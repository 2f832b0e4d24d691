"""Label propagation (community detection) — the generic-inbox algorithm.

Synchronous LPA (Raghavan et al.), as ``raphtory_tpu/algorithms/lpa.py``:
every vertex starts in its own community and repeatedly adopts the MOST
FREQUENT label among its in-neighbours (ties break to the smallest label; a
vertex with no in-neighbours keeps its label), halting when no label
changes. The per-vertex label histogram is the inbox-style aggregation the
reference's typed vertex messages allow (``VertexVisitor.scala:99-161``)
and a sum/min/max combiner cannot express: it runs through
``combiner='custom'`` and K7-mode ``ops.segment.segment_mode``.

Labels are GLOBAL PADDED vertex indices (int32), like ConnectedComponents'.
Not ``reduce_shell_safe`` (the reference's is not either), so LPA jobs take
the cold route: View jobs ``build_view`` + ``bsp.run``, Range jobs hop by
hop.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..engine.program import Context, Edges, VertexProgram
from ..ops.segment import segment_mode

_I32_MAX = int(np.iinfo(np.int32).max)


@dataclass(frozen=True)
class LabelPropagation(VertexProgram):
    max_steps: int = 30
    combiner = "custom"
    direction = "out"            # labels flow src -> dst; histogram at dst
    needs_vids = False
    needs_vertex_times = False
    needs_edge_times = False

    def init(self, ctx: Context):
        return torch.where(ctx.v_mask, ctx.global_index(), _I32_MAX)

    def message(self, src_state, edge: Edges):
        return src_state

    def exchange(self, payload, seg, num_segments, mask):
        # mode of the inbox per (window, destination); -1 marks "no messages"
        return segment_mode(payload, seg, num_segments, mask, default=-1,
                            k=num_segments // seg.n)

    def update(self, state, agg, ctx: Context):
        new = torch.where((agg >= 0) & ctx.v_mask, agg, state)
        new = torch.where(ctx.v_mask, new, _I32_MAX)
        return new, new == state

    def reduce(self, result, view, window=None):
        """Community stats (same shape as ConnectedComponents.reduce)."""
        labels = np.asarray(result)
        if window is None:
            mask = np.asarray(view.v_mask)
        else:
            mask = view.window_masks([window])[0][0]
        lab = labels[mask]
        if len(lab) == 0:
            return {"vertices": 0, "communities": 0, "biggest": 0, "top5": []}
        uniq, counts = np.unique(lab, return_counts=True)
        counts.sort()
        return {
            "vertices": int(len(lab)),
            "communities": int(len(uniq)),
            "biggest": int(counts[-1]),
            "top5": counts[::-1][:5].tolist(),
        }
