"""Connected components via min-label propagation.

Capability parity with the reference's flagship algorithm
(``core/analysis/Algorithms/ConnectedComponents.scala:10-42``): every vertex
starts labelled with its own id, repeatedly adopts the min label over its
neighbourhood (both directions), votes to halt when unchanged; the reducer
reports cluster count / biggest / islands / average like the reference's
``processResults`` (``ConnectedComponents.scala:44-122``).

Labels are GLOBAL PADDED vertex indices (int32) on the device, never 64-bit
external ids; ``view.vids[label]`` recovers the external id of a
component's representative. The generic superstep engine runs the
per-vertex ``init``/``message``/``update`` below; the hop-batched columnar
engine (``engine/hopbatch.HopBatchedCC``) runs the same semantics for
every (hop, window) view of a Range query.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..engine.program import Context, Edges, VertexProgram

_I32_MAX = int(np.iinfo(np.int32).max)


@dataclass(frozen=True)
class ConnectedComponents(VertexProgram):
    max_steps: int = 100
    combiner = "min"
    direction = "both"
    monotone_min = True        # min-label merge
    reduce_shell_safe = True   # reducer reads vids/v_mask only
    needs_vids = False
    needs_vertex_times = False
    needs_edge_times = False

    def init(self, ctx: Context):
        return torch.where(ctx.v_mask, ctx.global_index(), _I32_MAX)

    def message(self, src_state, edge: Edges):
        return src_state

    def update(self, state, agg, ctx: Context):
        new = torch.minimum(state, agg)
        new = torch.where(ctx.v_mask, new, _I32_MAX)
        return new, new == state

    def finalize(self, state, ctx: Context):
        return state

    def reduce(self, result, view, window=None):
        """Cluster stats in the reference's output shape
        (ConnectedComponents.scala:93-122): top-5 sizes, counts, islands."""
        labels = np.asarray(result)
        if window is None:
            mask = np.asarray(view.v_mask)
        else:
            mask = view.window_masks([window])[0][0]
        lab = labels[mask]
        if len(lab) == 0:
            return {
                "vertices": 0, "clusters": 0, "biggest": 0,
                "islands": 0, "proportion": 0.0, "top5": [],
            }
        uniq, counts = np.unique(lab, return_counts=True)
        counts.sort()
        top5 = counts[::-1][:5].tolist()
        return {
            "vertices": int(len(lab)),
            "clusters": int(len(uniq)),
            "biggest": int(counts[-1]),
            "islands": int((counts == 1).sum()),
            "proportion": float(counts[-1] / len(lab)),
            "top5": top5,
        }
