"""Degree statistics — DegreeBasic/InDegree/OutDegree parity.

Reference: ``core/analysis/Algorithms/DegreeBasic.scala`` (per-vertex
(in, out) pairs + totals/max in the reducer) and the random-example
``InDegree``/``OutDegree`` analysers. Zero supersteps: degrees are already a
segment-sum in the engine context.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..engine.program import Context, VertexProgram


@dataclass(frozen=True)
class DegreeBasic(VertexProgram):
    max_steps: int = 0
    reduce_shell_safe = True   # reducer reads vids/v_mask only
    needs_vids = False
    needs_vertex_times = False
    needs_edge_times = False

    def init(self, ctx: Context):
        return {}

    def finalize(self, state, ctx: Context):
        return {
            "in": torch.where(ctx.v_mask, ctx.in_deg, 0),
            "out": torch.where(ctx.v_mask, ctx.out_deg, 0),
        }

    def reduce(self, result, view, window=None):
        ind = np.asarray(result["in"])
        outd = np.asarray(result["out"])
        if window is None:
            mask = np.asarray(view.v_mask)
        else:
            mask = view.window_masks([window])[0][0]
        n = int(mask.sum())
        tot = ind + outd
        return {
            "vertices": n,
            "total_in": int(ind.sum()),
            "total_out": int(outd.sum()),
            "max_in": int(ind.max(initial=0)),
            "max_out": int(outd.max(initial=0)),
            "avg_degree": float(tot.sum() / max(n, 1)),
        }
