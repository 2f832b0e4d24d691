"""PageRank as a pull-combine vertex program — the flagship benchmark kernel.

The reference ships a deprecated 10-step push PageRank
(``examples/random/depricated/PageRank.scala:21-45``). This is the proper
power-iteration formulation: each superstep every vertex pulls
``rank/out_deg`` along in-edges (sum combiner), applies damping with a
dangling-mass correction, and votes to halt when its rank moved less than
``tol``. f32 on the device. The generic superstep engine (``engine/bsp.py``) runs
these functions for View queries and the resident sweep; the hop-batched
columnar engine (``engine/hopbatch.py``) runs exactly these semantics for
every (hop, window) view of a Range query at once.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..engine.program import Context, Edges, VertexProgram


@dataclass(frozen=True)
class PageRank(VertexProgram):
    damping: float = 0.85
    tol: float = 1e-6
    max_steps: int = 50
    combiner = "sum"
    direction = "out"   # payload flows src→dst, combined at dst = pull at dst
    reduce_shell_safe = True   # reducer reads vids/v_mask only
    needs_vids = False
    needs_vertex_times = False
    needs_edge_times = False

    def init(self, ctx: Context):
        n = torch.clamp(ctx.num_vertices, min=1.0)
        rank = torch.where(ctx.v_mask, 1.0 / n, 0.0).to(torch.float32)
        return {"rank": rank, "out_deg": ctx.out_deg.to(torch.float32)}

    def message(self, src_state, edge: Edges):
        deg = torch.clamp(src_state["out_deg"], min=1.0)
        return src_state["rank"] / deg

    def update(self, state, agg, ctx: Context):
        n = torch.clamp(ctx.num_vertices, min=1.0)
        # dangling vertices redistribute their mass uniformly
        dangling = ctx.global_sum(
            torch.where(ctx.v_mask & (ctx.out_deg == 0), state["rank"], 0.0))
        # an f32 numerator: torch divides a Python float by a tensor through
        # the reciprocal (two roundings); the reference divides once
        base = torch.full_like(n, 1.0 - self.damping) / n
        new = base + self.damping * (agg + dangling / n)
        new = torch.where(ctx.v_mask, new, 0.0).to(torch.float32)
        votes = (new - state["rank"]).abs() < self.tol
        return {"rank": new, "out_deg": state["out_deg"]}, votes

    def finalize(self, state, ctx: Context):
        return state["rank"]

    def reduce(self, result, view, window=None):
        ranks = np.asarray(result)
        order = np.argsort(ranks)[::-1][:10]
        return {
            "sum": float(ranks.sum()),
            "top10": [
                (int(view.vids[i]), float(ranks[i])) for i in order if ranks[i] > 0
            ],
        }
