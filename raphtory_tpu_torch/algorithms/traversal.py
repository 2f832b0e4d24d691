"""BFS / SSSP — min-plus traversal from seed vertices.

The LDBC-SNB capability bar (BASELINE.md configs: "BFS / SSSP Analyser over
sliding windows"). BFS is hop counting; SSSP weights edges with a numeric
property (default weight 1; a stored NaN weighs 1 too). Both are the same
min-plus program. The generic superstep engine runs the per-vertex
``init``/``message``/``update`` below; the hop-batched columnar engines
(``engine/hopbatch.HopBatchedBFS`` / ``HopBatchedSSSP``) run the same
semantics for every (hop, window) view of a Range query.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..engine.program import Context, Edges, VertexProgram

FINF = float("inf")


def _member(vids: torch.Tensor, ids: tuple) -> torch.Tensor:
    """bool[n]: which rows' ids are among ``ids`` — one sorted search per
    row, not an ``[n, len(ids)]`` compare."""
    if not ids:
        return torch.zeros(vids.shape, dtype=torch.bool, device=vids.device)
    table = torch.tensor(sorted(set(int(i) for i in ids)), dtype=vids.dtype,
                         device=vids.device)
    pos = torch.searchsorted(table, vids).clamp_(max=table.shape[0] - 1)
    return table[pos] == vids


@dataclass(frozen=True)
class SSSP(VertexProgram):
    seeds: tuple = ()
    weight_prop: str | None = None   # None -> unit weights (= BFS hop count)
    directed: bool = True
    max_steps: int = 100
    top_k: int = 20                  # farthest reached vertices in the summary
    full_distances: bool = False     # opt-in: ship every reached distance
    combiner = "min"
    monotone_min = True        # min-plus relaxation
    reduce_shell_safe = True   # reducer reads vids/v_mask only
    needs_vertex_times = False
    needs_edge_times = False

    @property
    def direction(self):  # type: ignore[override]
        return "out" if self.directed else "both"

    @property
    def edge_props(self):  # type: ignore[override]
        return (self.weight_prop,) if self.weight_prop else ()

    def init(self, ctx: Context):
        seeded = _member(ctx.vids, self.seeds) & ctx.v_mask
        return torch.where(seeded, 0.0, FINF).to(torch.float32)

    def message(self, src_state, edge: Edges):
        if self.weight_prop:
            w = edge.props[self.weight_prop]
            w = torch.where(torch.isnan(w), 1.0, w).to(torch.float32)
        else:
            w = 1.0
        return src_state + w

    def update(self, state, agg, ctx: Context):
        new = torch.minimum(state, agg)
        new = torch.where(ctx.v_mask, new, FINF)
        return new, new == state

    def reduce(self, result, view, window=None):
        """Top-k + hop histogram summary (PageRank reducer discipline).

        A range sweep runs this once per hop; shipping every reached
        vertex's distance per hop balloons job results, so the default
        reports the k farthest vertices plus a distance histogram. Full
        per-vertex distances stay available behind
        ``full_distances=True``.
        """
        dist = np.asarray(result)
        reached = np.isfinite(dist) & np.asarray(view.v_mask)
        out = {
            "reached": int(reached.sum()),
            "max_distance": float(dist[reached].max()) if reached.any() else None,
        }
        idx = np.flatnonzero(reached)
        if len(idx):
            k = min(self.top_k, len(idx))
            part = idx[np.argpartition(dist[idx], len(idx) - k)[len(idx) - k:]]
            order = part[np.argsort(dist[part])[::-1]]
            out["top"] = [
                {"vertex": int(view.vids[i]), "distance": float(dist[i])}
                for i in order
            ]
            # integer-bucket histogram of reached distances (hops for BFS)
            buckets = np.floor(dist[idx]).astype(np.int64)
            uniq, counts = np.unique(buckets, return_counts=True)
            out["histogram"] = {int(u): int(c) for u, c in zip(uniq, counts)}
        else:
            out["top"] = []
            out["histogram"] = {}
        if self.full_distances:
            out["distances"] = {
                int(view.vids[i]): float(dist[i]) for i in idx
            }
        return out


def BFS(seeds: tuple = (), directed: bool = True, max_steps: int = 100,
        top_k: int = 20, full_distances: bool = False) -> SSSP:
    """Hop-count traversal (unit-weight SSSP)."""
    return SSSP(seeds=seeds, weight_prop=None, directed=directed,
                max_steps=max_steps, top_k=top_k,
                full_distances=full_distances)
