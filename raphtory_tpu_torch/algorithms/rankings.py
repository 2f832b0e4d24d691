"""Ranking analysers: DegreeRanking, StarNode and Density.

Capability parity with ``raphtory_tpu/algorithms/rankings.py``: the
``DegreeRanking`` top-k output (``core/analysis/Algorithms/
DegreeRanking.scala``), the random example's ``StarNode`` and ``Density``
analysers. All three take zero supersteps: the engine's context already
holds each window's degrees, and ``reduce`` is numpy over the view.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from ..engine.program import Context, VertexProgram


def _vertex_mask(view, window) -> np.ndarray:
    if window is None:
        return np.asarray(view.v_mask)
    return view.window_masks([window])[0][0]


@dataclass(frozen=True)
class DegreeRanking(VertexProgram):
    needs_vids = False
    needs_vertex_times = False
    needs_edge_times = False
    top_k: int = 10
    by: str = "total"   # 'in' | 'out' | 'total'
    max_steps: int = 0

    def init(self, ctx: Context):
        return {}

    def finalize(self, state, ctx: Context):
        return {"in": ctx.in_deg, "out": ctx.out_deg}

    def reduce(self, result, view, window=None):
        ind = np.asarray(result["in"])
        outd = np.asarray(result["out"])
        mask = _vertex_mask(view, window)
        score = {"in": ind, "out": outd, "total": ind + outd}[self.by]
        score = np.where(mask, score, -1)
        order = np.argsort(-score, kind="stable")[: self.top_k]
        return {
            "ranking": [
                {"id": int(view.vids[i]), "in": int(ind[i]),
                 "out": int(outd[i])}
                for i in order
                if mask[i]
            ]
        }


@dataclass(frozen=True)
class StarNode(VertexProgram):
    """The vertex with the largest in-degree in the (windowed) view
    (``examples/random/depricated/StarNode.scala``)."""

    needs_vids = False
    needs_vertex_times = False
    needs_edge_times = False
    max_steps: int = 0

    def init(self, ctx: Context):
        return {}

    def finalize(self, state, ctx: Context):
        return {"in": ctx.in_deg}

    def reduce(self, result, view, window=None):
        ind = np.asarray(result["in"])
        mask = _vertex_mask(view, window)
        score = np.where(mask, ind, -1)
        if not mask.any():
            return {"star": None, "inDegree": 0}
        i = int(np.argmax(score))
        return {"star": int(view.vids[i]), "inDegree": int(ind[i])}


@dataclass(frozen=True)
class Density(VertexProgram):
    """|E| / (|V| * (|V| - 1)) on the (windowed) view."""

    needs_vids = False
    needs_vertex_times = False
    needs_edge_times = False
    max_steps: int = 0

    def init(self, ctx: Context):
        return {}

    def finalize(self, state, ctx: Context):
        return {"out": ctx.out_deg}

    def reduce(self, result, view, window=None):
        if window is None:
            vmask = np.asarray(view.v_mask)
            emask = np.asarray(view.e_mask)
        else:
            vm, em = view.window_masks([window])
            vmask, emask = vm[0], em[0]
        n = int(vmask.sum())
        m = int(emask.sum())
        return {
            "vertices": n,
            "edges": m,
            "density": (m / (n * (n - 1))) if n > 1 else 0.0,
        }
