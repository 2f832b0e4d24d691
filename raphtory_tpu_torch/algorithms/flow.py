"""FlowGraph — temporal flux aggregation per vertex.

Capability parity with ``raphtory_tpu/algorithms/flow.py``
(``core/analysis/Algorithms/FlowGraph.scala``, the track-and-trace
example's co-visit flows): for edges carrying a numeric ``flow`` property
(visit counts, transferred value, ...), each vertex's windowed in-flux,
out-flux and net flux, and the heaviest edges. Zero supersteps: the flux is
two segment sums over the exact windowed edge set, done in ``reduce``.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from ..engine.program import Context, VertexProgram


@dataclass(frozen=True)
class FlowGraph(VertexProgram):
    needs_vids = False
    needs_vertex_times = False
    needs_edge_times = False
    flow_prop: str = "flow"
    default_flow: float = 1.0
    max_steps: int = 0

    def init(self, ctx: Context):
        return {}

    def finalize(self, state, ctx: Context):
        return {"in_deg": ctx.in_deg, "out_deg": ctx.out_deg}

    def reduce(self, result, view, window=None):
        if window is None:
            emask = np.asarray(view.e_mask)
            vmask = np.asarray(view.v_mask)
        else:
            vm, em = view.window_masks([window])
            vmask, emask = vm[0], em[0]
        w = view.edge_prop(self.flow_prop)
        w = np.where(np.isnan(w), self.default_flow, w)
        influx = np.zeros(view.n_pad)
        outflux = np.zeros(view.n_pad)
        np.add.at(influx, view.e_dst[emask], w[emask])
        np.add.at(outflux, view.e_src[emask], w[emask])
        net = influx - outflux
        score = np.where(vmask, np.abs(net), -np.inf)
        order = np.argsort(-score, kind="stable")
        top = [
            {
                "id": int(view.vids[i]),
                "influx": float(influx[i]),
                "outflux": float(outflux[i]),
                "net": float(net[i]),
            }
            for i in order[:10]
            if vmask[i]
        ]
        wm = np.where(emask, w, -np.inf)
        heavy = np.argsort(-wm, kind="stable")[:10]
        corridors = [
            {
                "src": int(view.vids[view.e_src[j]]),
                "dst": int(view.vids[view.e_dst[j]]),
                "flow": float(w[j]),
            }
            for j in heavy
            if emask[j]
        ]
        return {
            "total_flow": float(w[emask].sum()),
            "top_vertices": top,
            "top_corridors": corridors,
        }
