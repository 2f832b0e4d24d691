"""Temporal taint tracking — time-respecting infection propagation.

Capability parity with ``EthereumTaintTracking``
(``examples/blockchain/analysers/EthereumTaintTracking.scala:93-127``) and
with ``raphtory_tpu/algorithms/taint.py``: a set of seed accounts becomes
tainted at a start time; taint flows along an edge OCCURRENCE (one
transaction) only if the occurrence happens at or after the moment its
source became tainted, so propagation follows the arrow of time through
the multigraph of edge events, not the deduplicated topology. The
``TaintTrackExchangeStop`` variant: a stop-list of vertices that absorb
taint but never pass it on (exchanges).

State is the earliest taint time per vertex (int64, ``IMAX`` = clean); the
message along occurrence e = (u → v, t) is ``t if taint[u] <= t else
IMAX``; the combiner is min, so the exchange is the int64 instantiation of
K7 / K7-P. The fixpoint comes within the diameter's supersteps.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..engine.program import Context, Edges, VertexProgram
from .traversal import _member

IMAX = int(np.iinfo(np.int64).max)


@dataclass(frozen=True)
class TaintTracking(VertexProgram):
    seeds: tuple = ()            # global vertex ids tainted at start_time
    start_time: int = 0
    stop_list: tuple = ()        # absorb but never re-emit (exchange stop)
    max_steps: int = 50
    value_prop: str | None = None  # per-occurrence value gate (see below)
    min_value: float = 0.0
    combiner = "min"
    direction = "out"
    needs_occurrences = True
    needs_vertex_times = False

    @property
    def edge_props(self):  # type: ignore[override]
        """Value-weighted taint: with ``value_prop`` set, an occurrence
        only carries taint when its OWN event property (e.g. the amount
        transferred) is >= ``min_value`` — dust transactions do not
        propagate."""
        return (self.value_prop,) if self.value_prop else ()

    def init(self, ctx: Context):
        tainted = _member(ctx.vids, self.seeds) & ctx.v_mask
        taint_t = torch.where(tainted, int(self.start_time), IMAX)
        stopped = _member(ctx.vids, self.stop_list)
        # every state leaf is [k, n]: the exchange gathers rows of each
        return {"taint": taint_t,
                "stopped": stopped.expand_as(taint_t).contiguous()}

    def message(self, src_state, edge: Edges):
        # edge.time is the occurrence (transaction) time; taint flows only
        # forward in time, and never OUT of a stop-listed vertex
        can_emit = (src_state["taint"] <= edge.time) & ~src_state["stopped"]
        if self.value_prop:
            val = edge.props[self.value_prop]
            floor = torch.tensor(self.min_value, dtype=val.dtype,
                                 device=val.device)
            can_emit &= ~torch.isnan(val) & (val >= floor)
        return torch.where(can_emit, edge.time, IMAX)

    def update(self, state, agg, ctx: Context):
        new = torch.minimum(state["taint"], agg)
        new = torch.where(ctx.v_mask, new, IMAX)
        return ({"taint": new, "stopped": state["stopped"]},
                new == state["taint"])

    def finalize(self, state, ctx: Context):
        return state["taint"]

    def reduce(self, result, view, window=None):
        taint = np.asarray(result)
        hit = np.flatnonzero(taint < IMAX)
        rows = sorted(
            ((int(view.vids[i]), int(taint[i])) for i in hit),
            key=lambda r: (r[1], r[0]),
        )
        return {
            "tainted": len(rows),
            "infections": [{"id": vid, "taintedAt": t} for vid, t in rows],
        }
