"""The vertex-program contract — the reference's ``Analyser`` as torch code.

The reference's user algorithm contract is the ``Analyser`` trait
(``core/analysis/API/Analyser.scala:30-63``): ``setup()``, ``analyse()`` (one
superstep of per-vertex code sending point-to-point messages), result
reducers, ``defineMaxSteps()``. Here an algorithm is a frozen dataclass of
array functions over the WHOLE vertex/edge set at once:

    init(ctx)                  -> state                 (Analyser.setup)
    message(src_state, edge)   -> payload               (messageNeighbour)
    update(state, agg, ctx)    -> (state, halt_votes)   (Analyser.analyse + voteToHalt)
    finalize(state, ctx)       -> result                (returnResults)
    reduce(result, view)       -> job-level answer      (processResults, host)

Messages flow along edges (``direction`` 'out', 'in' or 'both') and are
combined at the receiver by an associative-commutative ``combiner``
('sum' | 'min' | 'max'). The hop-batched columnar engine runs PageRank's
semantics directly; the generic superstep engine that drives these
functions for every program arrives with ROADMAP queue 1 item 4.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any

import torch


@dataclass(frozen=True)
class Edges:
    """Per-edge tensors visible to ``message`` (masked rows are neutralised
    by the engine). ``time``/``first_time`` are the latest/earliest history
    points."""

    src: torch.Tensor          # i32[m] global padded source index
    dst: torch.Tensor          # i32[m] global padded destination index
    mask: torch.Tensor         # bool[m] (already window-restricted)
    time: torch.Tensor         # i64[m] latest activity <= T
    first_time: torch.Tensor   # i64[m]
    props: dict[str, torch.Tensor] = field(default_factory=dict)
    step: int = 0              # current superstep


@dataclass(frozen=True)
class Context:
    """Per-superstep global context visible to ``init``/``update``/
    ``finalize`` — the analogue of the reference's injected
    ``sysSetup(context, managerCount, proxy: GraphLens, workerID)``
    (``Analyser.scala:37-42``), but the "lens" is just tensors."""

    n: int                     # padded vertex count
    time: int                  # view timestamp
    window: int                # window size (-1 = none)
    v_mask: torch.Tensor       # bool[n] in-view/in-window vertices
    vids: torch.Tensor         # i64[n] global ids (-1 pad)
    v_latest_time: torch.Tensor
    v_first_time: torch.Tensor
    out_deg: torch.Tensor      # i32[n] under current mask
    in_deg: torch.Tensor       # i32[n]
    n_active: torch.Tensor     # i32 scalar: active vertex count
    step: int = 0              # current superstep
    vprops: dict[str, torch.Tensor] = field(default_factory=dict)

    @property
    def num_vertices(self) -> torch.Tensor:
        """Active vertex count as f32 (PageRank-style normalisers)."""
        return self.n_active.to(torch.float32)

    def global_sum(self, x: torch.Tensor) -> torch.Tensor:
        return torch.sum(x)

    def global_max(self, x: torch.Tensor) -> torch.Tensor:
        return torch.max(x)


class VertexProgram:
    """Base class; subclass as @dataclass(frozen=True) with hyperparams as
    fields. Class attributes configure the engine."""

    combiner: str = "sum"
    direction: str = "out"          # 'out' | 'in' | 'both'
    max_steps: int = 20
    edge_props: tuple[str, ...] = ()
    vertex_props: tuple[str, ...] = ()
    # True when the program's overridden ``reduce`` reads only the
    # vertex-side view fields (vids / v_mask / v_latest_time /
    # window_masks()[0]) — the amortised sweep engines hand reducers a
    # lightweight shell without edge masks or property joins.
    reduce_shell_safe: bool = False

    def init(self, ctx: Context) -> Any:
        raise NotImplementedError

    def message(self, src_state: Any, edge: Edges) -> Any:
        """Payload sent along each edge, computed from the SENDER's state."""
        raise NotImplementedError

    def update(self, state: Any, agg: Any, ctx: Context):
        """Fold the combined inbox into new state; return (state, halt_votes)
        with halt_votes bool[n] True where the vertex votes to halt."""
        raise NotImplementedError

    def finalize(self, state: Any, ctx: Context) -> Any:
        return state

    def reduce(self, result, view, window=None):
        """Turn device results into the job-level answer (host code).
        Default: pass through."""
        return result
