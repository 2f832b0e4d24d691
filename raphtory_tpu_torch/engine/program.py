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
('sum' | 'min' | 'max'), or by the program's own ``exchange``
(``combiner='custom'``, LabelPropagation's ``segment_mode``). The generic superstep engine (``engine/bsp.py``)
drives these functions for every program; the hop-batched columnar engine
runs PageRank's, CC's and BFS/SSSP's semantics directly.

**Window-batched calls.** The reference vmaps ``init``/``update``/
``finalize`` over the k windows of a batched query (``bsp.py:160-218``).
Here each is called ONCE on ``[k, n]`` tensors, so the launches per
superstep do not grow with k: ``Context.time``, ``window`` and
``n_active`` are ``[k, 1]``; ``v_mask`` and the degrees ``[k, n]``;
``vids`` and the vertex times ``[n]`` (shared by every window);
``global_sum``/``global_max`` reduce over the vertex axis and keep it.
``message`` sees flat window-major edge tensors ``[k*m]``.

**Sharding context.** On a mesh (``parallel/sharded.py``) a program sees
only its rank's rows: ``n`` is the local row count, ``v_offset`` the
global index of local row 0 and ``axis`` the vertex axis of the mesh
(``cluster.bootstrap.Axis``), over which ``global_sum``, ``global_max``
and the engine's ``n_active`` all-reduce. On one device ``axis`` is None
and ``v_offset`` 0 (``raphtory_tpu/engine/program.py:83-110``).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any

import torch


@dataclass(frozen=True)
class Edges:
    """Per-edge tensors visible to ``message``, flat over the k windows
    (window w's edges at ``w*m .. w*m+m-1``; masked rows are neutralised
    by the engine). ``src``/``dst`` are the per-window vertex indices, NOT
    offset by window. ``time``/``first_time`` are the latest/earliest
    history points."""

    src: torch.Tensor          # i32[k*m] padded source index
    dst: torch.Tensor          # i32[k*m] padded destination index
    mask: torch.Tensor         # bool[k*m] (already window-restricted)
    time: torch.Tensor         # i64[k*m] latest activity <= T
    first_time: torch.Tensor   # i64[k*m]
    props: dict[str, torch.Tensor] = field(default_factory=dict)  # f32[k*m]
    step: int = 0              # current superstep


@dataclass(frozen=True)
class Context:
    """Per-superstep global context visible to ``init``/``update``/
    ``finalize`` — the analogue of the reference's injected
    ``sysSetup(context, managerCount, proxy: GraphLens, workerID)``
    (``Analyser.scala:37-42``), but the "lens" is just tensors, with a
    leading window axis of k."""

    n: int                     # padded vertex count
    time: torch.Tensor         # i64[k, 1] view timestamp
    window: torch.Tensor       # i64[k, 1] window size (-1 = none)
    v_mask: torch.Tensor       # bool[k, n] in-view/in-window vertices
    vids: torch.Tensor         # i64[n] global ids (-1 pad)
    v_latest_time: torch.Tensor   # i64[n]
    v_first_time: torch.Tensor    # i64[n]
    out_deg: torch.Tensor      # i32[k, n] under each window's mask
    in_deg: torch.Tensor       # i32[k, n]
    n_active: torch.Tensor     # i32[k, 1] active vertex count per window
    step: int = 0              # current superstep
    vprops: dict[str, torch.Tensor] = field(default_factory=dict)
    v_offset: int = 0          # global index of local row 0
    axis: Any = None           # the mesh's vertex axis (None: one device)

    @property
    def num_vertices(self) -> torch.Tensor:
        """Active vertex count as f32 (PageRank-style normalisers)."""
        return self.n_active.to(torch.float32)

    def global_sum(self, x: torch.Tensor) -> torch.Tensor:
        """Sum over the vertex axis, per window (``[k, 1]``). A float32 sum
        accumulates in float64 and rounds once, so its value does not hang
        on the reduction order (the card's and the CPU's differ); on a mesh
        the float64 partials are all-reduced before the one rounding."""
        if x.dtype == torch.float32:
            s = torch.sum(x, dim=-1, keepdim=True, dtype=torch.float64)
            if self.axis is not None:
                s = self.axis.all_reduce(s, "sum")
            return s.to(torch.float32)
        s = torch.sum(x, dim=-1, keepdim=True)
        return s if self.axis is None else self.axis.all_reduce(s, "sum")

    def global_max(self, x: torch.Tensor) -> torch.Tensor:
        """Max over the vertex axis, per window (``[k, 1]``)."""
        s = torch.amax(x, dim=-1, keepdim=True)
        return s if self.axis is None else self.axis.all_reduce(s, "max")

    def global_index(self) -> torch.Tensor:
        """i32[n]: the global padded index of each row (CC labels): the
        row plus ``v_offset``."""
        return torch.arange(self.n, dtype=torch.int32,
                            device=self.v_mask.device) + self.v_offset


class VertexProgram:
    """Base class; subclass as @dataclass(frozen=True) with hyperparams as
    fields. Class attributes configure the engine."""

    combiner: str = "sum"
    direction: str = "out"          # 'out' | 'in' | 'both'
    max_steps: int = 20
    edge_props: tuple[str, ...] = ()
    vertex_props: tuple[str, ...] = ()
    needs_occurrences: bool = False  # multigraph temporal algorithms
    # Array-requirement declarations: a program that never reads ctx.vids /
    # ctx.v_{latest,first}_time / edge.{time,first_time} sets the matching
    # flag False, and the engine then hands it pad defaults (-1 /
    # INT64_MIN) instead of the real arrays.
    needs_vids: bool = True
    needs_vertex_times: bool = True
    needs_edge_times: bool = True
    # True when the program's overridden ``reduce`` reads only the
    # vertex-side view fields (vids / v_mask / v_latest_time /
    # window_masks()[0]) — the amortised sweep engines hand reducers a
    # lightweight shell without edge masks or property joins.
    reduce_shell_safe: bool = False
    # Monotone min-merge declaration, the sparse frontier route's
    # eligibility gate (``parallel/frontier.py``; the reference's contract,
    # ``raphtory_tpu/engine/program.py:141-155``): combiner "min", a single
    # state leaf, ``update`` an elementwise masked min whose pad is the
    # dtype's min identity, votes exactly ``new == state``, and no read of
    # the degrees. ConnectedComponents and SSSP/BFS declare it.
    monotone_min: bool = False

    @property
    def cost_label(self) -> str:
        """Algorithm label the route decisions are filed under (class name
        by default)."""
        return type(self).__name__

    def init(self, ctx: Context) -> Any:
        raise NotImplementedError

    def message(self, src_state: Any, edge: Edges) -> Any:
        """Payload sent along each edge, computed from the SENDER's state.
        For direction='in' the "sender" is the edge's dst vertex; for 'both'
        it is called once per direction."""
        raise NotImplementedError

    def exchange(self, payload: Any, seg: Any, num_segments: int,
                 mask: torch.Tensor) -> Any:
        """combiner='custom' only: reduce the flat per-edge ``payload``
        (leaves ``[k*m, ...]``) into per-vertex aggregates (leaves
        ``[num_segments, ...]``, ``num_segments = k*n``); rows with
        ``mask`` False must not contribute (``raphtory_tpu/engine/
        program.py:177-190``). Where the reference passes each payload's
        flat segment id, the port passes the direction's
        ``ops.segment.SegmentCSR``: window w's row e goes to segment
        ``w*n + seg.ids[e]``, and ``seg.indptr``/``seg.perm`` walk each
        segment's rows — what ``ops.segment.segment_combine`` and
        ``segment_mode`` take (``k = num_segments // seg.n``). Restricted
        to direction 'out' or 'in' (merging two custom aggregations is not
        well-defined)."""
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
