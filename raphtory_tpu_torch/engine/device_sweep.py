"""Device-resident range sweeps: global dense-space tables and
``DeviceSweep``.

Vertices are indexed by their rank in the sorted set of every id the pinned
log ever mentions (``SweepBuilder.uv``); the edge table is every (src, dst)
pair the log ever mentions, sorted once by (dst, src). Positions never change
across a sweep — dead entities are simply masked — so the tables upload to
the device ONCE per log and every hop ships only fold-state deltas.

``DeviceSweep`` (``raphtory_tpu/engine/device_sweep.py:296``) keeps the
per-entity fold state (latest time, alive, first time) in six resident
device buffers, mirrors each hop's touched rows into them (K9a,
``ops/resident.apply_delta_chunk``: each chunk staged as one packed byte
buffer in pinned host memory and shipped in one non-blocking copy),
derives the window masks on the device
(K9b, ``ops/resident.window_masks``) and runs the generic superstep engine
(``engine/bsp.make_mask_runner``, K7) over them. Results are in the GLOBAL
dense vertex space: row i is vertex ``uv[i]``.

``run_sweep`` pipelines the hops as the reference does: hop i+1 folds and
stages on the lookahead lane while hop i ships and runs (``RTPU_PREFETCH``),
leaving checkpoints in the fold cache at the segment starts; where cached
checkpoints cover them (a later sweep over the same log and hops), with
``RTPU_FOLD_WORKERS`` > 1, contiguous segments of hops fold on forked
builders at once (``core/sweep.py``). Every payload ships from the calling
thread.

``repin`` adopts the rows appended to a live log since the pin
(``raphtory_tpu/engine/device_sweep.py:378``): the dense spaces do not
change, so the static device tables, the fold-state buffers and ``t_now``
stay valid, and the next ``advance`` folds the suffix as one delta. The
tracer, fault and ledger hooks wait for the serving stack (ROADMAP queue 1
item 6).
"""

from __future__ import annotations

import threading
import time as _time
import weakref
from functools import partial
from typing import NamedTuple

import numpy as np
import torch

from ..core.events import EDGE_ADD, EDGE_DELETE
from ..core.snapshot import INT64_MIN, _pad_bucket
from ..core.sweep import (_ENC_MASK, _ENC_SHIFT, SweepBuilder, fold_cache,
                          fold_pool, fold_workers, prefetch_map, prefetch_on)
from ..native import lib as _native
from ..obs import device as _obs_device
from ..obs import ledger as _ledger
from ..obs.metrics import METRICS
from ..obs.trace import TRACER
from ..ops.resident import apply_delta_chunk, pack_chunk, window_masks
from ..resilience import faults as _faults
from ..utils.device import resolve_device
from .program import VertexProgram


class IdSpaceError(ValueError):
    """The log has 2^31 distinct vertex ids or more: the packed pair keys
    of the global dense space are exhausted."""


def _pad_large(n: int) -> int:
    """Power-of-two buckets up to 2^16 (shared shapes across small logs),
    then 2^16-multiples — pow2 padding would waste up to 2x of every
    per-edge pass at GAB scale and beyond."""
    if n <= (1 << 16):
        return _pad_bucket(n)
    step = 1 << 16
    return ((n + step - 1) // step) * step


#: per-log cache of the device-uploaded static edge tables — a cold engine
#: over an unchanged log reuses the resident tensors instead of re-shipping
#: them per query. Keyed weakly by the CALLER's log object; one entry per
#: device.
_DEVICE_EDGES = weakref.WeakKeyDictionary()


class DeviceEdges(NamedTuple):
    """The static edge tables on the device: the (dst, src)-sorted edges
    with their destination CSR, and the source-ordered index over the
    same edges with its source CSR (``GlobalTables`` fields of the same
    names)."""
    e_src: torch.Tensor        # [m_pad] int32
    e_dst: torch.Tensor        # [m_pad] int32
    in_indptr: torch.Tensor    # [n_pad + 1] int64
    out_perm: torch.Tensor     # [m] int32
    out_indptr: torch.Tensor   # [n_pad + 1] int64


def _device_edges(log, tables, device: torch.device) -> DeviceEdges:
    """``DeviceEdges`` for ``tables``, cached per log and device. The
    (m, n) key is exact: pairs and vertices are never removed from a log,
    so equal counts mean the identical deterministic table (same pair set,
    same dense ranks, same (dst, src) sort)."""
    per_log = _DEVICE_EDGES.setdefault(log, {})
    ent = per_log.get(device)
    if ent is not None and ent[0] == tables.m and ent[1] == tables.n:
        return ent[2]
    dev = DeviceEdges(*(torch.from_numpy(getattr(tables, f)).to(device)
                        for f in DeviceEdges._fields))
    per_log[device] = (tables.m, tables.n, dev)
    return dev


class GlobalTables:
    """Static global-dense-space graph tables over a pinned log: every
    vertex id the log ever mentions (rank in ``uv`` = dense index) and every
    (src, dst) pair, (dst, src)-sorted, with its destination CSR."""

    def __init__(self, sw: SweepBuilder):
        if not sw._ok:
            raise IdSpaceError("log has >= 2^31 distinct vertices — the packed "
                             "pair key space is exhausted; use build_view")
        self.uv = sw.uv
        if sw._preseeded:
            # a preseeded sweep's pair table IS the all-pairs table (and
            # never grows) — no second unique over the edge events
            self.all_enc = sw.e_enc
        else:
            is_e = (sw._k == EDGE_ADD) | (sw._k == EDGE_DELETE)
            if is_e.any():
                enc = ((sw._dense(sw._s[is_e]) << _ENC_SHIFT)
                       | sw._dense(sw._d[is_e]))
                self.all_enc = np.unique(enc)
            else:
                self.all_enc = np.empty(0, np.int64)

        self.n = len(self.uv)
        self.m = len(self.all_enc)
        self.n_pad = _pad_large(self.n)
        self.m_pad = _pad_large(self.m)
        # times narrow to i32 when the whole log fits — halves both the
        # resident fold state and the delta bytes
        tcol = sw._t
        self.tdtype = (
            np.int32 if len(tcol) == 0
            or (tcol.min() > np.iinfo(np.int32).min // 2
                and tcol.max() < np.iinfo(np.int32).max // 2)
            else np.int64)
        self.tmin = np.iinfo(self.tdtype).min

        # engine edge order: (dst, src) — combine-at-destination reads a
        # contiguous edge run per destination row
        flip = ((self.all_enc & _ENC_MASK) << _ENC_SHIFT) \
            | (self.all_enc >> _ENC_SHIFT)
        order = np.argsort(flip)              # engine pos i ← enc rank
        self.eng_of_rank = np.empty(self.m, np.int64)
        self.eng_of_rank[order] = np.arange(self.m)

        # pad edges are dst = src = n_pad-1: the (dst, src) order survives
        # padding and the pads fall in the last destination row
        self.e_src = np.full(self.m_pad, self.n_pad - 1, np.int32)
        self.e_dst = np.full(self.m_pad, self.n_pad - 1, np.int32)
        eng_enc = self.all_enc[order]
        self.e_src[: self.m] = (eng_enc >> _ENC_SHIFT).astype(np.int32)
        self.e_dst[: self.m] = (eng_enc & _ENC_MASK).astype(np.int32)
        self.vids = np.full(self.n_pad, -1, np.int64)
        self.vids[: self.n] = self.uv
        #: destination CSR over the REAL (dst, src)-sorted edges: row d
        #: owns edges [in_indptr[d], in_indptr[d+1]). The pad edges are
        #: masked in every column and lie past in_indptr[n_pad] = m, so no
        #: row walks them (all m_pad - m of them would land in row n_pad-1)
        self.in_indptr = np.zeros(self.n_pad + 1, np.int64)
        np.cumsum(np.bincount(self.e_dst[: self.m], minlength=self.n_pad),
                  out=self.in_indptr[1:])
        #: source-ordered index over the same m real edges: out_perm[k] is
        #: the engine position of the k-th edge in (src, dst) order (a
        #: stable sort of the (dst, src) order by source), and source row
        #: s owns out_perm[out_indptr[s]:out_indptr[s+1]]. The min-combine
        #: kernels pull the reverse direction through it without atomics;
        #: the pad edges stay out of both CSRs
        self.out_perm = np.argsort(self.e_src[: self.m],
                                   kind="stable").astype(np.int32)
        self.out_indptr = np.zeros(self.n_pad + 1, np.int64)
        np.cumsum(np.bincount(self.e_src[: self.m], minlength=self.n_pad),
                  out=self.out_indptr[1:])

    def eng_pos(self, enc: np.ndarray) -> np.ndarray:
        """Engine positions of packed pair keys (must exist in the log).
        Packed keys are non-negative (dense<<32|dense), so the sorted i64
        table reinterprets as u64 zero-copy for the native parallel
        searchsorted — the hot per-hop lookup at 10^8-pair scale."""
        if len(enc) > (1 << 16) and _native.available():
            idx = _native.searchsorted_u64(
                self.all_enc.view(np.uint64),
                np.ascontiguousarray(enc).view(np.uint64))
            return self.eng_of_rank[idx]
        return self.eng_of_rank[np.searchsorted(self.all_enc, enc)]

    def cast_times(self, a: np.ndarray) -> np.ndarray:
        """i64 fold times → the narrow resident dtype (INT64_MIN pad maps to
        the narrow dtype's min) — shared by every engine over these tables."""
        if self.tdtype == np.int64:
            return a
        return np.where(a == INT64_MIN, self.tmin, a).astype(self.tdtype)


def normalize_windows(windows) -> list[int]:
    """window list → int list with -1 for 'no window' (engine convention)."""
    return [(-1 if w is None else int(w)) for w in windows]


def _time_dtype_status(tdtype, t_new: np.ndarray) -> str:
    """``"extended"``, or ``"rebuild"`` where an adopted suffix's times
    leave the narrowed int32 dtype the resident state was built in."""
    if tdtype == np.int32 and len(t_new) and not (
            int(t_new.min()) > np.iinfo(np.int32).min // 2
            and int(t_new.max()) < np.iinfo(np.int32).max // 2):
        return "rebuild"
    return "extended"


def sweep_phase_summary(sp, elapsed, fold_seconds, fold_stall_seconds,
                        ship_delta, ship_bytes, n_hops, fold_modes=None):
    """Per-sweep fold/stage/ship/compute phase breakdown
    (``raphtory_tpu/engine/device_sweep.py:59``), attached to the sweep
    span, observed into ``raphtory_sweep_phase_seconds{phase}`` and added
    to the active query ledger — shared by both sweep engines. ``fold``
    is the host fold (worker seconds under the prefetch), ``stage`` /
    ``ship`` the shared transfer engine's stalls during THIS sweep
    (``TransferStats.delta_since``; process-wide, so concurrent sweeps
    see each other's), ``compute`` the dispatch loop's residual (kernels
    and their host driving). Returns the phase dict."""
    stage = float(ship_delta.get("stage_stall_seconds", 0.0))
    wire = float(ship_delta.get("wire_stall_seconds", 0.0))
    phases = {
        "fold": float(fold_seconds),
        "stage": stage,
        "ship": wire,
        "compute": max(float(elapsed) - float(fold_stall_seconds)
                       - stage - wire, 0.0),
    }
    for ph, sec in phases.items():
        METRICS.sweep_phase_seconds.labels(ph).observe(sec)
    led = _ledger.current()
    if led is not None:
        # the port's engines ship their fold state in their own staged
        # copies, not through the transfer engine: their ``ship_bytes``
        # are this sweep's H2D bytes when the engine moved none
        if not ship_delta.get("bytes_shipped"):
            ship_delta = dict(ship_delta, bytes_shipped=int(ship_bytes))
        led.add_sweep(phases, ship_delta, ship_bytes, n_hops,
                      fold_modes=fold_modes)
    sp.set(elapsed_seconds=round(float(elapsed), 6),
           fold_stall_seconds=round(float(fold_stall_seconds), 6),
           ship_bytes=int(ship_bytes), n_hops=int(n_hops),
           **{f"{ph}_seconds": round(sec, 6) for ph, sec in phases.items()})
    return phases


def supported(program: VertexProgram) -> bool:
    """True if ``program`` can run on the device-resident sweep engine:
    no occurrence arrays and no host-materialised properties."""
    return (not program.needs_occurrences
            and not program.edge_props
            and not program.vertex_props)


def _widen(a: torch.Tensor, tmin: int) -> torch.Tensor:
    """Narrow int32 times → the int64 the ``Context``/``Edges`` contract
    carries; the narrow minimum (the pad) maps to INT64_MIN exactly."""
    if a.dtype == torch.int64:
        return a
    return torch.where(a == tmin, INT64_MIN, a.to(torch.int64))


class DeviceSweep:
    """Ascending-time range sweep with device-resident fold state.

    Drives a ``SweepBuilder`` for the host fold (delta semantics identical to
    ``build_view`` — killList propagation, delete-wins, revival), mirrors the
    touched rows into fixed-position device buffers (K9a), and runs the
    superstep engine over window masks derived on the device (K9b, then K7
    inside the engine).

    ``run(program, T, ...)`` returns ``(result, steps)``; results are in the
    GLOBAL dense vertex space: row i is vertex ``self.uv[i]``. ``device``
    None means the CUDA card (and raises without one).
    """

    def __init__(self, log, device=None):
        self.device = resolve_device(device)
        # fold state only (shells are vertex-side) — no add-row tracking
        self.sw = SweepBuilder(log, track_rows=False, preseed_pairs=True)
        self.tables = GlobalTables(self.sw)
        t = self.tables
        self.uv = t.uv
        self.n, self.m = t.n, t.m
        self.n_pad, self.m_pad = t.n_pad, t.m_pad
        # static device uploads — shared per log across sweeps
        self.edges = _device_edges(log, t, self.device)
        self.vids = torch.from_numpy(t.vids).to(self.device)
        # fold-state buffers in the narrow time dtype the log fits,
        # updated in place by every delta chunk
        self.tdtype = t.tdtype
        self._tmin = int(t.tmin)
        tdt = torch.int32 if self.tdtype == np.int32 else torch.int64
        dev = self.device
        self._bufs = (
            torch.full((self.n_pad,), self._tmin, dtype=tdt, device=dev),
            torch.zeros(self.n_pad, dtype=torch.bool, device=dev),
            torch.full((self.n_pad,), self._tmin, dtype=tdt, device=dev),
            torch.full((self.m_pad,), self._tmin, dtype=tdt, device=dev),
            torch.zeros(self.m_pad, dtype=torch.bool, device=dev),
            torch.full((self.m_pad,), self._tmin, dtype=tdt, device=dev),
        )
        # resident-buffer gauge (obs/device.py): the fold-state buffers
        # live exactly as long as this sweep
        _obs_device.RESIDENT.track(
            self, "fold_state",
            _obs_device.nbytes_tree(self._bufs)
            + _obs_device.nbytes_tree((self.vids,)))
        # delta chunk capacities: big enough that a typical hop is one chunk
        self.cap_v = max(1024, self.n_pad // 4)
        self.cap_e = max(4096, self.m_pad // 16)
        self.t_now: int | None = None
        #: host seconds spent folding + staging (summed over the threads
        #: that folded), device-bound seconds spent applying deltas and
        #: dispatching (host wall; the superstep loop waits on the device
        #: once per superstep), and bytes shipped
        self.fold_seconds = 0.0
        self.dispatch_seconds = 0.0
        self.ship_bytes = 0
        #: the fold seconds by mode (``serial``: this thread or the
        #: lookahead lane; ``parallel``: forked segments)
        self.fold_mode_seconds: dict = {}
        #: run_sweep: seconds the dispatch loop waited on folds (without
        #: the prefetch, every inline fold)
        self.fold_stall_seconds = 0.0
        # a failure between fold and device apply leaves t_now ahead of
        # the buffers (a lookahead fold may even be past the failed hop):
        # the next fold must restage the full state
        self._stale = False
        # held by every fold of this sweep's builder (advance, run_sweep
        # with its lookahead and forked folds) and by repin: a re-pin
        # waits for the folds in flight instead of rebinding under them
        self._pin_lock = threading.Lock()

    # ---- incremental re-pin (live serving) ----

    def repin(self, live_log) -> str:
        """Adopt the rows appended to ``live_log`` since this sweep's pin
        (``SweepBuilder.repin``). On ``"extended"`` the static device
        tables, the fold-state buffers and ``t_now`` stay valid, and the
        next ``advance`` folds the suffix. ``"noop"`` / ``"extended"`` /
        ``"rebuild"``; after ``"rebuild"`` the sweep must be discarded.
        A sweep whose buffers are behind its clock (``_stale``) rebuilds,
        and so does a suffix past the narrowed int32 time dtype."""
        with self._pin_lock:
            if self._stale:
                return "rebuild"
            n_old = len(self.sw._t)
            status = self.sw.repin(live_log)
            if status != "extended":
                return status
            return _time_dtype_status(self.tdtype, self.sw._t[n_old:])

    @property
    def edge_state(self) -> tuple:
        """The resident ``(e_lat, e_alive)`` buffers (engine edge order,
        ``tdtype`` times) at ``t_now`` — what the feature aggregation
        (``engine/features.py``, K10) masks its edges with."""
        return self._bufs[3], self._bufs[4]

    # ---- sweep driving ----

    def advance(self, time: int) -> None:
        """Fold events in (t_now, time] on the host and mirror the touched
        rows into the device buffers. Times must be non-decreasing."""
        with self._pin_lock:
            payload = self._fold_hop(time)
        self._apply_staged(payload)

    def _fold_hop(self, time: int, checkpoint_to=None) -> dict:
        """``_fold_hop_inner`` under a ``hop.fold`` span."""
        with TRACER.span("hop.fold", time=int(time),
                         engine="device_sweep") as sp:
            payload = self._fold_hop_inner(time, checkpoint_to)
            sp.set(kind=payload["kind"])
        return payload

    def _fold_hop_inner(self, time: int, checkpoint_to=None) -> dict:
        """Host half of one hop: fold events in (t_now, time] and stage the
        touched rows (``_stage_payload``). Numpy and pinned host memory
        only, so it may run on the lookahead lane while an earlier hop
        ships and runs; the payload carries its own hop time. A fold that
        moves the clock leaves its state in the fold cache
        ``checkpoint_to``, when given."""
        f0 = _time.perf_counter()
        time = int(time)
        if self.t_now is not None and time < self.t_now:
            if not self._stale:
                raise ValueError(
                    f"DeviceSweep times must ascend "
                    f"(got {time} < {self.t_now})")
            # stale rewind (a lookahead fold may have moved the clock past
            # the hop a caller retries): the fold only ascends, so rebuild
            # the builder from the pinned log and refold to `time`; the
            # stale path below restages the FULL state either way
            self.sw = SweepBuilder(self.sw.log, track_rows=False,
                                   preseed_pairs=True)
            self.t_now = None
        advanced = self.t_now is None or time > self.t_now
        if advanced:
            self.sw._advance(time)
            self.t_now = time
            self.sw.save_checkpoint(checkpoint_to)
        if self._stale:
            self._stale = False
            payload = {"time": time, "kind": "full",
                       "arrays": self._stage_full()}
        elif not advanced:   # repeat hop on healthy buffers: nothing to ship
            return {"time": time, "kind": "noop"}
        else:
            payload = self._stage_payload(self.sw, time)
        self._note_fold(_time.perf_counter() - f0, "serial")
        return payload

    def _note_fold(self, seconds: float, mode: str) -> None:
        self.fold_seconds += seconds
        self.fold_mode_seconds[mode] = (
            self.fold_mode_seconds.get(mode, 0.0) + seconds)

    def _stage_payload(self, sw, time: int) -> dict:
        """Staged payload for ``sw``'s LAST advance: noop / full refresh /
        padded delta chunks. The one staging policy of the engine-clock
        fold and the forked one (``_fold_hop_fork``)."""
        d = sw.last_delta
        nv, ne = len(d["v_idx"]), len(d["e_enc"])
        if nv == 0 and ne == 0:
            return {"time": time, "kind": "noop"}
        # full-state refresh (first hop, or a delta so large that chunked
        # scatters would ship more than the whole buffers)
        if nv > self.n_pad // 2 or ne > self.m_pad // 2:
            return {"time": time, "kind": "full",
                    "arrays": self._stage_full(sw)}
        e_pos = self.tables.eng_pos(d["e_enc"])
        n_chunks = max(-(-nv // self.cap_v), -(-ne // self.cap_e), 1)
        chunks = []
        for i in range(n_chunks):
            ov, oe = i * self.cap_v, i * self.cap_e
            chunks.append(self._stage_chunk(
                d["v_idx"][ov: ov + self.cap_v],
                d["v_lat"][ov: ov + self.cap_v],
                d["v_alive"][ov: ov + self.cap_v],
                d["v_first"][ov: ov + self.cap_v],
                e_pos[oe: oe + self.cap_e],
                d["e_lat"][oe: oe + self.cap_e],
                d["e_alive"][oe: oe + self.cap_e],
                d["e_first"][oe: oe + self.cap_e],
            ))
        return {"time": time, "kind": "chunks", "chunks": chunks}

    def _apply_staged(self, payload: dict) -> None:
        """Device half of one hop: ship the staged arrays and scatter them
        into the resident buffers (K9a), or swap in a full refresh."""
        kind = payload["kind"]
        if kind == "noop":
            return
        with TRACER.span("hop.ship", kind=kind, time=int(payload["time"])):
            self._apply_staged_inner(payload)

    def _apply_staged_inner(self, payload: dict) -> None:
        kind = payload["kind"]
        t0 = _time.perf_counter()
        try:
            if kind == "full":
                arrays = payload["arrays"]
                self.ship_bytes += sum(a.nbytes for a in arrays)
                self._bufs = tuple(torch.from_numpy(a).to(self.device)
                                   for a in arrays)
            else:
                for chunk in payload["chunks"]:
                    self.ship_bytes += chunk.payload_bytes
                    # one copy from pinned memory: the host does not wait
                    # (the caching host allocator keeps the block until the
                    # copy is done)
                    _ledger.instrument("device_sweep.apply",
                                       apply_delta_chunk)(
                        self._bufs, chunk._replace(data=chunk.data.to(
                            self.device, non_blocking=True)))
        except BaseException:
            # t_now already reflects this payload's fold but the buffers
            # may not — the next fold must take the full-refresh path
            self._stale = True
            raise
        finally:
            self.dispatch_seconds += _time.perf_counter() - t0

    def _cast_t(self, a: np.ndarray) -> np.ndarray:
        return self.tables.cast_times(a)

    def _stage_chunk(self, v_idx, v_lat, v_alive, v_first,
                     e_idx, e_lat, e_alive, e_first):
        """One delta chunk packed into one host byte buffer (pinned for a
        card), padded to the fixed capacities; pad rows carry the
        out-of-range index 2^31-1, which K9a skips."""
        cast = self._cast_t
        return pack_chunk(
            (v_idx, cast(v_lat), v_alive, cast(v_first),
             e_idx, cast(e_lat), e_alive, cast(e_first)),
            self.cap_v, self.cap_e, self._bufs[0].dtype,
            pin=self.device.type == "cuda")

    def _apply_chunk(self, v_idx, v_lat, v_alive, v_first,
                     e_idx, e_lat, e_alive, e_first) -> None:
        self._apply_staged({"time": self.t_now, "kind": "chunks",
                            "chunks": [self._stage_chunk(
                                v_idx, v_lat, v_alive, v_first,
                                e_idx, e_lat, e_alive, e_first)]})

    def _stage_full(self, sw=None) -> tuple:
        sw = self.sw if sw is None else sw
        tdt = self.tdtype
        v_lat = np.full(self.n_pad, self._tmin, tdt)
        v_alive = np.zeros(self.n_pad, bool)
        v_first = np.full(self.n_pad, self._tmin, tdt)
        v_lat[: self.n] = self._cast_t(sw.v_lat)
        v_alive[: self.n] = sw.v_alive
        v_first[: self.n] = self._cast_t(sw.v_first)
        e_lat = np.full(self.m_pad, self._tmin, tdt)
        e_alive = np.zeros(self.m_pad, bool)
        e_first = np.full(self.m_pad, self._tmin, tdt)
        pos = self.tables.eng_pos(sw.e_enc)
        e_lat[pos] = self._cast_t(sw.e_lat)
        e_alive[pos] = sw.e_alive
        e_first[pos] = self._cast_t(sw.e_first)
        return (v_lat, v_alive, v_first, e_lat, e_alive, e_first)

    def _refresh_full(self) -> None:
        self._apply_staged({"time": self.t_now, "kind": "full",
                            "arrays": self._stage_full()})

    # ---- program dispatch ----

    def run(self, program: VertexProgram, time: int | None = None, *,
            window: int | None = None, windows=None):
        """Advance to ``time`` (if given) and run ``program``; result rows
        are global dense vertex indices."""
        if not supported(program):
            raise ValueError(
                "program needs occurrences or host-materialised properties — "
                "run it through bsp.run / jobs instead")
        if time is not None:
            self.advance(time)
        if self.t_now is None:
            raise ValueError("call advance(T) (or pass time=) before run()")
        return self._dispatch(program, self.t_now, window, windows)

    def _dispatch(self, program: VertexProgram, T: int, window, windows):
        """Run ``program`` against the CURRENT resident buffers for hop
        time ``T`` (``device_sweep.py:261`` ``_compiled_run``): K9b masks,
        the times widened only for programs that read them, then the
        superstep engine."""
        from .bsp import make_mask_runner, tree_map

        batched = windows is not None
        if windows is not None and len(windows) == 0:
            raise ValueError("windows must be a non-empty list")
        if windows is None:
            windows = [window if window is not None else -1]
        wlist = normalize_windows(windows)
        # the device.dispatch failpoint: an injected error takes the path
        # a real dispatch failure takes
        _faults.fire("device.dispatch")
        t0 = _time.perf_counter()
        try:
            v_lat, v_alive, v_first, e_lat, e_alive, e_first = self._bufs
            v_masks, e_masks = window_masks(v_lat, v_alive, e_lat, e_alive,
                                            int(T), wlist)
            if program.needs_vertex_times:
                v_lat = _widen(v_lat, self._tmin)
                v_first = _widen(v_first, self._tmin)
            if program.needs_edge_times:
                e_lat = _widen(e_lat, self._tmin)
                e_first = _widen(e_first, self._tmin)
            runner = _ledger.instrument(
                f"device_sweep.superstep.{type(program).__name__}",
                make_mask_runner(program, self.n_pad, self.m_pad,
                                 len(wlist)))
            with TRACER.span("hop.compute", time=int(T), windows=len(wlist),
                             engine="device_sweep"):
                result, steps = runner(v_masks, e_masks, self.vids, v_lat,
                                       v_first, self.edges, e_lat, e_first,
                                       int(T), wlist, {}, {})
        finally:
            self.dispatch_seconds += _time.perf_counter() - t0
        if not batched:
            result = tree_map(lambda a: a[0], result)
        return result, steps

    def run_sweep(self, program: VertexProgram, times, *,
                  window: int | None = None, windows=None):
        """Ascending range sweep: returns ``(results, steps_list)`` with
        ``results[i]`` = ``run(program, times[i])``'s result, whatever the
        pipeline: the lookahead lane (``RTPU_PREFETCH``, on unless ``0``),
        forked segments where cached checkpoints cover their starts, or,
        with the prefetch off, the serial advance/run loop.
        ``fold_seconds``, ``fold_mode_seconds``, ``fold_stall_seconds``,
        ``dispatch_seconds`` and ``ship_bytes`` report this sweep alone."""
        if not supported(program):
            raise ValueError(
                "program needs occurrences or host-materialised properties — "
                "run it through bsp.run / jobs instead")
        times = [int(t) for t in times]
        if sorted(times) != times:
            raise ValueError("run_sweep times must ascend")
        from ..utils.transfer import shared_engine

        before = shared_engine().stats.as_dict()
        t_start = _time.perf_counter()
        with self._pin_lock, TRACER.span(
                "sweep.range", engine="device_sweep", hops=len(times),
                program=type(program).__name__) as sp:
            out = self._run_sweep(program, times, window, windows)
            self.last_phase_seconds = sweep_phase_summary(
                sp, _time.perf_counter() - t_start, self.fold_seconds,
                self.fold_stall_seconds,
                shared_engine().stats.delta_since(before),
                self.ship_bytes, len(times),
                fold_modes=self.fold_mode_seconds)
        return out

    def _run_sweep(self, program, times, window, windows):
        self.fold_seconds = self.dispatch_seconds = 0.0
        self.fold_mode_seconds = {}
        self.fold_stall_seconds = 0.0
        self.ship_bytes = 0
        results, steps = [], []

        def step(payload, stall):
            self.fold_stall_seconds += stall
            if stall > 0:
                TRACER.complete("fold.stall", stall,
                                time=int(payload["time"]))
            METRICS.h2d_stall_seconds.labels(stage="fold").inc(stall)
            self._apply_staged(payload)
            r, s = self._dispatch(program, payload["time"], window, windows)
            results.append(r)
            steps.append(s)

        if not prefetch_on() or len(times) <= 1:
            for T in times:
                t0 = _time.perf_counter()
                payload = self._fold_hop(T)
                step(payload, _time.perf_counter() - t0)
            return results, steps
        plan = self._sweep_plan(times)
        if plan is not None and not self._stale \
                and self.sw.covered(plan[2], plan[1][1:]):
            self._run_sweep_parallel(times, plan, step)
            return results, steps
        # the lane leaves checkpoints at the segments' starts
        at = set() if plan is None else set(plan[1][1:])
        cache = None if plan is None else plan[2]
        try:
            prefetch_map((partial(self._fold_hop, T,
                                  cache if T in at else None)
                          for T in times), step)
        except BaseException:
            # the lookahead fold may have moved t_now past the hop whose
            # dispatch failed: the buffers are behind the clock now
            self._stale = True
            raise
        return results, steps

    @staticmethod
    def _sweep_plan(times):
        """The forked sweep's plan ``(segments, starts, cache)``: up to
        ``fold_workers()`` contiguous segments of ``times`` and the time
        each one's fork starts from (None: the engine clock). None at one
        worker or with the fold cache off."""
        workers, cache = fold_workers(), fold_cache()
        if workers <= 1 or cache is None:
            return None
        per = -(-len(times) // min(workers, len(times)))
        segs = [times[o: o + per] for o in range(0, len(times), per)]
        starts = [None] + [int(segs[i - 1][-1]) for i in range(1, len(segs))]
        return segs, starts, cache

    def _run_sweep_parallel(self, times, plan, step) -> None:
        """Segment-parallel folds: each segment of ``plan`` folds and
        stages on its own fork of the builder, seeded at its start (a
        cached checkpoint), on ``fold_pool``, while ``step`` ships and runs
        the earlier hops on this thread. Each hop's payload is the serial
        fold's, so the state and results are too. The last fork becomes
        the engine's builder: the clock and the builder move only together,
        here."""
        if self.t_now is not None and times[0] < self.t_now:
            raise ValueError(f"DeviceSweep times must ascend "
                             f"(got {times[0]} < {self.t_now})")
        segs, starts, cache = plan

        def task(i: int):
            t0 = _time.perf_counter()
            with TRACER.span("hop.fold", hops=len(segs[i]),
                             engine="device_sweep", mode="parallel",
                             worker=threading.current_thread().name):
                sw = self.sw.fork() if starts[i] is None \
                    else self.sw.fork_at(starts[i], cache)
                prev = sw.t_prev
                payloads = []
                for T in segs[i]:
                    payloads.append(self._fold_hop_fork(sw, T, prev))
                    prev = T
            return sw, payloads, _time.perf_counter() - t0

        last_sw = [self.sw]

        def consume(res, stall):
            sw, payloads, dt = res
            self._note_fold(dt, "parallel")
            self.fold_stall_seconds += stall
            if stall > 0:
                TRACER.complete("fold.stall", stall)
            METRICS.h2d_stall_seconds.labels(stage="fold").inc(stall)
            METRICS.fold_seconds.labels("parallel").observe(dt)
            last_sw[0] = sw
            for payload in payloads:
                step(payload, 0.0)

        try:
            prefetch_map([partial(task, i) for i in range(len(segs))],
                         consume, depth=len(segs), pool=fold_pool())
        except BaseException:
            # a fork's payloads may be ahead of the applied buffers while
            # self.sw and t_now never moved: restage through the full
            # refresh
            self._stale = True
            raise
        self.sw = last_sw[0]
        self.t_now = times[-1]

    def _fold_hop_fork(self, sw, time: int, prev) -> dict:
        """``_fold_hop_inner`` on a forked builder: fold events in (prev,
        time] and stage the touched rows. The engine's clock, stale flag
        and telemetry are the calling loop's business."""
        time = int(time)
        with TRACER.span("hop.fold", time=time,
                         engine="device_sweep") as sp:
            if prev is not None and time <= prev:
                sp.set(kind="noop")
                return {"time": time, "kind": "noop"}
            sw._advance(time)
            payload = self._stage_payload(sw, time)
            sp.set(kind=payload["kind"])
            return payload
