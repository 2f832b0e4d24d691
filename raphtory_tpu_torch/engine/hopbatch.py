"""Hop-batched columnar PageRank — a whole range sweep as columns of one pass.

Every (hop, window) view of a Range query is a COLUMN of one column-batched
power iteration: the per-edge access becomes a C-wide row move, and the
temporal dimension is captured as per-hop fold state rebuilt on the device
from a base snapshot plus the host fold's per-hop touched-entity deltas
(deletes and revivals included, not an add-only approximation).

Port of ``raphtory_tpu/engine/hopbatch.py`` on its serial delta-fold path:
the host fold is the same numpy/C++ code, and the device side runs the
hand-written kernels of ``ops/columns.py`` — K1 (``masks_from_deltas``)
rebuilds the masks, K2a (``column_out_degree``) and K2b
(``column_pull_sum``) carry the power iteration's edge passes, and K2c
(``pagerank_update``) its superstep epilogue (dangling mass, damping, tol
halting with frozen columns); the per-dispatch start ranks stay in torch
ops. Semantics match ``algorithms/pagerank.py``. The iteration loops on
the host and reads one all-halted flag per superstep.

Reference contrast: one pass per RANGE QUERY, where the reference runs its
full actor handshake once per hop (``RangeAnalysisTask.scala:18-35``).
"""

from __future__ import annotations

import logging
import time as _time

import numpy as np
import torch

from ..core.events import EventLog
from ..core.sweep import SweepBuilder
from ..ops import columns
from ..utils.device import resolve_device
from .device_sweep import GlobalTables, _device_edges, normalize_windows

_log = logging.getLogger(__name__)


def _column_layout(hop_times, windows):
    """Hop-major (hop 0's windows first) column layout — the ONE place the
    ordering is defined."""
    H = len(hop_times)
    wlist = normalize_windows(windows)
    hop_of_col = np.repeat(np.arange(H, dtype=np.int32), len(wlist))
    T_col = np.asarray([int(x) for x in hop_times], np.int64)[hop_of_col]
    w_col = np.asarray(wlist * H, np.int64)
    return H, H * len(wlist), hop_of_col, T_col, w_col


def _pad_hop_deltas(deltas, H: int, tdt):
    """Pad per-hop (pos, lat, alive) delta lists to a fixed ``[H, U]``
    shape (hop 0 is empty: its state IS the base). Pad index 2^31-1 lies
    past every table and is skipped by the device scatter."""
    longest = max((len(p) for p, _, _ in deltas), default=1)
    U = max(256, 1 << int(np.ceil(np.log2(max(longest, 1)))))
    pos = np.full((H, U), 2**31 - 1, np.int32)
    lat = np.zeros((H, U), tdt)
    alive = np.zeros((H, U), bool)
    for h, (p, l, a) in enumerate(deltas):
        pos[h, : len(p)] = p
        lat[h, : len(l)] = l
        alive[h, : len(a)] = a
    return U, pos, lat, alive


def _pagerank_columns(me, mv, e_src, e_dst, indptr, n_pad: int,
                      damping: float, tol: float, max_steps: int,
                      r_init=None):
    """Power iteration over per-column masks ``me [m_pad, C]`` /
    ``mv [n_pad, C]`` — dangling redistribution, tol halting with
    converged-column freeze; semantics of ``algorithms/pagerank.py``.

    ``r_init`` (optional ``[n_pad, C]``) warm-starts the iteration: the
    update is a contraction, so ANY masked positive start converges to the
    SAME fixed point. Each column is masked to its own alive set, floored so
    newly-alive vertices get mass, and renormalised.

    Returns ``(ranks [C, n_pad], supersteps run)``. Edges are
    (dst, src)-sorted with their destination CSR ``indptr``."""
    out_deg = columns.column_out_degree(me, e_src, n_pad)
    n_act = torch.clamp(mv.to(torch.float32).sum(0), min=1.0)
    r = torch.where(mv, (1.0 / n_act)[None, :], 0.0)
    if r_init is not None:
        warm = torch.where(mv, torch.clamp(r_init, min=0.0), 0.0)
        warm = warm + torch.where(mv, torch.div(columns.f32(0.1, n_act),
                                                n_act)[None, :], 0.0)
        r = warm / torch.clamp(warm.sum(0, keepdim=True), min=1e-30)
    st = columns.rank_state(r.contiguous())
    columns.pagerank_update(st, None, out_deg, mv, n_act, damping, tol,
                            prime=True)
    steps = 0
    # the reference's while_loop condition, read on the host: one
    # all-halted flag per superstep
    while steps < max_steps and not bool(st.done):
        agg = columns.column_pull_sum(me, st.rd, e_src, e_dst, indptr)
        columns.pagerank_update(st, agg, out_deg, mv, n_act, damping, tol)
        steps += 1
    return st.r.t(), steps


def run_columns_delta(kind, tables, base, deltas_e, deltas_v, hop_times,
                      windows, *, algo_args: tuple, edges, r_init=None,
                      h0_delta: bool = False, ship_counter=None):
    """Dispatch the delta-fed columnar PageRank over
    ``_HopBatched._fold_deltas`` output; returns ``(ranks [H*W, n_pad],
    steps, advanced_base)``. ``base`` is a host snapshot (numpy) or, with
    ``h0_delta=True``, the previous dispatch's device-resident advanced
    state, in which case delta[0] carries the inter-batch catch-up and the
    dispatch ships O(Σ delta) bytes. ``edges`` is the device
    ``(e_src, e_dst, in_indptr)``; ``r_init`` is the previous chunk's full
    ``[C_prev, n_pad]`` output (its last hop's W rows seed every hop)."""
    if kind != "pagerank":
        raise NotImplementedError(
            f"columnar kind {kind!r}: CC/BFS/SSSP columns come with ROADMAP "
            "queue 1 item 2 (kernels K5, K6)")
    damping, tol, max_steps = algo_args
    H, C, _, T_col, w_col = _column_layout(hop_times, windows)
    W = C // H
    tdt = tables.tdtype
    _, de_pos, de_lat, de_alive = _pad_hop_deltas(deltas_e, H, tdt)
    _, dv_pos, dv_lat, dv_alive = _pad_hop_deltas(deltas_v, H, tdt)
    if ship_counter is not None:
        # FOLD-STATE host→device payload of THIS dispatch (padded shapes;
        # a device-resident h0 base and the cached tables ship nothing)
        shipped = [de_pos, de_lat, de_alive, dv_pos, dv_lat, dv_alive]
        if not h0_delta:
            shipped += list(base)
        ship_counter(int(sum(a.nbytes for a in shipped)))
    e_src, e_dst, indptr = edges
    dev = e_src.device

    def put(a):
        return torch.from_numpy(a).to(dev) if isinstance(a, np.ndarray) \
            else a

    info = np.iinfo(tdt)
    lo = put(np.clip(T_col - w_col, info.min, info.max).astype(tdt))
    nowin = put(w_col < 0)
    be_lat, be_alive, bv_lat, bv_alive = (put(a) for a in base)
    me, fe_lat, fe_alive = columns.masks_from_deltas(
        be_lat, be_alive, put(de_pos), put(de_lat), put(de_alive),
        lo, nowin, H, W, h0_delta)
    mv, fv_lat, fv_alive = columns.masks_from_deltas(
        bv_lat, bv_alive, put(dv_pos), put(dv_lat), put(dv_alive),
        lo, nowin, H, W, h0_delta)
    r0 = None
    if r_init is not None:
        r0 = r_init[-W:].repeat(H, 1).t().contiguous()
    out, steps = _pagerank_columns(me, mv, e_src, e_dst, indptr,
                                   tables.n_pad, damping, tol, max_steps,
                                   r_init=r0)
    return out, steps, (fe_lat, fe_alive, fv_lat, fv_alive)


class _HopBatched:
    """Shared incremental fold → per-hop state deltas (deletes included).

    ``run(hop_times, windows, chunks=k)`` splits the sweep into ``k`` equal
    hop groups, each folded on the host and then dispatched; the first
    group ships a base snapshot, later groups only deltas onto the
    device-resident advanced base. Results match ``chunks=1`` (hop-major
    concatenation, within solver tolerance for PageRank)."""

    #: set True by subclasses whose iteration is a contraction (safe to
    #: warm-start from the previous chunk's solution)
    supports_warm_start = False

    def __init__(self, log: EventLog, device=None):
        self.device = resolve_device(device)
        # fold state only — the columnar engine never emits GraphViews
        self.sw = SweepBuilder(log, track_rows=False, preseed_pairs=True)
        self.tables = GlobalTables(self.sw)
        # cache key for the device edge tables: the CALLER's log object
        # (sw.log is a fresh pin per engine and would never hit)
        self._log = log
        #: host seconds spent folding in the LAST run()
        self.fold_seconds = 0.0
        #: host wall seconds the LAST run() spent in its dispatches (H2D,
        #: kernels and the superstep loop, which waits on the device once
        #: per superstep)
        self.dispatch_seconds = 0.0
        #: host→device FOLD-STATE payload bytes of the LAST run() (the
        #: per-log static tables ship once and are excluded)
        self.ship_bytes = 0
        # running host base for the delta fold (built on first use)
        self._delta_base = None
        # device-resident advanced base: the last dispatch's post-final-hop
        # fold state, fed back as the next dispatch's base so follow-on
        # chunks and batches ship only deltas
        self._dev_base = None

    @property
    def _edges(self):
        return _device_edges(self._log, self.tables, self.device)

    def host_column_bytes(self, n_hops: int) -> int:
        """Host bytes the delta fold materialises for a sweep: O(base),
        whatever ``n_hops``. Routing layers size admission guards from
        THIS, not from engine internals."""
        t = self.tables
        return (t.m_pad + t.n_pad) * (np.dtype(t.tdtype).itemsize + 1)

    def device_mask_bytes(self, n_cols: int) -> int:
        """Device bytes of the [m_pad+n_pad, C] bool masks every columnar
        pass holds across its superstep loop."""
        return (self.tables.m_pad + self.tables.n_pad) * n_cols

    def _dispatch_deltas(self, payload, hop_times, windows, r_init=None):
        raise NotImplementedError

    def _delta_base_args(self, ship_base):
        """(base_for_dispatch, h0_delta): the device-resident advanced
        state when the fold shipped no base snapshot, else the host
        snapshot (first batch, or residency was dropped)."""
        if ship_base is None:
            return tuple(self._dev_base), True
        return ship_base, False

    def _count_ship(self, nbytes: int) -> None:
        self.ship_bytes += int(nbytes)

    def _run_delta(self, fn):
        """Run a delta dispatch and keep its advanced base device-resident;
        a failure drops residency so the next batch ships a fresh base."""
        try:
            out, steps, adv = fn()
        except Exception:
            self._dev_base = None
            raise
        self._dev_base = adv
        return out, steps

    def run(self, hop_times, windows, chunks: int = 1,
            warm_start: bool = False, hop_callback=None):
        """Returns ``(ranks [H*W, n_pad] on the engine's device, steps)``;
        ``steps`` is the max over chunks. ``warm_start=True`` initialises
        each chunk's columns from the previous chunk's LAST-hop ranks (same
        fixed point, reached in fewer steps when consecutive hops differ
        little); warm results agree with cold ones to the solver
        tolerance. ``hop_callback(T, sweep_builder)`` fires after each
        hop's fold."""
        self.fold_seconds = 0.0
        self.dispatch_seconds = 0.0
        self.ship_bytes = 0
        if warm_start and not self.supports_warm_start:
            raise ValueError(
                f"{type(self).__name__} cannot warm-start: its superstep "
                "is not a contraction (stale state would be wrong, not "
                "just slower)")
        hop_times = [int(x) for x in hop_times]
        chunks = max(1, min(int(chunks), len(hop_times)))
        try:
            return self._run_chunks(hop_times, windows, chunks, warm_start,
                                    hop_callback)
        except Exception:
            # a mid-run failure may leave the host fold ahead of the
            # device-resident base, and an advance that aborted before
            # _apply_delta_to_base leaves the running host base missing
            # that window: drop both, the next batch re-materialises
            self._dev_base = None
            self._delta_base = None
            raise

    def _run_chunks(self, hop_times, windows, chunks, warm_start,
                    hop_callback):
        self._check_forward(hop_times)
        if chunks == 1 or len(hop_times) % chunks:
            # unequal groups are not pipelined: one dispatch
            if warm_start and chunks > 1:
                _log.warning(
                    "%d hops do not split into %d equal chunks — running "
                    "one cold dispatch (warm_start has no effect)",
                    len(hop_times), chunks)
            groups = [list(hop_times)]
        else:
            per = len(hop_times) // chunks
            groups = [hop_times[c * per: (c + 1) * per]
                      for c in range(chunks)]
        outs, steps = [], 0
        for group in groups:
            _, payload = self._fold_deltas(group, hop_callback)
            # warm start: the previous chunk's FULL output; its last hop's
            # W rows are tiled per hop of this group inside the dispatch
            r_init = outs[-1] if warm_start and outs else None
            d0 = _time.perf_counter()
            out, st = self._dispatch_deltas(payload, group, windows,
                                            r_init=r_init)
            self.dispatch_seconds += _time.perf_counter() - d0
            outs.append(out)
            steps = max(steps, st)
        return torch.cat(outs, dim=0), steps

    def _check_forward(self, hop_times) -> None:
        if sorted(hop_times) != hop_times:
            raise ValueError("hop_times must ascend")
        if self.sw.t_prev is not None and hop_times[0] < self.sw.t_prev:
            # the incremental fold only moves forward; a backward batch on
            # the advanced clock would silently fold nothing
            raise ValueError(
                f"hop_times must continue forward from the previous batch "
                f"(got {hop_times[0]} < {self.sw.t_prev}); build a fresh "
                f"{type(self).__name__} to go back in history")

    def _materialise_base(self, sw):
        """Full engine-coordinate base arrays from a builder's fold state
        (the delta path's hop-0 snapshot)."""
        t = self.tables
        tdt = t.tdtype
        be_lat = np.full(t.m_pad, t.tmin, tdt)
        be_alive = np.zeros(t.m_pad, bool)
        pos = t.eng_pos(sw.e_enc)
        be_lat[pos] = t.cast_times(sw.e_lat)
        be_alive[pos] = sw.e_alive
        bv_lat = np.full(t.n_pad, t.tmin, tdt)
        bv_alive = np.zeros(t.n_pad, bool)
        nv = len(sw.uv)
        bv_lat[:nv] = t.cast_times(sw.v_lat)
        bv_alive[:nv] = sw.v_alive
        return (be_lat, be_alive, bv_lat, bv_alive)

    def _delta_eng(self, d):
        """``sweep.last_delta`` → engine-coordinate (pos, lat, alive)
        triples for edges and vertices."""
        t = self.tables
        de = (t.eng_pos(d["e_enc"]).astype(np.int32),
              t.cast_times(d["e_lat"]), d["e_alive"].astype(bool))
        dv = (d["v_idx"].astype(np.int32), t.cast_times(d["v_lat"]),
              d["v_alive"].astype(bool))
        return de, dv

    def _apply_delta_to_base(self):
        """Scatter the sweep's last delta into the RUNNING host base
        (O(delta)); returns the delta in engine coordinates."""
        de, dv = self._delta_eng(self.sw.last_delta)
        be_lat, be_alive, bv_lat, bv_alive = self._delta_base
        be_lat[de[0]] = de[1]
        be_alive[de[0]] = de[2]
        bv_lat[dv[0]] = dv[1]
        bv_alive[dv[0]] = dv[2]
        return de, dv

    def _fold_deltas(self, hop_times, hop_callback=None):
        """Delta fold: the state at each batch's first hop (the base) plus
        per-hop touched-entity (pos, lat, alive) lists — the device
        rebuilds the hop columns (K1). Host work and H2D bytes are
        O(base + Σ delta) instead of O(H · m_pad). The base is a RUNNING
        array updated by O(delta) scatters, so chunked sweeps pay the
        full-table materialisation once, not per chunk; with a live
        device-resident base the batch ships no base at all."""
        f0 = _time.perf_counter()
        hop_times = [int(x) for x in hop_times]
        self._check_forward(hop_times)
        tdt = self.tables.tdtype
        deltas_e, deltas_v = [], []
        ship_base = None
        # a live device-resident base makes this batch all-delta: hop 0's
        # catch-up ships in the delta[0] slot instead of a base snapshot
        resident = self._dev_base is not None and self._delta_base is not None
        empty = (np.empty(0, np.int32), np.empty(0, tdt),
                 np.empty(0, bool))
        for j, T in enumerate(hop_times):
            self.sw._advance(T)
            if hop_callback is not None:
                hop_callback(T, self.sw)
            if self._delta_base is None:
                # first batch, first hop: materialise from the full fold
                self._delta_base = list(self._materialise_base(self.sw))
            else:
                de, dv = self._apply_delta_to_base()
                if j > 0 or resident:
                    deltas_e.append(de)
                    deltas_v.append(dv)
            if j == 0 and not resident:
                # snapshot the running base as this batch's upload (the
                # arrays keep mutating through later hops)
                ship_base = tuple(a.copy() for a in self._delta_base)
                deltas_e.append(empty)
                deltas_v.append(empty)
        self.fold_seconds += _time.perf_counter() - f0
        return hop_times, (ship_base, deltas_e, deltas_v)


class HopBatchedPageRank(_HopBatched):
    """Windowed PageRank over a full hop sweep.

    ``run(hop_times, windows)`` returns ``(ranks, steps)`` with ranks
    ``[H*W, n_pad]`` ordered hop-major (hop 0's windows first), rows in the
    global dense vertex space (``self.tables.uv``), on the engine's device.
    ``device=None`` means the CUDA card (and raises without one).
    """

    supports_warm_start = True   # power iteration is a contraction

    def __init__(self, log: EventLog, damping: float = 0.85,
                 tol: float = 1e-7, max_steps: int = 20, device=None):
        super().__init__(log, device=device)
        self.damping, self.tol, self.max_steps = damping, tol, max_steps

    def _dispatch_deltas(self, payload, hop_times, windows, r_init=None):
        base, deltas_e, deltas_v = payload
        base, h0 = self._delta_base_args(base)
        return self._run_delta(lambda: run_columns_delta(
            "pagerank", self.tables, base, deltas_e, deltas_v,
            hop_times, windows,
            algo_args=(float(self.damping), float(self.tol),
                       int(self.max_steps)),
            edges=self._edges, r_init=r_init, h0_delta=h0,
            ship_counter=self._count_ship))
