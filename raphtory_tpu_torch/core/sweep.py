"""Incremental range-sweep view builder — delta-applied snapshots.

The reference re-runs the full per-timestamp handshake for every hop of a
Range query (``Tasks/RangeTasks/RangeAnalysisTask.scala:18-35`` — fresh
``TimeCheck``/``Setup`` per timestamp) and ``build_view`` likewise re-folds
the whole event log per hop. For an ascending sweep T0 < T1 < ... over a
pinned log that is wasteful: the fold state at T_{i+1} differs from T_i only
by the events with time in (T_i, T_{i+1}].

``SweepBuilder`` keeps the running fold state and applies each hop's delta:

* a fixed dense vertex dictionary is built once from the whole pinned log,
  so vertex fold state lives in flat dense arrays (O(delta) updates, no
  merging), and an edge (s, d) packs into ONE int64 key
  ``dense_s << 32 | dense_d`` — every edge-state merge is a single-key
  searchsorted, and the delta fold runs the native single-key kernel.
* cross-entity tombstones (vertex delete ⇒ incident-edge dead marks,
  ``Edge.killList`` semantics, ``Edge.scala:36-44``) are generated
  incrementally: delta deletes join against all pairs known so far (both
  src- and dst-sorted key arrays are maintained), and pairs first seen in
  this delta join against the full delete history — reproducing exactly the
  all-pairs × all-deletes join of ``build_view``.

Each ``view_at(T)`` emits a ``GraphView`` bit-identical to
``build_view(log, T)``; the columnar engine reads only the fold state and
``last_delta``.

The fold pipeline (``raphtory_tpu/core/sweep.py``'s, with its knobs and
defaults): ``_advance`` overlaps the vertex fold with the edge fold on a
worker pool; ``prefetch_map`` runs folds ahead of the dispatch that
consumes them (``RTPU_PREFETCH``, ``prefetch_on``); ``checkpoint`` /
``fork`` give independent builders whose chunk folds run concurrently on
``fold_pool`` (``RTPU_FOLD_WORKERS``); and ``FoldCache`` keeps fork
checkpoints across requests under one byte bound (``RTPU_FOLD_CACHE_MB``).
A fork seeded without a checkpoint folds its whole prefix again, so the
engines fork only where cached checkpoints cover every fork's start
(``SweepBuilder.covered``); otherwise they fold on the serial lane and
leave the checkpoints there (``save_checkpoint``). Worker threads overlap
only where numpy and the native library's ctypes calls drop the GIL.
"""

from __future__ import annotations

import bisect
import collections
import os
import threading
import time as _time
from concurrent.futures import ThreadPoolExecutor, wait

import numpy as np

from ..obs.trace import TRACER
from .events import EDGE_ADD, EDGE_DELETE, VERTEX_ADD, VERTEX_DELETE, EventLog
from .snapshot import (
    INT64_MIN,
    GraphView,
    _assemble_view,
    _expand_ranges,
    _fold_latest,
    build_view,
)

_ENC_SHIFT = 32
_ENC_MASK = (1 << _ENC_SHIFT) - 1

_EMPTY_DELTA = {
    "v_idx": np.empty(0, np.int64), "v_lat": np.empty(0, np.int64),
    "v_alive": np.empty(0, bool), "v_first": np.empty(0, np.int64),
    "e_enc": np.empty(0, np.int64), "e_lat": np.empty(0, np.int64),
    "e_alive": np.empty(0, bool), "e_first": np.empty(0, np.int64),
}


# ------------------------------------------------------------ fold pools

def fold_workers() -> int:
    """Size of the chunk-fold worker pool (``RTPU_FOLD_WORKERS``): half the
    cores plus one, at most 8, by default; ``1`` keeps every engine on its
    serial fold."""
    v = os.environ.get("RTPU_FOLD_WORKERS")
    if v is not None:
        return max(1, int(v))
    return max(1, min(8, (os.cpu_count() or 2) // 2 + 1))


class _SizedPools:
    """Process-wide thread pools keyed by their size: a knob change gets
    a pool of the new size instead of a stale cached one."""

    def __init__(self, prefix: str):
        self.prefix = prefix
        self._pools: dict = {}
        self._lock = threading.Lock()

    def get(self, n: int) -> ThreadPoolExecutor:
        with self._lock:
            pool = self._pools.get(n)
            if pool is None:
                pool = ThreadPoolExecutor(max_workers=n,
                                          thread_name_prefix=self.prefix)
                self._pools[n] = pool
            return pool


# three separate pools: a chunk fold BLOCKS on its inner vertex fold, so
# a pool shared with it could hold the very worker that fold needs
_VFOLD_POOLS = _SizedPools("sweep-vfold")
_FOLD_POOLS = _SizedPools("sweep-fold")
_PREFETCH_POOLS = _SizedPools("sweep-prefetch")


def _vfold_pool() -> ThreadPoolExecutor:
    """The overlapped vertex folds of ``_advance``: every concurrent chunk
    fold blocks on one, so the pool is at least as large as ``fold_pool``
    (and 2 for the serial engines' prefetch lane beside a caller)."""
    return _VFOLD_POOLS.get(max(2, fold_workers()))


def fold_pool() -> ThreadPoolExecutor:
    """INDEPENDENT chunk folds, each on its own forked builder, sized by
    ``fold_workers()``."""
    return _FOLD_POOLS.get(fold_workers())


def _prefetch_pool() -> ThreadPoolExecutor:
    """The lookahead lane: ONE worker, so folds that advance one shared
    builder run one at a time, in the order they were submitted."""
    return _PREFETCH_POOLS.get(1)


def prefetch_on() -> bool:
    """The engines' lookahead switch (``RTPU_PREFETCH``, on unless ``0``);
    off, every engine folds and dispatches in turn on the calling thread."""
    return os.environ.get("RTPU_PREFETCH", "1") != "0"


#: folds queued or running on the one-worker lane ahead of the one the
#: dispatch loop consumes
PREFETCH_DEPTH = 2


def prefetch_map(fold_fns, body, *, depth: int = PREFETCH_DEPTH,
                 pool=None) -> None:
    """Run ``fold_fns`` (zero-argument callables) on ``pool`` with
    ``depth`` of them in flight, and call ``body(result, stall_seconds)``
    for each result ON THE CALLING THREAD, in order, while the next folds
    run. ``stall_seconds`` is how long the caller waited for that fold (0:
    it hid behind the previous body). ``pool`` defaults to the one-worker
    lane (``_prefetch_pool``), the only safe pool for folds that share a
    builder; pass ``fold_pool()`` for independent folds. If a fold or a
    body raises, every fold in flight is drained before the exception
    propagates: the caller's handler must not reset state under a fold
    that still runs."""
    fns = list(fold_fns)
    if not fns:
        return
    depth = max(1, depth)
    pool = _prefetch_pool() if pool is None else pool
    # each fold adopts the submitting thread's trace context, so one
    # request's spans stay one trace across the pool (obs/trace.py)
    if TRACER.enabled:
        fns = [TRACER.carry(fn) for fn in fns]
    inflight = collections.deque(
        pool.submit(fns[i]) for i in range(min(depth, len(fns))))
    nxt = len(inflight)
    try:
        for _ in range(len(fns)):
            fut = inflight.popleft()
            t0 = _time.perf_counter()
            result = fut.result()
            stall = _time.perf_counter() - t0
            if nxt < len(fns):
                inflight.append(pool.submit(fns[nxt]))
                nxt += 1
            body(result, stall)
    except BaseException:
        wait(inflight)
        raise


# ----------------------------------------------------- checkpoint / fork
#
# The three lists below are read off ``SweepBuilder.__init__`` and
# ``_advance``; every array attribute of a builder is in exactly one
# (tests/test_torch_fold_parallel.py checks it).

#: set in ``__init__`` and never written again: forks share them
_LOG_DERIVED = ("log", "include_occurrences", "pad", "track_rows",
                "_t", "_k", "_s", "_d", "uv", "_ok", "_sd_all", "_dd_all",
                "_t_sorted", "_preseeded")
#: written IN PLACE by ``_advance`` (the vertex fold's four arrays; the
#: known pairs' overwrite of the edge state): checkpoints and forks copy
_STATE_COPIED = ("v_lat", "v_alive", "v_first", "v_seen",
                 "e_lat", "e_alive", "e_first", "e_seen")
#: only ever REBOUND by ``_advance`` (``np.insert`` / ``np.concatenate`` /
#: a reorder build new arrays): a checkpoint or a fork holds the reference
_STATE_SHARED = ("e_enc", "e_enc_dst", "dh_v", "dh_t",
                 "_ea_rows", "_va_rows")


class FoldCheckpoint:
    """A ``SweepBuilder``'s fold state at ``t_prev``, the seed of
    ``SweepBuilder.fork``. Checkpoints of any builder over the same log
    content are interchangeable (the dense spaces are functions of the
    content), which lets the fold cache hand them across requests;
    ``config`` keeps builders with other emit / preseed settings apart."""

    __slots__ = ("t_prev", "state", "config", "nbytes")

    def __init__(self, t_prev, state: dict, config: tuple):
        self.t_prev = t_prev
        self.state = state
        self.config = config
        self.nbytes = int(sum(a.nbytes for a in state.values()))


class SweepBuilder:
    """Build views at ascending timestamps over a pinned log, incrementally.

    For out-of-order `view_at` times, or once the dense dictionary would
    overflow the 32-bit pack, it falls back to full ``build_view`` per call.
    """

    def __init__(self, log: EventLog, *, include_occurrences: bool = False,
                 pad: str = "pow2", track_rows: bool = True,
                 preseed_pairs: bool = False):
        if include_occurrences and not track_rows:
            raise ValueError("occurrence views need the add-row lists")
        self.log = log.pin()
        self.include_occurrences = include_occurrences
        self.pad = pad
        self.track_rows = track_rows
        self._t = self.log.column("time")
        self._k = self.log.column("kind")
        self._s = self.log.column("src")
        self._d = self.log.column("dst")
        # dense dictionary over every vertex id the log ever mentions. dst is
        # only a vertex id on edge events — vertex events carry a -1 sentinel
        # there, and REAL ids can be negative (assign_id hashes to signed
        # int64), so select by kind, never by sign.
        is_e = (self._k == EDGE_ADD) | (self._k == EDGE_DELETE)
        d_real = self._d[is_e]
        # per-row dense ids, computed ONCE as the inverse of the dictionary's
        # own sort: per-hop _advance slices these instead of searching the
        # dictionary for every delta. (The reference searchsorts each row's
        # ids into ``uv`` and skips the table above 2^23 events; unsorted
        # lookups into a multi-MB dictionary were the dominant host cost of
        # the 2^25-event scale sweep. Same ids: ``uv`` holds unique values.)
        if len(self._s):
            self.uv, inv = np.unique(np.concatenate([self._s, d_real]),
                                     return_inverse=True)
            inv = inv.reshape(-1)
        else:
            self.uv, inv = np.empty(0, np.int64), None
        self._ok = len(self.uv) < (1 << 31)
        if self._ok and inv is not None:
            self._sd_all = inv[: len(self._s)]
            self._dd_all = np.zeros(len(self._d), np.int64)
            self._dd_all[is_e] = inv[len(self._s):]
        else:
            self._sd_all = self._dd_all = None
        nv = len(self.uv)
        # dense vertex fold state
        self.v_lat = np.full(nv, INT64_MIN, np.int64)
        self.v_alive = np.zeros(nv, bool)
        self.v_first = np.full(nv, INT64_MIN, np.int64)
        self.v_seen = np.zeros(nv, bool)
        # edge fold state keyed by packed (dense_s, dense_d); enc-sorted
        self.e_enc = np.empty(0, np.int64)
        self.e_lat = np.empty(0, np.int64)
        self.e_alive = np.empty(0, bool)
        self.e_first = np.empty(0, np.int64)
        # the same pair keys packed (dense_d, dense_s), kept sorted — the
        # dst-incidence index for tombstone joins
        self.e_enc_dst = np.empty(0, np.int64)
        # preseed: start the pair table with EVERY pair the log ever
        # mentions (alive=False, times at the sentinel). No pair is ever
        # "fresh" afterwards, so the per-hop sorted inserts and the
        # history-vs-new-pair joins vanish; the per-hop incident join over
        # all pairs generates exactly build_view's all-pairs × all-deletes
        # killList marks (a dead mark before a pair's first add loses to
        # the later add in the latest-wins fold — same outcome as the
        # historical join it replaces). The columnar engines opt in;
        # semantics stay bit-identical (tested against build_view).
        self.e_seen = np.empty(0, bool)   # pair has real marks (firsts set)
        self._preseeded = False
        if preseed_pairs and self._ok and is_e.any():
            enc_all = np.unique(self._pack(self._sd_all[is_e],
                                           self._dd_all[is_e]))
            self.e_enc = enc_all
            self.e_lat = np.full(len(enc_all), INT64_MIN, np.int64)
            self.e_alive = np.zeros(len(enc_all), bool)
            self.e_first = np.full(len(enc_all), INT64_MIN, np.int64)
            self.e_seen = np.zeros(len(enc_all), bool)
            self.e_enc_dst = np.sort(
                ((enc_all & _ENC_MASK) << _ENC_SHIFT)
                | (enc_all >> _ENC_SHIFT))
            self._preseeded = True
        # delete history: (dense vertex, time), sorted by vertex
        self.dh_v = np.empty(0, np.int64)
        self.dh_t = np.empty(0, np.int64)
        # in-time add-event row lists (property joins), ascending, grown
        # per delta — deltas are selected by event TIME, so their row
        # indices interleave with earlier hops' and need a sorted merge
        self._ea_rows = np.empty(0, np.int64)
        self._va_rows = np.empty(0, np.int64)
        self.t_prev: int | None = None
        # per-hop row selection: binary search when the log is time-sorted
        # (bulk loads, replayed dumps), O(N) boolean scan otherwise
        self._t_sorted = bool(
            len(self._t) == 0 or bool((self._t[:-1] <= self._t[1:]).all()))
        # last hop's touched-entity delta (dense vertex indices + packed edge
        # keys with their POST-update fold state) — consumed by the columnar
        # engine (engine/hopbatch.py), which ships only these O(delta) rows
        # to the device instead of fresh O(m) arrays
        self.last_delta: dict | None = None

    # ---- helpers ----

    def _dense(self, ids: np.ndarray) -> np.ndarray:
        return np.searchsorted(self.uv, ids)

    def _pack(self, ds: np.ndarray, dd: np.ndarray) -> np.ndarray:
        return (ds << _ENC_SHIFT) | dd

    def _incident(self, enc_sorted: np.ndarray, dv: np.ndarray, dt: np.ndarray,
                  flip: bool):
        """Dead marks (enc, t) for pairs in `enc_sorted` whose FIRST packed
        component is in dv. flip=True means enc_sorted is (d, s)-packed and
        results are re-packed as (s, d)."""
        lo = np.searchsorted(enc_sorted, dv << _ENC_SHIFT, side="left")
        hi = np.searchsorted(enc_sorted, (dv + 1) << _ENC_SHIFT, side="left")
        rows, qidx = _expand_ranges(lo, hi)
        enc = enc_sorted[rows]
        if flip:
            enc = ((enc & _ENC_MASK) << _ENC_SHIFT) | (enc >> _ENC_SHIFT)
        return enc, dt[qidx]

    # ---- checkpoint / fork ----

    def _config(self) -> tuple:
        return (self.include_occurrences, self.pad, self.track_rows,
                self._preseeded, len(self.uv), len(self._t))

    def state_nbytes(self) -> int:
        """Bytes of the fold state a ``checkpoint`` holds (what the fold
        cache counts it at), computed without taking one."""
        return int(sum(getattr(self, k).nbytes
                       for k in _STATE_COPIED + _STATE_SHARED))

    def checkpoint(self) -> FoldCheckpoint:
        """The fold state at the current ``t_prev``: the arrays ``_advance``
        writes in place are copied, those it only rebinds are shared."""
        state = {k: getattr(self, k).copy() for k in _STATE_COPIED}
        state.update({k: getattr(self, k) for k in _STATE_SHARED})
        return FoldCheckpoint(self.t_prev, state, self._config())

    def fork(self, cp: FoldCheckpoint | None = None) -> "SweepBuilder":
        """An INDEPENDENT builder over the same pinned log, seeded from
        ``cp`` (or from this builder's current state): it shares the
        log-derived arrays and copies the fold state, so the fork and its
        source advance without seeing each other. The fold state at T is a
        function of (log, T) alone, so a fork's views equal the serial
        builder's whatever hops reached them."""
        if cp is not None and cp.config != self._config():
            raise ValueError(
                "checkpoint was taken from an incompatible SweepBuilder "
                f"(config {cp.config} != {self._config()}): fold "
                "checkpoints only transfer between builders over the same "
                "pinned log content and emit settings")
        src = cp.state if cp is not None else vars(self)
        sw = SweepBuilder.__new__(SweepBuilder)
        for k in _LOG_DERIVED:
            setattr(sw, k, getattr(self, k))
        for k in _STATE_COPIED:
            setattr(sw, k, src[k].copy())
        for k in _STATE_SHARED:
            setattr(sw, k, src[k])
        sw.t_prev = cp.t_prev if cp is not None else self.t_prev
        sw.last_delta = None
        return sw

    def covered(self, cache, times) -> bool:
        """Whether forks can start at each of ``times`` without folding a
        prefix again: this builder is there already, or ``cache`` holds a
        checkpoint at exactly that time. A fork without one re-folds from
        this builder's clock, which costs more than the serial fold it
        would spare, so the engines fork only where this holds."""
        if cache is None:
            return False
        need = [int(t) for t in times
                if self.t_prev is None or t > self.t_prev]
        return cache.covers(log_fingerprint(self.log), self._config(), need)

    def save_checkpoint(self, cache) -> None:
        """Offer this builder's state at ``t_prev`` to ``cache`` as a fork
        seed; a state larger than the cache's whole bound is never
        copied."""
        if (cache is not None and self.t_prev is not None
                and self.state_nbytes() <= cache.max_bytes):
            cache.put_checkpoint(log_fingerprint(self.log),
                                 self.checkpoint())

    def fork_at(self, time: int, cache=None) -> "SweepBuilder":
        """A fork advanced to ``time``: seeded at ``cache``'s nearest
        checkpoint when that lies ahead of this builder, then one bulk
        advance, whose state goes back to the cache."""
        cp = None
        if cache is not None:
            cp = cache.nearest_checkpoint(log_fingerprint(self.log),
                                          self._config(), time)
            if cp is not None and self.t_prev is not None \
                    and cp.t_prev <= self.t_prev:
                cp = None
        sw = self.fork(cp)
        if sw.t_prev is None or sw.t_prev < time:
            with TRACER.span("fold.checkpoint", time=int(time),
                             seeded_from=(-1 if sw.t_prev is None
                                          else int(sw.t_prev))):
                sw._advance(time)
            sw.save_checkpoint(cache)
        return sw

    # ---- incremental re-pin (live epoch serving) ----

    def repin(self, live_log) -> str:
        """Adopt the rows appended to ``live_log`` since this builder's
        pin without refolding history (``raphtory_tpu/core/sweep.py:410``).
        Returns ``"noop"`` (the pin covers the log), ``"extended"`` (the
        suffix is adopted: the fold state, ``t_prev`` and the dense
        dictionaries stay valid, and the next ``_advance`` folds exactly
        the new rows) or ``"rebuild"`` (the caller builds a fresh
        builder). Extension needs the pin to still be a prefix of the log
        and the frozen dictionaries to cover the suffix, so it rebuilds
        where:

        * the log was compacted (``compactions`` moved: history was
          rewritten, maybe to the same row count);
        * a suffix row names a vertex id outside ``uv``;
        * a preseeded builder sees a (src, dst) pair outside ``e_enc``;
        * a suffix event lands at or before ``t_prev`` (the fence was not
          honoured: folded state is stale).

        The new pin rebinds ``log``, so ``log_fingerprint`` (cached on the
        pin) keys the fold cache by the extended content, and no
        checkpoint of the old pin can seed a fork of this builder. The
        caller must not let a fold of this builder run meanwhile (the
        engines drain theirs first)."""
        new = live_log.pin()
        n_old = len(self._t)
        if (getattr(new, "compactions", 0)
                != getattr(self.log, "compactions", 0)):
            # before the row-count fast path: "same n" says nothing about
            # row identity across a rewrite
            return "rebuild"
        if new.n == n_old:
            return "noop"
        if new.n < n_old or not self._ok:
            return "rebuild"
        t_new = new.column("time")[n_old:]
        k_new = new.column("kind")[n_old:]
        s_new = new.column("src")[n_old:]
        d_new = new.column("dst")[n_old:]
        if self.t_prev is not None and len(t_new) \
                and int(t_new.min()) <= self.t_prev:
            return "rebuild"
        is_e = (k_new == EDGE_ADD) | (k_new == EDGE_DELETE)
        ids = np.concatenate([s_new, d_new[is_e]])
        pos = np.searchsorted(self.uv, ids)
        pos_c = np.clip(pos, 0, max(len(self.uv) - 1, 0))
        if not len(self.uv) or not bool((self.uv[pos_c] == ids).all()):
            return "rebuild"   # a new vertex id: the dictionary is stale
        sd_new = pos[: len(s_new)]
        dd_new = np.zeros(len(d_new), np.int64)
        dd_new[is_e] = pos[len(s_new):]
        if self._preseeded and is_e.any():
            enc = self._pack(sd_new[is_e], dd_new[is_e])
            epos = np.clip(np.searchsorted(self.e_enc, enc), 0,
                           max(len(self.e_enc) - 1, 0))
            if not len(self.e_enc) \
                    or not bool((self.e_enc[epos] == enc).all()):
                return "rebuild"   # a new pair: the preseeded table is stale
        self.log = new
        self._t = new.column("time")
        self._k = new.column("kind")
        self._s = new.column("src")
        self._d = new.column("dst")
        if self._sd_all is not None:
            self._sd_all = np.concatenate([self._sd_all, sd_new])
            self._dd_all = np.concatenate([self._dd_all, dd_new])
        self._t_sorted = bool(
            self._t_sorted
            and (not len(t_new) or bool((t_new[:-1] <= t_new[1:]).all()))
            and (n_old == 0 or int(t_new[0]) >= int(self._t[n_old - 1])))
        return "extended"

    # ---- the sweep ----

    def view_at(self, time: int) -> GraphView:
        time = int(time)
        if not self._ok or (self.t_prev is not None and time < self.t_prev):
            return build_view(self.log, time,
                              include_occurrences=self.include_occurrences,
                              pad=self.pad)
        if self.t_prev is None or time > self.t_prev:
            self._advance(time)
        return self._emit(time)

    def _advance(self, time: int) -> None:
        t_prev = self.t_prev if self.t_prev is not None else np.iinfo(np.int64).min
        if self._t_sorted:
            lo = 0 if t_prev == np.iinfo(np.int64).min \
                else int(np.searchsorted(self._t, t_prev, side="right"))
            hi = int(np.searchsorted(self._t, time, side="right"))
            rows = np.arange(lo, hi)
        else:
            sel = (self._t <= time) if t_prev == np.iinfo(np.int64).min \
                else ((self._t > t_prev) & (self._t <= time))
            rows = np.flatnonzero(sel)
        self.t_prev = time
        if len(rows) == 0:
            self.last_delta = _EMPTY_DELTA
            return
        t = self._t[rows]
        k = self._k[rows]
        s = self._s[rows]
        d = self._d[rows]
        is_va = k == VERTEX_ADD
        is_vd = k == VERTEX_DELETE
        is_ea = k == EDGE_ADD
        is_ed = k == EDGE_DELETE
        uvd = None  # touched vertices, recorded into last_delta below

        if self.track_rows:
            new_ea = rows[is_ea]
            new_va = rows[is_va]
            self._ea_rows = np.insert(
                self._ea_rows, np.searchsorted(self._ea_rows, new_ea), new_ea)
            self._va_rows = np.insert(
                self._va_rows, np.searchsorted(self._va_rows, new_va), new_va)

        if self._sd_all is not None:
            sd, dd = self._sd_all[rows], self._dd_all[rows]
            ds_ea, dd_ea = sd[is_ea], dd[is_ea]
            dv_del = sd[is_vd]
            dv_add = sd[is_va]
            ds_ed, dd_ed = sd[is_ed], dd[is_ed]
        else:
            ds_ea = self._dense(s[is_ea])
            dd_ea = self._dense(d[is_ea])
            dv_del = self._dense(s[is_vd])
            dv_add = self._dense(s[is_va])
            ds_ed = self._dense(s[is_ed])
            dd_ed = self._dense(d[is_ed])
        t_del = t[is_vd]

        # -- vertex delta fold: adds + edge-endpoint revivals vs deletes --
        v_ids = np.concatenate([dv_add, ds_ea, dd_ea, dv_del])
        v_t = np.concatenate([t[is_va], t[is_ea], t[is_ea], t_del])
        v_al = np.zeros(len(v_ids), bool)
        v_al[: len(v_ids) - len(dv_del)] = True

        def vertex_fold():
            (uvd,), dlat, dalive, dfirst = _fold_latest((v_ids,), v_t, v_al)
            # delta times are strictly later than any prior mark, so the
            # delta's latest wins outright and firsts only fill unseen slots
            self.v_lat[uvd] = dlat
            self.v_alive[uvd] = dalive
            self.v_first[uvd] = np.where(self.v_seen[uvd],
                                         self.v_first[uvd], dfirst)
            self.v_seen[uvd] = True
            return uvd

        # the vertex fold runs on a worker, overlapped with the edge fold
        # below: the two touch disjoint state
        v_fut = _vfold_pool().submit(vertex_fold) if len(v_ids) else None
        try:
            uenc, epos = self._advance_edges(t, is_ea, is_ed, ds_ea, dd_ea,
                                             ds_ed, dd_ed, dv_del, t_del)
        finally:
            # joined even when the edge fold raised: nothing may write
            # this builder's vertex state once _advance has returned
            if v_fut is not None:
                wait([v_fut])
        if v_fut is not None:
            uvd = v_fut.result()

        # Touched-entity delta with POST-update fold state, read back from the
        # running arrays so it is correct no matter which code path (known
        # pair overwrite / fresh insert / tombstone join) produced the value.
        tv = uvd if uvd is not None else np.empty(0, np.int64)
        te = uenc if uenc is not None else np.empty(0, np.int64)
        if epos is None:
            epos = np.searchsorted(self.e_enc, te)
        self.last_delta = {
            "v_idx": tv, "v_lat": self.v_lat[tv],
            "v_alive": self.v_alive[tv], "v_first": self.v_first[tv],
            "e_enc": te, "e_lat": self.e_lat[epos],
            "e_alive": self.e_alive[epos], "e_first": self.e_first[epos],
        }

    def _advance_edges(self, t, is_ea, is_ed, ds_ea, dd_ea, ds_ed, dd_ed,
                       dv_del, t_del):
        """The edge half of ``_advance``: marks, tombstone joins and the
        fold into the pair table. Returns the touched pair keys (None when
        the hop marked no pair) and their table positions when no insert
        moved them (else None)."""
        uenc = epos_known = None
        # -- edge delta marks: own add/delete events --
        enc_ea = self._pack(ds_ea, dd_ea)
        enc_ed = self._pack(ds_ed, dd_ed)
        marks_enc = [enc_ea, enc_ed]
        marks_t = [t[is_ea], t[is_ed]]
        marks_a = [np.ones(len(enc_ea), bool), np.zeros(len(enc_ed), bool)]

        delta_enc = np.unique(np.concatenate([enc_ea, enc_ed])) \
            if (len(enc_ea) or len(enc_ed)) else np.empty(0, np.int64)
        if self._preseeded:
            new_enc = delta_enc[:0]   # every pair is in the table already
        else:
            pos = np.searchsorted(self.e_enc, delta_enc)
            pos_c = np.clip(pos, 0, max(len(self.e_enc) - 1, 0))
            known = (self.e_enc[pos_c] == delta_enc) if len(self.e_enc) \
                else np.zeros(len(delta_enc), bool)
            new_enc = delta_enc[~known]

        if len(dv_del):
            # delta deletes × (pairs known before this hop ∪ NEW delta pairs)
            for enc_arr, flip in ((self.e_enc, False), (self.e_enc_dst, True)):
                enc_ts, t_ts = self._incident(enc_arr, dv_del, t_del, flip)
                marks_enc.append(enc_ts)
                marks_t.append(t_ts)
                marks_a.append(np.zeros(len(enc_ts), bool))
            new_by_dst = np.sort(
                ((new_enc & _ENC_MASK) << _ENC_SHIFT) | (new_enc >> _ENC_SHIFT))
            for enc_arr, flip in ((new_enc, False), (new_by_dst, True)):
                enc_ts, t_ts = self._incident(enc_arr, dv_del, t_del, flip)
                marks_enc.append(enc_ts)
                marks_t.append(t_ts)
                marks_a.append(np.zeros(len(enc_ts), bool))

        if len(new_enc) and len(self.dh_v):
            # historical deletes × pairs first seen in this delta
            ns = new_enc >> _ENC_SHIFT
            nd = new_enc & _ENC_MASK
            for comp in (ns, nd):
                lo = np.searchsorted(self.dh_v, comp, side="left")
                hi = np.searchsorted(self.dh_v, comp, side="right")
                hrows, qidx = _expand_ranges(lo, hi)
                marks_enc.append(new_enc[qidx])
                marks_t.append(self.dh_t[hrows])
                marks_a.append(np.zeros(len(hrows), bool))

        all_enc = np.concatenate(marks_enc)
        if len(all_enc):
            all_t = np.concatenate(marks_t)
            all_a = np.concatenate(marks_a)
            (uenc,), elat_d, ealive_d, efirst_d = _fold_latest((all_enc,), all_t, all_a)
            upos = np.searchsorted(self.e_enc, uenc)
            upos_c = np.clip(upos, 0, max(len(self.e_enc) - 1, 0))
            uknown = (self.e_enc[upos_c] == uenc) if len(self.e_enc) \
                else np.zeros(len(uenc), bool)
            # existing pairs: delta marks are strictly later — overwrite
            # (firsts only fill slots that never saw a real mark — preseeded
            # pairs exist in the table before their first event)
            kpos = upos_c[uknown]
            self.e_lat[kpos] = elat_d[uknown]
            self.e_alive[kpos] = ealive_d[uknown]
            self.e_first[kpos] = np.where(self.e_seen[kpos],
                                          self.e_first[kpos],
                                          efirst_d[uknown])
            self.e_seen[kpos] = True
            # new pairs: insert (fold already merged their full history,
            # including historical tombstones, so firsts are exact)
            fresh = ~uknown
            if not fresh.any():
                # positions are final (no inserts shifted them): last_delta
                # reuses them instead of re-searching the whole table
                epos_known = upos_c
            if fresh.any():
                at = upos[fresh]
                self.e_enc = np.insert(self.e_enc, at, uenc[fresh])
                self.e_lat = np.insert(self.e_lat, at, elat_d[fresh])
                self.e_alive = np.insert(self.e_alive, at, ealive_d[fresh])
                self.e_first = np.insert(self.e_first, at, efirst_d[fresh])
                self.e_seen = np.insert(self.e_seen, at,
                                        np.ones(fresh.sum(), bool))
                enc2 = (((uenc[fresh] & _ENC_MASK) << _ENC_SHIFT)
                        | (uenc[fresh] >> _ENC_SHIFT))
                enc2 = np.sort(enc2)
                self.e_enc_dst = np.insert(
                    self.e_enc_dst, np.searchsorted(self.e_enc_dst, enc2), enc2)

        if len(dv_del) and not self._preseeded:
            # the delete history only feeds the new-pair join, which a
            # preseeded table never takes (no pair is ever new)
            self.dh_v = np.concatenate([self.dh_v, dv_del])
            self.dh_t = np.concatenate([self.dh_t, t_del])
            order = np.argsort(self.dh_v, kind="stable")
            self.dh_v = self.dh_v[order]
            self.dh_t = self.dh_t[order]
        return uenc, epos_known

    def _emit(self, time: int) -> GraphView:
        if not self.track_rows:
            raise RuntimeError(
                "this SweepBuilder was built with track_rows=False (fold "
                "state only — the columnar engine); use a default "
                "one to emit GraphViews")
        act_dense = np.flatnonzero(self.v_alive)
        act_vids = self.uv[act_dense]  # uv ascending ⇒ dense order = id order
        act_latest = self.v_lat[act_dense]
        act_first = self.v_first[act_dense]

        alive = self.e_alive
        enc = self.e_enc[alive]
        ae_s = self.uv[enc >> _ENC_SHIFT]
        ae_d = self.uv[enc & _ENC_MASK]
        ae_latest = self.e_lat[alive]
        ae_first = self.e_first[alive]
        # local endpoint indices via the dense→local LUT (enc order is
        # (src, dst)-major, so one argsort of the flipped packing gives the
        # (dst, src) order _assemble_view needs)
        lut = np.full(len(self.uv), -1, np.int32)
        lut[act_dense] = np.arange(len(act_dense), dtype=np.int32)
        src_loc = lut[enc >> _ENC_SHIFT]
        dst_loc = lut[enc & _ENC_MASK]
        eorder = np.argsort(
            (dst_loc.astype(np.int64) << _ENC_SHIFT) | src_loc, kind="stable")
        locs = (src_loc, dst_loc, eorder)

        occ = None
        if self.include_occurrences:
            rows = self._ea_rows
            occ = (rows, self._t[rows], self._s[rows], self._d[rows])
            if self._sd_all is not None:
                # the events' local endpoints off the dense dictionary
                occ += ((lut[self._sd_all[rows]], lut[self._dd_all[rows]]),)
        return _assemble_view(
            self.log, time, act_vids, act_latest, act_first,
            ae_s, ae_d, ae_latest, ae_first, self.pad,
            self._ea_rows, self._va_rows, occ, locs,
        )


# ------------------------------------------------------------- fold cache

_GOLD = np.uint64(0x9E3779B97F4A7C15)


def checksum(a: np.ndarray) -> int:
    """Order-sensitive 64-bit checksum of a 1-D array's values (floats and
    bools by their bits; 0 for an empty array)."""
    if not len(a):
        return 0
    a = np.ascontiguousarray(a)
    if a.dtype.kind in "fb":
        a = a.view(f"i{a.dtype.itemsize}")
    h = a.astype(np.int64, copy=False).view(np.uint64)
    idx = np.arange(len(h), dtype=np.uint64)
    return int(np.bitwise_xor.reduce((h + _GOLD) * (idx * _GOLD + _GOLD)))


def log_fingerprint(log) -> tuple:
    """Content identity of a pinned log for fold-cache keys: the row count,
    the append version and an order-sensitive checksum of each column (src
    and dst apart: a graph must not collide with its transpose). Cached on
    the pin, which never changes."""
    fp = getattr(log, "_rtpu_fold_fp", None)
    if fp is not None:
        return fp
    fp = (int(log.n), int(log.version), checksum(log.column("time")),
          checksum(log.column("src")), checksum(log.column("dst")),
          checksum(log.column("kind")))
    log._rtpu_fold_fp = fp
    return fp


class FoldCache:
    """Bounded cross-request cache of fork checkpoints (``FoldCheckpoint``
    at the starts of a sweep's forks), least recently used first out: a
    later sweep over the same log content seeds its forks there instead of
    folding the prefix again. Every access holds one lock. Callers never
    write a checkpoint after putting it."""

    def __init__(self, max_bytes: int):
        self.max_bytes = int(max_bytes)
        self._lock = threading.Lock()
        self._entries: collections.OrderedDict = collections.OrderedDict()
        self._bytes = 0
        self.hits = 0
        self.misses = 0
        self.evictions = 0
        # (fp, config) -> ascending checkpoint times, for nearest_checkpoint
        self._ckpt_times: dict = {}

    def _evict_until(self, budget: int) -> None:
        while self._bytes > budget and self._entries:
            key, (_, nbytes) = self._entries.popitem(last=False)
            self._bytes -= nbytes
            self.evictions += 1
            self._ckpt_times[key[:2]].remove(key[2])

    def put_checkpoint(self, fp: tuple, cp: FoldCheckpoint) -> bool:
        """Insert (or refresh) ``cp`` for log ``fp`` and evict past the
        bound. A checkpoint larger than the whole bound is refused (False):
        one oversized state must not flush every other entry."""
        if cp.t_prev is None or cp.nbytes > self.max_bytes:
            return False
        key = (fp, cp.config, int(cp.t_prev))
        with self._lock:
            if key in self._entries:
                self._entries.move_to_end(key)
                return True
            self._entries[key] = (cp, cp.nbytes)
            self._bytes += cp.nbytes
            bisect.insort(self._ckpt_times.setdefault((fp, cp.config), []),
                          int(cp.t_prev))
            self._evict_until(self.max_bytes)
        return True

    def nearest_checkpoint(self, fp: tuple, config: tuple,
                           time: int) -> FoldCheckpoint | None:
        """The latest cached checkpoint at or before ``time`` for this log
        and builder config: the fork seed with the shortest prefix left."""
        with self._lock:
            times = self._ckpt_times.get((fp, config), ())
            i = bisect.bisect_right(times, int(time))
            if i == 0:
                self.misses += 1
                return None
            key = (fp, config, times[i - 1])
            self._entries.move_to_end(key)
            self.hits += 1
            return self._entries[key][0]

    def covers(self, fp: tuple, config: tuple, times) -> bool:
        """Whether a checkpoint is cached at exactly each of ``times``
        (neither a hit nor a miss: the engines ask before they choose to
        fork)."""
        with self._lock:
            have = set(self._ckpt_times.get((fp, config), ()))
        return all(int(t) in have for t in times)

    def stats(self) -> dict:
        with self._lock:
            return {"entries": len(self._entries), "bytes": self._bytes,
                    "max_bytes": self.max_bytes, "hits": self.hits,
                    "misses": self.misses, "evictions": self.evictions}

    def clear(self) -> None:
        with self._lock:
            self._entries.clear()
            self._ckpt_times.clear()
            self._bytes = 0


_FOLD_CACHE = None
_FOLD_CACHE_LOCK = threading.Lock()


def fold_cache() -> FoldCache | None:
    """The process-wide fold cache, sized by ``RTPU_FOLD_CACHE_MB`` (default
    256; 0 turns it off), read on every call: a new size swaps in a fresh
    cache."""
    global _FOLD_CACHE
    mb = int(os.environ.get("RTPU_FOLD_CACHE_MB", 256))
    if mb <= 0:
        return None
    with _FOLD_CACHE_LOCK:
        if _FOLD_CACHE is None or _FOLD_CACHE.max_bytes != mb << 20:
            _FOLD_CACHE = FoldCache(mb << 20)
        return _FOLD_CACHE
