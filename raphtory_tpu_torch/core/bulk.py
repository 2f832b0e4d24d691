"""Bulk static loading — add-only edge streams at 100M-event scale.

The general ingest path (EventLog → SweepBuilder fold) supports deletes,
revivals, properties and out-of-order arrival; its comparison sorts cost
minutes at 10^8 events on one host core. Bulk imports of APPEND-ONLY edge
streams (the Twitter-2010 / warehouse-export shape) need none of that
generality, and collapse to radix passes:

* one stable radix argsort of the packed (src, dst) keys builds the global
  pair table (stability keeps each pair's events time-ascending);
* per-hop fold state comes from DELTA SLICES of the time-sorted stream —
  hop j re-sorts only the events in (T_{j-1}, T_j], so a sweep's fold cost
  is one radix of the first slice plus near-nothing per later hop (the
  same incremental idea as ``core/sweep.SweepBuilder``, specialised until
  it is just sorts);
* "latest event <= T" per pair/vertex is the last row of each run.

The native radix kernel (``rtpu_radix_argsort_u64``) carries the hot
sorts here; the native batched searchsorted serves the general engines'
pair lookups (``GlobalTables.eng_pos``). Numpy fallbacks keep every path
correct without the library.

Output plugs straight into the hop-batched columnar engine
(``engine/hopbatch.run_columns`` over the host columns, K3;
``engine/hopbatch.run_scale_columns`` over base + deltas, K4): the scale
benchmark's whole load+fold is seconds of radix passes instead of the
general fold's minutes.

Port of ``raphtory_tpu/core/bulk.py``; ``BulkGraph`` also carries the
destination CSR the port's pull-sum kernel (K2b) walks.
"""

from __future__ import annotations

import numpy as np

from ..engine.device_sweep import _pad_large
from ..native import lib as _native


class BulkGraph:
    """GlobalTables-shaped static tables over a bulk-loaded pair set: the
    (dst, src)-sorted edges ``e_src``/``e_dst`` (pads dst = src = n_pad-1)
    and their destination CSR ``in_indptr``."""

    def __init__(self, n_vertices: int, uniq_packed: np.ndarray,
                 tdtype) -> None:
        self.n = int(n_vertices)
        self.m = len(uniq_packed)
        self.n_pad = _pad_large(self.n)
        self.m_pad = _pad_large(self.m)
        self.tdtype = tdtype
        self.tmin = np.iinfo(tdtype).min
        self.uv = np.arange(self.n, dtype=np.int64)

        src_r = (uniq_packed >> np.uint64(32)).astype(np.int64)
        dst_r = (uniq_packed & np.uint64(0xFFFFFFFF)).astype(np.int64)
        flip = (dst_r.astype(np.uint64) << np.uint64(32)) \
            | src_r.astype(np.uint64)
        order = _native.radix_argsort_u64(flip)       # engine (dst, src) sort
        self.eng_of_rank = np.empty(self.m, np.int64)
        self.eng_of_rank[order] = np.arange(self.m)
        self.e_src = np.full(self.m_pad, self.n_pad - 1, np.int32)
        self.e_dst = np.full(self.m_pad, self.n_pad - 1, np.int32)
        self.e_src[: self.m] = src_r[order]
        self.e_dst[: self.m] = dst_r[order]
        #: destination CSR over the REAL edges: row d owns edges
        #: [in_indptr[d], in_indptr[d+1]), and in_indptr[n_pad] = m. The
        #: pad edges lie past it — counted, all m_pad - m of them would
        #: land in row n_pad-1 and serialise that row's pull-sum threads
        self.in_indptr = np.zeros(self.n_pad + 1, np.int64)
        np.cumsum(np.bincount(self.e_dst[: self.m], minlength=self.n_pad),
                  out=self.in_indptr[1:])


def _run_last(sorted_keys: np.ndarray):
    """Indices of the LAST row of each equal-key run (keys sorted)."""
    if len(sorted_keys) == 0:
        return np.empty(0, np.int64)
    change = np.flatnonzero(sorted_keys[1:] != sorted_keys[:-1])
    return np.concatenate([change, [len(sorted_keys) - 1]])


def _bulk_load(src, dst, times, hop_times, n_vertices):
    """Shared bulk-loader head: validation + ONE global pair radix.

    Returns ``(bulk, src, dst, times, hop_times, pos_of_event)`` where
    ``pos_of_event[i]`` is event i's ENGINE position — recovered from the
    single full-stream sort, so per-hop folds never binary-search the pair
    table again."""
    src = np.ascontiguousarray(src, np.int64)
    dst = np.ascontiguousarray(dst, np.int64)
    times = np.ascontiguousarray(times, np.int64)
    hop_times = [int(x) for x in hop_times]
    if sorted(hop_times) != hop_times:
        raise ValueError("hop_times must ascend")
    if len(times):
        # one comparison pass (no int64 diff temp at 100M scale); endpoints
        # then bound the whole sorted array in O(1)
        if not np.all(times[:-1] <= times[1:]):
            raise ValueError("bulk loader needs a time-sorted stream — "
                             "argsort by time first (radix_argsort_u64)")
        if times[0] < 0 or times[-1] >= 2**31:
            raise ValueError("bulk loader needs times in [0, 2^31) — use "
                             "the general EventLog path for wider clocks")
    id_max = max(int(src.max()), int(dst.max())) if len(src) else -1
    n_v = int(n_vertices) if n_vertices is not None else id_max + 1
    if len(src) and (src.min() < 0 or dst.min() < 0 or id_max >= 2**31):
        raise ValueError("bulk loader needs dense ids in [0, 2^31)")
    if id_max >= n_v:
        # an out-of-range id would silently mark PADDING vertices alive and
        # skew every column's rank mass — refuse instead
        raise ValueError(
            f"vertex id {id_max} >= n_vertices ({n_v})")

    packed = (src.astype(np.uint64) << np.uint64(32)) | dst.astype(np.uint64)
    order_all = _native.radix_argsort_u64(packed)
    sp = packed[order_all]
    uniq = sp[_run_last(sp)]          # last-of-run == unique, sorted
    bulk = BulkGraph(n_v, uniq, np.int32)
    starts = np.ones(len(sp), bool)
    starts[1:] = sp[1:] != sp[:-1]
    rank_sorted = np.cumsum(starts) - 1
    pos_of_event = np.empty(len(sp), np.int64)
    pos_of_event[order_all] = bulk.eng_of_rank[rank_sorted]
    return bulk, src, dst, times, hop_times, pos_of_event


def _slice_fold(lat_e, lat_v, src, dst, times, pos_of_event, prev, hi,
                tdtype, al_e=None, al_v=None):
    """Fold the time-ascending event slice [prev, hi) into running
    engine-order rows by DIRECT fancy assignment: numpy integer-array
    assignment keeps the last value for duplicate indices, so "latest
    event <= T" is just "write in stream order" — no per-slice sort.
    Endpoints interleave so the flattened vertex write order stays
    time-ascending. Returns the slice's raw (pos, ts, vk, vts) updates for
    callers that ship them as deltas instead of folding on host
    (``lat_e``/``lat_v`` may be None to skip the writes entirely)."""
    pos = pos_of_event[prev:hi]
    ts = times[prev:hi].astype(tdtype)
    vk = np.empty(2 * (hi - prev), np.int64)
    vk[0::2] = src[prev:hi]
    vk[1::2] = dst[prev:hi]
    vts = np.repeat(ts, 2)
    if lat_e is not None:
        lat_e[pos] = ts
        lat_v[vk] = vts
    if al_e is not None:
        al_e[pos] = True
        al_v[vk] = True
    return pos, ts, vk, vts


def bulk_hop_columns(src, dst, times, hop_times, n_vertices: int | None = None):
    """Load an ADD-ONLY edge stream and fold it at each hop time.

    ``src``/``dst``: dense non-negative int vertex ids (< 2^31);
    ``times``: non-decreasing event times (sort the stream first if not);
    ``hop_times``: ascending fold timestamps.

    Returns ``(bulk, e_lat, e_alive, v_lat, v_alive)`` with the column
    arrays shaped hop-major ``[H, m_pad]`` / ``[H, n_pad]`` in the bulk
    graph's engine order — exactly what ``engine.hopbatch.run_columns``
    consumes (row ``j`` = fold state at ``hop_times[j]``).

    Per-slice folds are DIRECT fancy assignments: the stream is
    time-ascending and numpy integer-array assignment keeps the last value
    for duplicate indices, so "latest event <= T" is just "write in stream
    order" — no per-slice sort at all.
    """
    bulk, src, dst, times, hop_times, pos_of_event = _bulk_load(
        src, dst, times, hop_times, n_vertices)
    tdtype = bulk.tdtype

    H = len(hop_times)
    e_lat = np.full((H, bulk.m_pad), bulk.tmin, tdtype)
    e_alive = np.zeros((H, bulk.m_pad), bool)
    v_lat = np.full((H, bulk.n_pad), bulk.tmin, tdtype)
    v_alive = np.zeros((H, bulk.n_pad), bool)

    lat_e = np.full(bulk.m_pad, bulk.tmin, tdtype)   # running engine-order
    al_e = np.zeros(bulk.m_pad, bool)
    lat_v = np.full(bulk.n_pad, bulk.tmin, tdtype)
    al_v = np.zeros(bulk.n_pad, bool)

    prev = 0
    for j, T in enumerate(hop_times):
        hi = int(np.searchsorted(times, T, side="right"))
        if hi > prev:
            _slice_fold(lat_e, lat_v, src, dst, times, pos_of_event,
                        prev, hi, tdtype, al_e=al_e, al_v=al_v)
            prev = hi
        e_lat[j] = lat_e          # contiguous row memcpy in this layout
        e_alive[j] = al_e
        v_lat[j] = lat_v
        v_alive[j] = al_v

    return bulk, e_lat, e_alive, v_lat, v_alive


def bulk_hop_deltas(src, dst, times, hop_times, n_vertices: int | None = None):
    """Like ``bulk_hop_columns`` but O(base + deltas) output for
    DEVICE-SIDE column reconstruction (``engine.hopbatch.run_scale_columns``)
    — at 10^8-edge scale the materialised ``[H, m_pad]`` columns cannot
    cross the host link, so hop 0's full fold state ships once and each
    later hop ships only its raw update pairs (the device scatter-max
    dedupes; times ascend so max == latest).

    Returns ``(bulk, base_e_lat, base_v_lat, deltas_e, deltas_v)`` where
    ``base_*`` are the engine-order fold rows at ``hop_times[0]`` (int32,
    INT32_MIN = never seen — add-only, so alive == lat >= 0) and
    ``deltas_*[j]`` is hop j's ``(positions, times)`` pair (empty for
    j = 0, the base)."""
    bulk, src, dst, times, hop_times, pos_of_event = _bulk_load(
        src, dst, times, hop_times, n_vertices)
    tdtype = bulk.tdtype

    base_e = np.full(bulk.m_pad, bulk.tmin, tdtype)
    base_v = np.full(bulk.n_pad, bulk.tmin, tdtype)
    empty = (np.empty(0, np.int32), np.empty(0, tdtype))
    deltas_e, deltas_v = [empty], [empty]

    hi0 = int(np.searchsorted(times, hop_times[0], side="right"))
    _slice_fold(base_e, base_v, src, dst, times, pos_of_event, 0, hi0,
                tdtype)

    # later hops: raw update pairs only — the folds happen on device
    prev = hi0
    for T in hop_times[1:]:
        hi = int(np.searchsorted(times, T, side="right"))
        pos, ts, vk, vts = _slice_fold(
            None, None, src, dst, times, pos_of_event, prev, hi, tdtype)
        deltas_e.append((pos.astype(np.int32), ts))
        deltas_v.append((vk.astype(np.int32), vts))
        prev = hi
    return bulk, base_e, base_v, deltas_e, deltas_v
