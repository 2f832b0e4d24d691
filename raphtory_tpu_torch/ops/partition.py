"""Partition-centric (PCPM) edge layout — destination-binned segments.

The port's copy of ``raphtory_tpu/ops/partition.py``, with the sparse
frontier route's bucket helpers (``frontier_bucket``). Edges are binned by DESTINATION PARTITION — a
contiguous ``n_per``-row slice of the dense vertex space sized so a
partition's accumulator block stays cache-resident — and messages from one
source into a partition can be combined in a per-(partition, source)
bucket before they cross into it (the pre-aggregation gather). The layout
arrays are built on the host, bit for bit the JAX package's, and cached
next to the owner's edge tables; the kernels (``ops/columns``,
``ops/minplus``, ``ops/segment``) read them through ``device_edges``.

Within each partition, edges sort by (src, dst), so a destination's slots
come in source order — the order the engine's (dst, src)-sorted table
visits them in. The binned kernels walk each destination's slots through
a per-destination index built once with the layout (``walk``), so the
binned float sums add in the unbinned route's order and are bitwise equal
to it; min/max results are order-exact either way.

Both knobs (``RTPU_PCPM``, ``RTPU_PARTITIONS``) and the budget
``RTPU_TILE_BUDGET_MB`` are read at DISPATCH time, by ``resolve``, with the
reference's rules: with no knob set the port bins exactly where the JAX
package bins.
"""

from __future__ import annotations

import os
import threading
import weakref
from typing import NamedTuple

import numpy as np
import torch

from ..native import lib as _native
from ..utils.transfer import shared_engine

#: alignment of the per-partition block capacities — keeps pad overhead
#: ~0.1% instead of the up-to-2x a power-of-two pad would cost
_ALIGN = 64

#: below this padded pair count the binning overhead dominates what
#: locality can give back — "auto" keeps tiny graphs on the unbinned route
AUTO_MIN_PAIRS = 1 << 17

#: modelled last-level cache a partition's accumulator slice must fit in,
#: and the DRAM access granularity — the two constants of the traffic
#: model below
CACHE_BYTES = 2 << 20
CACHELINE = 64

#: default floor for sparse-frontier slice buckets (slots). Small enough
#: that a near-quiescent superstep ships ~KBs; large enough that the
#: power-of-two ladder above it has only ~log2(n/floor) rungs, so the set
#: of collective shapes stays bounded
SPARSE_BUCKET_FLOOR = 256


def sparse_bucket_floor() -> int:
    """Resolved ``RTPU_SPARSE_BUCKETS`` (slot floor for frontier-slice
    buckets), read at dispatch time by the sparse comm route."""
    try:
        v = int(os.environ.get("RTPU_SPARSE_BUCKETS", SPARSE_BUCKET_FLOOR))
    except ValueError:
        v = SPARSE_BUCKET_FLOOR
    return max(8, v)


def frontier_bucket(count: int, floor: int | None = None,
                    cap: int | None = None) -> int:
    """Bucketed capacity for a compacted frontier slice: the smallest
    power of two >= ``count``, floored at ``floor`` slots (default: the
    resolved ``RTPU_SPARSE_BUCKETS``), so every frontier size in a
    power-of-two band reuses one collective shape. ``cap`` (when given)
    bounds the bucket from above — the dense-slice size, past which
    padding buys nothing."""
    floor = sparse_bucket_floor() if floor is None else max(1, int(floor))
    b = floor
    while b < count:
        b <<= 1
    if cap is not None:
        b = min(b, max(int(cap), 1))
    return b


class PartitionSpec(NamedTuple):
    """Static shape descriptor of a built layout (``None`` = unbinned)."""

    partitions: int   #: P — destination partitions (contiguous dst ranges)
    n_per: int        #: vertex rows per partition (ceil(n_pad / P))
    cap: int          #: binned edge slots per partition (aligned max load)
    cap_u: int        #: pre-agg bucket slots per partition (aligned max)
    preagg: bool      #: gather through per-(partition, src) buckets


class BinnedEdges(NamedTuple):
    """A layout on the device, as the binned kernels read it. The first six
    fields are ``PartitionLayout.device_args``; ``in_indptr``/``in_order``
    walk each destination row's slots (source order within the row),
    ``out_indptr``/``out_order`` each source row's (None unless the reverse
    direction was asked for). ``U`` is the bucket count ``P * cap_u``,
    0 when the layout does not pre-aggregate."""
    b_src: torch.Tensor        # [B] int32
    b_dst: torch.Tensor        # [B] int32
    valid: torch.Tensor        # [B] bool
    slot: torch.Tensor         # [B] int32
    u_src: torch.Tensor        # [P*cap_u] int32
    perm: torch.Tensor         # [B] int32
    in_indptr: torch.Tensor    # [n_pad + 1] int64
    in_order: torch.Tensor     # [m] int32
    out_indptr: torch.Tensor | None   # [n_pad + 1] int64
    out_order: torch.Tensor | None    # [m] int32
    U: int


def _csr(rows: np.ndarray, n: int) -> np.ndarray:
    indptr = np.zeros(n + 1, np.int64)
    np.cumsum(np.bincount(rows, minlength=n), out=indptr[1:])
    return indptr


class PartitionLayout:
    """Host arrays of one destination-binned layout + cached device copies.

    Flat binned edge space ``B = P * cap``; slot ``p * cap + i`` is the
    i-th edge of partition ``p`` (edges sorted (src, dst) within the
    partition, cap-padding marked invalid):

    - ``perm [B]``    binned slot → engine edge position (pads → m_pad-1)
    - ``inv [m_pad]`` engine position → binned slot (real edges only)
    - ``b_src [B]``   global src per slot (pads → n_pad-1)
    - ``b_dst [B]``   global dst per slot (pads → n_pad-1)
    - ``valid [B]``   real-edge slots
    - ``slot [B]``    pre-agg bucket per slot, global (p * cap_u + rank)
    - ``u_src [P*cap_u]`` bucket → global src (pads → n_pad-1)
    """

    def __init__(self, spec: PartitionSpec, perm, inv, b_src, b_dst,
                 valid, slot, u_src, n_pad: int, m: int):
        self.spec = spec
        self.perm = perm
        self.inv = inv
        self.b_src = b_src
        self.b_dst = b_dst
        self.valid = valid
        self.slot = slot
        self.u_src = u_src
        self.n_pad = int(n_pad)
        self.m = int(m)
        self._walks: dict = {}
        self._dev: dict = {}
        self._lock = threading.Lock()

    @property
    def B(self) -> int:
        """Binned edge slots, ``P * cap`` — the edge length of every binned
        mask and kernel."""
        return len(self.perm)

    def walk(self, reverse: bool = False):
        """``(indptr [n_pad + 1] int64, order [m] int32)``: the real slots
        of each destination row in source order (``reverse``: of each source
        row, in slot order), built once on the host. The destination walk is
        the slot of each engine position in engine order (``inv[:m]``): the
        engine table must be (dst, src)-sorted, as ``build_layout`` takes
        it."""
        key = "out" if reverse else "in"
        with self._lock:
            got = self._walks.get(key)
        if got is not None:
            return got
        if reverse:
            real = np.flatnonzero(self.valid)
            # a stable sort by source (the parallel native radix: numpy's
            # stable sort took ~5 s at the scale shape's 35M slots)
            order = real[_native.radix_argsort_u64(
                self.b_src[real].astype(np.uint64))]
            got = (_csr(self.b_src[real], self.n_pad),
                   order.astype(np.int32))
        else:
            order = self.inv[: self.m]
            rows = self.b_dst[order]
            if len(rows) > 1 and (np.diff(rows) < 0).any():
                raise ValueError("the layout's edge table is not sorted by "
                                 "destination")
            got = (_csr(rows, self.n_pad), order.astype(np.int32))
        with self._lock:
            return self._walks.setdefault(key, got)

    def device_args(self, device) -> tuple:
        """The layout's device operands, uploaded once per device then
        resident: ``(b_src, b_dst, valid, slot, u_src, perm)``, one put of
        the six tables through the process's transfer engine
        (``utils/transfer``: windows staged in reused pinned buffers, the
        next staged while one is copied), where the reference's go through
        ``device_put_chunked`` (``raphtory_tpu/ops/partition.py:150-154``).
        The upload runs outside the lock; a racing duplicate is dropped."""
        device = torch.device(device)
        with self._lock:
            dev = self._dev.get(("args", device))
        if dev is not None:
            return dev
        dev = tuple(shared_engine().put_many(
            (self.b_src, self.b_dst, self.valid, self.slot, self.u_src,
             self.perm), device))
        with self._lock:
            return self._dev.setdefault(("args", device), dev)

    def device_edges(self, device, reverse: bool = False) -> BinnedEdges:
        """``BinnedEdges`` on ``device``: the device args plus the
        destination walk (and, with ``reverse``, the source walk) — what
        the binned kernels take."""
        device = torch.device(device)
        key = ("walk", device, bool(reverse))
        with self._lock:
            got = self._dev.get(key)
        if got is not None:
            return got

        walks = list(self.walk(False)) + (list(self.walk(True)) if reverse
                                          else [])
        walks = shared_engine().put_many(walks, device)
        fwd = tuple(walks[:2])
        rev = tuple(walks[2:]) if reverse else (None, None)
        spec = self.spec
        got = BinnedEdges(*self.device_args(device), *fwd, *rev,
                          spec.partitions * spec.cap_u if spec.preagg else 0)
        with self._lock:
            return self._dev.setdefault(key, got)

    def remap_positions(self, pos: np.ndarray) -> np.ndarray:
        """Engine edge positions → binned slots, preserving the INT32_MAX
        skip sentinel the padded delta lists use."""
        sentinel = np.int32(2**31 - 1)
        safe = np.clip(pos, 0, len(self.inv) - 1)
        return np.where(pos == sentinel, sentinel,
                        self.inv[safe].astype(np.int32))

    def bin_base(self, lat: np.ndarray, alive: np.ndarray):
        """Engine-order per-pair base state → binned layout. Invalid
        (cap-pad) slots are forced dead so the kernels never need a
        separate validity AND."""
        lat_b = lat[self.perm]
        alive_b = alive[self.perm] & self.valid
        return lat_b, alive_b

    def bin_values(self, vals: np.ndarray) -> np.ndarray:
        """Engine-order per-pair values (e.g. SSSP weights) → binned."""
        return vals[self.perm]


class HostTables:
    """Minimal tables surface for ``resolve`` over a bare edge table (a
    view's per-snapshot tables). ``m`` is the REAL row count — the pow2 pad
    tail must become invalid cap-pad slots, never binned edges."""

    __slots__ = ("e_src", "e_dst", "n_pad", "m", "m_pad")

    def __init__(self, e_src, e_dst, n_pad: int, m: int):
        self.e_src = np.asarray(e_src)
        self.e_dst = np.asarray(e_dst)
        self.n_pad = int(n_pad)
        self.m = int(m)
        self.m_pad = len(self.e_src)


def partition_count(n_pad: int, budget_bytes: int,
                    override: int | None = None) -> int:
    """Partitions for an ``n_pad``-row destination space: the override, or
    auto-sized so one partition's f32 accumulator slice (at a reference
    column width of 128) stays within 1/128 of the tile budget. For the
    default 256 MB budget that is ``n_per = 2048`` rows."""
    if override is not None and override > 0:
        return max(1, min(int(override), int(n_pad)))
    n_per = max(1024, int(budget_bytes) >> 17)
    return max(1, -(-int(n_pad) // n_per))


def build_layout(e_src: np.ndarray, e_dst: np.ndarray, n_pad: int, m: int,
                 partitions: int) -> PartitionLayout:
    """Build the destination-binned layout for an engine edge table
    (``e_src``/``e_dst`` padded ``[m_pad]``, real edges in ``[0, m)``,
    (dst, src)-sorted). O(m log m) host work, done once per (owner, P)."""
    m = int(m)
    m_pad = len(e_dst)
    P = max(1, min(int(partitions), int(n_pad)))
    n_per = -(-int(n_pad) // P)
    src = e_src[:m].astype(np.int64)
    dst = e_dst[:m].astype(np.int64)
    part = dst // n_per
    # (partition, src, dst): bucket reads stream sequentially per partition
    order = np.lexsort((dst, src, part))
    counts = np.bincount(part[order], minlength=P)
    cap = int(max(_ALIGN, -(-int(counts.max(initial=0)) // _ALIGN) * _ALIGN))
    B = P * cap
    off = np.zeros(P + 1, np.int64)
    np.cumsum(counts, out=off[1:])

    part_o = np.repeat(np.arange(P, dtype=np.int64), counts)
    within = np.arange(m, dtype=np.int64) - np.repeat(off[:-1], counts)
    slots = part_o * cap + within                      # binned slot per row

    perm = np.full(B, m_pad - 1, np.int32)
    perm[slots] = order.astype(np.int32)
    inv = np.full(m_pad, B - 1, np.int32)
    inv[order] = slots.astype(np.int32)
    b_src = np.full(B, n_pad - 1, np.int32)
    b_src[slots] = src[order].astype(np.int32)
    b_dst = np.full(B, n_pad - 1, np.int32)
    b_dst[slots] = dst[order].astype(np.int32)
    valid = np.zeros(B, bool)
    valid[slots] = True

    # pre-aggregation buckets: one per (partition, src) run — the
    # (partition, src, dst) sort makes runs contiguous
    keys = part_o * (int(n_pad) + 1) + src[order]
    first = np.ones(m, bool)
    first[1:] = keys[1:] != keys[:-1]
    u_rank = np.cumsum(first) - 1                      # global unique rank
    u_per_part = np.bincount(part_o[first], minlength=P)
    u_off = np.zeros(P + 1, np.int64)
    np.cumsum(u_per_part, out=u_off[1:])
    cap_u = int(max(_ALIGN,
                    -(-int(u_per_part.max(initial=0)) // _ALIGN) * _ALIGN))
    local_rank = u_rank - u_off[part_o]                # rank within part
    slot = np.zeros(B, np.int32)
    slot[slots] = (part_o * cap_u + local_rank).astype(np.int32)
    u_src = np.full(P * cap_u, n_pad - 1, np.int32)
    u_src[(part_o[first] * cap_u + local_rank[first]).astype(np.int64)] = \
        src[order][first].astype(np.int32)

    # the buckets only pay when they are strictly fewer gather rows than
    # the edges themselves (pathological pads can invert that)
    preagg = int(first.sum()) > 0 and P * cap_u < B
    spec = PartitionSpec(P, n_per, cap, cap_u, bool(preagg))
    return PartitionLayout(spec, perm, inv, b_src, b_dst, valid, slot,
                           u_src, n_pad, m)


# ------------------------------------------------------------ resolution

#: per-owner (log / bulk graph / view) cache of built layouts, keyed by the
#: exact table identity (tag, m, n_pad, P) — pairs are never removed from a
#: log, so equal counts mean the identical deterministic table
_LAYOUTS: "weakref.WeakKeyDictionary" = weakref.WeakKeyDictionary()
_LAYOUTS_LOCK = threading.Lock()


def pcpm_enabled(m_pad: int, mode: str) -> bool:
    """``RTPU_PCPM`` decision for a graph of ``m_pad`` padded pairs:
    ``"1"`` forces the binned route, ``"0"`` the unbinned one, anything
    else — ``"auto"``, unset, set-but-empty, typos — bins only past
    ``AUTO_MIN_PAIRS``. Only an explicit ``"1"`` forces tiny graphs onto
    the binned route."""
    if mode == "0":
        return False
    if mode == "1":
        return True
    return int(m_pad) >= AUTO_MIN_PAIRS


def tile_budget_bytes() -> int:
    """Resolved ``RTPU_TILE_BUDGET_MB`` in bytes (default 256 MB) — here it
    sizes ``n_per`` only; the tiled kernel variants are not ported."""
    return int(os.environ.get("RTPU_TILE_BUDGET_MB", 256)) << 20


def resolve(owner, tables, budget_bytes: int, tag: str = ""):
    """Layout for ``tables`` (``e_src``, ``e_dst``, ``n_pad``, ``m``,
    ``m_pad``) or ``None`` when the binned route is off. Reads
    ``RTPU_PCPM`` / ``RTPU_PARTITIONS`` HERE, at dispatch. ``owner`` keys
    the cross-engine cache (the caller's log object outlives per-engine
    tables); ``tag`` tells different edge tables of one owner apart."""
    mode = os.environ.get("RTPU_PCPM", "auto")
    if not pcpm_enabled(tables.m_pad, mode):
        return None
    if getattr(tables, "e_src", None) is None:
        return None
    ov = os.environ.get("RTPU_PARTITIONS")
    P = partition_count(tables.n_pad, budget_bytes, int(ov) if ov else None)
    key = (tag, int(tables.m), int(tables.n_pad), int(P))
    with _LAYOUTS_LOCK:
        try:
            per_owner = _LAYOUTS.get(owner)
            if per_owner is None:
                per_owner = {}
                _LAYOUTS[owner] = per_owner
        except TypeError:
            # unweakrefable or unhashable owner: build uncached
            per_owner = None
        ent = per_owner.get(key) if per_owner is not None else None
    if ent is not None:
        return ent
    layout = build_layout(tables.e_src, tables.e_dst, tables.n_pad,
                          tables.m, P)
    if per_owner is not None:
        with _LAYOUTS_LOCK:
            ent = per_owner.setdefault(key, layout)
        return ent
    return layout


# ---------------------------------------------------------- traffic model


def edge_traffic_model(m_pad: int, C: int, n_pad: int,
                       spec: PartitionSpec | None,
                       itemsize: int = 4) -> dict:
    """Modelled DRAM bytes of ONE message-combine superstep (the PCPM
    paper's accounting): a random access into an operand whose working set
    exceeds ``CACHE_BYTES`` costs a full ``CACHELINE``; streamed and
    cache-resident operands cost their payload bytes once. Unbinned: every
    edge gathers a state row at random and scatter-adds one at random (a
    read-modify-write). Binned (``spec``): the gather reads each
    (partition, src) bucket row once, the expansion streams, and the
    scatter lands in a cache-resident ``n_per``-row slice."""
    row = C * itemsize
    state_bytes = n_pad * row

    def lines(r: int) -> int:            # DRAM bytes one random r-byte
        return -(-r // CACHELINE) * CACHELINE   # row access moves

    rand = lines(row) if state_bytes > CACHE_BYTES else row
    out = {"model": "pcpm_superstep", "columns": int(C)}
    if spec is None:
        streamed = m_pad * (2 * 4 + C)   # ids + bool mask
        random_bytes = m_pad * rand + 2 * m_pad * rand
        out.update(random_rows=int(2 * m_pad),
                   streamed_bytes=int(streamed),
                   est_hbm_bytes=int(random_bytes + streamed))
        return out
    B = spec.partitions * spec.cap
    slice_bytes = spec.n_per * row
    u_rows = spec.partitions * spec.cap_u if spec.preagg else B
    gather_bytes = u_rows * rand + (B * row if spec.preagg else 0)
    if slice_bytes <= CACHE_BYTES:
        scatter_bytes = B * row + n_pad * row
    else:                                # partitions mis-sized: random
        scatter_bytes = 2 * B * lines(row)
    streamed = B * (2 * 4 + C)           # ids + bool mask
    out.update(random_rows=int(u_rows),
               streamed_bytes=int(streamed),
               est_hbm_bytes=int(gather_bytes + scatter_bytes + streamed))
    return out
