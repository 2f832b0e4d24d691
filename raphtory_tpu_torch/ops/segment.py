"""K7 — the masked segment combine, the message exchange of the generic
superstep engine (``engine/bsp.py``).

The reference delivers typed point-to-point actor messages per vertex
(``VertexVisitor.scala:99-161`` → ``ReaderWorker.scala:137-157``). Here a
superstep's messages are a flat per-edge payload combined at the receiving
vertex with an associative-commutative reduction (sum, min or max); masked
edges contribute the combiner's neutral value, and so does an empty
segment.

Same three parts as ``ops/columns.py``, whose build and launch plumbing it
shares: the **wrapper** ``segment_combine`` (CPU tensors take the twin,
CUDA tensors launch ``rtpu_segment_combine`` from ``csrc/segment.cu`` or
raise), the **plain twin** ``segment_combine_plain`` (``index_add_`` /
``scatter_reduce_`` over the segment ids), and the CUDA source.

Where a payload goes is a ``SegmentCSR``: the segment id of every edge
(what the twin scatters by) and the same mapping as a CSR over the REAL
edges (what the kernel walks — each run read once for up to four windows,
short runs packed over a warp's lanes, runs past 32 entries a block each,
no atomics; every row combines in its CSR order, so float sums are
bitwise a sequential walk's). Pad edges lie outside the CSR and must be
masked in every window, as every caller's are. The runs past 32 entries
are listed once per CSR (``combine_plan``, which also checks it).

K7-P ``partition_reduce`` is the destination-binned (PCPM) combine
(``raphtory_tpu/ops/segment.py:116`` ``partition_segment_reduce``): the
payload read through a layout's permutation, each destination partition
reduced into its own dense ``n_per``-row block, in the fixed order of a
``PartitionWalk`` (``rtpu_partition_reduce``: the same kernel, its walk
read through ``order``, ``perm`` and ``valid``).
``partition_segment_reduce`` keeps the reference's signature on top of it.

K7-mode ``segment_mode`` (``raphtory_tpu/ops/segment.py:155``) is the
custom-combiner exchange ``LabelPropagation`` runs: the most frequent value
of each (window, segment) inbox, ties to the smallest value, masked rows
and values outside [0, 2^31) counting as no message, an empty inbox
giving ``default``. Its twin ``segment_mode_plain`` is the reference's
sort of packed ``(segment << 31) | value`` keys; the kernel
``rtpu_segment_mode`` walks each inbox through the same ``SegmentCSR``
as K7 (no global sort: a window's inbox is one CSR run) and is bitwise
equal to it, the result being an integer picked by count and value.

``segment_sum_sorted_csr`` (a segmented scan the reference takes only on
a TPU backend) is not ported (ROADMAP queue 2).
"""

from __future__ import annotations

import ctypes
import math
import weakref
from dataclasses import dataclass

import torch

from .columns import _expect, _fn, _k2_checked, _launch, _on_cuda, _stream

_OPS = {"sum": 0, "min": 1, "max": 2}
#: payload dtypes the kernel takes (the twin takes any)
_KERNEL_DTYPES = {torch.float32: 0, torch.int32: 1, torch.int64: 2}


def _counted(name: str, dtype: torch.dtype) -> str:
    """The ``LAUNCHES`` key of a K7 / K7-P launch: int64 payloads (the
    taint exchange) count apart, so a path that needs the int64
    instantiation shows that it ran."""
    return f"{name}_i64" if dtype == torch.int64 else name


def neutral(op: str, dtype: torch.dtype):
    """The combiner's identity for ``dtype``: 0, the dtype's max (+inf) or
    its min (-inf)."""
    if op not in _OPS:
        raise ValueError(f"unknown combiner {op!r}; use one of "
                         f"{sorted(_OPS)}")
    if op == "sum":
        return 0
    if dtype.is_floating_point:
        return float("inf") if op == "min" else float("-inf")
    info = torch.iinfo(dtype)
    return info.max if op == "min" else info.min


@dataclass(frozen=True)
class SegmentCSR:
    """The destination segment of each edge, twice: ``ids`` per edge, and a
    CSR over the real edges — row r owns ``perm[indptr[r]:indptr[r+1]]``
    (``perm`` None: the edges ``indptr[r]:indptr[r+1]`` themselves, for
    edges sorted by segment)."""
    ids: torch.Tensor               # int32 [m] segment of each edge
    indptr: torch.Tensor            # int64 [n + 1] over the real edges
    perm: torch.Tensor | None       # int32 [m_real] or None

    @property
    def n(self) -> int:
        """Segments per window."""
        return self.indptr.shape[0] - 1


def segment_combine_plain(data, csr: SegmentCSR, op: str, mask, k: int = 1):
    """Twin of ``rtpu_segment_combine``: ``data`` ``[k*m, ...]`` with its
    ``mask`` ``bool[k*m]`` combined into ``[k*n, ...]`` — window w's edge e
    into segment ``w*n + ids[e]`` (``raphtory_tpu/ops/segment.py:35``)."""
    m, n = csr.ids.shape[0], csr.n
    tail = tuple(data.shape[1:])
    x = data.reshape(k * m, math.prod(tail))    # an empty block too
    fill = neutral(op, data.dtype)
    x = torch.where(mask[:, None], x, torch.full_like(x, fill))
    ids = (csr.ids.long()[None, :]
           + torch.arange(k, device=data.device)[:, None] * n).reshape(-1)
    out = torch.full((k * n, x.shape[1]), fill, dtype=data.dtype,
                     device=data.device)
    if op == "sum":
        out.index_add_(0, ids, x)
    else:
        out.scatter_reduce_(0, ids[:, None].expand_as(x), x,
                            "amin" if op == "min" else "amax")
    return out.reshape((k * n,) + tail)


def combine_plan(indptr, order, perm, valid, m: int) -> torch.Tensor:
    """What K7 / K7-P need of a walk beyond its tensors: its long rows, the
    rows whose runs exceed ``SHORT_RUN`` entries (int32, longest first;
    each takes a block of its own, the first blocks of the launch). Checks
    the walk as the kernel reads it, on the walk's device (one read-back):
    ``indptr`` must start at 0, never fall and end within the entries
    (``order``'s length, or ``m`` without one); ``order`` must name slots
    inside ``perm`` / ``valid`` (or the ``m`` payload rows), and ``perm``
    payload rows in ``[0, m)`` at every slot the walk counts. Raises
    ``ValueError`` otherwise."""
    n = indptr.shape[0] - 1
    nnz = m if order is None else order.shape[0]
    # slot s is payload row perm[s], or s itself without a perm
    slots = (perm.shape[0] if perm is not None
             else m if valid is None else min(m, valid.shape[0]))
    lens = indptr[1:] - indptr[:-1]
    zero = indptr[:1].reshape(())
    stats = [indptr[0], indptr[-1], lens.min() if n else zero]
    walked = None
    if order is not None and order.numel():
        walked = order.long()
        stats += [walked.min(), walked.max()]
    first, last, shortest, *named = torch.stack(stats).tolist()
    what = "the walk" if order is not None else "the CSR"
    if first != 0 or shortest < 0 or last > nnz:
        raise ValueError(f"{what} is not a CSR over its {nnz} entries "
                         f"(starts at {first}, ends at {last}, a run of "
                         f"{shortest})")
    if named and (named[0] < 0 or named[1] >= slots):
        raise ValueError(f"{what} names slots outside [0, {slots})")
    if perm is not None and last:
        s = walked[:last] if walked is not None else torch.arange(
            last, device=indptr.device)
        rows = perm[s].long()
        if valid is not None:
            rows = rows[valid[s]]
        if rows.numel() and not bool(((rows >= 0) & (rows < m)).all()):
            raise ValueError(f"perm names payload rows outside [0, {m})")
    rows = torch.nonzero(lens > SHORT_RUN).reshape(-1)
    return rows[torch.argsort(lens[rows], descending=True,
                              stable=True)].to(torch.int32)


def _plan_of(name: str, m: int, indptr, order, perm, valid):
    """``combine_plan`` of a walk, once per walk and version
    (``columns._k2_checked``: each tensor's identity and version); the
    caller has checked the tensors' types and devices."""
    tensors = tuple(t for t in (indptr, order, perm, valid) if t is not None)
    return _k2_checked(f"{name} walk", tensors,
                       (m, order is None, perm is None, valid is None),
                       lambda: combine_plan(indptr, order, perm, valid, m))


def _payload_f(name: str, data, mask) -> int:
    """The checks a K7 / K7-P launch makes at every call (the walk and the
    mask are checked once per signature): the payload's dtype, contiguity
    and device. Returns F, the features a payload row holds (the kernel's
    grid rows are F * k, launched in groups of 65,535 by the C entry)."""
    if data.dtype not in _KERNEL_DTYPES:
        raise TypeError(f"{name}: payload dtype {data.dtype} has no kernel "
                        f"(want one of {sorted(map(str, _KERNEL_DTYPES))})")
    if not data.is_contiguous():
        raise ValueError(f"{name}: data is not contiguous")
    if data.device != mask.device:
        raise ValueError(f"{name}: data on {data.device}, the mask on "
                         f"{mask.device}")
    return math.prod(data.shape[1:])


def _run(counted: str, fn, *args) -> None:
    """Call a K7 / K7-P / K7-mode C entry (its last parameter the launches
    it made: one a group of 65,535 grid rows) and count its launches."""
    launched = ctypes.c_int64(0)
    err = fn(*args, ctypes.byref(launched))
    _launch(counted, err, launched.value)


def segment_combine(data, csr: SegmentCSR, op: str, mask, k: int = 1):
    """K7 wrapper (``raphtory_tpu/ops/segment.py:35`` ``segment_combine``,
    as the superstep runner calls it at ``engine/bsp.py:145,152,154``):
    the masked sum/min/max of ``data [k*m, ...]`` per (window, segment),
    ``[k*n, ...]``. Float32, int32 and int64 payloads on the card (an
    int64 launch counts as ``segment_combine_i64``), one launch a call up
    to 65,535 grid rows (features x windows), one a group of them past
    that: the CSR and the mask are checked once per signature and the
    CSR's long rows listed once (``combine_plan``), the payload at every
    call."""
    name = "segment_combine"
    if op not in _OPS:
        raise ValueError(f"{name}: unknown combiner {op!r}; use one of "
                         f"{sorted(_OPS)}")
    m, n = csr.ids.shape[0], csr.n
    if data.dim() == 0 or data.shape[0] != k * m:
        raise ValueError(f"{name}: data has shape {tuple(data.shape)}, want "
                         f"[{k * m}, ...] (k={k} windows x m={m} edges)")
    perm = () if csr.perm is None else (csr.perm,)

    def check():
        _expect(name, mask, "mask", (torch.bool,), (k * m,))
        _check_csr(name, csr, m)
        if not _on_cuda(name, data, mask, csr.ids, csr.indptr, *perm):
            return None
        return _plan_of(name, m, csr.indptr, csr.perm, None, None)

    long_rows = _k2_checked(name, (mask, csr.ids, csr.indptr, *perm), k,
                            check)
    if long_rows is None:
        return segment_combine_plain(data, csr, op, mask, k)
    F = _payload_f(name, data, mask)
    out = torch.empty((k * n,) + tuple(data.shape[1:]), dtype=data.dtype,
                      device=data.device)
    if not out.numel():
        return out
    _run(_counted(name, data.dtype),
         _fn("segment", "rtpu_segment_combine"),
         k, n, m, F, _OPS[op], _KERNEL_DTYPES[data.dtype],
         long_rows.shape[0], csr.indptr.data_ptr(),
         None if csr.perm is None else csr.perm.data_ptr(),
         long_rows.data_ptr(), data.data_ptr(), mask.data_ptr(),
         out.data_ptr(), _stream(data))
    return out


# ---------------------------------------------------------------- K7-mode

#: segment_mode's value budget: non-negative values below 2^31
_V_BITS = 31


def _mode_args(name, values, seg: SegmentCSR, num_segments: int, mask,
               k: int):
    m, n = seg.ids.shape[0], seg.indptr.shape[0] - 1
    if num_segments != k * n:
        raise ValueError(f"{name}: num_segments {num_segments} != k={k} "
                         f"windows x n={n} segments")
    if values.shape != (k * m,):
        raise ValueError(f"{name}: values has shape {tuple(values.shape)}, "
                         f"want [{k * m}] (k={k} windows x m={m} edges)")
    if mask is not None:
        _expect(name, mask, "mask", (torch.bool,), (k * m,))
    return m, n


def segment_mode_plain(values, seg: SegmentCSR, num_segments: int,
                       mask=None, default: int = -1, k: int = 1):
    """Twin of ``rtpu_segment_mode``, the reference's algorithm
    (``raphtory_tpu/ops/segment.py:155-205``): window w's row e lands in
    segment ``w*n + ids[e]``; rows masked off or with a value outside
    [0, 2^31) are parked past the last segment; the packed int64 keys
    ``(segment << 31) | value`` are sorted, equal runs counted, and each
    segment keeps the run of the largest ``count * 2^31 + (2^31 - 1 -
    value)``. ``[k*n]`` in the values' dtype."""
    m, n = _mode_args("segment_mode", values, seg, num_segments, mask, k)
    dev = values.device
    if mask is None:
        mask = torch.ones(k * m, dtype=torch.bool, device=dev)
    ids = (seg.ids.long()[None, :]
           + torch.arange(k, device=dev)[:, None] * n).reshape(-1)
    v = values.long()
    ok = (v >= 0) & (v < (1 << _V_BITS)) & mask
    s = torch.where(ok, ids, torch.full_like(ids, num_segments))
    v = torch.where(ok, v, torch.zeros_like(v))
    ks = torch.sort((s << _V_BITS) | v).values
    ss = ks >> _V_BITS
    vs = ks & ((1 << _V_BITS) - 1)
    start = torch.ones_like(ks, dtype=torch.bool)
    start[1:] = ks[1:] != ks[:-1]
    run_id = torch.cumsum(start, 0) - 1
    run_len = torch.bincount(run_id, minlength=ks.shape[0])
    score = run_len[run_id] * (1 << _V_BITS) + ((1 << _V_BITS) - 1 - vs)
    score = torch.where(start, score, torch.full_like(score, -1))
    seg_of_row = torch.clamp(ss, max=num_segments)
    best = torch.full((num_segments + 1,), torch.iinfo(torch.int64).min,
                      dtype=torch.int64, device=dev)
    best.scatter_reduce_(0, seg_of_row, score, "amax")
    best = best[:num_segments]
    val = ((1 << _V_BITS) - 1) - (best & ((1 << _V_BITS) - 1))
    return torch.where(best > 0, val, torch.full_like(val, default)) \
        .to(values.dtype)


#: the longest run the kernel's short-row path takes (a warp's lanes);
#: longer runs are ``ModePlan.long_rows``, a block each
SHORT_RUN = 32
#: the longest run a long-row block sorts in shared memory
#: (``kSmemRows``); a longer one sorts in the call's global scratch
SMEM_RUN = 4096


@dataclass(frozen=True)
class ModePlan:
    """What K7-mode's launch needs of a ``SegmentCSR``, derived once per CSR
    (``mode_plan``): the rows whose runs exceed ``SHORT_RUN`` entries, and
    whether one exceeds ``SMEM_RUN`` (the call then allocates the sort
    scratch)."""
    long_rows: torch.Tensor         # int32 [nl], ascending
    needs_scratch: bool


def mode_plan(seg: SegmentCSR, m: int) -> ModePlan:
    """Check ``seg`` as K7-mode walks it and list its long rows, on the
    CSR's device (two values read back): ``indptr`` must start at 0, never
    fall, and end within the edges (``m``, or ``perm``'s length), and
    ``perm`` name edges in ``[0, m)``; raises otherwise."""
    name = "segment_mode"
    indptr, n = seg.indptr, seg.n
    nnz = m if seg.perm is None else seg.perm.shape[0]
    lens = indptr[1:] - indptr[:-1]
    stats = [indptr[0], indptr[-1], lens.min() if n else indptr[0],
             lens.max() if n else indptr[0]]
    if seg.perm is not None and int(indptr[-1]) > 0:
        walked = seg.perm[:int(indptr[-1])]
        stats += [walked.min().long(), walked.max().long()]
    first, last, shortest, longest, *named = torch.stack(stats).tolist()
    if first != 0 or shortest < 0 or last > nnz:
        raise ValueError(f"{name}: indptr is not a CSR over the {nnz} "
                         f"edges (starts at {first}, ends at {last}, a run "
                         f"of {shortest})")
    if named and (named[0] < 0 or named[1] >= m):
        raise ValueError(f"{name}: perm names edges outside [0, {m})")
    rows = torch.nonzero(lens > SHORT_RUN).reshape(-1).to(torch.int32)
    return ModePlan(rows, longest > SMEM_RUN)


def _check_csr(name: str, seg: SegmentCSR, m: int) -> None:
    _expect(name, seg.ids, "ids", (torch.int32,), (m,))
    _expect(name, seg.indptr, "indptr", (torch.int64,), (seg.n + 1,))
    if seg.perm is not None:
        _expect(name, seg.perm, "perm", (torch.int32,), (seg.perm.shape[0],))


#: ``id`` of a ``SegmentCSR`` → (a weak reference to it, its tensors'
#: versions and edge count when checked, its ``ModePlan``); a frozen CSR
#: keeps its tensors, so identity and versions pin what was checked
_MODE_PLANS: dict = {}
#: CSRs kept before the cache is cleared
_MODE_PLAN_CAP = 256


def _mode_plan_of(name: str, seg: SegmentCSR, m: int) -> ModePlan:
    """``seg``'s checks and ``mode_plan``, once per CSR and version: a CSR
    changed in place is checked and listed again."""
    perm = seg.perm
    sig = (m, seg.indptr._version, seg.ids._version,
           None if perm is None else perm._version)
    got = _MODE_PLANS.get(id(seg))
    if got is not None and got[0]() is seg and got[1] == sig:
        return got[2]
    _check_csr(name, seg, m)
    _on_cuda(name, seg.indptr, seg.ids, *(() if perm is None else (perm,)))
    plan = mode_plan(seg, m)
    if len(_MODE_PLANS) >= _MODE_PLAN_CAP:
        _MODE_PLANS.clear()
    _MODE_PLANS[id(seg)] = (weakref.ref(seg), sig, plan)
    return plan


def segment_mode(values, seg: SegmentCSR, num_segments: int, mask=None,
                 default: int = -1, k: int = 1):
    """K7-mode wrapper (``raphtory_tpu/ops/segment.py:155``
    ``segment_mode``, as ``LabelPropagation.exchange`` calls it): the most
    frequent value of each of the ``num_segments = k*n`` (window, segment)
    inboxes of ``values [k*m]`` under ``mask bool[k*m]`` (None: every row),
    ties to the smallest value, ``default`` where nothing counts. Int32
    payloads on the card, one launch a call up to 65,535 windows (one a
    group of 65,535 past that): the CSR is checked and its
    long rows listed once per CSR and version (``_mode_plan_of``), the
    values and mask at every call; the sort scratch is allocated only for
    a CSR with a run past ``SMEM_RUN``."""
    name = "segment_mode"
    m, n = _mode_args(name, values, seg, num_segments, mask, k)
    if not _on_cuda(name, values, seg.indptr,
                    *(() if mask is None else (mask,))):
        _check_csr(name, seg, m)
        return segment_mode_plain(values, seg, num_segments, mask, default, k)
    if values.dtype != torch.int32 or not values.is_contiguous():
        raise TypeError(f"{name}: values must be contiguous int32 on the "
                        f"card, not {values.dtype}")
    default = int(default)
    if not -(1 << 31) <= default < (1 << 31):
        raise ValueError(f"{name}: default {default} is not an int32")
    plan = _mode_plan_of(name, seg, m)
    out = values.new_empty(k * n)
    # the long inboxes' sort space past shared memory: row r of window w
    # sorts in place at w*m + indptr[r] .. (disjoint runs, one buffer)
    scratch = values.new_empty(k * m) if plan.needs_scratch else None
    _run(name, _fn("segment", "rtpu_segment_mode"),
         k, n, m, default, plan.long_rows.shape[0], seg.indptr.data_ptr(),
         None if seg.perm is None else seg.perm.data_ptr(),
         values.data_ptr(), None if mask is None else mask.data_ptr(),
         plan.long_rows.data_ptr(),
         None if scratch is None else scratch.data_ptr(), out.data_ptr(),
         _stream(values))
    return out


# ---------------------------------------------------------------- K7-P

@dataclass(frozen=True)
class PartitionWalk:
    """Where K7-P reads each destination row's payload: row r (of the
    partition-major destination space, partition p owning rows p*n_per ..
    (p+1)*n_per-1) combines the slots ``order[indptr[r]:indptr[r+1]]``, in
    that order; slot s is payload row ``perm[s]`` (None: row s) and counts
    only where ``valid[s]`` (None: every slot)."""
    indptr: torch.Tensor            # int64 [n + 1]
    order: torch.Tensor             # int32 [nnz] slots
    perm: torch.Tensor | None       # int32 [B] slot → payload row
    valid: torch.Tensor | None      # bool [B]

    @property
    def n(self) -> int:
        """Destination rows (the output's rows per window)."""
        return self.indptr.shape[0] - 1


def partition_walk(local_ids, n_per: int, num_segments: int) -> PartitionWalk:
    """The walk of the reference's operands: ``local_ids [P, cap]`` rows
    within each partition (slot ``p * cap + i`` lands in row ``p * n_per +
    local_ids[p, i]``; ids outside ``[0, n_per)`` and rows past
    ``num_segments`` are dropped, as the reference's per-partition
    segment ops and final slice drop them). Slots of a row keep their slot
    order."""
    P = local_ids.shape[0]
    loc = local_ids.long()
    dest = (loc + torch.arange(P, device=loc.device)[:, None] * n_per) \
        .reshape(-1)
    keep = ((loc >= 0) & (loc < n_per)).reshape(-1) & (dest < num_segments)
    slots = torch.nonzero(keep).reshape(-1)
    order = slots[torch.argsort(dest[slots], stable=True)]
    indptr = torch.zeros(num_segments + 1, dtype=torch.int64,
                         device=loc.device)
    indptr[1:] = torch.cumsum(
        torch.bincount(dest[slots], minlength=num_segments), 0)
    return PartitionWalk(indptr, order.to(torch.int32), None, None)


def partition_reduce_plain(data, walk: PartitionWalk, op: str, mask,
                           k: int = 1):
    """Twin of ``rtpu_partition_reduce``: ``data [k*m, ...]`` engine-order
    payloads with ``mask bool[k*m]`` → ``[k*n, ...]``, window w's row r the
    ``op`` over the walk's slots of r (payload ``perm[s]``, counted where
    ``valid[s]`` and the mask are set) — ``raphtory_tpu/ops/segment.py:116``
    over ``x[:, b_perm]``, ``mask[:, b_perm] & b_valid``
    (``engine/bsp.py:131-141``)."""
    n = walk.n
    m = data.shape[0] // k if k else 0
    tail = tuple(data.shape[1:])
    x = data.reshape(k, m, -1)
    fill = neutral(op, data.dtype)
    slots = walk.order.long()
    rows = torch.repeat_interleave(
        torch.arange(n, device=data.device), torch.diff(walk.indptr))
    e = walk.perm.long()[slots] if walk.perm is not None else slots
    keep = mask.reshape(k, m)[:, e]
    if walk.valid is not None:
        keep = keep & walk.valid[slots][None, :]
    xs = torch.where(keep[:, :, None], x[:, e],
                     torch.full_like(x[:, :1], fill))
    out = torch.full((k, n, x.shape[2]), fill, dtype=data.dtype,
                     device=data.device)
    for w in range(k):
        if op == "sum":
            out[w].index_add_(0, rows, xs[w])
        else:
            out[w].scatter_reduce_(0, rows[:, None].expand_as(xs[w]), xs[w],
                                   "amin" if op == "min" else "amax")
    return out.reshape((k * n,) + tail)


def partition_reduce(data, walk: PartitionWalk, op: str, mask, k: int = 1):
    """K7-P wrapper: the masked sum/min/max of ``data [k*m, ...]`` over the
    walk's slots of each destination row, per window → ``[k*n, ...]``.
    Float32, int32 and int64 payloads on the card (an int64 launch counts
    as ``partition_segment_reduce_i64``), launched as K7 is (one launch a
    call up to 65,535 grid rows), the walk and the mask checked once per
    signature as K7's are."""
    name = "partition_segment_reduce"
    if op not in _OPS:
        raise ValueError(f"{name}: unknown combiner {op!r}; use one of "
                         f"{sorted(_OPS)}")
    if data.dim() == 0 or k <= 0 or data.shape[0] % k:
        raise ValueError(f"{name}: data has shape {tuple(data.shape)}, "
                         f"want [k*m, ...] with k={k} windows")
    m, n = data.shape[0] // k, walk.n
    extra = tuple(t for t in (walk.perm, walk.valid) if t is not None)

    def check():
        _expect(name, mask, "mask", (torch.bool,), (k * m,))
        _expect(name, walk.indptr, "indptr", (torch.int64,), (n + 1,))
        _expect(name, walk.order, "order", (torch.int32,),
                (walk.order.shape[0],))
        for what, t, dt in (("perm", walk.perm, torch.int32),
                            ("valid", walk.valid, torch.bool)):
            if t is not None:
                _expect(name, t, what, (dt,), (t.shape[0],))
        if (walk.perm is not None and walk.valid is not None
                and walk.perm.shape != walk.valid.shape):
            raise ValueError(f"{name}: perm and valid have "
                             f"{walk.perm.shape[0]} and "
                             f"{walk.valid.shape[0]} slots")
        if not _on_cuda(name, data, mask, walk.indptr, walk.order, *extra):
            return None
        return _plan_of(name, m, walk.indptr, walk.order, walk.perm,
                        walk.valid)

    long_rows = _k2_checked(name, (mask, walk.indptr, walk.order, *extra),
                            (k, walk.perm is None, walk.valid is None),
                            check)
    if long_rows is None:
        return partition_reduce_plain(data, walk, op, mask, k)
    F = _payload_f(name, data, mask)
    out = torch.empty((k * n,) + tuple(data.shape[1:]), dtype=data.dtype,
                      device=data.device)
    if not out.numel():
        return out
    _run(_counted(name, data.dtype),
         _fn("segment", "rtpu_partition_reduce"),
         k, n, m, F, _OPS[op], _KERNEL_DTYPES[data.dtype],
         long_rows.shape[0], walk.indptr.data_ptr(), walk.order.data_ptr(),
         None if walk.perm is None else walk.perm.data_ptr(),
         None if walk.valid is None else walk.valid.data_ptr(),
         long_rows.data_ptr(), data.data_ptr(), mask.data_ptr(),
         out.data_ptr(), _stream(data))
    return out


def partition_segment_reduce(data, local_ids, n_per: int, num_segments: int,
                             op: str = "sum", mask=None):
    """``raphtory_tpu/ops/segment.py:116`` with its signature: ``data [P,
    cap, ...]`` destination-binned payloads, ``local_ids [P, cap]`` rows
    within each partition → ``[num_segments, ...]`` (masked rows, and empty
    rows, give the combiner's neutral value). Runs K7-P over
    ``partition_walk``."""
    if op not in _OPS:
        raise ValueError(f"unknown combiner {op!r}; use one of "
                         f"{sorted(_OPS)}")
    P, cap = local_ids.shape
    flat = data.reshape((P * cap,) + tuple(data.shape[2:]))
    if mask is None:
        mask = torch.ones(P * cap, dtype=torch.bool, device=data.device)
    return partition_reduce(flat, partition_walk(local_ids, n_per,
                                                 num_segments),
                            op, mask.reshape(-1))
