"""The exchange kernels of the mesh path: ``halo_pack`` (K11's halo route)
and ``frontier_compact`` / ``frontier_merge_min`` (K13, the sparse
frontier route).

Same three parts as ``ops/columns.py``, whose build and launch plumbing
they share: the **wrapper** (CPU tensors take the twin, CUDA tensors
launch the kernel from ``csrc/exchange.cu`` or raise; each launch adds one
to ``columns.LAUNCHES``), the **plain twin** (``*_plain``), and the CUDA
source.

* ``halo_pack`` — the send page of ``exchange_halo``
  (``raphtory_tpu/parallel/sharded.py:697-708``): rows ``send_idx`` of a
  local state leaf ``[k, n_loc, *trail]``, written slot-major ``[S*h, k,
  *trail]``, the layout ``all_to_all`` sends as it stands.
* ``frontier_count`` + ``frontier_compact`` — the host compaction of
  ``raphtory_tpu/parallel/frontier.py:458-485``: the changed rows'
  ascending flat indices (``np.flatnonzero``'s order, int64) and their
  values, padded to the agreed bucket length with index 0 and the min
  identity. On the card the first launch counts and compacts in one pass
  into buffers of N slots and leaves the count on the device, so the
  ranks agree the bucket length from the all-gathered counts without a
  read-back of their own; the second pads the agreed bucket.
* ``frontier_merge_min`` — the ``np.minimum.at`` merge of
  ``frontier.py:498-502``: every gathered slice's live slots min-merged
  into the replica in place. Each row has ONE owner, so no two live slots
  name the same row; the kernel needs no atomics and is exact for floats.

The kernels run once a superstep on small inputs, so their host path is
kept lean: each wrapper checks its inputs in full
once per signature (shapes, dtypes, strides and devices of every tensor)
and caches the result with the launch plan, so a later call with the same
signature costs a dict lookup, and a call with any other signature (a
wrong one included) takes the full check again and raises as before. The
plan's integers reach the C entry point as one cached array; the stream
is read raw (``columns._stream``).

``SAMPLES``, when set to a dict, keeps host copies of the inputs of each
kernel's largest call (``chip_smoke.py`` times the kernels at the shapes
the mesh path gave them).
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from .columns import _expect, _fn, _launch, _on_cuda, _stream

#: inputs of each wrapper's largest call, on the host (None: not kept)
SAMPLES: dict | None = None

_MERGE_DTYPES = {torch.float32: 0, torch.int32: 1, torch.float64: 2,
                 torch.int64: 3}


def min_identity(dtype: torch.dtype):
    """The min-merge identity of ``dtype`` (``frontier._min_identity``):
    +inf, or the integer maximum."""
    if dtype.is_floating_point:
        return float("inf")
    return torch.iinfo(dtype).max


def _keep(name: str, size: int, *tensors) -> None:
    if SAMPLES is None:
        return
    if name not in SAMPLES or size > SAMPLES[name][0]:
        SAMPLES[name] = (size, tuple(t.detach().cpu().clone()
                                     if isinstance(t, torch.Tensor) else t
                                     for t in tensors))


def _tensors(name, **tensors):
    for what, t in tensors.items():
        if not isinstance(t, torch.Tensor):
            raise TypeError(f"{name}: {what} is {type(t).__name__}, want a "
                            "tensor")


# ---------------------------------------------------------------- halo

#: threads a block of the halo and merge kernels
THREADS = 256
#: shared bytes a halo block stages its slots in, at most
STAGE_BYTES = 16384
#: blocks the plans aim for before they widen a tile (two waves on the
#: H100's 132 SMs)
MIN_BLOCKS = 264
#: signatures kept by each wrapper's cache before it starts over
_SIG_CAP = 64


def _pow2_ceil(x: int) -> int:
    return 1 << max(0, int(x) - 1).bit_length()


def _lanes(words: int) -> int:
    """Threads that share one slot: the row's words, to a power of two,
    at most a warp."""
    return min(32, _pow2_ceil(words))


def halo_plan(k: int, sh: int, row_bytes: int, align: int):
    """The launch plan of one ``rtpu_halo_pack`` call: ``(word, lanes,
    tile, staged, grid, smem)``. ``align`` is the largest power of two (at
    most 16) dividing both the leaf's and the page's addresses.

    * ``word``: the widest of 16, 8, 4, 2 and 1 bytes that divides the row
      bytes and ``align``;
    * ``lanes`` threads a slot (``THREADS // lanes`` slots a pass);
    * staged (the page 16-byte aligned and a pass's slots fit in
      ``STAGE_BYTES``): ``tile`` slots a block, a multiple of 16 so that
      every tile starts 16-byte aligned in the page, widened by powers of
      two while the grid keeps ``MIN_BLOCKS`` blocks and the tile fits;
      ``smem`` is the tile's bytes. Otherwise a pass's slots a block,
      copied straight to the page."""
    word = 16
    while word > 1 and (row_bytes % word or align % word):
        word //= 2
    lanes = _lanes(row_bytes // word)
    rows = THREADS // lanes
    slot = k * row_bytes
    base = max(rows, 16)
    staged = align >= 16 and 0 < base * slot <= STAGE_BYTES
    if staged:
        tile = base
        while (tile * 2 * slot <= STAGE_BYTES and tile < 4 * base
               and -(-sh // (tile * 2)) >= MIN_BLOCKS):
            tile *= 2
        smem = tile * slot
    else:
        tile, smem = rows, 0
    grid = -(-sh // tile) if sh * slot else 0
    return word, lanes, tile, int(staged), grid, smem


def halo_pack_plain(a, send_idx):
    """Twin of ``rtpu_halo_pack``: ``a [k, n, *trail]`` rows ``send_idx``
    (every index in ``[0, n)``) → ``[len(send_idx), k, *trail]``."""
    return torch.index_select(a, 1, send_idx.long()).transpose(0, 1) \
        .contiguous()


#: halo_pack signature → None (CPU: the twin) or (the page's template, [k,
#: n, S*h, row bytes], {the addresses' low bits: plan array
#: (``_plan_array``)}, the C entry point). The template is one element
#: expanded to the page's shape: ``torch.empty_like`` of it allocates a
#: contiguous page for less host time than a shape-parsing ``empty``.
_HALO_SIGS: dict = {}


def _halo_signature(key, a, send_idx):
    """The full checks of ``halo_pack`` (raising on a bad input), then the
    signature's cache entry."""
    name = "halo_pack"
    _tensors(name, a=a, send_idx=send_idx)
    if a.dim() < 2:
        raise ValueError(f"{name}: leaf has shape {tuple(a.shape)}, want "
                         "[k, n_loc, ...]")
    _expect(name, send_idx, "send_idx", (torch.int32,),
            (send_idx.shape[0],))
    _expect(name, a, "a", (a.dtype,), tuple(a.shape))
    if not _on_cuda(name, a, send_idx):
        entry = None
    else:
        k, n, sh = a.shape[0], a.shape[1], send_idx.shape[0]
        trail = tuple(a.shape[2:])
        row_bytes = a.element_size()
        for d in trail:
            row_bytes *= d
        if k * row_bytes >= 1 << 31:
            raise ValueError(f"{name}: a slot of {k} x {row_bytes} bytes is "
                             "past the kernel's 32-bit slot offsets")
        template = a.new_empty(()).expand((sh, k) + trail)
        entry = (template, [k, n, sh, row_bytes], {},
                 _fn("exchange", "rtpu_halo_pack"))
    if len(_HALO_SIGS) >= _SIG_CAP:
        _HALO_SIGS.clear()
    _HALO_SIGS[key] = entry
    return entry


def _plan_array(values):
    """``values`` as a C ``int64_t`` array: ``(its address, the array)``,
    the array kept alive beside the address the launches pass."""
    arr = (ctypes.c_int64 * len(values))(*values)
    return ctypes.addressof(arr), arr


def halo_pack(a, send_idx):
    """K11 halo send page: rows ``send_idx`` (int32 ``[S*h]``) of the
    local leaf ``a [k, n_loc, *trail]`` (any dtype) → slot-major ``[S*h,
    k, *trail]``."""
    try:
        key = (a.shape, a.stride(), a.dtype, a.device, send_idx.shape,
               send_idx.stride(), send_idx.dtype, send_idx.device)
        sig = _HALO_SIGS.get(key, False)
    except AttributeError:          # not a tensor: the full check raises
        key, sig = None, False
    if sig is False:
        sig = _halo_signature(key, a, send_idx)
    if SAMPLES is not None:
        _keep("halo_pack", a.numel(), a, send_idx)
    if sig is None:
        return halo_pack_plain(a, send_idx)
    template, dims, plans, fn = sig
    out = torch.empty_like(template)
    src, dst = a.data_ptr(), out.data_ptr()
    low = (src | dst) & 15
    plan = plans.get(low)
    if plan is None:
        k, _, sh, row_bytes = dims
        plan = plans[low] = _plan_array(dims + list(halo_plan(
            k, sh, row_bytes, low & -low if low else 16)))
    err = fn(plan[0], send_idx.data_ptr(), src, dst, _stream(a))
    _launch("halo_pack", err)
    return out


# ---------------------------------------------------------------- frontier

#: rows a block of the one-pass compaction takes (``csrc/exchange.cu``)
TILE_ROWS = 8192
#: epochs a compaction scratch serves before it is cleared (the status
#: words' 22-bit epoch field; 0 is never used)
_EPOCHS = 1 << 22


class FrontierCount(NamedTuple):
    """The first pass of one compaction (``frontier_count``): the set rows'
    count, an int64 ``[1]`` tensor on the mask's device (on the card
    nothing is read back), and on the card the compacted rows already in
    place — the ascending flat indices ``idx`` and their rows ``val``, in
    buffers whose slots ``frontier_compact`` pads up to the bucket.
    ``host`` is the count as the caller already holds it on the host
    (``counted._replace(host=n)``; the sparse route's all-gathered counts),
    which spares ``frontier_compact`` a read-back."""
    count: torch.Tensor
    idx: torch.Tensor | None = None
    val: torch.Tensor | None = None
    host: int | None = None

    @property
    def total(self) -> int:
        """The count on the host: ``host`` when known, else a read-back."""
        return int(self.count) if self.host is None else self.host


def _check_changed(name, values, changed):
    n = values.shape[0]
    _expect(name, changed, "changed", (torch.bool,), (n,))
    _expect(name, values, "values", (values.dtype,), tuple(values.shape))
    return n


#: frontier_count signature → None (CPU: the count alone) or (the idx,
#: val and count templates, the plan's address, the plan, tiles, the C
#: entry point)
_COUNT_SIGS: dict = {}
#: (card, stream) → [scratch int64 [1 + tiles]: the ticket, then a status
#: word a tile; the last epoch used]
_SCRATCH: dict = {}


def _count_signature(key, changed, values, capacity):
    name = "frontier_compact"
    _tensors(name, changed=changed)
    if values is None:
        _expect(name, changed, "changed", (torch.bool,), (changed.shape[0],))
        if _on_cuda(name, changed):
            raise TypeError(f"{name}: on the card the count pass also "
                            "compacts: pass the values")
        entry = None
    else:
        _tensors(name, values=values)
        n = _check_changed(name, values, changed)
        if not _on_cuda(name, values, changed):
            entry = None
        else:
            if values.element_size() not in (4, 8):
                raise TypeError(f"{name}: state dtype {values.dtype} has no "
                                "kernel (4- or 8-byte elements)")
            cap = max(n, 1) if capacity is None else int(capacity)
            trail = tuple(values.shape[1:])
            f = 1
            for d in trail:
                f *= d
            tiles = max(1, -(-n // TILE_ROWS))
            one = values.new_empty(())
            entry = (one.new_empty((), dtype=torch.int64).expand(cap),
                     one.expand((cap,) + trail),
                     one.new_empty((), dtype=torch.int64).expand(1),
                     *_plan_array([n, f, values.element_size(), tiles]),
                     tiles, _fn("exchange", "rtpu_frontier_compact"))
    if key is not None:
        if len(_COUNT_SIGS) >= _SIG_CAP:
            _COUNT_SIGS.clear()
        _COUNT_SIGS[key] = entry
    return entry


def _scratch(values, stream: int, tiles: int):
    """The compaction scratch of ``values``' card and ``stream`` (grown to
    ``tiles`` status words, cleared when the epochs run out) and the
    call's epoch."""
    key = (values.get_device(), stream)
    st = _SCRATCH.get(key)
    if st is None or st[0].shape[0] <= tiles:
        st = _SCRATCH[key] = [torch.zeros(1 + tiles, dtype=torch.int64,
                                          device=values.device), 0]
    elif st[1] + 1 >= _EPOCHS:
        st[0].zero_()
        st[1] = 0
    st[1] += 1
    return st[0], st[1]


def frontier_count(changed, values=None) -> FrontierCount:
    """The first pass of a compaction: the set rows of ``changed bool[N]``
    counted and, on the card, compacted as ``frontier_compact`` returns
    them (ascending flat indices, then the rows of ``values [N, *trail]``)
    into buffers of ``max(N, 1)`` slots, the largest bucket the sparse
    route asks for — one launch, no read-back. The card needs ``values``;
    on the CPU it counts only (``values`` may be left out)."""
    return _count_pass(changed, values, None)


def _count_pass(changed, values, capacity: int | None) -> FrontierCount:
    """``frontier_count`` into buffers of ``capacity`` slots (None:
    ``max(N, 1)``)."""
    try:
        key = (changed.shape, changed.stride(), changed.dtype, changed.device,
               None if values is None else (values.shape, values.stride(),
                                            values.dtype, values.device),
               capacity)
        sig = _COUNT_SIGS.get(key, False)
    except AttributeError:          # not a tensor: the full check raises
        key, sig = None, False
    if sig is False:
        sig = _count_signature(key, changed, values, capacity)
    if sig is None:
        return FrontierCount(changed.sum(dtype=torch.int64).reshape(1))
    idx_t, val_t, cnt_t, plan, _, tiles, fn = sig
    idx, val, cnt = (torch.empty_like(idx_t), torch.empty_like(val_t),
                     torch.empty_like(cnt_t))
    stream = _stream(values)
    scratch, epoch = _scratch(values, stream, tiles)
    err = fn(plan, epoch, changed.data_ptr(), values.data_ptr(),
             idx.data_ptr(), val.data_ptr(), cnt.data_ptr(),
             scratch.data_ptr(), stream)
    _launch("frontier_compact", err)
    return FrontierCount(cnt, idx, val)


def frontier_compact_plain(values, changed, bucket: int, identity):
    """Twin: ``np.flatnonzero(changed)`` and ``values`` at those rows,
    padded to ``bucket`` slots with index 0 and ``identity``."""
    idx = torch.nonzero(changed).reshape(-1)
    cnt = idx.shape[0]
    if cnt > bucket:
        raise ValueError(f"frontier_compact: {cnt} set rows > bucket "
                         f"{bucket}")
    out_idx = torch.zeros(bucket, dtype=torch.int64, device=values.device)
    out_idx[:cnt] = idx
    out_val = torch.full((bucket,) + tuple(values.shape[1:]), identity,
                         dtype=values.dtype, device=values.device)
    out_val[:cnt] = values[idx]
    return out_idx, out_val


def _ident_bits(identity, dtype: torch.dtype) -> int:
    t = torch.tensor([identity], dtype=dtype)
    if t.element_size() == 4:
        return int(t.view(torch.int32).item()) & 0xFFFFFFFF
    return int(t.view(torch.int64).item())


#: frontier_compact signature → None (CPU: the twin) or (the pad plan's
#: address, the plan, the C entry point)
_PAD_SIGS: dict = {}


def _pad_signature(key, values, changed, bucket, identity):
    name = "frontier_compact"
    _tensors(name, values=values, changed=changed)
    _check_changed(name, values, changed)
    bucket = int(bucket)
    if bucket < 0:
        raise ValueError(f"{name}: bucket {bucket} < 0")
    if not _on_cuda(name, values, changed):
        entry = None
    else:
        if values.element_size() not in (4, 8):
            raise TypeError(f"{name}: state dtype {values.dtype} has no "
                            "kernel (4- or 8-byte elements)")
        f = 1
        for d in values.shape[1:]:
            f *= d
        grid = min(1024, -(-bucket * f // THREADS))
        entry = (*_plan_array([bucket, f, values.element_size(),
                               _ident_bits(identity, values.dtype), grid]),
                 _fn("exchange", "rtpu_frontier_pad"))
    if key is not None:
        if len(_PAD_SIGS) >= _SIG_CAP:
            _PAD_SIGS.clear()
        _PAD_SIGS[key] = entry
    return entry


def frontier_compact(values, changed, bucket: int, identity,
                     counted: FrontierCount | None = None):
    """K13 compaction: the rows of ``values [N, *trail]`` where ``changed
    bool[N]`` is set, as ``(idx int64 [bucket], val [bucket, *trail])`` —
    ascending flat indices, then index 0 / ``identity`` pads; raises when
    more than ``bucket`` rows are set. ``counted`` is
    ``frontier_count(changed, values)`` of these tensors; on the card this
    call then pads the rows already compacted (one launch), checking the
    count against ``bucket`` from ``counted.host`` when the caller holds it
    (no sync; the sparse route does) or else from a read-back. When None,
    the wrapper runs the count pass and reads the count back once."""
    try:
        key = (values.shape, values.stride(), values.dtype, values.device,
               changed.shape, changed.stride(), changed.dtype,
               changed.device, bucket, identity)
        sig = _PAD_SIGS.get(key, False)
    except AttributeError:          # not a tensor: the full check raises
        key, sig = None, False
    if sig is False:
        sig = _pad_signature(key, values, changed, bucket, identity)
    name = "frontier_compact"
    if sig is None:
        if SAMPLES is not None:
            _keep(name, int(changed.sum()), values, changed, int(bucket),
                  identity)
        return frontier_compact_plain(values, changed, bucket, identity)
    if counted is None:
        counted = _count_pass(changed, values,
                              max(values.shape[0], bucket, 1))
    total = counted.total
    if total > bucket:
        raise ValueError(f"{name}: {total} set rows > bucket {bucket}")
    cap = counted.idx.shape[0]
    if cap < bucket:
        raise ValueError(f"{name}: bucket {bucket} > the count pass's "
                         f"{cap} slots")
    if SAMPLES is not None:
        _keep(name, total, values, changed, int(bucket), identity)
    err = sig[2](sig[0], counted.count.data_ptr(), counted.idx.data_ptr(),
                 counted.val.data_ptr(), _stream(values))
    _launch(name, err)
    if cap == bucket:
        return counted.idx, counted.val
    return counted.idx[:bucket], counted.val[:bucket]


def frontier_merge_min_plain(replica, idx, val, counts):
    """Twin of ``rtpu_frontier_merge_min``: for each slice r, its first
    ``counts[r]`` slots min-merged into ``replica`` (in place)."""
    R = counts.shape[0]
    bucket = idx.shape[0] // R if R else 0
    live = (torch.arange(bucket, device=idx.device)[None, :]
            < counts[:, None]).reshape(-1)
    rows = idx[live]
    replica[rows] = torch.minimum(replica[rows], val[live])
    return replica


def merge_plan(R: int, bucket: int, f: int):
    """The launch plan of one ``rtpu_frontier_merge_min`` call: ``(lanes,
    tile, grid_x)`` — ``lanes`` threads a slot (the row's elements, to a
    power of two, at most a warp), a tile of one pass's slots
    (``THREADS // lanes``) a block, and the grid's x the tiles of one
    slice (its y is the slice)."""
    lanes = _lanes(f)
    tile = THREADS // lanes
    return lanes, tile, (-(-bucket // tile) if R * bucket * f else 0)


#: frontier_merge_min signature → None (CPU: the twin) or (its plan
#: array's address, the array, the C entry point)
_MERGE_SIGS: dict = {}


def _merge_signature(key, replica, idx, val, counts):
    name = "frontier_merge_min"
    _tensors(name, replica=replica, idx=idx, val=val, counts=counts)
    n = replica.shape[0]
    R = counts.shape[0]
    # the counts may be a strided column (``counts[:, 0]`` of the
    # all-gathered [R, 2]); everything else is contiguous
    if counts.dim() != 1 or counts.dtype != torch.int64:
        raise TypeError(f"{name}: counts has dtype {counts.dtype} and shape "
                        f"{tuple(counts.shape)}, want int64 [R]")
    _expect(name, idx, "idx", (torch.int64,), (idx.shape[0],))
    if R and idx.shape[0] % R:
        raise ValueError(f"{name}: {idx.shape[0]} slots do not split into "
                         f"{R} slices")
    _expect(name, val, "val", (replica.dtype,),
            (idx.shape[0],) + tuple(replica.shape[1:]))
    _expect(name, replica, "replica", (replica.dtype,), tuple(replica.shape))
    if not _on_cuda(name, replica, idx, val, counts):
        entry = None
    else:
        if replica.dtype not in _MERGE_DTYPES:
            raise TypeError(f"{name}: state dtype {replica.dtype} has no "
                            "kernel (want one of "
                            f"{sorted(map(str, _MERGE_DTYPES))})")
        if R > 65535:
            raise ValueError(f"{name}: {R} slices, at most 65,535 (the "
                             "grid's y)")
        bucket = idx.shape[0] // R if R else 0
        f = 1
        for d in replica.shape[1:]:
            f *= d
        entry = (*_plan_array([R, bucket, f, n,
                               _MERGE_DTYPES[replica.dtype],
                               counts.stride(0) if R else 1,
                               *merge_plan(R, bucket, f)]),
                 _fn("exchange", "rtpu_frontier_merge_min"))
    if len(_MERGE_SIGS) >= _SIG_CAP:
        _MERGE_SIGS.clear()
    _MERGE_SIGS[key] = entry
    return entry


def frontier_merge_min(replica, idx, val, counts):
    """K13 merge: ``replica [N, *trail]`` min-merged IN PLACE with the
    ``R`` gathered slices ``idx int64 [R*B]`` / ``val [R*B, *trail]``, the
    first ``counts[r]`` slots of slice r live (``counts`` int64 ``[R]``,
    any stride). Rows must have one owner (no row named by two live
    slots)."""
    try:
        key = (replica.shape, replica.stride(), replica.dtype,
               replica.device, idx.shape, idx.stride(), idx.dtype,
               idx.device, val.shape, val.stride(), val.dtype, val.device,
               counts.shape, counts.stride(), counts.dtype, counts.device)
        plan = _MERGE_SIGS.get(key, False)
    except AttributeError:          # not a tensor: the full check raises
        key, plan = None, False
    if plan is False:
        plan = _merge_signature(key, replica, idx, val, counts)
    if SAMPLES is not None:
        _keep("frontier_merge_min", int(counts.sum()), replica, idx, val,
              counts)
    if plan is None:
        return frontier_merge_min_plain(replica, idx, val, counts)
    err = plan[2](plan[0], counts.data_ptr(), idx.data_ptr(),
                  val.data_ptr(), replica.data_ptr(), _stream(replica))
    _launch("frontier_merge_min", err)
    return replica
