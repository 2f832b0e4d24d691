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
  identity. The count pass runs first, alone, because the bucket length
  depends on every rank's count.
* ``frontier_merge_min`` — the ``np.minimum.at`` merge of
  ``frontier.py:498-502``: every gathered slice's live slots min-merged
  into the replica in place. Each row has ONE owner, so no two live slots
  name the same row; the kernel needs no atomics and is exact for floats.

``SAMPLES``, when set to a dict, keeps host copies of the inputs of each
kernel's largest call (``chip_smoke.py`` times the kernels at the shapes
the mesh path gave them).
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from .columns import _expect, _fn, _launch, _on_cuda, _ptr, _stream

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


# ---------------------------------------------------------------- halo

def halo_pack_plain(a, send_idx):
    """Twin of ``rtpu_halo_pack``: ``a [k, n, *trail]`` rows ``send_idx``
    (every index in ``[0, n)``) → ``[len(send_idx), k, *trail]``."""
    return torch.index_select(a, 1, send_idx.long()).transpose(0, 1) \
        .contiguous()


def halo_pack(a, send_idx):
    """K11 halo send page: rows ``send_idx`` (int32 ``[S*h]``) of the
    local leaf ``a [k, n_loc, *trail]`` (any dtype) → slot-major ``[S*h,
    k, *trail]``."""
    name = "halo_pack"
    if a.dim() < 2:
        raise ValueError(f"{name}: leaf has shape {tuple(a.shape)}, want "
                         "[k, n_loc, ...]")
    _expect(name, send_idx, "send_idx", (torch.int32,),
            (send_idx.shape[0],))
    _expect(name, a, "a", (a.dtype,), tuple(a.shape))
    _keep(name, a.numel(), a, send_idx)
    if not _on_cuda(name, a, send_idx):
        return halo_pack_plain(a, send_idx)
    k, n = a.shape[0], a.shape[1]
    sh = send_idx.shape[0]
    out = torch.empty((sh, k) + tuple(a.shape[2:]), dtype=a.dtype,
                      device=a.device)
    row_bytes = a[0, 0].numel() * a.element_size() if k * n else 0
    err = _fn("exchange", "rtpu_halo_pack")(
        k, n, sh, row_bytes, _ptr(send_idx), _ptr(a), _ptr(out), _stream(a))
    _launch(name, err)
    return out


# ---------------------------------------------------------------- frontier

@dataclass(frozen=True)
class FrontierCount:
    """The count pass of one compaction: the set rows' total, and (on the
    card) each 4,096-row chunk's exclusive offset."""
    total: int
    offsets: torch.Tensor | None


def _check_changed(name, values, changed):
    n = values.shape[0]
    _expect(name, changed, "changed", (torch.bool,), (n,))
    _expect(name, values, "values", (values.dtype,), tuple(values.shape))
    return n


def frontier_count(changed) -> FrontierCount:
    """The count pass (two launches on the card: chunk counts, then their
    scan); the total comes back to the host."""
    name = "frontier_compact"
    _expect(name, changed, "changed", (torch.bool,), (changed.shape[0],))
    if not _on_cuda(name, changed):
        return FrontierCount(int(changed.sum()), None)
    n = changed.shape[0]
    g = max(1, -(-n // 4096))
    scratch = torch.empty(2 * g + 1, dtype=torch.int64, device=changed.device)
    counts, offsets, total = scratch[:g], scratch[g:2 * g], scratch[2 * g:]
    err = _fn("exchange", "rtpu_frontier_count")(
        n, _ptr(changed), _ptr(counts), _ptr(offsets), _ptr(total),
        _stream(changed))
    _launch(name, err, launched=2)
    return FrontierCount(int(total.item()), offsets)


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


def frontier_compact(values, changed, bucket: int, identity,
                     counted: FrontierCount | None = None):
    """K13 compaction: the rows of ``values [N, *trail]`` where ``changed
    bool[N]`` is set, as ``(idx int64 [bucket], val [bucket, *trail])`` —
    ascending flat indices, then index 0 / ``identity`` pads. ``counted``
    is this mask's ``frontier_count`` (run here when None)."""
    name = "frontier_compact"
    n = _check_changed(name, values, changed)
    if not _on_cuda(name, values, changed):
        if SAMPLES is not None:
            _keep(name, int(changed.sum()), values, changed, int(bucket),
                  identity)
        return frontier_compact_plain(values, changed, bucket, identity)
    if values.element_size() not in (4, 8):
        raise TypeError(f"{name}: state dtype {values.dtype} has no kernel "
                        "(4- or 8-byte elements)")
    if counted is None:
        counted = frontier_count(changed)
    count = counted.total
    if count > bucket:
        raise ValueError(f"{name}: {count} set rows > bucket {bucket}")
    _keep(name, count, values, changed, int(bucket), identity)
    f = values[0].numel() if n else 1
    out_idx = torch.empty(bucket, dtype=torch.int64, device=values.device)
    out_val = torch.empty((bucket,) + tuple(values.shape[1:]),
                          dtype=values.dtype, device=values.device)
    err = _fn("exchange", "rtpu_frontier_compact")(
        n, bucket, count, f, values.element_size(),
        _ident_bits(identity, values.dtype), _ptr(changed),
        _ptr(counted.offsets), _ptr(values), _ptr(out_idx), _ptr(out_val),
        _stream(values))
    _launch(name, err)
    return out_idx, out_val


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


def frontier_merge_min(replica, idx, val, counts):
    """K13 merge: ``replica [N, *trail]`` min-merged IN PLACE with the
    ``R`` gathered slices ``idx int64 [R*B]`` / ``val [R*B, *trail]``, the
    first ``counts[r]`` slots of slice r live (``counts`` int64 ``[R]``).
    Rows must have one owner (no row named by two live slots)."""
    name = "frontier_merge_min"
    n = replica.shape[0]
    R = counts.shape[0]
    _expect(name, counts, "counts", (torch.int64,), (R,))
    _expect(name, idx, "idx", (torch.int64,), (idx.shape[0],))
    if R and idx.shape[0] % R:
        raise ValueError(f"{name}: {idx.shape[0]} slots do not split into "
                         f"{R} slices")
    _expect(name, val, "val", (replica.dtype,),
            (idx.shape[0],) + tuple(replica.shape[1:]))
    _expect(name, replica, "replica", (replica.dtype,), tuple(replica.shape))
    if SAMPLES is not None:
        _keep(name, int(counts.sum()), replica, idx, val, counts)
    if not _on_cuda(name, replica, idx, val, counts):
        return frontier_merge_min_plain(replica, idx, val, counts)
    if replica.dtype not in _MERGE_DTYPES:
        raise TypeError(f"{name}: state dtype {replica.dtype} has no kernel "
                        f"(want one of {sorted(map(str, _MERGE_DTYPES))})")
    bucket = idx.shape[0] // R if R else 0
    f = replica[0].numel() if n else 1
    err = _fn("exchange", "rtpu_frontier_merge_min")(
        R, bucket, f, n, _MERGE_DTYPES[replica.dtype], _ptr(counts),
        _ptr(idx), _ptr(val), _ptr(replica), _stream(replica))
    _launch(name, err)
    return replica
