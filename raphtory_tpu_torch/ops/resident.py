"""K9a, K9b and K8u — the kernels of the resident sweep's device half and
of the cold route's bit-packed masks.

* **K9a** ``apply_delta_chunk`` (``raphtory_tpu/engine/device_sweep.py:239``
  ``_compiled_apply``): scatter-set one padded delta chunk into the six
  resident fold-state buffers, IN PLACE (the reference donates the buffers
  and gets new ones back; here they are updated where they lie). Pad rows
  carry the index 2^31-1 and are skipped. A chunk is one byte buffer
  (``PackedChunk``, built by ``pack_chunk``): its eight arrays at 16-byte
  aligned offsets (``chunk_offsets``), staged in pinned host memory and
  shipped in one non-blocking copy.
* **K9b** ``window_masks`` (the mask half of ``device_sweep.py:261``
  ``_compiled_run``, ``:273-277``): per-window vertex and edge masks
  ``alive & (w < 0 | lat >= clamp(T - w))`` from the resident state, in the
  narrow time dtype. The card branch passes the bounds by value (a host
  array the C entry copies into a kernel parameter, 32 windows a launch):
  no device tensor, no copy, no stream sync.
* **K8u** ``unpack_view_masks`` (``raphtory_tpu/engine/bsp.py:39``
  ``_unpack_bits``, as the cold route calls it at ``:377-378``): a View's
  vertex and edge masks, bit-packed in little bit order into ONE byte
  buffer (``pack_view_masks``: pinned for a card, shipped in one
  non-blocking copy), unpacked by one launch into one allocation.

Host staging (``stage``, ``pack``, ``ship``): host arrays laid out at
16-byte offsets in one byte buffer, pinned when it is bound for a card,
and shipped in one non-blocking copy — K9a's delta chunks, the K8u masks'
bits and the host-column route's fold columns
(``engine/hopbatch._fold_columns``).

Same three parts as ``ops/columns.py``, whose build and launch plumbing
they share: wrappers that route by device (CPU tensors take the twin, CUDA
tensors launch the kernel from ``csrc/sweep.cu`` or raise), plain twins
(``*_plain``), and the CUDA source.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import numpy as np
import torch

from .columns import _expect, _fn, _k2_checked, _launch, _on_cuda, _stream

_TIME_DTYPES = (torch.int32, torch.int64)
_NUMPY = {torch.int32: np.int32, torch.int64: np.int64, torch.bool: np.bool_}
#: each time dtype's (min, max)
_LIMITS = {t: (torch.iinfo(t).min, torch.iinfo(t).max) for t in _TIME_DTYPES}


# ------------------------------------------------------- host staging

def _align16(nbytes: int) -> int:
    return -(-nbytes // 16) * 16


def offsets16(sizes):
    """``(offsets, nbytes)`` of byte regions of the given ``sizes`` laid
    end to end, each starting at a multiple of 16 bytes."""
    offs, off = [], 0
    for size in sizes:
        offs.append(off)
        off += _align16(size)
    return tuple(offs), off


class Staged(tuple):
    """Host numpy arrays, views of ONE byte tensor ``data`` at 16-byte
    ``offsets`` (``stage``; pinned when it is bound for a card): a tuple
    of the arrays that carries the buffer they lie in, for ``ship``."""

    def __new__(cls, data: torch.Tensor, arrays, offsets):
        self = super().__new__(cls, arrays)
        self.data, self.offsets = data, tuple(offsets)
        return self


def stage(specs, pin: bool) -> Staged:
    """Empty numpy arrays of the given ``(shape, dtype)`` specs, views of
    one byte tensor at 16-byte offsets (``offsets16``), in pinned memory
    with ``pin`` (a card's uploads: one non-blocking copy; pinning fails
    loudly where no card is)."""
    specs = [(tuple(shape), np.dtype(dt)) for shape, dt in specs]
    sizes = [int(np.prod(shape, dtype=np.int64)) * dt.itemsize
             for shape, dt in specs]
    offs, total = offsets16(sizes)
    data = torch.empty(total, dtype=torch.uint8, pin_memory=pin)
    raw = data.numpy()
    return Staged(data, (raw[off: off + size].view(dt).reshape(shape)
                         for (shape, dt), off, size in zip(specs, offs,
                                                           sizes)), offs)


def pack(arrays, pin: bool) -> Staged:
    """Copies of host ``arrays`` in one staging buffer (``stage``)."""
    staged = stage([(a.shape, a.dtype) for a in arrays], pin)
    for dst, a in zip(staged, arrays):
        dst[...] = a
    return staged


def upload(data: torch.Tensor, dev) -> torch.Tensor:
    """The one copy of a staging buffer to ``dev`` (non-blocking from
    pinned memory; the caching host allocator keeps the block until the
    copy is done)."""
    return data.to(dev, non_blocking=True)


def ship(staged: Staged, dev, count: int | None = None) -> tuple:
    """The first ``count`` arrays of ``staged`` (all by default) on
    ``dev`` in ONE copy of the bytes they span: the arrays after them stay
    on the host. Returns the device tensors, views of that copy, in
    order."""
    count = len(staged) if count is None else count
    end = staged.offsets[count - 1] + staged[count - 1].nbytes if count else 0
    data = upload(staged.data[:end], torch.device(dev))
    return tuple(
        data[off: off + a.nbytes].view(torch.from_numpy(a[:0]).dtype)
        .view(a.shape) for a, off in zip(staged[:count], staged.offsets))


# ---------------------------------------------------------------- K9a

#: a chunk's eight arrays, in their packed order: (name, dtype; None = the
#: time dtype, side: 0 vertices / 1 edges)
_FIELDS = (("v_idx", torch.int32, 0), ("vd_lat", None, 0),
           ("vd_alive", torch.bool, 0), ("vd_first", None, 0),
           ("e_idx", torch.int32, 1), ("ed_lat", None, 1),
           ("ed_alive", torch.bool, 1), ("ed_first", None, 1))


@functools.lru_cache(maxsize=64)
def chunk_offsets(cap_v: int, cap_e: int, tdtype: torch.dtype):
    """``(offsets, nbytes)`` of a packed chunk: each of the eight arrays
    (``_FIELDS``, ``cap_v`` or ``cap_e`` rows) starts at a multiple of 16
    bytes, in order — ``chunk_offset`` in ``csrc/sweep.cu`` is the same
    rule."""
    return offsets16((cap_e if side else cap_v) * (dt or tdtype).itemsize
                     for _, dt, side in _FIELDS)


@functools.lru_cache(maxsize=64)
def _columns(cap_v: int, cap_e: int, tdtype: torch.dtype):
    """Each packed array's (name, byte slice, dtype, pad value)."""
    offs, _ = chunk_offsets(cap_v, cap_e, tdtype)
    out = []
    for (name, dt, side), off in zip(_FIELDS, offs):
        dt = dt or tdtype
        n = (cap_e if side else cap_v) * dt.itemsize
        out.append((name, slice(off, off + n), dt,
                    2**31 - 1 if name.endswith("idx") else 0))
    return tuple(out)


class PackedChunk(NamedTuple):
    """One delta chunk as a single byte buffer (``pack_chunk``), on the
    host (pinned for a card) or, after its upload, on the card."""
    data: torch.Tensor          # uint8 [chunk_offsets(...)[1]]
    cap_v: int
    cap_e: int
    tdtype: torch.dtype         # int32 or int64

    @property
    def payload_bytes(self) -> int:
        """The eight arrays' own bytes, alignment padding excluded (what
        eight separate uploads would ship)."""
        return (self.cap_v + self.cap_e) * (4 + 1 + 2 * self.tdtype.itemsize)

    def arrays(self) -> tuple:
        """The eight arrays as views of ``data``, in ``_FIELDS`` order."""
        return tuple(self.data[span].view(dt) for _, span, dt, _ in
                     _columns(self.cap_v, self.cap_e, self.tdtype))


def pack_chunk(arrays, cap_v: int, cap_e: int, tdtype: torch.dtype,
               pin: bool = False) -> PackedChunk:
    """The eight chunk arrays (numpy, ``_FIELDS`` order, each at most its
    capacity long) padded to ``cap_v`` / ``cap_e`` rows in one host byte
    buffer at ``chunk_offsets``: index pads 2^31-1 (K9a skips them), the
    other pads 0. ``pin``: allocate it in pinned memory, so its upload is
    one non-blocking copy. Values are cast as numpy assignment casts
    them."""
    if tdtype not in _TIME_DTYPES:
        raise TypeError(f"pack_chunk: time dtype {tdtype}, want int32 or "
                        "int64")
    cols = _columns(cap_v, cap_e, tdtype)
    staged = stage([(((span.stop - span.start) // dt.itemsize,), _NUMPY[dt])
                    for _, span, dt, _ in cols], pin)
    for (name, _, _, pad), col, a in zip(cols, staged, arrays):
        if len(a) > len(col):
            raise ValueError(f"pack_chunk: {name} has {len(a)} rows, more "
                             f"than its capacity {len(col)}")
        col[: len(a)] = a
        col[len(a):] = pad
    return PackedChunk(staged.data, cap_v, cap_e, tdtype)


def apply_delta_chunk_plain(bufs, chunk) -> None:
    """Twin of ``rtpu_apply_delta_chunk``: ``bufs`` = (v_lat, v_alive,
    v_first, e_lat, e_alive, e_first), ``chunk`` = (v_idx, v_lat, v_alive,
    v_first, e_idx, e_lat, e_alive, e_first); indices outside the buffer
    are pads and are skipped."""
    for idx, dst, src in ((chunk[0], bufs[:3], chunk[1:4]),
                          (chunk[4], bufs[3:], chunk[5:8])):
        p = idx.long()
        keep = (p >= 0) & (p < dst[0].shape[0])
        p = p[keep]
        if torch.unique(p).numel() != p.numel():
            raise ValueError("apply_delta_chunk: a chunk sets a position "
                             "twice — the host fold emits each touched "
                             "entity once")
        for b, v in zip(dst, src):
            b[p] = v[keep]


def _check_bufs(name: str, bufs):
    """The six resident buffers' checks (dtypes, shapes, contiguity, one
    device); the card branch runs them once per signature. Returns True
    for the card, None for the twin."""
    n_pad, m_pad = bufs[0].shape[0], bufs[3].shape[0]
    tdt = bufs[0].dtype
    if tdt not in _TIME_DTYPES:
        raise TypeError(f"{name}: time dtype {tdt}, want int32 or int64")
    for t, what, dt, ln in ((bufs[0], "v_lat", tdt, n_pad),
                            (bufs[1], "v_alive", torch.bool, n_pad),
                            (bufs[2], "v_first", tdt, n_pad),
                            (bufs[3], "e_lat", tdt, m_pad),
                            (bufs[4], "e_alive", torch.bool, m_pad),
                            (bufs[5], "e_first", tdt, m_pad)):
        _expect(name, t, what, (dt,), (ln,))
    return True if _on_cuda(name, *bufs) else None


def apply_delta_chunk(bufs, chunk: PackedChunk) -> None:
    """K9a wrapper: updates the six resident buffers ``bufs`` in place from
    the packed delta ``chunk`` (``pack_chunk``; times in the buffers'
    dtype). The buffers are checked once per signature
    (``columns._k2_checked``); each call checks the packed chunk's size,
    dtype, device and alignment and its capacities."""
    name = "apply_delta_chunk"
    bufs = tuple(bufs)
    card = _k2_checked(name, bufs, None, lambda: _check_bufs(name, bufs))
    tdt = bufs[0].dtype
    if chunk.tdtype != tdt:
        raise TypeError(f"{name}: the chunk's times (vd_lat, vd_first, "
                        f"ed_lat, ed_first) are {chunk.tdtype}, the "
                        f"buffers' {tdt}")
    if min(chunk.cap_v, chunk.cap_e) < 0:
        raise ValueError(f"{name}: capacities {chunk.cap_v}, {chunk.cap_e}")
    _expect(name, chunk.data, "packed chunk", (torch.uint8,),
            (chunk_offsets(chunk.cap_v, chunk.cap_e, tdt)[1],))
    if not card:
        _on_cuda(name, bufs[0], chunk.data)     # raises unless both on CPU
        return apply_delta_chunk_plain(bufs, chunk.arrays())
    if chunk.data.device != bufs[0].device:
        raise ValueError(f"{name}: the chunk lies on {chunk.data.device}, "
                         f"the buffers on {bufs[0].device}")
    if chunk.data.data_ptr() % 16:
        raise ValueError(f"{name}: the packed chunk is not 16-byte aligned")
    err = _fn("sweep", "rtpu_apply_delta_chunk")(
        bufs[0].shape[0], bufs[3].shape[0], chunk.cap_v, chunk.cap_e,
        tdt.itemsize, *(t.data_ptr() for t in bufs), chunk.data.data_ptr(),
        _stream(bufs[0]))
    _launch(name, err)


# ---------------------------------------------------------------- K9b

#: windows one K9b launch carries (``kWinGroup`` in ``csrc/sweep.cu``)
WINDOW_GROUP = 32


def _bounds(T: int, windows, tdtype: torch.dtype):
    """``(lo, nowin)`` per window as Python integers: ``lo = clamp(T - w)``
    into ``tdtype``'s range (exact) and ``nowin = w < 0``."""
    lo, hi = _LIMITS[tdtype]
    T = int(T)
    return ([min(max(T - int(w), lo), hi) for w in windows],
            [int(w) < 0 for w in windows])


def window_bounds(T: int, windows, tdtype: torch.dtype, device):
    """``(lo, nowin)`` per window as tensors on ``device`` (the twin's
    inputs): ``lo = clamp(T - w)`` into ``tdtype``'s range (exact, in
    Python integers) and ``nowin = w < 0``."""
    lo, nowin = _bounds(T, windows, tdtype)
    return (torch.tensor(lo, dtype=tdtype, device=device),
            torch.tensor(nowin, dtype=torch.bool, device=device))


def window_masks_plain(v_lat, v_alive, e_lat, e_alive, lo, nowin):
    """Twin of ``rtpu_window_masks``: ``(bool[k, n], bool[k, m])``."""
    nw = nowin[:, None]
    lo = lo[:, None]
    return (v_alive[None, :] & (nw | (v_lat[None, :] >= lo)),
            e_alive[None, :] & (nw | (e_lat[None, :] >= lo)))


def _check_state(name: str, v_lat, v_alive, e_lat, e_alive):
    """K9b's checks of the resident state; once per signature on the
    card. Returns True for the card, None for the twin."""
    tdt = v_lat.dtype
    if tdt not in _TIME_DTYPES:
        raise TypeError(f"{name}: time dtype {tdt}, want int32 or int64")
    n, m = v_lat.shape[0], e_lat.shape[0]
    _expect(name, v_lat, "v_lat", (tdt,), (n,))
    _expect(name, v_alive, "v_alive", (torch.bool,), (n,))
    _expect(name, e_lat, "e_lat", (tdt,), (m,))
    _expect(name, e_alive, "e_alive", (torch.bool,), (m,))
    return True if _on_cuda(name, v_lat, v_alive, e_lat, e_alive) else None


def window_masks(v_lat, v_alive, e_lat, e_alive, T: int, windows):
    """K9b wrapper: the k windows' vertex and edge masks at time ``T`` from
    the resident fold state (``windows``: ints, negative = no window). On
    the card: the state checked once per signature, the bounds passed by
    value (one launch a group of ``WINDOW_GROUP`` windows), both masks
    views of one allocation."""
    name = "window_masks"
    state = (v_lat, v_alive, e_lat, e_alive)
    card = _k2_checked(name, state, None,
                       lambda: _check_state(name, *state))
    tdt = v_lat.dtype
    if not card:
        return window_masks_plain(*state,
                                  *window_bounds(T, windows, tdt, "cpu"))
    n, m, k = v_lat.shape[0], e_lat.shape[0], len(windows)
    lo, nowin = _bounds(T, windows, tdt)
    bounds = (ctypes.c_int64 * (2 * k))(*lo, *nowin)
    e0 = _align16(k * n)
    buf = torch.empty(e0 + k * m, dtype=torch.bool, device=v_lat.device)
    v_out = buf.as_strided((k, n), (n, 1))
    e_out = buf.as_strided((k, m), (m, 1), e0)
    launched = ctypes.c_int64(0)
    err = _fn("sweep", "rtpu_window_masks")(
        k, n, m, tdt.itemsize, v_lat.data_ptr(), v_alive.data_ptr(),
        e_lat.data_ptr(), e_alive.data_ptr(), bounds, v_out.data_ptr(),
        e_out.data_ptr(), _stream(v_lat), ctypes.byref(launched))
    _launch(name, err, launched.value)
    return v_out, e_out


# ---------------------------------------------------------------- K8u

@functools.lru_cache(maxsize=64)
def view_mask_layout(k: int, n: int, m: int):
    """``(e_in, packed_bytes, e_out, out_bytes)`` of a View's K8u buffers:
    the packed bits (the k*n vertex bits flat from byte 0, the k*m edge
    bits from ``e_in``, each region at a multiple of 16 bytes) and the bool
    output (vertex masks from byte 0, edge masks from ``e_out``) —
    ``view_offsets`` in ``csrc/sweep.cu`` is the same rule."""
    (_, e_in), packed_bytes = offsets16((-(-k * n // 8), -(-k * m // 8)))
    e_out = _align16(k * n)
    return e_in, packed_bytes, e_out, e_out + k * m


def pack_view_masks(v_masks: np.ndarray, e_masks: np.ndarray,
                    pin: bool = False) -> torch.Tensor:
    """A View's bool masks ``[k, n]`` and ``[k, m]`` as K8u's one packed
    byte buffer (``view_mask_layout``), each region's bits flat in little
    bit order; in pinned memory with ``pin``."""
    staged = stage([((-(-a.size // 8),), np.uint8)
                    for a in (v_masks, e_masks)], pin)
    for bits, a in zip(staged, (v_masks, e_masks)):
        bits[:] = np.packbits(a.reshape(-1), bitorder="little")
    return staged.data


def _view_masks_out(k: int, n: int, m: int, device):
    """One bool allocation and its two mask views, the edge rows at
    ``view_mask_layout``'s ``e_out``."""
    _, _, e_out, total = view_mask_layout(k, n, m)
    buf = torch.empty(total, dtype=torch.bool, device=device)
    return buf, buf.as_strided((k, n), (n, 1)), buf.as_strided(
        (k, m), (m, 1), e_out)


def _unpack_flat(bits: torch.Tensor, count: int) -> torch.Tensor:
    shifts = torch.arange(8, dtype=torch.uint8, device=bits.device)
    return ((bits[:, None] >> shifts) & 1).reshape(-1)[:count].to(torch.bool)


def unpack_view_masks_plain(packed, k: int, n: int, m: int):
    """Twin of ``rtpu_unpack_view_masks``: ``(bool[k, n], bool[k, m])``
    from the packed buffer, views of one allocation as the kernel's."""
    e_in, _, _, _ = view_mask_layout(k, n, m)
    _, v, e = _view_masks_out(k, n, m, packed.device)
    v.view(-1).copy_(_unpack_flat(packed[: -(-k * n // 8)], k * n))
    e.view(-1).copy_(_unpack_flat(packed[e_in: e_in + -(-k * m // 8)],
                                  k * m))
    return v, e


def unpack_view_masks(packed, k: int, n: int, m: int):
    """K8u wrapper (``raphtory_tpu/engine/bsp.py:39`` ``_unpack_bits``): a
    View's ``k`` windows' vertex masks ``[k, n]`` and edge masks ``[k, m]``
    from ``pack_view_masks``' buffer, both contiguous bool views of one
    allocation (the edge view 16-byte aligned). On the card one launch,
    counted under ``unpack_mask_bits``."""
    name = "unpack_mask_bits"
    k, n, m = int(k), int(n), int(m)
    if min(k, n, m) < 0:
        raise ValueError(f"{name}: k={k}, n={n}, m={m}")
    _expect(name, packed, "packed", (torch.uint8,),
            (view_mask_layout(k, n, m)[1],))
    if not _on_cuda(name, packed):
        return unpack_view_masks_plain(packed, k, n, m)
    if packed.data_ptr() % 16:
        raise ValueError(f"{name}: the packed bits are not 16-byte aligned")
    buf, v, e = _view_masks_out(k, n, m, packed.device)
    # the allocation's own address: an empty view's data_ptr() is 0
    err = _fn("sweep", "rtpu_unpack_view_masks")(
        k * n, k * m, packed.data_ptr(), buf.data_ptr(), _stream(packed))
    _launch(name, err)
    return v, e
