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
* **K8u** ``unpack_mask_bits`` (``raphtory_tpu/engine/bsp.py:39``
  ``_unpack_bits``): little-bit-order ``u8[k, n/8]`` to ``bool[k, n]``.

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


# ---------------------------------------------------------------- K9a

#: a chunk's eight arrays, in their packed order: (name, dtype; None = the
#: time dtype, side: 0 vertices / 1 edges)
_FIELDS = (("v_idx", torch.int32, 0), ("vd_lat", None, 0),
           ("vd_alive", torch.bool, 0), ("vd_first", None, 0),
           ("e_idx", torch.int32, 1), ("ed_lat", None, 1),
           ("ed_alive", torch.bool, 1), ("ed_first", None, 1))


def _align16(nbytes: int) -> int:
    return -(-nbytes // 16) * 16


@functools.lru_cache(maxsize=64)
def chunk_offsets(cap_v: int, cap_e: int, tdtype: torch.dtype):
    """``(offsets, nbytes)`` of a packed chunk: each of the eight arrays
    (``_FIELDS``, ``cap_v`` or ``cap_e`` rows) starts at a multiple of 16
    bytes, in order — ``chunk_offset`` in ``csrc/sweep.cu`` is the same
    rule."""
    offs, off = [], 0
    for _, dt, side in _FIELDS:
        offs.append(off)
        off += _align16((cap_e if side else cap_v)
                        * (dt or tdtype).itemsize)
    return tuple(offs), off


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
    data = torch.empty(chunk_offsets(cap_v, cap_e, tdtype)[1],
                       dtype=torch.uint8, pin_memory=pin)
    buf = data.numpy()
    for (name, span, dt, pad), a in zip(_columns(cap_v, cap_e, tdtype),
                                        arrays):
        col = buf[span].view(_NUMPY[dt])
        if len(a) > len(col):
            raise ValueError(f"pack_chunk: {name} has {len(a)} rows, more "
                             f"than its capacity {len(col)}")
        col[: len(a)] = a
        col[len(a):] = pad
    return PackedChunk(data, cap_v, cap_e, tdtype)


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

def unpack_mask_bits_plain(packed):
    """Twin of ``rtpu_unpack_mask_bits``: ``u8[k, b]`` → ``bool[k, 8b]``,
    bit j of byte i is column ``8i + j``."""
    shifts = torch.arange(8, dtype=torch.uint8, device=packed.device)
    bits = (packed[:, :, None] >> shifts) & 1
    return bits.reshape(packed.shape[0], -1).to(torch.bool)


def unpack_mask_bits(packed):
    """K8u wrapper (``raphtory_tpu/engine/bsp.py:39`` ``_unpack_bits``)."""
    name = "unpack_mask_bits"
    if packed.dim() != 2:
        raise ValueError(f"{name}: packed has shape {tuple(packed.shape)}, "
                         "want [k, bytes]")
    rows, nbytes = packed.shape
    _expect(name, packed, "packed", (torch.uint8,), (rows, nbytes))
    if not _on_cuda(name, packed):
        return unpack_mask_bits_plain(packed)
    out = torch.empty((rows, nbytes * 8), dtype=torch.bool,
                      device=packed.device)
    err = _fn("sweep", "rtpu_unpack_mask_bits")(
        rows, nbytes, packed.data_ptr(), out.data_ptr(), _stream(packed))
    _launch(name, err)
    return out
