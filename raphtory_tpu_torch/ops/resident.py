"""K9a, K9b and K8u — the kernels of the resident sweep's device half and
of the cold route's bit-packed masks.

* **K9a** ``apply_delta_chunk`` (``raphtory_tpu/engine/device_sweep.py:239``
  ``_compiled_apply``): scatter-set one padded delta chunk into the six
  resident fold-state buffers, IN PLACE (the reference donates the buffers
  and gets new ones back; here they are updated where they lie). Pad rows
  carry the index 2^31-1 and are skipped.
* **K9b** ``window_masks`` (the mask half of ``device_sweep.py:261``
  ``_compiled_run``, ``:273-277``): per-window vertex and edge masks
  ``alive & (w < 0 | lat >= clamp(T - w))`` from the resident state, in the
  narrow time dtype.
* **K8u** ``unpack_mask_bits`` (``raphtory_tpu/engine/bsp.py:39``
  ``_unpack_bits``): little-bit-order ``u8[k, n/8]`` to ``bool[k, n]``.

Same three parts as ``ops/columns.py``, whose build and launch plumbing
they share: wrappers that route by device (CPU tensors take the twin, CUDA
tensors launch the kernel from ``csrc/sweep.cu`` or raise), plain twins
(``*_plain``), and the CUDA source.
"""

from __future__ import annotations

import torch

from .columns import _expect, _fn, _launch, _on_cuda, _stream

_TIME_DTYPES = (torch.int32, torch.int64)


# ---------------------------------------------------------------- K9a

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


def apply_delta_chunk(bufs, chunk) -> None:
    """K9a wrapper: updates the six resident buffers ``bufs`` in place from
    the padded delta ``chunk`` (int32 indices, times in the buffers'
    dtype, bool alive flags)."""
    name = "apply_delta_chunk"
    n_pad, m_pad = bufs[0].shape[0], bufs[3].shape[0]
    cap_v, cap_e = chunk[0].shape[0], chunk[4].shape[0]
    tdt = bufs[0].dtype
    if tdt not in _TIME_DTYPES:
        raise TypeError(f"{name}: time dtype {tdt}, want int32 or int64")
    for t, what, dts, shape in (
            (bufs[0], "v_lat", (tdt,), (n_pad,)),
            (bufs[1], "v_alive", (torch.bool,), (n_pad,)),
            (bufs[2], "v_first", (tdt,), (n_pad,)),
            (bufs[3], "e_lat", (tdt,), (m_pad,)),
            (bufs[4], "e_alive", (torch.bool,), (m_pad,)),
            (bufs[5], "e_first", (tdt,), (m_pad,)),
            (chunk[0], "v_idx", (torch.int32,), (cap_v,)),
            (chunk[1], "vd_lat", (tdt,), (cap_v,)),
            (chunk[2], "vd_alive", (torch.bool,), (cap_v,)),
            (chunk[3], "vd_first", (tdt,), (cap_v,)),
            (chunk[4], "e_idx", (torch.int32,), (cap_e,)),
            (chunk[5], "ed_lat", (tdt,), (cap_e,)),
            (chunk[6], "ed_alive", (torch.bool,), (cap_e,)),
            (chunk[7], "ed_first", (tdt,), (cap_e,))):
        _expect(name, t, what, dts, shape)
    if not _on_cuda(name, *bufs, *chunk):
        return apply_delta_chunk_plain(bufs, chunk)
    err = _fn("sweep", "rtpu_apply_delta_chunk")(
        n_pad, m_pad, cap_v, cap_e, tdt.itemsize,
        *(t.data_ptr() for t in bufs), *(t.data_ptr() for t in chunk),
        _stream(bufs[0]))
    _launch(name, err)


# ---------------------------------------------------------------- K9b

def window_bounds(T: int, windows, tdtype: torch.dtype, device):
    """``(lo, nowin)`` per window: ``lo = clamp(T - w)`` into ``tdtype``'s
    range (exact, in Python integers) and ``nowin = w < 0``."""
    info = torch.iinfo(tdtype)
    lo = [min(max(int(T) - int(w), info.min), info.max) for w in windows]
    return (torch.tensor(lo, dtype=tdtype, device=device),
            torch.tensor([int(w) < 0 for w in windows], dtype=torch.bool,
                         device=device))


def window_masks_plain(v_lat, v_alive, e_lat, e_alive, lo, nowin):
    """Twin of ``rtpu_window_masks``: ``(bool[k, n], bool[k, m])``."""
    nw = nowin[:, None]
    lo = lo[:, None]
    return (v_alive[None, :] & (nw | (v_lat[None, :] >= lo)),
            e_alive[None, :] & (nw | (e_lat[None, :] >= lo)))


def window_masks(v_lat, v_alive, e_lat, e_alive, T: int, windows):
    """K9b wrapper: the k windows' vertex and edge masks at time ``T`` from
    the resident fold state (``windows``: ints, negative = no window)."""
    name = "window_masks"
    n, m, k = v_lat.shape[0], e_lat.shape[0], len(windows)
    tdt = v_lat.dtype
    if tdt not in _TIME_DTYPES:
        raise TypeError(f"{name}: time dtype {tdt}, want int32 or int64")
    _expect(name, v_lat, "v_lat", (tdt,), (n,))
    _expect(name, v_alive, "v_alive", (torch.bool,), (n,))
    _expect(name, e_lat, "e_lat", (tdt,), (m,))
    _expect(name, e_alive, "e_alive", (torch.bool,), (m,))
    lo, nowin = window_bounds(T, windows, tdt, v_lat.device)
    if not _on_cuda(name, v_lat, v_alive, e_lat, e_alive):
        return window_masks_plain(v_lat, v_alive, e_lat, e_alive, lo, nowin)
    v_out = torch.empty((k, n), dtype=torch.bool, device=v_lat.device)
    e_out = torch.empty((k, m), dtype=torch.bool, device=v_lat.device)
    err = _fn("sweep", "rtpu_window_masks")(
        k, n, m, tdt.itemsize, v_lat.data_ptr(), v_alive.data_ptr(),
        e_lat.data_ptr(), e_alive.data_ptr(), lo.data_ptr(), nowin.data_ptr(),
        v_out.data_ptr(), e_out.data_ptr(), _stream(v_lat))
    _launch(name, err)
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
