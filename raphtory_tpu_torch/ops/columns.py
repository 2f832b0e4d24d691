"""Kernels of the hop-batched columnar engine: K1 (with K6w, the weighted
SSSP weight-state rebuild beside it), K3 (the host-column route's window
masks), K4 (the bulk scale path's per-hop masks, engine-order or binned),
KB1 (K3's masks emitted straight into the destination-binned layout) and
K2 (the edge
passes and the superstep update of the PageRank power iteration, with
K2b-P the binned pull-sum); the build and launch plumbing that
``ops/minplus.py`` (K5/K6 and their binned K5-P/K6-P), ``ops/segment.py``
(K7, K7-P, K7-mode), ``ops/resident.py`` (K9a, K9b, K8u) and
``ops/features.py`` (K10, K10-P) and ``ops/exchange.py`` (the mesh
path's ``halo_pack``, ``frontier_compact``, ``frontier_merge_min``) share.

Each kernel has three parts here:

* a **wrapper** (``masks_from_deltas``, ``column_masks``,
  ``scale_hop_masks``, ``bin_column_masks``, ``column_out_degree``,
  ``column_pull_sum``, ``binned_pull_sum``, ``pagerank_update``) that
  checks device, dtype, shape
  and contiguity, allocates the outputs, and routes by the tensors' device:
  CPU tensors take the plain twin, CUDA tensors launch the hand-written
  kernel (or raise — there is no fallback). Each kernel launch adds one to
  ``LAUNCHES[name]``; nothing else does (an entry point that launches
  several passes, as K4's does, or none, as K1's and K6w's for an empty
  table, reports how many it launched).
* a **plain twin** (``*_plain``): PyTorch code with the same math. The CPU
  tests hold it against the JAX package, and the chip smoke run holds each
  kernel against it on the card.
* the **CUDA source** in ``raphtory_tpu_torch/csrc/``, compiled with
  ``nvcc`` for ``sm_90a`` on first use into a shared library with a plain C
  interface (keyed by a hash of the source, under ``csrc/_build/``) and
  bound with ``ctypes``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
import time as _time
import weakref
from dataclasses import dataclass
from pathlib import Path

import numpy as np
import torch
from torch.utils.weak import WeakIdKeyDictionary

_CSRC = Path(__file__).resolve().parent.parent / "csrc"
_BUILD = _CSRC / "_build"

#: kernel library → (CUDA source, its C entry points)
_LIBS = {
    "masks": ("masks.cu", ("rtpu_masks_from_deltas_i32",
                           "rtpu_masks_from_deltas_i64",
                           "rtpu_weights_from_deltas",
                           "rtpu_column_masks_i32", "rtpu_column_masks_i64",
                           "rtpu_scale_hop_masks",
                           "rtpu_bin_column_masks_i32",
                           "rtpu_bin_column_masks_i64")),
    "pagerank_columns": ("pagerank_columns.cu", ("rtpu_column_out_degree",
                                                 "rtpu_column_pull_sum",
                                                 "rtpu_pagerank_update",
                                                 "rtpu_binned_pull_sum")),
    "minplus_columns": ("minplus_columns.cu", (
        "rtpu_cc_superstep", "rtpu_minplus_superstep")),
    "segment": ("segment.cu", ("rtpu_segment_combine",
                               "rtpu_partition_reduce",
                               "rtpu_segment_mode")),
    "features": ("features.cu", ("rtpu_feature_propagate",
                                 "rtpu_feature_propagate_binned")),
    "sweep": ("sweep.cu", ("rtpu_apply_delta_chunk", "rtpu_window_masks",
                           "rtpu_unpack_view_masks")),
    "exchange": ("exchange.cu", ("rtpu_halo_pack", "rtpu_frontier_compact",
                                 "rtpu_frontier_pad",
                                 "rtpu_frontier_merge_min")),
}
_ARGTYPES = {
    # len, H, W, U, h0, tw | base_l, base_a, d_pos, d_lat, d_alive, lo,
    # nowin, adv_l, adv_a, touch, out, stream | launched
    "rtpu_masks_from_deltas_i32": 6 * [ctypes.c_int64]
    + 12 * [ctypes.c_void_p] + [ctypes.POINTER(ctypes.c_int64)],
    "rtpu_masks_from_deltas_i64": 6 * [ctypes.c_int64]
    + 12 * [ctypes.c_void_p] + [ctypes.POINTER(ctypes.c_int64)],
    # len, H, U, h0, tw | base, d_pos, d_val, adv, touch, out, stream |
    # launched
    "rtpu_weights_from_deltas": 5 * [ctypes.c_int64]
    + 7 * [ctypes.c_void_p] + [ctypes.POINTER(ctypes.c_int64)],
    # m, n, H, C | e_lat, e_alive, v_lat, v_alive | bounds (host, 3C
    # int64) | me, mv, stream | launched
    "rtpu_column_masks_i32": 4 * [ctypes.c_int64] + 4 * [ctypes.c_void_p]
    + [ctypes.POINTER(ctypes.c_int64)] + 3 * [ctypes.c_void_p]
    + [ctypes.POINTER(ctypes.c_int64)],
    "rtpu_column_masks_i64": 4 * [ctypes.c_int64] + 4 * [ctypes.c_void_p]
    + [ctypes.POINTER(ctypes.c_int64)] + 3 * [ctypes.c_void_p]
    + [ctypes.POINTER(ctypes.c_int64)],
    # rows, len, H, W, U | base, d_pos, d_t, thr, perm, valid, inv, out,
    # stream | launched
    "rtpu_scale_hop_masks": 5 * [ctypes.c_int64] + 9 * [ctypes.c_void_p]
    + [ctypes.POINTER(ctypes.c_int64)],
    # n, C | out_indptr, out_order, me, deg, stream
    "rtpu_column_out_degree": 2 * [ctypes.c_int64] + 5 * [ctypes.c_void_p],
    # n, C | indptr, src, me, rd, agg, stream
    "rtpu_column_pull_sum": 2 * [ctypes.c_int64] + 6 * [ctypes.c_void_p],
    # n, C, gx, prime | 1-damping, damping, tol | agg, deg, mv, n_act, r, rd,
    # dangling, halted, done, part (f64), busy, ticket, stream
    "rtpu_pagerank_update": 4 * [ctypes.c_int64] + 3 * [ctypes.c_float]
    + 13 * [ctypes.c_void_p],
    # n, C, gx | in_indptr, in_order, in_rows, out_indptr, out_order,
    # out_rows, me, mv, cur, nxt, halted, done, busy, ticket, stream
    "rtpu_cc_superstep": 3 * [ctypes.c_int64] + 15 * [ctypes.c_void_p],
    # n, C, W, H, gx, directed | ew, then as rtpu_cc_superstep
    "rtpu_minplus_superstep": 6 * [ctypes.c_int64] + 16 * [ctypes.c_void_p],
    # k, n, m, F, op, dtype, nl | indptr, perm, long_rows, x, mask, out,
    # stream | launched
    "rtpu_segment_combine": 7 * [ctypes.c_int64] + 7 * [ctypes.c_void_p]
    + [ctypes.POINTER(ctypes.c_int64)],
    # n_pad, m_pad, cap_v, cap_e, tbytes | six buffers, the packed chunk,
    # stream
    "rtpu_apply_delta_chunk": 5 * [ctypes.c_int64] + 8 * [ctypes.c_void_p],
    # k, n, m, tbytes | v_lat, v_alive, e_lat, e_alive | bounds (host, 2k
    # int64) | v_out, e_out, stream | launched
    "rtpu_window_masks": 4 * [ctypes.c_int64] + 4 * [ctypes.c_void_p]
    + [ctypes.POINTER(ctypes.c_int64)] + 3 * [ctypes.c_void_p]
    + [ctypes.POINTER(ctypes.c_int64)],
    # vbits, ebits | packed, out, stream
    "rtpu_unpack_view_masks": 2 * [ctypes.c_int64] + 3 * [ctypes.c_void_p],
    # B, m, n, H, C | e_lat, e_alive, v_lat, v_alive | bounds (host, 3C
    # int64) | perm, valid, me, mv, stream | launched
    "rtpu_bin_column_masks_i32": 5 * [ctypes.c_int64] + 4 * [ctypes.c_void_p]
    + [ctypes.POINTER(ctypes.c_int64)] + 5 * [ctypes.c_void_p]
    + [ctypes.POINTER(ctypes.c_int64)],
    "rtpu_bin_column_masks_i64": 5 * [ctypes.c_int64] + 4 * [ctypes.c_void_p]
    + [ctypes.POINTER(ctypes.c_int64)] + 5 * [ctypes.c_void_p]
    + [ctypes.POINTER(ctypes.c_int64)],
    # n, C | in_indptr, pairs, me, rd, agg, stream
    "rtpu_binned_pull_sum": 2 * [ctypes.c_int64] + 6 * [ctypes.c_void_p],
    # k, n, m, F, op, dtype, nl | indptr, order, perm, valid, long_rows, x,
    # mask, out, stream | launched
    "rtpu_partition_reduce": 7 * [ctypes.c_int64] + 9 * [ctypes.c_void_p]
    + [ctypes.POINTER(ctypes.c_int64)],
    # k, n, m, default, nl | indptr, perm, values, mask, long_rows,
    # scratch, out, stream | launched
    "rtpu_segment_mode": 5 * [ctypes.c_int64] + 8 * [ctypes.c_void_p]
    + [ctypes.POINTER(ctypes.c_int64)],
    # n_pad, F, fdtype, tbytes, lo, nowin | sw, 1-sw | in_indptr, e_src,
    # e_lat, e_alive, H, out, stream
    "rtpu_feature_propagate": 6 * [ctypes.c_int64] + 2 * [ctypes.c_float]
    + 7 * [ctypes.c_void_p],
    # n_pad, F, fdtype, tbytes, lo, nowin | sw, 1-sw | in_indptr, walk,
    # e_lat, e_alive, H, out, stream
    "rtpu_feature_propagate_binned": 6 * [ctypes.c_int64]
    + 2 * [ctypes.c_float] + 7 * [ctypes.c_void_p],
    # plan (int64 [10]), send_idx, src, out, stream
    "rtpu_halo_pack": 5 * [ctypes.c_void_p],
    # plan (int64 [4]), epoch | changed, values, out_idx, out_val, count,
    # scratch, stream
    "rtpu_frontier_compact": [ctypes.c_void_p, ctypes.c_int64]
    + 7 * [ctypes.c_void_p],
    # plan (int64 [5]), count, out_idx, out_val, stream
    "rtpu_frontier_pad": 5 * [ctypes.c_void_p],
    # plan (int64 [9]), counts, idx, val, replica, stream
    "rtpu_frontier_merge_min": 6 * [ctypes.c_void_p],
}

#: kernel launches per wrapper since the last ``reset_launches()``
LAUNCHES = {"masks_from_deltas": 0, "column_masks": 0,
            "scale_hop_masks": 0, "column_out_degree": 0,
            "column_pull_sum": 0, "pagerank_update": 0,
            "cc_superstep": 0, "minplus_superstep": 0,
            "weights_from_deltas": 0, "segment_combine": 0,
            "segment_combine_i64": 0, "partition_segment_reduce_i64": 0,
            "apply_delta_chunk": 0, "window_masks": 0,
            "unpack_mask_bits": 0, "bin_masks": 0, "binned_pull_sum": 0,
            "binned_cc_superstep": 0, "binned_minplus_superstep": 0,
            "partition_segment_reduce": 0, "segment_mode": 0,
            "feature_propagate": 0, "feature_propagate_binned": 0,
            "halo_pack": 0, "frontier_compact": 0, "frontier_merge_min": 0}

#: ``nvcc -Xptxas -v`` report of each library built by this process
BUILD_LOG: dict[str, str] = {}

_loaded: dict[str, ctypes.CDLL] = {}
_lock = threading.Lock()


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _lib_path(name: str) -> Path:
    src = (_CSRC / _LIBS[name][0]).read_bytes()
    return _BUILD / f"lib{name}_{hashlib.sha256(src).hexdigest()[:16]}.so"


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME is None:
        raise RuntimeError("no CUDA toolkit found (set CUDA_HOME): the "
                           "kernels are compiled with nvcc on first use")
    return str(Path(CUDA_HOME) / "bin" / "nvcc")


def build() -> float:
    """Compile every kernel library not built yet — one ``nvcc`` per source,
    all started together — and load them all. Returns the seconds spent."""
    t0 = _time.perf_counter()
    with _lock:
        todo = [n for n in _LIBS if n not in _loaded]
        procs = {}
        for name in todo:
            out = _lib_path(name)
            if out.exists():
                continue
            _BUILD.mkdir(exist_ok=True)
            tmp = out.with_name(f".{out.name}.{os.getpid()}.tmp")
            cmd = [_nvcc(), "-gencode", "arch=compute_90a,code=sm_90a",
                   "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
                   "-Xptxas", "-v", "-o", str(tmp),
                   str(_CSRC / _LIBS[name][0])]
            procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                            stderr=subprocess.STDOUT,
                                            text=True), tmp, out)
        failed = []
        for name, (proc, tmp, out) in procs.items():
            log, _ = proc.communicate(timeout=900)
            BUILD_LOG[name] = log
            if proc.returncode:
                tmp.unlink(missing_ok=True)
                failed.append(f"{name}: nvcc exited {proc.returncode}\n{log}")
            else:
                # publish atomically: a killed or concurrent build never
                # leaves a half-written library under the final name
                os.replace(tmp, out)
        if failed:
            raise RuntimeError("kernel build failed:\n" + "\n".join(failed))
        for name in todo:
            lib = ctypes.CDLL(str(_lib_path(name)))
            for fn in _LIBS[name][1]:
                getattr(lib, fn).argtypes = _ARGTYPES[fn]
                getattr(lib, fn).restype = ctypes.c_int
            _loaded[name] = lib
    return _time.perf_counter() - t0


#: each C entry point's ctypes function, bound once after its build
_bound: dict = {}


def _fn(lib: str, fn: str):
    f = _bound.get(fn)
    if f is None:
        if lib not in _loaded:
            build()
        f = _bound[fn] = getattr(_loaded[lib], fn)
    return f


def _on_cuda(name: str, *tensors: torch.Tensor) -> bool:
    """True → launch the CUDA kernel; False → the plain twin. Only CPU
    tensors take the twin; tensors on several devices, or on any other
    device type, raise."""
    devs = {t.device for t in tensors}
    if len(devs) != 1:
        raise ValueError(f"{name}: tensors on several devices {devs}")
    dev = devs.pop()
    if dev.type == "cpu":
        return False
    if dev.type == "cuda":
        return True
    raise ValueError(f"{name}: unsupported device {dev}")


def _expect(name: str, t: torch.Tensor, what: str, dtypes, shape) -> None:
    if not isinstance(t, torch.Tensor):
        raise TypeError(f"{name}: {what} is {type(t).__name__}, want a "
                        "tensor")
    if t.dtype not in dtypes:
        raise TypeError(f"{name}: {what} has dtype {t.dtype}, want one of "
                        f"{dtypes}")
    if t.shape != tuple(shape):          # torch.Size against a tuple
        raise ValueError(f"{name}: {what} has shape {tuple(t.shape)}, want "
                         f"{tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: {what} is not contiguous")


def _launch(name: str, err: int, launched: int = 1) -> None:
    """Raise on a failed launch, else count ``launched`` kernel launches."""
    if err:
        raise RuntimeError(f"{name}: CUDA kernel launch failed "
                           f"(cudaError {err})")
    LAUNCHES[name] += launched


#: the raw handle of a card's current stream, read without building a
#: ``torch.cuda.Stream`` (absent from CPU-only builds, where no tensor
#: reaches a kernel); every entry point's pointers, this one included,
#: are declared ``c_void_p``, so ctypes takes the ints as they are
_raw_stream = getattr(torch._C, "_cuda_getCurrentRawStream", None)


def _stream(t: torch.Tensor) -> int:
    return _raw_stream(t.get_device())


_TIME_DTYPES = (torch.int32, torch.int64)


def _skip_pads(name: str, h: int, pos: torch.Tensor, n: int):
    """(positions inside ``[0, n)``, their keep mask) of one hop's delta
    row; raises on a position set twice."""
    p = pos.long()
    keep = (p >= 0) & (p < n)
    p = p[keep]
    if torch.unique(p).numel() != p.numel():
        raise ValueError(f"{name}: hop {h} delta sets a position twice — "
                         "the host fold emits each touched entity once per "
                         "hop")
    return p, keep


# ---------------------------------------------------------------- K1

def masks_from_deltas_plain(base_lat, base_alive, d_pos, d_lat, d_alive,
                            lo, nowin, H: int, W: int, h0: bool = False):
    """Twin of ``csrc/masks.cu``: per hop, scatter-set the hop's deltas
    into a copy of the base state (hop 0 only when ``h0``; pad rows with a
    position outside ``[0, len)`` are dropped), then write the hop's W
    window columns ``alive & (nowin | lat >= lo)``. Returns ``(mask [len,
    H*W], advanced lat, advanced alive)``."""
    cur_l, cur_a = base_lat.clone(), base_alive.clone()
    n = cur_l.shape[0]
    out = torch.empty((n, H * W), dtype=torch.bool, device=cur_l.device)
    for h in range(H):
        if h or h0:
            p, keep = _skip_pads("masks_from_deltas", h, d_pos[h], n)
            cur_l[p] = d_lat[h][keep]
            cur_a[p] = d_alive[h][keep]
        sl = slice(h * W, (h + 1) * W)
        out[:, sl] = cur_a[:, None] & (nowin[sl][None, :]
                                       | (cur_l[:, None] >= lo[sl][None, :]))
    return out, cur_l, cur_a


#: (card, stream handle) → K1's hop-touch scratch, grown to the largest
#: call's ``len`` words; a stream's calls run in order, so one buffer serves
#: them all
_TOUCH: dict = {}


def _touch_words(H: int) -> int:
    """Bytes of K1's hop-touch word for an ``H``-hop call: 1, 4 or 8 (groups
    of 8, 32 or 64 hops)."""
    return 1 if H <= 8 else 4 if H <= 32 else 8


def _touch_scratch(dev: torch.device, stream: int, nbytes: int):
    """At least ``nbytes`` bytes of K1 touch scratch for ``stream``."""
    key = (dev, stream)
    buf = _TOUCH.get(key)
    if buf is None or buf.numel() < nbytes:
        if len(_TOUCH) >= _SIG_CAP:
            _TOUCH.clear()
        buf = _TOUCH[key] = torch.empty(max(nbytes, 8), dtype=torch.uint8,
                                        device=dev)
    return buf


def masks_from_deltas(base_lat, base_alive, d_pos, d_lat, d_alive, lo, nowin,
                      H: int, W: int, h0: bool = False):
    """K1 wrapper (replaces ``raphtory_tpu/engine/hopbatch.py:66``): the
    per-hop fold-state rebuild and window masks of one dispatch. ``lo`` is
    ``clip(T_col - w_col)`` already in the time dtype and ``nowin`` is
    ``w_col < 0``, both ``[H*W]``. Returns ``(mask [len, H*W] bool, advanced
    lat, advanced alive)``. The kernel never rebuilds the hop state (three
    passes a group of up to 64 hops in one cooperative launch,
    ``csrc/masks.cu``): the call allocates the outputs, the advanced state
    included, and takes the hop-touch scratch from ``_touch_scratch``; the
    base is read, never copied."""
    name = "masks_from_deltas"
    n = base_lat.shape[0]
    tdt = base_lat.dtype
    U = d_pos.shape[1] if d_pos.dim() == 2 else -1
    _expect(name, base_lat, "base_lat", _TIME_DTYPES, (n,))
    _expect(name, base_alive, "base_alive", (torch.bool,), (n,))
    _expect(name, d_pos, "d_pos", (torch.int32,), (H, U))
    _expect(name, d_lat, "d_lat", (tdt,), (H, U))
    _expect(name, d_alive, "d_alive", (torch.bool,), (H, U))
    _expect(name, lo, "lo", (tdt,), (H * W,))
    _expect(name, nowin, "nowin", (torch.bool,), (H * W,))
    tensors = (base_lat, base_alive, d_pos, d_lat, d_alive, lo, nowin)
    if not _on_cuda(name, *tensors):
        return masks_from_deltas_plain(*tensors, H, W, h0)
    out = base_alive.new_empty((n, H * W))
    adv_l, adv_a = base_lat.new_empty(n), base_alive.new_empty(n)
    tw = _touch_words(H)
    stream = _stream(out)
    touch = _touch_scratch(out.device, stream, -(-n * tw // 4) * 4)
    fn = _fn("masks", "rtpu_masks_from_deltas_i32" if tdt == torch.int32
             else "rtpu_masks_from_deltas_i64")
    launched = ctypes.c_int64(0)
    err = fn(n, H, W, U, int(bool(h0)), tw, base_lat.data_ptr(),
             base_alive.data_ptr(), d_pos.data_ptr(), d_lat.data_ptr(),
             d_alive.data_ptr(), lo.data_ptr(), nowin.data_ptr(),
             adv_l.data_ptr(), adv_a.data_ptr(), touch.data_ptr(),
             out.data_ptr(), stream, ctypes.byref(launched))
    _launch(name, err, launched.value)
    return out, adv_l, adv_a


# ---------------------------------------------------------------- K6w

def weights_from_deltas_plain(base_w, d_pos, d_val, H: int,
                              h0: bool = False):
    """Twin of ``rtpu_weights_from_deltas``: per hop, scatter-set the hop's
    ``(pos, val)`` weight deltas into a copy of the base weight state (hop 0
    only with ``h0``; pad rows outside ``[0, len)`` dropped) and write the
    state as the hop's column. Returns ``(ew [len, H] f32, advanced
    state)``."""
    cur = base_w.clone()
    n = cur.shape[0]
    out = torch.empty((n, H), dtype=torch.float32, device=cur.device)
    for h in range(H):
        if h or h0:
            p, keep = _skip_pads("weights_from_deltas", h, d_pos[h], n)
            cur[p] = d_val[h][keep]
        out[:, h] = cur
    return out, cur


def weights_from_deltas(base_w, d_pos, d_val, H: int, h0: bool = False):
    """K6w wrapper (replaces the weight rebuild of
    ``raphtory_tpu/engine/hopbatch.py:374-384``): ``base_w [len]`` f32,
    ``d_pos [H, U]`` int32 (pad 2^31-1), ``d_val [H, U]`` f32 → ``(ew
    [len, H] f32 — hop h's weight state in column h, the block K6 reads,
    advanced state [len])``. K1's kernel with an f32 state (``csrc/
    masks.cu``): one cooperative launch a call, the hop-touch scratch from
    ``_touch_scratch``, the base read and never copied; the inputs are
    checked once per signature (``_k2_checked``)."""
    name = "weights_from_deltas"

    def check():
        n = base_w.shape[0]
        U = d_pos.shape[1] if d_pos.dim() == 2 else -1
        _expect(name, base_w, "base_w", (torch.float32,), (n,))
        _expect(name, d_pos, "d_pos", (torch.int32,), (H, U))
        _expect(name, d_val, "d_val", (torch.float32,), (H, U))
        return (n, U) if _on_cuda(name, base_w, d_pos, d_val) else None

    got = _k2_checked(name, (base_w, d_pos, d_val), H, check)
    if got is None:
        return weights_from_deltas_plain(base_w, d_pos, d_val, H, h0)
    n, U = got
    out = base_w.new_empty((n, H))
    adv = base_w.new_empty(n)
    tw = _touch_words(H)
    stream = _stream(out)
    touch = _touch_scratch(out.device, stream, -(-n * tw // 4) * 4)
    launched = ctypes.c_int64(0)
    err = _fn("masks", "rtpu_weights_from_deltas")(
        n, H, U, int(bool(h0)), tw, base_w.data_ptr(), d_pos.data_ptr(),
        d_val.data_ptr(), adv.data_ptr(), touch.data_ptr(), out.data_ptr(),
        stream, ctypes.byref(launched))
    _launch(name, err, launched.value)
    return out, adv


# ---------------------------------------------------------------- K3

#: columns one K3 / KB1 launch carries (``kColGroup`` in ``csrc/masks.cu``):
#: a call launches once a group
COLUMN_GROUP = 64


def _host_array(name: str, what: str, a):
    """A column bound as a host numpy array: a numpy array, a sequence or
    a CPU tensor; a tensor on any other device raises."""
    if isinstance(a, torch.Tensor):
        if a.device.type != "cpu":
            raise ValueError(f"{name}: {what} is on {a.device}; the column "
                             "bounds are host arrays (the kernel takes them "
                             "by value)")
        a = a.numpy()
    return np.asarray(a)


def _column_bounds(name: str, hop_of_col, lo, nowin, H: int,
                   tdt: torch.dtype):
    """K3's / KB1's column bounds checked on the host — ``hop_of_col [C]``
    integers in ``[0, H)``, ``lo [C]`` in the time dtype (an array of
    another dtype raises; a sequence's values must fit it), ``nowin [C]``
    bool — and packed as the C entry takes them: ``int64 [3C]``,
    hop_of_col then lo then nowin."""
    hop = _host_array(name, "hop_of_col", hop_of_col)
    lo_a = _host_array(name, "lo", lo)
    nw = _host_array(name, "nowin", nowin)
    C = hop.shape[0] if hop.ndim == 1 else -1
    for a, what in ((hop, "hop_of_col"), (lo_a, "lo"), (nw, "nowin")):
        if a.shape != (C,):
            raise ValueError(f"{name}: {what} has shape {a.shape}, want "
                             f"({C},)")
    out = np.empty(3 * C, np.int64)
    if not C:
        return out
    ndt = _NP_TIMES[tdt]
    if hop.dtype.kind not in "iu":
        raise TypeError(f"{name}: hop_of_col has dtype {hop.dtype}, want "
                        "integers")
    if nw.dtype != np.bool_:
        raise TypeError(f"{name}: nowin has dtype {nw.dtype}, want bool")
    if isinstance(lo, (np.ndarray, torch.Tensor)):
        if lo_a.dtype != ndt:
            raise TypeError(f"{name}: lo has dtype {lo_a.dtype}, want "
                            f"{ndt} (the times' dtype)")
    elif lo_a.dtype.kind not in "iu" or not np.array_equal(
            lo_a.astype(ndt), lo_a):
        raise ValueError(f"{name}: lo holds values outside {ndt}")
    out[:C], out[C:2 * C], out[2 * C:] = hop, lo_a, nw
    if H <= 0:
        raise ValueError(f"{name}: {C} columns over no hop")
    if out[:C].min() < 0 or out[:C].max() >= H:
        raise ValueError(f"{name}: hop_of_col names a hop outside [0, {H})")
    return out


#: the numpy type of each time dtype
_NP_TIMES = {torch.int32: np.dtype(np.int32), torch.int64: np.dtype(np.int64)}


def _twin_bounds(bounds, tdt: torch.dtype):
    """``bounds`` (``_column_bounds``' packing) as the twins take them: CPU
    tensors ``(hop_of_col int32, lo, nowin bool)``."""
    C = bounds.shape[0] // 3
    return (torch.from_numpy(bounds[:C].astype(np.int32)),
            torch.from_numpy(bounds[C:2 * C].astype(_NP_TIMES[tdt])),
            torch.from_numpy(bounds[2 * C:] != 0))


def _by_value(bounds):
    """The C entry's ``bounds`` argument: the packed host array, shared."""
    return (ctypes.c_int64 * bounds.shape[0]).from_buffer(bounds)


def column_masks_plain(e_lat, e_alive, v_lat, v_alive, hop_of_col, lo,
                       nowin):
    """Twin of ``rtpu_column_masks``: per column c, ``alive[hop_of_col[c]]
    & (nowin[c] | lat[hop_of_col[c]] >= lo[c])``, transposed to the
    entity-major layout (the bounds as tensors on the columns' device).
    Returns ``(me [m, C], mv [n, C])``."""
    hop = hop_of_col.long()

    def masks(lat, alive):
        return (alive[hop] & (nowin[:, None] | (lat[hop] >= lo[:, None]))) \
            .t().contiguous()

    return masks(e_lat, e_alive), masks(v_lat, v_alive)


def _fold_columns(name, e_lat, e_alive, v_lat, v_alive):
    """``(H, m, n)`` of the hop-major fold columns, checked."""
    H, m = e_lat.shape if e_lat.dim() == 2 else (-1, -1)
    n = v_lat.shape[1] if v_lat.dim() == 2 else -1
    tdt = e_lat.dtype
    _expect(name, e_lat, "e_lat", _TIME_DTYPES, (H, m))
    _expect(name, e_alive, "e_alive", (torch.bool,), (H, m))
    _expect(name, v_lat, "v_lat", (tdt,), (H, n))
    _expect(name, v_alive, "v_alive", (torch.bool,), (H, n))
    return H, m, n


def column_masks(e_lat, e_alive, v_lat, v_alive, hop_of_col, lo, nowin):
    """K3 wrapper (replaces ``raphtory_tpu/engine/hopbatch.py:50``): the
    host-column route's window masks. ``e_lat``/``e_alive [H, m]`` and
    ``v_lat``/``v_alive [H, n]`` are the host fold's hop-major columns
    (int32 or int64 times, bool alive), on the card or the CPU; the column
    bounds are HOST arrays (numpy, sequences or CPU tensors): ``hop_of_col
    [C]`` names each column's hop in ``[0, H)``, ``lo [C]`` is ``clip(T_col
    - w_col)`` in the time dtype and ``nowin [C]`` is ``w_col < 0``. On the
    card the bounds travel by value (one launch a group of
    ``COLUMN_GROUP`` columns), so nothing is uploaded. Returns ``(me [m,
    C], mv [n, C])`` bool, entity-major."""
    name = "column_masks"
    H, m, n = _fold_columns(name, e_lat, e_alive, v_lat, v_alive)
    bounds = _column_bounds(name, hop_of_col, lo, nowin, H, e_lat.dtype)
    cols = (e_lat, e_alive, v_lat, v_alive)
    if not _on_cuda(name, *cols):
        return column_masks_plain(*cols, *_twin_bounds(bounds, e_lat.dtype))
    C = bounds.shape[0] // 3
    me, mv = _mask_pair(m, n, C, e_lat.device)
    fn = _fn("masks", "rtpu_column_masks_i32" if e_lat.dtype == torch.int32
             else "rtpu_column_masks_i64")
    launched = ctypes.c_int64(0)
    err = fn(m, n, H, C, e_lat.data_ptr(), e_alive.data_ptr(),
             v_lat.data_ptr(), v_alive.data_ptr(), _by_value(bounds),
             me.data_ptr(), mv.data_ptr(), _stream(me),
             ctypes.byref(launched))
    _launch(name, err, launched.value)
    return me, mv


def _mask_pair(rows: int, n: int, C: int, dev):
    """``(me [rows, C], mv [n, C])`` bool, views of ONE allocation (the
    vertex rows at the next 16-byte boundary)."""
    v0 = -(-rows * C // 16) * 16
    buf = torch.empty(v0 + n * C, dtype=torch.bool, device=dev)
    return (buf.as_strided((rows, C), (C, 1)),
            buf.as_strided((n, C), (C, 1), v0))


# ---------------------------------------------------------------- K4

def scale_hop_masks_plain(base, d_pos, d_t, thr, H: int, W: int):
    """Twin of ``rtpu_scale_hop_masks``: per hop, the running scatter-max of
    the hop's ``(pos, t)`` updates into a copy of the base state (positions
    outside ``[0, len)`` dropped; the pads ``(0, INT32_MIN)`` are a max
    no-op), then the hop's W columns ``cur >= thr``. Returns ``[len, H*W]``
    bool, hop-major columns."""
    cur = base.clone()
    n = cur.shape[0]
    out = torch.empty((n, H * W), dtype=torch.bool, device=cur.device)
    for h in range(H):
        p = d_pos[h].long()
        keep = (p >= 0) & (p < n)
        cur.scatter_reduce_(0, p[keep], d_t[h][keep], "amax",
                            include_self=True)
        sl = slice(h * W, (h + 1) * W)
        out[:, sl] = cur[:, None] >= thr[sl][None, :]
    return out


#: a layout's ``perm`` → ((length, versions, weak ``valid``), its inverse):
#: ``slot_inverse``'s, kept while the layout's device arrays live
_SLOT_INVERSES = WeakIdKeyDictionary()


def slot_inverse(perm, valid, length: int):
    """``int32 [length]``: engine position → the binned slot that holds it
    (``inv[perm[b]] = b`` for each valid slot b), -1 where no valid slot
    does — the engine's pad rows among them (the host layout's ``inv``
    sends those to slot ``B - 1``, which may be a real slot). Binned K4's
    second pass writes an update through it. Built on ``perm``'s device at
    the first call (one scatter) and cached with ``perm``; a layout whose
    valid slots name a position outside ``[0, length)`` or one position
    twice is refused."""
    sig = (length, perm._version, valid._version)
    got = _SLOT_INVERSES.get(perm)
    if got is not None and got[0][:3] == sig and got[0][3]() is valid:
        return got[1]
    slots = torch.nonzero(valid).squeeze(1)
    pos = perm[slots].long()
    if pos.numel() and (int(pos.min()) < 0 or int(pos.max()) >= length):
        raise ValueError(f"scale_hop_masks: the layout's valid slots name "
                         f"positions outside [0, {length})")
    inv = torch.full((length,), -1, dtype=torch.int32, device=perm.device)
    inv[pos] = slots.to(torch.int32)
    if int((inv >= 0).sum()) != pos.numel():
        raise ValueError("scale_hop_masks: two valid slots of the layout "
                         "hold one engine position")
    _SLOT_INVERSES[perm] = ((*sig, weakref.ref(valid)), inv)
    return inv


def scale_hop_masks(base, d_pos, d_t, thr, H: int, W: int, perm=None,
                    valid=None):
    """K4 wrapper (replaces ``_compiled_scale.hop_masks``,
    ``raphtory_tpu/engine/hopbatch.py:2129-2150``, in both its unrolled and
    its ``RTPU_SCALE_MASKS=scan`` shape): the add-only scale path's masks
    of one entity table. ``base [len]`` int32 (INT32_MIN = never seen),
    ``d_pos``/``d_t [H, U]`` int32 padded update lists, ``thr [H*W]`` int32
    column thresholds → ``[len, H*W]`` bool. The twin runs the reference's
    scatter-max; the kernel never builds the hop state (two passes over the
    output: the base's compares, then each update's 1s, ``csrc/masks.cu``)
    and the call allocates only the output.

    ``perm``/``valid`` (``[B]`` int32 / bool, a ``PartitionLayout``'s) emit
    the masks binned instead, ``[B, H*W]`` (hopbatch.py:2126-2137): row b is
    row ``perm[b]`` of the engine-order masks, 0 where ``valid[b]`` is
    False. The kernel reads the base through ``perm`` and writes the
    updates through ``slot_inverse`` (cached with ``perm``)."""
    name = "scale_hop_masks"
    n = base.shape[0]
    U = d_pos.shape[1] if d_pos.dim() == 2 else -1
    _expect(name, base, "base", (torch.int32,), (n,))
    _expect(name, d_pos, "d_pos", (torch.int32,), (H, U))
    _expect(name, d_t, "d_t", (torch.int32,), (H, U))
    _expect(name, thr, "thr", (torch.int32,), (H * W,))
    tensors = (base, d_pos, d_t, thr)
    binned = perm is not None
    if binned:
        B = perm.shape[0] if perm.dim() == 1 else -1
        _expect(name, perm, "perm", (torch.int32,), (B,))
        _expect(name, valid, "valid", (torch.bool,), (B,))
        tensors += (perm, valid)
    if not _on_cuda(name, *tensors):
        out = scale_hop_masks_plain(base, d_pos, d_t, thr, H, W)
        return _bin_rows(out, perm, valid) if binned else out
    rows = B if binned else n
    out = torch.empty((rows, H * W), dtype=torch.bool, device=base.device)
    extra = ((perm.data_ptr(), valid.data_ptr(),
              slot_inverse(perm, valid, n).data_ptr()) if binned
             else (None, None, None))
    launched = ctypes.c_int64(0)
    err = _fn("masks", "rtpu_scale_hop_masks")(
        rows, n, H, W, U, base.data_ptr(), d_pos.data_ptr(), d_t.data_ptr(),
        thr.data_ptr(), *extra, out.data_ptr(), _stream(out),
        ctypes.byref(launched))
    _launch(name, err, launched.value)
    return out


# ---------------------------------------------------------------- KB1

def _bin_rows(me, perm, valid):
    """Engine-order ``me [m, C]`` → binned ``[B, C]``: row b is row
    ``perm[b]``, cleared where ``valid[b]`` is False (``_bin_masks``,
    ``raphtory_tpu/engine/hopbatch.py:283``)."""
    return me[perm.long()] & valid[:, None]


def bin_column_masks_plain(e_lat, e_alive, v_lat, v_alive, hop_of_col, lo,
                           nowin, perm, valid):
    """Twin of ``rtpu_bin_column_masks``: K3's masks, the edge masks then
    permuted into the binned layout. Returns ``(me [B, C], mv [n, C])``."""
    me, mv = column_masks_plain(e_lat, e_alive, v_lat, v_alive, hop_of_col,
                                lo, nowin)
    return _bin_rows(me, perm, valid), mv


def bin_column_masks(e_lat, e_alive, v_lat, v_alive, hop_of_col, lo, nowin,
                     perm, valid):
    """KB1 wrapper on the host-column route (replaces K3 + ``_bin_masks``,
    ``raphtory_tpu/engine/hopbatch.py:50, 283``): the arguments of
    ``column_masks`` (the bounds host arrays, by value on the card) plus a
    layout's ``perm``/``valid [B]`` on the columns' device. Returns ``(me
    [B, C] binned, mv [n, C])`` in one pass a group of ``COLUMN_GROUP``
    columns — edge row b read from edge ``perm[b]`` of the hop-major
    columns, 0 on cap-pad slots."""
    name = "bin_masks"
    H, m, n = _fold_columns(name, e_lat, e_alive, v_lat, v_alive)
    B = perm.shape[0] if perm.dim() == 1 else -1
    _expect(name, perm, "perm", (torch.int32,), (B,))
    _expect(name, valid, "valid", (torch.bool,), (B,))
    bounds = _column_bounds(name, hop_of_col, lo, nowin, H, e_lat.dtype)
    tensors = (e_lat, e_alive, v_lat, v_alive, perm, valid)
    if not _on_cuda(name, *tensors):
        return bin_column_masks_plain(
            *tensors[:4], *_twin_bounds(bounds, e_lat.dtype), perm, valid)
    C = bounds.shape[0] // 3
    me, mv = _mask_pair(B, n, C, e_lat.device)
    fn = _fn("masks", "rtpu_bin_column_masks_i32"
             if e_lat.dtype == torch.int32 else "rtpu_bin_column_masks_i64")
    launched = ctypes.c_int64(0)
    err = fn(B, m, n, H, C, e_lat.data_ptr(), e_alive.data_ptr(),
             v_lat.data_ptr(), v_alive.data_ptr(), _by_value(bounds),
             perm.data_ptr(), valid.data_ptr(), me.data_ptr(), mv.data_ptr(),
             _stream(me), ctypes.byref(launched))
    _launch(name, err, launched.value)
    return me, mv


# ---------------------------------------------------------------- K2

#: K2 card-branch input signature → (weak references to its tensors, what
#: the launch needs); see ``_k2_checked``
_K2_SIGS: dict = {}
#: signatures kept before the cache is cleared
_SIG_CAP = 256


def _k2_checked(name: str, tensors, extra, check):
    """``check()`` — a K2 wrapper's full checks of ``tensors``, raising on a
    bad input and returning None for the twin's branch, else what the
    launch needs — run once per input signature on the card branch: the
    power iteration calls each wrapper with the same tensors every
    superstep, and later calls skip the checks. The signature is each
    tensor's identity and version counter (plus ``extra``): every in-place
    change of a tensor, of its data or of its shape, strides or storage,
    bumps the counter, so a live tensor with the same version has the
    shape, dtype, device, contiguity and address it was checked with; the
    identity is held by weak reference. A changed signature is checked
    again. (Reading each tensor's shape, strides, dtype, device and address
    into a key costs the host as much as the checks it would skip.)"""
    try:
        key = (name, extra, *map(id, tensors),
               *[t._version for t in tensors])
        card = _on_cuda(name, tensors[0])
    except AttributeError:          # not a tensor: the full check raises
        key, card = None, False
    got = _K2_SIGS.get(key) if card else None
    if got is not None and all([r() is t for r, t in zip(got[0], tensors)]):
        return got[1]
    val = check()
    if val is not None and key is not None:
        if len(_K2_SIGS) >= _SIG_CAP:
            _K2_SIGS.clear()
        _K2_SIGS[key] = ([weakref.ref(t) for t in tensors], val)
    return val


# ---------------------------------------------------------------- K2a

#: ``e_src`` → ((m, n_pad, its version), its source walk): ``source_walk``'s,
#: kept while the edge table's device tensor lives
_SOURCE_WALKS = WeakIdKeyDictionary()
#: a source walk's ``out_order`` → (weak references to the ``e_src`` and
#: ``out_indptr`` it was checked with, their versions, its own, n_pad):
#: ``_check_walk``'s last pass
_WALKS_CHECKED = WeakIdKeyDictionary()


def source_walk(e_src, m: int, n_pad: int):
    """``(out_indptr [n_pad + 1] int64, out_order [m] int32)``: the first
    ``m`` rows of ``e_src`` (an edge table's real edges) grouped by source,
    each source's rows in table order — a stable sort by source, as
    ``GlobalTables.out_perm`` is built — with the source CSR. K2a's walk
    for an edge table that carries none (``core/bulk.BulkGraph``): built on
    ``e_src``'s device at the first call (m * 4 + n_pad * 8 bytes) and
    cached with ``e_src``."""
    got = _SOURCE_WALKS.get(e_src)
    if got is None or got[0] != (m, n_pad, e_src._version):
        src = e_src[:m]
        order = torch.sort(src, stable=True).indices.to(torch.int32)
        indptr = torch.zeros(n_pad + 1, dtype=torch.int64,
                             device=e_src.device)
        torch.cumsum(torch.bincount(src, minlength=n_pad), 0,
                     out=indptr[1:])
        got = _SOURCE_WALKS[e_src] = ((m, n_pad, e_src._version),
                                      (indptr, order))
    return got[1]


def _check_walk(name: str, e_src, walk, n_pad: int) -> None:
    """Refuse a source walk K2a would miscount with. ``walk = (out_indptr,
    out_order)`` must list rows of ``e_src`` once each, grouped by source
    in ascending order, ``e_src[out_order]`` agreeing with the CSR
    ``out_indptr``; a row it leaves out must be a pad (source ``n_pad - 1``,
    the pad edges' and cap-pad slots' source, masked in every column), so
    its length is the real row count. Checked once per walk and edge table
    (a few values read back), then remembered."""
    indptr, order = walk
    _expect(name, indptr, "out_indptr", (torch.int64,), (n_pad + 1,))
    k = order.shape[0] if order.dim() == 1 else -1
    _expect(name, order, "out_order", (torch.int32,), (k,))
    sig = (e_src._version, indptr._version, order._version, n_pad)
    seen = _WALKS_CHECKED.get(order)
    if seen is not None and seen[0]() is e_src and seen[1]() is indptr \
            and seen[2] == sig:
        return
    rows = e_src.shape[0]
    o = order.long()
    if int(indptr[0]) != 0 or int(indptr[-1]) != k \
            or bool((indptr[1:] < indptr[:-1]).any()):
        raise ValueError(f"{name}: out_indptr is not the CSR of a walk of "
                         f"{k} entries")
    if k and (int(o.min()) < 0 or int(o.max()) >= rows):
        raise ValueError(f"{name}: the source walk names rows outside "
                         f"[0, {rows})")
    walked = torch.zeros(rows, dtype=torch.bool, device=e_src.device)
    walked[o] = True
    if int(walked.sum()) != k:
        raise ValueError(f"{name}: the source walk names a row twice")
    src = e_src[o].long()
    if k and (int(src.min()) < 0 or int(src.max()) >= n_pad
              or bool((src[1:] < src[:-1]).any())):
        raise ValueError(f"{name}: the source walk's rows are not in "
                         "ascending source order")
    if not torch.equal(torch.bincount(src, minlength=n_pad),
                       indptr[1:] - indptr[:-1]):
        raise ValueError(f"{name}: out_indptr does not match the sources "
                         "of the walk's rows")
    if bool((~walked & (e_src != n_pad - 1)).any()):
        raise ValueError(f"{name}: the source walk leaves out a real row "
                         f"(a row whose source is not the pad {n_pad - 1})")
    _WALKS_CHECKED[order] = (weakref.ref(e_src), weakref.ref(indptr), sig)


def column_out_degree_plain(me, e_src, n_pad: int):
    """Twin of ``rtpu_column_out_degree``: integer per-column out-degree
    ``deg[src[e], c] += me[e, c]``, returned as f32 ``[n_pad, C]``."""
    deg = torch.zeros((n_pad, me.shape[1]), dtype=torch.int32,
                      device=me.device)
    return deg.index_add_(0, e_src, me.to(torch.int32)).to(torch.float32)


def column_out_degree(me, e_src, n_pad: int, walk=None):
    """K2a wrapper (the out-degree segment-sum of
    ``raphtory_tpu/engine/hopbatch.py:154``): ``me [rows, C]`` bool,
    ``e_src [rows]`` int32 → f32 ``[n_pad, C]``. The twin scatters by
    ``e_src``; the kernel gathers over the source walk ``walk =
    (out_indptr, out_order)`` (``DeviceEdges.out_indptr``/``out_perm``, a
    layout's ``walk(reverse=True)``, or ``source_walk``), which a CUDA call
    must give and any call's walk must pass ``_check_walk``. Rows the walk
    leaves out (the pads) must be masked in every column."""
    name = "column_out_degree"
    tensors = (me, e_src) if walk is None else (me, e_src, *walk)

    def check():
        m, C = me.shape if isinstance(me, torch.Tensor) and me.dim() == 2 \
            else (-1, -1)
        _expect(name, me, "me", (torch.bool,), (m, C))
        _expect(name, e_src, "e_src", (torch.int32,), (m,))
        if walk is not None:
            _check_walk(name, e_src, walk, n_pad)
        if not _on_cuda(name, *tensors):
            return None
        if walk is None:
            raise ValueError(f"{name}: the kernel counts over a source walk "
                             "(out_indptr, out_order); none was given")
        return ()

    if _k2_checked(name, tensors, (n_pad, walk is None), check) is None:
        return column_out_degree_plain(me, e_src, n_pad)
    C = me.shape[1]
    deg = torch.empty((n_pad, C), dtype=torch.float32, device=me.device)
    err = _fn("pagerank_columns", "rtpu_column_out_degree")(
        n_pad, C, walk[0].data_ptr(), walk[1].data_ptr(), me.data_ptr(),
        deg.data_ptr(), _stream(deg))
    _launch(name, err, 1 if n_pad and C else 0)
    return deg


# ---------------------------------------------------------------- K2b

def column_pull_sum_plain(me, rd, e_src, e_dst):
    """Twin of ``rtpu_column_pull_sum``: ``agg[d, c] = Σ_{e: dst[e]=d}
    (me[e, c] ? rd[src[e], c] : 0)``, f32 ``[n_pad, C]``."""
    payload = torch.where(me, rd[e_src.long()], 0.0)
    return torch.zeros_like(rd).index_add_(0, e_dst, payload)


def column_pull_sum(me, rd, e_src, e_dst, indptr):
    """K2b wrapper (the per-superstep gather + segment-sum of
    ``raphtory_tpu/engine/hopbatch.py:154``): ``me [m_pad, C]`` bool,
    ``rd [n_pad, C]`` f32, (dst, src)-sorted ``e_src``/``e_dst [m_pad]``
    int32 and their destination CSR ``indptr [n_pad + 1]`` int64 → f32
    ``[n_pad, C]``. The twin reads ``e_dst``, the kernel ``indptr`` and
    ``e_src`` (K2b-P's kernel with walk entry j the pair (e_src[j], j));
    edges past ``indptr[n_pad]`` (the pad edges) must be masked in every
    column, where the twin adds their zeros and the kernel skips them."""
    name = "column_pull_sum"
    tensors = (me, rd, e_src, e_dst, indptr)

    def check():
        m, C = me.shape if isinstance(me, torch.Tensor) and me.dim() == 2 \
            else (-1, -1)
        n = rd.shape[0] if isinstance(rd, torch.Tensor) else -1
        _expect(name, me, "me", (torch.bool,), (m, C))
        _expect(name, rd, "rd", (torch.float32,), (n, C))
        _expect(name, e_src, "e_src", (torch.int32,), (m,))
        _expect(name, e_dst, "e_dst", (torch.int32,), (m,))
        _expect(name, indptr, "indptr", (torch.int64,), (n + 1,))
        return () if _on_cuda(name, *tensors) else None

    if _k2_checked(name, tensors, None, check) is None:
        return column_pull_sum_plain(me, rd, e_src, e_dst)
    n, C = rd.shape
    agg = torch.empty((n, C), dtype=torch.float32, device=rd.device)
    err = _fn("pagerank_columns", "rtpu_column_pull_sum")(
        n, C, indptr.data_ptr(), e_src.data_ptr(), me.data_ptr(),
        rd.data_ptr(), agg.data_ptr(), _stream(agg))
    _launch(name, err, 1 if n and C else 0)
    return agg


# ---------------------------------------------------------------- K2b-P

def binned_pull_sum_plain(me, rd, be):
    """Twin of ``rtpu_binned_pull_sum``: ``agg[d, c] = Σ_{s: b_dst[s]=d}
    (me[s, c] ? vals[slot[s], c] : 0)`` with ``vals = rd[u_src]`` when the
    layout pre-aggregates (``be.U > 0``), else ``rd[b_src[s], c]``
    (``raphtory_tpu/engine/hopbatch.py:242-258``), f32 ``[n_pad, C]``."""
    if be.U:
        src = rd[be.u_src.long()][be.slot.long()]
    else:
        src = rd[be.b_src.long()]
    payload = torch.where(me, src, 0.0)
    return torch.zeros_like(rd).index_add_(0, be.b_dst, payload)


#: ``BinnedEdges.in_order`` → its pull-sum walk pairs
#: (``binned_pull_walk``), kept while the layout's device arrays live
_PULL_WALKS = WeakIdKeyDictionary()
#: ``BinnedEdges.in_order`` of the layouts ``check_bucket_sources`` passed
_BUCKETS_CHECKED = WeakIdKeyDictionary()


def check_bucket_sources(name: str, be) -> None:
    """On a pre-aggregating layout (``be.U > 0``) the twins and the
    reference read a walked slot's bucket row ``u_src[slot[s]]``, where the
    kernels read its source row ``b_src[s]`` straight from the state: the
    two must agree on every real slot. Checked once per layout (a gather
    and a compare on its device); a layout that breaks it is refused."""
    if not be.U or be.in_order in _BUCKETS_CHECKED:
        return
    s = be.in_order.long()
    src = be.b_src[s]
    bad = torch.nonzero(be.u_src[be.slot[s].long()] != src)
    if bad.numel():
        j = int(bad[0, 0])
        raise ValueError(
            f"{name}: walk entry {j} (slot {int(s[j])}) reads bucket source "
            f"{int(be.u_src[be.slot[s[j]]])}, not its slot's source "
            f"{int(src[j])}: the layout's buckets do not match its slots")
    _BUCKETS_CHECKED[be.in_order] = True


def binned_pull_walk(be):
    """``int32 [m, 2]``: for each entry ``j`` of the layout's destination
    walk (slot ``s = in_order[j]``), the source row ``b_src[s]`` and ``s`` —
    what K2b-P reads a walk entry, one 8-byte load (``check_bucket_sources``
    first). Derived on ``be``'s device at the first call (m * 8 bytes) and
    cached with ``be``."""
    got = _PULL_WALKS.get(be.in_order)
    if got is None:
        check_bucket_sources("binned_pull_sum", be)
        got = torch.stack([be.b_src[be.in_order.long()], be.in_order], dim=1)
        _PULL_WALKS[be.in_order] = got
    return got


def binned_pull_sum(me, rd, be):
    """K2b-P wrapper (the binned pull-sum of
    ``raphtory_tpu/engine/hopbatch.py:242-258``): ``me [B, C]`` bool binned
    masks, ``rd [n_pad, C]`` f32, ``be`` the layout's ``BinnedEdges`` → f32
    ``[n_pad, C]``, one launch. The kernel walks each destination's real
    slots in source order (``be.in_indptr`` and ``binned_pull_walk``'s
    pairs) and reads each slot's source row straight from ``rd``, so it
    adds in K2b's order; the twin scatters by ``b_dst``. Cap-pad slots must
    be masked, as ``bin_base``/KB1 leave them."""
    name = "binned_pull_sum"
    tensors = (me, rd, be.b_src, be.b_dst, be.slot, be.u_src, be.in_indptr,
               be.in_order)

    def check():
        B, C = me.shape if isinstance(me, torch.Tensor) and me.dim() == 2 \
            else (-1, -1)
        n = rd.shape[0] if isinstance(rd, torch.Tensor) else -1
        _expect(name, me, "me", (torch.bool,), (B, C))
        _expect(name, rd, "rd", (torch.float32,), (n, C))
        _check_binned(name, be, B, n)
        return () if _on_cuda(name, *tensors) else None

    if _k2_checked(name, tensors, be.U, check) is None:
        return binned_pull_sum_plain(me, rd, be)
    n, C = rd.shape
    pairs = binned_pull_walk(be)
    agg = torch.empty((n, C), dtype=torch.float32, device=rd.device)
    err = _fn("pagerank_columns", "rtpu_binned_pull_sum")(
        n, C, be.in_indptr.data_ptr(), pairs.data_ptr(), me.data_ptr(),
        rd.data_ptr(), agg.data_ptr(), _stream(agg))
    _launch(name, err, 1 if n and C else 0)
    return agg


def _check_binned(name: str, be, B: int, n: int,
                  reverse: bool = False) -> None:
    """Shapes and dtypes of a ``BinnedEdges`` for ``B`` slots over ``n``
    rows (``reverse``: the source walk too)."""
    _expect(name, be.b_src, "b_src", (torch.int32,), (B,))
    _expect(name, be.b_dst, "b_dst", (torch.int32,), (B,))
    _expect(name, be.slot, "slot", (torch.int32,), (B,))
    _expect(name, be.u_src, "u_src", (torch.int32,), (be.u_src.shape[0],))
    if be.U and be.U != be.u_src.shape[0]:
        raise ValueError(f"{name}: U={be.U} buckets, u_src has "
                         f"{be.u_src.shape[0]}")
    _expect(name, be.in_indptr, "in_indptr", (torch.int64,), (n + 1,))
    _expect(name, be.in_order, "in_order", (torch.int32,),
            (be.in_order.shape[0],))
    if reverse:
        if be.out_indptr is None:
            raise ValueError(f"{name}: the layout's source walk is missing "
                             "(device_edges(..., reverse=True))")
        _expect(name, be.out_indptr, "out_indptr", (torch.int64,), (n + 1,))
        _expect(name, be.out_order, "out_order", (torch.int32,),
                (be.out_order.shape[0],))


# ---------------------------------------------------------------- K2c

#: K2c's block: 256 threads, a thread 4 adjacent columns of a row
#: (``csrc/pagerank_columns.cu``)
_UPDATE_THREADS = 256
#: rows a K2c thread keeps in flight (the kernel's ``kUpdateRows``)
_UPDATE_ROWS = 4
#: most blocks of K2c's grid: the 2 an SM its registers leave resident, on
#: the H100's 132; its last block sums one partial per block along the rows
_UPDATE_BLOCKS = 2 * 132


def update_grid(n: int, C: int) -> int:
    """Blocks along the rows of K2c's grid for ``[n, C]`` state — the row
    count of its per-block partials. A block holds whole rows of up to 256
    quads (4 columns); wider C tiles the quads over the grid's second
    dimension, and the rows get what is left of ``_UPDATE_BLOCKS`` (at
    least one block), or fewer blocks where that would leave a thread
    fewer than ``_UPDATE_ROWS`` rows."""
    quads = max(1, -(-C // 4))
    tile = min(quads, _UPDATE_THREADS)
    rows = _UPDATE_THREADS // tile
    tiles = -(-quads // tile)
    return max(1, min(-(-n // (rows * _UPDATE_ROWS)),
                      _UPDATE_BLOCKS // tiles))


@dataclass
class RankState:
    """Per-dispatch state of the column-batched power iteration, updated in
    place by ``pagerank_update``. ``part``/``busy``/``ticket`` are the
    kernel's cross-block scratch (the twin leaves them alone)."""
    r: torch.Tensor          # [n, C] f32 ranks
    rd: torch.Tensor         # [n, C] f32 r / max(deg, 1): K2b's input
    dangling: torch.Tensor   # [C] f32 mass on alive zero-out-degree rows
    halted: torch.Tensor     # [C] bool converged (frozen) columns
    done: torch.Tensor       # [1] bool every column halted
    part: torch.Tensor       # [gx, C] f64 per-block dangling partials
    busy: torch.Tensor       # [gx, C] int32 per-block "not converged"
    ticket: torch.Tensor     # [1] int32 blocks finished (reset by the last)


def rank_state(r: torch.Tensor) -> RankState:
    """A ``RankState`` around starting ranks ``r [n, C]`` (f32,
    contiguous); the rest is derived by ``pagerank_update(prime=True)``."""
    n, C = r.shape
    dev = r.device
    gx = update_grid(n, C)
    return RankState(
        r=r, rd=torch.empty_like(r),
        dangling=torch.zeros(C, dtype=torch.float32, device=dev),
        halted=torch.zeros(C, dtype=torch.bool, device=dev),
        done=torch.zeros(1, dtype=torch.bool, device=dev),
        part=torch.empty((gx, C), dtype=torch.float64, device=dev),
        busy=torch.empty((gx, C), dtype=torch.int32, device=dev),
        ticket=torch.zeros(1, dtype=torch.int32, device=dev))


def f32(x: float, like: torch.Tensor) -> torch.Tensor:
    """A Python float as an f32 scalar tensor: ``x / t`` on a tensor is
    ``t.reciprocal() * x`` in torch, which rounds twice — the reference's
    ``x / t`` is one correctly rounded f32 division."""
    return torch.tensor(x, dtype=torch.float32, device=like.device)


def pagerank_update_plain(st: RankState, agg, deg, mv, n_act,
                          damping: float, tol: float,
                          prime: bool = False) -> None:
    """Twin of ``rtpu_pagerank_update``: the superstep epilogue after the
    pull-sum — dangling redistribution, damping, masking, per-column tol
    halting, the freeze of halted columns — then the next superstep's
    ``rd`` and dangling mass and the all-halted flag. ``prime`` skips the
    update (derives ``rd``/dangling from the starting ranks)."""
    r = st.r
    if not prime:
        new = (torch.div(f32(1.0 - damping, r), n_act)[None, :]
               + f32(damping, r) * (agg + (st.dangling / n_act)[None, :]))
        new = torch.where(mv, new, 0.0)
        col_done = (((new - r).abs() < tol) | ~mv).all(0)
        r.copy_(torch.where(st.halted[None, :], r, new))
        st.halted |= col_done
    torch.mul(r, 1.0 / torch.clamp(deg, min=1.0), out=st.rd)
    st.dangling.copy_(torch.where(mv & (deg == 0), r, 0.0).sum(0))
    st.done.copy_(st.halted.all().reshape(1))


def pagerank_update(st: RankState, agg, deg, mv, n_act, damping: float,
                    tol: float, prime: bool = False) -> None:
    """K2c wrapper (the superstep epilogue of the loop body of
    ``raphtory_tpu/engine/hopbatch.py:154``, lines 259-266): updates ``st``
    in place from ``agg [n, C]`` (K2b's output; unused with ``prime``),
    the f32 out-degree ``deg [n, C]``, the vertex mask ``mv [n, C]`` and
    the per-column alive counts ``n_act [C]``."""
    name = "pagerank_update"
    # agg is K2b's new output every superstep: checked at every call, the
    # rest once per signature
    tensors = (st.r, st.rd, deg, mv, n_act, st.dangling, st.halted, st.done,
               st.part, st.busy, st.ticket)

    def check():
        n, C = st.r.shape if isinstance(st.r, torch.Tensor) \
            and st.r.dim() == 2 else (-1, -1)
        _expect(name, st.r, "r", (torch.float32,), (n, C))
        _expect(name, st.rd, "rd", (torch.float32,), (n, C))
        _expect(name, deg, "deg", (torch.float32,), (n, C))
        _expect(name, mv, "mv", (torch.bool,), (n, C))
        _expect(name, n_act, "n_act", (torch.float32,), (C,))
        _expect(name, st.dangling, "dangling", (torch.float32,), (C,))
        _expect(name, st.halted, "halted", (torch.bool,), (C,))
        _expect(name, st.done, "done", (torch.bool,), (1,))
        if not _on_cuda(name, *tensors):
            return None
        gx = update_grid(n, C)
        _expect(name, st.part, "part", (torch.float64,), (gx, C))
        _expect(name, st.busy, "busy", (torch.int32,), (gx, C))
        _expect(name, st.ticket, "ticket", (torch.int32,), (1,))
        return gx

    gx = _k2_checked(name, tensors, bool(prime), check)
    n, C = st.r.shape
    if not prime:
        _expect(name, agg, "agg", (torch.float32,), (n, C))
        _on_cuda(name, st.r, agg)     # raises off the state's device
    if gx is None:
        return pagerank_update_plain(st, agg, deg, mv, n_act, damping, tol,
                                     prime)
    fn = _fn("pagerank_columns", "rtpu_pagerank_update")
    _launch(name, fn(n, C, gx, int(bool(prime)), 1.0 - damping, damping, tol,
                     None if prime else agg.data_ptr(), deg.data_ptr(),
                     mv.data_ptr(), n_act.data_ptr(), st.r.data_ptr(),
                     st.rd.data_ptr(), st.dangling.data_ptr(),
                     st.halted.data_ptr(), st.done.data_ptr(),
                     st.part.data_ptr(), st.busy.data_ptr(),
                     st.ticket.data_ptr(), _stream(st.r)))
