"""Kernels of the hop-batched columnar engine: K1 and K2 (the edge passes
and the superstep update of the PageRank power iteration).

Each kernel has three parts here:

* a **wrapper** (``masks_from_deltas``, ``column_out_degree``,
  ``column_pull_sum``, ``pagerank_update``) that checks device, dtype, shape
  and contiguity, allocates the outputs, and routes by the tensors' device:
  CPU tensors take the plain twin, CUDA tensors launch the hand-written
  kernel (or raise — there is no fallback). Each kernel launch adds one to
  ``LAUNCHES[name]``; nothing else does (K1's C entry point runs a hop loop
  and reports how many kernels it launched).
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
from dataclasses import dataclass
from pathlib import Path

import torch

_CSRC = Path(__file__).resolve().parent.parent / "csrc"
_BUILD = _CSRC / "_build"

#: kernel library → (CUDA source, its C entry points)
_LIBS = {
    "masks": ("masks.cu", ("rtpu_masks_from_deltas_i32",
                           "rtpu_masks_from_deltas_i64")),
    "pagerank_columns": ("pagerank_columns.cu", ("rtpu_column_out_degree",
                                                 "rtpu_column_pull_sum",
                                                 "rtpu_pagerank_update")),
}
_ARGTYPES = {
    # len, H, W, U, h0 | d_pos, d_lat, d_alive, lo, nowin, cur_l, cur_a,
    # out, stream | launched
    "rtpu_masks_from_deltas_i32": 5 * [ctypes.c_int64] + 9 * [ctypes.c_void_p]
    + [ctypes.POINTER(ctypes.c_int64)],
    "rtpu_masks_from_deltas_i64": 5 * [ctypes.c_int64] + 9 * [ctypes.c_void_p]
    + [ctypes.POINTER(ctypes.c_int64)],
    # m, C | me, src, deg, stream
    "rtpu_column_out_degree": 2 * [ctypes.c_int64] + 4 * [ctypes.c_void_p],
    # n, C | indptr, src, me, rd, agg, stream
    "rtpu_column_pull_sum": 2 * [ctypes.c_int64] + 6 * [ctypes.c_void_p],
    # n, C, gx, prime | 1-damping, damping, tol | agg, deg, mv, n_act, r, rd,
    # dangling, halted, done, part, busy, ticket, stream
    "rtpu_pagerank_update": 4 * [ctypes.c_int64] + 3 * [ctypes.c_float]
    + 13 * [ctypes.c_void_p],
}

#: kernel launches per wrapper since the last ``reset_launches()``
LAUNCHES = {"masks_from_deltas": 0, "column_out_degree": 0,
            "column_pull_sum": 0, "pagerank_update": 0}

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


def _fn(lib: str, fn: str):
    if lib not in _loaded:
        build()
    return getattr(_loaded[lib], fn)


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
    if tuple(t.shape) != tuple(shape):
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


def _ptr(t: torch.Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())


def _stream(t: torch.Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream(t.device).cuda_stream)


_TIME_DTYPES = (torch.int32, torch.int64)


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
            p = d_pos[h].long()
            keep = (p >= 0) & (p < n)
            p = p[keep]
            if torch.unique(p).numel() != p.numel():
                raise ValueError(f"hop {h} delta sets a position twice — "
                                 "the host fold emits each touched entity "
                                 "once per hop")
            cur_l[p] = d_lat[h][keep]
            cur_a[p] = d_alive[h][keep]
        sl = slice(h * W, (h + 1) * W)
        out[:, sl] = cur_a[:, None] & (nowin[sl][None, :]
                                       | (cur_l[:, None] >= lo[sl][None, :]))
    return out, cur_l, cur_a


def masks_from_deltas(base_lat, base_alive, d_pos, d_lat, d_alive, lo, nowin,
                      H: int, W: int, h0: bool = False):
    """K1 wrapper (replaces ``raphtory_tpu/engine/hopbatch.py:66``): the
    per-hop fold-state rebuild and window masks of one dispatch. ``lo`` is
    ``clip(T_col - w_col)`` already in the time dtype and ``nowin`` is
    ``w_col < 0``, both ``[H*W]``. Returns ``(mask [len, H*W] bool, advanced
    lat, advanced alive)``."""
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
    cur_l, cur_a = base_lat.clone(), base_alive.clone()
    out = torch.empty((n, H * W), dtype=torch.bool, device=base_lat.device)
    fn = _fn("masks", "rtpu_masks_from_deltas_i32" if tdt == torch.int32
             else "rtpu_masks_from_deltas_i64")
    launched = ctypes.c_int64(0)
    err = fn(n, H, W, U, int(bool(h0)), _ptr(d_pos), _ptr(d_lat),
             _ptr(d_alive), _ptr(lo), _ptr(nowin), _ptr(cur_l), _ptr(cur_a),
             _ptr(out), _stream(out), ctypes.byref(launched))
    _launch(name, err, launched.value)
    return out, cur_l, cur_a


# ---------------------------------------------------------------- K2a

def column_out_degree_plain(me, e_src, n_pad: int):
    """Twin of ``rtpu_column_out_degree``: integer per-column out-degree
    ``deg[src[e], c] += me[e, c]``, returned as f32 ``[n_pad, C]``."""
    deg = torch.zeros((n_pad, me.shape[1]), dtype=torch.int32,
                      device=me.device)
    return deg.index_add_(0, e_src, me.to(torch.int32)).to(torch.float32)


def column_out_degree(me, e_src, n_pad: int):
    """K2a wrapper (the out-degree segment-sum of
    ``raphtory_tpu/engine/hopbatch.py:154``): ``me [m_pad, C]`` bool,
    ``e_src [m_pad]`` int32 → f32 ``[n_pad, C]``."""
    name = "column_out_degree"
    m, C = me.shape
    _expect(name, me, "me", (torch.bool,), (m, C))
    _expect(name, e_src, "e_src", (torch.int32,), (m,))
    if not _on_cuda(name, me, e_src):
        return column_out_degree_plain(me, e_src, n_pad)
    deg = torch.zeros((n_pad, C), dtype=torch.int32, device=me.device)
    fn = _fn("pagerank_columns", "rtpu_column_out_degree")
    _launch(name, fn(m, C, _ptr(me), _ptr(e_src), _ptr(deg), _stream(deg)))
    return deg.to(torch.float32)


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
    ``[n_pad, C]``. The twin reads ``e_dst``, the kernel ``indptr``; edges
    past ``indptr[n_pad]`` (the pad edges) must be masked in every column,
    where the twin adds their zeros and the kernel skips them."""
    name = "column_pull_sum"
    m, C = me.shape
    n = rd.shape[0]
    _expect(name, me, "me", (torch.bool,), (m, C))
    _expect(name, rd, "rd", (torch.float32,), (n, C))
    _expect(name, e_src, "e_src", (torch.int32,), (m,))
    _expect(name, e_dst, "e_dst", (torch.int32,), (m,))
    _expect(name, indptr, "indptr", (torch.int64,), (n + 1,))
    if not _on_cuda(name, me, rd, e_src, e_dst, indptr):
        return column_pull_sum_plain(me, rd, e_src, e_dst)
    agg = torch.empty((n, C), dtype=torch.float32, device=rd.device)
    fn = _fn("pagerank_columns", "rtpu_column_pull_sum")
    _launch(name, fn(n, C, _ptr(indptr), _ptr(e_src), _ptr(me), _ptr(rd),
                     _ptr(agg), _stream(agg)))
    return agg


# ---------------------------------------------------------------- K2c

#: K2c's block: 256 threads, columns fastest (``csrc/pagerank_columns.cu``)
_UPDATE_THREADS = 256
#: most blocks along K2c's rows: its last block sums one partial per block
_UPDATE_BLOCKS = 2 * 132


def update_grid(n: int, C: int) -> int:
    """Blocks along the rows of K2c's grid for ``[n, C]`` state — the row
    count of its per-block partials."""
    rows = _UPDATE_THREADS // max(1, min(C, _UPDATE_THREADS))
    return max(1, min(-(-n // rows), _UPDATE_BLOCKS))


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
    part: torch.Tensor       # [gx, C] f32 per-block dangling partials
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
        part=torch.empty((gx, C), dtype=torch.float32, device=dev),
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
    n, C = st.r.shape
    _expect(name, st.r, "r", (torch.float32,), (n, C))
    _expect(name, st.rd, "rd", (torch.float32,), (n, C))
    _expect(name, deg, "deg", (torch.float32,), (n, C))
    _expect(name, mv, "mv", (torch.bool,), (n, C))
    _expect(name, n_act, "n_act", (torch.float32,), (C,))
    _expect(name, st.dangling, "dangling", (torch.float32,), (C,))
    _expect(name, st.halted, "halted", (torch.bool,), (C,))
    _expect(name, st.done, "done", (torch.bool,), (1,))
    tensors = [st.r, st.rd, deg, mv, n_act, st.dangling, st.halted, st.done,
               st.part, st.busy, st.ticket]
    if not prime:
        _expect(name, agg, "agg", (torch.float32,), (n, C))
        tensors.append(agg)
    if not _on_cuda(name, *tensors):
        return pagerank_update_plain(st, agg, deg, mv, n_act, damping, tol,
                                     prime)
    gx = update_grid(n, C)
    _expect(name, st.part, "part", (torch.float32,), (gx, C))
    _expect(name, st.busy, "busy", (torch.int32,), (gx, C))
    _expect(name, st.ticket, "ticket", (torch.int32,), (1,))
    fn = _fn("pagerank_columns", "rtpu_pagerank_update")
    _launch(name, fn(n, C, gx, int(bool(prime)), 1.0 - damping, damping, tol,
                     None if prime else _ptr(agg), _ptr(deg), _ptr(mv),
                     _ptr(n_act), _ptr(st.r), _ptr(st.rd), _ptr(st.dangling),
                     _ptr(st.halted), _ptr(st.done), _ptr(st.part),
                     _ptr(st.busy), _ptr(st.ticket), _stream(st.r)))
