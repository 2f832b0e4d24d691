"""ctypes bindings for the native kernel library.

Every function here mirrors a numpy implementation elsewhere in the package;
callers use ``native.fold_latest or numpy_path`` style dispatch. The library
compiles lazily on first use (``native/build.py``) and failure to build just
means the numpy paths run.
"""

from __future__ import annotations

import ctypes
import logging
import threading

import numpy as np

_log = logging.getLogger(__name__)
_lib = None
_tried = False
_load_lock = threading.Lock()   # first use may g++-build the library —
# concurrent first callers (e.g. the sweep's overlapped vertex fold) must
# not race the build/latch

_i64p = ctypes.POINTER(ctypes.c_int64)
_u8p = ctypes.POINTER(ctypes.c_uint8)


def _load():
    global _lib, _tried
    if _tried:
        return _lib
    with _load_lock:
        if _tried:
            return _lib
        return _load_locked()


def _load_locked():
    global _lib, _tried
    try:
        _lib = _build_and_bind()
    finally:
        # set LAST (under the lock, after _lib publishes) so the unlocked
        # fast path never observes _tried before _lib
        _tried = True
    return _lib


def _build_and_bind():
    from .build import lib_path

    path = lib_path()
    if path is None:
        # one-time heads-up: every `_native.x or numpy` dispatch in the
        # package now takes the interpreted path (including the O(queries)
        # _lex_lookup loop on edge-property materialisation)
        _log.warning(
            "raphtory_tpu_torch native kernels unavailable (build disabled or "
            "failed) — falling back to slower numpy/Python paths")
        return None
    try:
        lib = ctypes.CDLL(str(path))
    except OSError as e:
        _log.warning(
            "raphtory_tpu_torch native kernel library failed to load (%s) — "
            "falling back to slower numpy/Python paths", e)
        return None
    lib.rtpu_sort_events.restype = None
    lib.rtpu_sort_events.argtypes = [
        ctypes.c_int64, _i64p, _i64p, _i64p, _u8p, _i64p]
    lib.rtpu_fold_sorted.restype = ctypes.c_int64
    lib.rtpu_fold_sorted.argtypes = [
        ctypes.c_int64, _i64p, _i64p, _i64p, _u8p, _i64p,
        _i64p, _i64p, _i64p, _u8p, _i64p]
    lib.rtpu_lex_lookup2.restype = None
    lib.rtpu_lex_lookup2.argtypes = [
        ctypes.c_int64, _i64p, _i64p, ctypes.c_int64, _i64p, _i64p, _i64p]
    _u64p = ctypes.POINTER(ctypes.c_uint64)
    lib.rtpu_searchsorted_u64.restype = None
    lib.rtpu_searchsorted_u64.argtypes = [
        ctypes.c_int64, _u64p, ctypes.c_int64, _u64p, ctypes.c_int32, _i64p]
    return lib


def available() -> bool:
    return _load() is not None


def _p64(a: np.ndarray):
    return a.ctypes.data_as(_i64p)


def _pu8(a: np.ndarray):
    return a.ctypes.data_as(_u8p)


def _c64(a) -> np.ndarray:
    return np.ascontiguousarray(a, np.int64)


def sort_events(keys: tuple, times, alive) -> np.ndarray | None:
    """Argsort by (keys..., time, alive-first); np.lexsort((~alive, times,
    *reversed(keys))) equivalent. None when the native lib is unavailable."""
    lib = _load()
    if lib is None or len(keys) not in (1, 2):
        return None
    n = len(times)
    k1 = _c64(keys[0])
    k2 = _c64(keys[1]) if len(keys) == 2 else None
    t = _c64(times)
    a = np.ascontiguousarray(alive, np.uint8)
    order = np.empty(n, np.int64)
    lib.rtpu_sort_events(
        n, _p64(k1), _p64(k2) if k2 is not None else None,
        _p64(t), _pu8(a), _p64(order))
    return order


def fold_latest(keys: tuple, times, alive):
    """Native _fold_latest: (unique_keys, latest_time, latest_alive,
    first_time). None when unavailable."""
    lib = _load()
    if lib is None or len(keys) not in (1, 2):
        return None
    n = len(times)
    if n == 0:
        empty = tuple(np.empty(0, np.int64) for _ in keys)
        return empty, np.empty(0, np.int64), np.empty(0, bool), np.empty(0, np.int64)
    k1 = _c64(keys[0])
    k2 = _c64(keys[1]) if len(keys) == 2 else None
    t = _c64(times)
    a = np.ascontiguousarray(alive, np.uint8)
    order = np.empty(n, np.int64)
    lib.rtpu_sort_events(
        n, _p64(k1), _p64(k2) if k2 is not None else None,
        _p64(t), _pu8(a), _p64(order))
    ok1 = np.empty(n, np.int64)
    ok2 = np.empty(n, np.int64) if k2 is not None else None
    olat = np.empty(n, np.int64)
    oal = np.empty(n, np.uint8)
    ofst = np.empty(n, np.int64)
    g = lib.rtpu_fold_sorted(
        n, _p64(k1), _p64(k2) if k2 is not None else None,
        _p64(t), _pu8(a), _p64(order),
        _p64(ok1), _p64(ok2) if ok2 is not None else None,
        _p64(olat), _pu8(oal), _p64(ofst))
    out_keys = (ok1[:g].copy(),)
    if ok2 is not None:
        out_keys = (ok1[:g].copy(), ok2[:g].copy())
    return out_keys, olat[:g].copy(), oal[:g].astype(bool), ofst[:g].copy()


def lex_lookup2(b1, b2, q1, q2) -> np.ndarray | None:
    lib = _load()
    if lib is None:
        return None
    b1 = _c64(b1)
    b2 = _c64(b2)
    q1 = _c64(q1)
    q2 = _c64(q2)
    out = np.empty(len(q1), np.int64)
    lib.rtpu_lex_lookup2(
        len(b1), _p64(b1), _p64(b2), len(q1), _p64(q1), _p64(q2), _p64(out))
    return out


def searchsorted_u64(base: np.ndarray, queries: np.ndarray,
                     side: str = "left") -> np.ndarray:
    """Parallel batched searchsorted over a sorted uint64 array."""
    lib = _load()
    base = np.ascontiguousarray(base, np.uint64)
    queries = np.ascontiguousarray(queries, np.uint64)
    if lib is None:
        return np.searchsorted(base, queries, side=side)
    out = np.empty(len(queries), np.int64)
    u64p = ctypes.POINTER(ctypes.c_uint64)
    lib.rtpu_searchsorted_u64(
        len(base), base.ctypes.data_as(u64p),
        len(queries), queries.ctypes.data_as(u64p),
        1 if side == "right" else 0, _p64(out))
    return out
