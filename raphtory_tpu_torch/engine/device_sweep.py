"""Global dense-space graph tables and their cached device upload.

Vertices are indexed by their rank in the sorted set of every id the pinned
log ever mentions (``SweepBuilder.uv``); the edge table is every (src, dst)
pair the log ever mentions, sorted once by (dst, src). Positions never change
across a sweep — dead entities are simply masked — so the tables upload to
the device ONCE per log and every hop ships only fold-state deltas.
"""

from __future__ import annotations

import weakref

import numpy as np
import torch

from ..core.events import EDGE_ADD, EDGE_DELETE
from ..core.snapshot import INT64_MIN, _pad_bucket
from ..core.sweep import _ENC_MASK, _ENC_SHIFT, SweepBuilder
from ..native import lib as _native


def _pad_large(n: int) -> int:
    """Power-of-two buckets up to 2^16 (shared shapes across small logs),
    then 2^16-multiples — pow2 padding would waste up to 2x of every
    per-edge pass at GAB scale and beyond."""
    if n <= (1 << 16):
        return _pad_bucket(n)
    step = 1 << 16
    return ((n + step - 1) // step) * step


#: per-log cache of the device-uploaded static edge tables — a cold engine
#: over an unchanged log reuses the resident tensors instead of re-shipping
#: them per query. Keyed weakly by the CALLER's log object; one entry per
#: device.
_DEVICE_EDGES = weakref.WeakKeyDictionary()


def _device_edges(log, tables, device: torch.device):
    """Device ``(e_src, e_dst, in_indptr)`` for ``tables``, cached per log
    and device. The (m, n) key is exact: pairs and vertices are never
    removed from a log, so equal counts mean the identical deterministic
    table (same pair set, same dense ranks, same (dst, src) sort)."""
    per_log = _DEVICE_EDGES.setdefault(log, {})
    ent = per_log.get(device)
    if ent is not None and ent[0] == tables.m and ent[1] == tables.n:
        return ent[2]
    dev = tuple(torch.from_numpy(a).to(device)
                for a in (tables.e_src, tables.e_dst, tables.in_indptr))
    per_log[device] = (tables.m, tables.n, dev)
    return dev


class GlobalTables:
    """Static global-dense-space graph tables over a pinned log: every
    vertex id the log ever mentions (rank in ``uv`` = dense index) and every
    (src, dst) pair, (dst, src)-sorted, with its destination CSR."""

    def __init__(self, sw: SweepBuilder):
        if not sw._ok:
            raise ValueError("log has >= 2^31 distinct vertices — the packed "
                             "pair key space is exhausted; use build_view")
        self.uv = sw.uv
        if sw._preseeded:
            # a preseeded sweep's pair table IS the all-pairs table (and
            # never grows) — no second unique over the edge events
            self.all_enc = sw.e_enc
        else:
            is_e = (sw._k == EDGE_ADD) | (sw._k == EDGE_DELETE)
            if is_e.any():
                enc = ((sw._dense(sw._s[is_e]) << _ENC_SHIFT)
                       | sw._dense(sw._d[is_e]))
                self.all_enc = np.unique(enc)
            else:
                self.all_enc = np.empty(0, np.int64)

        self.n = len(self.uv)
        self.m = len(self.all_enc)
        self.n_pad = _pad_large(self.n)
        self.m_pad = _pad_large(self.m)
        # times narrow to i32 when the whole log fits — halves both the
        # resident fold state and the delta bytes
        tcol = sw._t
        self.tdtype = (
            np.int32 if len(tcol) == 0
            or (tcol.min() > np.iinfo(np.int32).min // 2
                and tcol.max() < np.iinfo(np.int32).max // 2)
            else np.int64)
        self.tmin = np.iinfo(self.tdtype).min

        # engine edge order: (dst, src) — combine-at-destination reads a
        # contiguous edge run per destination row
        flip = ((self.all_enc & _ENC_MASK) << _ENC_SHIFT) \
            | (self.all_enc >> _ENC_SHIFT)
        order = np.argsort(flip)              # engine pos i ← enc rank
        self.eng_of_rank = np.empty(self.m, np.int64)
        self.eng_of_rank[order] = np.arange(self.m)

        # pad edges are dst = src = n_pad-1: the (dst, src) order survives
        # padding and the pads fall in the last destination row
        self.e_src = np.full(self.m_pad, self.n_pad - 1, np.int32)
        self.e_dst = np.full(self.m_pad, self.n_pad - 1, np.int32)
        eng_enc = self.all_enc[order]
        self.e_src[: self.m] = (eng_enc >> _ENC_SHIFT).astype(np.int32)
        self.e_dst[: self.m] = (eng_enc & _ENC_MASK).astype(np.int32)
        self.vids = np.full(self.n_pad, -1, np.int64)
        self.vids[: self.n] = self.uv
        #: destination CSR over the REAL (dst, src)-sorted edges: row d
        #: owns edges [in_indptr[d], in_indptr[d+1]). The pad edges are
        #: masked in every column and lie past in_indptr[n_pad] = m, so no
        #: row walks them (all m_pad - m of them would land in row n_pad-1)
        self.in_indptr = np.zeros(self.n_pad + 1, np.int64)
        np.cumsum(np.bincount(self.e_dst[: self.m], minlength=self.n_pad),
                  out=self.in_indptr[1:])

    def eng_pos(self, enc: np.ndarray) -> np.ndarray:
        """Engine positions of packed pair keys (must exist in the log).
        Packed keys are non-negative (dense<<32|dense), so the sorted i64
        table reinterprets as u64 zero-copy for the native parallel
        searchsorted — the hot per-hop lookup at 10^8-pair scale."""
        if len(enc) > (1 << 16) and _native.available():
            idx = _native.searchsorted_u64(
                self.all_enc.view(np.uint64),
                np.ascontiguousarray(enc).view(np.uint64))
            return self.eng_of_rank[idx]
        return self.eng_of_rank[np.searchsorted(self.all_enc, enc)]

    def cast_times(self, a: np.ndarray) -> np.ndarray:
        """i64 fold times → the narrow resident dtype (INT64_MIN pad maps to
        the narrow dtype's min) — shared by every engine over these tables."""
        if self.tdtype == np.int64:
            return a
        return np.where(a == INT64_MIN, self.tmin, a).astype(self.tdtype)


def normalize_windows(windows) -> list[int]:
    """window list → int list with -1 for 'no window' (engine convention)."""
    return [(-1 if w is None else int(w)) for w in windows]
