"""Incremental range-sweep view builder — delta-applied snapshots.

The reference re-runs the full per-timestamp handshake for every hop of a
Range query (``Tasks/RangeTasks/RangeAnalysisTask.scala:18-35`` — fresh
``TimeCheck``/``Setup`` per timestamp) and ``build_view`` likewise re-folds
the whole event log per hop. For an ascending sweep T0 < T1 < ... over a
pinned log that is wasteful: the fold state at T_{i+1} differs from T_i only
by the events with time in (T_i, T_{i+1}].

``SweepBuilder`` keeps the running fold state and applies each hop's delta:

* a fixed dense vertex dictionary is built once from the whole pinned log,
  so vertex fold state lives in flat dense arrays (O(delta) updates, no
  merging), and an edge (s, d) packs into ONE int64 key
  ``dense_s << 32 | dense_d`` — every edge-state merge is a single-key
  searchsorted, and the delta fold runs the native single-key kernel.
* cross-entity tombstones (vertex delete ⇒ incident-edge dead marks,
  ``Edge.killList`` semantics, ``Edge.scala:36-44``) are generated
  incrementally: delta deletes join against all pairs known so far (both
  src- and dst-sorted key arrays are maintained), and pairs first seen in
  this delta join against the full delete history — reproducing exactly the
  all-pairs × all-deletes join of ``build_view``.

Each ``view_at(T)`` emits a ``GraphView`` bit-identical to
``build_view(log, T)``; the columnar engine reads only the fold state and
``last_delta``.
"""

from __future__ import annotations

import numpy as np

from .events import EDGE_ADD, EDGE_DELETE, VERTEX_ADD, VERTEX_DELETE, EventLog
from .snapshot import (
    INT64_MIN,
    GraphView,
    _assemble_view,
    _expand_ranges,
    _fold_latest,
    build_view,
)

_ENC_SHIFT = 32
_ENC_MASK = (1 << _ENC_SHIFT) - 1

_EMPTY_DELTA = {
    "v_idx": np.empty(0, np.int64), "v_lat": np.empty(0, np.int64),
    "v_alive": np.empty(0, bool), "v_first": np.empty(0, np.int64),
    "e_enc": np.empty(0, np.int64), "e_lat": np.empty(0, np.int64),
    "e_alive": np.empty(0, bool), "e_first": np.empty(0, np.int64),
}


class SweepBuilder:
    """Build views at ascending timestamps over a pinned log, incrementally.

    For out-of-order `view_at` times, or once the dense dictionary would
    overflow the 32-bit pack, it falls back to full ``build_view`` per call.
    """

    def __init__(self, log: EventLog, *, include_occurrences: bool = False,
                 pad: str = "pow2", track_rows: bool = True,
                 preseed_pairs: bool = False):
        if include_occurrences and not track_rows:
            raise ValueError("occurrence views need the add-row lists")
        self.log = log.pin()
        self.include_occurrences = include_occurrences
        self.pad = pad
        self.track_rows = track_rows
        self._t = self.log.column("time")
        self._k = self.log.column("kind")
        self._s = self.log.column("src")
        self._d = self.log.column("dst")
        # dense dictionary over every vertex id the log ever mentions. dst is
        # only a vertex id on edge events — vertex events carry a -1 sentinel
        # there, and REAL ids can be negative (assign_id hashes to signed
        # int64), so select by kind, never by sign.
        is_e = (self._k == EDGE_ADD) | (self._k == EDGE_DELETE)
        d_real = self._d[is_e]
        # per-row dense ids, computed ONCE as the inverse of the dictionary's
        # own sort: per-hop _advance slices these instead of searching the
        # dictionary for every delta. (The reference searchsorts each row's
        # ids into ``uv`` and skips the table above 2^23 events; unsorted
        # lookups into a multi-MB dictionary were the dominant host cost of
        # the 2^25-event scale sweep. Same ids: ``uv`` holds unique values.)
        if len(self._s):
            self.uv, inv = np.unique(np.concatenate([self._s, d_real]),
                                     return_inverse=True)
            inv = inv.reshape(-1)
        else:
            self.uv, inv = np.empty(0, np.int64), None
        self._ok = len(self.uv) < (1 << 31)
        if self._ok and inv is not None:
            self._sd_all = inv[: len(self._s)]
            self._dd_all = np.zeros(len(self._d), np.int64)
            self._dd_all[is_e] = inv[len(self._s):]
        else:
            self._sd_all = self._dd_all = None
        nv = len(self.uv)
        # dense vertex fold state
        self.v_lat = np.full(nv, INT64_MIN, np.int64)
        self.v_alive = np.zeros(nv, bool)
        self.v_first = np.full(nv, INT64_MIN, np.int64)
        self.v_seen = np.zeros(nv, bool)
        # edge fold state keyed by packed (dense_s, dense_d); enc-sorted
        self.e_enc = np.empty(0, np.int64)
        self.e_lat = np.empty(0, np.int64)
        self.e_alive = np.empty(0, bool)
        self.e_first = np.empty(0, np.int64)
        # the same pair keys packed (dense_d, dense_s), kept sorted — the
        # dst-incidence index for tombstone joins
        self.e_enc_dst = np.empty(0, np.int64)
        # preseed: start the pair table with EVERY pair the log ever
        # mentions (alive=False, times at the sentinel). No pair is ever
        # "fresh" afterwards, so the per-hop sorted inserts and the
        # history-vs-new-pair joins vanish; the per-hop incident join over
        # all pairs generates exactly build_view's all-pairs × all-deletes
        # killList marks (a dead mark before a pair's first add loses to
        # the later add in the latest-wins fold — same outcome as the
        # historical join it replaces). The columnar engines opt in;
        # semantics stay bit-identical (tested against build_view).
        self.e_seen = np.empty(0, bool)   # pair has real marks (firsts set)
        self._preseeded = False
        if preseed_pairs and self._ok and is_e.any():
            enc_all = np.unique(self._pack(self._sd_all[is_e],
                                           self._dd_all[is_e]))
            self.e_enc = enc_all
            self.e_lat = np.full(len(enc_all), INT64_MIN, np.int64)
            self.e_alive = np.zeros(len(enc_all), bool)
            self.e_first = np.full(len(enc_all), INT64_MIN, np.int64)
            self.e_seen = np.zeros(len(enc_all), bool)
            self.e_enc_dst = np.sort(
                ((enc_all & _ENC_MASK) << _ENC_SHIFT)
                | (enc_all >> _ENC_SHIFT))
            self._preseeded = True
        # delete history: (dense vertex, time), sorted by vertex
        self.dh_v = np.empty(0, np.int64)
        self.dh_t = np.empty(0, np.int64)
        # in-time add-event row lists (property joins), ascending, grown
        # per delta — deltas are selected by event TIME, so their row
        # indices interleave with earlier hops' and need a sorted merge
        self._ea_rows = np.empty(0, np.int64)
        self._va_rows = np.empty(0, np.int64)
        self.t_prev: int | None = None
        # per-hop row selection: binary search when the log is time-sorted
        # (bulk loads, replayed dumps), O(N) boolean scan otherwise
        self._t_sorted = bool(
            len(self._t) == 0 or bool((self._t[:-1] <= self._t[1:]).all()))
        # last hop's touched-entity delta (dense vertex indices + packed edge
        # keys with their POST-update fold state) — consumed by the columnar
        # engine (engine/hopbatch.py), which ships only these O(delta) rows
        # to the device instead of fresh O(m) arrays
        self.last_delta: dict | None = None

    # ---- helpers ----

    def _dense(self, ids: np.ndarray) -> np.ndarray:
        return np.searchsorted(self.uv, ids)

    def _pack(self, ds: np.ndarray, dd: np.ndarray) -> np.ndarray:
        return (ds << _ENC_SHIFT) | dd

    def _incident(self, enc_sorted: np.ndarray, dv: np.ndarray, dt: np.ndarray,
                  flip: bool):
        """Dead marks (enc, t) for pairs in `enc_sorted` whose FIRST packed
        component is in dv. flip=True means enc_sorted is (d, s)-packed and
        results are re-packed as (s, d)."""
        lo = np.searchsorted(enc_sorted, dv << _ENC_SHIFT, side="left")
        hi = np.searchsorted(enc_sorted, (dv + 1) << _ENC_SHIFT, side="left")
        rows, qidx = _expand_ranges(lo, hi)
        enc = enc_sorted[rows]
        if flip:
            enc = ((enc & _ENC_MASK) << _ENC_SHIFT) | (enc >> _ENC_SHIFT)
        return enc, dt[qidx]

    # ---- the sweep ----

    def view_at(self, time: int) -> GraphView:
        time = int(time)
        if not self._ok or (self.t_prev is not None and time < self.t_prev):
            return build_view(self.log, time,
                              include_occurrences=self.include_occurrences,
                              pad=self.pad)
        if self.t_prev is None or time > self.t_prev:
            self._advance(time)
        return self._emit(time)

    def _advance(self, time: int) -> None:
        t_prev = self.t_prev if self.t_prev is not None else np.iinfo(np.int64).min
        if self._t_sorted:
            lo = 0 if t_prev == np.iinfo(np.int64).min \
                else int(np.searchsorted(self._t, t_prev, side="right"))
            hi = int(np.searchsorted(self._t, time, side="right"))
            rows = np.arange(lo, hi)
        else:
            sel = (self._t <= time) if t_prev == np.iinfo(np.int64).min \
                else ((self._t > t_prev) & (self._t <= time))
            rows = np.flatnonzero(sel)
        self.t_prev = time
        if len(rows) == 0:
            self.last_delta = _EMPTY_DELTA
            return
        t = self._t[rows]
        k = self._k[rows]
        s = self._s[rows]
        d = self._d[rows]
        is_va = k == VERTEX_ADD
        is_vd = k == VERTEX_DELETE
        is_ea = k == EDGE_ADD
        is_ed = k == EDGE_DELETE
        uvd = uenc = None  # touched entities, recorded into last_delta below

        if self.track_rows:
            new_ea = rows[is_ea]
            new_va = rows[is_va]
            self._ea_rows = np.insert(
                self._ea_rows, np.searchsorted(self._ea_rows, new_ea), new_ea)
            self._va_rows = np.insert(
                self._va_rows, np.searchsorted(self._va_rows, new_va), new_va)

        if self._sd_all is not None:
            sd, dd = self._sd_all[rows], self._dd_all[rows]
            ds_ea, dd_ea = sd[is_ea], dd[is_ea]
            dv_del = sd[is_vd]
            dv_add = sd[is_va]
            ds_ed, dd_ed = sd[is_ed], dd[is_ed]
        else:
            ds_ea = self._dense(s[is_ea])
            dd_ea = self._dense(d[is_ea])
            dv_del = self._dense(s[is_vd])
            dv_add = self._dense(s[is_va])
            ds_ed = self._dense(s[is_ed])
            dd_ed = self._dense(d[is_ed])
        t_del = t[is_vd]

        # -- vertex delta fold: adds + edge-endpoint revivals vs deletes --
        v_ids = np.concatenate([dv_add, ds_ea, dd_ea, dv_del])
        v_t = np.concatenate([t[is_va], t[is_ea], t[is_ea], t_del])
        v_al = np.zeros(len(v_ids), bool)
        v_al[: len(v_ids) - len(dv_del)] = True

        if len(v_ids):
            (uvd,), dlat, dalive, dfirst = _fold_latest((v_ids,), v_t, v_al)
            # delta times are strictly later than any prior mark, so the
            # delta's latest wins outright and firsts only fill unseen slots
            self.v_lat[uvd] = dlat
            self.v_alive[uvd] = dalive
            self.v_first[uvd] = np.where(self.v_seen[uvd],
                                         self.v_first[uvd], dfirst)
            self.v_seen[uvd] = True

        # -- edge delta marks: own add/delete events --
        enc_ea = self._pack(ds_ea, dd_ea)
        enc_ed = self._pack(ds_ed, dd_ed)
        marks_enc = [enc_ea, enc_ed]
        marks_t = [t[is_ea], t[is_ed]]
        marks_a = [np.ones(len(enc_ea), bool), np.zeros(len(enc_ed), bool)]

        delta_enc = np.unique(np.concatenate([enc_ea, enc_ed])) \
            if (len(enc_ea) or len(enc_ed)) else np.empty(0, np.int64)
        if self._preseeded:
            new_enc = delta_enc[:0]   # every pair is in the table already
        else:
            pos = np.searchsorted(self.e_enc, delta_enc)
            pos_c = np.clip(pos, 0, max(len(self.e_enc) - 1, 0))
            known = (self.e_enc[pos_c] == delta_enc) if len(self.e_enc) \
                else np.zeros(len(delta_enc), bool)
            new_enc = delta_enc[~known]

        if len(dv_del):
            # delta deletes × (pairs known before this hop ∪ NEW delta pairs)
            for enc_arr, flip in ((self.e_enc, False), (self.e_enc_dst, True)):
                enc_ts, t_ts = self._incident(enc_arr, dv_del, t_del, flip)
                marks_enc.append(enc_ts)
                marks_t.append(t_ts)
                marks_a.append(np.zeros(len(enc_ts), bool))
            new_by_dst = np.sort(
                ((new_enc & _ENC_MASK) << _ENC_SHIFT) | (new_enc >> _ENC_SHIFT))
            for enc_arr, flip in ((new_enc, False), (new_by_dst, True)):
                enc_ts, t_ts = self._incident(enc_arr, dv_del, t_del, flip)
                marks_enc.append(enc_ts)
                marks_t.append(t_ts)
                marks_a.append(np.zeros(len(enc_ts), bool))

        if len(new_enc) and len(self.dh_v):
            # historical deletes × pairs first seen in this delta
            ns = new_enc >> _ENC_SHIFT
            nd = new_enc & _ENC_MASK
            for comp in (ns, nd):
                lo = np.searchsorted(self.dh_v, comp, side="left")
                hi = np.searchsorted(self.dh_v, comp, side="right")
                hrows, qidx = _expand_ranges(lo, hi)
                marks_enc.append(new_enc[qidx])
                marks_t.append(self.dh_t[hrows])
                marks_a.append(np.zeros(len(hrows), bool))

        all_enc = np.concatenate(marks_enc)
        epos_known = None
        if len(all_enc):
            all_t = np.concatenate(marks_t)
            all_a = np.concatenate(marks_a)
            (uenc,), elat_d, ealive_d, efirst_d = _fold_latest((all_enc,), all_t, all_a)
            upos = np.searchsorted(self.e_enc, uenc)
            upos_c = np.clip(upos, 0, max(len(self.e_enc) - 1, 0))
            uknown = (self.e_enc[upos_c] == uenc) if len(self.e_enc) \
                else np.zeros(len(uenc), bool)
            # existing pairs: delta marks are strictly later — overwrite
            # (firsts only fill slots that never saw a real mark — preseeded
            # pairs exist in the table before their first event)
            kpos = upos_c[uknown]
            self.e_lat[kpos] = elat_d[uknown]
            self.e_alive[kpos] = ealive_d[uknown]
            self.e_first[kpos] = np.where(self.e_seen[kpos],
                                          self.e_first[kpos],
                                          efirst_d[uknown])
            self.e_seen[kpos] = True
            # new pairs: insert (fold already merged their full history,
            # including historical tombstones, so firsts are exact)
            fresh = ~uknown
            if not fresh.any():
                # positions are final (no inserts shifted them): last_delta
                # reuses them instead of re-searching the whole table
                epos_known = upos_c
            if fresh.any():
                at = upos[fresh]
                self.e_enc = np.insert(self.e_enc, at, uenc[fresh])
                self.e_lat = np.insert(self.e_lat, at, elat_d[fresh])
                self.e_alive = np.insert(self.e_alive, at, ealive_d[fresh])
                self.e_first = np.insert(self.e_first, at, efirst_d[fresh])
                self.e_seen = np.insert(self.e_seen, at,
                                        np.ones(fresh.sum(), bool))
                enc2 = (((uenc[fresh] & _ENC_MASK) << _ENC_SHIFT)
                        | (uenc[fresh] >> _ENC_SHIFT))
                enc2 = np.sort(enc2)
                self.e_enc_dst = np.insert(
                    self.e_enc_dst, np.searchsorted(self.e_enc_dst, enc2), enc2)

        if len(dv_del) and not self._preseeded:
            # the delete history only feeds the new-pair join, which a
            # preseeded table never takes (no pair is ever new)
            self.dh_v = np.concatenate([self.dh_v, dv_del])
            self.dh_t = np.concatenate([self.dh_t, t_del])
            order = np.argsort(self.dh_v, kind="stable")
            self.dh_v = self.dh_v[order]
            self.dh_t = self.dh_t[order]

        # Touched-entity delta with POST-update fold state, read back from the
        # running arrays so it is correct no matter which code path (known
        # pair overwrite / fresh insert / tombstone join) produced the value.
        tv = uvd if uvd is not None else np.empty(0, np.int64)
        te = uenc if uenc is not None else np.empty(0, np.int64)
        epos = epos_known if epos_known is not None \
            else np.searchsorted(self.e_enc, te)
        self.last_delta = {
            "v_idx": tv, "v_lat": self.v_lat[tv],
            "v_alive": self.v_alive[tv], "v_first": self.v_first[tv],
            "e_enc": te, "e_lat": self.e_lat[epos],
            "e_alive": self.e_alive[epos], "e_first": self.e_first[epos],
        }

    def _emit(self, time: int) -> GraphView:
        if not self.track_rows:
            raise RuntimeError(
                "this SweepBuilder was built with track_rows=False (fold "
                "state only — the columnar engine); use a default "
                "one to emit GraphViews")
        act_dense = np.flatnonzero(self.v_alive)
        act_vids = self.uv[act_dense]  # uv ascending ⇒ dense order = id order
        act_latest = self.v_lat[act_dense]
        act_first = self.v_first[act_dense]

        alive = self.e_alive
        enc = self.e_enc[alive]
        ae_s = self.uv[enc >> _ENC_SHIFT]
        ae_d = self.uv[enc & _ENC_MASK]
        ae_latest = self.e_lat[alive]
        ae_first = self.e_first[alive]
        # local endpoint indices via the dense→local LUT (enc order is
        # (src, dst)-major, so one argsort of the flipped packing gives the
        # (dst, src) order _assemble_view needs)
        lut = np.full(len(self.uv), -1, np.int32)
        lut[act_dense] = np.arange(len(act_dense), dtype=np.int32)
        src_loc = lut[enc >> _ENC_SHIFT]
        dst_loc = lut[enc & _ENC_MASK]
        eorder = np.argsort(
            (dst_loc.astype(np.int64) << _ENC_SHIFT) | src_loc, kind="stable")
        locs = (src_loc, dst_loc, eorder)

        occ = None
        if self.include_occurrences:
            rows = self._ea_rows
            occ = (rows, self._t[rows], self._s[rows], self._d[rows])
            if self._sd_all is not None:
                # the events' local endpoints off the dense dictionary
                occ += ((lut[self._sd_all[rows]], lut[self._dd_all[rows]]),)
        return _assemble_view(
            self.log, time, act_vids, act_latest, act_first,
            ae_s, ae_d, ae_latest, ae_first, self.pad,
            self._ea_rows, self._va_rows, occ, locs,
        )
