"""Event log → immutable graph views.

Replaces the reference's ``GraphLens`` family
(``core/analysis/API/GraphLenses/{GraphLens,ViewLens,WindowLens}.scala``): a
view at time T is not a filter over live mutable state gated by watermarks,
but a vectorised fold over the sorted event log producing flat arrays.

Window semantics match ``Entity.aliveAtWithWindow`` (``Entity.scala:193-201``):
an entity is in-window(T, W) iff its latest history point at or before T is an
"alive" state AND that point's time is >= T - W. Because the check only looks
at the latest point, window masks for many window sizes are pure comparisons
against the per-entity ``latest_time`` array — the reference's
``WindowLens.shrinkWindow`` monotone-refinement trick (``WindowLens.scala:59-65``)
becomes a stacked boolean mask, essentially free.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from ..native import lib as _native
from .events import EDGE_ADD, EDGE_DELETE, VERTEX_ADD, VERTEX_DELETE, EventLog

INT64_MIN = np.iinfo(np.int64).min


def _round_up(n: int, mult: int) -> int:
    return ((max(n, 1) + mult - 1) // mult) * mult


def _pad_bucket(n: int) -> int:
    """Bucketed padding (shared shapes across small logs): next power of
    two."""
    if n <= 8:
        return 8
    return 1 << int(np.ceil(np.log2(n)))


def _last_per_group(sort_order: np.ndarray, group_starts_sorted: np.ndarray) -> np.ndarray:
    """Given a lexsort order and boolean new-group marks over the sorted rows,
    return (in sorted coordinates) the index of the LAST row of each group."""
    n = len(sort_order)
    starts = np.flatnonzero(group_starts_sorted)
    ends = np.empty_like(starts)
    ends[:-1] = starts[1:] - 1
    ends[-1] = n - 1
    return ends


def _fold_latest(
    keys: tuple[np.ndarray, ...],
    times: np.ndarray,
    alive: np.ndarray,
):
    """Deterministic latest-state fold over an event stream.

    keys: one or more int64 key columns identifying the entity.
    Tie-break at equal (entity, time): dead (alive=0) wins — sort alive rows
    first so the last row of each (entity, time) run is the tombstone if any.

    Returns (unique_keys_cols, latest_time, latest_alive, first_time) with one
    row per distinct entity, keys sorted ascending.
    """
    if len(times) == 0:
        empty = tuple(np.empty(0, np.int64) for _ in keys)
        return empty, np.empty(0, np.int64), np.empty(0, bool), np.empty(0, np.int64)
    folded = _native.fold_latest(keys, times, alive)
    if folded is not None:
        return folded
    # lexsort: primary = keys (last first), then time, then alive (dead last)
    order = np.lexsort((~alive, times) + tuple(reversed(keys)))
    sk = [k[order] for k in keys]
    st = times[order]
    sa = alive[order]
    ng = np.zeros(len(st), dtype=bool)
    ng[0] = True
    same = np.ones(len(st) - 1, dtype=bool)
    for k in sk:
        same &= k[1:] == k[:-1]
    ng[1:] = ~same
    last = _last_per_group(order, ng)
    first = np.flatnonzero(ng)
    out_keys = tuple(k[last] for k in sk)
    return out_keys, st[last], sa[last], st[first]


@dataclass
class GraphView:
    """Immutable, padded snapshot of the graph at time T.

    All arrays are numpy; the padded sizes are bucketed powers of two.
    Edges are stored COO sorted by (dst, src) — the natural order
    for combine-at-destination message passing (segment ops) — with an
    ``out_order`` permutation giving (src, dst) order for out-edge CSR.
    """

    time: int
    n_pad: int                      # padded vertex count
    m_pad: int                      # padded edge count
    n_active: int                   # real vertex count
    m_active: int                   # real edge count
    vids: np.ndarray                # i64[n_pad]  global ids, -1 pad
    v_mask: np.ndarray              # bool[n_pad]
    v_latest_time: np.ndarray       # i64[n_pad]  latest history point <= T
    v_first_time: np.ndarray        # i64[n_pad]  earliest history point
    e_src: np.ndarray               # i32[m_pad]  local index, 0 pad
    e_dst: np.ndarray               # i32[m_pad]  local index, 0 pad
    e_mask: np.ndarray              # bool[m_pad]
    e_latest_time: np.ndarray       # i64[m_pad]  latest alive-point <= T
    e_first_time: np.ndarray        # i64[m_pad]  earliest history point
    out_order: np.ndarray           # i32[m_pad]  permutation into (src,dst) order
    in_indptr: np.ndarray           # i32[n_pad+1] CSR over (dst-sorted) edges
    out_indptr: np.ndarray          # i32[n_pad+1] CSR over out_order edges
    out_deg: np.ndarray             # i32[n_pad]
    in_deg: np.ndarray              # i32[n_pad]
    # optional multigraph occurrence arrays (one row per edge-add event of
    # an edge alive at T; TaintTracking), (dst, src)-sorted like the edges
    occ_src: np.ndarray | None = None   # i32[o_pad], pad n_pad-1
    occ_dst: np.ndarray | None = None   # i32[o_pad], pad n_pad-1
    occ_time: np.ndarray | None = None  # i64[o_pad], pad INT64_MIN
    occ_mask: np.ndarray | None = None  # bool[o_pad]
    _occ_rows: np.ndarray | None = field(default=None, repr=False)  # i64[o_pad] log rows, -1 pad
    _log: EventLog | None = field(default=None, repr=False)
    _eadd_rows: np.ndarray | None = field(default=None, repr=False)
    _vadd_rows: np.ndarray | None = field(default=None, repr=False)

    # ---- window machinery (WindowLens.scala analogue) ----

    def window_masks(self, windows) -> tuple[np.ndarray, np.ndarray]:
        """Masks for a batch of window sizes: (v_masks[K,n], e_masks[K,m]).

        Pure comparisons on latest-time arrays; descending windows are
        monotone refinements (shrinkWindow semantics) by construction.
        """
        w = np.asarray(windows, np.int64).reshape(-1, 1)
        lo = self.time - w  # inclusive bound: latest_time >= T - W
        v = self.v_mask[None, :] & (self.v_latest_time[None, :] >= lo)
        e = self.e_mask[None, :] & (self.e_latest_time[None, :] >= lo)
        return v, e

    # ---- property materialisation ----

    def vertex_prop(self, name: str, default: float = np.nan) -> np.ndarray:
        """f64[n_pad]: value of the latest property update <= T per vertex
        (immutable keys: the earliest value — ImmutableProperty.scala:9-11)."""
        return _materialise_prop(
            self._log, self._vadd_rows, name, self.time,
            keys=(self._log.column("src")[self._vadd_rows],),
            lookup_keys=(self.vids,), default=default,
        )

    def edge_prop(self, name: str, default: float = np.nan) -> np.ndarray:
        gsrc = self.vids[self.e_src]
        gdst = self.vids[self.e_dst]
        log = self._log
        rows = self._eadd_rows
        return _materialise_prop(
            log, rows, name, self.time,
            keys=(log.column("src")[rows], log.column("dst")[rows]),
            lookup_keys=(gsrc, gdst), default=default,
        )

    def occ_prop(self, name: str, default: float = np.nan) -> np.ndarray:
        """f64[o_pad]: the property value attached to each occurrence's OWN
        edge-add event (per-transaction values, e.g. the amount a
        value-weighted taint gates on) — unlike ``edge_prop``, which folds
        to the latest value per deduplicated edge
        (``raphtory_tpu/core/snapshot.py:197``)."""
        rows = self._occ_rows
        if rows is None:
            raise ValueError("view was built without include_occurrences")
        out = np.full(len(rows), default, np.float64)
        log = self._log
        if log is None or name not in log.props._key_ids:
            return out
        kid = log.props._key_ids[name]
        pk = log.props.column("key")
        sel = (pk == kid) & (log.props.column("tag") == log.props.NUM_TAG)
        if not sel.any():
            return out
        ev = log.props.column("event")[sel]
        val = log.props.column("num")[sel]
        order = np.argsort(ev, kind="stable")  # last write per event wins
        ev, val = ev[order], val[order]
        pos = np.searchsorted(ev, rows, side="right") - 1
        ok = (pos >= 0) & (rows >= 0)
        ok &= ev[np.clip(pos, 0, None)] == rows
        out[ok] = val[pos[ok]]
        return out

    def local_index(self, global_ids) -> np.ndarray:
        """Map global vertex ids → local indices (-1 if absent/padded)."""
        # vids[:n_active] is sorted ascending by construction
        return _lex_lookup((self.vids[: self.n_active],),
                           (np.asarray(global_ids, np.int64),)
                           ).astype(np.int64)


def _materialise_prop(log, rows, name, T, keys, lookup_keys, default):
    """Latest (or earliest, for immutable keys) numeric property value <= T
    (f64 output)."""
    n_out = len(lookup_keys[0])
    out = np.full(n_out, default, np.float64)
    if log is None or name not in log.props._key_ids:
        return out
    kid = log.props._key_ids[name]
    pe = log.props.column("event")
    pk = log.props.column("key")
    ptag = log.props.column("tag")
    sel = (pk == kid) & (ptag == log.props.NUM_TAG)
    if not sel.any():
        return out
    ev = pe[sel]
    val = log.props.column("num")[sel]
    # join prop rows onto the event subset `rows` (sorted ascending)
    pos = np.searchsorted(rows, ev)
    pos = np.clip(pos, 0, len(rows) - 1)
    hit = rows[pos] == ev
    ev, val, pos = ev[hit], val[hit], pos[hit]
    t = log.column("time")[ev]
    intime = t <= T
    ev, val, pos, t = ev[intime], val[intime], pos[intime], t[intime]
    if len(ev) == 0:
        return out
    kcols = tuple(k[pos] for k in keys)
    # latest per key (or earliest if immutable): sort by (keys, time, row)
    order = np.lexsort((ev, t) + tuple(reversed(kcols)))
    sk = [k[order] for k in kcols]
    sval = val[order]
    ng = np.zeros(len(order), bool)
    ng[0] = True
    same = np.ones(len(order) - 1, bool)
    for k in sk:
        same &= k[1:] == k[:-1]
    ng[1:] = ~same
    if log.props.is_immutable(kid):
        pick = np.flatnonzero(ng)
    else:
        pick = _last_per_group(order, ng)
    ukeys = tuple(k[pick] for k in sk)
    uval = sval[pick]
    # look up each output key among ukeys (sorted lexicographically)
    out_idx = _lex_lookup(ukeys, lookup_keys)
    found = out_idx >= 0
    out[found] = uval[out_idx[found]]
    return out


def _lex_lookup(sorted_keys: tuple, query_keys: tuple) -> np.ndarray:
    """Index of each query tuple in lexicographically sorted key columns, -1 if
    missing. Encodes pairs by rank to use searchsorted."""
    if len(sorted_keys[0]) == 0:
        return np.full(len(query_keys[0]), -1, np.int64)
    if len(sorted_keys) == 1:
        base, q = sorted_keys[0], query_keys[0]
        pos = np.searchsorted(base, q)
        pos = np.clip(pos, 0, len(base) - 1)
        return np.where(base[pos] == q, pos, -1)
    # two-column case: binary search on the first col, then the second within runs
    b1, b2 = sorted_keys
    q1, q2 = query_keys
    looked = _native.lex_lookup2(b1, b2, q1, q2)
    if looked is not None:
        return looked
    # vectorised fallback: rank-encode both columns over the union of base
    # and query values (ranks are order-preserving, so the packed base stays
    # lex-sorted and never overflows the way raw ~2^62 ids would), then one
    # searchsorted over the packed pairs
    u2, inv2 = np.unique(np.concatenate([b2, q2]), return_inverse=True)
    r_b2, r_q2 = inv2[:len(b2)], inv2[len(b2):]
    u1, inv1 = np.unique(np.concatenate([b1, q1]), return_inverse=True)
    r_b1, r_q1 = inv1[:len(b1)], inv1[len(b1):]
    stride = np.int64(len(u2))
    packed_b = r_b1.astype(np.int64) * stride + r_b2
    packed_q = r_q1.astype(np.int64) * stride + r_q2
    pos = np.searchsorted(packed_b, packed_q)
    pos = np.clip(pos, 0, len(packed_b) - 1)
    return np.where(packed_b[pos] == packed_q, pos, -1)


def build_view(
    log: EventLog,
    time: int,
    *,
    include_occurrences: bool = False,
    pad: str = "pow2",
) -> GraphView:
    """Fold the event log into a GraphView at `time`.

    This is the semantic core: the deterministic multiset fold described in
    ``events.py`` (vertex revive-via-edge-add, vertex-delete → incident edge
    tombstones, delete-wins tie-break). ``include_occurrences`` attaches
    the multigraph occurrence rows (``_attach_occurrences``).
    """
    log = log.pin()  # consistent columns; immune to concurrent compaction
    t_all = log.column("time")
    k_all = log.column("kind")
    s_all = log.column("src")
    d_all = log.column("dst")

    intime = t_all <= time
    rows = np.flatnonzero(intime)
    t = t_all[rows]
    k = k_all[rows]
    s = s_all[rows]
    d = d_all[rows]

    is_va = k == VERTEX_ADD
    is_vd = k == VERTEX_DELETE
    is_ea = k == EDGE_ADD
    is_ed = k == EDGE_DELETE

    # ---- vertex stream: adds + edge-endpoint revivals vs deletes ----
    v_ids = np.concatenate([s[is_va], s[is_ea], d[is_ea], s[is_vd]])
    v_t = np.concatenate([t[is_va], t[is_ea], t[is_ea], t[is_vd]])
    n_alive_marks = int(is_va.sum() + 2 * is_ea.sum())
    v_alive = np.zeros(len(v_ids), bool)
    v_alive[:n_alive_marks] = True
    (uvid,), v_latest_t, v_is_alive, v_first_t = _fold_latest((v_ids,), v_t, v_alive)

    active = v_is_alive
    act_vids = uvid[active]
    act_latest = v_latest_t[active]
    act_first = v_first_t[active]

    # ---- edge stream: own add/delete + endpoint-delete tombstones ----
    e_s = np.concatenate([s[is_ea], s[is_ed]])
    e_d = np.concatenate([d[is_ea], d[is_ed]])
    e_t = np.concatenate([t[is_ea], t[is_ed]])
    e_alive = np.zeros(len(e_s), bool)
    e_alive[: int(is_ea.sum())] = True

    # distinct edges ever seen (any time — folds correctly regardless of order)
    if is_ea.any() or is_ed.any():
        up_s, up_d = _unique_pairs(e_s, e_d)
    else:
        up_s = up_d = np.empty(0, np.int64)

    del_v = s[is_vd]
    del_t = t[is_vd]
    if len(del_v) and len(up_s):
        ts_s, ts_d, ts_t = _endpoint_tombstones(up_s, up_d, del_v, del_t)
        e_s = np.concatenate([e_s, ts_s])
        e_d = np.concatenate([e_d, ts_d])
        e_t = np.concatenate([e_t, ts_t])
        e_alive = np.concatenate([e_alive, np.zeros(len(ts_s), bool)])

    (ues, ued), e_latest_t, e_is_alive, e_first_t = _fold_latest((e_s, e_d), e_t, e_alive)
    ae_s = ues[e_is_alive]
    ae_d = ued[e_is_alive]
    ae_latest = e_latest_t[e_is_alive]
    ae_first = e_first_t[e_is_alive]

    occ = None
    if include_occurrences:
        occ = (rows[is_ea], t[is_ea], s[is_ea], d[is_ea])
    return _assemble_view(
        log, int(time), act_vids, act_latest, act_first,
        ae_s, ae_d, ae_latest, ae_first, pad,
        rows[is_ea], rows[is_va], occ,
    )


def _unique_pairs(s: np.ndarray, d: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Distinct (s, d) pairs, lex-sorted. (np.unique(axis=0) sorts a structured
    view — ~10x slower than a plain lexsort on the two columns.)"""
    zeros = np.zeros(len(s), np.int64)
    order = _native.sort_events((s, d), zeros, zeros.astype(bool))
    if order is None:
        order = np.lexsort((d, s))
    ss, dd = s[order], d[order]
    keep = np.ones(len(ss), bool)
    keep[1:] = (ss[1:] != ss[:-1]) | (dd[1:] != dd[:-1])
    return ss[keep], dd[keep]


def _assemble_view(
    log, time, act_vids, act_latest, act_first,
    ae_s, ae_d, ae_latest, ae_first, pad,
    eadd_rows, vadd_rows, occ=None, locs=None,
) -> GraphView:
    """Alive vertex/edge fold state → padded device-ready GraphView.

    Shared tail of ``build_view`` and the incremental ``SweepBuilder``
    (``core/sweep.py``); `occ` is (ea_rows, ea_t, ea_s, ea_d) of the
    in-time edge-add events when occurrence arrays are asked for. `locs` is an
    optional (src_loc, dst_loc, eorder) precomputation: local endpoint
    indices for the alive edges plus the (dst, src) sort permutation — the
    sweep derives these O(1)-ish from its dense dictionary, skipping the
    searchsorted/lexsort here."""
    n_active = len(act_vids)
    m_active = len(ae_s)

    # ---- local index space ----
    n_pad = _pad_bucket(n_active) if pad == "pow2" else _round_up(n_active, 8)
    vids = np.full(n_pad, -1, np.int64)
    vids[:n_active] = act_vids  # sorted ascending by construction of the fold
    v_mask = np.zeros(n_pad, bool)
    v_mask[:n_active] = True
    v_latest = np.full(n_pad, INT64_MIN, np.int64)
    v_latest[:n_active] = act_latest
    v_first = np.full(n_pad, INT64_MIN, np.int64)
    v_first[:n_active] = act_first

    if locs is None:
        # endpoints of alive edges are guaranteed alive (fold invariant)
        src_loc = np.searchsorted(act_vids, ae_s).astype(np.int32)
        dst_loc = np.searchsorted(act_vids, ae_d).astype(np.int32)
        # sort edges by (dst, src) — combine-at-destination order
        eorder = np.lexsort((src_loc, dst_loc))
    else:
        src_loc, dst_loc, eorder = locs
    src_loc = src_loc[eorder]
    dst_loc = dst_loc[eorder]
    ae_latest = ae_latest[eorder]
    ae_first = ae_first[eorder]

    m_pad = _pad_bucket(m_active) if pad == "pow2" else _round_up(m_active, 8)
    # Padding rows use dst index n_pad-1 (the max) so the dst-sorted order
    # survives padding — destination-CSR consumers rely on it. Padded rows
    # carry combiner-neutral payloads, so where they land is harmless.
    e_src = np.full(m_pad, n_pad - 1, np.int32)
    e_dst = np.full(m_pad, n_pad - 1, np.int32)
    e_mask = np.zeros(m_pad, bool)
    e_lat = np.full(m_pad, INT64_MIN, np.int64)
    e_fst = np.full(m_pad, INT64_MIN, np.int64)
    e_src[:m_active] = src_loc
    e_dst[:m_active] = dst_loc
    e_mask[:m_active] = True
    e_lat[:m_active] = ae_latest
    e_fst[:m_active] = ae_first

    out_order32 = np.zeros(m_pad, np.int32)
    if locs is None:
        oo = np.lexsort((dst_loc, src_loc)).astype(np.int32)
    else:
        # input edges were (src, dst)-sorted, so among the dst-sorted rows
        # the src-major order is just the inverse of `eorder` (pairs are
        # deduped — no ties to break)
        oo = np.empty(m_active, np.int32)
        oo[eorder] = np.arange(m_active, dtype=np.int32)
    out_order32[:m_active] = oo
    if m_pad > m_active:
        out_order32[m_active:] = np.arange(m_active, m_pad, dtype=np.int32)

    in_indptr = _indptr(dst_loc, n_pad)
    out_indptr = _indptr(src_loc[oo], n_pad)
    out_deg = np.diff(out_indptr).astype(np.int32)
    in_deg = np.diff(in_indptr).astype(np.int32)

    view = GraphView(
        time=int(time),
        n_pad=n_pad, m_pad=m_pad, n_active=n_active, m_active=m_active,
        vids=vids, v_mask=v_mask, v_latest_time=v_latest, v_first_time=v_first,
        e_src=e_src, e_dst=e_dst, e_mask=e_mask,
        e_latest_time=e_lat, e_first_time=e_fst,
        out_order=out_order32, in_indptr=in_indptr, out_indptr=out_indptr,
        out_deg=out_deg, in_deg=in_deg,
        _log=log,
        _eadd_rows=eadd_rows,
        _vadd_rows=vadd_rows,
    )
    if occ is not None:
        _attach_occurrences(view, *occ)
    return view


def _expand_ranges(lo: np.ndarray, hi: np.ndarray):
    """(row_indices, query_index_per_row) for per-query ranges [lo, hi)."""
    cnt = hi - lo
    total = int(cnt.sum())
    if total == 0:
        return np.empty(0, np.int64), np.empty(0, np.int64)
    rep = np.repeat(np.arange(len(lo)), cnt)
    offs = np.arange(total) - np.repeat(np.cumsum(cnt) - cnt, cnt)
    return np.repeat(lo, cnt) + offs, rep


def _endpoint_tombstones(up_s, up_d, del_v, del_t):
    """For every (vertex-delete v@t) × (distinct edge incident to v): a dead
    mark (s, d, t). Vectorised join via sorted incidence lists."""
    out_s, out_d, out_t = [], [], []
    for key in (up_s, up_d):
        order = np.argsort(key, kind="stable")
        skey = key[order]
        lo = np.searchsorted(skey, del_v, side="left")
        hi = np.searchsorted(skey, del_v, side="right")
        srows, qidx = _expand_ranges(lo, hi)
        if len(srows) == 0:
            continue
        rows = order[srows]
        out_s.append(up_s[rows])
        out_d.append(up_d[rows])
        out_t.append(del_t[qidx])
    if not out_s:
        z = np.empty(0, np.int64)
        return z, z, z
    return (np.concatenate(out_s), np.concatenate(out_d), np.concatenate(out_t))


def _indptr(sorted_ids: np.ndarray, n: int) -> np.ndarray:
    counts = np.bincount(sorted_ids, minlength=n).astype(np.int32)
    indptr = np.zeros(n + 1, np.int32)
    np.cumsum(counts, out=indptr[1:])
    return indptr


def _attach_occurrences(view: GraphView, ea_rows, ea_t, ea_s, ea_d,
                        locs=None) -> None:
    """Multigraph occurrence arrays (``raphtory_tpu/core/snapshot.py:655``):
    one row per edge-add event whose edge is alive in the view — the
    analogue of iterating raw edge history
    (``VertexVisitor.getOutgoingNeighborsAfter``, ``EdgeVisitor.getTimeAfter``)
    that temporal algorithms like EthereumTaintTracking read. Rows are
    (dst, src)-sorted (stable, so equal pairs keep event order); the pad
    rows have dst = src = n_pad-1, ``occ_mask`` False and ``occ_time``
    INT64_MIN. ``locs`` is an optional (src_loc, dst_loc) of the events'
    local endpoint indices (-1 where the vertex is not in the view), which
    the sweep reads off its dense dictionary instead of searching.

    The reference filters the events by a search of each one's (dst, src)
    key among the alive edges, then lexsorts the survivors; here the keys
    are sorted first (a stable sort of the packed key is that lexsort) and
    searched in order — the same rows in the same order, without the
    cache misses of unsorted queries."""
    if locs is None:
        sl, dl = view.local_index(ea_s), view.local_index(ea_d)
    else:
        sl, dl = (np.asarray(a, np.int64) for a in locs)
    cand = np.flatnonzero((sl >= 0) & (dl >= 0))
    key = dl[cand] * (view.n_pad + 1) + sl[cand]
    order = np.argsort(key, kind="stable")
    cand, key = cand[order], key[order]
    # restrict to occurrences of edges alive at T
    key_view = view.e_dst.astype(np.int64) * (view.n_pad + 1) + view.e_src
    alive_keys = np.sort(key_view[view.e_mask])
    if len(alive_keys):
        pos = np.minimum(np.searchsorted(alive_keys, key),
                         len(alive_keys) - 1)
        idx = cand[alive_keys[pos] == key]
    else:
        idx = cand[:0]
    o = len(idx)
    o_pad = _pad_bucket(o)
    occ_src = np.full(o_pad, view.n_pad - 1, np.int32)
    occ_dst = np.full(o_pad, view.n_pad - 1, np.int32)
    occ_time = np.full(o_pad, INT64_MIN, np.int64)
    occ_mask = np.zeros(o_pad, bool)
    occ_rows = np.full(o_pad, -1, np.int64)
    occ_src[:o] = sl[idx]
    occ_dst[:o] = dl[idx]
    occ_time[:o] = np.asarray(ea_t)[idx]
    occ_mask[:o] = True
    occ_rows[:o] = np.asarray(ea_rows)[idx]
    view.occ_src, view.occ_dst = occ_src, occ_dst
    view.occ_time, view.occ_mask = occ_time, occ_mask
    view._occ_rows = occ_rows
