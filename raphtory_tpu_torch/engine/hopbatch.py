"""Hop-batched columnar engines — a whole range sweep as columns of one pass.

Every (hop, window) view of a Range query is a COLUMN of one column-batched
iteration (PageRank's power iteration, or the min-combine traversals of
connected components and BFS / weighted SSSP): the per-edge access becomes
a C-wide row move, and the temporal dimension is captured as per-hop fold
state rebuilt on the device from a base snapshot plus the host fold's
per-hop touched-entity deltas (deletes and revivals included, not an
add-only approximation).

Port of ``raphtory_tpu/engine/hopbatch.py``: the host fold is the same
numpy/C++ code and its pipeline (the lookahead prefetch, forked parallel
chunk folds, the cross-request fold cache of ``core/sweep.py``), and the
device side runs the
hand-written kernels of ``ops/columns.py`` — K1 (``masks_from_deltas``)
rebuilds the masks from a base plus per-hop deltas (the default
``RTPU_FOLD=delta`` route), K3 (``column_masks``) builds them from the
hop-major ``[H, m_pad]`` fold columns the host materialises instead
(``RTPU_FOLD=host``, and ``run_columns`` over ``core/bulk.bulk_hop_columns``),
K4 (``scale_hop_masks``) from the bulk loader's add-only base and update
lists (``run_scale_columns``), K2a (``column_out_degree``) and K2b
(``column_pull_sum``) carry the power iteration's edge passes, and K2c
(``pagerank_update``) its superstep epilogue (dangling mass, damping, tol
halting with frozen columns); K5 (``ops/minplus.cc_superstep``) and K6
(``minplus_superstep``) are one superstep each of CC and BFS / SSSP, and
K6w (``columns.weights_from_deltas``) rebuilds SSSP's per-hop weight state.
The per-dispatch start states stay in torch ops. Semantics match
``algorithms/``. Every iteration loops on the host and reads one
all-halted flag per superstep.

Destination-binned (PCPM) route: each run resolves the partition layout
(``ops/partition.resolve``: ``RTPU_PCPM``, ``RTPU_PARTITIONS``,
``RTPU_TILE_BUDGET_MB``, read at dispatch with the reference's auto rule),
and where it bins every edge operand lives in the layout's binned space of
``B = P * cap`` slots: the delta route bins the base on the host and remaps
the delta positions (K1 then runs unchanged at length B), the host-column
route emits its masks binned (KB1) and the scale route its (K4 through the
layout's permutation and its device inverse), and the passes
are K2b-P (``columns.binned_pull_sum``), K5-P and K6-P
(``minplus.binned_cc_superstep`` / ``binned_minplus_superstep``); K2a runs
on the binned operands over the layout's source walk, and K2c as it is.

Reference contrast: one pass per RANGE QUERY, where the reference runs its
full actor handshake once per hop (``RangeAnalysisTask.scala:18-35``).
"""

from __future__ import annotations

import logging
import os
import threading
import time as _time
from functools import partial

import numpy as np
import torch

from ..core.events import EDGE_ADD, EventLog
from ..core.sweep import (SweepBuilder, fold_cache, fold_pool, fold_workers,
                          prefetch_map, prefetch_on)
from ..ops import columns, minplus
from ..ops import partition as _partition
from ..ops.partition import BinnedEdges
from ..obs import device as _obs_device
from ..obs import ledger as _ledger
from ..obs.trace import TRACER
from ..ops.resident import Staged, pack, ship, stage
from ..utils.device import resolve_device
from .device_sweep import (DeviceEdges, GlobalTables, _device_edges,
                           _time_dtype_status, normalize_windows,
                           sweep_phase_summary)

_log = logging.getLogger(__name__)


def _column_layout(hop_times, windows):
    """Hop-major (hop 0's windows first) column layout — the ONE place the
    ordering is defined."""
    H = len(hop_times)
    wlist = normalize_windows(windows)
    hop_of_col = np.repeat(np.arange(H, dtype=np.int32), len(wlist))
    T_col = np.asarray([int(x) for x in hop_times], np.int64)[hop_of_col]
    w_col = np.asarray(wlist * H, np.int64)
    return H, H * len(wlist), hop_of_col, T_col, w_col


def stack_grids(grids):
    """Multi-request column stacking (``raphtory_tpu/engine/hopbatch.py:
    2298``): merge per-request ``(hop_times, windows)`` grids into ONE
    dispatch grid — the serving scheduler's entry into the columnar
    engines (``jobs/scheduler.py``). The batch grid is the cross product
    of the hop union and the window union, a superset of every member's
    grid. Returns ``(hops, wlist, cols)``:

    * ``hops`` — ascending union of all hop times (ints, deduplicated);
    * ``wlist`` — union of the normalized windows (``None`` → -1),
      first-seen order, deduplicated;
    * ``cols`` — per request, the flat column indices of ITS cells in the
      batch result (hop-major ``_column_layout`` order), hops ascending ×
      that request's own window order: the order a serial per-request
      dispatch emits them in, so the demux is an index gather.
    """
    hops = sorted({int(t) for ts, _ in grids for t in ts})
    wlist: list[int] = []
    for _, ws in grids:
        for w in normalize_windows(ws):
            if w not in wlist:
                wlist.append(w)
    W = len(wlist)
    hop_idx = {t: j for j, t in enumerate(hops)}
    cols = []
    for ts, ws in grids:
        nws = [wlist.index(w) for w in normalize_windows(ws)]
        cols.append([hop_idx[int(t)] * W + i
                     for t in sorted({int(x) for x in ts}) for i in nws])
    return hops, wlist, cols


def _pad_hop_deltas(deltas, H: int, tdt):
    """Pad per-hop (pos, lat, alive) delta lists to a fixed ``[H, U]``
    shape (hop 0 is empty: its state IS the base). Pad index 2^31-1 lies
    past every table and is skipped by the device scatter."""
    longest = max((len(p) for p, _, _ in deltas), default=1)
    U = max(256, 1 << int(np.ceil(np.log2(max(longest, 1)))))
    pos = np.full((H, U), 2**31 - 1, np.int32)
    lat = np.zeros((H, U), tdt)
    alive = np.zeros((H, U), bool)
    for h, (p, l, a) in enumerate(deltas):
        pos[h, : len(p)] = p
        lat[h, : len(l)] = l
        alive[h, : len(a)] = a
    return U, pos, lat, alive


def _pagerank_columns(me, mv, e_src, e_dst, indptr, n_pad: int,
                      damping: float, tol: float, max_steps: int,
                      r_init=None, pcpm: BinnedEdges | None = None,
                      walk=None):
    """Power iteration over per-column masks ``me [m_pad, C]`` /
    ``mv [n_pad, C]`` — dangling redistribution, tol halting with
    converged-column freeze; semantics of ``algorithms/pagerank.py``.

    ``r_init`` (optional ``[n_pad, C]``) warm-starts the iteration: the
    update is a contraction, so ANY masked positive start converges to the
    SAME fixed point. Each column is masked to its own alive set, floored so
    newly-alive vertices get mass, and renormalised.

    Returns ``(ranks [C, n_pad], supersteps run)``. Edges are
    (dst, src)-sorted with their destination CSR ``indptr``; with ``pcpm``
    (a layout's ``BinnedEdges``) ``me``/``e_src``/``e_dst``/``indptr`` are
    the binned ``[B(, C)]`` operands and the pull-sum is K2b-P. ``walk``
    is the edges' source walk ``(out_indptr, out_order)`` K2a counts over
    (``_pr_args``; the CPU twin needs none)."""
    out_deg = columns.column_out_degree(me, e_src, n_pad, walk)
    n_act = torch.clamp(mv.to(torch.float32).sum(0), min=1.0)
    r = torch.where(mv, (1.0 / n_act)[None, :], 0.0)
    if r_init is not None:
        warm = torch.where(mv, torch.clamp(r_init, min=0.0), 0.0)
        warm = warm + torch.where(mv, torch.div(columns.f32(0.1, n_act),
                                                n_act)[None, :], 0.0)
        r = warm / torch.clamp(warm.sum(0, keepdim=True), min=1e-30)
    st = columns.rank_state(r.contiguous())
    columns.pagerank_update(st, None, out_deg, mv, n_act, damping, tol,
                            prime=True)
    steps = 0
    # the reference's while_loop condition, read on the host: one
    # all-halted flag per superstep
    while steps < max_steps and not bool(st.done):
        agg = (columns.column_pull_sum(me, st.rd, e_src, e_dst, indptr)
               if pcpm is None else columns.binned_pull_sum(me, st.rd, pcpm))
        columns.pagerank_update(st, agg, out_deg, mv, n_act, damping, tol)
        steps += 1
    return st.r.t(), steps


def _cc_columns(me, mv, edges, n_pad: int, max_steps: int, l_init=None):
    """Columnar min-label propagation — connected components for every
    (hop, window) column at once (``algorithms/connected_components.py``
    semantics: undirected min over both directions, labels are global
    padded indices). ``l_init`` ([n_pad, C] int32) warm-starts from a
    previous epoch's labels: the start is ``min(own index, l_init)``,
    equal to the cold result only when the graph merely GAINED
    edges/vertices since (the caller's gate, as in the reference).
    ``edges`` is the ``DeviceEdges`` or, binned, a layout's ``BinnedEdges``
    (``me`` then ``[B, C]``). Returns ``(labels [C, n_pad], supersteps
    run)``."""
    step = (minplus.binned_cc_superstep if isinstance(edges, BinnedEdges)
            else minplus.cc_superstep)
    lab0 = torch.where(mv, torch.arange(n_pad, dtype=torch.int32,
                                        device=mv.device)[:, None],
                       minplus.I32_MAX)
    if l_init is not None:
        lab0 = torch.where(mv, torch.minimum(lab0, l_init), minplus.I32_MAX)
    st = minplus.min_state(lab0.contiguous())
    steps = 0
    while steps < max_steps and not bool(st.done):
        step(st, me, mv, edges)
        steps += 1
    return st.cur.t(), steps


def _bfs_columns(me, mv, edges, n_pad: int, max_steps: int, directed: bool,
                 seed_mask, ew=None, W: int = 1, d_init=None):
    """Columnar min-plus traversal (``algorithms/traversal.SSSP``
    semantics): ``ew`` is None for hop counting or the ``[m_pad, H]`` f32
    weight block (hop ``c // W`` of column ``c``). ``d_init`` ([n_pad, C]
    f32) warm-starts with ``min(cold seed, d_init)``, valid when edges and
    vertices were only ADDED since (the caller's gate); weighted SSSP never
    warm-starts. ``edges`` as for ``_cc_columns`` (binned: ``ew`` is the
    binned ``[B, H]`` block). Returns ``(distances [C, n_pad], supersteps
    run)``."""
    step = (minplus.binned_minplus_superstep
            if isinstance(edges, BinnedEdges) else minplus.minplus_superstep)
    d0 = torch.where(mv & seed_mask[:, None], 0.0, minplus.INF) \
        .to(torch.float32)
    if d_init is not None:
        d0 = torch.where(mv, torch.minimum(d0, d_init), minplus.INF)
    st = minplus.min_state(d0.contiguous())
    steps = 0
    while steps < max_steps and not bool(st.done):
        step(st, me, mv, edges, directed, ew, W)
        steps += 1
    return st.cur.t(), steps


def _pr_args(edges, tables):
    """``(e_src, e_dst, indptr, pcpm, walk)`` of ``_pagerank_columns`` for
    a layout's ``BinnedEdges`` (K2a walks its source walk, ``device_edges(
    ..., reverse=True)``), the ``DeviceEdges`` of ``GlobalTables`` (its
    ``out_indptr``/``out_perm``) or the first three fields of a
    ``core/bulk.BulkGraph``'s, which has no source index: K2a's walk is
    then ``columns.source_walk``, built on the device at first use and
    cached with ``e_src``."""
    if isinstance(edges, BinnedEdges):
        return (edges.b_src, edges.b_dst, edges.in_indptr, edges,
                (edges.out_indptr, edges.out_order))
    if isinstance(edges, DeviceEdges):
        return (*edges[:3], None, (edges.out_indptr, edges.out_perm))
    return (*edges[:3], None,
            columns.source_walk(edges[0], tables.m, tables.n_pad))


def _seed_mask(tables, seed_vids) -> np.ndarray:
    """Global dense-space seed mask from external vertex ids (absent ids
    ignored)."""
    seed_mask = np.zeros(tables.n_pad, bool)
    seeds = np.asarray(sorted({int(v) for v in seed_vids}), np.int64)
    if len(seeds) and len(tables.uv):
        pos = np.clip(np.searchsorted(tables.uv, seeds), 0,
                      len(tables.uv) - 1)
        ok = tables.uv[pos] == seeds
        seed_mask[pos[ok]] = True
    return seed_mask


def _pad_weight_deltas(weight_deltas, H: int):
    """Pad per-hop (pos, val) weight updates to ``[H, U]`` (pad position
    2^31-1, skipped by the device scatter)."""
    longest = max((len(p) for p, _ in weight_deltas), default=1)
    U = max(256, 1 << int(np.ceil(np.log2(max(longest, 1)))))
    pos = np.full((H, U), 2**31 - 1, np.int32)
    val = np.zeros((H, U), np.float32)
    for h, (p, v) in enumerate(weight_deltas):
        pos[h, : len(p)] = p
        val[h, : len(v)] = v
    return pos, val


def _put(a, dev):
    """A host array on ``dev``; a tensor passes through as it is."""
    return torch.from_numpy(a).to(dev) if isinstance(a, np.ndarray) else a


def _tile_warm(r_init, H: int, W: int):
    """The warm start of an ``H``-hop dispatch: the last hop's W rows of the
    previous output ``r_init [C_prev, n_pad]``, tiled per hop, as ``[n_pad,
    H*W]`` (None when cold)."""
    if r_init is None:
        return None
    return r_init[-W:].repeat(H, 1).t().contiguous()


def run_columns_delta(kind, tables, base, deltas_e, deltas_v, hop_times,
                      windows, *, algo_args: tuple, edges=None,
                      seed_mask=None, r_init=None, weight_base=None,
                      weight_deltas=None, h0_delta: bool = False,
                      ship_counter=None, layout=None, device=None):
    """Dispatch a delta-fed columnar kernel (``kind``: pagerank | cc | bfs)
    over ``_HopBatched._fold_deltas`` output; returns ``(result [H*W,
    n_pad], steps, advanced_base)``. ``base`` is a host snapshot (numpy)
    or, with ``h0_delta=True``, the previous dispatch's device-resident
    advanced state, in which case delta[0] carries the inter-batch
    catch-up and the dispatch ships O(Σ delta) bytes. ``edges`` is the
    device ``DeviceEdges``; ``seed_mask`` the device ``[n_pad]`` bool seeds
    (bfs). ``weight_base`` + ``weight_deltas`` ([(pos, val)] per hop) turn
    bfs into weighted SSSP with the weight state rebuilt on the device too
    (K6w); the advanced base then carries the weight state as a 5th
    element. ``r_init`` is the previous chunk's (or epoch's) full
    ``[C_prev, n_pad]`` output: its last hop's W rows seed every hop.

    ``layout`` (``ops/partition.PartitionLayout``) routes the dispatch
    through the destination-binned kernels: a host base is binned HERE (a
    resident h0 base already is: it is the previous binned dispatch's
    advanced state), the edge delta positions (and SSSP's weight ones) are
    remapped to binned slots, K1/K6w run at length B, and ``edges`` is not
    needed (``device`` names the card, None: the CUDA card)."""
    H, C, _, T_col, w_col = _column_layout(hop_times, windows)
    W = C // H
    tdt = tables.tdtype
    _, de_pos, de_lat, de_alive = _pad_hop_deltas(deltas_e, H, tdt)
    _, dv_pos, dv_lat, dv_alive = _pad_hop_deltas(deltas_v, H, tdt)
    weighted = weight_base is not None
    if weighted:
        dw_pos, dw_val = _pad_weight_deltas(weight_deltas, H)
    base = tuple(base)
    if layout is not None:
        if not h0_delta:
            base = (*layout.bin_base(base[0], base[1]), *base[2:])
            if weighted:
                weight_base = layout.bin_values(weight_base)
        de_pos = layout.remap_positions(de_pos)
        if weighted:
            dw_pos = layout.remap_positions(dw_pos)
    if ship_counter is not None:
        # FOLD-STATE host→device payload of THIS dispatch (padded shapes;
        # a device-resident h0 base, the cached tables and the per-engine
        # seed mask ship nothing)
        shipped = [de_pos, de_lat, de_alive, dv_pos, dv_lat, dv_alive]
        if not h0_delta:
            shipped += list(base)
        if weighted:
            shipped += [dw_pos, dw_val]
            if not h0_delta:
                shipped.append(weight_base)
        ship_counter(int(sum(a.nbytes for a in shipped)))
    dev = (edges.e_src.device if edges is not None
           else resolve_device(device))
    if layout is not None:
        edges = layout.device_edges(dev, reverse=True)

    def put(a):
        return _put(a, dev)

    with TRACER.span("hop.compute", kind=kind, hops=H, cols=H * W,
                     resident_base=h0_delta, pcpm=layout is not None):
        return _ledger.instrument(f"hopbatch.delta.{kind}", partial(
            _delta_program, kind, tables, algo_args, edges, seed_mask,
            r_init, weight_base, put, H, W, h0_delta))(
            *base, T_col, w_col, de_pos, de_lat, de_alive, dv_pos, dv_lat,
            dv_alive, *((dw_pos, dw_val) if weighted else ()))


def _delta_program(kind, tables, algo_args, edges, seed_mask, r_init,
                   weight_base, put, H, W, h0_delta, be_lat, be_alive,
                   bv_lat, bv_alive, T_col, w_col, de_pos, de_lat, de_alive,
                   dv_pos, dv_lat, dv_alive, dw_pos=None, dw_val=None):
    """The device half of ``run_columns_delta`` (the program the reference
    compiles as ``hopbatch.delta.{kind}``): upload the base and the
    deltas, rebuild the masks (K1), then iterate (K2a/b/c, K5 or K6 with
    K6w's weights)."""
    tdt = tables.tdtype
    weighted = weight_base is not None
    info = np.iinfo(tdt)
    lo = put(np.clip(T_col - w_col, info.min, info.max).astype(tdt))
    nowin = put(w_col < 0)
    be_lat, be_alive, bv_lat, bv_alive = (
        put(a) for a in (be_lat, be_alive, bv_lat, bv_alive))
    me, fe_lat, fe_alive = columns.masks_from_deltas(
        be_lat, be_alive, put(de_pos), put(de_lat), put(de_alive),
        lo, nowin, H, W, h0_delta)
    mv, fv_lat, fv_alive = columns.masks_from_deltas(
        bv_lat, bv_alive, put(dv_pos), put(dv_lat), put(dv_alive),
        lo, nowin, H, W, h0_delta)
    adv = (fe_lat, fe_alive, fv_lat, fv_alive)
    warm = _tile_warm(r_init, H, W)
    n_pad = tables.n_pad
    if kind == "pagerank":
        damping, tol, max_steps = algo_args
        e_src, e_dst, indptr, pcpm, walk = _pr_args(edges, tables)
        out, steps = _pagerank_columns(me, mv, e_src, e_dst, indptr, n_pad,
                                       damping, tol, max_steps, r_init=warm,
                                       pcpm=pcpm, walk=walk)
    elif kind == "cc":
        (max_steps,) = algo_args
        out, steps = _cc_columns(me, mv, edges, n_pad, max_steps,
                                 l_init=warm)
    elif kind == "bfs":
        max_steps, directed = algo_args
        ew = None
        if weighted:
            ew, cur_w = columns.weights_from_deltas(
                put(weight_base), put(dw_pos), put(dw_val), H, h0_delta)
            adv = adv + (cur_w,)
        out, steps = _bfs_columns(me, mv, edges, n_pad, max_steps, directed,
                                  seed_mask, ew, W, d_init=warm)
    else:
        raise ValueError(f"unknown columnar kind {kind!r}")
    return out, steps, adv


def _host_edges(tables, dev):
    """The static edge tables of ``tables`` uploaded to ``dev``: the whole
    ``DeviceEdges`` of ``GlobalTables``, or the first three fields of a
    ``core/bulk.BulkGraph``, which has no source-ordered index (the
    min-combine kernels need one; PageRank's K2a builds it,
    ``_pr_args``)."""
    if not hasattr(tables, "out_perm"):
        return tuple(_put(getattr(tables, f), dev)
                     for f in DeviceEdges._fields[:3])
    return DeviceEdges(*(_put(getattr(tables, f), dev)
                         for f in DeviceEdges._fields))


def _ship_columns(cols, dev) -> tuple:
    """Host fold columns on ``dev`` in ONE non-blocking copy
    (``ops/resident.ship``): a ``Staged`` tuple, as ``_fold_columns``
    builds it, ships its buffer; plain numpy arrays are packed into a new
    one first (pinned for a card). Tensors pass through."""
    if isinstance(cols, Staged):
        return ship(cols, dev)
    if any(isinstance(a, torch.Tensor) for a in cols):
        return tuple(_put(a, dev) for a in cols)
    return ship(pack(cols, pin=torch.device(dev).type == "cuda"), dev)


def _dispatch_columns(tables, cols, hop_times, windows, dev, layout=None):
    """Ship the host fold columns ``cols = (e_lat, e_alive, v_lat,
    v_alive)`` (hop-major ``[H, m_pad]`` / ``[H, n_pad]``) in one copy
    (``_ship_columns``; device tensors pass through) and build the window
    masks on the device: K3, or KB1 with a ``layout`` (the edge masks
    emitted binned, ``[B, C]``). The column bounds stay on the host: the
    kernels take them by value. Returns ``(H, W, me, mv [n_pad, C])``."""
    H, C, hop_of_col, T_col, w_col = _column_layout(hop_times, windows)
    tdt = tables.tdtype
    info = np.iinfo(tdt)
    args = (*_ship_columns(cols, dev), hop_of_col,
            np.clip(T_col - w_col, info.min, info.max).astype(tdt),
            w_col < 0)
    if layout is None:
        me, mv = columns.column_masks(*args)
    else:
        _, _, valid, _, _, perm = layout.device_args(dev)
        me, mv = columns.bin_column_masks(*args, perm, valid)
    return H, C // H, me, mv


def _column_edges(tables, dev, edges, layout):
    """The edge operands of a host-column dispatch: the layout's
    ``BinnedEdges`` with its source walk, else ``edges`` or the tables' own
    upload."""
    if layout is not None:
        return layout.device_edges(dev, reverse=True)
    return edges if edges is not None else _host_edges(tables, dev)


def run_columns(tables, e_lat, e_alive, v_lat, v_alive, hop_times, windows,
                *, damping: float = 0.85, tol: float = 1e-7,
                max_steps: int = 20, edges=None, r_init=None, device=None,
                layout=None):
    """Columnar PageRank over prebuilt per-hop fold columns — the
    ``RTPU_FOLD=host`` route of ``HopBatchedPageRank`` and the add-only bulk
    loader's (``core/bulk.bulk_hop_columns``). ``tables`` needs the
    GlobalTables / BulkGraph surface (``n_pad``, ``e_src``, ``e_dst``,
    ``in_indptr``, ``tdtype``); ``edges`` (device tensors, ``DeviceEdges``
    or its first three fields) skips their upload. ``r_init`` (the
    previous chunk's full ``[C_prev, n_pad]`` output, on the device)
    warm-starts from its last hop's W rows, tiled per hop. ``layout``
    (a ``PartitionLayout`` of ``tables``) takes the binned route (KB1,
    K2b-P). ``device=None`` is the CUDA card. Returns ``(ranks [H*W,
    n_pad] hop-major, steps)``."""
    dev = resolve_device(device)
    with TRACER.span("hop.compute", cols=len(hop_times) * len(
            normalize_windows(windows))):
        H, W, me, mv = _dispatch_columns(
            tables, (e_lat, e_alive, v_lat, v_alive), hop_times, windows,
            dev, layout)
        e_src, e_dst, indptr, pcpm, walk = _pr_args(
            _column_edges(tables, dev, edges, layout), tables)
        return _ledger.instrument("hopbatch.pagerank_cols",
                                  _pagerank_columns)(
            me, mv, e_src, e_dst, indptr, tables.n_pad, float(damping),
            float(tol), int(max_steps), r_init=_tile_warm(r_init, H, W),
            pcpm=pcpm, walk=walk)


def run_cc_columns(tables, e_lat, e_alive, v_lat, v_alive, hop_times,
                   windows, *, max_steps: int = 100, edges=None, device=None,
                   layout=None):
    """Columnar connected components over prebuilt per-hop fold columns
    (K3, then K5 per superstep; KB1 and K5-P with a ``layout``). ``edges``
    is the device ``DeviceEdges`` (uploaded from ``tables`` when None).
    Returns ``(labels [H*W, n_pad], steps)``."""
    dev = resolve_device(device)
    with TRACER.span("hop.compute", cols=len(hop_times) * len(
            normalize_windows(windows))):
        _, _, me, mv = _dispatch_columns(
            tables, (e_lat, e_alive, v_lat, v_alive), hop_times, windows,
            dev, layout)
        return _ledger.instrument("hopbatch.cc_cols", _cc_columns)(
            me, mv, _column_edges(tables, dev, edges, layout), tables.n_pad,
            int(max_steps))


def run_bfs_columns(tables, e_lat, e_alive, v_lat, v_alive, hop_times,
                    windows, seed_vids, *, directed: bool = False,
                    max_steps: int = 100, edges=None, weight_cols=None,
                    device=None, layout=None):
    """Columnar min-plus traversal over prebuilt fold columns (K3, then K6
    per superstep); ``seed_vids`` are external vertex ids looked up in the
    global dense space (absent ids ignored). ``weight_cols`` (``[H,
    m_pad]`` f32, missing folded to 1.0) turns hop counting into weighted
    SSSP: it uploads transposed, as the ``[m_pad, H]`` block K6 reads
    (binned with a ``layout``: rows follow the layout permutation, ``[B,
    H]``, as the reference's ``ew[perm]``). Returns ``(distances [H*W,
    n_pad], steps)``."""
    dev = resolve_device(device)
    with TRACER.span("hop.compute", cols=len(hop_times) * len(
            normalize_windows(windows))):
        # the weight columns ride the fold columns' one copy
        cols = _ship_columns((e_lat, e_alive, v_lat, v_alive)
                             + (() if weight_cols is None
                                else (weight_cols,)), dev)
        _, W, me, mv = _dispatch_columns(tables, cols[:4], hop_times,
                                         windows, dev, layout)
        edges = _column_edges(tables, dev, edges, layout)
        ew = None
        if weight_cols is not None:
            ew = cols[4].t()
            if layout is not None:
                ew = ew[edges.perm.long()]
            ew = ew.contiguous()
        seed_mask = _put(_seed_mask(tables, seed_vids), dev)
        return _ledger.instrument("hopbatch.bfs_cols", _bfs_columns)(
            me, mv, edges, tables.n_pad, int(max_steps), bool(directed),
            seed_mask, ew, W)


def _delta_fingerprint(deltas_e, deltas_v) -> tuple:
    """Cheap identity of the delta lists a scale payload was built from:
    per-hop lengths plus an xor checksum over BOTH the pos and time arrays
    (same positions with different update times are different deltas). A
    payload built from DIFFERENT deltas must fail loudly in
    ``run_scale_columns`` instead of returning mislabelled results."""
    def xor(a):
        a = np.asarray(a)
        if not len(a):
            return 0
        return int(np.bitwise_xor.reduce(a.astype(np.int64, copy=False)))

    def fp(deltas):
        return tuple((int(len(p)), xor(p) ^ (xor(t) << 1))
                     for p, t in deltas)

    return fp(deltas_e), fp(deltas_v)


def prepare_scale_payload(deltas_e, deltas_v, hop_times, windows,
                          device=None):
    """Pad the per-hop update lists and compute the column thresholds ONCE
    for repeated ``run_scale_columns`` calls over the same sweep, and
    upload them to ``device`` (None: the CUDA card) — re-padding and
    re-uploading per sweep would put the host→device copy inside a timed
    loop. Updates pad with ``(pos 0, INT32_MIN)``, a max no-op; thresholds
    are ``max(T - w, 0)``, or 0 unwindowed. Returns ``(U_e, U_v, de_pos,
    de_t, dv_pos, dv_t, thr, fingerprint)``."""
    dev = resolve_device(device)
    H = len(hop_times)
    wlist = normalize_windows(windows)
    W = len(wlist)
    thr = np.zeros(H * W, np.int32)
    for j, T in enumerate(int(x) for x in hop_times):
        for i, w in enumerate(wlist):
            thr[j * W + i] = 0 if w < 0 else max(int(T) - int(w), 0)

    def pad_for(deltas):
        longest = max((len(p) for p, _ in deltas), default=1)
        return max(1024, 1 << int(np.ceil(np.log2(max(longest, 1)))))

    def pad_deltas(deltas, U):
        pos = np.zeros((H, U), np.int32)
        t = np.full((H, U), np.iinfo(np.int32).min, np.int32)
        for h, (p, tt) in enumerate(deltas):
            if len(p) > U:
                raise ValueError(f"delta {h} exceeds pad {U}")
            pos[h, : len(p)] = p
            t[h, : len(p)] = tt
        return pos, t

    U_e, U_v = pad_for(deltas_e), pad_for(deltas_v)
    de_pos, de_t = pad_deltas(deltas_e, U_e)
    dv_pos, dv_t = pad_deltas(deltas_v, U_v)
    # fingerprint: the (hop_times, windows) grid AND the delta lists — a
    # payload prepared for one sweep must not silently relabel another
    # same-shape sweep's results
    fp = (tuple(int(x) for x in hop_times), tuple(wlist),
          _delta_fingerprint(deltas_e, deltas_v))
    return (U_e, U_v, *(_put(a, dev) for a in (de_pos, de_t, dv_pos, dv_t,
                                                thr)), fp)


def run_scale_columns(bulk, base_e, base_v, deltas_e, deltas_v, hop_times,
                      windows, *, damping: float = 0.85, tol: float = 0.0,
                      max_steps: int = 20, edges=None, prepared=None,
                      device=None):
    """Columnar PageRank over ``core/bulk.bulk_hop_deltas`` output: the
    base fold rows and per-hop update lists go to the device, K4 rebuilds
    every hop's masks there, and every (hop, window) view runs as one
    column (K2). Returns ``(ranks [H*W, n_pad] hop-major, steps)``;
    unwindowed views use a negative window (``run_columns``' convention).
    ``base_e``/``base_v`` may already be device tensors, ``edges`` the
    device ``(e_src, e_dst, in_indptr)`` (K2a's source walk is built from
    its ``e_src`` at the first call and cached with it,
    ``columns.source_walk``), and ``prepared`` (from
    ``prepare_scale_payload``) the uploaded update lists, so repeated
    sweeps ship nothing; a payload prepared for another grid or other
    deltas raises ``ValueError``. ``device=None`` is the CUDA card.

    The partition layout resolves HERE on ``bulk`` (``ops/partition``
    knobs, read at dispatch): binned, K4 emits the edge masks straight into
    the ``[B, H*W]`` binned layout (the hop state advancing in engine order,
    as the reference's), and the pull-sum is K2b-P."""
    dev = resolve_device(device)
    H = len(hop_times)
    wlist = normalize_windows(windows)
    W = len(wlist)
    if prepared is None:
        prepared = prepare_scale_payload(deltas_e, deltas_v, hop_times,
                                         windows, device=dev)
    else:
        # caller-supplied payload: verify it was built from THESE deltas
        # and THIS grid (the fresh-built branch above trivially was)
        fp = prepared[7]
        want = (tuple(int(x) for x in hop_times), tuple(wlist),
                _delta_fingerprint(deltas_e, deltas_v))
        if fp[:2] != want[:2]:
            raise ValueError(
                "prepared payload was built for a different sweep grid "
                f"(prepared {fp[0][:2]}.../{fp[1]}, called with "
                f"{want[0][:2]}.../{want[1]}) — prepare_scale_payload must "
                "see the SAME hop_times/windows (and the same deltas)")
        if fp[2] != want[2]:
            raise ValueError(
                "prepared payload was built from DIFFERENT delta lists "
                "(per-hop length/checksum mismatch) — results would be "
                "mislabelled; re-run prepare_scale_payload on these deltas")
    _, _, de_pos, de_t, dv_pos, dv_t, thr, _ = prepared
    layout = _partition.resolve(bulk, bulk, _partition.tile_budget_bytes())
    if layout is not None:
        edges = layout.device_edges(dev, reverse=True)
    elif edges is None:
        edges = _host_edges(bulk, dev)
    binned = isinstance(edges, BinnedEdges)
    with TRACER.span("hop.compute", cols=H * W):
        return _ledger.instrument("hopbatch.pagerank_scale", _scale_program)(
            bulk, _put(base_e, dev), _put(base_v, dev), de_pos, de_t,
            dv_pos, dv_t, thr, edges, binned, H, W, float(damping),
            float(tol), int(max_steps))


def _scale_program(bulk, base_e, base_v, de_pos, de_t, dv_pos, dv_t, thr,
                   edges, binned, H, W, damping, tol, max_steps):
    """The device half of ``run_scale_columns`` (the reference's
    ``hopbatch.pagerank_scale`` program): K4 for both mask sets, then the
    power iteration (K2a/b/c)."""
    me = columns.scale_hop_masks(
        base_e, de_pos, de_t, thr, H, W,
        perm=edges.perm if binned else None,
        valid=edges.valid if binned else None)
    mv = columns.scale_hop_masks(base_v, dv_pos, dv_t, thr, H, W)
    e_src, e_dst, indptr, pcpm, walk = _pr_args(edges, bulk)
    return _pagerank_columns(me, mv, e_src, e_dst, indptr, bulk.n_pad,
                             damping, tol, max_steps, pcpm=pcpm, walk=walk)


class _HopBatched:
    """Shared incremental fold → per-hop state (deletes included).

    ``run(hop_times, windows, chunks=k)`` splits the sweep into ``k`` equal
    hop groups. On the default delta route (``RTPU_FOLD=delta``) the first
    group ships a base snapshot, later groups only deltas onto the
    device-resident advanced base (K1); on ``RTPU_FOLD=host`` every group
    ships its hop-major ``[H, m_pad]`` fold columns (K3). Both routes build
    the same masks, so their results are bitwise equal. Results match
    ``chunks=1`` (hop-major concatenation; bitwise for CC and BFS/SSSP,
    within solver tolerance for PageRank).

    The fold pipeline, with the reference's knobs: group ``c+1`` folds on
    the lookahead lane while group ``c`` dispatches (``RTPU_PREFETCH``,
    default on), and the lane leaves fork checkpoints in the cross-request
    fold cache (``RTPU_FOLD_CACHE_MB``). Where cached checkpoints cover
    every fork's start (a later sweep over the same log and hop grid), the
    groups (or one group's hops) fold concurrently on forked builders
    instead (up to ``RTPU_FOLD_WORKERS``), byte-equal to the serial fold.
    Dispatches stay on the calling thread, in group order."""

    #: set True by subclasses whose iteration is a contraction (safe to
    #: warm-start from the previous chunk's solution)
    supports_warm_start = False

    #: subclasses whose kernel accepts a cross-epoch warm seed
    #: (``run(..., warm_state=...)``) under the caller-enforced monotone
    #: gate — the CC/BFS min-merge warm init. Contraction engines
    #: (``supports_warm_start``) accept the seed unconditionally.
    supports_epoch_warm = False

    #: False where the fold threads SEQUENTIAL state of its own through
    #: the engine (SSSP's weight cursor): such an engine folds on the
    #: shared builder whatever ``RTPU_FOLD_WORKERS`` says
    supports_parallel_fold = True

    def __init__(self, log: EventLog, device=None):
        self.device = resolve_device(device)
        # fold state only — the columnar engine never emits GraphViews
        self.sw = SweepBuilder(log, track_rows=False, preseed_pairs=True)
        self.tables = GlobalTables(self.sw)
        # cache key for the device edge tables: the CALLER's log object
        # (sw.log is a fresh pin per engine and would never hit)
        self._log = log
        #: fold seconds of the LAST run(), summed over the threads that
        #: folded (worker seconds: may exceed the run's wall time)
        self.fold_seconds = 0.0
        #: the LAST run()'s fold seconds by mode: ``serial`` (this thread
        #: or the lookahead lane) and ``parallel`` (forked units)
        self.fold_mode_seconds: dict = {}
        #: seconds the LAST run()'s dispatch loop waited on folds (0: every
        #: fold hid behind a dispatch; without the prefetch, every inline
        #: fold)
        self.fold_stall_seconds = 0.0
        #: host wall seconds the LAST run() spent in its dispatches (H2D,
        #: kernels and the superstep loop, which waits on the device once
        #: per superstep)
        self.dispatch_seconds = 0.0
        #: host→device FOLD-STATE payload bytes of the LAST run() (the
        #: per-log static tables ship once and are excluded)
        self.ship_bytes = 0
        # running host base for the delta fold (built on first use)
        self._delta_base = None
        # device-resident advanced base: the last dispatch's post-final-hop
        # fold state, fed back as the next dispatch's base so follow-on
        # chunks and batches ship only deltas
        self._dev_base = None
        # the PCPM layout spec the resident base is expressed in (None =
        # engine order): a knob flip between batches must drop residency,
        # never scatter one layout's delta onto the other's state
        self._dev_base_spec = None
        # the run's resolved partition layout (ops/partition.py), fixed
        # for the whole run at its start — None on the unbinned route
        self._active_layout = None
        # cross-epoch warm seed (run(..., warm_state=...)): seeds the FIRST
        # dispatch's iteration from a previous run's output
        self._epoch_seed = None
        # held by run() / fold_payloads() (every fold they queue on the
        # lookahead lane or fork on fold_pool ends before they return) and
        # by repin: a re-pin waits for those folds, never rebinds under them
        self._pin_lock = threading.Lock()

    @property
    def _edges(self):
        """The unbinned device edge tables, or None on the binned route
        (the binned dispatches read the layout's own device arrays)."""
        if self._active_layout is not None:
            return None
        return _device_edges(self._log, self.tables, self.device)

    def _resolve_layout(self):
        return _partition.resolve(self._log, self.tables,
                                  _partition.tile_budget_bytes())

    def _sync_layout(self):
        """Resolve the partition layout ONCE per run (``RTPU_PCPM`` /
        ``RTPU_PARTITIONS`` are dispatch-time knobs), and drop the
        device-resident advanced base when it is expressed in another edge
        layout than this run dispatches in — a catch-up delta remapped for
        one layout scattered onto the other's state would be silently
        wrong, not slow."""
        lay = self._resolve_layout()
        spec = None if lay is None else lay.spec
        if self._dev_base is not None and self._dev_base_spec != spec:
            self._drop_residency()
        self._active_layout = lay
        return lay

    def _drop_residency(self) -> None:
        """Forget the device-resident advanced base: the next delta batch
        ships a base snapshot from the host clock."""
        self._dev_base = None
        _obs_device.RESIDENT.drop(self, "advanced_base")

    def _use_delta_fold(self) -> bool:
        """The fold route, read at dispatch: ``RTPU_FOLD=host`` ships the
        host-built fold columns (K3), anything else (default ``delta``)
        the base plus per-hop deltas (K1)."""
        return os.environ.get("RTPU_FOLD", "delta") != "host"

    def host_column_bytes(self, n_hops: int) -> int:
        """Host bytes the fold will materialise for an ``n_hops`` sweep —
        O(base) on the delta route, O(H · (m_pad + n_pad)) on the
        host-column route. Routing layers size their admission guards from
        THIS, not from engine internals."""
        t = self.tables
        per_row = np.dtype(t.tdtype).itemsize + 1   # lat + alive
        if self._use_delta_fold():
            return (t.m_pad + t.n_pad) * per_row
        return n_hops * (t.m_pad + t.n_pad) * per_row

    def _edge_len(self) -> int:
        """Edge length of the masks the next run holds: m_pad, or the
        binned layout's B where the knobs bin this log."""
        lay = self._resolve_layout()
        return self.tables.m_pad if lay is None else lay.B

    def device_mask_bytes(self, n_cols: int) -> int:
        """Device bytes of the [m_pad+n_pad, C] bool masks ([B+n_pad, C]
        binned) every columnar pass holds across its superstep loop."""
        return (self._edge_len() + self.tables.n_pad) * n_cols

    def _dispatch_deltas(self, payload, hop_times, windows, r_init=None):
        raise NotImplementedError

    def _dispatch_cols(self, cols, hop_times, windows, r_init=None):
        raise NotImplementedError

    def _delta_base_args(self, ship_base):
        """(base_for_dispatch, h0_delta): the device-resident advanced
        state when the fold shipped no base snapshot, else the host
        snapshot (first batch, or residency was dropped)."""
        if ship_base is None:
            # SSSP's advanced base carries its weight state as a 5th entry
            return tuple(self._dev_base[:4]), True
        return ship_base, False

    def _count_ship(self, nbytes: int) -> None:
        self.ship_bytes += int(nbytes)

    def _run_delta(self, fn):
        """Run a delta dispatch and keep its advanced base device-resident;
        a failure drops residency so the next batch ships a fresh base."""
        try:
            out, steps, adv = fn()
        except Exception:
            self._drop_residency()
            raise
        self._dev_base = adv
        self._dev_base_spec = (None if self._active_layout is None
                               else self._active_layout.spec)
        # resident-buffer gauge (obs/device.py): the advanced base lives
        # as long as this engine keeps it
        _obs_device.RESIDENT.track(self, "advanced_base",
                                   _obs_device.nbytes_tree(adv))
        return out, steps

    def repin(self) -> str:
        """Adopt the rows appended to the engine's live log since its pin
        (``SweepBuilder.repin``; ``raphtory_tpu/engine/hopbatch.py:906``).
        On ``"extended"`` the dense dictionaries and the pair table do not
        change, so ``GlobalTables``, the cached device edge tables, the host
        delta base and the device-resident advanced base (``_dev_base``,
        ``_dev_base_spec``) stay valid, and the next ``run`` folds the
        suffix. ``"noop"`` / ``"extended"`` / ``"rebuild"``; after
        ``"rebuild"`` the engine must be discarded (its pin may already be
        rebound). A run in progress on another thread finishes first."""
        with self._pin_lock:
            n_old = len(self.sw._t)
            status = self.sw.repin(self._log)
            if status != "extended":
                return status
            status = _time_dtype_status(self.tables.tdtype,
                                        self.sw._t[n_old:])
            if status == "extended":
                status = self._extend(n_old)
            return status

    def _extend(self, n_old: int) -> str:
        """Engine state past the fold's to extend over the adopted rows
        ``[n_old, n)``: none here; SSSP's weight stream."""
        return "extended"

    def run(self, hop_times, windows, chunks: int = 1,
            warm_start: bool = False, hop_callback=None, warm_state=None):
        """Returns ``(result [H*W, n_pad] on the engine's device, steps)``;
        ``steps`` is the max over chunks. ``warm_start=True`` initialises
        each chunk's columns from the previous chunk's LAST-hop ranks (same
        fixed point, reached in fewer steps when consecutive hops differ
        little); warm results agree with cold ones to the solver
        tolerance. ``hop_callback(T, sweep_builder)`` fires after each
        hop's fold; under parallel folds it fires on worker threads, in any
        hop order (key what it keeps by ``T``).

        ``warm_state`` (a previous ``run``'s output, ``[C_prev, n_pad]``
        with the SAME window count) seeds the FIRST dispatch the same way:
        the cross-epoch warm channel. PageRank takes it unconditionally;
        for CC/BFS the min-merge warm init is only equivalent under the
        monotone (add-only, unwindowed) gate the CALLER must enforce; SSSP
        ignores it (a weight update can raise a pair's weight)."""
        self.fold_seconds = 0.0
        self.fold_mode_seconds = {}
        self.fold_stall_seconds = 0.0
        self.dispatch_seconds = 0.0
        self.ship_bytes = 0
        if warm_start and not self.supports_warm_start:
            raise ValueError(
                f"{type(self).__name__} cannot warm-start: its superstep "
                "is not a contraction (stale state would be wrong, not "
                "just slower)")
        self._epoch_seed = None
        # the min-merge seed of CC/BFS rides the delta route only; the
        # host-column route has no warm plumbing for it (as in the
        # reference)
        if warm_state is not None and (
                self.supports_warm_start
                or (self.supports_epoch_warm and self._use_delta_fold())):
            self._epoch_seed = warm_state
        hop_times = [int(x) for x in hop_times]
        chunks = max(1, min(int(chunks), len(hop_times)))
        from ..utils.transfer import shared_engine

        before = shared_engine().stats.as_dict()
        t_start = _time.perf_counter()
        with self._pin_lock, TRACER.span(
                "sweep.columnar", engine=type(self).__name__,
                hops=len(hop_times), chunks=chunks) as sp:
            out = self._run_locked(hop_times, windows, chunks, warm_start,
                                   hop_callback)
            self.last_phase_seconds = sweep_phase_summary(
                sp, _time.perf_counter() - t_start, self.fold_seconds,
                self.fold_stall_seconds,
                shared_engine().stats.delta_since(before),
                self.ship_bytes, len(hop_times),
                fold_modes=self.fold_mode_seconds)
        return out

    def _run_locked(self, hop_times, windows, chunks, warm_start,
                    hop_callback):
        self._sync_layout()
        try:
            return self._run_chunks(hop_times, windows, chunks, warm_start,
                                    hop_callback)
        except Exception:
            # a mid-run failure may leave the host fold ahead of the
            # device-resident base, and an advance that aborted before
            # _apply_delta_to_base leaves the running host base missing
            # that window: drop both, the next batch re-materialises
            self._drop_residency()
            self._delta_base = None
            raise

    def _observe_fold(self, seconds: float, mode: str) -> None:
        self.fold_mode_seconds[mode] = (
            self.fold_mode_seconds.get(mode, 0.0) + float(seconds))

    def _dispatch_group(self, payload, group, windows, delta, warm_start,
                        outs) -> None:
        """Dispatch one group's payload and append ``(out, steps)`` to
        ``outs``. Warm start seeds it with the previous group's FULL output
        (its last hop's W rows are tiled per hop inside the dispatch), the
        first group with the epoch seed."""
        if outs:
            r_init = outs[-1][0] if warm_start else None
        else:
            r_init = self._epoch_seed
        d0 = _time.perf_counter()
        if delta:
            out = self._dispatch_deltas(payload, group, windows,
                                        r_init=r_init)
        else:
            out = self._dispatch_cols(payload, group, windows, r_init=r_init)
        self.dispatch_seconds += _time.perf_counter() - d0
        outs.append(out)

    @staticmethod
    def _gather(outs):
        return (torch.cat([o for o, _ in outs], dim=0),
                max(s for _, s in outs))

    def _groups(self, hop_times, chunks, warm_start=False):
        if chunks == 1 or len(hop_times) % chunks:
            # unequal groups are not pipelined: one dispatch
            if warm_start and chunks > 1:
                _log.warning(
                    "%d hops do not split into %d equal chunks — running "
                    "one cold dispatch (warm_start has no effect)",
                    len(hop_times), chunks)
            return [list(hop_times)]
        per = len(hop_times) // chunks
        return [hop_times[c * per: (c + 1) * per] for c in range(chunks)]

    def _run_chunks(self, hop_times, windows, chunks, warm_start,
                    hop_callback):
        self._check_forward(hop_times)
        delta = self._use_delta_fold()
        groups = self._groups(hop_times, chunks, warm_start)
        plan = self._fold_plan(groups, delta) if prefetch_on() else None
        outs = []
        if self._forks_pay(plan):
            self._fold_groups_parallel(
                groups, plan, hop_callback, delta,
                lambda c, p: self._dispatch_group(p, groups[c], windows,
                                                  delta, warm_start, outs))
        else:
            self._fold_dispatch_serial(
                groups, windows, warm_start,
                self._checkpointing(hop_callback, plan), delta, outs)
        return self._gather(outs)

    def _fold_plan(self, groups, delta):
        """The forked fold's plan ``(units, starts, cache)``: its units
        ``(group, hops, row offset)``, one a group or one group split
        across the workers, and the time each unit's fork starts from
        (None: the engine clock, to which a resident delta base pins unit
        0). None where this engine folds serially whatever the cache holds:
        one worker, one unit, a fold that cannot fork, or no cache."""
        workers = fold_workers()
        cache = fold_cache()
        if workers <= 1 or not self.supports_parallel_fold or cache is None:
            return None
        if len(groups) == 1:
            hops0 = groups[0]
            per = -(-len(hops0) // min(workers, len(hops0)))
            units = [(0, hops0[o: o + per], o)
                     for o in range(0, len(hops0), per)]
        else:
            units = [(c, g, 0) for c, g in enumerate(groups)]
        if len(units) < 2:
            return None
        resident0 = delta and self._dev_base is not None
        # unit 0 emits absolute state unless the resident chain pins it to
        # the engine clock (its catch-up delta covers (clock, first hop])
        starts = [None if resident0 else int(units[0][1][0])]
        starts += [int(units[u - 1][1][-1]) for u in range(1, len(units))]
        return units, starts, cache

    def _forks_pay(self, plan) -> bool:
        """Fork only where cached checkpoints cover every unit's start: a
        cold fork re-folds its whole prefix, and the forks lost to the
        serial lane so on the card's host (PERF.md §6)."""
        return plan is not None and self.sw.covered(
            plan[2], [t for t in plan[1] if t is not None])

    @staticmethod
    def _checkpointing(hop_callback, plan):
        """``hop_callback`` that also leaves a checkpoint at each start of
        ``plan``'s forks as the serial fold passes it, so the next sweep
        over this log and grid can fork there."""
        if plan is None:
            return hop_callback
        _, starts, cache = plan
        at = {t for t in starts if t is not None}

        def cb(T, sw):
            if int(T) in at:
                sw.save_checkpoint(cache)
            if hop_callback is not None:
                hop_callback(T, sw)
        return cb

    def _fold_dispatch_serial(self, groups, windows, warm_start,
                              hop_callback, delta, outs) -> None:
        """The shared-builder pipeline: the groups fold one at a time on
        the lookahead lane (``PREFETCH_DEPTH`` queued ahead) while earlier
        groups dispatch on this thread into ``outs``; without the prefetch,
        fold and dispatch alternate here."""

        def fold(group, lookahead: bool):
            # a lookahead fold runs BEFORE the previous group's delta
            # dispatch has left its device-resident base: it must assume
            # it, or chunks 2+ would ship a base the serial loop never does
            with TRACER.span("hop.fold", hops=len(group),
                             engine=type(self).__name__):
                t0 = _time.perf_counter()
                if delta:
                    _, p = self._fold_deltas(group, hop_callback,
                                             assume_resident=lookahead)
                else:
                    _, p = self._fold_columns(group, hop_callback)
                self._observe_fold(_time.perf_counter() - t0, "serial")
            return group, p

        def dispatch(fold_out, stall):
            group, payload = fold_out
            self.fold_stall_seconds += stall
            if stall > 0:
                TRACER.complete("fold.stall", stall, hops=len(group))
            self._dispatch_group(payload, group, windows, delta, warm_start,
                                 outs)

        if prefetch_on() and len(groups) > 1:
            prefetch_map((partial(fold, g, c > 0)
                          for c, g in enumerate(groups)), dispatch)
        else:
            for g in groups:
                t0 = _time.perf_counter()
                out = fold(g, False)
                dispatch(out, _time.perf_counter() - t0)

    def fold_payloads(self, hop_times, chunks: int = 1):
        """Fold the sweep's group payloads WITHOUT dispatching them: the
        serial / parallel A/B surface. Chooses as ``run`` does: forked
        folds where cached checkpoints cover every fork's start, else the
        serial fold, which leaves those checkpoints (at more than one
        ``RTPU_FOLD_WORKERS``). Returns ``(groups, payloads)``, one payload
        a group, byte-equal to what ``run(hop_times, ..., chunks=chunks)``
        dispatches."""
        hop_times = [int(x) for x in hop_times]
        self._check_forward(hop_times)
        chunks = max(1, min(int(chunks), len(hop_times)))
        with self._pin_lock:
            return self._fold_payloads_locked(hop_times, chunks)

    def _fold_payloads_locked(self, hop_times, chunks):
        self._sync_layout()
        groups = self._groups(hop_times, chunks)
        delta = self._use_delta_fold()
        plan = self._fold_plan(groups, delta)
        if self._forks_pay(plan):
            payloads = self._fold_groups_parallel(groups, plan, None, delta,
                                                  lambda c, p: None)
            return groups, payloads
        cb = self._checkpointing(None, plan)
        payloads = []
        for c, g in enumerate(groups):
            t0 = _time.perf_counter()
            if delta:
                # groups 1+ fold all-delta as the pipelined run does (the
                # previous group's dispatch leaves a resident base)
                _, p = self._fold_deltas(g, cb, assume_resident=c > 0)
            else:
                _, p = self._fold_columns(g, cb)
            self._observe_fold(_time.perf_counter() - t0, "serial")
            payloads.append(p)
        return groups, payloads

    def _fold_groups_parallel(self, groups, plan, hop_callback, delta,
                              on_payload):
        """Parallel chunk folds: every unit of ``plan`` runs on its own fork
        of the engine's builder, seeded at its start (a cached checkpoint)
        on ``fold_pool``; the units of one group write absolute column rows
        or delta lists, so the parts concatenate. ``on_payload(c,
        payload)`` fires on THIS thread as each group completes, in group
        order. The last fork becomes the engine's builder. Returns the
        payloads, one a group."""
        units, starts, cache = plan
        left = [0] * len(groups)
        for c, _, _ in units:
            left[c] += 1
        cols_out = None
        if not delta:
            # this route advances the fold WITHOUT the running delta base,
            # as the serial _fold_columns does
            self._delta_base = None
            self._drop_residency()
            # each group's columns in one staged buffer, allocated here;
            # the workers write their rows into its views
            cols_out = [self._stage_columns(len(g)) for g in groups]

        def task(u: int):
            c, hops, off = units[u]
            t0 = _time.perf_counter()
            with TRACER.span("hop.fold", hops=len(hops),
                             engine=type(self).__name__, mode="parallel",
                             worker=threading.current_thread().name):
                sw = self.sw.fork() if starts[u] is None \
                    else self.sw.fork_at(starts[u], cache)
                part = None
                if delta:
                    part = self._fold_deltas_fork(
                        sw, hops,
                        c == 0 and off == 0 and starts[0] is not None,
                        hop_callback)
                else:
                    self._fold_columns_fork(sw, hops, hop_callback,
                                            cols_out[c], off)
            return u, sw, part, _time.perf_counter() - t0

        pending: dict = {}
        payloads = [None] * len(groups)
        last_sw = [None]

        def consume(res, stall):
            u, sw, part, dt = res
            self.fold_seconds += dt
            self._observe_fold(dt, "parallel")
            self.fold_stall_seconds += stall
            if stall > 0:
                TRACER.complete("fold.stall", stall, hops=len(units[u][1]))
            last_sw[0] = sw
            c = units[u][0]
            pending.setdefault(c, []).append(part)
            left[c] -= 1
            if left[c]:
                return
            parts = pending.pop(c)
            if delta:
                payload = parts[0] if len(parts) == 1 \
                    else self._merge_delta_parts(parts)
            else:
                payload = cols_out[c]
                self.ship_bytes += sum(a.nbytes for a in payload)
            payloads[c] = payload
            on_payload(c, payload)

        prefetch_map([partial(task, u) for u in range(len(units))], consume,
                     depth=len(units), pool=fold_pool())
        # the engine's fold clock ends at the sweep's last hop, as the
        # serial fold leaves it; the running host base never moved, so it
        # goes (a resident batch re-materialises it from this builder)
        self.sw = last_sw[0]
        self._delta_base = None
        return payloads

    @staticmethod
    def _merge_delta_parts(parts):
        """The delta payloads of ONE group's units, concatenated: part 0
        may carry the base; each later unit's hop 0 is the catch-up from
        the unit before, the serial fold's window."""
        deltas_e, deltas_v = [], []
        for p in parts:
            deltas_e.extend(p[1])
            deltas_v.extend(p[2])
        return (parts[0][0], deltas_e, deltas_v)

    def _check_forward(self, hop_times) -> None:
        if sorted(hop_times) != hop_times:
            raise ValueError("hop_times must ascend")
        if self.sw.t_prev is not None and hop_times[0] < self.sw.t_prev:
            # the incremental fold only moves forward; a backward batch on
            # the advanced clock would silently fold nothing
            raise ValueError(
                f"hop_times must continue forward from the previous batch "
                f"(got {hop_times[0]} < {self.sw.t_prev}); build a fresh "
                f"{type(self).__name__} to go back in history")

    def _materialise_base(self, sw):
        """Full engine-coordinate base arrays from a builder's fold state
        (the delta path's hop-0 snapshot, a column group's first row)."""
        t = self.tables
        tdt = t.tdtype
        be_lat = np.full(t.m_pad, t.tmin, tdt)
        be_alive = np.zeros(t.m_pad, bool)
        pos = t.eng_pos(sw.e_enc)
        be_lat[pos] = t.cast_times(sw.e_lat)
        be_alive[pos] = sw.e_alive
        bv_lat = np.full(t.n_pad, t.tmin, tdt)
        bv_alive = np.zeros(t.n_pad, bool)
        nv = len(sw.uv)
        bv_lat[:nv] = t.cast_times(sw.v_lat)
        bv_alive[:nv] = sw.v_alive
        return (be_lat, be_alive, bv_lat, bv_alive)

    def _column_specs(self, H: int) -> list:
        """``(shape, dtype)`` of each host fold column of an ``H``-hop
        dispatch: e_lat, e_alive, v_lat, v_alive."""
        t = self.tables
        return [((H, size), dt) for size, dt in (
            (t.m_pad, t.tdtype), (t.m_pad, bool), (t.n_pad, t.tdtype),
            (t.n_pad, bool))]

    def _stage_columns(self, H: int) -> Staged:
        """A fresh staging buffer for an ``H``-hop group's columns, pinned
        when the engine's device is the card (one non-blocking copy)."""
        return stage(self._column_specs(H), pin=self.device.type == "cuda")

    def _fold_columns(self, hop_times, hop_callback=None):
        """Host-column fold: hop-major state columns ``[H, m_pad]`` /
        ``[H, n_pad]`` (lat, alive), written into one fresh ``Staged``
        buffer (``_stage_columns``; any further columns of
        ``_column_specs`` are left for the subclass to fill). The device
        builds the masks from them (K3)."""
        f0 = _time.perf_counter()
        # this route advances the shared SweepBuilder WITHOUT updating the
        # running delta base, and the device-resident advanced base falls
        # behind it: a later delta-route call must rebuild both, or it
        # would scatter one hop's delta onto a stale base
        self._delta_base = None
        self._drop_residency()
        hop_times = [int(x) for x in hop_times]
        self._check_forward(hop_times)
        staged = self._stage_columns(len(hop_times))
        self._fold_columns_fork(self.sw, hop_times, hop_callback, staged, 0)
        self.fold_seconds += _time.perf_counter() - f0
        self.ship_bytes += sum(a.nbytes for a in staged[:4])
        return hop_times, staged

    def _fold_columns_fork(self, sw, group, hop_callback, out,
                           off: int) -> None:
        """The column fold of ``group`` on builder ``sw``, into rows
        ``[off, off + len(group))`` of ``out``: the first row whole from
        the fold state, every later one copied from the row before (
        contiguous in this layout) with the hop's touched-entity delta
        (``sw.last_delta``) scattered in. Every row is absolute state, so
        units of one group fold independently into one buffer."""
        e_lat, e_alive, v_lat, v_alive = cols = out[:4]
        for j, T in enumerate(group):
            sw._advance(T)
            if hop_callback is not None:
                hop_callback(T, sw)
            r = off + j
            if j == 0:
                for col, row in zip(cols, self._materialise_base(sw)):
                    col[r] = row
                continue
            for col in cols:
                col[r] = col[r - 1]
            de, dv = self._delta_eng(sw.last_delta)
            for (pos, lat, alive), lat_col, alive_col in (
                    (de, e_lat, e_alive), (dv, v_lat, v_alive)):
                lat_col[r, pos] = lat
                alive_col[r, pos] = alive

    def _delta_eng(self, d):
        """``sweep.last_delta`` → engine-coordinate (pos, lat, alive)
        triples for edges and vertices."""
        t = self.tables
        de = (t.eng_pos(d["e_enc"]).astype(np.int32),
              t.cast_times(d["e_lat"]), d["e_alive"].astype(bool))
        dv = (d["v_idx"].astype(np.int32), t.cast_times(d["v_lat"]),
              d["v_alive"].astype(bool))
        return de, dv

    def _apply_delta_to_base(self):
        """Scatter the sweep's last delta into the RUNNING host base
        (O(delta)); returns the delta in engine coordinates."""
        de, dv = self._delta_eng(self.sw.last_delta)
        be_lat, be_alive, bv_lat, bv_alive = self._delta_base
        be_lat[de[0]] = de[1]
        be_alive[de[0]] = de[2]
        bv_lat[dv[0]] = dv[1]
        bv_alive[dv[0]] = dv[2]
        return de, dv

    def _fold_deltas(self, hop_times, hop_callback=None,
                     assume_resident: bool = False):
        """Delta fold: the state at each batch's first hop (the base) plus
        per-hop touched-entity (pos, lat, alive) lists — the device
        rebuilds the hop columns (K1). Host work and H2D bytes are
        O(base + Σ delta) instead of O(H · m_pad). The base is a RUNNING
        array updated by O(delta) scatters, so chunked sweeps pay the
        full-table materialisation once, not per chunk; with a live
        device-resident base the batch ships no base at all.
        ``assume_resident=True`` is the lookahead's promise that the
        PREVIOUS group's dispatch will have left a resident base by the
        time this payload dispatches (a failed dispatch ends the run
        before the payload is used)."""
        f0 = _time.perf_counter()
        hop_times = [int(x) for x in hop_times]
        self._check_forward(hop_times)
        tdt = self.tables.tdtype
        deltas_e, deltas_v = [], []
        ship_base = None
        # a live device-resident base makes this batch all-delta: hop 0's
        # catch-up ships in the delta[0] slot instead of a base snapshot
        resident = assume_resident or self._dev_base is not None
        if resident and self._delta_base is None \
                and self.sw.t_prev is not None:
            # a parallel fold adopted a fork and dropped the running base:
            # rebuild it at the adopted clock, where the resident state is
            self._delta_base = list(self._materialise_base(self.sw))
        resident = resident and self._delta_base is not None
        empty = (np.empty(0, np.int32), np.empty(0, tdt),
                 np.empty(0, bool))
        for j, T in enumerate(hop_times):
            self.sw._advance(T)
            if hop_callback is not None:
                hop_callback(T, self.sw)
            if self._delta_base is None:
                # first batch, first hop: materialise from the full fold
                self._delta_base = list(self._materialise_base(self.sw))
            else:
                de, dv = self._apply_delta_to_base()
                if j > 0 or resident:
                    deltas_e.append(de)
                    deltas_v.append(dv)
            if j == 0 and not resident:
                # snapshot the running base as this batch's upload (the
                # arrays keep mutating through later hops)
                ship_base = tuple(a.copy() for a in self._delta_base)
                deltas_e.append(empty)
                deltas_v.append(empty)
        self.fold_seconds += _time.perf_counter() - f0
        return hop_times, (ship_base, deltas_e, deltas_v)

    def _fold_deltas_fork(self, sw, group, ship_base: bool, hop_callback):
        """The delta fold of one unit on a FORKED builder, the parallel
        twin of ``_fold_deltas``: no engine state is touched. With
        ``ship_base`` hop 0 is a full base snapshot (the first unit of a
        non-resident sweep); otherwise every hop is a delta, hop 0 the
        catch-up from the unit before — the serial fold's windows, so the
        assembled payload is byte-equal."""
        tdt = self.tables.tdtype
        deltas_e, deltas_v = [], []
        base = None
        empty = (np.empty(0, np.int32), np.empty(0, tdt),
                 np.empty(0, bool))
        for j, T in enumerate(group):
            sw._advance(T)
            if hop_callback is not None:
                hop_callback(T, sw)
            if j == 0 and ship_base:
                base = self._materialise_base(sw)
                deltas_e.append(empty)
                deltas_v.append(empty)
            else:
                de, dv = self._delta_eng(sw.last_delta)
                deltas_e.append(de)
                deltas_v.append(dv)
        return (base, deltas_e, deltas_v)


class HopBatchedPageRank(_HopBatched):
    """Windowed PageRank over a full hop sweep.

    ``run(hop_times, windows)`` returns ``(ranks, steps)`` with ranks
    ``[H*W, n_pad]`` ordered hop-major (hop 0's windows first), rows in the
    global dense vertex space (``self.tables.uv``), on the engine's device.
    ``device=None`` means the CUDA card (and raises without one).
    """

    supports_warm_start = True   # power iteration is a contraction

    def __init__(self, log: EventLog, damping: float = 0.85,
                 tol: float = 1e-7, max_steps: int = 20, device=None):
        super().__init__(log, device=device)
        self.damping, self.tol, self.max_steps = damping, tol, max_steps

    def _dispatch_cols(self, cols, hop_times, windows, r_init=None):
        return run_columns(
            self.tables, *_ship_columns(cols, self.device), hop_times,
            windows, damping=self.damping, tol=self.tol,
            max_steps=self.max_steps, edges=self._edges, r_init=r_init,
            device=self.device, layout=self._active_layout)

    def _dispatch_deltas(self, payload, hop_times, windows, r_init=None):
        base, deltas_e, deltas_v = payload
        base, h0 = self._delta_base_args(base)
        return self._run_delta(lambda: run_columns_delta(
            "pagerank", self.tables, base, deltas_e, deltas_v,
            hop_times, windows,
            algo_args=(float(self.damping), float(self.tol),
                       int(self.max_steps)),
            edges=self._edges, r_init=r_init, h0_delta=h0,
            ship_counter=self._count_ship, layout=self._active_layout,
            device=self.device))


class HopBatchedBFS(_HopBatched):
    """Windowed BFS hop counting over a full hop sweep; distances are f32
    with inf for unreached (SSSP-with-unit-weights semantics). Rows of the
    ``[H*W, n_pad]`` result are hop-major, columns in the global dense
    vertex space."""

    supports_epoch_warm = True   # min-merge seed (gate: _bfs_columns)

    def __init__(self, log: EventLog, seeds, directed: bool = False,
                 max_steps: int = 100, device=None):
        super().__init__(log, device=device)
        self._seeds = tuple(seeds)
        self.directed = directed
        self.max_steps = max_steps
        # seeds are fixed per engine: the dense seed mask uploads once
        self._seed_dev = None

    @property
    def seeds(self):
        """Seed vertex ids — fixed at construction (build a new engine for
        different seeds)."""
        return self._seeds

    @property
    def _seed(self):
        if self._seed_dev is None:
            self._seed_dev = torch.from_numpy(
                _seed_mask(self.tables, self.seeds)).to(self.device)
        return self._seed_dev

    def _dispatch_cols(self, cols, hop_times, windows, r_init=None):
        # r_init is never set here: no warm start on the host-column route
        return run_bfs_columns(
            self.tables, *_ship_columns(cols, self.device), hop_times,
            windows, self.seeds, directed=self.directed,
            max_steps=self.max_steps, edges=self._edges, device=self.device,
            layout=self._active_layout)

    def _dispatch_deltas(self, payload, hop_times, windows, r_init=None):
        # r_init is the cross-epoch warm seed (min-merged distances);
        # validity is gated by the caller (_bfs_columns docstring)
        base, deltas_e, deltas_v = payload
        base, h0 = self._delta_base_args(base)
        return self._run_delta(lambda: run_columns_delta(
            "bfs", self.tables, base, deltas_e, deltas_v, hop_times,
            windows, algo_args=(int(self.max_steps), bool(self.directed)),
            edges=self._edges, seed_mask=self._seed, r_init=r_init,
            h0_delta=h0, ship_counter=self._count_ship,
            layout=self._active_layout, device=self.device))


class HopBatchedSSSP(HopBatchedBFS):
    """Weighted min-plus traversal over a full hop sweep.

    Per-pair weights are the LATEST numeric value of ``weight_prop`` at
    each hop (the (time, event-row) tie-break of the per-view property
    join), folded as per-hop ``(pos, val)`` updates that the device
    rebuilds into a ``[m_pad, H]`` weight block (K6w); pairs that never
    set the key weigh 1.0, and so do stored NaNs (``SSSP.message``'s
    rule). Immutable keys (earliest-wins) are refused: the ascending fold
    is last-wins."""

    #: a weight update can RAISE a pair's weight — old distances become
    #: stale under-estimates, so SSSP never takes a cross-epoch seed
    supports_epoch_warm = False

    #: the weight fold advances a SEQUENTIAL cursor over the sorted update
    #: stream: its chunk folds cannot fork
    supports_parallel_fold = False

    def host_column_bytes(self, n_hops: int) -> int:
        extra = self.tables.m_pad * 4   # the weight base (delta route)
        if not self._use_delta_fold():
            extra = n_hops * self.tables.m_pad * 4   # [H, m_pad] f32 cols
        return super().host_column_bytes(n_hops) + extra

    def device_mask_bytes(self, n_cols: int) -> int:
        # the reference's accounting ([m_pad, C] f32 weights, [B, C]
        # binned), kept so the jobs layer's memory guard routes the same
        # ranges; the port's [m_pad, H] block is W times smaller
        return (super().device_mask_bytes(n_cols)
                + self._edge_len() * n_cols * 4)

    def __init__(self, log: EventLog, seeds, weight_prop: str,
                 directed: bool = False, max_steps: int = 100, device=None):
        super().__init__(log, seeds, directed=directed, max_steps=max_steps,
                         device=device)
        log = self.sw.log
        props = log.props
        if weight_prop in props._key_ids \
                and props.is_immutable(props._key_ids[weight_prop]):
            raise ValueError(
                f"{weight_prop!r} is an immutable (earliest-wins) key — "
                "the incremental weight fold is last-wins")
        self.weight_prop = weight_prop
        t = self.tables
        # every numeric row of the key on an EDGE_ADD event, sorted by
        # (time, event-row) — the order the per-view join picks "latest"
        # from — plus a running per-pair state row
        self._w_state = np.ones(t.m_pad, np.float32)
        self._w_t = np.empty(0, np.int64)
        self._w_val = np.empty(0, np.float32)
        self._w_pos = np.empty(0, np.int64)
        if weight_prop in props._key_ids:
            sel = ((props.column("key") == props._key_ids[weight_prop])
                   & (props.column("tag") == props.NUM_TAG))
            ev = props.column("event")[sel]
            is_add = log.column("kind")[ev] == EDGE_ADD
            ev = ev[is_add]
            val = props.column("num")[sel][is_add]
            # stored NaNs weigh 1.0 like missing values — a raw NaN would
            # poison the whole column through the relaxation
            val = np.where(np.isnan(val), 1.0, val)
            tt = log.column("time")[ev]
            order = np.lexsort((ev, tt))
            self._w_t = tt[order]
            self._w_val = val[order].astype(np.float32)
            enc = self.sw._pack(self.sw._dense(log.column("src")[ev]),
                                self.sw._dense(log.column("dst")[ev]))
            self._w_pos = t.eng_pos(enc)[order]
        self._w_cursor = 0

    def _extend(self, n_old: int) -> str:
        """Extend the sorted weight-update stream with the adopted rows'
        props (``raphtory_tpu/engine/hopbatch.py:1911``). The consumed
        prefix ``[:_w_cursor]`` is history (times <= t_prev); the
        unconsumed tail and the new updates (all past t_prev: the repin
        guard) merge by a STABLE sort on time alone, which keeps the
        (time, event-row) order: each block is in it, and every new event
        row is past every pinned one. A key that turned immutable
        (earliest-wins) rebuilds: ``__init__`` refuses it."""
        log = self.sw.log
        props = log.props
        if self.weight_prop not in props._key_ids:
            return "extended"
        kid = props._key_ids[self.weight_prop]
        if props.is_immutable(kid):
            return "rebuild"
        pe = props.column("event")
        sel = ((pe >= n_old) & (props.column("key") == kid)
               & (props.column("tag") == props.NUM_TAG))
        ev = pe[sel]
        is_add = log.column("kind")[ev] == EDGE_ADD
        ev = ev[is_add]
        if not len(ev):
            return "extended"
        val = props.column("num")[sel][is_add]
        val = np.where(np.isnan(val), 1.0, val).astype(np.float32)
        tt = log.column("time")[ev]
        order = np.lexsort((ev, tt))
        enc = self.sw._pack(self.sw._dense(log.column("src")[ev]),
                            self.sw._dense(log.column("dst")[ev]))
        pos = self.tables.eng_pos(enc)
        cur = self._w_cursor
        t_cat = np.concatenate([self._w_t[cur:], tt[order]])
        v_cat = np.concatenate([self._w_val[cur:], val[order]])
        p_cat = np.concatenate([self._w_pos[cur:], pos[order]])
        tail = np.argsort(t_cat, kind="stable")
        self._w_t = np.concatenate([self._w_t[:cur], t_cat[tail]])
        self._w_val = np.concatenate([self._w_val[:cur], v_cat[tail]])
        self._w_pos = np.concatenate([self._w_pos[:cur], p_cat[tail]])
        return "extended"

    def _column_specs(self, H: int) -> list:
        # the weight columns join the fold columns' staging buffer
        return super()._column_specs(H) + [((H, self.tables.m_pad),
                                            np.float32)]

    def _weight_cols(self, hop_times, cols):
        """Fill ``cols``, the host-column route's ``[H, m_pad]`` f32 weight
        columns: row j is the running per-pair weight state at
        ``hop_times[j]``."""
        for j, T in enumerate(hop_times):
            hi = int(np.searchsorted(self._w_t, T, side="right"))
            if hi > self._w_cursor:
                # ascending (time, row) order: last write = latest value
                self._w_state[self._w_pos[self._w_cursor:hi]] = \
                    self._w_val[self._w_cursor:hi]
                self._w_cursor = hi
            cols[j] = self._w_state

    def _fold_columns(self, hop_times, hop_callback=None):
        hop_times, cols = super()._fold_columns(hop_times, hop_callback)
        self._weight_cols(hop_times, cols[4])
        self.ship_bytes += cols[4].nbytes
        return hop_times, cols

    def _weight_deltas(self, hop_times, resident: bool = False):
        """Per-hop ``(pos, val)`` weight updates plus the running state at
        hop 0 of this batch (``w_base``). ``resident`` mirrors the mask
        fold's decision: hop 0's catch-up ships as delta[0] against the
        device-held weight state, and ``w_base`` is None."""
        wd = []
        w_base = None
        for j, T in enumerate(hop_times):
            hi = int(np.searchsorted(self._w_t, T, side="right"))
            pos = self._w_pos[self._w_cursor:hi].astype(np.int32)
            val = self._w_val[self._w_cursor:hi]
            if (j > 0 or resident) and len(pos):
                # last-wins per pair WITHIN the hop: the device scatter
                # takes each position once (its twin raises on a repeat)
                u_last = np.unique(pos[::-1], return_index=True)[1]
                sel = np.sort(len(pos) - 1 - u_last)
                pos, val = pos[sel], val[sel]
            if hi > self._w_cursor:
                self._w_state[self._w_pos[self._w_cursor:hi]] = \
                    self._w_val[self._w_cursor:hi]
                self._w_cursor = hi
            if j == 0 and not resident:
                # updates at/before hop 0 belong to the base
                w_base = self._w_state.copy()
                wd.append((pos[:0], val[:0]))
            else:
                wd.append((pos, val))
        return w_base, wd

    def _fold_deltas(self, hop_times, hop_callback=None,
                     assume_resident: bool = False):
        hop_times, payload = super()._fold_deltas(hop_times, hop_callback,
                                                  assume_resident)
        # payload[0] is None exactly when the mask fold went all-delta
        # against the device-resident base — the weight fold must match
        return hop_times, (*payload,
                           *self._weight_deltas(hop_times,
                                                resident=payload[0] is None))

    def _dispatch_cols(self, cols, hop_times, windows, r_init=None):
        # the weight columns ride the fold columns' one copy
        *cols, wcols = _ship_columns(cols, self.device)
        return run_bfs_columns(
            self.tables, *cols, hop_times, windows, self.seeds,
            directed=self.directed, max_steps=self.max_steps,
            edges=self._edges, weight_cols=wcols, device=self.device,
            layout=self._active_layout)

    def _dispatch_deltas(self, payload, hop_times, windows, r_init=None):
        base, deltas_e, deltas_v, w_base, w_deltas = payload
        base, h0 = self._delta_base_args(base)
        if h0:
            w_base = self._dev_base[4]   # device-resident weight state
        return self._run_delta(lambda: run_columns_delta(
            "bfs", self.tables, base, deltas_e, deltas_v, hop_times,
            windows, algo_args=(int(self.max_steps), bool(self.directed)),
            edges=self._edges, seed_mask=self._seed,
            weight_base=w_base, weight_deltas=w_deltas, h0_delta=h0,
            ship_counter=self._count_ship, layout=self._active_layout,
            device=self.device))


class HopBatchedCC(_HopBatched):
    """Windowed connected components over a full hop sweep; labels are
    global padded indices (``tables.uv[label]`` is the component's
    min vid)."""

    supports_epoch_warm = True   # min-merge seed (gate: _cc_columns)

    def __init__(self, log: EventLog, max_steps: int = 100, device=None):
        super().__init__(log, device=device)
        self.max_steps = max_steps

    def _dispatch_cols(self, cols, hop_times, windows, r_init=None):
        # r_init is never set here: no warm start on the host-column route
        return run_cc_columns(
            self.tables, *_ship_columns(cols, self.device), hop_times,
            windows, max_steps=self.max_steps, edges=self._edges,
            device=self.device, layout=self._active_layout)

    def _dispatch_deltas(self, payload, hop_times, windows, r_init=None):
        # r_init is the cross-epoch warm seed (min-merged labels);
        # validity is gated by the caller (_cc_columns docstring)
        base, deltas_e, deltas_v = payload
        base, h0 = self._delta_base_args(base)
        return self._run_delta(lambda: run_columns_delta(
            "cc", self.tables, base, deltas_e, deltas_v, hop_times,
            windows, algo_args=(int(self.max_steps),), edges=self._edges,
            r_init=r_init, h0_delta=h0, ship_counter=self._count_ship,
            layout=self._active_layout, device=self.device))
