"""The BSP superstep engine — the generic runner for every vertex program.

Replaces the reference's actor-driven superstep machinery (the
``AnalysisTask`` coordinator counting ``Ready``/``EndStep`` acks,
``ReaderWorker`` executing ``analyse()`` per shard, the double-buffered
mailboxes) as ``raphtory_tpu/engine/bsp.py`` does, with the JAX program
written out as torch code: the barrier is the host loop, quiescence is a
reduction read on the host once per superstep, and the message exchange
is a gather plus K7 (``ops/segment.segment_combine``).

Batched windows (``ReaderWorker.scala:180-187``) run as ONE flat graph of
k·n vertices and k·m edges: window w's segment ids are offset by w·n, and
the program's ``init``/``update``/``finalize`` are called once on ``[k, n]``
tensors (``engine/program.py``), so launches per superstep do not grow
with k. Halted windows freeze.

Two callers: ``run``/``run_async`` over a host ``GraphView`` (the cold
route: masks built on the host, both bit-packed into one pinned buffer,
shipped in one non-blocking copy and unpacked on the card by one K8u
launch) and the resident sweep (``engine/device_sweep.py``), which makes
its masks on the card (K9b) and calls ``make_mask_runner`` directly.

The cold route takes the destination-binned (PCPM) exchange where
``ops/partition.resolve`` bins the view's edge table (``RTPU_PCPM``, the
reference's auto rule): the destination direction combines with K7-P
(``ops/segment.partition_reduce``) over the view's layout, the reverse
direction keeps K7. The resident sweep stays unbinned, as in the
reference.

A ``combiner="custom"`` program reduces its payloads with its own
``exchange`` (``program.py``; LabelPropagation's K7-mode ``segment_mode``)
over the direction's ``SegmentCSR``, on every route, never binned.

An occurrence program (``needs_occurrences``: TaintTracking) runs the same
superstep over the multigraph of edge-add events instead of the
deduplicated edge table (``raphtory_tpu/engine/bsp.py:320-327``): the
view's ``occ_*`` rows are its edges, each with its own event time, and
its int64 state moves through the int64 instantiations of K7 / K7-P.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from ..core.snapshot import INT64_MIN, GraphView, _indptr
from ..ops import partition as _partition
from ..ops.resident import pack_view_masks, unpack_view_masks, upload
from ..ops.segment import (PartitionWalk, SegmentCSR, partition_reduce,
                           segment_combine)
from ..utils.device import resolve_device
from .device_sweep import DeviceEdges, normalize_windows
from .program import Context, Edges, VertexProgram

_ELEM = {"sum": torch.add, "min": torch.minimum, "max": torch.maximum}


def tree_map(fn, *trees):
    """``fn`` over the tensor leaves of dicts / lists / tuples of tensors
    (the program state and result pytrees)."""
    t0 = trees[0]
    if isinstance(t0, dict):
        return {key: tree_map(fn, *(t[key] for t in trees)) for key in t0}
    if isinstance(t0, (list, tuple)):
        return type(t0)(tree_map(fn, *leaves) for leaves in zip(*trees))
    return fn(*trees)


def check_program(program: VertexProgram) -> None:
    """Refuse a combiner this engine does not know."""
    if program.combiner not in _ELEM and program.combiner != "custom":
        raise ValueError(f"unknown combiner {program.combiner!r}")


def _check_custom(program: VertexProgram) -> None:
    if program.combiner == "custom" and program.direction == "both":
        raise ValueError(
            "combiner='custom' requires direction 'out' or 'in' — merging "
            "two custom aggregations is not well-defined")


def make_mask_runner(program: VertexProgram, n: int, m: int, k: int,
                     pcpm: PartitionWalk | None = None):
    """The superstep core over UNPACKED bool masks (``v_masks [k, n]``,
    ``e_masks [k, m]``) — ``raphtory_tpu/engine/bsp.py:70``. The returned
    ``run(v_masks, e_masks, vids, v_latest, v_first, edges, e_latest,
    e_first, time, windows, eprops, vprops)`` gives ``(result, steps)``:
    result leaves ``[k, n, ...]`` and the superstep count as an int.
    ``edges`` is a ``DeviceEdges`` (the (dst, src)-sorted endpoints and
    both CSRs over the real edges); arrays a program opts out of
    (``needs_*`` False) may be None. ``pcpm`` (the view layout's
    destination walk, through its ``perm``/``valid``) makes the
    destination-direction combine the binned one (K7-P); the reverse
    direction keeps K7's (``bsp.py:127-141``)."""
    check_program(program)
    _check_custom(program)
    op = program.combiner
    custom = op == "custom"

    def run(v_masks, e_masks, vids, v_latest, v_first, edges: DeviceEdges,
            e_latest, e_first, time: int, windows, eprops, vprops):
        dev = v_masks.device
        if not program.needs_vids:
            vids = torch.full((n,), -1, dtype=torch.int64, device=dev)
        if not program.needs_vertex_times:
            v_latest = torch.full((n,), INT64_MIN, dtype=torch.int64,
                                  device=dev)
            v_first = v_latest
        if not program.needs_edge_times:
            e_latest = torch.full((m,), INT64_MIN, dtype=torch.int64,
                                  device=dev)
            e_first = e_latest

        # flat (window-major) edge space: window w's ids offset by w*n
        voffs = torch.arange(k, dtype=torch.int64, device=dev)[:, None] * n
        flat_dst = (edges.e_dst.long()[None, :] + voffs).reshape(-1)
        flat_src = (edges.e_src.long()[None, :] + voffs).reshape(-1)
        em_flat = e_masks.reshape(-1)
        at_dst = SegmentCSR(edges.e_dst, edges.in_indptr, None)
        at_src = SegmentCSR(edges.e_src, edges.out_indptr, edges.out_perm)

        def tile_e(a):
            return a if k == 1 else a.repeat((k,) + (1,) * (a.dim() - 1))

        def combine(tree, csr):
            if custom:
                return tree_map(lambda a: a.reshape((k, n) + a.shape[1:]),
                                program.exchange(tree, csr, k * n, em_flat))
            if pcpm is not None and csr is at_dst:
                return tree_map(lambda x: partition_reduce(
                    x, pcpm, op, em_flat, k).reshape((k, n) + x.shape[1:]),
                    tree)
            return tree_map(lambda x: segment_combine(
                x, csr, op, em_flat, k).reshape((k, n) + x.shape[1:]), tree)

        # per-window degrees: one flat masked segment-sum each way (K7)
        ones = torch.ones(k * m, dtype=torch.int32, device=dev)
        in_deg = segment_combine(ones, at_dst, "sum", em_flat, k).reshape(k, n)
        out_deg = segment_combine(ones, at_src, "sum", em_flat,
                                  k).reshape(k, n)
        time_t = torch.full((k, 1), int(time), dtype=torch.int64, device=dev)
        win_t = torch.tensor(normalize_windows(windows), dtype=torch.int64,
                             device=dev).reshape(k, 1)
        n_active = v_masks.sum(dim=1, keepdim=True, dtype=torch.int32)

        def mk_ctx(step: int) -> Context:
            return Context(n=n, time=time_t, window=win_t, v_mask=v_masks,
                           vids=vids, v_latest_time=v_latest,
                           v_first_time=v_first, out_deg=out_deg,
                           in_deg=in_deg, n_active=n_active, step=step,
                           vprops=vprops)

        def flat_edges(step: int) -> Edges:
            # src/dst stay the per-window indices (programs compare them)
            return Edges(src=tile_e(edges.e_src), dst=tile_e(edges.e_dst),
                         mask=em_flat, time=tile_e(e_latest),
                         first_time=tile_e(e_first),
                         props={key: tile_e(v) for key, v in eprops.items()},
                         step=step)

        def gather_flat(state, ids):
            return tree_map(
                lambda a: a.reshape((k * n,) + a.shape[2:])[ids], state)

        def step_all(st, step: int):
            ek = flat_edges(step)
            agg = None
            if program.direction in ("out", "both"):
                agg = combine(program.message(gather_flat(st, flat_src), ek),
                              at_dst)
            if program.direction in ("in", "both"):
                agg_in = combine(
                    program.message(gather_flat(st, flat_dst), ek), at_src)
                agg = agg_in if agg is None else tree_map(_ELEM[op], agg,
                                                          agg_in)
            new, votes = program.update(st, agg, mk_ctx(step))
            return new, (votes | ~v_masks).all(dim=1)

        state = program.init(mk_ctx(0))
        steps = 0
        if program.max_steps > 0:
            halted = torch.zeros(k, dtype=torch.bool, device=dev)
            while steps < program.max_steps:
                new_state, new_halt = step_all(state, steps)
                # halted windows keep their state (bsp.py:220-227)
                state = tree_map(lambda old, new: torch.where(
                    halted.reshape((k,) + (1,) * (new.dim() - 1)), old, new),
                    state, new_state)
                halted = halted | new_halt
                steps += 1
                if bool(halted.all()):   # the one host read per superstep
                    break
        return program.finalize(state, mk_ctx(steps)), steps

    return run


def _occ_count(view: GraphView) -> int:
    """The real occurrence rows of a view (they lead; the pads follow)."""
    return int((view._occ_rows >= 0).sum())


def view_edges(view: GraphView, device,
               occurrences: bool = False) -> DeviceEdges:
    """A view's edge tables on ``device``: its (dst, src)-sorted endpoints
    (pads dst = src = n_pad-1), the destination CSR and the source-ordered
    index over the REAL edges only (the pads stay out of both CSRs).
    ``occurrences``: the same over the occurrence rows, whose CSRs the
    view does not carry (built here from ``occ_dst`` / ``occ_src``)."""
    if occurrences:
        o, n = _occ_count(view), view.n_pad
        src = view.occ_src[:o]
        host = (view.occ_src, view.occ_dst,
                _indptr(view.occ_dst[:o], n).astype(np.int64),
                np.argsort(src, kind="stable").astype(np.int32),
                _indptr(src, n).astype(np.int64))
    else:
        m = int(view.m_active)
        host = (view.e_src, view.e_dst, view.in_indptr.astype(np.int64),
                view.out_order[:m].astype(np.int32),
                view.out_indptr.astype(np.int64))
    return DeviceEdges(*(torch.from_numpy(np.ascontiguousarray(a)).to(device)
                         for a in host))


def _view_layout(view: GraphView, occurrences: bool = False):
    """Destination-binned layout for a view's edge table (or its
    occurrence rows), or None when ``RTPU_PCPM`` keeps the flat exchange
    (``raphtory_tpu/engine/bsp.py:255-271``). Knobs are read HERE, at
    dispatch. ``m`` is the REAL row count: the pad tail must become invalid
    cap-pad slots, not edges that grow the last partition by the pad
    count."""
    if occurrences:
        tables = _partition.HostTables(view.occ_src, view.occ_dst,
                                       view.n_pad, _occ_count(view))
    else:
        tables = _partition.HostTables(view.e_src, view.e_dst, view.n_pad,
                                       int(view.m_active))
    return _partition.resolve(view, tables, _partition.tile_budget_bytes(),
                              tag="occ" if occurrences else "e")


def _gather_props(view: GraphView, keys, kind: str, device) -> dict:
    """Each property as f32 on ``device``: per vertex (``"v"``), per
    deduplicated edge (``"e"``) or per occurrence, the value of its own
    event (``"occ"``)."""
    read = {"v": view.vertex_prop, "e": view.edge_prop,
            "occ": view.occ_prop}[kind]
    return {name: torch.from_numpy(np.asarray(read(name), np.float32))
            .to(device) for name in keys}


#: the cold route's dispatch seconds by stage (``mask_build``, ``pack``,
#: ``mask_upload_unpack``, ``view_edges``, ``props``, ``layout``,
#: ``supersteps``), summed over ``run_async`` calls while it is a dict;
#: each stage then closes with a device sync. None: no clock, no syncs.
STAGE_SECONDS: dict | None = None


def _stage_clock(device):
    """``mark(stage)``: adds the seconds since the previous mark (the
    first: since this call) to ``STAGE_SECONDS[stage]``, after a device
    sync; a no-op while ``STAGE_SECONDS`` is None."""
    split = STAGE_SECONDS
    if split is None:
        return lambda stage: None
    last = [time.perf_counter()]

    def mark(stage):
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        now = time.perf_counter()
        split[stage] = split.get(stage, 0.0) + now - last[0]
        last[0] = now
    return mark


def run_async(program: VertexProgram, view: GraphView, *,
              window: int | None = None, windows=None, device=None):
    """Run a vertex program against a host view on ``device`` (None: the
    CUDA card) — ``raphtory_tpu/engine/bsp.py:287``. The torch engine
    blocks once per superstep for its halting read, so the result is ready
    on return; the name keeps the reference's surface.

    window=None, windows=None → plain view ({View,Range}AnalysisTask).
    window=w                  → single window (Windowed*).
    windows=[w0 > w1 > ...]   → batched windows, one result per window
                                (BWindowed*; leading axis on the result).
    """
    _check_custom(program)
    device = resolve_device(device)
    check_program(program)
    batched = windows is not None
    if windows is not None and len(windows) == 0:
        raise ValueError("windows must be a non-empty list of window sizes")
    if windows is None:
        windows = [window if window is not None else -1]
    wlist = normalize_windows(windows)
    k = len(wlist)
    mark = _stage_clock(device)

    # an occurrence program's edges are the edge-add events of the edges
    # alive at T, each with its own time (``getOutgoingNeighborsAfter``,
    # VertexVisitor.scala:33)
    occ = program.needs_occurrences
    if occ:
        if view.occ_src is None:
            raise ValueError(
                "program needs occurrences: build the view with "
                "include_occurrences=True")
        e_latest = e_first = view.occ_time
        e_base_mask = view.occ_mask
    else:
        e_latest, e_first = view.e_latest_time, view.e_first_time
        e_base_mask = view.e_mask
    n_pad, m_pad = view.n_pad, len(e_base_mask)

    v_masks = np.empty((k, n_pad), bool)
    e_masks = np.empty((k, m_pad), bool)
    for i, w in enumerate(wlist):
        if w < 0:
            v_masks[i] = view.v_mask
            e_masks[i] = e_base_mask
        else:
            # the vertex half of ``view.window_masks([w])``, its int64 bound
            lo = (view.time - np.asarray([w], np.int64))[0]
            v_masks[i] = view.v_mask & (view.v_latest_time >= lo)
            e_masks[i] = e_base_mask & (e_latest >= view.time - w)
    mark("mask_build")
    # both masks bit-packed into one buffer (pinned for a card), one
    # non-blocking copy, one K8u launch
    packed = pack_view_masks(v_masks, e_masks, pin=device.type == "cuda")
    mark("pack")
    v_dev, e_dev = unpack_view_masks(upload(packed, device), k, n_pad,
                                     m_pad)
    mark("mask_upload_unpack")
    edges = view_edges(view, device, occ)
    mark("view_edges")

    def put(a, needed):
        return torch.from_numpy(a).to(device) if needed else None

    needs_vt, needs_et = program.needs_vertex_times, program.needs_edge_times
    tables = (put(view.vids, program.needs_vids),
              put(view.v_latest_time, needs_vt),
              put(view.v_first_time, needs_vt),
              put(e_latest, needs_et), put(e_first, needs_et),
              _gather_props(view, program.edge_props, "occ" if occ else "e",
                            device),
              _gather_props(view, program.vertex_props, "v", device))
    mark("props")
    # the layout only where the binned exchange can engage: a custom
    # exchange or an in-only program never takes the destination combine.
    # The port is no TPU backend, so sum programs bin too (the reference's
    # non-TPU branch, bsp.py:350-356)
    binnable = (program.combiner != "custom"
                and program.direction in ("out", "both"))
    layout = _view_layout(view, occ) if binnable else None
    walk = None
    if layout is not None:
        be = layout.device_edges(device)
        walk = PartitionWalk(be.in_indptr, be.in_order, be.perm, be.valid)
    mark("layout")
    runner = make_mask_runner(program, n_pad, m_pad, k, walk)
    vids, v_latest, v_first, e_lat, e_fst, eprops, vprops = tables
    result, steps = runner(v_dev, e_dev, vids, v_latest, v_first, edges,
                           e_lat, e_fst, int(view.time), wlist, eprops,
                           vprops)
    mark("supersteps")
    if not batched:
        result = tree_map(lambda a: a[0], result)
    return result, steps


def run(program: VertexProgram, view: GraphView, *,
        window: int | None = None, windows=None, device=None):
    """``(result, int steps)`` of ``program`` on ``view`` (``run_async``;
    ``raphtory_tpu/engine/bsp.py:395``)."""
    return run_async(program, view, window=window, windows=windows,
                     device=device)
