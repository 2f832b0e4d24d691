"""Sparse frontier collectives — the third comm route (``comm="sparse"``),
K13.

Port of ``raphtory_tpu/parallel/frontier.py``. The dense routes ship state
sized by the GRAPH every superstep; this one ships state sized by the
FRONTIER:

* Each rank runs one superstep over its FULL state replica ``[k, n_pad]``
  using only the edge blocks of the vertex shards it owns (one owner per
  shard: the rank at window coordinate 0). A row's complete aggregate is
  computed by its owner; non-owned rows keep the replica's value.
* The changed rows are compacted on the device (``ops/exchange.
  frontier_count``: one pass writes the ascending indices and values and
  leaves the count on the device; ``frontier_compact`` pads them to a
  bucket of ``ops.partition.frontier_bucket`` slots).
* One all-gather of every rank's ``(count, unhalted)`` agrees the bucket
  length and the halting vote, one all-gather moves the slices, and
  ``frontier_merge_min`` min-merges them into every replica. Monotonicity
  makes the merge exact, so the replica is BITWISE the dense routes'
  state.
* A world of one rank runs the whole sweep without an exchange, and
  still accounts the slots each superstep would have shipped.

The rows, bytes, density and fallback-superstep accounting are the
reference's (``frontier.py:409-533``). Eligibility is the
``VertexProgram.monotone_min`` contract.
"""

from __future__ import annotations

import time as _time

import numpy as np
import torch

from ..engine.bsp import _ELEM, tree_map
from ..engine.program import Context, Edges, VertexProgram
from ..ops.exchange import (frontier_compact, frontier_count,
                            frontier_merge_min, min_identity)
from ..ops.partition import frontier_bucket, sparse_bucket_floor
from ..ops.segment import SegmentCSR, segment_combine
from .sharded import V_AXIS, _window_masks, leaves

#: global frontier density past which a sparse slot (index + value) moves
#: more bytes than the dense row it encodes — supersteps above it count
#: as fallback supersteps
CROSSOVER_DENSITY = 1.0 / 3.0

#: cold-start density prior the route chooser uses before any measured
#: history exists for an (algorithm, window-batch) key
PRIOR_DENSITY = 0.05


def supported(program: VertexProgram) -> bool:
    """Sparse-route eligibility: the program declares the monotone
    min-merge contract (``engine/program.py`` ``monotone_min``)."""
    return (bool(getattr(program, "monotone_min", False))
            and program.combiner == "min")


def owned_shards(mesh) -> list[int]:
    """Vertex shards this rank owns: shard s belongs to the rank at
    (window 0, vertex s) — one owner per shard even when the window axis
    spans ranks."""
    return [s for s in range(mesh.shape[V_AXIS]) if s == mesh.rank]


def _flat_blocks(sv, owned, wlist, time):
    """The owned shards' edge blocks as flat GLOBAL-index arrays, per-window
    masks, and each direction's real (non-pad) slots — the combine CSR's
    rows (``frontier.py:293``)."""
    n_loc = sv.n_loc
    offs = (np.asarray(owned, np.int64) * n_loc).astype(np.int32)
    sel = list(owned)

    def flat(a):
        return a[sel].reshape(-1)

    def real(count, m_loc):
        return np.concatenate([i * m_loc + np.arange(int(count[s]))
                               for i, s in enumerate(sel)]
                              or [np.empty(0, np.int64)])

    d_time, s_time = flat(sv.d_time), flat(sv.s_time)
    d_masks = _window_masks(flat(sv.d_mask), d_time, wlist, time)
    s_masks = _window_masks(flat(sv.s_mask), s_time, wlist, time)
    return {
        "d_src": flat(sv.d_src_g),
        "d_dst": (sv.d_dst_l[sel] + offs[:, None]).reshape(-1),
        "d_masks": d_masks, "d_time": d_time, "d_first": flat(sv.d_first),
        "d_props": {p: flat(a) for p, a in sv.d_props.items()},
        "d_real": real(sv.d_count, sv.m_loc_d),
        "s_dst": flat(sv.s_dst_g),
        "s_src": (sv.s_src_l[sel] + offs[:, None]).reshape(-1),
        "s_masks": s_masks, "s_time": s_time, "s_first": flat(sv.s_first),
        "s_props": {p: flat(a) for p, a in sv.s_props.items()},
        "s_real": real(sv.s_count, sv.m_loc_s),
    }


def _csr(ids: torch.Tensor, real: np.ndarray, n: int) -> SegmentCSR:
    """Combine CSR over the real slots ``real`` (ascending; their ids are
    sorted: shard-local sorted ids plus ascending shard offsets)."""
    dev = ids.device
    rr = torch.from_numpy(real.astype(np.int64)).to(dev)
    indptr = torch.zeros(n + 1, dtype=torch.int64, device=dev)
    indptr[1:] = torch.cumsum(torch.bincount(ids.long()[rr], minlength=n), 0)
    return SegmentCSR(ids, indptr, rr.to(torch.int32))


class _Superstep:
    """One rank's superstep over its owned blocks on the full replica
    (``_frontier_runner``, ``frontier.py:99``): ``init``, ``step`` (the
    new state, the changed-row mask of owned rows and the unhalted count)
    and ``finalize``."""

    def __init__(self, program, view, sv, owned, wlist, device):
        self.program = program
        k = self.k = len(wlist)
        n_pad = self.n_pad = int(view.n_pad)
        T = int(view.time)
        b = _flat_blocks(sv, owned, wlist, T)

        def put(a):
            return torch.from_numpy(np.ascontiguousarray(a)).to(device)

        def tile(a):
            return a if k == 1 else a.repeat((k,) + (1,) * (a.dim() - 1))

        owned_mask = np.zeros(n_pad, bool)
        for s in owned:
            owned_mask[s * sv.n_loc:(s + 1) * sv.n_loc] = True
        self.owned = put(owned_mask)
        v_mask = np.asarray(view.v_mask).reshape(-1)
        v_latest = np.asarray(view.v_latest_time).reshape(-1)
        self.v_masks = put(_window_masks(v_mask, v_latest, wlist, T))
        self.vids = put(np.asarray(view.vids).reshape(-1))
        self.v_latest = put(v_latest)
        self.v_first = put(np.asarray(view.v_first_time).reshape(-1))
        self.vprops = {p: put(np.asarray(view.vertex_prop(p), np.float32))
                       for p in program.vertex_props}
        self.time_t = torch.full((k, 1), T, dtype=torch.int64,
                                 device=device)
        self.win_t = put(np.asarray(wlist, np.int64)).reshape(k, 1)
        woffs = torch.arange(k, dtype=torch.int64, device=device)[:, None]

        def flat_ids(a):
            return (a.long()[None, :] + woffs * n_pad).reshape(-1)

        self.dm = put(b["d_masks"]).reshape(-1)
        self.sm = put(b["s_masks"]).reshape(-1)
        d_src, d_dst = put(b["d_src"]), put(b["d_dst"])
        s_dst, s_src = put(b["s_dst"]), put(b["s_src"])
        self.at_dst = _csr(d_dst, b["d_real"], n_pad)
        self.at_src = _csr(s_src, b["s_real"], n_pad)
        self.fl_d_src, self.fl_s_dst = flat_ids(d_src), flat_ids(s_dst)
        keys = program.edge_props
        self.d_edges = dict(src=tile(d_src), dst=tile(d_dst), mask=self.dm,
                            time=tile(put(b["d_time"])),
                            first_time=tile(put(b["d_first"])),
                            props={p: tile(put(a)) for p, a
                                   in b["d_props"].items() if p in keys})
        self.s_edges = dict(src=tile(s_src), dst=tile(s_dst), mask=self.sm,
                            time=tile(put(b["s_time"])),
                            first_time=tile(put(b["s_first"])),
                            props={p: tile(put(a)) for p, a
                                   in b["s_props"].items() if p in keys})
        ones_d = torch.ones(self.dm.shape[0], dtype=torch.int32,
                            device=device)
        ones_s = torch.ones(self.sm.shape[0], dtype=torch.int32,
                            device=device)
        # degrees from the owned edge subset only: the monotone-min
        # contract forbids reading them
        self.in_deg = segment_combine(ones_d, self.at_dst, "sum", self.dm,
                                      k).reshape(k, n_pad)
        self.out_deg = segment_combine(ones_s, self.at_src, "sum", self.sm,
                                       k).reshape(k, n_pad)
        self.n_active = self.v_masks.sum(dim=1, keepdim=True,
                                         dtype=torch.int32)

    def ctx(self, step: int) -> Context:
        # the GLOBAL context: the full replica, offset 0, no mesh axis
        return Context(n=self.n_pad, time=self.time_t, window=self.win_t,
                       v_mask=self.v_masks, vids=self.vids,
                       v_latest_time=self.v_latest,
                       v_first_time=self.v_first, out_deg=self.out_deg,
                       in_deg=self.in_deg, n_active=self.n_active,
                       step=step, vprops=self.vprops)

    def init(self):
        return self.program.init(self.ctx(0))

    def step(self, state, step: int):
        prog, k, n_pad = self.program, self.k, self.n_pad
        op = prog.combiner

        def gather(ids):
            return tree_map(lambda a: a.reshape(
                (k * n_pad,) + tuple(a.shape[2:]))[ids], state)

        def combine(tree, csr, mask):
            return tree_map(lambda x: segment_combine(x, csr, op, mask, k)
                            .reshape((k, n_pad) + x.shape[1:]), tree)

        agg = None
        if prog.direction in ("out", "both"):
            agg = combine(prog.message(gather(self.fl_d_src),
                                       Edges(step=step, **self.d_edges)),
                          self.at_dst, self.dm)
        if prog.direction in ("in", "both"):
            agg_in = combine(prog.message(gather(self.fl_s_dst),
                                          Edges(step=step, **self.s_edges)),
                             self.at_src, self.sm)
            agg = agg_in if agg is None else tree_map(_ELEM[op], agg, agg_in)
        new, votes = prog.update(state, agg, self.ctx(step))
        # non-owned rows belong to their owners' supersteps: keep the
        # replica's merged value whatever update produced
        own = self.owned
        new = tree_map(lambda nw, old: torch.where(
            own.reshape((1, n_pad) + (1,) * (nw.dim() - 2)), nw, old),
            new, state)
        unhalted = ((~(votes | ~self.v_masks)) & own[None, :]).sum()
        changed = torch.zeros((k, n_pad), dtype=torch.bool,
                              device=own.device)
        for nw, old in zip(leaves(new), leaves(state)):
            diff = nw != old
            if diff.dim() > 2:
                diff = diff.flatten(2).any(dim=2)
            changed |= diff
        return new, changed & own[None, :], unhalted

    def finalize(self, state, steps: int):
        return self.program.finalize(state, self.ctx(steps))


def run_sparse(program: VertexProgram, view, mesh, sv, wlist,
               *, multi: bool):
    """The sparse-frontier superstep loop (``frontier.py:337``). Returns
    ``(result tree [k, n_pad, ...], steps, acct)``, ``acct`` the exchange
    accounting the dispatcher folds into ``COLLECTIVES``. Every collective
    is the same on every rank: bucket lengths and halting derive from the
    all-gathered counts, never from rank-local state."""
    if not supported(program):
        raise ValueError(
            f"{type(program).__name__} is not sparse-route eligible: "
            "comm='sparse' needs the monotone_min contract "
            "(engine/program.py)")
    k = len(wlist)
    n_pad = int(view.n_pad)
    owned = owned_shards(mesh)
    sup = _Superstep(program, view, sv, owned, wlist, mesh.device)
    state = sup.init()
    st_leaves = leaves(state)
    if len(st_leaves) != 1:
        raise ValueError(
            f"{type(program).__name__}.monotone_min promises a single "
            f"state leaf; init() returned {len(st_leaves)}")
    leaf = st_leaves[0]
    identity = min_identity(leaf.dtype)
    trailing = tuple(leaf.shape[2:])
    trail_items = int(np.prod(trailing, dtype=np.int64)) if trailing else 1
    slot_bytes = 8 + leaf.element_size() * trail_items
    floor = sparse_bucket_floor()
    n_procs = mesh.n_processes
    world = mesh.world

    steps = 0
    rows_total = bytes_total = fallback_steps = 0
    density_sum = barrier_wait = 0.0
    if not multi:
        # one participating rank: no exchange between supersteps; the
        # changed counts still account the slots each would have shipped
        unh = 1
        while steps < program.max_steps and unh > 0:
            state, changed, unhalted = sup.step(state, steps)
            cnt, unh = (int(x) for x in torch.stack(
                [changed.sum(), unhalted]).tolist())
            B = frontier_bucket(cnt, floor, cap=k * n_pad)
            rows_total += B
            bytes_total += B * slot_bytes
            density = cnt / float(k * n_pad)
            density_sum += density
            fallback_steps += density > CROSSOVER_DENSITY
            steps += 1
    halted = False
    while multi and steps < program.max_steps and not halted:
        new, changed, unhalted = sup.step(state, steps)
        ch = changed.reshape(-1)
        flat_new = leaves(new)[0].reshape((k * n_pad,) + trailing)
        # the count pass compacts too and leaves the count on the device
        counted = frontier_count(ch, flat_new)
        # counts first: ONE agreement round fixes the bucket length and
        # the halting vote for every rank; reading it is the superstep's
        # one host sync
        t_bar = _time.perf_counter()
        mine = torch.cat([counted.count,
                          unhalted.to(torch.int64).reshape(1)])
        counts = world.all_gather(mine)
        counts_h = counts.cpu()
        cmax = int(counts_h[:, 0].max())
        cglobal = int(counts_h[:, 0].sum())
        unh_g = int(counts_h[:, 1].sum())
        B = frontier_bucket(cmax, floor, cap=k * n_pad)
        if cmax > B:
            raise ValueError(f"sparse route: {cmax} changed rows > bucket "
                             f"{B}")
        idx, val = frontier_compact(
            flat_new, ch, B, identity,
            counted._replace(host=int(counts_h[world.index, 0])))
        idx_all = world.all_gather(idx).reshape(-1)
        val_all = world.all_gather(val).reshape((-1,) + trailing)
        barrier_wait += _time.perf_counter() - t_bar
        # min-merge every rank's slice into the replica: identity pads and
        # own rows are no-ops and merge order cannot matter
        base = leaves(state)[0].reshape((k * n_pad,) + trailing).clone()
        frontier_merge_min(base, idx_all, val_all, counts[:, 0])
        merged = base.reshape((k, n_pad) + trailing)
        state = tree_map(lambda _: merged, state)
        rows_step = B * n_procs
        density = cglobal / float(k * n_pad)
        density_sum += density
        fallback_steps += density > CROSSOVER_DENSITY
        rows_total += rows_step
        bytes_total += rows_step * slot_bytes + 16 * n_procs
        steps += 1
        halted = unh_g == 0

    result = sup.finalize(state, steps)
    acct = {
        "rows": rows_total,
        "bytes": bytes_total,
        "supersteps": steps,
        "barrier_wait": barrier_wait,
        "density": (density_sum / steps) if steps else 0.0,
        "fallback_supersteps": int(fallback_steps),
        "processes": n_procs,
        "owned_shards": len(owned),
    }
    return result, steps, acct
