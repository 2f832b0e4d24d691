"""Vertex-sharded supersteps over the ranks of a process group — K11.

Port of ``raphtory_tpu/parallel/sharded.py``. The reference runs one
``shard_map`` program over a (windows, vertices) device mesh in one
process; here a mesh is a process group laid out as (windows, vertices),
one rank per coordinate (rank ``w * S + v``), each rank on its own device
(``cluster/bootstrap.py``). A world of one rank is the degenerate
one-card mesh.

* The padded vertex space is range-partitioned over the vertex axis
  (``partition_view``, host numpy, bitwise the reference's, halo pages
  included); edges are partitioned twice, by destination shard (the
  out-direction combines at the destination) and by source shard (the
  in-direction). Each rank uploads only its own shard's blocks.
* A superstep (``_run_local``) moves remote neighbour state by one of
  two routes: ``all_gather`` (the vertex axis replicates the state) or
  ``halo`` (each rank packs the rows its peers reference into a send page
  with the ``halo_pack`` kernel, one ``all_to_all``, then ``[local |
  halo]``). Then the gather + ``message``, the combine through K7
  ``segment_combine`` (or the program's custom ``exchange``) over the
  shard's CSR, ``update``, and the per-window halt: an all-reduce over
  the vertex axis, so a window halts only on GLOBAL quiescence; the loop
  runs while any window anywhere is unhalted.
* A third route, ``sparse``, ships only the changed rows (monotone-min
  programs, ``parallel/frontier.py``). ``choose_route`` picks per
  dispatch, the reference's byte model and decision table.
* ``finalize``, then every rank all-gathers the results into global
  vertex order.

``CollectiveStats`` / ``COLLECTIVES`` keep the reference's accounting of
what each route moved; the chooser reads its measured frontier density.
An occurrence program (TaintTracking) runs over the view's occurrence rows:
``partition_view(..., occurrences=True)`` scatters the multigraph's
edge-add events, each with its own time and ``occ_prop`` values, into the
blocks (``sharded.py:595-613``), and its int64 state moves through the
same all_gather / halo exchange and the int64 K7.
The reference's tracing, journal, ledger, metrics and mesh-sanitizer hooks
are not ported (ROADMAP queue 1 items 6-8).
"""

from __future__ import annotations

import os
import threading
import time as _time
from collections import deque
from dataclasses import dataclass

import numpy as np
import torch

from ..cluster import bootstrap as _boot
from ..core.snapshot import INT64_MIN, GraphView
from ..engine.bsp import _ELEM, _check_custom, check_program, tree_map
from ..engine.program import Context, Edges, VertexProgram
from ..obs import device as _obs_device
from ..obs import journal as _journal
from ..obs import ledger as _ledger
from ..obs.trace import TRACER
from ..ops.exchange import halo_pack
from ..ops.segment import SegmentCSR, segment_combine
from ..utils.device import resolve_device

V_AXIS = "vertices"
W_AXIS = "windows"


class CollectiveStats:
    """Process-wide accounting of what the cross-shard exchanges moved
    (``raphtory_tpu/parallel/sharded.py:73``): per (route, direction)
    dispatches, supersteps, rows, bytes and seconds; the partition skew;
    the measured frontier density per (algorithm, window-batch) key — the
    route chooser's input — and the decision log. Thread-safe."""

    def __init__(self):
        self._lock = threading.Lock()
        self._routes: dict[tuple, dict] = {}
        self._skew: dict | None = None
        self._skew_builds = 0
        self._skew_refreshes = 0
        self._frontier: dict[str, deque] = {}
        self._route_log: deque = deque(maxlen=64)
        self._route_counts: dict[tuple, int] = {}

    def note_partition(self, skew: dict) -> None:
        with self._lock:
            self._skew = skew
            self._skew_builds += 1

    def note_exchange(self, route: str, direction: str, *, rows: int,
                      bytes_: int, seconds: float, supersteps: int,
                      barrier_wait: float = 0.0) -> None:
        with self._lock:
            d = self._routes.setdefault((route, direction), {
                "dispatches": 0, "supersteps": 0, "rows": 0, "bytes": 0,
                "seconds": 0.0, "barrier_wait_seconds": 0.0})
            d["dispatches"] += 1
            d["supersteps"] += int(supersteps)
            d["rows"] += int(rows)
            d["bytes"] += int(bytes_)
            d["seconds"] += float(seconds)
            d["barrier_wait_seconds"] += float(barrier_wait)

    def note_skew_refresh(self, skew: dict) -> None:
        with self._lock:
            self._skew = skew
            self._skew_refreshes += 1

    def note_route_decision(self, decision: dict) -> None:
        algo = str(decision.get("algorithm", "?"))
        route = str(decision.get("route", "?"))
        with self._lock:
            self._route_log.append(dict(decision))
            key = (algo, route)
            self._route_counts[key] = self._route_counts.get(key, 0) + 1

    def note_frontier(self, key: str, density: float,
                      supersteps: int) -> None:
        with self._lock:
            dq = self._frontier.setdefault(key, deque(maxlen=32))
            dq.append((float(density), int(supersteps)))

    def frontier_hint(self, key: str) -> float | None:
        """Mean measured frontier density for ``key`` (None: no
        history)."""
        with self._lock:
            dq = self._frontier.get(key)
            if not dq:
                return None
            return sum(d for d, _ in dq) / len(dq)

    def snapshot(self) -> dict:
        with self._lock:
            routes = {f"{r}/{d}": dict(v)
                      for (r, d), v in sorted(self._routes.items())}
            skew = dict(self._skew) if self._skew else None
            builds = self._skew_builds
            refreshes = self._skew_refreshes
            density = {k: round(sum(d for d, _ in dq) / len(dq), 6)
                       for k, dq in sorted(self._frontier.items()) if dq}
            table = {
                "counts": {f"{a}/{r}": n for (a, r), n
                           in sorted(self._route_counts.items())},
                "recent": [dict(d) for d in list(self._route_log)[-8:]],
            }
        for v in routes.values():
            v["seconds"] = round(v["seconds"], 6)
            v["barrier_wait_seconds"] = round(
                v["barrier_wait_seconds"], 6)
        return {"routes": routes, "skew": skew, "skew_builds": builds,
                "skew_refreshes": refreshes,
                "frontier_density": density, "route_table": table}

    def clear(self) -> None:
        with self._lock:
            self._routes.clear()
            self._skew = None
            self._skew_builds = 0
            self._skew_refreshes = 0
            self._frontier.clear()
            self._route_log.clear()
            self._route_counts.clear()


#: process-wide collective accounting every mesh dispatch records into
COLLECTIVES = CollectiveStats()


def shard_skew(**kinds) -> dict:
    """Per-shard row-count skew summary: for each named kind (an array of
    per-shard counts), the histogram plus max/mean; ``skew`` 1.0 is
    perfectly balanced."""
    out = {}
    for kind, arr in kinds.items():
        a = np.asarray(arr, np.float64).reshape(-1)
        mean = float(a.mean()) if a.size else 0.0
        mx = float(a.max()) if a.size else 0.0
        out[kind] = {
            "per_shard": [int(x) for x in a],
            "max": int(mx),
            "mean": round(mean, 2),
            "skew": round(mx / mean, 4) if mean > 0 else 1.0,
        }
    return out


def sampled_skew(sv, max_cols: int = 1 << 16) -> dict:
    """Post-ingest recompute of the per-shard edge skew from the CURRENT
    block masks, column-sampled at a deterministic stride past
    ``max_cols``; the static halo histogram carries over."""
    def counts(mask):
        m = mask.shape[1]
        step = max(1, m // max_cols)
        c = np.count_nonzero(mask[:, ::step], axis=1).astype(np.float64)
        return c * step

    skew = shard_skew(edges_dst=counts(sv.d_mask),
                      edges_src=counts(sv.s_mask))
    if sv.skew:
        for kind in ("halo_dst", "halo_src"):
            if kind in sv.skew:
                skew[kind] = dict(sv.skew[kind])
    return skew


def refresh_partition_skew(sv) -> dict:
    """Recompute and republish the skew of an existing partition from its
    live masks, stamped onto the sharded view."""
    skew = sampled_skew(sv)
    sv.skew = skew
    COLLECTIVES.note_skew_refresh(skew)
    return skew


#: comm routes a dispatch can take
COMM_ROUTES = ("halo", "all_gather", "sparse")


def _dense_auto(sv, view, program, S: int) -> str:
    """The pre-sparse auto rule: halo wins when the referenced remote rows
    are fewer than the remote rows all_gather would replicate; ties go to
    all_gather."""
    return ("halo" if S > 1
            and sv.halo_rows(program.direction) < view.n_pad - sv.n_loc
            else "all_gather")


def _partition_floor() -> int:
    from ..ops.partition import sparse_bucket_floor

    return sparse_bucket_floor()


def choose_route(program, view, sv, mesh, requested: str, k: int,
                 multi: bool, *, env: str | None = None,
                 density_hint: float | None = None) -> dict:
    """The comm-route decision record of one dispatch
    (``raphtory_tpu/parallel/sharded.py:308``): route, reason and the
    evidence — the byte model of each route per superstep, the measured or
    prior frontier density, the skew and the route history. Every input
    is the same on every rank. ``mesh`` needs ``shape``, ``n_devices``
    and ``n_processes``; ``env``/``density_hint`` override
    ``RTPU_COMM_ROUTE`` and the recorded history."""
    from . import frontier as _frontier

    if env is None:
        env = os.environ.get("RTPU_COMM_ROUTE", "auto").strip().lower()
    env = env or "auto"
    env_valid = env in COMM_ROUTES + ("auto",)
    S = mesh.shape[V_AXIS]
    label = program.cost_label
    key = f"{label}/k{k}"
    eligible = _frontier.supported(program)
    if density_hint is None:
        density_hint = COLLECTIVES.frontier_hint(key)
    measured = density_hint is not None
    density = _frontier.PRIOR_DENSITY if density_hint is None else density_hint

    item = 4          # eligible state leaves are i32 labels / f32 dists
    slot = 8 + item   # i64 flat index + value
    n_dev = int(mesh.n_devices)
    n_procs = int(mesh.n_processes)
    est = {
        "all_gather": (view.n_pad - sv.n_loc) * k * item * n_dev,
        "halo": sv.halo_rows(program.direction) * k * item * n_dev,
        "sparse": max(density * k * view.n_pad * slot,
                      _partition_floor() * n_procs * slot),
    }
    dense_pick = _dense_auto(sv, view, program, S)

    route = requested
    reason = "explicit comm= argument"
    if requested == "auto":
        if env != "auto" and env_valid:
            route = env
            reason = "forced by RTPU_COMM_ROUTE"
        elif not env_valid:
            route = "auto"
            reason = f"invalid RTPU_COMM_ROUTE={env!r} ignored"
        else:
            route = "auto"
            reason = "auto"
    if route == "sparse" and not eligible:
        if requested == "sparse":
            raise ValueError(
                f"comm='sparse' requires the monotone_min contract; "
                f"{type(program).__name__} does not declare it")
        route = dense_pick
        reason = ("RTPU_COMM_ROUTE=sparse ignored: "
                  f"{label} is not monotone_min — dense fallback")
    if route == "auto":
        if eligible and multi and est["sparse"] < min(est["all_gather"],
                                                     est["halo"]):
            route = "sparse"
            reason = ("measured density" if measured else "prior density") \
                + " puts sparse below both dense routes"
        else:
            route = dense_pick
            if not eligible:
                reason = "program not monotone_min: dense volume rule"
            elif not multi:
                reason = "single-process mesh: dense volume rule"
            else:
                reason = "frontier density above crossover: dense volume rule"

    skew_max = 0.0
    if sv.skew:
        skew_max = max(float(s.get("skew", 1.0)) for s in sv.skew.values())
    hist = {}
    snap = COLLECTIVES.snapshot()["routes"]
    for rk, v in snap.items():
        r = rk.split("/")[0]
        h = hist.setdefault(r, {"bytes": 0, "supersteps": 0,
                                "barrier_wait_seconds": 0.0})
        h["bytes"] += v["bytes"]
        h["supersteps"] += v["supersteps"]
        h["barrier_wait_seconds"] = round(
            h["barrier_wait_seconds"] + v["barrier_wait_seconds"], 6)
    return {
        "algorithm": label,
        "key": key,
        "requested": requested,
        "env": env if env != "auto" else None,
        "route": route,
        "reason": reason,
        "eligible": eligible,
        "evidence": {
            "n_pad": int(view.n_pad),
            "k": int(k),
            "shards": int(S),
            "processes": int(n_procs),
            "multi": bool(multi),
            "density": round(float(density), 6),
            "density_measured": measured,
            "est_bytes_per_superstep": {r: int(b) for r, b in est.items()},
            "skew_max": round(skew_max, 4),
            "route_history": hist,
        },
    }


# ---------------------------------------------------------------- the mesh

class Mesh:
    """A (windows, vertices) layout of the ranks of the process group:
    rank ``w * S + v`` holds window block w and vertex shard v, on
    ``device``. ``v_axis`` / ``w_axis`` / ``world`` are the collectives
    of its vertex axis, its window axis and the whole mesh
    (``cluster.bootstrap.Axis``). Every rank is its own process, so
    ``n_processes`` is the rank count."""

    def __init__(self, n_window_shards: int, n_vertex_shards: int,
                 rank: int, device: torch.device, v_axis, w_axis, world):
        self.shape = {W_AXIS: int(n_window_shards),
                      V_AXIS: int(n_vertex_shards)}
        self.rank = int(rank)
        self.device = device
        self.v_axis, self.w_axis, self.world = v_axis, w_axis, world

    @property
    def w_index(self) -> int:
        return self.rank // self.shape[V_AXIS]

    @property
    def v_index(self) -> int:
        return self.rank % self.shape[V_AXIS]

    @property
    def n_devices(self) -> int:
        return self.shape[W_AXIS] * self.shape[V_AXIS]

    @property
    def n_processes(self) -> int:
        return self.world.size

    def __repr__(self) -> str:
        return (f"Mesh({self.shape[W_AXIS]}x{self.shape[V_AXIS]}, "
                f"rank {self.rank}, {self.device})")


_MESHES: dict = {}
_MESH_LOCK = threading.Lock()


def make_mesh(n_vertex_shards: int | None = None, n_window_shards: int = 1,
              device=None) -> Mesh:
    """The (windows, vertices) mesh over every rank of the process group
    (``cluster.bootstrap``), or the one-rank mesh when no group is formed.
    Defaults to all ranks on the vertex axis. ``device`` defaults to the
    rank's bootstrap device, else the CUDA card. Every rank must call it
    with the same arguments in the same order (it forms the axes' process
    groups)."""
    topo = _boot.topology()
    world = topo.n_ranks
    W = int(n_window_shards)
    S = world // W if n_vertex_shards is None else int(n_vertex_shards)
    if S * W != world:
        raise ValueError(f"{S}x{W} mesh != {world} rank(s)")
    if device is None and _boot.rank_device() is not None:
        dev = _boot.rank_device()
    else:
        dev = resolve_device(device)
    key = (W, S, str(dev))
    with _MESH_LOCK:
        if key in _MESHES:
            return _MESHES[key]
        rank = topo.rank
        if world == 1:
            one = _boot.Axis((0,), 0)
            mesh = Mesh(1, 1, 0, dev, one, one, one)
        else:
            import torch.distributed as dist

            def axis(groups):
                mine = None
                for ranks in groups:
                    if len(ranks) == world:
                        g = dist.group.WORLD
                    elif len(ranks) > 1:
                        g = dist.new_group(list(ranks))  # every rank calls
                    else:
                        g = None
                    if rank in ranks:
                        mine = _boot.Axis(ranks, ranks.index(rank), g)
                return mine

            v_axis = axis([[w * S + v for v in range(S)] for w in range(W)])
            w_axis = axis([[w * S + v for w in range(W)] for v in range(S)])
            world_axis = _boot.Axis(range(world), rank, dist.group.WORLD)
            mesh = Mesh(W, S, rank, dev, v_axis, w_axis, world_axis)
        _MESHES[key] = mesh
        return mesh


# ---------------------------------------------------------------- partition

@dataclass
class ShardedView:
    """Host-side partitioned snapshot: leading axis = vertex shard. Fields
    as the reference's (``sharded.py:466``), plus ``d_count``/``s_count``:
    each shard's real (non-pad) slots, the extent of its combine CSR."""

    n_shards: int
    n_loc: int                 # vertices per shard
    m_loc_d: int               # padded edges per shard (dst partition)
    m_loc_s: int               # padded edges per shard (src partition)
    vids: np.ndarray           # i64[S, n_loc]
    v_mask: np.ndarray         # bool[S, n_loc]
    v_latest: np.ndarray       # i64[S, n_loc]
    v_first: np.ndarray        # i64[S, n_loc]
    # dst partition: combine-at-dst; src index is GLOBAL (gathered state)
    d_src_g: np.ndarray        # i32[S, m_loc_d]
    d_dst_l: np.ndarray        # i32[S, m_loc_d]  local, sorted, pad n_loc-1
    d_mask: np.ndarray         # bool[S, m_loc_d]
    d_time: np.ndarray         # i64[S, m_loc_d]
    d_first: np.ndarray
    # src partition: combine-at-src; dst index is GLOBAL
    s_dst_g: np.ndarray        # i32[S, m_loc_s]
    s_src_l: np.ndarray        # i32[S, m_loc_s]  local, sorted, pad n_loc-1
    s_mask: np.ndarray
    s_time: np.ndarray
    s_first: np.ndarray
    d_props: dict              # name -> f32[S, m_loc_d]
    s_props: dict
    view: GraphView
    d_count: np.ndarray        # i64[S] real slots of each dst block
    s_count: np.ndarray        # i64[S]
    occurrences: bool = False  # blocks hold occ_* (multigraph) rows
    # halo structures: h_* is the per-(requester, owner) slot capacity;
    # *_h remaps the global ref array into [local | halo] space
    # [0, n_loc + S*h); *_send[S, S*h] is each owner's all_to_all send page
    h_d: int = 0
    d_src_h: np.ndarray | None = None   # i32[S, m_loc_d]
    d_send: np.ndarray | None = None    # i32[S, S*h_d]
    h_s: int = 0
    s_dst_h: np.ndarray | None = None
    s_send: np.ndarray | None = None
    skew: dict | None = None

    def halo_rows(self, direction: str) -> int:
        """Rows exchanged per rank per superstep on the halo path (against
        ``view.n_pad - n_loc`` received per rank for all_gather)."""
        rows = 0
        if direction in ("out", "both"):
            rows += self.n_shards * self.h_d
        if direction in ("in", "both"):
            rows += self.n_shards * self.h_s
        return rows


def _pow2(n: int) -> int:
    return 8 if n <= 8 else 1 << int(np.ceil(np.log2(n)))


def _build_halo(idx_g: np.ndarray, n_loc: int, S: int):
    """Halo layout for one partition direction (``sharded.py:523``):
    ``(h, idx_h, send, halo_counts)`` — the per-(requester, owner) slot
    capacity; ``idx_h[S, m_loc]``, each GLOBAL ref remapped into the
    shard's ``[local | halo]`` space (``n_loc + owner*h + slot`` for a
    remote row); ``send[S, S*h]``, owner o's all_to_all send page (chunk
    r: the local rows requester r referenced, sorted unique, slot order
    matching r's remap); ``halo_counts[S]``, each requester's unique
    remote refs."""
    idx_h = np.zeros(idx_g.shape, np.int32)
    halo_counts = np.zeros(idx_g.shape[0], np.int64)
    uniq = []
    maxcnt = 1
    for sh in range(S):
        g = idx_g[sh].astype(np.int64)
        owner = g // n_loc
        local = owner == sh
        idx_h[sh, local] = (g[local] - sh * n_loc).astype(np.int32)
        rem = np.flatnonzero(~local)
        if len(rem) == 0:
            continue
        go, oo = g[rem], owner[rem]
        order = np.lexsort((go, oo))
        gs, os_ = go[order], oo[order]
        new = np.ones(len(gs), bool)
        new[1:] = (gs[1:] != gs[:-1]) | (os_[1:] != os_[:-1])
        uid = np.cumsum(new) - 1
        u_owner = os_[new]
        u_g = gs[new]
        o_change = np.ones(len(u_owner), bool)
        o_change[1:] = u_owner[1:] != u_owner[:-1]
        arange_u = np.arange(len(u_g))
        base = np.maximum.accumulate(np.where(o_change, arange_u, 0))
        slot = (arange_u - base).astype(np.int64)
        maxcnt = max(maxcnt, int(slot.max()) + 1)
        halo_counts[sh] = len(u_g)
        uniq.append((sh, u_owner, u_g, slot, rem[order], uid))
    h = _pow2(maxcnt)
    send = np.zeros((S, S * h), np.int32)
    for sh, u_owner, u_g, slot, rows, uid in uniq:
        idx_h[sh, rows] = (n_loc + u_owner[uid] * h + slot[uid]).astype(np.int32)
        send[u_owner, sh * h + slot] = (u_g - u_owner * n_loc).astype(np.int32)
    return h, idx_h, send, halo_counts


def partition_view(view: GraphView, n_shards: int,
                   edge_props: tuple = (),
                   occurrences: bool = False) -> ShardedView:
    """Range-partition the padded vertex space into contiguous shards and
    scatter edges into per-shard blocks (dst- and src-partitioned), plus
    the halo exchange layout (``sharded.py:588``, bitwise the reference's
    arrays). With ``occurrences=True`` the blocks hold the multigraph
    occurrence rows (per-event times and props) instead of the
    deduplicated edges."""
    if view.n_pad % n_shards:
        raise ValueError(
            f"vertex shard count {n_shards} must divide the padded vertex "
            f"count {view.n_pad} (use a power-of-two vertex-axis size)")
    n_loc = view.n_pad // n_shards
    S = n_shards

    if occurrences:
        if view.occ_src is None:
            raise ValueError("program needs occurrences: build the view "
                             "with include_occurrences=True")
        act = view.occ_mask
        esrc = view.occ_src[act].astype(np.int64)
        edst = view.occ_dst[act].astype(np.int64)
        etime = efirst = view.occ_time[act]
        props = {k: view.occ_prop(k)[act] for k in edge_props}
    else:
        act = view.e_mask
        esrc = view.e_src[act].astype(np.int64)
        edst = view.e_dst[act].astype(np.int64)
        etime = view.e_latest_time[act]
        efirst = view.e_first_time[act]
        props = {k: view.edge_prop(k)[act] for k in edge_props}

    def _partition(owner_of, local_of, global_of):
        owner = owner_of // n_loc
        order = np.lexsort((local_of, owner))
        counts = np.bincount(owner, minlength=S)
        shard_counts.append(np.asarray(counts[:S], np.int64))
        m_loc = _pow2(int(counts.max()) if len(counts) else 0)
        idx_g = np.full((S, m_loc), view.n_pad - 1, np.int32)
        idx_l = np.full((S, m_loc), n_loc - 1, np.int32)
        mask = np.zeros((S, m_loc), bool)
        tarr = np.full((S, m_loc), INT64_MIN, np.int64)
        farr = np.full((S, m_loc), INT64_MIN, np.int64)
        parr = {k: np.zeros((S, m_loc), np.float32) for k in props}
        off = 0
        for sh in range(S):
            c = int(counts[sh]) if sh < len(counts) else 0
            rows = order[off: off + c]
            off += c
            idx_g[sh, :c] = global_of[rows]
            idx_l[sh, :c] = (owner_of[rows] - sh * n_loc)
            mask[sh, :c] = True
            tarr[sh, :c] = etime[rows]
            farr[sh, :c] = efirst[rows]
            for kk in props:
                parr[kk][sh, :c] = props[kk][rows]
        return m_loc, idx_g, idx_l, mask, tarr, farr, parr

    shard_counts: list = []   # filled by _partition (dst then src)
    m_loc_d, d_src_g, d_dst_l, d_mask, d_time, d_first, d_props = _partition(
        edst, edst % n_loc, esrc)
    m_loc_s, s_dst_g, s_src_l, s_mask, s_time, s_first, s_props = _partition(
        esrc, esrc % n_loc, edst)

    h_d, d_src_h, d_send, halo_d = _build_halo(d_src_g, n_loc, S)
    h_s, s_dst_h, s_send, halo_s = _build_halo(s_dst_g, n_loc, S)

    skew = shard_skew(edges_dst=shard_counts[0], edges_src=shard_counts[1],
                      halo_dst=halo_d, halo_src=halo_s)
    COLLECTIVES.note_partition(skew)

    rs = lambda a: a.reshape(S, n_loc)
    return ShardedView(
        n_shards=S, n_loc=n_loc, m_loc_d=m_loc_d, m_loc_s=m_loc_s,
        vids=rs(view.vids), v_mask=rs(view.v_mask),
        v_latest=rs(view.v_latest_time), v_first=rs(view.v_first_time),
        d_src_g=d_src_g, d_dst_l=d_dst_l, d_mask=d_mask,
        d_time=d_time, d_first=d_first,
        s_dst_g=s_dst_g, s_src_l=s_src_l, s_mask=s_mask,
        s_time=s_time, s_first=s_first,
        d_props=d_props, s_props=s_props, view=view,
        d_count=shard_counts[0], s_count=shard_counts[1],
        occurrences=occurrences, h_d=h_d, d_src_h=d_src_h, d_send=d_send,
        h_s=h_s, s_dst_h=s_dst_h, s_send=s_send,
        skew=skew,
    )


# ---------------------------------------------------------------- K11

def shard_csr(ids: torch.Tensor, count: int, n: int) -> SegmentCSR:
    """The combine CSR of one shard block: ``ids`` (int32, sorted over the
    block's first ``count`` real slots; the pads after them are masked in
    every window and stay out of the CSR)."""
    c = torch.bincount(ids[:count].long(), minlength=n)
    indptr = torch.zeros(n + 1, dtype=torch.int64, device=ids.device)
    indptr[1:] = torch.cumsum(c, 0)
    return SegmentCSR(ids, indptr, None)


def _window_masks(base, times, windows, T: int):
    """``[k, m]`` masks ``base & (w < 0 | times >= T - w)`` per window."""
    out = np.empty((len(windows),) + base.shape, bool)
    for i, w in enumerate(windows):
        out[i] = base if w < 0 else base & (times >= T - w)
    return out


def _run_local(program: VertexProgram, sv: ShardedView, mesh: Mesh,
               time: int, wl_loc: list, n_pad: int, comm: str, vprops):
    """One rank's SPMD superstep loop (``_sharded_runner``,
    ``sharded.py:681-928``): its window block ``wl_loc`` of vertex shard
    ``mesh.v_index``. Returns ``(result leaves [k_loc, n_loc, ...],
    steps)``."""
    dev = mesh.device
    v, S, n_loc = mesh.v_index, sv.n_shards, sv.n_loc
    k = len(wl_loc)
    v_off = v * n_loc
    op = program.combiner
    v_axis, w_axis = mesh.v_axis, mesh.w_axis

    def put(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    v_masks = put(_window_masks(sv.v_mask[v], sv.v_latest[v], wl_loc, time))
    dm = put(_window_masks(sv.d_mask[v], sv.d_time[v], wl_loc, time)) \
        .reshape(-1)
    sm = put(_window_masks(sv.s_mask[v], sv.s_time[v], wl_loc, time)) \
        .reshape(-1)
    d_src_g, d_dst_l = put(sv.d_src_g[v]), put(sv.d_dst_l[v])
    s_dst_g, s_src_l = put(sv.s_dst_g[v]), put(sv.s_src_l[v])
    at_dst = shard_csr(d_dst_l, int(sv.d_count[v]), n_loc)
    at_src = shard_csr(s_src_l, int(sv.s_count[v]), n_loc)
    woffs = torch.arange(k, dtype=torch.int64, device=dev)[:, None]
    if comm == "halo":
        width_d, width_s = n_loc + S * sv.h_d, n_loc + S * sv.h_s
        d_send, s_send = put(sv.d_send[v]), put(sv.s_send[v])
        fl_d_src = (put(sv.d_src_h[v]).long()[None, :]
                    + woffs * width_d).reshape(-1)
        fl_s_dst = (put(sv.s_dst_h[v]).long()[None, :]
                    + woffs * width_s).reshape(-1)
    else:
        width_d = width_s = n_pad
        fl_d_src = (d_src_g.long()[None, :] + woffs * n_pad).reshape(-1)
        fl_s_dst = (s_dst_g.long()[None, :] + woffs * n_pad).reshape(-1)

    def tile(a):
        return a if k == 1 else a.repeat((k,) + (1,) * (a.dim() - 1))

    def gather_state(st):
        # [S, k, n_loc, ...] from the vertex axis → [k, n_pad, ...]
        def leaf(a):
            g = v_axis.all_gather(a).transpose(0, 1)
            return g.reshape((k, S * n_loc) + tuple(a.shape[2:]))
        return tree_map(leaf, st)

    def exchange_halo(st, send):
        # halo_pack writes the send page slot-major: chunk r of S equal
        # chunks goes to rank r; chunk o of what comes back is owner o's
        # page for us
        def leaf(a):
            recv = v_axis.all_to_all(halo_pack(a, send)).transpose(0, 1)
            return torch.cat([a, recv], dim=1)
        return tree_map(leaf, st)

    def gather_flat(pool, ids, width):
        return tree_map(
            lambda a: a.reshape((k * width,) + tuple(a.shape[2:]))[ids],
            pool)

    def combine(tree, csr, mask):
        if op == "custom":
            return tree_map(lambda a: a.reshape((k, n_loc) + a.shape[1:]),
                            program.exchange(tree, csr, k * n_loc, mask))
        return tree_map(lambda x: segment_combine(x, csr, op, mask, k)
                        .reshape((k, n_loc) + x.shape[1:]), tree)

    ones_d = torch.ones(dm.shape[0], dtype=torch.int32, device=dev)
    ones_s = torch.ones(sm.shape[0], dtype=torch.int32, device=dev)
    in_deg = segment_combine(ones_d, at_dst, "sum", dm, k).reshape(k, n_loc)
    out_deg = segment_combine(ones_s, at_src, "sum", sm, k).reshape(k, n_loc)
    n_active = v_axis.all_reduce(
        v_masks.sum(dim=1, keepdim=True, dtype=torch.int32))
    time_t = torch.full((k, 1), int(time), dtype=torch.int64, device=dev)
    win_t = torch.tensor(wl_loc, dtype=torch.int64, device=dev).reshape(k, 1)
    vids, v_lat, v_first = (put(a[v]) for a in (sv.vids, sv.v_latest,
                                                 sv.v_first))
    vp = {key: put(a[v]) for key, a in vprops.items()}
    d_time, d_first = tile(put(sv.d_time[v])), tile(put(sv.d_first[v]))
    s_time, s_first = tile(put(sv.s_time[v])), tile(put(sv.s_first[v]))
    d_props = {key: tile(put(a[v])) for key, a in sv.d_props.items()
               if key in program.edge_props}
    s_props = {key: tile(put(a[v])) for key, a in sv.s_props.items()
               if key in program.edge_props}

    def mk_ctx(step: int) -> Context:
        return Context(n=n_loc, time=time_t, window=win_t, v_mask=v_masks,
                       vids=vids, v_latest_time=v_lat, v_first_time=v_first,
                       out_deg=out_deg, in_deg=in_deg, n_active=n_active,
                       step=step, vprops=vp, v_offset=v_off, axis=v_axis)

    def step_all(st, step: int):
        if comm == "halo":
            pool_d = lambda: exchange_halo(st, d_send)
            pool_s = lambda: exchange_halo(st, s_send)
        else:
            full = gather_state(st)
            pool_d = pool_s = lambda: full
        agg = None
        if program.direction in ("out", "both"):
            # the Edges contract: src/dst are GLOBAL padded indices
            edges = Edges(src=tile(d_src_g), dst=tile(d_dst_l) + v_off,
                          mask=dm, time=d_time, first_time=d_first,
                          props=d_props, step=step)
            agg = combine(program.message(
                gather_flat(pool_d(), fl_d_src, width_d), edges), at_dst, dm)
        if program.direction in ("in", "both"):
            edges = Edges(src=tile(s_src_l) + v_off, dst=tile(s_dst_g),
                          mask=sm, time=s_time, first_time=s_first,
                          props=s_props, step=step)
            agg_in = combine(program.message(
                gather_flat(pool_s(), fl_s_dst, width_s), edges), at_src, sm)
            agg = agg_in if agg is None else tree_map(_ELEM[op], agg, agg_in)
        new, votes = program.update(st, agg, mk_ctx(step))
        # local vote only: the caller makes it global over the vertex axis
        return new, (~(votes | ~v_masks)).sum(dim=1, dtype=torch.int32)

    state = program.init(mk_ctx(0))
    steps = 0
    if program.max_steps > 0:
        halted = torch.zeros(k, dtype=torch.bool, device=dev)
        while steps < program.max_steps:
            new_state, unhalted_local = step_all(state, steps)
            # per-window GLOBAL quiescence: a window halts only when no
            # shard changed state (sharded.py:856-870)
            new_halt = v_axis.all_reduce(unhalted_local) == 0
            state = tree_map(lambda old, new: torch.where(
                halted.reshape((k,) + (1,) * (new.dim() - 1)), old, new),
                state, new_state)
            halted = halted | new_halt
            steps += 1
            # any unhalted window anywhere keeps every rank stepping
            left = w_axis.all_reduce(
                (~halted).sum(dtype=torch.int32).reshape(1))
            if int(left) == 0:   # the one host read per superstep
                break
    return program.finalize(state, mk_ctx(steps)), steps


def run(program: VertexProgram, view: GraphView, mesh: Mesh, *,
        window: int | None = None, windows=None,
        sharded_view: ShardedView | None = None, comm: str = "auto"):
    """Run a vertex program SPMD over the mesh (``sharded.py:931``): the
    surface of ``engine.bsp.run`` plus the mesh. Every rank calls it with
    the same arguments and gets ``(result, steps)``: result leaves
    ``[K windows, n_pad, ...]`` in GLOBAL vertex order on the rank's
    device (the leading axis dropped without ``windows``).

    ``comm``: ``"all_gather"``, ``"halo"``, ``"sparse"`` (monotone-min
    programs) or ``"auto"`` (``choose_route``; ``RTPU_COMM_ROUTE`` forces
    a route for auto dispatches). The superstep loop reads its halting
    flag on the host each superstep, so a dispatch ends with its results
    ready (the reference's ``block=False`` has no counterpart)."""
    check_program(program)
    _check_custom(program)
    batched = windows is not None
    if windows is not None and len(windows) == 0:
        raise ValueError("windows must be a non-empty list of window sizes")
    if windows is None:
        windows = [window if window is not None else -1]
    wlist = [int(w) if w is not None and w >= 0 else -1 for w in windows]

    W = mesh.shape[W_AXIS]
    S = mesh.shape[V_AXIS]
    # pad the window count to a multiple of the window-axis size with
    # no-op duplicates of the last window
    k = len(wlist)
    k_pad = ((k + W - 1) // W) * W
    wlist_p = wlist + [wlist[-1]] * (k_pad - k)
    k_loc = k_pad // W

    occurrences = bool(program.needs_occurrences)
    sv = sharded_view
    if (sv is None or sv.n_shards != S or sv.view is not view
            or sv.occurrences != occurrences
            or not set(program.edge_props) <= set(sv.d_props)):
        sv = partition_view(view, S, tuple(program.edge_props),
                            occurrences=occurrences)

    if comm not in ("auto",) + COMM_ROUTES:
        raise ValueError(
            f"comm must be auto|halo|all_gather|sparse, got {comm!r}")
    # the mesh spans processes when it has more than one rank
    multi = mesh.n_processes > 1
    decision = choose_route(program, view, sv, mesh, comm, k, multi)
    comm = decision["route"]
    proc = TRACER.process_index
    COLLECTIVES.note_route_decision(decision)
    if TRACER.enabled:
        ev = decision["evidence"]
        TRACER.instant(
            "comm.route", process=proc, algorithm=decision["algorithm"],
            route=comm, requested=decision["requested"],
            reason=decision["reason"], density=ev["density"],
            skew_max=ev["skew_max"],
            **{f"est_{r}": b
               for r, b in ev["est_bytes_per_superstep"].items()})
    if _journal.enabled():
        _journal.emit("comm.route", decision)

    if comm == "sparse":
        from . import frontier as _frontier

        with TRACER.span("comm.exchange", route="sparse",
                         direction=program.direction, process=proc,
                         shards=S, windows=k) as csp:
            t0 = _time.perf_counter()
            result, steps, acct = _frontier.run_sparse(
                program, view, mesh, sv, wlist, multi=multi)
            csp.set(supersteps=acct["supersteps"], rows=acct["rows"],
                    bytes=acct["bytes"],
                    density=round(acct["density"], 6),
                    fallback_supersteps=acct["fallback_supersteps"],
                    barrier_wait_seconds=round(acct["barrier_wait"], 6))
        led = _ledger.current()
        if led is not None:
            led.add_dcn("sparse", rows=acct["rows"], bytes_=acct["bytes"])
        COLLECTIVES.note_exchange(
            "sparse", program.direction, rows=acct["rows"],
            bytes_=acct["bytes"], seconds=_time.perf_counter() - t0,
            supersteps=acct["supersteps"],
            barrier_wait=acct["barrier_wait"])
        COLLECTIVES.note_frontier(decision["key"], acct["density"],
                                  acct["supersteps"])
        if not batched:
            result = tree_map(lambda a: a[0], result)
        return result, steps

    vprops = {kk: np.asarray(view.vertex_prop(kk), np.float32)
              .reshape(S, sv.n_loc) for kk in program.vertex_props}
    wl_loc = wlist_p[mesh.w_index * k_loc:(mesh.w_index + 1) * k_loc]
    rows_dev = (sv.halo_rows(program.direction) if comm == "halo"
                else view.n_pad - sv.n_loc)
    rows_step = rows_dev * k_loc * mesh.n_devices

    # every rank gathers the blocks into global order: [W, S, k_loc, n_loc]
    # -> [W * k_loc, S * n_loc], then the pad windows are cut
    def globalise(a):
        g = mesh.world.all_gather(a)
        tail = tuple(a.shape[2:])
        g = g.reshape((W, S, k_loc, sv.n_loc) + tail).transpose(1, 2)
        return g.reshape((k_pad, view.n_pad) + tail)[:k]

    with TRACER.span("comm.exchange", route=comm,
                     direction=program.direction, process=proc,
                     shards=S, windows=k_pad,
                     rows_per_superstep=rows_step) as csp:
        t0 = _time.perf_counter()
        local, steps = _run_local(program, sv, mesh, int(view.time), wl_loc,
                                  int(view.n_pad), comm, vprops)
        t_disp = _time.perf_counter()
        if multi:
            # local completion: the kernels and the in-loop collectives
            with TRACER.span("comm.block_wait", route=comm, process=proc):
                _obs_device.block_ready(local)
        seconds = _time.perf_counter() - t0
        # bytes a row moves: the result leaves' widths (the exchanged state
        # of every program this engine runs)
        row_bytes = sum(a.element_size() * int(np.prod(a.shape[2:],
                                                       dtype=np.int64))
                        for a in leaves(local))
        rows_total = rows_step * steps
        barrier_wait = 0.0
        if multi:
            # the result all-gather: this rank's wait behind its peers
            t_bar = _time.perf_counter()
            with TRACER.span("comm.barrier_wait", route=comm, process=proc):
                result = tree_map(globalise, local)
            barrier_wait = _time.perf_counter() - t_bar
        else:
            result = tree_map(globalise, local)
        csp.set(supersteps=steps, rows=rows_total,
                bytes=rows_total * row_bytes,
                block_seconds=round(seconds - (t_disp - t0), 6),
                barrier_wait_seconds=round(barrier_wait, 6))
    COLLECTIVES.note_exchange(
        comm, program.direction, rows=rows_total,
        bytes_=rows_total * row_bytes, seconds=seconds, supersteps=steps,
        barrier_wait=barrier_wait)
    led = _ledger.current()
    if led is not None:
        led.add_dcn(comm, rows=rows_total, bytes_=rows_total * row_bytes)
    if not batched:
        result = tree_map(lambda a: a[0], result)
    return result, steps


def leaves(tree) -> list:
    """The tensor leaves of a state or result tree, in key order."""
    if isinstance(tree, dict):
        return [x for key in sorted(tree) for x in leaves(tree[key])]
    if isinstance(tree, (list, tuple)):
        return [x for t in tree for x in leaves(t)]
    return [tree]
