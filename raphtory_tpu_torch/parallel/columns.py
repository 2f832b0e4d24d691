"""Column-sharded range sweeps — view-axis parallelism over the ranks of a
mesh, K12.

Port of ``raphtory_tpu/parallel/columns.py``. The hop-batched columnar
engines (``engine/hopbatch``) evaluate every (hop, window) view of a range
query as an independent COLUMN; here the column axis is split over every
rank of the mesh: the graph tables and the host fold columns replicate
(each rank uploads them), each rank builds its block's window masks (K3
``column_masks``) and runs the same iteration on it (K2 PageRank, K5 CC,
K6 BFS / weighted SSSP), and the blocks all-gather back. No exchange in
the superstep loop. The columns pad to a multiple of the rank count by
repeating column 0, as the reference pads them, and the pad is dropped.
The reference's route is unbinned, and so is this one.
"""

from __future__ import annotations

import time as _time

import numpy as np
import torch

from ..engine.hopbatch import (_bfs_columns, _cc_columns, _column_layout,
                               _host_edges, _pagerank_columns, _pr_args,
                               _put, _seed_mask, _ship_columns)
from ..ops import columns as _columns


def run_columns_sharded(tables, e_lat, e_alive, v_lat, v_alive, hop_times,
                        windows, mesh, *, kind: str = "pagerank",
                        damping: float = 0.85, tol: float = 1e-7,
                        max_steps: int = 20, seeds=(),
                        directed: bool = False, weight_cols=None):
    """Columnar sweep with the (hop, window) axis sharded over the ranks of
    ``mesh`` (every rank calls it with the same arguments). ``kind``:
    ``"pagerank"`` | ``"cc"`` | ``"bfs"`` (``seeds``/``directed`` apply;
    ``weight_cols`` ``[H, m_pad]`` f32 on the host makes it weighted SSSP:
    a rank uploads its hops' rows). The fold columns are the host-column
    route's ``[H, m_pad]`` / ``[H, n_pad]``: device tensors (the callers
    ship ``_fold_columns``' buffer, ``ops/resident.ship``) or host arrays,
    packed into one copy.
    Returns ``(result [C, n_pad] hop-major on the rank's device, steps)``:
    the values of the single-device runners, ``steps`` the maximum over
    the ranks' blocks."""
    from .sharded import COLLECTIVES

    n_dev = mesh.n_devices
    H, C, hop_of_col, T_col, w_col = _column_layout(hop_times, windows)
    pad = (-C) % n_dev
    if pad:
        # replicate column 0 into the pad slots — cheapest valid views
        hop_of_col = np.concatenate([hop_of_col,
                                     np.repeat(hop_of_col[:1], pad)])
        T_col = np.concatenate([T_col, np.repeat(T_col[:1], pad)])
        w_col = np.concatenate([w_col, np.repeat(w_col[:1], pad)])
    c_loc = (C + pad) // n_dev
    mine = slice(mesh.rank * c_loc, (mesh.rank + 1) * c_loc)
    dev = mesh.device
    n_pad = tables.n_pad
    extra_host = []
    if kind == "bfs":
        extra_host.append(_seed_mask(tables, seeds))
        if weight_cols is not None:
            extra_host.append(weight_cols)
    elif kind not in ("pagerank", "cc"):
        raise ValueError(f"unknown columnar kind {kind!r}")

    # the fold columns may arrive on the device (shipped in one copy)
    repl_arrays = [a if isinstance(a, torch.Tensor) else np.asarray(a)
                   for a in (tables.e_src, tables.e_dst, e_lat, e_alive,
                             v_lat, v_alive, *extra_host)]
    repl_bytes = int(sum(a.nbytes for a in repl_arrays))
    repl_rows = int(sum(a.shape[-1] if a.ndim else 1 for a in repl_arrays))
    COLLECTIVES.note_route_decision({
        "algorithm": f"columns.{kind}", "route": "replicate",
        "requested": "replicate",
        "reason": "column-sharded dispatch replicates tables once",
        "est_bytes": {"replicate": repl_bytes * max(1, n_dev - 1)},
    })
    t0 = _time.perf_counter()
    info = np.iinfo(tables.tdtype)
    lo = np.clip(T_col - w_col, info.min, info.max).astype(tables.tdtype)
    me, mv = _columns.column_masks(
        *_ship_columns((e_lat, e_alive, v_lat, v_alive), dev),
        hop_of_col[mine], lo[mine], w_col[mine] < 0)
    edges = _host_edges(tables, dev)
    if kind == "pagerank":
        e_src, e_dst, indptr, _, walk = _pr_args(edges, tables)
        out, steps = _pagerank_columns(me, mv, e_src, e_dst, indptr, n_pad,
                                       float(damping), float(tol),
                                       int(max_steps), walk=walk)
    elif kind == "cc":
        out, steps = _cc_columns(me, mv, edges, n_pad, int(max_steps))
    else:
        ew = None
        if weight_cols is not None:
            # per-column weights: column c of the block reads hop
            # hop_of_col[c] (W = 1 below)
            ew = _put(np.ascontiguousarray(
                np.asarray(weight_cols)[hop_of_col[mine]].T), dev)
        out, steps = _bfs_columns(me, mv, edges, n_pad, int(max_steps),
                                  bool(directed),
                                  _put(extra_host[0], dev), ew, 1)
    t_bar = _time.perf_counter()
    result = mesh.world.all_gather(out.contiguous()).reshape(
        C + pad, n_pad)[:C]
    steps = int(mesh.world.all_reduce(
        torch.tensor([int(steps)], dtype=torch.int64, device=dev), "max"))
    barrier_wait = _time.perf_counter() - t_bar
    COLLECTIVES.note_exchange(
        "replicate", "columns", rows=repl_rows * max(1, n_dev - 1),
        bytes_=repl_bytes * max(1, n_dev - 1),
        seconds=_time.perf_counter() - t0, supersteps=1,
        barrier_wait=barrier_wait)
    return result, steps
