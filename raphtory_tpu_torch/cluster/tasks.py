"""Described mesh requests, run by every rank of a spawned group.

``cluster.bootstrap.spawn`` starts ranks in fresh interpreters that import
only this package, so what the ranks should do travels as data: a spec of
logs (event-log columns, or a ``utils.synth`` generator and its
arguments) and an ordered list of requests. ``run_requests`` (the
spawner's target, ``"raphtory_tpu_torch.cluster.tasks:run_requests"``)
runs them in order on every rank — the same collectives in the same order
— and returns each request's results as numpy, with what it moved
(``COLLECTIVES`` routes before and after), the kernel launches and the
wall seconds of its dispatch alone: the view, its partition, the engine
and its fold columns are built before the clock starts (a ``job``
request times the whole job), and the clock stops when the device has
finished, before the results are copied to the host. Two flags make a request a measuring replay instead: with
``sample`` it keeps the exchange kernels' largest inputs
(``ops.exchange.SAMPLES``, a host copy and a sync a call) and reports no
seconds; with ``collectives`` it times each collective
(``bootstrap.TIMES``, a device sync before and after each). Requests:

* ``sharded`` — ``parallel.sharded.run`` of a program on ``build_view``
  at ``T`` (``mesh``: ``[S, W]``; ``windows``/``window``; ``comm``; the
  view carries the occurrence rows when the program needs them);
* ``sweep`` — ``parallel.sweep.ShardedSweep.run`` at each of ``times``;
* ``columns`` — ``parallel.columns.run_columns_sharded`` over a
  hop-batched engine's host fold columns;
* ``job`` — an ``AnalysisManager`` job with ``mesh=``: its result rows;
* ``fail`` — raise on rank ``rank`` (the spawner's failure path).
"""

from __future__ import annotations

import time as _time
from contextlib import contextmanager

import torch

from ..core.events import EventLog
from ..interop import event_log_from_arrays, program_from_params
from ..ops import columns as _columns
from ..ops import exchange as _exchange
from ..ops.resident import ship
from ..utils import synth
from . import bootstrap as _boot


def build_log(desc: dict) -> EventLog:
    """A log from its description: ``{"arrays": cols, "props": payloads}``
    or ``{"synth": name, "kwargs": {...}}`` (a ``utils.synth``
    generator)."""
    if "synth" in desc:
        return getattr(synth, desc["synth"])(**desc.get("kwargs", {}))
    return event_log_from_arrays(desc["arrays"], props=desc.get("props"))


def _numpy(tree):
    if isinstance(tree, dict):
        return {k: _numpy(v) for k, v in tree.items()}
    if isinstance(tree, torch.Tensor):
        return tree.cpu().numpy()
    return tree


def _program(req):
    name, params = req["program"]
    return program_from_params(name, **params)


def _mesh(req):
    from ..parallel.sharded import make_mesh

    S, W = req.get("mesh", (None, 1))
    return make_mesh(S, W)


def _windows(req):
    return {k: req[k] for k in ("window", "windows") if k in req}


class _Clock:
    """Wall seconds of the blocks it times, each ended by a device sync."""

    def __init__(self):
        self.seconds = 0.0

    @contextmanager
    def __call__(self):
        t0 = _time.perf_counter()
        yield
        if torch.cuda.is_available() and torch.cuda.is_initialized():
            torch.cuda.synchronize()
        self.seconds += _time.perf_counter() - t0


def _sharded(req, logs, clock):
    from ..core.snapshot import build_view
    from ..parallel import sharded

    mesh, prog = _mesh(req), _program(req)
    view = build_view(logs[req["log"]], int(req["T"]),
                      include_occurrences=prog.needs_occurrences)
    sv = sharded.partition_view(view, mesh.shape[sharded.V_AXIS],
                                tuple(prog.edge_props),
                                occurrences=prog.needs_occurrences)
    with clock():
        res, steps = sharded.run(prog, view, mesh, sharded_view=sv,
                                 comm=req.get("comm", "auto"),
                                 **_windows(req))
    return {"result": _numpy(res), "steps": int(steps)}


def _sweep(req, logs, clock):
    from ..parallel.sweep import ShardedSweep

    mesh = _mesh(req)
    sw = ShardedSweep(logs[req["log"]], mesh.shape["vertices"])
    prog = _program(req)
    out = []
    for T in req["times"]:
        with clock():
            res, steps = sw.run(prog, int(T), mesh=mesh,
                                comm=req.get("comm", "auto"),
                                **_windows(req))
        out.append({"result": _numpy(res), "steps": int(steps)})
    return {"hops": out, "uv": sw.t.uv}


def _engine(kind, log, params, device):
    from ..engine.hopbatch import (HopBatchedBFS, HopBatchedCC,
                                   HopBatchedPageRank, HopBatchedSSSP)

    if kind == "pagerank":
        return HopBatchedPageRank(log, device=device)
    if kind == "cc":
        return HopBatchedCC(log, device=device)
    if params.get("weight_prop"):
        return HopBatchedSSSP(log, params["seeds"], params["weight_prop"],
                              device=device)
    return HopBatchedBFS(log, params.get("seeds", ()), device=device)


def _columns_req(req, logs, clock):
    from ..parallel.columns import run_columns_sharded

    mesh = _mesh(req)
    kind = req["kind"]
    params = dict(req.get("params", {}))
    hb = _engine(kind, logs[req["log"]], params, mesh.device)
    hops, cols = hb._fold_columns(req["hops"])
    weight_prop = params.pop("weight_prop", None)
    if weight_prop:
        # the weights stay on the host: a rank ships only its hops' rows
        params["weight_cols"] = cols[4]
    with clock():
        # the four fold columns in one copy of the bytes they span
        res, steps = run_columns_sharded(hb.tables,
                                         *ship(cols, mesh.device, 4), hops,
                                         req["windows"], mesh, kind=kind,
                                         **params)
    return {"result": res.cpu().numpy(), "steps": int(steps)}


def _job(req, logs, clock):
    from ..core.service import TemporalGraph
    from ..jobs.manager import AnalysisManager, RangeQuery, ViewQuery

    mesh = _mesh(req)
    graph = TemporalGraph(logs[req["log"]], device=mesh.device)
    mgr = AnalysisManager(graph, mesh=mesh)
    kind, kw = req["query"]
    q = ViewQuery(**kw) if kind == "view" else RangeQuery(**kw)
    with clock():
        job = mgr.submit(_program(req), q)
        if not job.wait(req.get("timeout", 600)):
            raise TimeoutError(f"job {job.id} did not finish")
    if job.status != "done":
        raise RuntimeError(f"job {job.id} {job.status}: {job.error}")
    return {"rows": [{k: v for k, v in row.items() if k != "viewTime"}
                     for row in job.results_snapshot()]}


def _fail(req, logs, clock):
    if _boot.topology().rank == req.get("rank", 0):
        raise RuntimeError("requested failure")
    import torch.distributed as dist

    dist.barrier()   # the other ranks wait on the one that failed
    return {}


_OPS = {"sharded": _sharded, "sweep": _sweep, "columns": _columns_req,
        "job": _job, "fail": _fail}


def run_requests(spec: dict) -> dict:
    """Run ``spec["requests"]`` in order over the logs ``spec["logs"]``.
    Returns ``{"results": [...], "staged": [...], "samples": ...}``, each
    result with its dispatch ``seconds`` (None for a ``sample`` replay),
    its ``launches``, its ``routes`` delta and, for a ``collectives``
    replay, ``collectives``: ``{name: [calls, seconds]}``. ``samples``
    holds the ``sample`` replays' kernel inputs (None without one)."""
    from ..parallel.sharded import COLLECTIVES

    logs = {name: build_log(d) for name, d in spec.get("logs", {}).items()}
    samples = None
    results = []
    for req in spec["requests"]:
        before = COLLECTIVES.snapshot()["routes"]
        _columns.reset_launches()
        if req.get("sample"):
            samples = {} if samples is None else samples
            _exchange.SAMPLES = samples
        _boot.TIMES = {} if req.get("collectives") else None
        clock = _Clock()
        out = _OPS[req["op"]](req, logs, clock)
        _exchange.SAMPLES = None
        out["seconds"] = None if req.get("sample") else clock.seconds
        if req.get("collectives"):
            out["collectives"] = _boot.TIMES
        _boot.TIMES = None
        out["launches"] = {k: v for k, v in _columns.LAUNCHES.items() if v}
        after = COLLECTIVES.snapshot()["routes"]
        out["routes"] = {
            key: {f: v[f] - before.get(key, {}).get(f, 0)
                  for f in ("dispatches", "supersteps", "rows", "bytes")}
            for key, v in after.items()
            if v["dispatches"] != before.get(key, {}).get("dispatches", 0)}
        results.append(out)
    return {"results": results, "staged": sorted(_boot.STAGED),
            "samples": samples}

