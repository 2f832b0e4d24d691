"""K12, the port's column-sharded Range sweep (``raphtory_tpu_torch/
parallel/columns.run_columns_sharded``), against the reference's
``run_columns_sharded`` on 4 devices and against the port's own
single-device host-column runners (``engine/hopbatch.run_columns`` /
``run_cc_columns`` / ``run_bfs_columns``).

4 gloo CPU ranks (one group for the module) run PageRank, CC, BFS and
weighted SSSP over 5 hops x 2 windows (10 columns, padded to 12 and cut
back). CC, BFS and SSSP are BITWISE the reference's and the port's
single-device runs with equal steps; PageRank within rtol 1e-5 / atol
1e-7, equal steps. The one-rank mesh runs in this process."""

import numpy as np
import pytest
from test_sweep import random_log
from test_torch_sharded import log_desc, port_log, run_ranks

import jax
from raphtory_tpu.core.events import EventLog as JEventLog
from raphtory_tpu.engine.hopbatch import HopBatchedBFS as JHopBatchedBFS
from raphtory_tpu.engine.hopbatch import HopBatchedCC as JHopBatchedCC
from raphtory_tpu.engine.hopbatch import \
    HopBatchedPageRank as JHopBatchedPageRank
from raphtory_tpu.engine.hopbatch import HopBatchedSSSP as JHopBatchedSSSP
from raphtory_tpu.parallel.columns import \
    run_columns_sharded as jrun_columns_sharded
from raphtory_tpu_torch.engine import hopbatch
from raphtory_tpu_torch.parallel import sharded
from raphtory_tpu_torch.parallel.columns import run_columns_sharded

HOPS = [20, 40, 60, 80, 99]
WINDOWS = [1000, 30]
SEEDS = (0, 1, 2)
#: kind -> (run_columns_sharded kwargs, the engine's extra arguments)
KINDS = {
    "pagerank": dict(kind="pagerank", tol=1e-7, max_steps=20),
    "cc": dict(kind="cc", max_steps=60),
    "bfs": dict(kind="bfs", seeds=SEEDS, directed=False, max_steps=50),
    "sssp": dict(kind="bfs", seeds=SEEDS, directed=False, max_steps=50),
}


def jax_log(kind):
    rng = np.random.default_rng(7)
    if kind != "sssp":
        return random_log(rng, n_events=900, n_ids=50, t_span=100)
    n = 700
    src, dst = rng.integers(0, 40, n), rng.integers(0, 40, n)
    times = np.sort(rng.integers(0, 100, n))
    log = JEventLog()
    log.append_batch(times, np.full(n, 2, np.uint8), src.astype(np.int64),
                     dst.astype(np.int64),
                     props=[(i, {"weight": float(rng.uniform(0.5, 3.0))})
                            for i in range(n)])
    return log


def jax_engine(kind, log):
    if kind == "pagerank":
        return JHopBatchedPageRank(log, tol=1e-7, max_steps=20)
    if kind == "cc":
        return JHopBatchedCC(log, max_steps=60)
    if kind == "bfs":
        return JHopBatchedBFS(log, SEEDS, directed=False, max_steps=50)
    return JHopBatchedSSSP(log, SEEDS, "weight", directed=False,
                           max_steps=50)


def request(kind):
    params = {k: v for k, v in KINDS[kind].items() if k != "kind"}
    if kind == "sssp":
        params["weight_prop"] = "weight"
    return dict(op="columns", log=kind, kind=KINDS[kind]["kind"],
                hops=HOPS, windows=WINDOWS, mesh=(4, 1), params=params)


@pytest.fixture(scope="module")
def ranks():
    logs = {k: log_desc(jax_log(k)) for k in KINDS}
    return dict(zip(KINDS, run_ranks(logs, [request(k) for k in KINDS])))


def single_device(kind, log):
    """The port's single-device host-column runners on the CPU."""
    from raphtory_tpu_torch.engine.hopbatch import (HopBatchedBFS,
                                                    HopBatchedPageRank,
                                                    HopBatchedSSSP)

    if kind == "sssp":
        hb = HopBatchedSSSP(log, SEEDS, "weight", device="cpu")
    elif kind == "bfs":
        hb = HopBatchedBFS(log, SEEDS, device="cpu")
    else:
        hb = HopBatchedPageRank(log, device="cpu")
    hops, cols = hb._fold_columns(HOPS)
    kw = {k: v for k, v in KINDS[kind].items() if k != "kind"}
    if kind == "pagerank":
        return hopbatch.run_columns(hb.tables, *cols, hops, WINDOWS,
                                    device="cpu", **kw)
    if kind == "cc":
        return hopbatch.run_cc_columns(hb.tables, *cols, hops, WINDOWS,
                                       device="cpu", **kw)
    seeds = kw.pop("seeds")
    if kind == "sssp":
        *cols, kw["weight_cols"] = cols
    return hopbatch.run_bfs_columns(hb.tables, *cols, hops, WINDOWS, seeds,
                                    device="cpu", **kw)


def assert_same(got, want, kind):
    want = np.asarray(want)
    assert got.shape == want.shape and got.dtype == want.dtype
    if kind == "pagerank":
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-7)
    else:
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("kind", sorted(KINDS))
def test_column_sharded_matches_reference_and_single_device(ranks, kind):
    got = ranks[kind]
    jlog = jax_log(kind)
    hb = jax_engine(kind, jlog)
    _, cols = hb._fold_columns(HOPS)
    kw = dict(KINDS[kind])
    if kind == "sssp":
        *cols, kw["weight_cols"] = cols
    want, wsteps = jrun_columns_sharded(hb.tables, *cols, HOPS, WINDOWS,
                                        jax.devices()[:4], **kw)
    assert_same(got["result"], want, kind)
    assert got["steps"] == int(wsteps)
    one, steps = single_device(kind, port_log(jlog))
    assert_same(got["result"], one.numpy(), kind)
    assert got["steps"] == steps
    assert got["routes"]["replicate/columns"]["dispatches"] == 1


@pytest.mark.parametrize("kind", sorted(KINDS))
def test_one_rank_mesh_is_the_single_device_run(kind):
    log = port_log(jax_log(kind))
    req = request(kind)
    from raphtory_tpu_torch.cluster.tasks import _engine

    params = dict(req["params"])
    hb = _engine(req["kind"], log, params, "cpu")
    hops, cols = hb._fold_columns(HOPS)
    if params.pop("weight_prop", None):
        *cols, params["weight_cols"] = cols
    got, steps = run_columns_sharded(hb.tables, *cols, hops, WINDOWS,
                                     sharded.make_mesh(1, 1, device="cpu"),
                                     kind=req["kind"], **params)
    one, one_steps = single_device(kind, log)
    np.testing.assert_array_equal(got.numpy(), one.numpy())
    assert steps == one_steps


def test_unknown_kind_raises():
    log = port_log(jax_log("cc"))
    hb = hopbatch.HopBatchedCC(log, device="cpu")
    _, cols = hb._fold_columns(HOPS)
    with pytest.raises(ValueError, match="unknown columnar kind"):
        run_columns_sharded(hb.tables, *cols, HOPS, WINDOWS,
                            sharded.make_mesh(1, 1, device="cpu"),
                            kind="lpa")


@pytest.mark.parametrize("kind", sorted(KINDS))
def test_columns_request_ships_the_fold_columns_in_one_copy(kind,
                                                            monkeypatch):
    """A columns request ships the four fold columns in ONE copy of the
    bytes they span in ``_fold_columns``' staging buffer; SSSP's weight
    columns, after them in that buffer, are not in it (a rank uploads only
    its hops' rows). The result stays the single-device run's."""
    from raphtory_tpu_torch.cluster import tasks
    from raphtory_tpu_torch.ops import resident

    log = port_log(jax_log(kind))
    monkeypatch.setattr(tasks, "_mesh", lambda req: sharded.make_mesh(
        1, 1, device="cpu"))
    upload, uploaded = resident.upload, []
    monkeypatch.setattr(resident, "upload", lambda data, dev: uploaded.append(
        data.numel()) or upload(data, dev))
    req = request(kind)
    got = tasks._columns_req(req, {kind: log}, tasks._Clock())
    _, cols = tasks._engine(req["kind"], log, dict(req["params"]),
                            "cpu")._fold_columns(HOPS)
    assert len(cols) == (5 if kind == "sssp" else 4)
    assert uploaded == [cols.offsets[3] + cols[3].nbytes]
    one, steps = single_device(kind, log)
    np.testing.assert_array_equal(got["result"], one.numpy())
    assert got["steps"] == steps
