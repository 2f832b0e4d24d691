"""The port's ``AnalysisManager`` with ``mesh=`` against the reference's,
row for row (``time``, ``windowsize``, ``steps`` and the reduced result;
PageRank's top-10 vertex ids equal and ranks within rtol 1e-5 / atol
1e-7).

4 gloo CPU ranks (one group for the module) submit the same jobs: View
PageRank and CC (``sharded.run``), Range PageRank, CC and BFS (the
column-sharded route, K12), a DegreeBasic Range (no columnar engine: the
static-partition ``ShardedSweep``, K11) and a LabelPropagation Range (its
reducer needs the full view: hop by hop through ``sharded.run``). Every
rank emits the same rows. In this process, on the one-rank mesh: which
route each query takes, and that the single-device routes decline."""

import dataclasses

import numpy as np
import pytest
from test_torch_sharded import jax_mesh, log_desc, port_prog, run_ranks

from raphtory_tpu.algorithms import ConnectedComponents as JCC
from raphtory_tpu.algorithms import DegreeBasic as JDegree
from raphtory_tpu.algorithms import LabelPropagation as JLPA
from raphtory_tpu.algorithms import PageRank as JPageRank
from raphtory_tpu.algorithms.traversal import BFS as JBFS
from raphtory_tpu.core.service import TemporalGraph as JTemporalGraph
from raphtory_tpu.jobs.manager import AnalysisManager as JAnalysisManager
from raphtory_tpu.jobs.manager import RangeQuery as JRangeQuery
from raphtory_tpu.jobs.manager import ViewQuery as JViewQuery
from raphtory_tpu.utils.synth import gab_like_log
from raphtory_tpu_torch.core.service import TemporalGraph
from raphtory_tpu_torch.interop import event_log_from_arrays
from raphtory_tpu_torch.jobs import manager
from raphtory_tpu_torch.jobs.manager import (AnalysisManager, RangeQuery,
                                             ViewQuery)
from raphtory_tpu_torch.parallel import sharded

WINDOWS = (1_000, 200, 50)
RANGE = dict(start=450, end=1_000, jump=110, windows=WINDOWS)
#: name -> (program, query kind, query args, mesh [S, W])
JOBS = {
    "pagerank_view": (JPageRank(tol=1e-7, max_steps=20), "view",
                      dict(timestamp=900, windows=WINDOWS), (4, 1)),
    "cc_view": (JCC(max_steps=60), "view", dict(timestamp=900,
                                                windows=WINDOWS), (2, 2)),
    "pagerank_range": (JPageRank(tol=1e-7, max_steps=20), "range", RANGE,
                       (4, 1)),
    "cc_range": (JCC(max_steps=60), "range", RANGE, (2, 2)),
    "bfs_range": (JBFS(seeds=(1, 2, 3), directed=False, max_steps=40),
                  "range", RANGE, (4, 1)),
    "degree_range": (JDegree(), "range", RANGE, (2, 2)),
    "lpa_range": (JLPA(max_steps=10), "range",
                  dict(start=780, end=1_000, jump=110, windows=(1_000, 200)),
                  (4, 1)),
}


@pytest.fixture(autouse=True)
def _one_job_at_a_time(monkeypatch):
    # the reference's own route for every job (no coalescing)
    monkeypatch.setenv("RTPU_BATCH_WINDOW_MS", "0")


def jax_log():
    return gab_like_log(1_500, 15_000, seed=5, t_span=1_000)


def jax_rows(jprog, kind, args, mesh):
    q = JViewQuery(**args) if kind == "view" else JRangeQuery(**args)
    mgr = JAnalysisManager(JTemporalGraph(jax_log()), mesh=mesh)
    job = mgr.submit(jprog, q)
    assert job.wait(300) and job.status == "done", job.error
    return mgr.results(job.id)


def assert_rows_match(got, want, pagerank):
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        for k in ("time", "windowsize", "steps"):
            assert g[k] == w[k], (k, g, w)
        if not pagerank:
            assert g["result"] == w["result"]
            continue
        gt, wt = g["result"]["top10"], w["result"]["top10"]
        assert [v for v, _ in gt] == [v for v, _ in wt]
        np.testing.assert_allclose([r for _, r in gt], [r for _, r in wt],
                                   rtol=1e-5, atol=1e-7)
        assert abs(g["result"]["sum"] - w["result"]["sum"]) <= 1e-5


@pytest.fixture(scope="module")
def ranks():
    reqs = [dict(op="job", log="g", program=(type(p).__name__,
                                             dataclasses.asdict(p)),
                 query=(kind, args), mesh=mesh)
            for p, kind, args, mesh in JOBS.values()]
    return dict(zip(JOBS, run_ranks({"g": log_desc(jax_log())}, reqs)))


@pytest.mark.parametrize("name", sorted(JOBS))
def test_mesh_job_matches_reference(ranks, name):
    jprog, kind, args, (S, W) = JOBS[name]
    want = jax_rows(jprog, kind, args, jax_mesh(S, W))
    assert_rows_match(ranks[name]["rows"], want,
                      pagerank=isinstance(jprog, JPageRank))


def _one_rank_manager():
    log = event_log_from_arrays(jax_log().arrays())
    mesh = sharded.make_mesh(1, 1, device="cpu")
    return AnalysisManager(TemporalGraph(log, device="cpu"), mesh=mesh)


def _spy(monkeypatch, names):
    taken = []
    for name in names:
        orig = getattr(manager.Job, name)

        def spy(self, *a, _orig=orig, _name=name):
            r = _orig(self, *a)
            taken.append((_name, r))
            return r

        monkeypatch.setattr(manager.Job, name, spy)
    return taken


ROUTES = ("_try_range_mesh_columns", "_try_range_mesh",
          "_try_range_hopbatch", "_try_range_device", "_try_view_resident")


@pytest.mark.parametrize("name,route", [
    ("pagerank_range", [("_try_range_mesh_columns", True)]),
    ("degree_range", [("_try_range_mesh_columns", False),
                      ("_try_range_mesh", True)]),
    ("lpa_range", [("_try_range_mesh_columns", False),
                   ("_try_range_mesh", False),
                   ("_try_range_hopbatch", False),
                   ("_try_range_device", False)]),
    ("cc_view", [("_try_view_resident", False)]),
])
def test_one_rank_mesh_routes_and_declines(monkeypatch, name, route):
    """On a mesh the mesh routes go first and the single-device routes
    decline (``raphtory_tpu/jobs/manager.py:327-330, 588, 717, 840``);
    the rows equal the reference's on its one-device mesh."""
    taken = _spy(monkeypatch, ROUTES)
    dispatched = []
    orig_run = sharded.run
    monkeypatch.setattr(sharded, "run", lambda *a, **kw: dispatched.append(
        1) or orig_run(*a, **kw))
    jprog, kind, args, _ = JOBS[name]
    mgr = _one_rank_manager()
    q = ViewQuery(**args) if kind == "view" else RangeQuery(**args)
    job = mgr.submit(port_prog(jprog), q)
    assert job.wait(300) and job.status == "done", job.error
    assert taken == route
    # everything but the column-sharded route dispatches K11
    assert bool(dispatched) == (name != "pagerank_range")
    want = jax_rows(jprog, kind, args, jax_mesh(1, 1))
    assert_rows_match(mgr.results(job.id), want,
                      pagerank=isinstance(jprog, JPageRank))


def test_manager_takes_the_mesh_device():
    mgr = _one_rank_manager()
    assert mgr.device.type == "cpu" and mgr.mesh.n_devices == 1
