"""The port's ``AnalysisManager`` against the JAX package's on Range queries
with windows: PageRank (the same rows in the same order, equal
time/windowsize/steps, equal top-10 vertex ids, rank sums within 1e-5),
and ConnectedComponents and SSSP/BFS, whose rows (``reduce()`` output)
are equal exactly. Then View queries on the warm (resident ``DeviceSweep``)
and the cold (host view + ``bsp.run``) routes, and a DegreeBasic Range
query on the resident sweep, row for row against the JAX manager."""

import dataclasses

import numpy as np
import pytest

from raphtory_tpu.algorithms import SSSP as JSSSP
from raphtory_tpu.algorithms import ConnectedComponents as JCC
from raphtory_tpu.algorithms import DegreeBasic as JDegree
from raphtory_tpu.algorithms import PageRank as JPageRank
from raphtory_tpu.core.service import TemporalGraph as JTemporalGraph
from raphtory_tpu.jobs.manager import AnalysisManager as JAnalysisManager
from raphtory_tpu.jobs.manager import RangeQuery as JRangeQuery
from raphtory_tpu.jobs.manager import ViewQuery as JViewQuery
from raphtory_tpu.utils.synth import gab_like_log, ldbc_like_log
from raphtory_tpu_torch.core.service import TemporalGraph
from raphtory_tpu_torch.interop import (event_log_from_arrays,
                                        numeric_prop_payloads,
                                        program_from_params)
from raphtory_tpu_torch.jobs.manager import (AnalysisManager, LiveQuery,
                                             RangeQuery, ViewQuery)


@pytest.fixture(autouse=True)
def _unbinned_reference(monkeypatch):
    monkeypatch.setenv("RTPU_PCPM", "0")
    # one job at a time through the reference's own route (no coalescing)
    monkeypatch.setenv("RTPU_BATCH_WINDOW_MS", "0")


def _run_jax(jlog, prog, q):
    mgr = JAnalysisManager(JTemporalGraph(jlog))
    job = mgr.submit(prog, JRangeQuery(**dataclasses.asdict(q)))
    assert job.wait(300) and job.status == "done", job.error
    return mgr.results(job.id)


@pytest.mark.parametrize("jump", [100, 75])   # 6 hops (3 chunks) / 8 (4)
def test_range_job_matches_reference(jump):
    jlog = gab_like_log(1_500, 15_000, seed=5, t_span=1_000)
    jprog = JPageRank(tol=1e-7, max_steps=20)
    prog = program_from_params("PageRank", **dataclasses.asdict(jprog))
    q = RangeQuery(start=450, end=1_000, jump=jump, windows=(1_000, 200, 50))
    want = _run_jax(jlog, jprog, q)

    mgr = AnalysisManager(TemporalGraph(event_log_from_arrays(jlog.arrays()),
                                        device="cpu"), device="cpu")
    job = mgr.submit(prog, q)
    assert job.wait(300) and job.status == "done", job.error
    got = mgr.results(job.id)
    assert mgr.jobs() == {job.id: "done"}
    assert len(got) == len(want) == len(range(450, 1_001, jump)) * 3
    for g, w in zip(got, want):
        for k in ("time", "windowsize", "steps"):
            assert g[k] == w[k], (k, g, w)
        assert [v for v, _ in g["result"]["top10"]] == \
            [v for v, _ in w["result"]["top10"]]
        np.testing.assert_allclose([r for _, r in g["result"]["top10"]],
                                   [r for _, r in w["result"]["top10"]],
                                   rtol=1e-5, atol=1e-7)
        assert abs(g["result"]["sum"] - w["result"]["sum"]) <= 1e-5


def test_unported_queries_raise_and_failures_fail_the_job():
    """A Live query runs (its epochs on the live epoch engine); a
    custom-combiner program and an occurrence program without their own
    functions, and a Range whose fence never passes, fail the job as the
    reference's do."""
    from raphtory_tpu.engine.program import VertexProgram as JVertexProgram
    from raphtory_tpu_torch.engine.program import VertexProgram

    class Custom(VertexProgram):
        combiner = "custom"

    class JCustom(JVertexProgram):
        combiner = "custom"

    class Occurrences(VertexProgram):
        needs_occurrences = True

    class JOccurrences(JVertexProgram):
        needs_occurrences = True

    jlog = gab_like_log(50, 200, t_span=100)
    g = TemporalGraph(event_log_from_arrays(jlog.arrays()), device="cpu")
    mgr = AnalysisManager(g, device="cpu")
    jg = JTemporalGraph(jlog)
    jmgr = JAnalysisManager(jg)
    prog = program_from_params("PageRank")
    live = mgr.submit(prog, LiveQuery(repeat=0.01, max_runs=3))
    assert live.wait(60) and live.status == "done", live.error
    # wall-clock mode on an unchanged log: one served epoch, two skipped
    assert live.live.mode_counts == {"rebase": 1, "skipped": 2}
    assert [r["time"] for r in mgr.results(live.id)] == [g.latest_time]
    # the base class's functions raise inside the job, in both packages:
    # the occurrence program's on the cold route, with its occurrence rows
    for q, jq in ((ViewQuery(timestamp=50), JViewQuery(timestamp=50)),
                  (RangeQuery(start=0, end=50, jump=10),
                   JRangeQuery(start=0, end=50, jump=10))):
        for m, p, qq in ((mgr, Custom(), q), (jmgr, JCustom(), jq),
                         (mgr, Occurrences(), q),
                         (jmgr, JOccurrences(), jq)):
            job = m.submit(p, qq)
            assert job.wait(60) and job.status == "failed"
            assert "NotImplementedError" in job.error
            assert m.results(job.id) == []
    with pytest.raises(ValueError, match="jump"):
        RangeQuery(start=0, end=10, jump=0)
    # the watermark fence: a source that never passes the range's end; the
    # columnar and resident routes decline, the first hop's view times out
    for graph in (g, jg):
        graph.watermarks.register("feed")
    for m, q in ((mgr, RangeQuery(start=0, end=50, jump=10)),
                 (jmgr, JRangeQuery(start=0, end=50, jump=10))):
        job = m.submit(prog if m is mgr else JPageRank(), q,
                       wait_timeout=0.05)
        assert job.wait(60) and job.status == "failed"
        assert "StaleViewError" in job.error and m.results(job.id) == []
    # ... and a View behind it: the cold route owns the wait, and fails
    job = mgr.submit(prog, ViewQuery(timestamp=50), wait_timeout=0.05)
    assert job.wait(60) and job.status == "failed"
    assert "StaleViewError" in job.error and g._resident is None


def test_range_past_the_view_cap_matches_reference():
    """1,025 views, one past the columnar route's cap: the route declines
    and the job runs on the resident DeviceSweep (``_try_range_device``),
    as the reference's does, with the reference's rows (CC: exact; a
    PageRank row may halt a superstep apart on float noise, see
    ``test_torch_bsp.assert_pagerank_steps``)."""
    jlog = gab_like_log(50, 200, t_span=100)
    jprog = JCC(max_steps=60)
    prog = program_from_params("ConnectedComponents",
                               **dataclasses.asdict(jprog))
    q = RangeQuery(start=0, end=1_024, jump=1, windows=(10,))
    want = _run_jax(jlog, jprog, q)
    got = _run_port(jlog, prog, q)
    _same_rows(got, want, 1_025)


def test_unsafe_range_runs_hop_by_hop_behind_the_fence():
    """A source whose watermark is behind the range's end: the columnar
    and resident routes decline, and the job runs hop by hop behind the
    fence, each hop waiting for the watermark to pass it — the rows equal
    the reference's job on the same graph and feed."""
    import threading

    jlog = ldbc_like_log(n_persons=300, n_knows=2_000, t_span=1_000)
    jprog = JCC(max_steps=60)
    prog = program_from_params("ConnectedComponents",
                               **dataclasses.asdict(jprog))
    q = RangeQuery(start=200, end=1_000, jump=200, windows=(1_000, 300))
    rows = []
    for port in (False, True):
        if port:
            graph = TemporalGraph(event_log_from_arrays(jlog.arrays()),
                                  device="cpu")
            mgr = AnalysisManager(graph, device="cpu")
        else:
            graph = JTemporalGraph(jlog)
            mgr = JAnalysisManager(graph)
        graph.watermarks.register("feed")
        graph.watermarks.advance("feed", 500)
        assert graph.safe_time() < q.end
        job = mgr.submit(prog if port else jprog,
                         q if port else JRangeQuery(**dataclasses.asdict(q)))
        threading.Timer(0.5, graph.watermarks.advance,
                        ("feed", 2_000)).start()
        assert job.wait(300) and job.status == "done", job.error
        rows.append(mgr.results(job.id))
    _same_rows(rows[1], rows[0], 5 * 2)


def _run_port(jlog, prog, q):
    log = event_log_from_arrays(jlog.arrays(),
                                props=numeric_prop_payloads(jlog.props))
    mgr = AnalysisManager(TemporalGraph(log, device="cpu"), device="cpu")
    job = mgr.submit(prog, q)
    assert job.wait(300) and job.status == "done", job.error
    return mgr.results(job.id)


def _same_rows(got, want, n_rows):
    assert len(got) == len(want) == n_rows
    for g, w in zip(got, want):
        for k in ("time", "windowsize", "steps", "result"):
            assert g[k] == w[k], (k, g, w)


@pytest.mark.parametrize("jump", [100, 75])   # 6 hops (3 chunks) / 8 (4)
def test_cc_range_job_matches_reference(jump):
    """Multi-chunk CC Range jobs run cold chunks (CC cannot warm-start)."""
    jlog = ldbc_like_log(n_persons=600, n_knows=3_000, t_span=1_000)
    jprog = JCC(max_steps=60)
    prog = program_from_params("ConnectedComponents",
                               **dataclasses.asdict(jprog))
    q = RangeQuery(start=450, end=1_000, jump=jump, windows=(1_000, 200))
    want = _run_jax(jlog, jprog, q)
    got = _run_port(jlog, prog, q)
    _same_rows(got, want, len(range(450, 1_001, jump)) * 2)
    assert got[-1]["result"]["clusters"] > 1


@pytest.mark.parametrize("weighted", [True, False])
def test_sssp_range_job_matches_reference(weighted):
    """Weighted SSSP routes to HopBatchedSSSP, unweighted to HopBatchedBFS;
    8 hops run as 4 cold chunks."""
    jlog = ldbc_like_log(n_persons=400, n_knows=3_000, t_span=1_000,
                         weighted=True)
    jprog = JSSSP(seeds=(0, 1, 5), weight_prop="weight" if weighted
                  else None, directed=False, max_steps=32)
    prog = program_from_params("SSSP", **dataclasses.asdict(jprog))
    q = RangeQuery(start=300, end=1_000, jump=100, windows=(1_000, 300))
    want = _run_jax(jlog, jprog, q)
    got = _run_port(jlog, prog, q)
    _same_rows(got, want, 8 * 2)
    assert got[-1]["result"]["reached"] > 3


@pytest.mark.parametrize("jump", [100, 75])   # 6 hops (3 chunks) / 8 (4)
def test_range_job_on_the_host_route_matches_the_delta_route(jump,
                                                            monkeypatch):
    """A PageRank Range job on ``RTPU_FOLD=host`` (host-built fold columns,
    K3) gives the delta route's rows: the same masks, so the same ranks to
    the bit, the same steps and the same reduced results."""
    jlog = gab_like_log(1_500, 15_000, seed=5, t_span=1_000)
    prog = program_from_params("PageRank", tol=1e-7, max_steps=20)
    q = RangeQuery(start=450, end=1_000, jump=jump, windows=(1_000, 200, 50))
    monkeypatch.setenv("RTPU_FOLD", "host")
    host = _run_port(jlog, prog, q)
    monkeypatch.setenv("RTPU_FOLD", "delta")
    delta = _run_port(jlog, prog, q)
    _same_rows(host, delta, len(range(450, 1_001, jump)) * 3)


def test_host_route_admission_guard_declines_oversized_sweeps(monkeypatch):
    """The columnar route's host-memory guard reads the engine's
    ``host_column_bytes`` by route: 1,000 hops of ``[m_pad]`` fold columns
    pass it on the delta route (O(base)) and are declined on
    ``RTPU_FOLD=host`` (O(H · m_pad)). Declined, the job runs on the
    resident DeviceSweep, as the reference's does, with the reference's
    rows."""
    from raphtory_tpu_torch.engine.hopbatch import HopBatchedCC

    jlog = gab_like_log(20_000, 120_000, seed=3, t_span=2_000)
    log = event_log_from_arrays(jlog.arrays())
    hb = HopBatchedCC(log, device="cpu")
    assert hb.host_column_bytes(1_000) <= 1 << 29
    monkeypatch.setenv("RTPU_FOLD", "host")
    assert hb.host_column_bytes(1_000) > 1 << 29
    jprog = JCC(max_steps=60)
    prog = program_from_params("ConnectedComponents",
                               **dataclasses.asdict(jprog))
    q = RangeQuery(start=1_000, end=1_999, jump=1, window=500)
    mgr = AnalysisManager(TemporalGraph(log, device="cpu"), device="cpu")
    job = mgr.submit(prog, q)
    assert job.wait(300) and job.status == "done", job.error
    _same_rows(mgr.results(job.id), _run_jax(jlog, jprog, q), 1_000)


def _run_jobs(mgr, jobs):
    """Submit (program, query) pairs one after another on ``mgr``; all
    rows in order."""
    rows = []
    for prog, q in jobs:
        job = mgr.submit(prog, q)
        assert job.wait(300) and job.status == "done", job.error
        rows.extend(mgr.results(job.id))
    return rows


def _same_view_rows(got, want):
    """Rows equal on time/windowsize/steps/result; PageRank results (a
    top-10 and a sum) within rtol 1e-5 / atol 1e-7."""
    assert len(got) == len(want)
    for g, w in zip(got, want):
        for k in ("time", "windowsize", "steps"):
            assert g[k] == w[k], (k, g, w)
        if isinstance(w["result"], dict) and "top10" in w["result"]:
            assert [v for v, _ in g["result"]["top10"]] == \
                [v for v, _ in w["result"]["top10"]]
            np.testing.assert_allclose(
                [r for _, r in g["result"]["top10"]],
                [r for _, r in w["result"]["top10"]], rtol=1e-5, atol=1e-7)
            assert abs(g["result"]["sum"] - w["result"]["sum"]) <= 1e-5
        else:
            assert g["result"] == w["result"], (g, w)


def _view_managers(jlog):
    log = event_log_from_arrays(jlog.arrays(),
                                props=numeric_prop_payloads(jlog.props))
    g = TemporalGraph(log, device="cpu")
    return (JAnalysisManager(JTemporalGraph(jlog)),
            AnalysisManager(g, device="cpu"), g)


def _both(jmgr, mgr, jobs):
    want = _run_jobs(jmgr, [(jp, JViewQuery(**dataclasses.asdict(q))
                             if isinstance(q, ViewQuery)
                             else JRangeQuery(**dataclasses.asdict(q)))
                            for jp, q in jobs])
    got = _run_jobs(mgr, [(program_from_params(
        type(jp).__name__, **dataclasses.asdict(jp)), q) for jp, q in jobs])
    return got, want


@pytest.mark.parametrize("name", ["pagerank", "cc", "degree", "bfs"])
def test_warm_view_jobs_match_reference(name, monkeypatch):
    """Ascending View jobs ride the graph's shared resident sweep (one
    DeviceSweep, advanced by deltas): rows equal the JAX manager's."""
    jlog = gab_like_log(1_500, 15_000, seed=9, t_span=1_000)
    jprog = {"pagerank": JPageRank(tol=1e-7, max_steps=20),
             "cc": JCC(max_steps=60), "degree": JDegree(),
             "bfs": JSSSP(seeds=(0, 1, 2), directed=False,
                          max_steps=40)}[name]
    jmgr, mgr, g = _view_managers(jlog)
    from raphtory_tpu_torch.engine import bsp

    cold = []
    monkeypatch.setattr(bsp, "run", lambda *a, **k: cold.append(1))
    jobs = [(jprog, ViewQuery(timestamp=600, windows=(1_000, 200, 50))),
            (jprog, ViewQuery(timestamp=700, window=300)),
            (jprog, ViewQuery(timestamp=700)),
            (jprog, ViewQuery(timestamp=950, windows=(500, 100)))]
    got, want = _both(jmgr, mgr, jobs)
    _same_view_rows(got, want)
    assert len(got) == 7 and not cold   # never the cold route
    assert g._resident is not None and g._resident.t_now == 950


def test_cold_view_jobs_match_reference(monkeypatch):
    """The cold route: a View behind the resident sweep's clock, and a
    weighted SSSP (properties: not resident-eligible) View."""
    from raphtory_tpu_torch.engine import bsp

    cold = []
    run = bsp.run
    monkeypatch.setattr(bsp, "run", lambda *a, **k: cold.append(1)
                        or run(*a, **k))
    jlog = ldbc_like_log(n_persons=500, n_knows=4_000, t_span=1_000,
                         weighted=True)
    jmgr, mgr, g = _view_managers(jlog)
    pr = JPageRank(tol=1e-7, max_steps=20)
    sssp = JSSSP(seeds=(0, 1, 5), weight_prop="weight", directed=False,
                 max_steps=40)
    jobs = [(pr, ViewQuery(timestamp=900, windows=(1_000, 300))),
            (pr, ViewQuery(timestamp=500, windows=(1_000, 300))),  # behind
            (sssp, ViewQuery(timestamp=800, windows=(1_000, 200))),
            (sssp, ViewQuery(timestamp=950))]
    got, want = _both(jmgr, mgr, jobs)
    _same_view_rows(got, want)
    assert got[-1]["result"]["reached"] > 3
    assert g._resident.t_now == 900   # the behind View did not move it
    assert len(cold) == 3


def test_degree_range_job_runs_on_the_resident_sweep():
    jlog = gab_like_log(800, 6_000, seed=4, t_span=1_000)
    jmgr, mgr, _ = _view_managers(jlog)
    q = RangeQuery(start=300, end=1_000, jump=100, windows=(1_000, 150))
    got, want = _both(jmgr, mgr, [(JDegree(), q)])
    _same_rows(got, want, 8 * 2)
    assert got[-1]["result"]["total_in"] > 0


def test_failed_resident_dispatch_fails_the_job(monkeypatch):
    """No quiet fallback: a resident dispatch that raises drops the sweep
    and fails the job; the cold route is not tried."""
    from raphtory_tpu_torch.engine import bsp, device_sweep

    g = TemporalGraph(event_log_from_arrays(
        gab_like_log(300, 2_000, t_span=100).arrays()), device="cpu")
    mgr = AnalysisManager(g, device="cpu")
    cold = []
    monkeypatch.setattr(bsp, "run", lambda *a, **k: cold.append(1))

    def boom(*a, **k):
        raise RuntimeError("device lost")

    monkeypatch.setattr(device_sweep.DeviceSweep, "_dispatch", boom)
    job = mgr.submit(program_from_params("PageRank"),
                     ViewQuery(timestamp=60, window=20))
    assert job.wait(60) and job.status == "failed"
    assert "device lost" in job.error and mgr.results(job.id) == []
    assert g._resident is None and not cold


def test_hop_by_hop_range_job_of_a_property_program_matches_reference():
    """A program outside the columnar engine that reads an edge property
    is not resident-eligible: its Range job runs hop by hop on incremental
    host views (the reference's RangeAnalysisTask loop) through bsp.run."""
    from dataclasses import dataclass

    import jax.numpy as jnp
    import torch

    from raphtory_tpu.engine.program import VertexProgram as JVP
    from raphtory_tpu_torch.engine.program import VertexProgram

    @dataclass(frozen=True)
    class JWeightedIn(JVP):
        max_steps: int = 1
        edge_props = ("weight",)

        def init(self, ctx):
            return jnp.zeros(ctx.v_mask.shape, jnp.float32)

        def message(self, src_state, edge):
            w = edge.props["weight"]
            return jnp.where(jnp.isnan(w), 0.0, w)

        def update(self, state, agg, ctx):
            return agg, jnp.ones_like(ctx.v_mask)

    @dataclass(frozen=True)
    class WeightedIn(VertexProgram):
        max_steps: int = 1
        edge_props = ("weight",)

        def init(self, ctx):
            return torch.zeros(ctx.v_mask.shape, dtype=torch.float32)

        def message(self, src_state, edge):
            w = edge.props["weight"]
            return torch.where(torch.isnan(w), 0.0, w)

        def update(self, state, agg, ctx):
            return agg, torch.ones_like(ctx.v_mask)

    jlog = ldbc_like_log(n_persons=300, n_knows=2_000, t_span=1_000,
                         weighted=True)
    q = RangeQuery(start=400, end=1_000, jump=200, windows=(1_000, 300))
    want = _run_jax(jlog, JWeightedIn(), q)
    got = _run_port(jlog, WeightedIn(), q)
    assert len(got) == len(want) == 4 * 2
    for g, w in zip(got, want):
        for k in ("time", "windowsize", "steps"):
            assert g[k] == w[k], (k, g, w)
        np.testing.assert_allclose(g["result"], np.asarray(w["result"]),
                                   rtol=1e-5, atol=1e-7)
    assert float(np.asarray(got[-1]["result"]).sum()) > 0


# ------------------------------------------- the destination-binned route

def test_binned_range_and_view_jobs_match_reference(monkeypatch):
    """With ``RTPU_PCPM=1`` the jobs reach the binned route through the
    engines with no switch of their own: PageRank and CC Range jobs and a
    cold PageRank View (behind the resident clock) equal the JAX
    manager's binned rows; the admission guard counts the binned masks."""
    monkeypatch.setenv("RTPU_PCPM", "1")
    monkeypatch.setenv("RTPU_PARTITIONS", "5")
    jlog = ldbc_like_log(n_persons=600, n_knows=3_000, t_span=1_000)
    jmgr, mgr, g = _view_managers(jlog)
    pr = JPageRank(tol=1e-7, max_steps=20)
    cc = JCC(max_steps=60)
    jobs = [(pr, RangeQuery(start=450, end=1_000, jump=150,
                            windows=(1_000, 200))),
            (cc, RangeQuery(start=450, end=1_000, jump=150,
                            windows=(1_000, 200))),
            (pr, ViewQuery(timestamp=900, windows=(1_000, 300))),
            (pr, ViewQuery(timestamp=500, windows=(1_000, 300)))]
    got, want = _both(jmgr, mgr, jobs)
    _same_view_rows(got, want)
    from raphtory_tpu_torch.engine.hopbatch import HopBatchedCC

    hb = HopBatchedCC(g.log, device="cpu")
    assert hb.device_mask_bytes(1) == hb._resolve_layout().B \
        + hb.tables.n_pad
