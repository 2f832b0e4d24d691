"""The port's ``AnalysisManager`` against the JAX package's on one PageRank
Range query with windows: the same rows in the same order, equal
time/windowsize/steps, equal top-10 vertex ids, rank sums within 1e-5."""

import dataclasses

import numpy as np
import pytest

from raphtory_tpu.algorithms import PageRank as JPageRank
from raphtory_tpu.core.service import TemporalGraph as JTemporalGraph
from raphtory_tpu.jobs.manager import AnalysisManager as JAnalysisManager
from raphtory_tpu.jobs.manager import RangeQuery as JRangeQuery
from raphtory_tpu.utils.synth import gab_like_log
from raphtory_tpu_torch.core.service import TemporalGraph
from raphtory_tpu_torch.interop import event_log_from_arrays, \
    program_from_params
from raphtory_tpu_torch.jobs.manager import (AnalysisManager, RangeQuery,
                                             ViewQuery)


@pytest.fixture(autouse=True)
def _unbinned_reference(monkeypatch):
    monkeypatch.setenv("RTPU_PCPM", "0")


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
    from raphtory_tpu_torch.engine.program import VertexProgram

    g = TemporalGraph(event_log_from_arrays(
        gab_like_log(50, 200, t_span=100).arrays()), device="cpu")
    mgr = AnalysisManager(g, device="cpu")
    prog = program_from_params("PageRank")
    with pytest.raises(NotImplementedError, match="View"):
        mgr.submit(prog, ViewQuery(timestamp=50))
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        mgr.submit(VertexProgram(), RangeQuery(start=0, end=50, jump=10))
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        program_from_params("ConnectedComponents")
    with pytest.raises(ValueError, match="jump"):
        RangeQuery(start=0, end=10, jump=0)
    # past the columnar route's view cap: no fallback route, the job fails
    job = mgr.submit(prog, RangeQuery(start=0, end=2_000, jump=1,
                                      windows=(10,)))
    assert job.wait(60) and job.status == "failed"
    assert "NotImplementedError" in job.error and mgr.results(job.id) == []
    # the watermark fence: a source that never passes the range's end
    g.watermarks.register("feed")
    job = mgr.submit(prog, RangeQuery(start=0, end=50, jump=10),
                     wait_timeout=0.05)
    assert job.wait(60) and job.status == "failed"
    assert "StaleRangeError" in job.error
