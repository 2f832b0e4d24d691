"""The port's serving scheduler (``jobs/scheduler.py``) against the JAX
package's: ``stack_grids`` on hypothesis-drawn grids, a burst of
concurrent Range requests coalesced the same way (the same batches, the
same members, the same demuxed rows — PageRank within rtol 1e-5 / atol
1e-7 with equal supersteps, CC and BFS bitwise), an injected
``sched.dispatch`` failure sending every member to its own route with its
rows still right, and admission / shed decisions equal under the same
budget state."""

import threading

import numpy as np
import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

from raphtory_tpu.algorithms import SSSP as JSSSP
from raphtory_tpu.algorithms import ConnectedComponents as JCC
from raphtory_tpu.algorithms import PageRank as JPageRank
from raphtory_tpu.core.service import TemporalGraph as JTemporalGraph
from raphtory_tpu.engine.hopbatch import stack_grids as j_stack_grids
from raphtory_tpu.jobs import manager as j_manager
from raphtory_tpu.jobs import scheduler as j_sched
from raphtory_tpu.resilience import faults as j_faults
from raphtory_tpu.utils.synth import gab_like_log
from raphtory_tpu_torch.core.service import TemporalGraph
from raphtory_tpu_torch.engine.hopbatch import stack_grids
from raphtory_tpu_torch.interop import event_log_from_arrays, \
    program_from_params
from raphtory_tpu_torch.jobs import manager as p_manager
from raphtory_tpu_torch.jobs import scheduler as p_sched
from raphtory_tpu_torch.resilience import faults as p_faults

TIMEOUT = 60


@pytest.fixture(autouse=True)
def _knobs(monkeypatch):
    monkeypatch.setenv("RTPU_PCPM", "0")
    # a window long enough that a burst submitted back to back lands in
    # ONE collect window however loaded the host is
    monkeypatch.setenv("RTPU_BATCH_WINDOW_MS", "1500")


# ------------------------------------------------------------ stack_grids


_grid = st.tuples(
    st.lists(st.integers(0, 40), min_size=1, max_size=6),
    st.lists(st.one_of(st.none(), st.integers(1, 30)), min_size=1,
             max_size=4, unique=True))


@settings(max_examples=150, deadline=None)
@given(st.lists(_grid, min_size=1, max_size=6))
def test_stack_grids_equal(grids):
    assert stack_grids(grids) == j_stack_grids(grids)


def test_request_classification_equal():
    from raphtory_tpu.algorithms import DegreeBasic as JDegree

    progs = [JPageRank(tol=1e-6, max_steps=9), JCC(max_steps=7),
             JSSSP(seeds=(3, 1), max_steps=5),
             JSSSP(seeds=(2,), weight_prop="w", directed=True), JDegree()]
    qs = [(j_manager.RangeQuery(10, 50, 10, windows=(20, 5)),
           p_manager.RangeQuery(10, 50, 10, windows=(20, 5))),
          (j_manager.ViewQuery(30, window=4), p_manager.ViewQuery(30, 4)),
          (j_manager.RangeQuery(0, 100_000, 1), p_manager.RangeQuery(
              0, 100_000, 1)),
          (j_manager.LiveQuery(max_runs=3, windows=(1, 2)),
           p_manager.LiveQuery(max_runs=3, windows=(1, 2)))]
    for jp in progs:
        pp = program_from_params(type(jp).__name__, **{
            k: v for k, v in vars(jp).items() if not k.startswith("_")})
        assert p_sched.family_of(pp) == j_sched.family_of(jp)
    for jq, pq in qs:
        assert p_sched.request_grid(pq) == j_sched.request_grid(jq)
        assert p_sched.views_of(pq) == j_sched.views_of(jq)


# ---------------------------------------------------------------- bursts


def _log():
    return gab_like_log(600, 6_000, seed=13, t_span=1_000)


def _managers(jlog):
    jmgr = j_manager.AnalysisManager(JTemporalGraph(jlog))
    mgr = p_manager.AnalysisManager(
        TemporalGraph(event_log_from_arrays(jlog.arrays()), device="cpu"),
        device="cpu")
    return jmgr, mgr


#: (program name, params, RangeQuery kwargs): four PageRank requests with
#: their own hops and windows, two CC and two BFS requests
BURST = [
    ("PageRank", dict(tol=1e-7, max_steps=30),
     dict(start=400, end=1_000, jump=200, windows=(1_000, 100))),
    ("PageRank", dict(tol=1e-7, max_steps=30),
     dict(start=600, end=1_000, jump=100, windows=(300,))),
    ("PageRank", dict(tol=1e-7, max_steps=30),
     dict(start=500, end=900, jump=200, windows=(100, 50))),
    ("PageRank", dict(tol=1e-7, max_steps=30),
     dict(start=1_000, end=1_000, jump=1, window=None)),
    ("ConnectedComponents", dict(max_steps=50),
     dict(start=500, end=1_000, jump=250, windows=(200,))),
    ("ConnectedComponents", dict(max_steps=50),
     dict(start=750, end=1_000, jump=250, windows=(400, 200))),
    ("BFS", dict(seeds=(0, 3), max_steps=40),
     dict(start=600, end=1_000, jump=200, windows=(500,))),
    ("BFS", dict(seeds=(0, 3), max_steps=40),
     dict(start=1_000, end=1_000, jump=1, windows=(250, 500))),
]


def _jprog(name, params):
    from raphtory_tpu.algorithms import BFS as JBFS

    return {"PageRank": JPageRank, "ConnectedComponents": JCC,
            "BFS": JBFS}[name](**params)


def _submit_burst(mgr, query_cls, prog_of, explain=False):
    """Every request of the burst from its own thread at once, as
    concurrent REST handlers submit."""
    jobs = [None] * len(BURST)

    def one(i):
        name, params, q = BURST[i]
        jobs[i] = mgr.submit(prog_of(name, params), query_cls(**q),
                             job_id=f"burst{i}", explain=explain)

    threads = [threading.Thread(target=one, args=(i,))
               for i in range(len(BURST))]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    for job in jobs:
        assert job.wait(TIMEOUT) and job.status == "done", job.error
    return jobs


def assert_rows_equal(got, want, pagerank):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        for k in ("time", "windowsize", "steps"):
            assert g[k] == w[k], (k, g, w)
        if not pagerank:
            assert g["result"] == w["result"]
            continue
        assert [v for v, _ in g["result"]["top10"]] == \
            [v for v, _ in w["result"]["top10"]]
        np.testing.assert_allclose([r for _, r in g["result"]["top10"]],
                                   [r for _, r in w["result"]["top10"]],
                                   rtol=1e-5, atol=1e-7)
        assert abs(g["result"]["sum"] - w["result"]["sum"]) <= 1e-5


STAT_KEYS = ("batches_formed", "jobs_coalesced", "coalesced_jobs_hist",
             "batch_declined", "solo_passthrough", "deadline_expired",
             "queue_depth", "admitted_live_jobs")


def _coalesced(jobs):
    return [{k: v for k, v in (j.ledger.coalesced or {}).items()
             if k != "batch_id"} for j in jobs]


def test_burst_coalesces_as_the_reference():
    jlog = _log()
    jmgr, mgr = _managers(jlog)
    jjobs = _submit_burst(jmgr, j_manager.RangeQuery, _jprog)
    pjobs = _submit_burst(
        mgr, p_manager.RangeQuery,
        lambda n, p: program_from_params(n, **p))
    want, got = jmgr.scheduler.status_block(), mgr.scheduler.status_block()
    for k in STAT_KEYS:
        assert got[k] == want[k], k
    # three families, one batch each: 4 PageRank, 2 CC, 2 BFS members
    assert want["batches_formed"] == 3 and want["batch_declined"] == 0
    assert want["coalesced_jobs_hist"] == {"2": 2, "4": 1}
    assert _coalesced(pjobs) == _coalesced(jjobs)
    for (name, _, _), pj, jj in zip(BURST, pjobs, jjobs):
        assert_rows_equal(mgr.results(pj.id), jmgr.results(jj.id),
                          name == "PageRank")


def test_failed_batch_sends_members_to_their_own_routes():
    """The ``sched.dispatch`` failpoint fails the shared dispatch: every
    member takes its own route (the same device), with the rows a solo
    run gives, in both packages."""
    jlog = _log()
    jmgr, mgr = _managers(jlog)
    try:
        j_faults.arm("sched.dispatch=error:1.0:1")
        p_faults.arm("sched.dispatch=error:1.0:1")
        jjobs = _submit_burst(jmgr, j_manager.RangeQuery, _jprog)
        pjobs = _submit_burst(mgr, p_manager.RangeQuery,
                              lambda n, p: program_from_params(n, **p))
        jdoc, pdoc = j_faults.faultz(), p_faults.faultz()
    finally:
        j_faults.disarm()
        p_faults.disarm()
    assert pdoc["sites"]["sched.dispatch"]["injected"] == \
        jdoc["sites"]["sched.dispatch"]["injected"] == 1
    want, got = jmgr.scheduler.status_block(), mgr.scheduler.status_block()
    for k in STAT_KEYS:
        assert got[k] == want[k], k
    assert want["batch_declined"] == 1 and want["batches_formed"] == 2
    assert _coalesced(pjobs) == _coalesced(jjobs)
    for (name, _, _), pj, jj in zip(BURST, pjobs, jjobs):
        assert_rows_equal(mgr.results(pj.id), jmgr.results(jj.id),
                          name == "PageRank")


def test_solo_and_opted_out_requests_take_their_own_route():
    jlog = _log()
    jmgr, mgr = _managers(jlog)
    for m, q, prog in (
            (jmgr, j_manager.RangeQuery, JPageRank(max_steps=20)),
            (mgr, p_manager.RangeQuery,
             program_from_params("PageRank", max_steps=20))):
        a = m.submit(prog, q(500, 1_000, 250), job_id="solo")
        b = m.submit(prog, q(500, 1_000, 250), job_id="optout",
                     batch=False)
        c = m.submit(prog, q(500, 1_000, 250), job_id="urgent",
                     priority=9)
        for job in (a, b, c):
            assert job.wait(TIMEOUT) and job.status == "done", job.error
    want, got = jmgr.scheduler.status_block(), mgr.scheduler.status_block()
    for k in STAT_KEYS:
        assert got[k] == want[k], k
    assert want["solo_passthrough"] == 1 and want["batches_formed"] == 0
    for jid in ("solo", "optout", "urgent"):
        assert_rows_equal(mgr.results(jid), jmgr.results(jid), True)


# -------------------------------------------------------------- admission


@pytest.mark.parametrize("burning", [False, True])
def test_admission_decisions_equal(monkeypatch, burning):
    """The same sequence of requests against the same budget state: the
    same admits, the same sheds with the same evidence and Retry-After."""
    monkeypatch.setenv("RTPU_ADMISSION", "1")
    monkeypatch.setenv("RTPU_ADMISSION_BUDGET_S", "2")
    monkeypatch.setenv("RTPU_ADMISSION_MAX_JOBS", "6")
    monkeypatch.setenv("RTPU_SCHED_TENANT_SHARE", "0.5")
    jlog = _log()
    graphs = (JTemporalGraph(jlog), TemporalGraph(
        event_log_from_arrays(jlog.arrays()), device="cpu"))
    rng = np.random.default_rng(1)
    reqs = [(("acme", "beta", None)[int(rng.integers(0, 3))],
             int(rng.integers(1, 12)),
             None if rng.random() < 0.7 else float(rng.integers(100, 3000)))
            for _ in range(14)]

    def drive(sched_mod, mgr_mod, graph, pkg):
        if burning:
            monkeypatch.setattr(pkg.budget.BUDGET, "status_block",
                                lambda: {"grade": "burning"})
            monkeypatch.setattr(pkg.workload.WORKLOAD, "top_by_cost",
                                lambda n=8: [{"tenant": "beta"}])
        sched = sched_mod.ServingScheduler(graph)
        sched.note_live_epoch("PageRank", 0.01)
        prog = (JPageRank() if sched_mod is j_sched
                else program_from_params("PageRank"))
        out, admitted = [], []
        for i, (tenant, hops, deadline) in enumerate(reqs):
            q = mgr_mod.RangeQuery(0, 10 * (hops - 1), 10)
            try:
                est = sched.admit(prog, q, tenant, deadline_ms=deadline)
                out.append(("admit", round(est, 6)))
                admitted.append((est, tenant))
            except sched_mod.AdmissionDenied as e:
                out.append(("shed", str(e), e.evidence, e.retry_after_s))
            if i % 4 == 3 and admitted:
                sched.cancel(*admitted.pop(0))
        block = sched.status_block()
        return out, {k: block[k] for k in (
            "shed", "admitted_live_jobs", "backlog_seconds",
            "tenant_live_jobs", "prices_seconds_per_view")}

    import raphtory_tpu.obs as jobs_obs
    import raphtory_tpu_torch.obs as pobs

    class Pkg:
        def __init__(self, obs):
            self.budget, self.workload = obs.budget, obs.workload

    want = drive(j_sched, j_manager, graphs[0], Pkg(jobs_obs))
    got = drive(p_sched, p_manager, graphs[1], Pkg(pobs))
    assert got == want
    assert any(o[0] == "shed" for o in want[0])
    assert any(o[0] == "admit" for o in want[0])
