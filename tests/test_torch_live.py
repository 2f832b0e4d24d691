"""The port's Live queries against the JAX package's on the same stream
(after ``tests/test_live.py``): a feeder appends one batch of events per
epoch and advances a watermark, and both packages' ``LiveQuery`` jobs serve
every epoch. The rows must match (PageRank within rtol 1e-5 / atol 1e-7,
CC / BFS / SSSP and the rest equal), and so must the epoch modes
(``mode_counts``: incremental, rebase, resync, resweep, skipped): the
standing engine adopts each suffix, a new vertex id rebases it, deletes
close CC's warm gate, ``RTPU_LIVE_RESYNC`` resyncs and ``RTPU_LIVE=0``
re-sweeps. A failed epoch dispatch fails the port's job (no re-sweep)."""

import dataclasses
import threading
import time

import numpy as np
import pytest

from raphtory_tpu.algorithms import SSSP as JSSSP
from raphtory_tpu.algorithms import ConnectedComponents as JCC
from raphtory_tpu.algorithms import DegreeBasic as JDegree
from raphtory_tpu.algorithms import PageRank as JPageRank
from raphtory_tpu.core.events import EventLog as JEventLog
from raphtory_tpu.core.service import TemporalGraph as JTemporalGraph
from raphtory_tpu.ingestion.watermark import \
    WatermarkRegistry as JWatermarkRegistry
from raphtory_tpu.jobs.manager import AnalysisManager as JAnalysisManager
from raphtory_tpu.jobs.manager import LiveQuery as JLiveQuery
from raphtory_tpu.obs.freshness import FRESH
from raphtory_tpu_torch.core.events import EventLog
from raphtory_tpu_torch.core.service import TemporalGraph
from raphtory_tpu_torch.engine import hopbatch
from raphtory_tpu_torch.ingestion.watermark import WatermarkRegistry
from raphtory_tpu_torch.interop import program_from_params
from raphtory_tpu_torch.jobs import live as live_mod
from raphtory_tpu_torch.jobs.manager import AnalysisManager, LiveQuery

N_IDS = 24
T0 = 40
STEP = 20


@pytest.fixture(autouse=True)
def _fresh(monkeypatch):
    monkeypatch.setenv("RTPU_PCPM", "0")
    monkeypatch.setenv("RTPU_BATCH_WINDOW_MS", "0")
    FRESH.clear()
    yield
    FRESH.clear()


def _events(rng, pool, t_lo, t_hi, n, deletes, props):
    out = []
    for t in rng.integers(t_lo + 1, t_hi + 1, n):   # arrival order shuffled
        a, b = pool[int(rng.integers(0, len(pool)))]
        v = int(rng.integers(0, N_IDS))
        kind = int(rng.choice(4, p=[0.1, 0.1, 0.6, 0.2])) if deletes \
            else int(rng.choice([0, 2], p=[0.15, 0.85]))
        p = {"w": float(rng.integers(1, 5))} if props else None
        out.append((kind, int(t), v, a, b, p))
    return out


def _apply(log, events):
    for kind, t, v, a, b, p in events:
        if kind == 0:
            log.add_vertex(t, v, p)
        elif kind == 1:
            log.delete_vertex(t, v)
        elif kind == 2:
            log.add_edge(t, a, b, p)
        else:
            log.delete_edge(t, a, b)


def stream(seed, n_batches=5, new_vertex_at=2, deletes_at=(3,)):
    """The seed segment (every id and pool pair, then events up to T0, one
    at T0) and ``n_batches`` batches, batch i in ``(T0 + i*STEP, T0 +
    (i+1)*STEP]``: add-only except ``deletes_at``; batch ``new_vertex_at``
    brings an id the pin has not seen."""
    rng = np.random.default_rng(seed)
    pool = [(int(a), int(b)) for a, b in rng.integers(0, N_IDS, (60, 2))]
    first = [(0, 0, v, 0, 0, None) for v in range(N_IDS)]
    first += [(2, 1, 0, a, b, {"w": 1.0}) for a, b in pool]
    first += _events(rng, pool, 1, T0 - 1, 200, True, True)
    first += [(0, T0, 0, 0, 0, None)]
    batches = []
    for i in range(n_batches):
        lo = T0 + i * STEP
        ev = _events(rng, pool, lo, lo + STEP, 40, i in deletes_at, True)
        if i == new_vertex_at:
            ev.append((2, lo + 3, 0, 1, N_IDS + 7, {"w": 2.0}))
        batches.append(ev)
    return first, batches


PACKAGES = {
    "jax": (JEventLog, JTemporalGraph, JWatermarkRegistry,
            lambda g: JAnalysisManager(g), JLiveQuery),
    "port": (EventLog, lambda log, watermarks: TemporalGraph(
        log, watermarks=watermarks, device="cpu"), WatermarkRegistry,
        lambda g: AnalysisManager(g, device="cpu"), LiveQuery),
}


def serve(pkg, prog, first, batches, windows=None, window=None):
    """A LiveQuery job in event-time mode over the stream: one epoch per
    batch, each batch appended only once the previous epoch's rows are
    out. Returns (rows without viewTime, the job)."""
    Log, Graph, Marks, Manager, Query = PACKAGES[pkg]
    log, wm = Log(), Marks()
    _apply(log, first)
    wm.register("s")
    wm.advance("s", T0)
    mgr = Manager(Graph(log, watermarks=wm))
    per = len(windows) if windows is not None else 1
    job = mgr.submit(prog, Query(repeat=STEP, event_time=True,
                                 max_runs=len(batches) + 1, window=window,
                                 windows=windows))
    failed = []

    def feed():
        for i, ev in enumerate(batches):
            deadline = time.monotonic() + 60
            while (len(mgr.results(job.id)) < (i + 1) * per
                   and not job.wait(0.001)):
                if time.monotonic() > deadline:
                    failed.append(i)
                    return
            _apply(log, ev)
            wm.advance("s", T0 + (i + 1) * STEP)
        wm.finish("s")

    feeder = threading.Thread(target=feed)
    feeder.start()
    try:
        assert job.wait(120), (pkg, job.error)
    finally:
        wm.finish("s")
        feeder.join(30)
    assert not failed and job.status == "done", (pkg, job.status, job.error)
    rows = [{k: v for k, v in r.items() if k != "viewTime"}
            for r in mgr.results(job.id)]
    return rows, job


def jax_modes(job):
    return FRESH.live_subscription_rows()[job.id]["modes"]


def assert_rows_match(got, want, float_tol):
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        if not float_tol:
            assert g == w
            continue
        for k in ("time", "windowsize", "steps"):
            assert g[k] == w[k], (k, g, w)
        gr, wr = g["result"], w["result"]
        assert [v for v, _ in gr["top10"]] == [v for v, _ in wr["top10"]]
        np.testing.assert_allclose([r for _, r in gr["top10"]],
                                   [r for _, r in wr["top10"]],
                                   rtol=1e-5, atol=1e-7)
        assert abs(gr["sum"] - wr["sum"]) <= 1e-5


PROGRAMS = {
    "pagerank": JPageRank(tol=1e-7, max_steps=30),
    "cc": JCC(max_steps=60),
    "bfs": JSSSP(seeds=(0, 3), directed=False, max_steps=60),
    "sssp": JSSSP(seeds=(0,), weight_prop="w", directed=False,
                  max_steps=60),
}


def _port(jprog):
    return program_from_params(type(jprog).__name__,
                               **dataclasses.asdict(jprog))


@pytest.mark.parametrize("windows", [None, (30, 10)])
@pytest.mark.parametrize("name", sorted(PROGRAMS))
def test_live_stream_matches_reference(name, windows):
    """Epoch 0 rebases, the new-vertex batch rebases, every other epoch is
    incremental (CC / BFS warm where the batch adds only and no window
    is asked for; PageRank always; SSSP never)."""
    first, batches = stream({"pagerank": 1, "cc": 2, "bfs": 3,
                             "sssp": 4}[name])
    jprog = PROGRAMS[name]
    want, jjob = serve("jax", jprog, first, batches, windows=windows)
    got, job = serve("port", _port(jprog), first, batches, windows=windows)
    assert_rows_match(got, want, name == "pagerank")
    assert [r["time"] for r in got][:: len(windows or [0])] == \
        [T0 + i * STEP for i in range(len(batches) + 1)]
    assert job.live.mode_counts == jax_modes(jjob) == \
        {"rebase": 2, "incremental": len(batches) - 1}
    eps = list(job.live.epochs)
    assert [e["mode"] for e in eps] == \
        ["rebase", "incremental", "incremental", "rebase", "incremental",
         "incremental"]
    assert all(e["delta_rows"] > 0 for e in eps[1:])
    # the warm gate: PageRank on every incremental epoch, CC / BFS on the
    # add-only ones without windows, SSSP never
    gate = {"pagerank": [True] * 4,
            "cc": [True, True, False, True] if windows is None else
            [False] * 4, "sssp": [False] * 4}
    gate["bfs"] = gate["cc"]
    assert [e["warm"] for e in eps if e["mode"] == "incremental"] == \
        gate[name]
    # an incremental epoch ships a delta, not the base a rebase ships
    assert eps[1]["ship_bytes"] < eps[0]["ship_bytes"]


@pytest.mark.parametrize("knob", ["live_off", "resync"])
def test_live_knobs_match_reference(knob, monkeypatch):
    """``RTPU_LIVE=0``: every epoch re-sweeps (the View routes).
    ``RTPU_LIVE_RESYNC=1``: every epoch after the first drops residency
    and the seed."""
    if knob == "live_off":
        monkeypatch.setenv("RTPU_LIVE", "0")
    else:
        monkeypatch.setenv("RTPU_LIVE_RESYNC", "1")
    first, batches = stream(5, new_vertex_at=None, deletes_at=())
    jprog = PROGRAMS["cc"]
    want, jjob = serve("jax", jprog, first, batches)
    got, job = serve("port", _port(jprog), first, batches)
    assert_rows_match(got, want, False)
    assert job.live.mode_counts == jax_modes(jjob)
    if knob == "live_off":
        assert job.live.mode_counts == {"resweep": len(batches) + 1}
    else:
        assert job.live.mode_counts == {"rebase": 1,
                                        "resync": len(batches)}


def test_non_columnar_program_resweeps_like_the_reference():
    """A program with no columnar engine (DegreeBasic) declines the
    standing engine once and re-sweeps every epoch."""
    first, batches = stream(6, new_vertex_at=None)
    want, jjob = serve("jax", JDegree(), first, batches)
    got, job = serve("port", _port(JDegree()), first, batches)
    assert_rows_match(got, want, False)
    assert job.live.mode_counts == jax_modes(jjob) == \
        {"resweep": len(batches) + 1}


def test_wall_clock_mode_skips_unchanged_epochs():
    first, _ = stream(7)
    rows = {}
    for pkg, prog in (("jax", JCC(max_steps=60)),
                      ("port", _port(JCC(max_steps=60)))):
        Log, Graph, Marks, Manager, Query = PACKAGES[pkg]
        log = Log()
        _apply(log, first)
        mgr = Manager(Graph(log, watermarks=Marks()))
        job = mgr.submit(prog, Query(repeat=0.01, max_runs=5))
        assert job.wait(60) and job.status == "done", job.error
        rows[pkg] = ([{k: v for k, v in r.items() if k != "viewTime"}
                      for r in mgr.results(job.id)],
                     jax_modes(job) if pkg == "jax"
                     else job.live.mode_counts)
    assert rows["port"] == rows["jax"]
    assert rows["port"][1] == {"rebase": 1, "skipped": 4}
    assert len(rows["port"][0]) == 1


def test_failed_epoch_dispatch_fails_the_job(monkeypatch):
    """The port's rule (ROADMAP, known differences): an exception from the
    standing engine's dispatch fails the job; the epoch does not re-sweep."""
    first, batches = stream(8)
    resweeps = []
    monkeypatch.setattr(live_mod.LiveEpochState, "_resweep",
                        lambda *a: resweeps.append(1) or "resweep")

    def boom(*a, **k):
        raise RuntimeError("kernel launch failed")

    monkeypatch.setattr(hopbatch.HopBatchedCC, "_dispatch_deltas", boom)
    Log, Graph, Marks, Manager, Query = PACKAGES["port"]
    log = Log()
    _apply(log, first)
    mgr = Manager(Graph(log, watermarks=Marks()))
    job = mgr.submit(_port(JCC(max_steps=60)),
                     Query(repeat=STEP, event_time=True, max_runs=3))
    assert job.wait(60) and job.status == "failed"
    assert "kernel launch failed" in job.error
    assert not resweeps and mgr.results(job.id) == []


def test_knobs_parse_like_the_reference(monkeypatch):
    from raphtory_tpu.jobs import live as jlive

    for env, vals in (("RTPU_LIVE_EPOCH_MS", ["", "40", "x", "-3"]),
                      ("RTPU_LIVE_RESYNC", ["", "0", "9", "bad"]),
                      ("RTPU_LIVE", ["", "0", "1", "false"])):
        for v in vals:
            monkeypatch.setenv(env, v)
            assert live_mod.epoch_floor_s() == jlive.epoch_floor_s()
            assert live_mod.resync_every() == jlive.resync_every()
            assert live_mod.live_enabled() == jlive.live_enabled()
    assert live_mod.MAX_DEVICE_MASK_BYTES == jlive.MAX_DEVICE_MASK_BYTES
    assert live_mod.MAX_HOST_COLUMN_BYTES == jlive.MAX_HOST_COLUMN_BYTES


def test_kill_interrupts_the_watermark_wait():
    """Event-time mode waits for the watermark in chunks, so a kill ends a
    job whose source never advances past its first epoch."""
    first, _ = stream(9)
    Log, Graph, Marks, Manager, Query = PACKAGES["port"]
    log, wm = Log(), Marks()
    _apply(log, first)
    wm.register("s")
    wm.advance("s", T0)
    mgr = Manager(Graph(log, watermarks=wm))
    job = mgr.submit(_port(JCC(max_steps=60)),
                     Query(repeat=STEP, event_time=True), wait_timeout=60)
    deadline = time.monotonic() + 30
    while not mgr.results(job.id) and time.monotonic() < deadline:
        time.sleep(0.01)
    assert len(mgr.results(job.id)) == 1   # the first epoch, at T0
    t0 = time.monotonic()
    job.kill()
    assert job.wait(5) and job.status == "killed"
    assert time.monotonic() - t0 < 2.0
    # the epoch the kill cut short emits nothing (as in the reference, the
    # loop serves it, and the emit stops at the kill)
    assert len(mgr.results(job.id)) == 1


# ---- the live engine's obs hooks (freshness, metrics, journal, tracer) --


def _live_counts(metrics, job_ids=None):
    """``raphtory_live_epochs_total`` by (algorithm, mode)."""
    fam = metrics.live_epochs
    out = {}
    for child_key, child in fam._metrics.items() \
            if hasattr(fam, "_metrics") else fam._children.items():
        value = child._value.get() if hasattr(child._value, "get") \
            else child._value
        out[tuple(child_key)] = value
    return out


@pytest.mark.parametrize("name,seed", [("cc", 8), ("sssp", 9)])
def test_live_hooks_fire_as_the_reference(name, seed, monkeypatch,
                                          tmp_path):
    """Every epoch lands in the freshness plane's subscription table, the
    epochs counter, the journal and the tracer, in both packages alike
    (the port adds one ``live.repin`` span an incremental epoch, which
    splits the epoch's time). A stream of its own a program: the
    reference's fold cache would serve a repeated stream from its payload
    entries, which the port does not keep."""
    from raphtory_tpu.obs import journal as j_journal
    from raphtory_tpu.obs.metrics import METRICS as J_METRICS
    from raphtory_tpu.obs.trace import TRACER as J_TRACER
    from raphtory_tpu_torch.obs import journal as p_journal
    from raphtory_tpu_torch.obs.freshness import FRESH as P_FRESH
    from raphtory_tpu_torch.obs.metrics import METRICS as P_METRICS
    from raphtory_tpu_torch.obs.trace import TRACER as P_TRACER

    P_FRESH.clear()
    first, batches = stream(seed, n_batches=3, new_vertex_at=None)
    jprog = PROGRAMS[name]
    before = (_live_counts(J_METRICS), _live_counts(P_METRICS))
    monkeypatch.setenv("RTPU_JOURNAL", "1")
    out = {}
    for pkg, journal, prog in (("jax", j_journal, jprog),
                               ("port", p_journal, _port(jprog))):
        monkeypatch.setenv("RTPU_JOURNAL_DIR", str(tmp_path / pkg))
        journal.shutdown()
        try:
            rows, job = serve(pkg, prog, first, batches)
            assert journal.get().flush(30.0)
            recs = [r for seg in sorted((tmp_path / pkg).iterdir())
                    for r, _ in journal.scan_segment(str(seg))]
        finally:
            journal.shutdown()
        epochs = [{k: v for k, v in r["d"].items()
                   if k not in ("seconds", "staleness_s", "job_id")}
                  for r in recs if r["k"] == "epoch"]
        out[pkg] = (rows, job, epochs)
    (jrows, jjob, jep), (rows, job, ep) = out["jax"], out["port"]
    assert_rows_match(rows, jrows, name == "pagerank")
    assert ep == jep and [e["mode"] for e in ep] == \
        ["rebase"] + ["incremental"] * len(batches)
    # the freshness plane's subscription row
    sub_j = FRESH.live_subscription_rows()[jjob.id]
    sub_p = P_FRESH.live_subscription_rows()[job.id]
    assert sub_p["modes"] == sub_j["modes"]
    assert _strip_recent(sub_p) == _strip_recent(sub_j)
    # the counter moved by the same (algorithm, mode) amounts
    dj = {k: v - before[0].get(k, 0)
          for k, v in _live_counts(J_METRICS).items()}
    dp = {k: v - before[1].get(k, 0)
          for k, v in _live_counts(P_METRICS).items()}
    assert {k: v for k, v in dp.items() if v} == \
        {k: v for k, v in dj.items() if v}
    # a traced run of each (the journal off again): the epoch spans of the
    # reference, plus the port's live.repin around each adoption
    monkeypatch.delenv("RTPU_JOURNAL")
    monkeypatch.delenv("RTPU_JOURNAL_DIR")
    spans = {}
    for pkg, tracer, prog in (("jax", J_TRACER, jprog),
                              ("port", P_TRACER, _port(jprog))):
        tracer.enable()
        try:
            _, tjob = serve(pkg, prog, first, batches)
            spans[pkg] = [e["name"] for e in tracer.for_trace(tjob.trace_id)
                          if e.get("ph") == "X"]
        finally:
            tracer.disable()
    assert spans["port"].count("live.epoch") == \
        spans["jax"].count("live.epoch") == len(batches) + 1
    assert spans["port"].count("live.repin") == len(batches)
    assert spans["port"].count("sweep.columnar") == \
        spans["jax"].count("sweep.columnar")
    P_FRESH.clear()


def _strip_recent(sub):
    """A subscription row without its clock readings."""
    return {k: ([{kk: vv for kk, vv in r.items()
                  if kk not in ("unix", "staleness_seconds")}
                 for r in v] if k == "recent" else v)
            for k, v in sub.items()
            if k not in ("last_unix", "first_unix", "last_wall",
                         "staleness_seconds", "last_staleness_seconds",
                         "key")}


class _GradeJob:
    """What ``LiveEpochState.next_wait`` reads of its job."""

    class ledger:
        algorithm = "PageRank"
    program = None


@pytest.mark.parametrize("staleness,grade", [(0.5, "ok"), (3.0, "burning")])
def test_staleness_grades_equal(monkeypatch, staleness, grade):
    """The same ingest head and live results give the same staleness
    budget grade and the same wait in both packages. Both keep a grade
    under the target's lower-cased name, so the epoch engine, which asks
    under the program's name, reads "ok" in both."""
    from raphtory_tpu.jobs.live import LiveEpochState as JLiveEpochState
    from raphtory_tpu_torch.obs.freshness import FRESH as P_FRESH

    monkeypatch.setenv("RTPU_FRESH_TARGET", "PageRank=p50:1s")
    got = []
    for fresh, state_cls, query in (
            (FRESH, JLiveEpochState, JLiveQuery(repeat=3.0)),
            (P_FRESH, live_mod.LiveEpochState, LiveQuery(repeat=3.0))):
        fresh.clear()
        now = 1_000.0
        for i in range(20):
            # the head passes the result's time `staleness` seconds before
            # the result is served
            now += 1.0
            fresh.note_batch("s", np.array([10 * i + 5]),
                             np.array([2], np.int8), now=now - staleness)
            fresh.note_live_result("PageRank", 10 * i, now=now)
        got.append((fresh.budget_evaluate()["grade"],
                    fresh.live_grade("pagerank"),
                    fresh.live_grade("PageRank"),
                    state_cls(_GradeJob()).next_wait(query),
                    fresh.staleness_totals_below("PageRank", 1.0)))
        fresh.clear()
    assert got[1] == got[0]
    assert got[0][:4] == (grade, grade, "ok", 3.0)


@pytest.mark.parametrize("grade", ["ok", "degraded", "burning"])
def test_next_wait_follows_each_grade(monkeypatch, grade):
    """The wall-clock wait between epochs: the repeat when the budget is
    ok, half of it when degraded, the ``RTPU_LIVE_EPOCH_MS`` floor when
    burning — alike in both packages."""
    from raphtory_tpu.jobs.live import LiveEpochState as JLiveEpochState
    from raphtory_tpu_torch.obs.freshness import FRESH as P_FRESH

    monkeypatch.setenv("RTPU_LIVE_EPOCH_MS", "40")
    waits = []
    for fresh, state_cls, query in (
            (FRESH, JLiveEpochState, JLiveQuery(repeat=3.0)),
            (P_FRESH, live_mod.LiveEpochState, LiveQuery(repeat=3.0))):
        monkeypatch.setattr(fresh, "live_grade", lambda alg: grade)
        waits.append(state_cls(_GradeJob()).next_wait(query))
    assert waits[1] == waits[0] == {"ok": 3.0, "degraded": 1.5,
                                    "burning": 0.04}[grade]
