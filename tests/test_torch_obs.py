"""The port's ``obs/`` against the JAX package's: the same calls, made from
a seed with numpy, go through both packages' journal, tracer, SLO
histograms, freshness plane, error budgets, workload accounts, ledgers,
device plane and metrics bundle, and what they report must be equal.
Wherever time enters, both modules read one injected clock (``Clock``),
so no result depends on the host's speed."""

import json
import threading
import time as _real_time

import numpy as np
import pytest

import raphtory_tpu.obs.budget as j_budget
import raphtory_tpu.obs.device as j_device
import raphtory_tpu.obs.freshness as j_fresh
import raphtory_tpu.obs.journal as j_journal
import raphtory_tpu.obs.ledger as j_ledger
import raphtory_tpu.obs.metrics as j_metrics
import raphtory_tpu.obs.slo as j_slo
import raphtory_tpu.obs.trace as j_trace
import raphtory_tpu.obs.workload as j_workload
import raphtory_tpu_torch.obs.budget as p_budget
import raphtory_tpu_torch.obs.device as p_device
import raphtory_tpu_torch.obs.freshness as p_fresh
import raphtory_tpu_torch.obs.journal as p_journal
import raphtory_tpu_torch.obs.ledger as p_ledger
import raphtory_tpu_torch.obs.metrics as p_metrics
import raphtory_tpu_torch.obs.slo as p_slo
import raphtory_tpu_torch.obs.trace as p_trace
import raphtory_tpu_torch.obs.workload as p_workload

REF = dict(budget=j_budget, device=j_device, fresh=j_fresh,
           journal=j_journal, ledger=j_ledger, metrics=j_metrics, slo=j_slo,
           trace=j_trace, workload=j_workload)
PORT = dict(budget=p_budget, device=p_device, fresh=p_fresh,
            journal=p_journal, ledger=p_ledger, metrics=p_metrics, slo=p_slo,
            trace=p_trace, workload=p_workload)


class Clock:
    """One injected clock for every ``time`` a module reads: it moves only
    when the test advances it."""

    def __init__(self, t: float = 1_760_000_000.0):
        self.t = float(t)

    def time(self):
        return self.t

    monotonic = perf_counter = time

    def perf_counter_ns(self):
        return int(round(self.t * 1e9))

    def time_ns(self):
        return self.perf_counter_ns()

    def sleep(self, s):
        _real_time.sleep(s)   # waits for other threads; the clock holds

    def advance(self, s):
        self.t += float(s)


@pytest.fixture
def clocks(monkeypatch):
    """A fresh clock per package, patched into every obs module of it."""
    out = []
    for pkg in (REF, PORT):
        c = Clock()
        for name, mod in pkg.items():
            if name != "metrics":   # creation stamps: see the metrics test
                monkeypatch.setattr(mod, "time", c)
        out.append(c)
    return out


def _both(fn):
    """``fn(pkg)`` for the reference and the port."""
    return fn(REF), fn(PORT)


# ---------------------------------------------------------------- journal


def test_journal_records_equal(tmp_path, clocks):
    rng = np.random.default_rng(11)
    kinds = ["ledger", "sched", "epoch", "fresh", "fault"]
    recs = [(kinds[int(rng.integers(0, len(kinds)))],
             {"x": int(rng.integers(0, 100)),
              "y": round(float(rng.random()), 6)},
             f"t{int(rng.integers(0, 3))}" if rng.random() < 0.5 else None,
             "acme" if rng.random() < 0.3 else None) for _ in range(40)]

    def drive(pkg, clock, d):
        j = pkg["journal"].Journal(directory=str(d), process_index=0)
        for kind, data, trace, tenant in recs:
            clock.advance(0.25)
            j.emit(kind, data, trace_id=trace, tenant=tenant)
        assert j.flush(30.0)
        status = j.status()
        j.close()
        got = []
        for name in sorted(p.name for p in d.iterdir()):
            got += pkg["journal"].scan_segment(str(d / name))
        return got, {k: status[k] for k in ("records_written", "drops",
                                             "encode_errors", "segments")}

    want = drive(REF, clocks[0], tmp_path / "ref")
    got = drive(PORT, clocks[1], tmp_path / "port")
    assert got == want
    assert len(want[0]) == len(recs) + 1   # the meta record first


# ------------------------------------------------------------------ trace


def _trace_program(pkg):
    """Nested spans, instants, a completed span, a cross-thread handoff
    (``capture`` / ``carry``) and an error span, on a private tracer."""
    tr = pkg["trace"].Tracer(enabled=True, ring=256, annotate=False)
    tr._trace_prefix = "p"
    clock = pkg["trace"].time
    with tr.span("rest.request", method="POST", path="/x") as root:
        clock.advance(0.001)
        ctx = tr.capture()
        with tr.span("job", job_id="j1"):
            clock.advance(0.002)
            tr.instant("sched.batch", jobs=3)
            with tr.span("hop.fold", hops=2):
                clock.advance(0.004)
            tr.complete("fold.stall", 0.0005, hops=2)
        box = []

        def work():
            with tr.span("hop.compute", cols=6):
                clock.advance(0.003)
            box.append(tr.capture())

        t = threading.Thread(target=tr.carry(work), name="worker-1")
        t.start()
        t.join()
        try:
            with tr.span("superstep.block"):
                raise ValueError("boom")
        except ValueError:
            pass
        root.set(status="done")
    with tr.adopt(ctx):
        with tr.span("late.child"):
            clock.advance(0.001)
    return tr, root.trace


def _normalise(events):
    """Thread idents and the process id differ between two runs: map each
    to its first-seen order."""
    tids, out = {}, []
    for e in events:
        e = json.loads(json.dumps(e))
        if "tid" in e:
            e["tid"] = tids.setdefault(e["tid"], len(tids))
        e.pop("pid", None)
        out.append(e)
    return out


def test_trace_trees_and_chrome_traces_equal(clocks):
    (jt, jid), (pt, pid) = _both(_trace_program)
    assert jid == pid == "p-1"
    assert _normalise(pt.recent(100)) == _normalise(jt.recent(100))
    assert _normalise(pt.for_trace(pid)) == _normalise(jt.for_trace(jid))
    jc, pc = jt.chrome_trace(), pt.chrome_trace()
    assert _normalise(pc["traceEvents"]) == _normalise(jc["traceEvents"])
    st_j, st_p = jt.status(), pt.status()
    st_j.pop("dump_path", None)
    st_p.pop("dump_path", None)
    assert st_p == st_j


# ------------------------------------------------------- SLO and budgets


def test_slo_and_budget_payloads_equal(clocks, monkeypatch):
    monkeypatch.setenv("RTPU_SLO_TARGET", "pagerank=p99:0.25s,cc=p90:1s")
    rng = np.random.default_rng(5)
    obs = [(("PageRank", "ConnectedComponents")[int(rng.integers(0, 2))],
            ("e2e", "fold", "compute")[int(rng.integers(0, 3))],
            float(rng.exponential(0.2)), f"tr{i}") for i in range(200)]

    def drive(pkg):
        slo = pkg["slo"].SLORegistry()
        clock = pkg["slo"].time
        for alg, ph, sec, tid in obs:
            clock.advance(0.01)
            slo.observe(alg, ph, sec, trace_id=tid)
        monkeypatch.setattr(pkg["slo"], "SLO", slo)
        budget = pkg["budget"].BudgetRegistry()
        try:
            ev = budget.evaluate(now=clock.t + 1.0, rows=[])
        finally:
            budget.clear()
        return (slo.as_dict(), ev, slo.totals_below("pagerank", "e2e", 0.25),
                slo.exemplar("PageRank"))

    assert drive(PORT) == drive(REF)


# ------------------------------------------------------------- freshness


def test_freshness_payloads_equal(clocks, monkeypatch):
    monkeypatch.setenv("RTPU_FRESH_TARGET", "pagerank=p99:5s")
    rng = np.random.default_rng(9)
    batches = []
    t_hi = 0
    for i in range(12):
        n = int(rng.integers(1, 50))
        t = np.sort(rng.integers(t_hi, t_hi + 100, n))
        t[: n // 4] -= 30    # some events arrive behind the high water
        k = rng.integers(0, 4, n)
        batches.append((("a", "b")[i % 2], t.astype(np.int64),
                        k.astype(np.int8)))
        t_hi += 100

    def drive(pkg):
        fr = pkg["fresh"].FreshnessRegistry()
        clock = pkg["fresh"].time
        fr.register_source("a", disorder=10)
        fr.register_source("b", disorder=50)
        for i, (src, t, k) in enumerate(batches):
            clock.advance(0.5)
            fr.note_batch(src, t, k, trace_id=f"b{i}")
            if i % 3 == 2:
                clock.advance(0.2)
                fr.note_safe(int(t.max()) - 40)
        for j in range(6):
            clock.advance(1.5)
            s = fr.note_live_result("PageRank", 100 * j, head_time=1_200,
                                    trace_id=f"l{j}")
            fr.note_live_epoch(f"job{j % 2}", algorithm="PageRank",
                               mode=("rebase", "incremental")[j > 0],
                               delta_rows=10 * j, ship_bytes=64 * j,
                               staleness_s=s, result_time=100 * j)
        return (fr.freshz(), fr.status_block(),
                fr.budget_evaluate(now=clock.t),
                fr.live_grade("PageRank"), fr.pending_batches(),
                fr.queryable_lag_seconds())

    assert drive(PORT) == drive(REF)


# -------------------------------------------------- ledgers and workload


def _ledger_program(pkg, seed=3):
    """Two query ledgers with phases, sweeps, kernels, a coalesced share
    and a merge, closed and rolled into workload accounts."""
    led_mod = pkg["ledger"]
    rng = np.random.default_rng(seed)
    clock = led_mod.time
    leds = []
    for q in range(3):
        led = led_mod.Ledger(f"q{q}", ("PageRank", "ConnectedComponents")[
            q % 2])
        led.tenant = ("acme", "anon")[q % 2]
        led.queue_wait_seconds = 0.001 * q
        for ph in ("fold", "compute", "emit"):
            led.add_phase(ph, float(rng.random()))
        led.add_sweep({"fold": 0.1, "stage": 0.01, "ship": 0.02,
                       "compute": 0.3},
                      {"bytes_shipped": 1024 * (q + 1),
                       "stage_stall_seconds": 0.01,
                       "wire_stall_seconds": 0.02}, 4096, 3,
                      fold_modes={"serial": 0.1})
        led.fold_cache_event(hit=q % 2 == 0)
        rec = {"flops": None, "bytes_accessed": None, "bound": "unknown"}
        for _ in range(q + 2):
            led.count_dispatch("hopbatch.delta.pagerank", rec)
        led.count_measured("hopbatch.delta.pagerank", 0.002)
        led.count_views(6)
        led.count_supersteps(20)
        led.add_dcn("halo", rows=100, bytes_=400)
        leds.append(led)
    batch = led_mod.Ledger("batch_0", "pagerank")
    batch.add_phase("compute", 0.5)
    batch.add_sweep({"fold": 0.2, "compute": 0.3}, {}, 0, 2)
    leds[0].absorb_share(batch.as_dict(), 0.25,
                         coalesced={"batch_id": "batch_0", "jobs": 4})
    leds[1].merge(leds[2])
    clock.advance(2.0)
    for led in leds:
        led.finish(2.0, status="done")
    # the resident-set peak is the process's: the same for both packages
    # only by luck of timing, so it is compared apart
    return leds


def test_ledger_and_workload_accounts_equal(clocks, monkeypatch):
    def drive(pkg):
        leds = _ledger_program(pkg)
        wl = pkg["workload"].WorkloadRegistry()
        for led in leds:
            wl.record(led, status="done")
        dicts = [led.as_dict() for led in leds]
        for d in dicts:
            assert d["host"].pop("peak_rss_bytes") > 0
        return dicts, [led.bound() for led in leds], wl.workloadz(), \
            wl.top_by_cost(2), wl.status_block()

    want, got = _both(drive)
    # the one field the port reports differently by design: the reference
    # harvests XLA analysis on the CPU, the port has none to harvest
    for d in want[0] + got[0]:
        d.pop("xla_analysis")
    for a in (want[2], got[2]):
        for acc in a["tenants"]:
            acc.get("host", {}).pop("peak_rss_bytes", None)
    assert got == want


def test_ledger_probe_is_the_reference_degraded_mode():
    p_ledger.reset_xla_caps()
    caps = p_ledger.xla_analysis_caps()
    assert caps["cost"] is False and caps["memory"] is False
    assert caps["platform"] == "cpu"
    rec = p_ledger.REGISTRY.harvest("hopbatch.test", ("py:int",), None, ())
    assert rec["bound"] == "unknown" and rec["flops"] is None
    cz = p_ledger.costz()
    assert cz["xla"]["cost"] is False
    assert all(k["bound"] == "unknown" for k in cz["kernels"])


def test_instrument_counts_dispatches_into_the_ledger(monkeypatch):
    monkeypatch.setenv("RTPU_DEVICE_TIMING", "1")
    import torch

    calls = []

    def kernel(a, b, scale=1.0):
        calls.append(1)
        return a * scale + b

    k = p_ledger.instrument("hopbatch.test_kernel", kernel)
    led = p_ledger.Ledger("q", "PageRank")
    with p_ledger.activate(led):
        for _ in range(3):
            out = k(torch.ones(4), torch.zeros(4), scale=2.0)
    assert torch.equal(out, torch.full((4,), 2.0)) and len(calls) == 3
    snap = led.as_dict()["device"]["kernels"]["hopbatch.test_kernel"]
    assert snap["dispatches"] == 3 and snap["timed_dispatches"] == 2
    rows = [r for r in p_ledger.REGISTRY.snapshot()
            if r["kernel"] == "hopbatch.test_kernel"]
    assert rows and rows[0]["sig"] == "torch.float32[4]×torch.float32[4]" \
        "×py:float"
    assert rows[0]["dispatches"] == 3


# ---------------------------------------------------------------- device


def test_device_plane_degrades_as_the_reference_on_the_cpu():
    import jax.numpy as jnp
    import torch

    assert p_device.memory_snapshot() == j_device.memory_snapshot()
    tree_j = (jnp.zeros(10, jnp.int32), [jnp.ones(3, jnp.bool_)])
    tree_p = (torch.zeros(10, dtype=torch.int32),
              [torch.ones(3, dtype=torch.bool)])
    assert p_device.nbytes_tree(tree_p) == j_device.nbytes_tree(tree_j) == 43
    assert p_device.block_ready(tree_p) and j_device.block_ready(tree_j)

    class Owner:
        pass

    def drive(pkg, tree):
        reg = pkg["device"].ResidentRegistry()
        a, b = Owner(), Owner()
        reg.track(a, "fold_state", pkg["device"].nbytes_tree(tree))
        reg.track(b, "advanced_base", 7)
        reg.drop(b, "advanced_base")
        snap = reg.snapshot()
        for r in snap["buffers"]:
            r.pop("unix")
        return snap

    assert drive(PORT, tree_p) == drive(REF, tree_j)


# --------------------------------------------------------------- metrics


def _drive_metrics(m):
    rng = np.random.default_rng(2)
    m.jobs_started.labels("RangeQuery").inc()
    m.jobs_completed.labels(status="done").inc(3)
    m.supersteps.inc(17)
    m.live_epochs.labels("PageRank", "incremental").inc(2)
    m.partition_skew.labels("edges_dst").set(1.375)
    m.h2d_inflight_depth.set(123456789.5)
    m.scheduler_batches.labels("pagerank").inc()
    m.scheduler_shed.labels("over_budget").inc()
    for x in rng.exponential(0.3, 40):
        m.view_seconds.observe(float(x))
        m.request_seconds.labels("PageRank", "e2e").observe(float(x))
        m.shard_rows.labels("halo_dst").observe(float(x) * 1e6)
    m.scheduler_coalesced_jobs.observe(4)
    m.tenant_cost_seconds.labels('we"ird\\ten\nant', "fold").inc(0.5)


def test_metrics_exposition_equal_line_for_line(monkeypatch):
    """The port's exposition of the same ``inc`` / ``set`` / ``observe``
    calls equals ``prometheus_client``'s line for line. The ``_created``
    rule: both write a ``_created`` sample per counter and histogram
    series (a gauge family after each metric); its VALUE is each
    package's own creation time, so those lines are compared by name and
    labels only. The scrape-time gauges read process state (RSS, the
    card's memory, the live schedulers) and are compared the same way."""
    from prometheus_client import generate_latest

    monkeypatch.delenv("PROMETHEUS_DISABLE_CREATED_SERIES", raising=False)
    jm, pm = j_metrics.Metrics(), p_metrics.Metrics()
    _drive_metrics(jm)
    _drive_metrics(pm)
    want = generate_latest(jm.registry).decode().splitlines()
    got = pm.registry.exposition().splitlines()
    assert len(got) == len(want)
    live = ("raphtory_host_rss_bytes", "raphtory_device_bytes_in_use",
            "raphtory_scheduler_queue_depth",
            "raphtory_scheduler_backlog_seconds",
            "raphtory_freshness_pending_batches")
    created = 0
    for g, w in zip(got, want):
        name = w.split(" ")[0]
        if not w.startswith("#") and (
                name.split("{")[0].endswith("_created")
                or name.startswith(live)):
            assert g.split(" ")[0] == name
            float(g.split(" ")[1])
            created += name.split("{")[0].endswith("_created")
        else:
            assert g == w
    assert created >= 20


def test_metrics_server_serves_the_exposition():
    import urllib.request

    srv = p_metrics.MetricsServer(port=0, addr="127.0.0.1").start()
    try:
        assert srv.port and p_metrics.bound_port() == srv.port
        resp = urllib.request.urlopen(
            f"http://127.0.0.1:{srv.port}/metrics", timeout=30)
        text = resp.read().decode()
        assert resp.headers["Content-Type"] == p_metrics.CONTENT_TYPE
    finally:
        srv.stop()
    assert "# TYPE raphtory_views_computed_total counter" in text
    assert p_metrics.bound_port() == 0
