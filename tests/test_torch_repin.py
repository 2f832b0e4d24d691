"""Incremental re-pin in the port against the reference: ``SweepBuilder.
repin`` returns the reference's status on each guard's log; after
``"extended"`` the fold state, ``DeviceSweep`` results and the hop-batched
engines' results (SSSP's weight stream included) are bitwise a fresh
engine's over the grown log; the resident View route extends its sweep
without building a new one; and no fold in flight folds over a pin that a
repin rebinds."""

import threading
import time

import numpy as np
import pytest
import torch

from raphtory_tpu.core.events import EventLog as JEventLog
from raphtory_tpu.core.sweep import SweepBuilder as JSweepBuilder
from raphtory_tpu_torch.core.events import EventLog
from raphtory_tpu_torch.core.service import TemporalGraph
from raphtory_tpu_torch.core.snapshot import build_view
from raphtory_tpu_torch.core.sweep import (FoldCache, SweepBuilder,
                                          log_fingerprint)
from raphtory_tpu_torch.engine import device_sweep
from raphtory_tpu_torch.engine.device_sweep import DeviceSweep
from raphtory_tpu_torch.engine.hopbatch import (HopBatchedBFS, HopBatchedCC,
                                                HopBatchedPageRank,
                                                HopBatchedSSSP)
from raphtory_tpu_torch.interop import program_from_params
from raphtory_tpu_torch.jobs.manager import AnalysisManager, ViewQuery

N_IDS = 24
STATE = ("v_lat", "v_alive", "v_first", "v_seen", "e_enc", "e_lat",
         "e_alive", "e_first", "e_seen", "e_enc_dst", "dh_v", "dh_t")


@pytest.fixture(autouse=True)
def _unbinned(monkeypatch):
    monkeypatch.setenv("RTPU_PCPM", "0")


def _pool(rng, n_pairs=60):
    return [(int(a), int(b)) for a, b in rng.integers(0, N_IDS, (n_pairs, 2))]


def _events(rng, pool, t_lo, t_hi, n, deletes=False, props=False):
    """``n`` events with times in (t_lo, t_hi], arrival order shuffled, over
    the seeded ids and pairs (an adoptable suffix)."""
    out = []
    for t in rng.integers(t_lo + 1, t_hi + 1, n):
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


def _seed(rng, pool, logs, props=False):
    """Every id and every pool pair at times 0 / 1, then a shuffled
    segment up to t 40 (with deletes)."""
    ev = [(0, 0, v, 0, 0, None) for v in range(N_IDS)]
    ev += [(2, 1, 0, a, b, {"w": 1.0} if props else None) for a, b in pool]
    ev += _events(rng, pool, 1, 40, 200, deletes=True, props=props)
    for log in logs:
        _apply(log, ev)


def _pair(seed, props=False):
    rng = np.random.default_rng(seed)
    pool = _pool(rng)
    log, jlog = EventLog(), JEventLog()
    _seed(rng, pool, (log, jlog), props=props)
    return rng, pool, log, jlog


class _Compacted:
    """A live log whose pin reports one compaction more than it did: the
    port's log has no ``compact_to`` (ROADMAP queue 1 item 6), so the
    guard is driven with the attribute the reference's compaction moves."""

    def __init__(self, log):
        self.log = log

    def pin(self):
        p = self.log.freeze()
        p.compactions = 1
        return p


def _guard_case(guard, log, jlog, rng, pool):
    """Grow both logs as ``guard`` needs; return the port's live log."""
    if guard == "noop":
        return log
    if guard == "new_vertex":
        ev = [(2, 50, 0, 0, N_IDS + 5, None)]
    elif guard == "behind_clock":
        ev = [(2, 10, 0, 1, 2, None)]
    elif guard == "new_pair":
        known = set(pool)
        a, b = next((a, b) for a in range(N_IDS) for b in range(N_IDS)
                    if (a, b) not in known)
        ev = [(2, 50, 0, a, b, None)]
    elif guard == "at_clock":
        ev = [(2, 40, 0, *pool[0], None)]
    elif guard in ("extended", "compaction"):
        ev = _events(rng, pool, 40, 60, 40, deletes=True)
    _apply(log, ev)
    _apply(jlog, ev)
    if guard == "compaction":
        jlog.compact_to(JEventLog(), 0)
        return _Compacted(log)
    return log


GUARDS = ["noop", "extended", "new_vertex", "behind_clock", "at_clock",
          "new_pair", "compaction"]


@pytest.mark.parametrize("preseed", [True, False])
@pytest.mark.parametrize("guard", GUARDS)
def test_repin_status_matches_reference(guard, preseed):
    rng, pool, log, jlog = _pair(3)
    sw = SweepBuilder(log, track_rows=False, preseed_pairs=preseed)
    jsw = JSweepBuilder(jlog, track_rows=False, preseed_pairs=preseed)
    sw._advance(40)
    jsw._advance(40)
    live = _guard_case(guard, log, jlog, rng, pool)
    status = sw.repin(live)
    assert status == jsw.repin(jlog)
    want = {"noop": "noop", "extended": "extended",
            "new_pair": "rebuild" if preseed else "extended"}.get(
                guard, "rebuild")
    assert status == want


@pytest.mark.parametrize("preseed", [True, False])
def test_extended_fold_state_is_a_fresh_builders(preseed):
    rng, pool, log, _ = _pair(5)
    sw = SweepBuilder(log, preseed_pairs=preseed)
    sw.view_at(40)
    old_fp = log_fingerprint(sw.log)
    cache = FoldCache(1 << 24)
    sw.save_checkpoint(cache)
    for lo, hi in ((40, 55), (55, 70), (70, 90)):
        _apply(log, _events(rng, pool, lo, hi, 60, deletes=True))
        assert sw.repin(log) == "extended"
        assert sw.repin(log) == "noop"
        got = sw.view_at(hi)
        fresh = SweepBuilder(log, preseed_pairs=preseed)
        want = fresh.view_at(hi)
        for k in STATE:
            np.testing.assert_array_equal(getattr(sw, k), getattr(fresh, k),
                                          err_msg=k)
        for f in ("vids", "v_mask", "v_latest_time", "e_src", "e_dst",
                  "e_mask", "e_latest_time", "in_deg", "out_deg"):
            np.testing.assert_array_equal(getattr(got, f), getattr(want, f),
                                          err_msg=f)
        ref = build_view(log, hi)
        np.testing.assert_array_equal(got.v_mask, ref.v_mask)
        assert sw._config() == fresh._config()
    # the cache key follows the new pin: the old pin's checkpoint at t 40
    # seeds no fork of the extended builder
    assert log_fingerprint(sw.log) != old_fp
    assert cache.nearest_checkpoint(log_fingerprint(sw.log), sw._config(),
                                    90) is None
    assert not sw.covered(cache, [95])


def _cc():
    return program_from_params("ConnectedComponents", max_steps=60)


def _pr():
    return program_from_params("PageRank", tol=1e-7, max_steps=30)


def test_device_sweep_extends_bitwise_a_fresh_sweep():
    rng, pool, log, _ = _pair(7)
    ds = DeviceSweep(log, device="cpu")
    ds.run(_cc(), 40, windows=[30, 10])
    edges, vids = ds.edges, ds.vids
    for lo, hi in ((40, 52), (52, 75)):
        _apply(log, _events(rng, pool, lo, hi, 50, deletes=True))
        assert ds.repin(log) == "extended"
        assert ds.edges is edges and ds.vids is vids and ds.t_now == lo
        fresh = DeviceSweep(log, device="cpu")
        for prog in (_cc(), _pr()):
            got, gs = ds.run(prog, hi, windows=[50, 30, 10])
            want, ws = fresh.run(prog, hi, windows=[50, 30, 10])
            assert gs == ws
            for g, w in zip(*(x.values() if isinstance(x, dict) else (x,)
                              for x in (got, want))):
                assert torch.equal(g, w)
        for a, b in zip(ds._bufs, fresh._bufs):
            assert torch.equal(a, b)


def test_device_sweep_rebuilds_when_stale_or_past_the_time_dtype():
    rng, pool, log, _ = _pair(8)
    ds = DeviceSweep(log, device="cpu")
    ds.advance(40)
    assert ds.tdtype == np.int32
    _apply(log, [(2, 1 << 30, 0, *pool[0], None)])
    assert ds.repin(log) == "rebuild"
    rng, pool, log, _ = _pair(8)
    ds = DeviceSweep(log, device="cpu")
    ds.advance(40)
    ds._stale = True
    _apply(log, _events(rng, pool, 40, 50, 10))
    assert ds.repin(log) == "rebuild"


ENGINES = {
    "pagerank": lambda log: HopBatchedPageRank(log, tol=1e-7, max_steps=30,
                                               device="cpu"),
    "cc": lambda log: HopBatchedCC(log, max_steps=60, device="cpu"),
    "bfs": lambda log: HopBatchedBFS(log, seeds=(0, 3), max_steps=60,
                                     device="cpu"),
    "sssp": lambda log: HopBatchedSSSP(log, seeds=(0,), weight_prop="w",
                                       max_steps=60, device="cpu"),
}


@pytest.mark.parametrize("fold", ["delta", "host"])
@pytest.mark.parametrize("kind", sorted(ENGINES))
def test_hopbatch_extends_bitwise_a_fresh_engine(kind, fold, monkeypatch):
    """Every epoch adopts the suffix and folds only its delta onto the
    kept device-resident base; its columns are bitwise a fresh engine's
    over the grown log (PageRank and CC / BFS cold here: the warm seed is
    the live engine's gate, ``test_torch_live.py``)."""
    monkeypatch.setenv("RTPU_FOLD", fold)
    rng, pool, log, _ = _pair({"pagerank": 11, "cc": 12, "bfs": 13,
                               "sssp": 14}[kind], props=True)
    hb = ENGINES[kind](log)
    hb.run([40], [None, 15])
    for i, (lo, hi) in enumerate(((40, 55), (55, 70), (70, 90))):
        _apply(log, _events(rng, pool, lo, hi, 60, deletes=i % 2 == 0,
                            props=True))
        base = hb._dev_base
        assert hb.repin() == "extended"
        assert hb._dev_base is base   # residency survives the extension
        hops = [(lo + hi) // 2, hi]
        got, gs = hb.run(hops, [None, 15])
        fresh = ENGINES[kind](log)
        want, ws = fresh.run(hops, [None, 15])
        assert gs == ws
        assert torch.equal(got, want)
        if fold == "delta":
            assert hb.ship_bytes < fresh.ship_bytes
        if kind == "sssp":
            cur = hb._w_cursor
            assert cur == fresh._w_cursor
            for k in ("_w_t", "_w_val", "_w_pos", "_w_state"):
                np.testing.assert_array_equal(getattr(hb, k),
                                              getattr(fresh, k), err_msg=k)


def test_sssp_rebuilds_on_an_immutable_weight_key():
    rng, pool, log, _ = _pair(15, props=True)
    hb = ENGINES["sssp"](log)
    hb.run([40], [None])
    a, b = pool[0]
    log.add_edge(50, a, b, {"!w": 2.0})
    assert hb.repin() == "rebuild"


def test_resident_view_extends_without_a_new_sweep(monkeypatch):
    rng, pool, log, _ = _pair(17)
    g = TemporalGraph(log, device="cpu")
    mgr = AnalysisManager(g, device="cpu")
    built = []
    init = device_sweep.DeviceSweep.__init__

    def counting(self, *a, **k):
        built.append(1)
        init(self, *a, **k)

    monkeypatch.setattr(device_sweep.DeviceSweep, "__init__", counting)

    def rows(m, t):
        job = m.submit(_cc(), ViewQuery(t, windows=(50, 10)))
        assert job.wait(60) and job.status == "done", job.error
        return [{k: v for k, v in r.items() if k != "viewTime"}
                for r in m.results(job.id)]

    rows(mgr, 40)
    sweep = g._resident
    for lo, hi in ((40, 60), (60, 85)):
        _apply(log, _events(rng, pool, lo, hi, 60, deletes=True))
        n_built = len(built)
        got = rows(mgr, hi)
        assert g._resident is sweep and len(built) == n_built
        fresh = AnalysisManager(TemporalGraph(log, device="cpu"),
                                device="cpu")
        assert got == rows(fresh, hi)
    # a new vertex id: the route rebuilds its sweep from a fresh pin
    log.add_edge(90, 0, N_IDS + 3)
    n_built = len(built)
    rows(mgr, 95)
    assert g._resident is not sweep and len(built) == n_built + 1


def test_repin_waits_for_the_folds_in_flight(monkeypatch):
    """A repin issued while a pipelined run folds on the lookahead lane
    waits for it: the run folds only the pinned rows (its result is the
    old log's), and the next run folds the adopted suffix."""
    monkeypatch.setenv("RTPU_PREFETCH", "1")
    monkeypatch.setenv("RTPU_FOLD_WORKERS", "1")
    rng, pool, log, _ = _pair(19)
    snapshot = EventLog()
    _apply_from(snapshot, log)
    hb = ENGINES["cc"](log)
    advance = SweepBuilder._advance
    started = threading.Event()

    def slow(self, time_):
        started.set()
        time.sleep(0.05)
        advance(self, time_)

    monkeypatch.setattr(SweepBuilder, "_advance", slow)
    hops = [36, 38, 40, 42]
    out = {}
    runner = threading.Thread(target=lambda: out.setdefault(
        "r", hb.run(hops, [None], chunks=4)))
    runner.start()
    assert started.wait(10)
    # rows past the pin that land INSIDE the running sweep's hops: a fold
    # that saw them would change its columns
    suffix = _events(rng, pool, 40, 42, 30)
    _apply(log, suffix)
    status = {}
    repinner = threading.Thread(target=lambda: status.setdefault(
        "s", hb.repin()))
    repinner.start()
    repinner.join(30)
    runner.join(30)
    assert status["s"] == "rebuild"   # rows at or before the run's clock
    want, _ = ENGINES["cc"](snapshot).run(hops, [None])
    assert torch.equal(out["r"][0], want)
    # a suffix past the clock is adopted once the run has ended
    rng, pool, log, _ = _pair(19)
    hb = ENGINES["cc"](log)
    runner = threading.Thread(target=lambda: out.setdefault(
        "r2", hb.run(hops, [None], chunks=4)))
    started.clear()
    runner.start()
    assert started.wait(10)
    _apply(log, _events(rng, pool, 42, 60, 30))
    assert hb.repin() == "extended"
    assert not runner.is_alive()
    got, _ = hb.run([60], [None])
    assert torch.equal(got, ENGINES["cc"](log).run([60], [None])[0])


def _apply_from(dst, src):
    a = src.arrays()
    dst.append_batch(a["time"].copy(), a["kind"].copy(), a["src"].copy(),
                     a["dst"].copy())
