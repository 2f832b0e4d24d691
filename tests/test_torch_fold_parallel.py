"""The port's fold pipeline (``core/sweep.py``, ``engine/hopbatch.py``,
``engine/device_sweep.py``) after the JAX package's
``tests/test_fold_parallel.py``: forked builders' views bitwise the serial
builder's and the JAX package's, the three attribute lists, fold payloads
byte-equal across worker counts and to the JAX engine's, ``run`` and
``run_sweep`` under every mode equal to the serial loop, the choice of
mode (forks only where cached checkpoints cover their starts, the serial
lane leaving them), ``prefetch_map``'s order and drain, and the
cross-request fold cache (bound, eviction, checkpoints, a repeated Range
job). Small logs and 2-3 fold workers; no wall-clock assertion."""

import dataclasses
import sys
import threading
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch
from test_sweep import random_log
from test_torch_host import assert_views_equal

from raphtory_tpu.algorithms import ConnectedComponents as JCC
from raphtory_tpu.core.service import TemporalGraph as JTemporalGraph
from raphtory_tpu.core.snapshot import build_view as j_build_view
from raphtory_tpu.core.sweep import SweepBuilder as JSweepBuilder
from raphtory_tpu.engine.hopbatch import HopBatchedPageRank as JPageRank
from raphtory_tpu.jobs.manager import AnalysisManager as JAnalysisManager
from raphtory_tpu.jobs.manager import RangeQuery as JRangeQuery
from raphtory_tpu.utils.synth import ldbc_like_log
from raphtory_tpu_torch.algorithms import PageRank
from raphtory_tpu_torch.core import sweep as cs
from raphtory_tpu_torch.core.service import TemporalGraph
from raphtory_tpu_torch.core.sweep import (FoldCache, FoldCheckpoint,
                                          SweepBuilder, fold_cache,
                                          fold_workers, log_fingerprint,
                                          prefetch_map)
from raphtory_tpu_torch.engine import hopbatch as thb
from raphtory_tpu_torch.engine.device_sweep import DeviceSweep
from raphtory_tpu_torch.interop import (event_log_from_arrays,
                                        numeric_prop_payloads,
                                        program_from_params)
from raphtory_tpu_torch.jobs.manager import AnalysisManager, RangeQuery
from raphtory_tpu_torch.ops.resident import Staged

HOPS = [150, 300, 450, 600, 750, 900]


@pytest.fixture(autouse=True)
def _unbinned(monkeypatch):
    monkeypatch.setenv("RTPU_PCPM", "0")


def _carried(jlog):
    return event_log_from_arrays(jlog.arrays(),
                                 props=numeric_prop_payloads(jlog.props))


def _log(seed, n_events=900, n_ids=40, t_span=1000):
    return random_log(np.random.default_rng(seed), n_events=n_events,
                      n_ids=n_ids, t_span=t_span, props=True)


def _equal(a, b) -> bool:
    """Payload trees equal to the byte: arrays by value and dtype, a
    ``Staged`` buffer as the tuple of its arrays."""
    if a is None or b is None:
        return a is b
    if isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        return (isinstance(a, np.ndarray) and isinstance(b, np.ndarray)
                and a.dtype == b.dtype and np.array_equal(a, b))
    if isinstance(a, (list, tuple)):
        return len(a) == len(b) and all(_equal(x, y) for x, y in zip(a, b))
    return a == b


# ---------------------------------------------------------- fork/checkpoint


@pytest.mark.parametrize("seed", [0, 3, 8])
def test_fork_views_bit_identical_to_serial_and_jax(seed):
    """A fork seeded mid-sweep by one bulk advance (a chunk fold's shape)
    emits the serial builder's views and the JAX package's, deletes,
    tombstone joins and id reuse included."""
    jlog = random_log(np.random.default_rng(seed), n_events=500, n_ids=14,
                      t_span=60)
    log = event_log_from_arrays(jlog.arrays())
    times = [5, 12, 20, 31, 44, 59]
    serial = SweepBuilder(log)
    want = [serial.view_at(t) for t in times]
    jsw = JSweepBuilder(jlog)
    base = SweepBuilder(log)
    for lo, hi in ((0, 2), (2, 4), (4, 6)):
        fork = base.fork()
        if lo:
            fork._advance(times[lo - 1])
        for j in range(lo, hi):
            got = fork.view_at(times[j])
            assert_views_equal(got, want[j])
            assert_views_equal(got, jsw.view_at(times[j]))
    assert base.t_prev is None


def test_fork_from_checkpoint_and_independence():
    jlog = random_log(np.random.default_rng(17), n_events=400, n_ids=12,
                      t_span=50)
    sw = SweepBuilder(event_log_from_arrays(jlog.arrays()))
    sw.view_at(20)
    cp = sw.checkpoint()
    sw.view_at(45)   # the source moves past the checkpoint
    fork = sw.fork(cp)
    assert fork.t_prev == 20
    assert_views_equal(fork.view_at(30), j_build_view(jlog, 30))
    assert_views_equal(sw.view_at(49), j_build_view(jlog, 49))
    # a backward view on a fork falls back to build_view, as on any builder
    assert_views_equal(fork.view_at(10), j_build_view(jlog, 10))


def test_fork_rejects_incompatible_checkpoint():
    log = event_log_from_arrays(random_log(np.random.default_rng(1),
                                           n_events=100).arrays())
    cp = SweepBuilder(log).checkpoint()
    with pytest.raises(ValueError, match="incompatible"):
        SweepBuilder(log, include_occurrences=True).fork(cp)


@pytest.mark.parametrize("preseed", [False, True])
@pytest.mark.parametrize("track_rows", [False, True])
def test_every_builder_array_in_exactly_one_list(preseed, track_rows):
    """Every attribute of a fresh builder but its clock and last delta is
    in exactly one of the three lists, every array among them; and a fork
    advanced through deletes and fresh pairs leaves every array of its
    source as it was (a shared array written in place would show here)."""
    lists = (cs._LOG_DERIVED, cs._STATE_COPIED, cs._STATE_SHARED)
    names = [k for lst in lists for k in lst]
    assert len(names) == len(set(names))
    log = event_log_from_arrays(_log(5).arrays())
    sw = SweepBuilder(log, track_rows=track_rows, preseed_pairs=preseed)
    assert set(vars(sw)) == set(names) | {"t_prev", "last_delta"}
    arrays = {k for k, v in vars(sw).items() if isinstance(v, np.ndarray)}
    assert arrays <= set(names) - {"log"}
    assert set(cs._STATE_COPIED) | set(cs._STATE_SHARED) <= arrays
    sw._advance(300)
    assert sw.checkpoint().nbytes == sw.state_nbytes()
    before = {k: getattr(sw, k).copy() for k in names
              if isinstance(getattr(sw, k), np.ndarray)}
    fork = sw.fork()
    for T in HOPS[2:]:
        fork._advance(T)
    assert fork.dh_v is not sw.dh_v or preseed
    for k, v in before.items():
        np.testing.assert_array_equal(getattr(sw, k), v, err_msg=k)


# ------------------------------------------------- parallel chunk folds


@pytest.mark.parametrize("seed", [2, 9])
@pytest.mark.parametrize("route", ["delta", "host"])
def test_fold_payloads_byte_equal_across_workers_and_jax(monkeypatch, seed,
                                                         route):
    """``fold_payloads`` under 1 and 3 workers, and the JAX engine's over
    the same log and grid, byte-equal for chunks 1-3 and 6 (one group
    sub-split across the workers, then one unit a group). At 3 workers the
    cold fold takes the serial lane and leaves a checkpoint at every
    unit's start; the next fold forks there, one fork a unit, each seeded
    at its checkpoint with no prefix to fold. On the host-column route
    each group is ONE staged buffer, whichever threads wrote its rows."""
    monkeypatch.setenv("RTPU_FOLD", route)
    monkeypatch.setenv("RTPU_FOLD_CACHE_MB", "16")
    jlog = _log(seed)
    log = _carried(jlog)
    seeded, advanced = [], []
    real_fork_at, real_advance = SweepBuilder.fork_at, SweepBuilder._advance

    def fork_at(self, time, cache=None):
        seeded.append(time)
        return real_fork_at(self, time, cache)

    def advance(self, time):
        advanced.append(time)
        return real_advance(self, time)

    monkeypatch.setattr(SweepBuilder, "fork_at", fork_at)
    monkeypatch.setattr(SweepBuilder, "_advance", advance)
    for chunks in (1, 2, 3, 6):
        fold_cache().clear()
        monkeypatch.setenv("RTPU_FOLD_WORKERS", "1")
        g1, p1 = thb.HopBatchedPageRank(log, device="cpu").fold_payloads(
            HOPS, chunks=chunks)
        jg, jp = JPageRank(jlog).fold_payloads(HOPS, chunks=chunks)
        assert fold_cache().stats()["entries"] == 0
        monkeypatch.setenv("RTPU_FOLD_WORKERS", "3")
        hb = thb.HopBatchedPageRank(log, device="cpu")
        g3, p3 = hb.fold_payloads(HOPS, chunks=chunks)
        assert hb.fold_mode_seconds.keys() == {"serial"}
        n_units = {1: 3, 2: 2, 3: 3, 6: 6}[chunks]
        assert fold_cache().stats()["entries"] == n_units - (chunks == 6)
        seeded.clear()
        advanced.clear()
        hits = fold_cache().stats()["hits"]
        hb = thb.HopBatchedPageRank(log, device="cpu")
        g4, p4 = hb.fold_payloads(HOPS, chunks=chunks)
        assert len(seeded) == n_units
        assert fold_cache().stats()["hits"] == hits + n_units
        # each fork advances through its own hops and nothing else
        assert sorted(advanced) == HOPS
        assert hb.fold_mode_seconds.keys() == {"parallel"}
        assert hb.sw.t_prev == HOPS[-1] and hb._delta_base is None
        assert g1 == g3 == g4 == [list(g) for g in jg]
        for p in (p1, p3, p4):
            assert _equal(p, jp), f"chunks={chunks}"
            if route == "host":
                assert all(isinstance(x, Staged) for x in p)


@pytest.mark.parametrize("kind", ["pagerank", "cc", "bfs", "sssp"])
def test_run_under_every_mode_matches_serial(monkeypatch, kind):
    """``run`` with forked folds (3 workers, the checkpoints left by an
    earlier engine's sweeps) and with the prefetch alone (1 worker),
    against the serial loop (1 worker, no prefetch): CC, BFS and SSSP
    bitwise, PageRank within rtol 1e-5 / atol 1e-7 with equal steps. SSSP
    takes the prefetch lane at any worker count. A follow-on batch on the
    same engine (its adopted fork, its rebuilt base) matches a fresh
    engine."""
    monkeypatch.setenv("RTPU_FOLD_CACHE_MB", "16")
    fold_cache().clear()
    jlog = _log(31)
    log = _carried(jlog)

    def make():
        if kind == "pagerank":
            return thb.HopBatchedPageRank(log, tol=1e-7, max_steps=20,
                                          device="cpu")
        if kind == "cc":
            return thb.HopBatchedCC(log, max_steps=40, device="cpu")
        if kind == "bfs":
            return thb.HopBatchedBFS(log, (1, 2), max_steps=40,
                                     device="cpu")
        return thb.HopBatchedSSSP(log, (1, 2), "w", max_steps=40,
                                  device="cpu")

    def check(got, want):
        (g, gs), (w, ws) = got, want
        assert gs == ws
        if kind == "pagerank":
            np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=1e-5,
                                       atol=1e-7)
        else:
            assert torch.equal(g, w)

    windows = [300, None]
    modes = {"serial": ("1", "0"), "prefetch": ("1", "1"),
             "parallel": ("3", "1")}
    runs = {}
    for mode, (workers, prefetch) in modes.items():
        monkeypatch.setenv("RTPU_FOLD_WORKERS", workers)
        monkeypatch.setenv("RTPU_PREFETCH", prefetch)
        if mode == "parallel":   # the cold sweeps leave the checkpoints
            hb = make()
            hb.run(HOPS[:4], windows, chunks=2)
            hb.run(HOPS[4:], windows)
            assert hb.fold_mode_seconds.keys() == {"serial"}
        hb = make()
        out = []
        for hops, kw in ((HOPS[:4], dict(chunks=2)), (HOPS[4:], {})):
            out.append(hb.run(hops, windows, **kw))
            want_mode = "parallel" if (mode == "parallel"
                                       and kind != "sssp") else "serial"
            assert hb.fold_mode_seconds.keys() == {want_mode}
            assert hb.fold_seconds > 0
        runs[mode] = (hb, out)
    for mode in ("prefetch", "parallel"):
        for got, want in zip(runs[mode][1], runs["serial"][1]):
            check(got, want)
    check(runs["parallel"][1][1], make().run(HOPS[4:], windows))


def test_fold_workers_one_never_enters_the_parallel_fold(monkeypatch):
    """At one worker no sweep forks, even a repeat whose starts the cache
    would cover, and the serial lane leaves no checkpoint."""
    monkeypatch.setenv("RTPU_FOLD_WORKERS", "1")
    monkeypatch.setenv("RTPU_FOLD_CACHE_MB", "16")
    fold_cache().clear()
    assert fold_workers() == 1

    def boom(*a, **k):
        raise AssertionError("parallel fold entered at workers=1")

    monkeypatch.setattr(thb._HopBatched, "_fold_groups_parallel", boom)
    monkeypatch.setattr(DeviceSweep, "_run_sweep_parallel", boom)
    log = _carried(_log(4, n_events=400, n_ids=20, t_span=500))
    for _ in range(2):
        r, _ = thb.HopBatchedPageRank(log, tol=0.0, max_steps=5,
                                      device="cpu").run([200, 400], [None],
                                                        chunks=2)
        assert r.shape[0] == 2
        _, p = thb.HopBatchedCC(log, device="cpu").fold_payloads(
            [200, 400], 2)
        assert len(p) == 2
        got, _ = DeviceSweep(log, device="cpu").run_sweep(
            PageRank(max_steps=3, tol=0.0), [200, 300, 400], windows=[None])
        assert len(got) == 3
    assert fold_cache().stats()["entries"] == 0


def test_device_sweep_every_mode_matches_serial(monkeypatch):
    """``run_sweep`` on the lookahead lane (one worker; three, cold) and on
    forked segments (three workers, the cold sweep's checkpoints), against
    ``RTPU_PREFETCH=0``: every result bitwise, the clock and the builder
    adopted together, a backward sweep refused. Repeated hops (a
    segment's boundary among them) stay noops."""
    monkeypatch.setenv("RTPU_FOLD_CACHE_MB", "16")
    fold_cache().clear()
    log = _carried(_log(12, n_events=700, n_ids=30, t_span=900))
    pr = PageRank(max_steps=8, tol=0.0)
    hops = [150, 300, 300, 450, 600, 750]
    monkeypatch.setenv("RTPU_FOLD_WORKERS", "1")
    monkeypatch.setenv("RTPU_PREFETCH", "0")
    want, ws = DeviceSweep(log, device="cpu").run_sweep(
        pr, hops, windows=[200, None])
    monkeypatch.setenv("RTPU_PREFETCH", "1")
    for workers, mode in (("1", "serial"), ("3", "serial"),
                          ("3", "parallel")):
        monkeypatch.setenv("RTPU_FOLD_WORKERS", workers)
        ds = DeviceSweep(log, device="cpu")
        got, gs = ds.run_sweep(pr, hops, windows=[200, None])
        assert gs == ws and ds.fold_mode_seconds.keys() == {mode}
        for g, w in zip(got, want):
            assert all(torch.equal(a, b) for a, b in zip(
                torch.utils._pytree.tree_leaves(g),
                torch.utils._pytree.tree_leaves(w)))
        assert ds.t_now == 750 and ds.sw.t_prev == 750
        with pytest.raises(ValueError, match="ascend"):
            ds.run_sweep(pr, [100, 200], windows=[None])


def test_device_sweep_failed_parallel_sweep_recovers(monkeypatch):
    """A dispatch that fails mid-sweep under forked segments marks the
    sweep stale; the engine's clock and builder never moved, so the next
    sweep restages the full state and matches a fresh engine."""
    monkeypatch.setenv("RTPU_FOLD_WORKERS", "3")
    monkeypatch.setenv("RTPU_FOLD_CACHE_MB", "16")
    fold_cache().clear()
    log = _carried(_log(13, n_events=600, n_ids=30, t_span=900))
    pr = PageRank(max_steps=6, tol=0.0)
    # a cold sweep over the same hops leaves the segments' checkpoints
    DeviceSweep(log, device="cpu").run_sweep(pr, [150, 300, 450, 600],
                                             windows=[None])
    ds = DeviceSweep(log, device="cpu")
    real, calls = ds._dispatch, []

    def flaky(*a):
        calls.append(a[1])
        if len(calls) == 3:
            raise RuntimeError("injected")
        return real(*a)

    monkeypatch.setattr(ds, "_dispatch", flaky)
    with pytest.raises(RuntimeError, match="injected"):
        ds.run_sweep(pr, [150, 300, 450, 600], windows=[None])
    assert ds._stale and ds.t_now is None and ds.sw.t_prev is None
    assert "parallel" in ds.fold_mode_seconds
    got, _ = ds.run_sweep(pr, [450, 600], windows=[None])
    want, _ = DeviceSweep(log, device="cpu").run_sweep(pr, [450, 600],
                                                       windows=[None])
    assert all(torch.equal(g, w) for g, w in zip(got, want))


# ------------------------------------------------------------- prefetch


def test_prefetch_map_keeps_order_and_drains_on_a_raise():
    """Folds that finish in reverse order still reach the body in order,
    on the calling thread; a raising body returns only after every fold
    in flight has finished."""
    pool = ThreadPoolExecutor(max_workers=3)
    try:
        go = [threading.Event() for _ in range(3)]

        def fold(i):
            def f():
                if i < 2:   # fold i waits for fold i+1 to finish
                    assert go[i + 1].wait(5)
                go[i].set()
                return i, threading.get_ident()
            return f

        seen = []
        prefetch_map([fold(i) for i in range(3)],
                     lambda r, stall: seen.append((r[0], stall >= 0)),
                     depth=3, pool=pool)
        assert seen == [(0, True), (1, True), (2, True)]

        release, finished = threading.Event(), []

        def held(i):
            def f():
                if i:
                    assert release.wait(5)
                    finished.append(i)
                return i
            return f

        def body(r, stall):
            release.set()
            raise RuntimeError("boom")

        # fold 3 is submitted before the first body runs: 1-3 in flight
        with pytest.raises(RuntimeError, match="boom"):
            prefetch_map([held(i) for i in range(5)], body, depth=3,
                         pool=pool)
        assert sorted(finished) == [1, 2, 3]
    finally:
        pool.shutdown(wait=True)


def test_fold_pools_keyed_by_size(monkeypatch):
    monkeypatch.setenv("RTPU_FOLD_WORKERS", "2")
    two = cs.fold_pool()
    assert cs.fold_pool() is two and two._max_workers == 2
    monkeypatch.setenv("RTPU_FOLD_WORKERS", "3")
    assert cs.fold_pool()._max_workers == 3
    assert cs._vfold_pool()._max_workers == 3
    assert cs._prefetch_pool()._max_workers == 1
    assert len({id(cs.fold_pool()), id(cs._vfold_pool()),
                id(cs._prefetch_pool())}) == 3


# ---------------------------------------------------------- fold cache


def test_fold_cache_bound_and_eviction_under_concurrent_puts():
    """The byte bound holds at every moment under concurrent puts and
    lookups from more threads than cores (the interpreter's switch
    interval shortened), LRU entries evict, counted, with their times, and
    a checkpoint larger than the bound is refused."""
    cache = FoldCache(max_bytes=1 << 16)
    cfg = ("cfg",)

    def cp(t, n=512):   # 4 KiB at n=512
        return FoldCheckpoint(t, {"a": np.zeros(n, np.int64)}, cfg)

    assert not cache.put_checkpoint(("big",), cp(1, (1 << 13) + 1))
    errors = []

    def worker(w):
        try:
            for i in range(40):
                assert cache.put_checkpoint((w,), cp(i))
                cache.nearest_checkpoint((w,), cfg, (i * 7) % 40)
                assert cache.stats()["bytes"] <= cache.max_bytes
        except Exception as e:   # a thread's raise would be lost
            errors.append(e)

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=worker, args=(w,))
                   for w in range(12)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(30)
            assert not t.is_alive()
    finally:
        sys.setswitchinterval(interval)
    assert not errors
    st = cache.stats()
    assert st["bytes"] <= cache.max_bytes and st["evictions"] > 0
    assert st["entries"] == (1 << 16) // 4096
    assert st["hits"] + st["misses"] == 12 * 40
    assert sum(len(v) for v in cache._ckpt_times.values()) == st["entries"]


def test_nearest_checkpoint_and_a_fork_from_it():
    jlog = random_log(np.random.default_rng(2), n_events=300, n_ids=12,
                      t_span=50)
    sw = SweepBuilder(event_log_from_arrays(jlog.arrays()), track_rows=False)
    fp = log_fingerprint(sw.log)
    cache = FoldCache(max_bytes=1 << 24)
    for t in (10, 20, 30):
        f = sw.fork()
        f._advance(t)
        assert cache.put_checkpoint(fp, f.checkpoint())
    assert cache.nearest_checkpoint(fp, sw._config(), 5) is None
    assert cache.nearest_checkpoint(fp + (1,), sw._config(), 25) is None
    cp = cache.nearest_checkpoint(fp, sw._config(), 25)
    assert cp is not None and cp.t_prev == 20
    assert cache.nearest_checkpoint(fp, sw._config(), 99).t_prev == 30
    fork = sw.fork(cp)
    fork._advance(40)
    want = JSweepBuilder(jlog, track_rows=False)
    want._advance(40)
    for k in ("e_enc", "e_lat", "e_alive", "v_lat", "v_alive", "v_first"):
        np.testing.assert_array_equal(getattr(fork, k), getattr(want, k))
    # evicted checkpoints leave the index with their entries
    small = FoldCache(max_bytes=cp.nbytes)
    for t in (10, 20):
        f = sw.fork()
        f._advance(t)
        small.put_checkpoint(fp, f.checkpoint())
    assert small.nearest_checkpoint(fp, sw._config(), 15) is None
    assert small.nearest_checkpoint(fp, sw._config(), 25).t_prev == 20


@pytest.mark.parametrize("route", ["delta", "host"])
def test_cold_sweep_takes_the_serial_lane_and_leaves_checkpoints(
        monkeypatch, route):
    """At 2 workers a cold sweep never forks (a fork would fold its whole
    prefix again): it folds on the lookahead lane and leaves a checkpoint
    at each start its forks would have; the same sweep on a fresh engine
    then forks there, with the same result and the same hop callbacks.
    With the cache off, every sweep stays serial."""
    monkeypatch.setenv("RTPU_FOLD", route)
    monkeypatch.setenv("RTPU_FOLD_CACHE_MB", "32")
    monkeypatch.setenv("RTPU_FOLD_WORKERS", "2")
    fold_cache().clear()
    log = _carried(_log(6, n_events=800, n_ids=30))
    hops = [200, 400, 600, 800]

    def run_with_shells(hb):
        shells = {}

        def cb(T, sw):
            shells[int(T)] = (sw.v_lat.copy(), sw.v_alive.copy(),
                              sw.v_first.copy())
        r, s = hb.run(hops, [None], chunks=2, hop_callback=cb)
        return r, s, shells

    hb1 = thb.HopBatchedPageRank(log, tol=0.0, max_steps=6, device="cpu")
    r1, s1, sh1 = run_with_shells(hb1)
    assert hb1.fold_mode_seconds.keys() == {"serial"}
    fp, cfg = log_fingerprint(hb1.sw.log), hb1.sw._config()
    assert fold_cache().covers(fp, cfg, [200, 400])
    assert fold_cache().stats()["entries"] == 2
    hb2 = thb.HopBatchedPageRank(log, tol=0.0, max_steps=6, device="cpu")
    r2, s2, sh2 = run_with_shells(hb2)
    assert hb2.fold_mode_seconds.keys() == {"parallel"}
    assert hb2.ship_bytes == hb1.ship_bytes
    assert hb2.sw.t_prev == hops[-1]
    assert torch.equal(r1, r2) and s1 == s2
    assert sorted(sh1) == sorted(sh2) == hops
    for t in sh1:
        for a, b in zip(sh1[t], sh2[t]):
            np.testing.assert_array_equal(a, b)
    monkeypatch.setenv("RTPU_FOLD_CACHE_MB", "0")
    hb3 = thb.HopBatchedPageRank(log, tol=0.0, max_steps=6, device="cpu")
    r3, s3, _ = run_with_shells(hb3)
    assert hb3.fold_mode_seconds.keys() == {"serial"}
    assert torch.equal(r1, r3) and s1 == s3


def test_partly_covered_sweep_stays_serial(monkeypatch):
    """Checkpoints at some of a sweep's fork starts are not enough: a
    sweep over another hop grid of the same log takes the serial lane (and
    leaves its own starts), then forks on its repeat."""
    monkeypatch.setenv("RTPU_FOLD_CACHE_MB", "32")
    monkeypatch.setenv("RTPU_FOLD_WORKERS", "3")
    fold_cache().clear()
    log = _carried(_log(7, n_events=800, n_ids=30))

    def modes(hops):
        hb = thb.HopBatchedCC(log, max_steps=30, device="cpu")
        r, _ = hb.run(hops, [None], chunks=3)
        return set(hb.fold_mode_seconds), r

    assert modes(HOPS)[0] == {"serial"}            # starts 150, 300, 600
    assert modes(HOPS)[0] == {"parallel"}
    other = [150, 300, 450, 500, 700, 900]          # starts 150, 300, 500
    (cold, r_cold), (warm, r_warm) = modes(other), modes(other)
    assert (cold, warm) == ({"serial"}, {"parallel"})
    assert torch.equal(r_cold, r_warm)


def test_checkpoint_past_the_bound_is_never_copied(monkeypatch):
    """A state larger than the whole cache is neither copied nor put (the
    ``scale`` cell's fold state exceeds the default bound); a fork still
    advances to its start without it."""
    sw = SweepBuilder(_carried(_log(8)), track_rows=False)
    sw._advance(300)
    cache = FoldCache(max_bytes=sw.state_nbytes() - 1)

    def boom(self):
        raise AssertionError("a checkpoint past the bound was copied")

    monkeypatch.setattr(SweepBuilder, "checkpoint", boom)
    sw.save_checkpoint(cache)
    fork = sw.fork_at(600, cache)
    assert fork.t_prev == 600 and sw.t_prev == 300
    assert cache.stats()["entries"] == 0
    want = SweepBuilder(sw.log, track_rows=False)
    want._advance(600)
    for k in cs._STATE_COPIED:
        np.testing.assert_array_equal(getattr(fork, k), getattr(want, k))


def test_engine_reuse_after_a_forked_fold_stays_correct(monkeypatch):
    """A forked fold on a resident engine adopts its last fork and drops
    the running host base: a later batch on the same engine rebuilds it
    at the adopted clock and matches a fresh engine."""
    monkeypatch.setenv("RTPU_FOLD_CACHE_MB", "32")
    monkeypatch.setenv("RTPU_FOLD_WORKERS", "2")
    fold_cache().clear()
    log = _carried(_log(51, n_events=900, n_ids=35))

    def engine():
        hb = thb.HopBatchedCC(log, max_steps=30, device="cpu")
        hb.run([500, 600], [None])             # resident at 600
        return hb

    engine().run([700, 800, 900, 1000], [None])   # leaves start 800
    hb = engine()
    hb.run([700, 800, 900, 1000], [None])
    assert hb.fold_mode_seconds.keys() == {"parallel"}
    assert hb._dev_base is not None and hb._delta_base is None
    assert hb.sw.t_prev == 1000
    got, _ = hb.run([1050], [300, None])
    assert hb.fold_mode_seconds.keys() == {"serial"}
    monkeypatch.setenv("RTPU_FOLD_CACHE_MB", "0")
    want, _ = thb.HopBatchedCC(log, max_steps=30, device="cpu").run(
        [1050], [300, None])
    assert torch.equal(got, want)


def test_fold_cache_off_at_zero(monkeypatch):
    monkeypatch.setenv("RTPU_FOLD_CACHE_MB", "0")
    assert fold_cache() is None
    monkeypatch.setenv("RTPU_FOLD_CACHE_MB", "8")
    c = fold_cache()
    assert c.max_bytes == 8 << 20 and fold_cache() is c
    monkeypatch.delenv("RTPU_FOLD_CACHE_MB")
    assert fold_cache().max_bytes == 256 << 20


def test_log_fingerprint_content_addressed():
    a = event_log_from_arrays(_log(5).arrays())
    b = event_log_from_arrays(_log(5).arrays())
    c = event_log_from_arrays(_log(6).arrays())
    cols = _log(5).arrays()
    flip = event_log_from_arrays(dict(cols, src=cols["dst"],
                                      dst=cols["src"]))
    assert log_fingerprint(a.pin()) == log_fingerprint(b.pin())
    assert log_fingerprint(a.pin()) != log_fingerprint(c.pin())
    assert log_fingerprint(a.pin()) != log_fingerprint(flip.pin())


def test_repeated_range_job_hits_the_cache_and_matches_jax(monkeypatch):
    """A repeated Range job: the first folds on the serial lane and leaves
    its checkpoints, the second forks at them (cache hits), and both
    return the JAX package's rows."""
    monkeypatch.setenv("RTPU_FOLD_CACHE_MB", "64")
    monkeypatch.setenv("RTPU_FOLD_WORKERS", "2")
    monkeypatch.setenv("RTPU_BATCH_WINDOW_MS", "0")
    fold_cache().clear()
    jlog = ldbc_like_log(n_persons=300, n_knows=2_000, t_span=1_000)
    jprog = JCC(max_steps=60)
    q = dict(start=300, end=1_000, jump=100, windows=(1_000, 200))
    jmgr = JAnalysisManager(JTemporalGraph(jlog))
    jjob = jmgr.submit(jprog, JRangeQuery(**q))
    assert jjob.wait(300) and jjob.status == "done", jjob.error
    want = jmgr.results(jjob.id)
    mgr = AnalysisManager(TemporalGraph(_carried(jlog), device="cpu"),
                          device="cpu")
    prog = program_from_params("ConnectedComponents",
                               **dataclasses.asdict(jprog))
    rows, hits = [], [fold_cache().stats()["hits"]]
    for _ in range(2):
        job = mgr.submit(prog, RangeQuery(**q))
        assert job.wait(300) and job.status == "done", job.error
        rows.append(mgr.results(job.id))
        hits.append(fold_cache().stats()["hits"])
    assert hits[0] == hits[1] < hits[2]
    assert len(want) == 8 * 2
    for got in rows:
        assert len(got) == len(want)
        for g, w in zip(got, want):
            for k in ("time", "windowsize", "steps", "result"):
                assert g[k] == w[k], (k, g, w)
