"""The port's ``DeviceSweep`` against the JAX package's, hop for hop, on the
same logs (carried across as numpy arrays) — mirroring
``tests/test_device_sweep.py``. Both run in the same global dense space,
so results compare row for row: the six resident fold-state buffers
bitwise after every hop (int32 and int64 times), ConnectedComponents
labels and DegreeBasic degrees bitwise, PageRank within rtol 1e-5 /
atol 1e-7, superstep counts equal (PageRank: see
``test_torch_bsp.assert_pagerank_steps``). Covers ascending hops with
repeats, deletes, the full-refresh first hop, a forced multi-chunk delta
(small chunk capacities), recovery after a failed delta apply, and
``supported()`` rejection."""

import numpy as np
import pytest
import torch
from test_sweep import random_log
from test_torch_bsp import assert_pagerank_steps, assert_results_match

from raphtory_tpu.algorithms import SSSP as JSSSP
from raphtory_tpu.algorithms import ConnectedComponents as JCC
from raphtory_tpu.algorithms import DegreeBasic as JDegree
from raphtory_tpu.algorithms import PageRank as JPageRank
from raphtory_tpu.core.events import EventLog as JEventLog
from raphtory_tpu.engine import device_sweep as jds
from raphtory_tpu_torch.engine import device_sweep as tds
from raphtory_tpu_torch.interop import event_log_from_arrays, \
    program_from_params

HOPS = [10, 35, 35, 36, 60, 79, 99]


@pytest.fixture(autouse=True)
def _serial_reference(monkeypatch):
    # the reference's serial sweep: no prefetch worker
    monkeypatch.setenv("RTPU_PREFETCH", "0")


def _port(jprog):
    import dataclasses

    return program_from_params(type(jprog).__name__,
                               **dataclasses.asdict(jprog))


def _pair(jlog):
    return (jds.DeviceSweep(jlog),
            tds.DeviceSweep(event_log_from_arrays(jlog.arrays()),
                            device="cpu"))


def _same_buffers(jsw, tsw):
    for g, w in zip(tsw._bufs, jsw._bufs):
        w = np.asarray(w)
        assert g.numpy().dtype == w.dtype
        np.testing.assert_array_equal(g.numpy(), w)


def _check_run(jsw, tsw, jprog, T, **kw):
    want, wsteps = jsw.run(jprog, T, **kw)
    got, gsteps = tsw.run(_port(jprog), T, **kw)
    _same_buffers(jsw, tsw)
    if isinstance(jprog, JPageRank):
        log = tsw.sw.log
        jlog = jsw.sw.log
        import dataclasses

        def fresh(k, port):
            p = dataclasses.replace(jprog, max_steps=k, tol=0.0)
            if port:
                return tds.DeviceSweep(log, device="cpu").run(
                    _port(p), T, **kw)[0]
            return jds.DeviceSweep(jlog).run(p, T, **kw)[0]

        assert_pagerank_steps(gsteps, wsteps, lambda k: fresh(k, True),
                              lambda k: fresh(k, False), jprog.tol)
    else:
        assert gsteps == int(wsteps), (T, gsteps, int(wsteps))
    assert_results_match(got, want, isinstance(jprog, JPageRank))


@pytest.mark.parametrize("seed", [0, 3, 8])
def test_pagerank_matches_reference_sweep(seed):
    jlog = random_log(np.random.default_rng(seed), n_events=600, n_ids=40,
                      t_span=80)
    jsw, tsw = _pair(jlog)
    for T in HOPS:
        _check_run(jsw, tsw, JPageRank(max_steps=20, tol=1e-7), T,
                   windows=[100, 30, 7])


@pytest.mark.parametrize("seed", [1, 5])
def test_degree_cc_bfs_match_reference_sweep(seed):
    jlog = random_log(np.random.default_rng(seed), n_events=500, n_ids=30,
                      t_span=60)
    jsw, tsw = _pair(jlog)
    for T in [12, 30, 30, 59]:
        _check_run(jsw, tsw, JDegree(), T)
        _check_run(jsw, tsw, JCC(max_steps=50), T, window=25)
        _check_run(jsw, tsw, JSSSP(seeds=(1, 2), directed=False,
                                   max_steps=40), T, windows=[60, 10])


def test_first_hop_is_a_full_refresh_then_deltas():
    jlog = random_log(np.random.default_rng(2), n_events=600, n_ids=40,
                      t_span=80)
    _, tsw = _pair(jlog)
    kinds = []
    for T in (70, 72, 72, 79):
        payload = tsw._fold_hop_inner(T)
        kinds.append(payload["kind"])
        tsw._apply_staged(payload)
    assert kinds[0] == "full" and kinds[2] == "noop"
    assert "chunks" in kinds[1:] and tsw.ship_bytes > 0


def test_multi_chunk_delta_application():
    """Shrunken chunk capacities force several chunks on both the vertex
    and the edge side: buffers still match the reference's bitwise."""
    jlog = random_log(np.random.default_rng(9), n_events=800, n_ids=60,
                      t_span=100)
    jsw, tsw = _pair(jlog)
    jsw.cap_v, jsw.cap_e = tsw.cap_v, tsw.cap_e = 8, 16
    seen = []
    for T in [20, 21, 50, 99]:
        payload = tsw._fold_hop_inner(T)
        seen.append(len(payload.get("chunks", ())))
        tsw._apply_staged(payload)
        jsw.advance(T)
        _same_buffers(jsw, tsw)
        _check_run(jsw, tsw, JPageRank(max_steps=10, tol=1e-7), T,
                   windows=[200, 40])
    assert max(seen) >= 2


def test_failed_apply_recovers_through_a_full_refresh(monkeypatch):
    jlog = random_log(np.random.default_rng(4), n_events=500, n_ids=30,
                      t_span=80)
    jsw, tsw = _pair(jlog)
    tsw.run(_port(JCC(max_steps=50)), 40)

    def boom(bufs, chunk):
        raise RuntimeError("injected")

    with monkeypatch.context() as mp:
        mp.setattr(tds, "apply_delta_chunk", boom)
        with pytest.raises(RuntimeError, match="injected"):
            tsw.advance(43)   # a small delta: chunks, through K9a
    assert tsw._stale
    for T in (60, 79):   # the next fold restages the full state
        _check_run(jsw, tsw, JCC(max_steps=50), T)


def test_apply_chunk_and_refresh_full_match_reference():
    """The direct one-chunk apply and the forced full refresh, against
    the reference's methods of the same names."""
    jlog = random_log(np.random.default_rng(7), n_events=400, n_ids=30,
                      t_span=80)
    jsw, tsw = _pair(jlog)
    for ds in (jsw, tsw):
        ds.advance(50)
    rows = (np.array([0, 3], np.int64), np.array([60, 61], np.int64),
            np.array([True, False]), np.array([1, 2], np.int64),
            np.array([0], np.int64), np.array([62], np.int64),
            np.array([True]), np.array([5], np.int64))
    for ds in (jsw, tsw):
        ds._apply_chunk(*rows)
    _same_buffers(jsw, tsw)
    for ds in (jsw, tsw):
        ds._refresh_full()      # back to the host fold's state at 50
    _same_buffers(jsw, tsw)
    assert tsw._bufs[0][3].item() != 61


def test_run_sweep_matches_the_run_loop():
    jlog = random_log(np.random.default_rng(6), n_events=500, n_ids=30,
                      t_span=80)
    log = event_log_from_arrays(jlog.arrays())
    prog = _port(JPageRank(max_steps=15, tol=1e-7))
    res, steps = tds.DeviceSweep(log, device="cpu").run_sweep(
        prog, [20, 40, 60, 79], windows=[100, 10])
    ds = tds.DeviceSweep(log, device="cpu")
    for T, r, s in zip([20, 40, 60, 79], res, steps):
        want, ws = ds.run(prog, T, windows=[100, 10])
        assert s == ws and torch.equal(r, want)
    with pytest.raises(ValueError, match="ascend"):
        ds.run_sweep(prog, [80, 70])


def test_unsupported_program_raises():
    jlog = random_log(np.random.default_rng(2), n_events=100)
    _, tsw = _pair(jlog)
    sssp = _port(JSSSP(seeds=(0,), weight_prop="weight"))
    assert not tds.supported(sssp)
    assert tds.supported(_port(JCC()))
    with pytest.raises(ValueError, match="properties"):
        tsw.run(sssp, 10)


def test_times_must_ascend_and_repeat_ok():
    jlog = random_log(np.random.default_rng(4), n_events=200)
    _, tsw = _pair(jlog)
    pr = _port(JPageRank(max_steps=5))
    tsw.run(pr, 20)
    tsw.run(pr, 20)  # same time: no-op advance
    with pytest.raises(ValueError, match="ascend"):
        tsw.advance(10)


def test_wide_timestamps_use_the_int64_path():
    base = 3_000_000_000  # > int32 max
    jlog = JEventLog()
    jlog.add_edge(base + 10, 1, 2)
    jlog.add_edge(base + 20, 2, 3)
    jlog.add_edge(base + 500, 3, 1)
    jlog.delete_edge(base + 600, 2, 3)
    jsw, tsw = _pair(jlog)
    assert tsw.tdtype == np.int64 and tsw._bufs[0].dtype == torch.int64
    for T in (base + 15, base + 550, base + 700):
        _check_run(jsw, tsw, JPageRank(max_steps=10, tol=1e-8), T,
                   windows=[1000, 8])
        _check_run(jsw, tsw, JSSSP(seeds=(1,), max_steps=10), T)


def test_empty_log_and_pre_history_time():
    jlog = JEventLog()
    jlog.add_edge(100, 1, 2)
    jsw, tsw = _pair(jlog)
    got, _ = tsw.run(_port(JPageRank(max_steps=5)), 5)  # before any event
    assert float(got.sum()) == pytest.approx(0.0)
    got, _ = tsw.run(_port(JPageRank(max_steps=5)), 150)
    assert float(got.sum()) == pytest.approx(1.0, abs=1e-4)
