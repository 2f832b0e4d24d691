"""The port's columnar CC, BFS and weighted SSSP engines against the JAX
package's on the same logs (carried across as numpy arrays and numeric
property rows): labels and distances BITWISE equal, superstep counts equal
(ROADMAP "Checked against the reference": min-combine results are exact).
Covers chunked sweeps (``chunks=4`` on 6 hops is the uneven split), the
device-resident advanced base across runs (SSSP's weight state included),
the epoch warm seed, stored NaN weights, the immutable-key refusal and the
LDBC-like generator."""

import numpy as np
import pytest
import torch
from test_sweep import random_log

from raphtory_tpu.engine import hopbatch as jhb
from raphtory_tpu.utils import synth as jsynth
from raphtory_tpu_torch.engine import hopbatch as thb
from raphtory_tpu_torch.interop import (event_log_from_arrays,
                                        numeric_prop_payloads)
from raphtory_tpu_torch.utils import synth

WINDOWS = [1000, 25, None]
SEEDS = (1, 2, 3, 9_999)   # 9_999 never occurs: ignored


@pytest.fixture(autouse=True)
def _unbinned_reference(monkeypatch):
    # the reference stays on the unbinned route at every size
    monkeypatch.setenv("RTPU_PCPM", "0")


def carried(jlog):
    return event_log_from_arrays(jlog.arrays(),
                                 props=numeric_prop_payloads(jlog.props))


def _log(seed):
    if seed == "ldbc":
        return jsynth.ldbc_like_log(n_persons=300, n_knows=3_000,
                                    t_span=10_000, weighted=True), \
            [5_000, 6_000, 7_000, 8_000, 9_000, 9_999], "weight"
    rng = np.random.default_rng(seed)
    return random_log(rng, n_events=800, n_ids=50, t_span=100,
                      props=True), [20, 40, 60, 80, 85, 99], "w"


def _engines(kind, jlog, directed=False):
    log = carried(jlog)
    if kind == "cc":
        return (jhb.HopBatchedCC(jlog, max_steps=60),
                thb.HopBatchedCC(log, max_steps=60, device="cpu"))
    if kind == "bfs":
        return (jhb.HopBatchedBFS(jlog, SEEDS, directed=directed,
                                  max_steps=40),
                thb.HopBatchedBFS(log, SEEDS, directed=directed,
                                  max_steps=40, device="cpu"))
    prop = "weight" if "weight" in jlog.props.keys else "w"
    return (jhb.HopBatchedSSSP(jlog, SEEDS, prop, directed=directed,
                               max_steps=40),
            thb.HopBatchedSSSP(log, SEEDS, prop, directed=directed,
                               max_steps=40, device="cpu"))


def _check(want, got):
    (w, ws), (g, gs) = want, got
    w = np.asarray(w)
    assert g.device.type == "cpu" and g.shape == w.shape
    assert g.dtype.itemsize == w.dtype.itemsize
    np.testing.assert_array_equal(g.numpy(), w)   # bitwise (no NaN)
    assert gs == int(ws)


@pytest.mark.parametrize("chunks", [1, 2, 3, 4])
@pytest.mark.parametrize("seed", [0, 1, "ldbc"])
def test_cc_matches_reference(seed, chunks):
    jlog, hops, _ = _log(seed)
    j, t = _engines("cc", jlog)
    _check(j.run(hops, WINDOWS, chunks=chunks),
           t.run(hops, WINDOWS, chunks=chunks))
    assert t.fold_seconds > 0 and t.ship_bytes > 0


@pytest.mark.parametrize("chunks", [1, 2, 3, 4])
@pytest.mark.parametrize("directed", [False, True])
@pytest.mark.parametrize("seed", [0, "ldbc"])
def test_bfs_matches_reference(seed, directed, chunks):
    jlog, hops, _ = _log(seed)
    j, t = _engines("bfs", jlog, directed)
    _check(j.run(hops, WINDOWS, chunks=chunks),
           t.run(hops, WINDOWS, chunks=chunks))


@pytest.mark.parametrize("chunks", [1, 2, 3, 4])
@pytest.mark.parametrize("directed", [False, True])
@pytest.mark.parametrize("seed", [2, "ldbc"])
def test_sssp_matches_reference(seed, directed, chunks):
    """Weighted: the per-hop weight deltas rebuilt on the device (K6w),
    zero weights included (random logs set ``w`` in 0..4)."""
    jlog, hops, _ = _log(seed)
    j, t = _engines("sssp", jlog, directed)
    want = j.run(hops, WINDOWS, chunks=chunks)
    got = t.run(hops, WINDOWS, chunks=chunks)
    _check(want, got)
    assert np.isfinite(got[0].numpy()).any()
    # the weights do change the answer against hop counting
    bfs, _ = _engines("bfs", jlog, directed)[1].run(hops, WINDOWS)
    assert not np.array_equal(bfs.numpy(), got[0].numpy())


@pytest.mark.parametrize("kind", ["cc", "bfs", "sssp"])
def test_resident_base_across_runs(kind, monkeypatch):
    """A second run() continues from the device-resident advanced base:
    every dispatch after the first ships deltas only (h0), SSSP's weight
    state riding along as the base's 5th entry."""
    seen = []
    real = thb.run_columns_delta

    def spy(*a, **kw):
        seen.append((kw["h0_delta"], kw.get("weight_base") is not None,
                     len(a[2])))
        return real(*a, **kw)

    monkeypatch.setattr(thb, "run_columns_delta", spy)
    jlog, hops, _ = _log("ldbc" if kind == "sssp" else 3)
    j, t = _engines(kind, jlog)
    _check(j.run(hops[:4], WINDOWS, chunks=2),
           t.run(hops[:4], WINDOWS, chunks=2))
    _check(j.run(hops[4:], WINDOWS), t.run(hops[4:], WINDOWS))
    assert [h0 for h0, _, _ in seen] == [False, True, True]
    assert all(w == (kind == "sssp") and nb == 4 for _, w, nb in seen)
    assert len(t._dev_base) == (5 if kind == "sssp" else 4)


@pytest.mark.parametrize("kind", ["cc", "bfs"])
def test_epoch_warm_state(kind):
    """``warm_state`` seeds the first dispatch with min(cold start, the
    previous run's output) — on an add-only log, as the live engine's gate
    requires, and equal to the JAX package's warm run bitwise."""
    jlog = jsynth.gab_like_log(400, 3_000, seed=4, t_span=600)
    windows = [None]
    j, t = _engines(kind, jlog)
    jw, tw = j.run([200, 300], windows), t.run([200, 300], windows)
    _check(jw, tw)
    j2, t2 = _engines(kind, jlog)
    want = j2.run([400, 500, 599], windows, warm_state=jw[0])
    got = t2.run([400, 500, 599], windows, warm_state=tw[0])
    _check(want, got)
    cold = _engines(kind, jlog)[1].run([400, 500, 599], windows)
    np.testing.assert_array_equal(got[0].numpy(), cold[0].numpy())


def test_sssp_ignores_warm_state():
    jlog, hops, _ = _log("ldbc")
    _, t = _engines("sssp", jlog)
    prev, _ = t.run(hops[:2], WINDOWS)
    _, t2 = _engines("sssp", jlog)
    _, t3 = _engines("sssp", jlog)
    np.testing.assert_array_equal(
        t2.run(hops[2:], WINDOWS, warm_state=prev)[0].numpy(),
        t3.run(hops[2:], WINDOWS)[0].numpy())


def test_sssp_stored_nan_weighs_one():
    """An explicitly stored NaN weight weighs 1.0, like a missing one."""
    from raphtory_tpu.core.events import EventLog as JEventLog

    jlog = JEventLog()
    jlog.append_batch(np.array([1, 2, 3]), np.array([2, 2, 2], np.uint8),
                      np.array([0, 1, 0]), np.array([1, 2, 2]),
                      props=[(0, {"weight": float("nan")}),
                             (1, {"weight": 2.0}), (2, {"weight": 7.5})])
    want = jhb.HopBatchedSSSP(jlog, (0,), "weight", directed=True,
                              max_steps=10).run([3], [None])
    got = thb.HopBatchedSSSP(carried(jlog), (0,), "weight", directed=True,
                             max_steps=10, device="cpu").run([3], [None])
    _check(want, got)
    np.testing.assert_array_equal(got[0].numpy()[0, :3], [0.0, 1.0, 3.0])


def test_sssp_refuses_immutable_key():
    from raphtory_tpu_torch.core.events import EventLog

    log = EventLog()
    log.append_batch(np.array([1, 2]), np.array([2, 2], np.uint8),
                     np.array([0, 1]), np.array([1, 2]),
                     props=[(0, {"!weight": 2.0}), (1, {"!weight": 3.0})])
    with pytest.raises(ValueError, match="immutable"):
        thb.HopBatchedSSSP(log, (0,), "weight", device="cpu")
    # a random log's "!kind" key is immutable in both packages
    jlog, _, _ = _log(0)
    with pytest.raises(ValueError, match="immutable"):
        thb.HopBatchedSSSP(carried(jlog), (0,), "kind", device="cpu")


def test_ldbc_like_log_matches_reference():
    """Same seed → the same events and property rows as the JAX
    generator."""
    kw = dict(n_persons=500, n_knows=4_000, t_span=50_000, weighted=True)
    want, got = jsynth.ldbc_like_log(**kw), synth.ldbc_like_log(**kw)
    for k, v in want.arrays().items():
        np.testing.assert_array_equal(got.arrays()[k], v, err_msg=k)
    for c in ("event", "key", "tag", "num"):
        np.testing.assert_array_equal(got.props.column(c),
                                      want.props.column(c), err_msg=c)
    assert got.props.keys == want.props.keys == ["weight"]
    assert numeric_prop_payloads(got.props) \
        == numeric_prop_payloads(want.props)
    unweighted = synth.ldbc_like_log(n_persons=50, n_knows=300)
    assert unweighted.props.n == 0
    kinds = unweighted.column("kind")
    assert (kinds == 3).sum() == 30   # 10 % deletes


@pytest.mark.parametrize("chunks", [1, 2, 4])
@pytest.mark.parametrize("kind", ["cc", "bfs", "sssp"])
@pytest.mark.parametrize("seed", [0, "ldbc"])
def test_host_route_matches_reference(seed, kind, chunks, monkeypatch):
    """``RTPU_FOLD=host`` on both sides: the host-built ``[H, m_pad]`` fold
    columns (SSSP's weight columns too) through K3's twin and K5 / K6,
    bitwise with equal steps; the dispatches ship the columns."""
    monkeypatch.setenv("RTPU_FOLD", "host")
    jlog, hops, _ = _log(seed)
    j, t = _engines(kind, jlog)
    _check(j.run(hops, WINDOWS, chunks=chunks),
           t.run(hops, WINDOWS, chunks=chunks))
    tb = t.tables
    cols = len(hops) * (tb.m_pad + tb.n_pad) * (
        np.dtype(tb.tdtype).itemsize + 1)
    weights = len(hops) * tb.m_pad * 4 if kind == "sssp" else 0
    assert t.ship_bytes == cols + weights
    assert t.host_column_bytes(len(hops)) == cols + weights


def _engine(kind, log):
    if kind == "pagerank":
        return thb.HopBatchedPageRank(log, tol=0.0, max_steps=8,
                                      device="cpu")
    if kind == "cc":
        return thb.HopBatchedCC(log, max_steps=30, device="cpu")
    if kind == "bfs":
        return thb.HopBatchedBFS(log, (1, 2), max_steps=30, device="cpu")
    return thb.HopBatchedSSSP(log, (1, 2), "w", max_steps=30, device="cpu")


@pytest.mark.parametrize("chunks", [1, 2])
@pytest.mark.parametrize("kind", ["pagerank", "cc", "bfs", "sssp"])
def test_host_route_matches_delta_route(kind, chunks, monkeypatch):
    """Port of the reference's ``test_delta_fold_matches_host_columns``:
    the device-rebuilt masks (K1, base + per-hop deltas) and the host-built
    columns (K3) are the same masks, deletes and revivals included — so
    every engine's two routes agree BITWISE with equal steps."""
    log = carried(random_log(np.random.default_rng(11), n_events=900,
                             n_ids=40, t_span=1000, props=True))
    hops = [300, 500, 700, 900]
    windows = [250, None]
    monkeypatch.setenv("RTPU_FOLD", "host")
    host, s1 = _engine(kind, log).run(hops, windows, chunks=chunks)
    monkeypatch.setenv("RTPU_FOLD", "delta")
    delta, s2 = _engine(kind, log).run(hops, windows, chunks=chunks)
    assert torch.equal(host, delta) and s1 == s2


@pytest.mark.parametrize("kind", ["cc", "bfs"])
def test_host_route_ignores_the_epoch_warm_seed(kind, monkeypatch):
    """The min-merge epoch seed rides the delta route only (the reference's
    host-column route has no warm plumbing): on ``RTPU_FOLD=host`` a
    ``warm_state`` changes nothing."""
    jlog = jsynth.gab_like_log(400, 3_000, seed=4, t_span=600)
    monkeypatch.setenv("RTPU_FOLD", "host")
    prev, _ = _engines(kind, jlog)[1].run([200, 300], [None])
    got = _engines(kind, jlog)[1].run([400, 599], [None], warm_state=prev)
    cold = _engines(kind, jlog)[1].run([400, 599], [None])
    assert torch.equal(got[0], cold[0]) and got[1] == cold[1]


# ------------------------------------------- the destination-binned route

def _binned(monkeypatch, P, fold="delta"):
    """Both packages on the binned route: ``RTPU_PCPM=1``, ``P``
    partitions (None: the budget's auto sizing), the fold route."""
    monkeypatch.setenv("RTPU_PCPM", "1")
    monkeypatch.setenv("RTPU_FOLD", fold)
    if P is None:
        monkeypatch.delenv("RTPU_PARTITIONS", raising=False)
    else:
        monkeypatch.setenv("RTPU_PARTITIONS", str(P))


@pytest.mark.parametrize("fold", ["delta", "host"])
@pytest.mark.parametrize("P", [1, 2, 7, None])
@pytest.mark.parametrize("kind", ["cc", "bfs", "sssp"])
def test_binned_route_matches_reference(kind, P, fold, monkeypatch):
    """Binned CC / BFS / weighted SSSP bitwise equal to the JAX package's
    binned run, steps equal, over adversarial delete/tombstone logs; the
    layout the port resolved is the reference's."""
    _binned(monkeypatch, P, fold)
    jlog, hops, _ = _log(0 if kind != "sssp" else 2)
    j, t = _engines(kind, jlog)
    _check(j.run(hops, WINDOWS), t.run(hops, WINDOWS))
    assert t._active_layout is not None
    assert tuple(t._active_layout.spec) == tuple(j._active_layout.spec)


@pytest.mark.parametrize("kind", ["cc", "bfs", "sssp"])
def test_binned_chunked_resident_batches(kind, monkeypatch):
    """Chunked sweeps and a follow-on forward batch keep the device-resident
    advanced base BINNED across dispatches (SSSP's weight state too)."""
    _binned(monkeypatch, 5)
    jlog, hops, _ = _log("ldbc")
    j, t = _engines(kind, jlog, directed=kind == "bfs")
    _check(j.run(hops[:4], WINDOWS, chunks=2),
           t.run(hops[:4], WINDOWS, chunks=2))
    assert t._dev_base is not None and t._dev_base_spec is not None
    assert t._dev_base[0].shape[0] == t._active_layout.B
    _check(j.run(hops[4:], WINDOWS), t.run(hops[4:], WINDOWS))


def test_knob_flip_between_batches_drops_residency(monkeypatch):
    """A resident base built in one layout must not receive the other
    layout's catch-up delta (``tests/test_partition.py:207``): flipping
    ``RTPU_PCPM`` between forward batches re-ships a fresh base and stays
    right, in both flip directions."""
    jlog = random_log(np.random.default_rng(13), n_events=700, n_ids=45,
                      t_span=100)
    log = carried(jlog)
    monkeypatch.setenv("RTPU_PCPM", "0")
    ref = jhb.HopBatchedCC(jlog, max_steps=60)
    w1 = np.asarray(ref.run([30, 50], [60])[0])
    w2 = np.asarray(ref.run([70, 99], [60])[0])

    monkeypatch.setenv("RTPU_PCPM", "1")
    monkeypatch.setenv("RTPU_PARTITIONS", "4")
    hb = thb.HopBatchedCC(log, max_steps=60, device="cpu")
    g1 = hb.run([30, 50], [60])[0]
    assert hb._dev_base_spec is not None
    monkeypatch.setenv("RTPU_PCPM", "0")        # flip: binned → engine
    g2 = hb.run([70, 99], [60])[0]
    assert hb._dev_base_spec is None and hb._active_layout is None
    np.testing.assert_array_equal(g1.numpy(), w1)
    np.testing.assert_array_equal(g2.numpy(), w2)

    hb2 = thb.HopBatchedCC(log, max_steps=60, device="cpu")
    h1 = hb2.run([30, 50], [60])[0]
    monkeypatch.setenv("RTPU_PCPM", "1")        # flip: engine → binned
    h2 = hb2.run([70, 99], [60])[0]
    assert hb2._dev_base_spec is not None
    np.testing.assert_array_equal(h1.numpy(), w1)
    np.testing.assert_array_equal(h2.numpy(), w2)


def test_knob_flip_never_scatters_across_layouts(monkeypatch):
    """The guard is what keeps the flip right: with the drop disabled the
    second batch's binned catch-up would land on the engine-order base."""
    jlog = random_log(np.random.default_rng(13), n_events=700, n_ids=45,
                      t_span=100)
    monkeypatch.setenv("RTPU_PCPM", "0")
    hb = thb.HopBatchedCC(carried(jlog), max_steps=60, device="cpu")
    hb.run([30, 50], [60])
    base = hb._dev_base
    monkeypatch.setenv("RTPU_PCPM", "1")
    hb._sync_layout()
    assert hb._dev_base is None and base is not None
    assert hb.device_mask_bytes(1) == hb._active_layout.B + hb.tables.n_pad
