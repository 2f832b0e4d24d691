"""The port's ``HopBatchedPageRank`` against the JAX package's on the same
logs (carried across as numpy arrays): chunked pipelining, the uneven-chunk
fallback, warm start, the device-resident advanced base across runs, and
the refusal of a backward sweep. Tolerances are the reference's own:
rtol 1e-5 / atol 1e-7 cold (``tests/test_hopbatch.py:145``), atol 1e-6 warm
(``:187``) — f32 sums in another order; superstep counts are equal."""

import numpy as np
import pytest
from test_sweep import random_log

from raphtory_tpu.engine.hopbatch import HopBatchedPageRank as JHopBatched
from raphtory_tpu.utils.synth import gab_like_log
from raphtory_tpu_torch.engine.hopbatch import HopBatchedPageRank
from raphtory_tpu_torch.interop import event_log_from_arrays


@pytest.fixture(autouse=True)
def _unbinned_reference(monkeypatch):
    # the reference stays on the unbinned route at every size
    monkeypatch.setenv("RTPU_PCPM", "0")


def _log(seed):
    if seed == "gab":
        return gab_like_log(800, 8_000, t_span=600), \
            [150, 250, 350, 450, 500, 599]
    rng = np.random.default_rng(seed)
    return random_log(rng, n_events=800, n_ids=50, t_span=100), \
        [20, 40, 60, 80, 85, 99]


def _both(jlog, tol=1e-7, max_steps=20):
    return (JHopBatched(jlog, tol=tol, max_steps=max_steps),
            HopBatchedPageRank(event_log_from_arrays(jlog.arrays()), tol=tol,
                               max_steps=max_steps, device="cpu"))


def _check(want, got, warm):
    (w, ws), (g, gs) = want, got
    w = np.asarray(w)
    assert g.shape == w.shape and g.device.type == "cpu"
    if warm:
        np.testing.assert_allclose(g.numpy(), w, atol=1e-6, rtol=0)
    else:
        np.testing.assert_allclose(g.numpy(), w, rtol=1e-5, atol=1e-7)
    assert gs == int(ws)


@pytest.mark.parametrize("warm", [False, True])
@pytest.mark.parametrize("chunks", [1, 2, 3, 4])
@pytest.mark.parametrize("seed", [0, 1, "gab"])
def test_hopbatch_matches_reference(seed, chunks, warm):
    """chunks=4 on 6 hops is the uneven split: one cold dispatch."""
    jlog, hops = _log(seed)
    windows = [1000, 25, None]
    j, t = _both(jlog)
    _check(j.run(hops, windows, chunks=chunks, warm_start=warm),
           t.run(hops, windows, chunks=chunks, warm_start=warm),
           warm and chunks in (2, 3))
    assert t.fold_seconds > 0 and t.ship_bytes > 0


@pytest.mark.parametrize("seed", [2, "gab"])
def test_hopbatch_resident_base_across_runs(seed, monkeypatch):
    """A second run() on the same engine continues from the device-resident
    advanced base: every dispatch after the first ships deltas only (h0 —
    delta[0] is the catch-up onto the resident state)."""
    from raphtory_tpu_torch.engine import hopbatch as thb

    h0s = []
    real = thb.run_columns_delta

    def spy(*a, **kw):
        h0s.append(kw["h0_delta"])
        return real(*a, **kw)

    monkeypatch.setattr(thb, "run_columns_delta", spy)
    jlog, hops = _log(seed)
    windows = [1000, 30]
    j, t = _both(jlog)
    _check(j.run(hops[:3], windows, chunks=3, warm_start=True),
           t.run(hops[:3], windows, chunks=3, warm_start=True), True)
    _check(j.run(hops[3:], windows), t.run(hops[3:], windows), False)
    assert h0s == [False, True, True, True]


def test_hopbatch_refuses_descending_and_backward_hops():
    jlog, _ = _log(0)
    _, t = _both(jlog)
    with pytest.raises(ValueError, match="ascend"):
        t.run([40, 20], [10])
    t.run([50, 60], [10])
    with pytest.raises(ValueError, match="continue forward"):
        t.run([30, 70], [10])


def test_pagerank_program_functions_match_reference():
    """The port's PageRank vertex program (init/message/update/finalize),
    driven by a plain superstep loop over the port's own view, against the
    JAX package's generic engine on the same view — and the columnar
    engine's one-hop, unwindowed column against both."""
    import torch

    from raphtory_tpu.algorithms import PageRank as JPageRank
    from raphtory_tpu.core.snapshot import build_view as j_build_view
    from raphtory_tpu.engine import bsp
    from raphtory_tpu_torch.core.snapshot import build_view
    from raphtory_tpu_torch.engine.program import Context, Edges
    from raphtory_tpu_torch.interop import program_from_params

    jlog, _ = _log(4)
    T = 70
    want, want_steps = bsp.run(JPageRank(tol=1e-7, max_steps=30),
                               j_build_view(jlog, T))
    log = event_log_from_arrays(jlog.arrays())
    v = build_view(log, T)
    prog = program_from_params("PageRank", tol=1e-7, max_steps=30)
    e_src = torch.from_numpy(v.e_src).long()
    e_dst = torch.from_numpy(v.e_dst).long()
    e_mask = torch.from_numpy(v.e_mask)
    out_deg = torch.zeros(v.n_pad, dtype=torch.int32).index_add_(
        0, e_src, e_mask.to(torch.int32))
    ctx = Context(n=v.n_pad, time=T, window=-1,
                  v_mask=torch.from_numpy(v.v_mask),
                  vids=torch.from_numpy(v.vids),
                  v_latest_time=torch.from_numpy(v.v_latest_time),
                  v_first_time=torch.from_numpy(v.v_first_time),
                  out_deg=out_deg, in_deg=out_deg,
                  n_active=torch.tensor(v.n_active, dtype=torch.int32))
    edges = Edges(src=e_src, dst=e_dst, mask=e_mask,
                  time=torch.from_numpy(v.e_latest_time),
                  first_time=torch.from_numpy(v.e_first_time))
    state, steps = prog.init(ctx), 0
    while steps < prog.max_steps:
        payload = prog.message({k: x[e_src] for k, x in state.items()},
                               edges)
        agg = torch.zeros(v.n_pad).index_add_(
            0, e_dst, torch.where(e_mask, payload, 0.0))
        state, votes = prog.update(state, agg, ctx)
        steps += 1
        if bool((votes | ~ctx.v_mask).all()):
            break
    got = prog.finalize(state, ctx).numpy()
    np.testing.assert_allclose(got, np.asarray(want), rtol=1e-5, atol=1e-7)
    assert steps == int(want_steps)

    ranks, _ = HopBatchedPageRank(log, tol=1e-7, max_steps=30,
                                  device="cpu").run([T], [None])
    uv = np.asarray(v.vids[: v.n_active])
    dense = np.searchsorted(
        HopBatchedPageRank(log, device="cpu").tables.uv, uv)
    np.testing.assert_allclose(ranks[0].numpy()[dense], got[: v.n_active],
                               rtol=1e-5, atol=1e-7)
    reduced = prog.reduce(got, v)
    assert abs(reduced["sum"] - 1.0) < 1e-4 and reduced["top10"]
