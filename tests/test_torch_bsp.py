"""The port's generic superstep engine (``engine/bsp.run``, the cold View
route) against ``raphtory_tpu.engine.bsp.run`` on ``build_view`` of the
same random logs (carried across as numpy arrays and numeric property
rows): PageRank, ConnectedComponents, BFS directed and undirected,
weighted SSSP and DegreeBasic, each on a plain, a ``window=`` and a
``windows=[w0 > w1 > w2]`` query. Equal superstep counts always; labels,
distances and degrees bitwise; PageRank within rtol 1e-5 / atol 1e-7.
Batched windows equal single-window runs, as the reference's own
``test_pagerank_batched_windows_match_single`` pins for it.

PageRank's step count halts on ``|r_s - r_{s-1}| < tol`` in float32, and
XLA reassociates the reference's update (it scatter-adds the messages into
a buffer holding ``dangling / n`` instead of adding the two afterwards), so
its ranks differ from any other summation order by an ulp or two. Where the
two engines' counts differ, ``assert_pagerank_steps`` requires that the
slower engine's largest change at the faster one's last superstep lies
within 8 ulps above ``tol`` — the halting test sat on float noise — and
fails otherwise."""

import dataclasses

import jax
import numpy as np
import pytest
import torch
from test_sweep import random_log

from raphtory_tpu.algorithms import SSSP as JSSSP
from raphtory_tpu.algorithms import ConnectedComponents as JCC
from raphtory_tpu.algorithms import DegreeBasic as JDegree
from raphtory_tpu.algorithms import PageRank as JPageRank
from raphtory_tpu.core.snapshot import build_view as jbuild_view
from raphtory_tpu.engine import bsp as jbsp
from raphtory_tpu_torch.core.snapshot import build_view
from raphtory_tpu_torch.engine import bsp
from raphtory_tpu_torch.interop import (event_log_from_arrays,
                                        numeric_prop_payloads,
                                        program_from_params)

PROGRAMS = {
    "pagerank": JPageRank(max_steps=30, tol=1e-7),
    "cc": JCC(max_steps=60),
    "bfs_directed": JSSSP(seeds=(1, 2, 3, 99), directed=True, max_steps=40),
    "bfs_undirected": JSSSP(seeds=(1, 2, 3), directed=False, max_steps=40),
    "sssp_weighted": JSSSP(seeds=(0, 4), weight_prop="w", directed=False,
                           max_steps=40),
    "degree": JDegree(),
}
QUERIES = {"plain": {}, "window": {"window": 30},
           "windows": {"windows": [100, 30, 7]}}


@pytest.fixture(autouse=True)
def _unbinned_reference(monkeypatch):
    monkeypatch.setenv("RTPU_PCPM", "0")


def _logs(seed):
    jlog = random_log(np.random.default_rng(seed), n_events=700, n_ids=45,
                      t_span=100, props=True)
    return jlog, event_log_from_arrays(
        jlog.arrays(), props=numeric_prop_payloads(jlog.props))


def port_program(jprog):
    return program_from_params(type(jprog).__name__,
                               **dataclasses.asdict(jprog))


def leaves(tree):
    """Result leaves in key order, as numpy."""
    if isinstance(tree, dict):
        return [leaves(tree[k])[0] for k in sorted(tree)]
    return [np.asarray(tree.numpy() if isinstance(tree, torch.Tensor)
                       else tree)]


def assert_results_match(got, want, float_tol: bool):
    g_leaves, w_leaves = leaves(got), [np.asarray(x) for x in (
        [want[k] for k in sorted(want)] if isinstance(want, dict)
        else jax.tree_util.tree_leaves(want))]
    assert len(g_leaves) == len(w_leaves)
    for g, w in zip(g_leaves, w_leaves):
        assert g.shape == w.shape and g.dtype == w.dtype, (g.dtype, w.dtype)
        if float_tol:
            np.testing.assert_allclose(g, w, rtol=1e-5, atol=1e-7)
        else:
            np.testing.assert_array_equal(g, w)


def _max_delta(run, s):
    """Largest rank change of superstep ``s`` of ``run(max_steps)`` (tol 0:
    every superstep runs)."""
    a, b = (np.stack([np.asarray(x) for x in leaves(run(k))])
            for k in (s - 1, s))
    return float(np.abs(b - a).max()), float(np.abs(b).max())


def assert_pagerank_steps(gsteps, wsteps, run_port, run_ref, tol):
    """Equal steps, or a halting test on float noise (module docstring):
    ``run_port``/``run_ref`` map a step count to that engine's result with
    ``tol = 0``."""
    if gsteps == int(wsteps):
        return
    s = min(gsteps, int(wsteps))
    slower = run_port if gsteps > s else run_ref
    delta, top = _max_delta(slower, s)
    assert tol <= delta < tol + 8 * np.spacing(np.float32(top)), (
        gsteps, int(wsteps), delta)


@pytest.mark.parametrize("query", sorted(QUERIES))
@pytest.mark.parametrize("name", sorted(PROGRAMS))
@pytest.mark.parametrize("seed", [0, 3])
def test_bsp_run_matches_reference(seed, name, query):
    jlog, log = _logs(seed)
    jprog = PROGRAMS[name]
    prog = port_program(jprog)
    for T in (40, 99):
        want, wsteps = jbsp.run(jprog, jbuild_view(jlog, T),
                                **QUERIES[query])
        got, gsteps = bsp.run(prog, build_view(log, T), device="cpu",
                              **QUERIES[query])
        if name == "pagerank":
            def at(steps, mod, run, view, **kw):
                p = dataclasses.replace(jprog, max_steps=steps, tol=0.0)
                return run(p if mod is None else port_program(p), view,
                           **kw, **QUERIES[query])[0]

            assert_pagerank_steps(
                gsteps, wsteps,
                lambda k: at(k, 1, bsp.run, build_view(log, T),
                             device="cpu"),
                lambda k: at(k, None, jbsp.run, jbuild_view(jlog, T)),
                jprog.tol)
        else:
            assert gsteps == int(wsteps), (T, gsteps, int(wsteps))
        assert_results_match(got, want, name == "pagerank")
    if name != "degree":
        assert gsteps > 0


@pytest.mark.parametrize("name", ["pagerank", "cc"])
def test_batched_windows_match_single(name):
    """The flat k-window layout gives each window the result of its own
    one-window run (bsp.py:107-111); duplicate windows agree exactly."""
    jlog, log = _logs(11)
    view = build_view(log, 95)
    windows = [100, 40, 40, 10]
    prog = (port_program(JPageRank(max_steps=30, tol=0.0))
            if name == "pagerank" else port_program(JCC(max_steps=60)))
    batched, _ = bsp.run(prog, view, windows=windows, device="cpu")
    for i, w in enumerate(windows):
        single, _ = bsp.run(prog, view, window=w, device="cpu")
        if name == "pagerank":
            np.testing.assert_allclose(batched[i].numpy(), single.numpy(),
                                       atol=1e-6, err_msg=f"window {w}")
            np.testing.assert_allclose(batched[i].sum().item(), 1.0,
                                       atol=1e-3)
        else:
            np.testing.assert_array_equal(batched[i].numpy(),
                                          single.numpy())
    np.testing.assert_array_equal(batched[1].numpy(), batched[2].numpy())


def test_halted_windows_freeze_and_steps_follow_the_slowest():
    """A window that halts early keeps its state while the others run on:
    the batched run's steps are the slowest window's, and each window's
    result equals its own run's (CC: exact)."""
    _, log = _logs(4)
    view = build_view(log, 99)
    prog = port_program(JCC(max_steps=60))
    windows = [1000, 1]
    batched, steps = bsp.run(prog, view, windows=windows, device="cpu")
    singles = [bsp.run(prog, view, window=w, device="cpu") for w in windows]
    assert steps == max(s for _, s in singles)
    assert singles[1][1] < singles[0][1]
    for i, (res, _) in enumerate(singles):
        np.testing.assert_array_equal(batched[i].numpy(), res.numpy())


def test_degree_runs_no_superstep_and_max_steps_zero():
    _, log = _logs(2)
    res, steps = bsp.run(port_program(JDegree()), build_view(log, 60),
                         windows=[100, 10], device="cpu")
    assert steps == 0 and res["in"].shape == res["out"].shape
    assert res["in"].dtype == torch.int32
    assert int(res["in"].sum()) > int(res["in"][1].sum()) >= 0


def test_view_edges_csr_walk_matches_ids():
    """The cold route's CSRs cover the REAL edges of the view only."""
    _, log = _logs(5)
    view = build_view(log, 80)
    e = bsp.view_edges(view, "cpu")
    m = view.m_active
    for ids, indptr, perm in ((e.e_dst, e.in_indptr, None),
                              (e.e_src, e.out_indptr, e.out_perm)):
        seen = np.zeros(view.m_pad, int)
        for r in range(view.n_pad):
            rows = np.arange(int(indptr[r]), int(indptr[r + 1]))
            idx = rows if perm is None else perm.numpy()[rows]
            assert (ids.numpy()[idx] == r).all()
            seen[idx] += 1
        assert (seen[:m] == 1).all() and (seen[m:] == 0).all()
    assert e.in_indptr.dtype == e.out_indptr.dtype == torch.int64


def test_unported_programs_raise():
    """What the port refuses or fails, it refuses or fails as the reference
    does: a custom-combiner program without its own functions raises the
    base class's NotImplementedError in both packages, and with direction
    'both' the reference's ValueError; an occurrence program on a view
    built without its occurrence rows raises the reference's ValueError."""
    from raphtory_tpu.engine.program import VertexProgram as JVertexProgram
    from raphtory_tpu_torch.engine.program import VertexProgram

    class Custom(VertexProgram):
        combiner = "custom"

    class JCustom(JVertexProgram):
        combiner = "custom"

    class CustomBoth(Custom):
        direction = "both"

    class JCustomBoth(JCustom):
        direction = "both"

    class Occurrences(VertexProgram):
        needs_occurrences = True

    class JOccurrences(JVertexProgram):
        needs_occurrences = True

    jlog, log = _logs(1)
    view, jview = build_view(log, 50), jbuild_view(jlog, 50)
    with pytest.raises(NotImplementedError):
        jbsp.run(JCustom(), jview)
    with pytest.raises(NotImplementedError):
        bsp.run(Custom(), view, device="cpu")
    for run, prog, v, kw in ((jbsp.run, JCustomBoth(), jview, {}),
                             (bsp.run, CustomBoth(), view,
                              {"device": "cpu"})):
        with pytest.raises(ValueError, match="custom"):
            run(prog, v, **kw)
    with pytest.raises(NotImplementedError):
        JCustom().exchange(None, None, 0, None)
    with pytest.raises(NotImplementedError):
        Custom().exchange(None, None, 0, None)
    for run, prog, v, kw in ((jbsp.run, JOccurrences(), jview, {}),
                             (bsp.run, Occurrences(), view,
                              {"device": "cpu"})):
        with pytest.raises(ValueError, match="include_occurrences"):
            run(prog, v, **kw)
    with pytest.raises(ValueError, match="non-empty"):
        bsp.run(port_program(JCC()), view, windows=[], device="cpu")


def test_context_is_window_batched():
    """init/update/finalize see [k, n] masks and degrees and [k, 1]
    scalars, once per superstep for all k windows."""
    from raphtory_tpu_torch.engine.program import VertexProgram

    seen = []

    @dataclasses.dataclass(frozen=True)
    class Probe(VertexProgram):
        max_steps: int = 2

        def init(self, ctx):
            seen.append(("init", tuple(ctx.v_mask.shape),
                         tuple(ctx.out_deg.shape), tuple(ctx.time.shape),
                         tuple(ctx.n_active.shape),
                         tuple(ctx.global_sum(ctx.in_deg).shape),
                         tuple(ctx.global_max(ctx.in_deg).shape)))
            return torch.zeros(ctx.v_mask.shape, dtype=torch.float32)

        def message(self, src_state, edge):
            seen.append(("message", tuple(src_state.shape),
                         tuple(edge.src.shape)))
            return src_state + 1.0

        def update(self, state, agg, ctx):
            seen.append(("update", tuple(agg.shape)))
            return state, torch.zeros_like(ctx.v_mask)

    _, log = _logs(6)
    view = build_view(log, 70)
    k, n, m = 3, view.n_pad, view.m_pad
    _, steps = bsp.run(Probe(), view, windows=[100, 20, 5], device="cpu")
    assert steps == 2
    assert seen == [("init", (k, n), (k, n), (k, 1), (k, 1), (k, 1), (k, 1)),
                    ("message", (k * m,), (k * m,)), ("update", (k, n)),
                    ("message", (k * m,), (k * m,)), ("update", (k, n))]


# ------------------------------------------- the destination-binned route

@pytest.mark.parametrize("name", sorted(PROGRAMS))
@pytest.mark.parametrize("P", ["3", "7"])
def test_binned_bsp_run_matches_reference(P, name, monkeypatch):
    """The cold View on the binned exchange (``RTPU_PCPM=1``): the
    destination direction combines through the view's layout (K7-P), the
    reverse keeps K7 — against the JAX package's binned ``bsp.run``
    (``tests/test_partition.py:312``); the layout bins the REAL rows only."""
    monkeypatch.setenv("RTPU_PCPM", "1")
    monkeypatch.setenv("RTPU_PARTITIONS", P)
    jlog, log = _logs(3)
    jprog = PROGRAMS[name]
    prog = port_program(jprog)
    q = QUERIES["windows"]
    want, wsteps = jbsp.run(jprog, jbuild_view(jlog, 60), **q)
    view = build_view(log, 60)
    got, gsteps = bsp.run(prog, view, device="cpu", **q)
    if name == "pagerank":
        def at(steps, port):
            p = dataclasses.replace(jprog, max_steps=steps, tol=0.0)
            if port:
                return bsp.run(port_program(p), view, device="cpu", **q)[0]
            return jbsp.run(p, jbuild_view(jlog, 60), **q)[0]

        assert_pagerank_steps(gsteps, wsteps, lambda k: at(k, True),
                              lambda k: at(k, False), jprog.tol)
    else:
        assert gsteps == int(wsteps)
    assert_results_match(got, want, name == "pagerank")
    lay = bsp._view_layout(view)
    jlay = jbsp._view_layout(jbuild_view(jlog, 60), view.e_src, view.e_dst,
                             False)
    assert lay is not None and tuple(lay.spec) == tuple(jlay.spec)
    assert lay.m == view.m_active and int(lay.valid.sum()) == view.m_active


def test_binned_exchange_launches_the_partition_combine(monkeypatch):
    """Where the layout bins, the destination combine is K7-P and the
    reverse direction K7; the binned and flat exchanges agree."""
    from raphtory_tpu_torch.engine import bsp as bsp_mod

    calls = []
    real = bsp_mod.partition_reduce
    monkeypatch.setattr(bsp_mod, "partition_reduce",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    jlog, log = _logs(0)
    view = build_view(log, 80)
    prog = port_program(PROGRAMS["cc"])
    monkeypatch.setenv("RTPU_PCPM", "0")
    flat, fsteps = bsp.run(prog, view, device="cpu", windows=[100, 20])
    assert not calls
    monkeypatch.setenv("RTPU_PCPM", "1")
    got, steps = bsp.run(prog, view, device="cpu", windows=[100, 20])
    assert calls and steps == fsteps
    assert all(np.array_equal(a, b) for a, b in zip(leaves(got),
                                                    leaves(flat)))
