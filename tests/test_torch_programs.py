"""The five programs the port carries last (``DegreeRanking``, ``StarNode``,
``Density``, ``FlowGraph``, ``BinaryDiffusion``) against the JAX package's:
each through both packages' ``AnalysisManager`` as a windowed View and a
windowed Range (rows equal except ``viewTime``), through both generic
engines directly, and ``BinaryDiffusion``'s coin hash held bitwise against
the reference's uint32 hash on the same ``(src, dst, step, seed)``."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_sweep import random_log

from raphtory_tpu.algorithms.diffusion import \
    BinaryDiffusion as JBinaryDiffusion
from raphtory_tpu.algorithms.flow import FlowGraph as JFlowGraph
from raphtory_tpu.algorithms.rankings import DegreeRanking as JDegreeRanking
from raphtory_tpu.algorithms.rankings import Density as JDensity
from raphtory_tpu.algorithms.rankings import StarNode as JStarNode
from raphtory_tpu.core.service import TemporalGraph as JTemporalGraph
from raphtory_tpu.core.snapshot import build_view as jbuild_view
from raphtory_tpu.engine import bsp as jbsp
from raphtory_tpu.engine.program import Edges as JEdges
from raphtory_tpu.jobs.manager import AnalysisManager as JAnalysisManager
from raphtory_tpu.jobs.manager import RangeQuery as JRangeQuery
from raphtory_tpu.jobs.manager import ViewQuery as JViewQuery
from raphtory_tpu_torch.algorithms.diffusion import edge_hash
from raphtory_tpu_torch.core.service import TemporalGraph
from raphtory_tpu_torch.core.snapshot import build_view
from raphtory_tpu_torch.engine import bsp
from raphtory_tpu_torch.engine.program import Edges
from raphtory_tpu_torch.interop import (_PROGRAMS, event_log_from_arrays,
                                        numeric_prop_payloads,
                                        program_from_params)
from raphtory_tpu_torch.jobs.manager import (AnalysisManager, RangeQuery,
                                             ViewQuery)

PROGRAMS = {
    "degree_ranking": JDegreeRanking(top_k=7, by="total"),
    "degree_ranking_in": JDegreeRanking(top_k=5, by="in"),
    "star": JStarNode(),
    "density": JDensity(),
    "flow": JFlowGraph(flow_prop="w", default_flow=0.5),
    "diffusion": JBinaryDiffusion(spread_prob=0.6, max_steps=30),
    "diffusion_seeded": JBinaryDiffusion(seeds=(3, 7), seed=5,
                                         spread_prob=0.4, max_steps=30),
}
WINDOWS = (100, 30, 7)


@pytest.fixture(autouse=True)
def _one_route(monkeypatch):
    monkeypatch.setenv("RTPU_PCPM", "0")
    monkeypatch.setenv("RTPU_BATCH_WINDOW_MS", "0")


def _logs(seed=0):
    jlog = random_log(np.random.default_rng(seed), n_events=600, n_ids=40,
                      t_span=100, props=True)
    return jlog, event_log_from_arrays(
        jlog.arrays(), props=numeric_prop_payloads(jlog.props))


def _port(jprog):
    return program_from_params(type(jprog).__name__,
                               **dataclasses.asdict(jprog))


def _rows(mgr, prog, q):
    job = mgr.submit(prog, q)
    assert job.wait(120) and job.status == "done", job.error
    return [{k: v for k, v in r.items() if k != "viewTime"}
            for r in mgr.results(job.id)]


def test_program_from_params_carries_all_twelve():
    names = {"PageRank", "ConnectedComponents", "SSSP", "BFS", "DegreeBasic",
             "LabelPropagation", "TaintTracking", "DegreeRanking",
             "StarNode", "Density", "FlowGraph", "BinaryDiffusion"}
    assert set(_PROGRAMS) == names
    for jprog in PROGRAMS.values():
        prog = _port(jprog)
        assert type(prog).__name__ == type(jprog).__name__
        assert dataclasses.asdict(prog) == dataclasses.asdict(jprog)
        for attr in ("combiner", "direction", "needs_vids",
                     "needs_vertex_times", "needs_edge_times"):
            assert getattr(prog, attr) == getattr(jprog, attr), attr
    with pytest.raises(KeyError, match="unknown program"):
        program_from_params("NoSuchProgram")


@pytest.mark.parametrize("name", sorted(PROGRAMS))
def test_jobs_match_reference(name):
    """A windowed View and a windowed Range through both managers: the
    same rows in the same order."""
    jlog, log = _logs()
    jprog = PROGRAMS[name]
    jmgr = JAnalysisManager(JTemporalGraph(jlog))
    mgr = AnalysisManager(TemporalGraph(log, device="cpu"), device="cpu")
    for q, jq in ((ViewQuery(80, windows=WINDOWS),
                   JViewQuery(80, windows=WINDOWS)),
                  (RangeQuery(40, 100, 20, windows=WINDOWS),
                   JRangeQuery(40, 100, 20, windows=WINDOWS))):
        got, want = _rows(mgr, _port(jprog), q), _rows(jmgr, jprog, jq)
        assert len(got) == len(want) > 0
        assert got == want


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("name", ["diffusion", "diffusion_seeded",
                                  "degree_ranking"])
def test_bsp_run_matches_reference(name, seed):
    """The generic engines directly: the raw per-vertex results bitwise,
    the same superstep count."""
    jlog, log = _logs(seed)
    jprog = PROGRAMS[name]
    want, wsteps = jbsp.run(jprog, jbuild_view(jlog, 70),
                            windows=list(WINDOWS))
    got, steps = bsp.run(_port(jprog), build_view(log, 70),
                         windows=list(WINDOWS), device="cpu")
    assert steps == int(wsteps)
    if isinstance(got, dict):
        got = [got[k].numpy() for k in sorted(got)]
        want = [np.asarray(want[k]) for k in sorted(want)]
    else:
        got, want = [got.numpy()], [np.asarray(want)]
    for g, w in zip(got, want):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)
    if name.startswith("diffusion"):
        # the spread reached past its seed in some window
        assert int(got[0].sum()) > len(WINDOWS)


def _jax_hash(src, dst, step, seed):
    """The reference's uint32 hash, from its own ``message``: with a
    source state of all ones the payload is the coin, and with
    ``spread_prob`` just above ``h / 2^32`` it is the hash's order."""
    prog = JBinaryDiffusion(seed=seed, spread_prob=0.5)
    edges = JEdges(src=jnp.asarray(src), dst=jnp.asarray(dst),
                   mask=jnp.ones(len(src), bool),
                   time=jnp.zeros(len(src), jnp.int64),
                   first_time=jnp.zeros(len(src), jnp.int64), props={},
                   step=jnp.int32(step))
    return np.asarray(prog.message(jnp.ones(len(src), jnp.int32), edges))


def _reference_hash_bits(src, dst, step, seed):
    """The reference's hash expression (``raphtory_tpu/algorithms/
    diffusion.py:53-60``) evaluated by jax.numpy in uint32."""
    u = jnp.uint32
    h = (jnp.asarray(src).astype(u) * u(0x9E3779B1)
         ^ jnp.asarray(dst).astype(u) * u(0x85EBCA77)
         ^ (jnp.int32(step).astype(u) + u(seed)) * u(0xC2B2AE3D))
    h = h ^ (h >> 15)
    h = h * u(0x2C1B3C6D)
    h = h ^ (h >> 12)
    h = h * u(0x297A2D39)
    h = h ^ (h >> 15)
    return np.asarray(h).astype(np.int64)


@pytest.mark.parametrize("step,seed", [(0, 42), (1, 42), (7, 5),
                                       (49, 2**31 - 1), (3, 2**32 - 3)])
def test_diffusion_hash_is_the_reference_hash(step, seed):
    rng = np.random.default_rng(step + 17)
    src = np.concatenate([rng.integers(-2**31, 2**31, 4000),
                          [0, 1, -1, 2**31 - 1, -2**31]]).astype(np.int32)
    dst = np.concatenate([rng.integers(-2**31, 2**31, 4000),
                          [0, 2**31 - 1, -1, 5, -2**31]]).astype(np.int32)
    got = edge_hash(torch.from_numpy(src), torch.from_numpy(dst), step,
                    seed).numpy()
    np.testing.assert_array_equal(got,
                                  _reference_hash_bits(src, dst, step, seed))
    # the coins: the reference's message against the port's, bitwise
    coins = _port(JBinaryDiffusion(seed=seed, spread_prob=0.5)).message(
        torch.ones(len(src), dtype=torch.int32),
        Edges(src=torch.from_numpy(src), dst=torch.from_numpy(dst),
              mask=torch.ones(len(src), dtype=torch.bool),
              time=torch.zeros(len(src), dtype=torch.int64),
              first_time=torch.zeros(len(src), dtype=torch.int64),
              step=step))
    want = _jax_hash(src, dst, step, seed)
    np.testing.assert_array_equal(coins.numpy(), want)
    assert 0 < int(want.sum()) < len(src)
