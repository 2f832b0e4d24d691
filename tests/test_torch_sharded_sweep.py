"""The port's static-partition mesh Range sweep (``raphtory_tpu_torch/
parallel/sweep.ShardedSweep``) against ``raphtory_tpu.parallel.sweep.
ShardedSweep`` on a 4-device mesh and against the port's single-device
``DeviceSweep``.

4 gloo CPU ranks (one group for the module) sweep PageRank on a 2 x 2
mesh (all_gather) and CC on a 1 x 4 mesh (halo) over ascending hops,
repeats included: CC bitwise, PageRank within rtol 1e-5 / atol 1e-7,
equal steps. In this process: the static partition and its per-hop
patches bitwise the reference's, the shard-count check, and the sampled
skew refresh."""

import dataclasses

import numpy as np
import pytest
from test_sweep import random_log
from test_torch_sharded import (jax_mesh, log_desc, port_log, port_prog,
                                run_ranks, spec)

from raphtory_tpu.algorithms import ConnectedComponents as JCC
from raphtory_tpu.algorithms import PageRank as JPageRank
from raphtory_tpu.parallel.sweep import ShardedSweep as JShardedSweep
from raphtory_tpu_torch.engine.device_sweep import DeviceSweep
from raphtory_tpu_torch.parallel import sharded
from raphtory_tpu_torch.parallel.sweep import ShardedSweep

TIMES = [15, 40, 41, 41, 89]
WINDOWS = [100, 20]
#: name -> (program, mesh [S, W], comm)
CASES = {"pagerank": (JPageRank(max_steps=15, tol=1e-7), (2, 2),
                      "all_gather"),
         "cc": (JCC(max_steps=40), (4, 1), "halo")}


def jax_log(seed=6):
    return random_log(np.random.default_rng(seed), n_events=600, n_ids=48,
                      t_span=90)


@pytest.fixture(scope="module")
def ranks():
    reqs = [dict(op="sweep", log="g", times=TIMES, program=spec(prog),
                 mesh=mesh, windows=WINDOWS, comm=comm)
            for prog, mesh, comm in CASES.values()]
    return dict(zip(CASES, run_ranks({"g": log_desc(jax_log())}, reqs)))


@pytest.mark.parametrize("name", sorted(CASES))
def test_sharded_sweep_matches_reference(ranks, name):
    jprog, (S, W), comm = CASES[name]
    got = ranks[name]
    jlog = jax_log()
    jsweep = JShardedSweep(jlog, S)
    dsweep = DeviceSweep(port_log(jlog), device="cpu")
    np.testing.assert_array_equal(got["uv"], jsweep.t.uv)
    for T, hop in zip(TIMES, got["hops"]):
        want, wsteps = jsweep.run(jprog, T, mesh=jax_mesh(S, W),
                                  windows=WINDOWS, comm=comm)
        one, steps = dsweep.run(port_prog(jprog), T, windows=WINDOWS)
        assert hop["steps"] == steps == int(wsteps)
        if name == "pagerank":
            np.testing.assert_allclose(hop["result"], np.asarray(want),
                                       rtol=1e-5, atol=1e-7)
            np.testing.assert_allclose(hop["result"], one.numpy(),
                                       rtol=1e-5, atol=1e-7)
        else:
            np.testing.assert_array_equal(hop["result"], np.asarray(want))
            np.testing.assert_array_equal(hop["result"], one.numpy())


def test_static_partition_and_patches_match_reference():
    jlog = jax_log(0)
    jsw, sw = JShardedSweep(jlog, 4), ShardedSweep(port_log(jlog), 4)
    for T in (None, 10, 50, 89):
        if T is not None:
            jsw.advance(T)
            sw.advance(T)
        for f in dataclasses.fields(sw.sv):
            if f.name in ("view", "d_props", "s_props", "d_count",
                          "s_count"):
                continue
            got, want = getattr(sw.sv, f.name), getattr(jsw.sv, f.name)
            if isinstance(want, np.ndarray):
                np.testing.assert_array_equal(got, want, err_msg=f.name)
            else:
                assert got == want, f.name
    np.testing.assert_array_equal(sw.sv.d_count,
                                  np.bincount(sw._d_shard, minlength=4))
    rv, jrv = sw.reduce_view(), jsw.reduce_view()
    for f in ("time", "n_pad", "vids", "v_mask", "v_latest_time"):
        np.testing.assert_array_equal(getattr(rv, f), getattr(jrv, f))
    with pytest.raises(ValueError, match="ascend"):
        sw.advance(5)


def test_shard_count_must_divide_the_pad():
    with pytest.raises(ValueError, match="must divide"):
        ShardedSweep(port_log(jax_log()), 3)
    mesh = sharded.make_mesh(1, 1, device="cpu")
    with pytest.raises(ValueError, match="partition shards"):
        ShardedSweep(port_log(jax_log()), 2).run(port_prog(JCC()), 50,
                                                 mesh=mesh)
    with pytest.raises(ValueError, match="advance"):
        ShardedSweep(port_log(jax_log()), 1).run(port_prog(JCC()),
                                                 mesh=mesh)


def test_skew_refreshes_after_churn():
    """Once a quarter of the pair table has churned the sampled skew is
    republished, at the hops the reference republishes it."""
    jlog = jax_log(1)
    jsw, sw = JShardedSweep(jlog, 4), ShardedSweep(port_log(jlog), 4)
    before = sharded.COLLECTIVES.snapshot()["skew_refreshes"]
    for T in range(5, 90, 5):
        jsw.advance(T)
        sw.advance(T)
        assert sw.sv.skew == jsw.sv.skew, T
    assert sharded.COLLECTIVES.snapshot()["skew_refreshes"] > before
