"""K11, the port's vertex-sharded supersteps (``raphtory_tpu_torch/
parallel/sharded.py``), against ``raphtory_tpu.parallel.sharded.run``.

The reference runs a 4-device mesh in one process (conftest's virtual CPU
devices); the port runs the same mesh as 4 gloo ranks on the CPU, spawned
ONCE for the module (``cluster.bootstrap.spawn``, hard timeout) and
driven through ``cluster.tasks``. On the same seeded logs: PageRank and
ConnectedComponents on 1 x 4 and 2 x 2 (windows x vertices) meshes over
the all_gather and halo routes, with a window count (3) that is no
multiple of the window axis; LabelPropagation through its custom
combiner; the degenerate 1 x 1 mesh in this process. CC and LPA labels
bitwise with equal steps; PageRank within rtol 1e-5 / atol 1e-7, steps
equal to the port's single-device ``bsp.run`` and to the reference's but
for the documented float-noise case (``test_torch_bsp.
assert_pagerank_steps``). TaintTracking over the occurrence partition
(int64 state, a stop-list, a value gate) on the same meshes and routes,
in the same rank group: bitwise the reference's and the port's
single-device ``bsp.run``, equal steps. Every rank holds the same result. Also the
host partition (``partition_view``, ``_build_halo``) bitwise, and the
spawner's failure path.

The test session's rank groups start one after another
(``one_group_at_a_time``): under pytest-xdist every worker holds the JAX
package's 8 virtual devices, and several groups of 4 rank interpreters at
once beside them are what a loaded machine does not need."""

import contextlib
import dataclasses
import fcntl
import os
import tempfile
import time
from pathlib import Path

import jax
import numpy as np
import pytest
import torch
from test_sweep import random_log
from test_torch_bsp import assert_pagerank_steps

from raphtory_tpu.algorithms import BinaryDiffusion as JDiffusion
from raphtory_tpu.algorithms import ConnectedComponents as JCC
from raphtory_tpu.algorithms import LabelPropagation as JLPA
from raphtory_tpu.algorithms import PageRank as JPageRank
from raphtory_tpu.algorithms import TaintTracking as JTaint
from raphtory_tpu.core.snapshot import build_view as jbuild_view
from raphtory_tpu.parallel import sharded as jsharded
from raphtory_tpu_torch.cluster.bootstrap import _machine, spawn
from raphtory_tpu_torch.core.snapshot import build_view
from raphtory_tpu_torch.engine import bsp
from raphtory_tpu_torch.interop import (event_log_from_arrays,
                                        numeric_prop_payloads,
                                        program_from_params)
from raphtory_tpu_torch.parallel import sharded

TARGET = "raphtory_tpu_torch.cluster.tasks:run_requests"
T = 90
WINDOWS = [100, 30, 7]
PROGRAMS = {"pagerank": JPageRank(max_steps=30, tol=1e-7),
            "cc": JCC(max_steps=60),
            "lpa": JLPA(max_steps=12),
            # no seeds: the seed vertex is the collective min over ranks
            "diffusion": JDiffusion(spread_prob=0.6, max_steps=30)}
#: (program, mesh [S, W], comm)
CASES = [(p, mesh, comm) for p in ("pagerank", "cc")
         for mesh in ((4, 1), (2, 2)) for comm in ("all_gather", "halo")] \
    + [("lpa", (4, 1), "halo"), ("lpa", (2, 2), "all_gather")] \
    + [("diffusion", (4, 1), "halo"), ("diffusion", (2, 2), "all_gather")]
#: TaintTracking over the occurrence rows: (mesh [S, W], comm, value gate)
TAINT_CASES = [((4, 1), "halo", False), ((4, 1), "all_gather", True),
               ((2, 2), "all_gather", False), ((2, 2), "halo", True)]


def jax_log(seed=11):
    return random_log(np.random.default_rng(seed), n_events=900, n_ids=70,
                      t_span=100, props=True)


def log_desc(jlog):
    """What the ranks rebuild the port's log from."""
    return {"arrays": {k: np.asarray(v) for k, v in jlog.arrays().items()},
            "props": numeric_prop_payloads(jlog.props)}


def port_log(jlog):
    d = log_desc(jlog)
    return event_log_from_arrays(d["arrays"], props=d["props"])


def spec(jprog):
    return (type(jprog).__name__, dataclasses.asdict(jprog))


def taint_prog(value: bool):
    """The reference's TaintTracking on the test log's own ids: 3 seeds at
    t 20, a stop-listed vertex and, with ``value``, a gate on each
    event's ``w``."""
    view = jbuild_view(jax_log(), T)
    ids = [int(v) for v in view.vids[:view.n_active]]
    kw = dict(seeds=tuple(ids[:3]), start_time=20, stop_list=(ids[5],),
              max_steps=30)
    if value:
        kw.update(value_prop="w", min_value=2.0)
    return JTaint(**kw)


def port_prog(jprog):
    name, params = spec(jprog)
    return program_from_params(name, **params)


def jax_mesh(S, W):
    return jsharded.make_mesh(S, W, devices=jax.devices()[:S * W])


def _groups_base() -> Path:
    run = os.environ.get("PYTEST_XDIST_TESTRUNUID", str(os.getpid()))
    return Path(tempfile.gettempdir()) / f"rtpu_rank_groups_{run}"


def _trace(what: str, error: BaseException | None = None) -> None:
    test = os.environ.get("PYTEST_CURRENT_TEST", "-").split(" ")[0]
    worker = os.environ.get("PYTEST_XDIST_WORKER", "-")
    lines = [f"{time.strftime('%H:%M:%S')} {worker} {what} {test}: "
             f"{_machine()}"]
    if error is not None:
        # spawn's text: how each rank ended and the tail of its output
        text = f"{type(error).__name__}: {error}"
        lines += [f"    | {line}" for line in text.splitlines()]
    with open(f"{_groups_base()}.log", "a") as log:
        log.write("\n".join(lines) + "\n")


@contextlib.contextmanager
def one_group_at_a_time():
    """Hold the test session's rank-group lock (a file lock shared by the
    session's pytest-xdist workers), so that its groups of ranks run one
    after another. Each group's start and end, with the machine's free
    memory and load, go to ``rtpu_rank_groups_<run>.log`` beside the lock
    in the temp directory: a worker lost inside a group leaves a start
    with no end, and the memory the machine had left. A group that
    raised leaves the exception's type and text under its line, each
    line prefixed ``    | `` (for ``spawn``: each rank's exit and the
    tail of its output)."""
    with open(f"{_groups_base()}.lock", "w") as f:
        fcntl.flock(f, fcntl.LOCK_EX)
        try:
            _trace("start")
            yield
        except BaseException as error:
            _trace("raised", error)
            raise
        else:
            _trace("end")
        finally:
            fcntl.flock(f, fcntl.LOCK_UN)


def run_ranks(logs, requests, timeout=240, world=4, whole=False):
    """Spawn ``world`` gloo CPU ranks once for ``requests``: rank 0's
    results (``whole``: all rank 0 returned), after checking every rank
    got the same."""
    with one_group_at_a_time():
        out = spawn(TARGET, world, ({"logs": logs, "requests": requests},),
                    timeout=timeout, device="cpu")
    for other in out[1:]:
        for a, b in zip(out[0]["results"], other["results"]):
            assert a.keys() == b.keys()
            for key in ("result", "steps", "rows", "hops"):
                if key in a:
                    assert_tree_equal(a[key], b[key])
    return out[0] if whole else out[0]["results"]


def assert_tree_equal(a, b):
    if isinstance(a, dict):
        assert a.keys() == b.keys()
        for k in a:
            assert_tree_equal(a[k], b[k])
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            assert_tree_equal(x, y)
    else:
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def assert_matches(got, want, name):
    want = np.asarray(want)
    assert got.shape == want.shape and got.dtype == want.dtype
    if name == "pagerank":
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-7)
    else:
        np.testing.assert_array_equal(got, want)


@pytest.fixture(scope="module")
def ranks():
    jlog = jax_log()
    reqs = [dict(op="sharded", log="g", T=T, program=spec(PROGRAMS[p]),
                 mesh=mesh, windows=WINDOWS, comm=comm)
            for p, mesh, comm in CASES]
    reqs += [dict(op="sharded", log="g", T=T, program=spec(taint_prog(value)),
                  mesh=mesh, windows=WINDOWS, comm=comm)
             for mesh, comm, value in TAINT_CASES]
    keys = CASES + [("taint",) + c for c in TAINT_CASES]
    return dict(zip(keys, run_ranks({"g": log_desc(jlog)}, reqs)))


@pytest.mark.parametrize("case", TAINT_CASES, ids=lambda c: f"{c[0][1]}x"
                         f"{c[0][0]}-{c[1]}{'-value' if c[2] else ''}")
def test_sharded_taint_matches_reference(ranks, case):
    """The occurrence partition (``sharded.py:604-613``): int64 taint
    times through all_gather / halo and the int64 K7, bitwise."""
    (S, W), comm, value = case
    got = ranks[("taint",) + case]
    jlog = jax_log()
    jprog = taint_prog(value)
    want, wsteps = jsharded.run(
        jprog, jbuild_view(jlog, T, include_occurrences=True),
        jax_mesh(S, W), windows=WINDOWS, comm=comm)
    single, steps = bsp.run(
        port_prog(jprog), build_view(port_log(jlog), T,
                                     include_occurrences=True),
        windows=WINDOWS, device="cpu")
    assert got["result"].dtype == np.int64
    np.testing.assert_array_equal(got["result"], np.asarray(want))
    np.testing.assert_array_equal(got["result"], single.numpy())
    assert got["steps"] == steps == int(wsteps)
    assert got["routes"][f"{comm}/out"]["supersteps"] == got["steps"]
    assert (got["result"] < np.iinfo(np.int64).max).any()


@pytest.mark.parametrize("case", CASES, ids=lambda c: f"{c[0]}-"
                         f"{c[1][1]}x{c[1][0]}-{c[2]}")
def test_sharded_run_matches_reference(ranks, case):
    name, (S, W), comm = case
    got = ranks[case]
    jlog = jax_log()
    jview = jbuild_view(jlog, T)
    jprog = PROGRAMS[name]
    want, wsteps = jsharded.run(jprog, jview, jax_mesh(S, W),
                                windows=WINDOWS, comm=comm)
    assert_matches(got["result"], want, name)
    assert got["routes"][f"{comm}/{jprog.direction}"]["supersteps"] \
        == got["steps"]
    prog = port_prog(jprog)
    view = build_view(port_log(jlog), T)
    single, ssteps = bsp.run(prog, view, windows=WINDOWS, device="cpu")
    assert got["steps"] == ssteps
    assert_matches(got["result"], single.numpy(), name)
    if name != "pagerank":
        assert got["steps"] == int(wsteps)
        return
    assert_pagerank_steps(
        got["steps"], wsteps,
        lambda s: bsp.run(dataclasses.replace(prog, max_steps=s, tol=0.0),
                          view, windows=WINDOWS, device="cpu")[0],
        lambda s: jsharded.run(dataclasses.replace(jprog, max_steps=s,
                                                   tol=0.0),
                               jview, jax_mesh(S, W), windows=WINDOWS,
                               comm=comm)[0], jprog.tol)


@pytest.mark.parametrize("name", ["pagerank", "cc"])
def test_one_rank_mesh_matches_reference(name):
    """The degenerate 1 x 1 mesh: no process group, this process."""
    jlog = jax_log(3)
    jprog = PROGRAMS[name]
    want, wsteps = jsharded.run(jprog, jbuild_view(jlog, T), jax_mesh(1, 1),
                                window=30)
    mesh = sharded.make_mesh(1, 1, device="cpu")
    assert (mesh.n_devices, mesh.n_processes, mesh.rank) == (1, 1, 0)
    got, steps = sharded.run(port_prog(jprog),
                             build_view(port_log(jlog), T), mesh, window=30)
    assert_matches(got.numpy(), want, name)
    assert steps == int(wsteps)


@pytest.mark.parametrize("shards", [1, 2, 4, 8])
def test_partition_and_halo_match_reference(shards):
    jlog = jax_log(5)
    jsv = jsharded.partition_view(jbuild_view(jlog, T), shards,
                                  edge_props=("w",))
    sv = sharded.partition_view(build_view(port_log(jlog), T), shards,
                                edge_props=("w",))
    for f in ("n_shards", "n_loc", "m_loc_d", "m_loc_s", "h_d", "h_s"):
        assert getattr(sv, f) == getattr(jsv, f), f
    for f in ("vids", "v_mask", "v_latest", "v_first", "d_src_g", "d_dst_l",
              "d_mask", "d_time", "d_first", "s_dst_g", "s_src_l", "s_mask",
              "s_time", "s_first", "d_src_h", "d_send", "s_dst_h", "s_send"):
        np.testing.assert_array_equal(getattr(sv, f), getattr(jsv, f),
                                      err_msg=f)
        assert getattr(sv, f).dtype == getattr(jsv, f).dtype, f
    np.testing.assert_array_equal(sv.d_props["w"], jsv.d_props["w"])
    np.testing.assert_array_equal(sv.s_props["w"], jsv.s_props["w"])
    assert sv.skew == jsv.skew
    np.testing.assert_array_equal(sv.d_count, sv.skew["edges_dst"]
                                  ["per_shard"])
    for direction in ("out", "in", "both"):
        assert sv.halo_rows(direction) == jsv.halo_rows(direction)


def test_build_halo_matches_reference():
    rng = np.random.default_rng(0)
    for S, n_loc, m in ((4, 16, 40), (8, 8, 64), (2, 32, 5)):
        idx = rng.integers(0, S * n_loc, (S, m)).astype(np.int32)
        for got, want in zip(sharded._build_halo(idx, n_loc, S),
                             jsharded._build_halo(idx, n_loc, S)):
            np.testing.assert_array_equal(got, want)
    for n in (0, 1, 8, 9, 1000):
        assert sharded._pow2(n) == jsharded._pow2(n)


def test_failing_rank_stops_the_group():
    """A rank that raises brings every rank down, and the spawner raises
    with its error, well inside the timeout."""
    with one_group_at_a_time(), \
            pytest.raises(RuntimeError, match="requested failure"):
        spawn(TARGET, 2, ({"requests": [dict(op="fail", rank=1)]},),
              timeout=60, device="cpu")


def test_a_rank_that_aborts_in_its_teardown_does_not_fail_the_group():
    """A rank ends once its result is written and the group has met: no
    teardown runs after that. Here each rank's work registers an exit
    handler that aborts the process, as gloo's teardown aborted a rank
    of a finished group ("terminate called without an active
    exception", the rank killed by SIGABRT after the others exited 0);
    the group still returns every rank's result."""
    with one_group_at_a_time():
        out = spawn("atexit:register", 2, (os.abort,), timeout=60,
                    device="cpu")
    assert out == [os.abort, os.abort]


def test_rank_groups_leave_a_trace():
    """Every group run under the lock appends its start and its end (or
    that it raised, with the exception's type and text) with the
    machine's memory and load to the session's trace. A failed spawn's
    text, with each rank's exit and output, is kept whole."""
    log = Path(f"{_groups_base()}.log")
    before = log.read_text() if log.exists() else ""
    with pytest.raises(RuntimeError, match="inside"):
        with one_group_at_a_time():
            raise RuntimeError("inside\nsecond line")
    with pytest.raises(RuntimeError, match="failed") as failed:
        with one_group_at_a_time():
            spawn("sys:exit", 2, (3,), timeout=60, device="cpu")
    with one_group_at_a_time():
        pass
    new = log.read_text()[len(before):].splitlines()
    mine = [i for i, line in enumerate(new)
            if "test_rank_groups_leave_a_trace" in line]
    assert [new[i].split()[2] for i in mine] == [
        "start", "raised", "start", "raised", "start", "end"]
    assert all("MemAvailable" in new[i] or "not readable" in new[i]
               for i in mine)

    def text_under(i):
        # a raised line and its text are one write under the lock; other
        # workers' groups may write between this test's own groups
        lines = []
        for line in new[i + 1:]:
            if not line.startswith("    | "):
                break
            lines.append(line[len("    | "):])
        return lines

    assert text_under(mine[1]) == ["RuntimeError: inside", "second line"]
    kept = "\n".join(text_under(mine[3]))
    assert kept == f"RuntimeError: {failed.value}".rstrip("\n")
    assert "rank 0 (exit 3)" in kept and "rank 1 (exit 3)" in kept


def test_a_rank_killed_from_outside_is_named():
    """A rank that SIGKILL ends (here each rank sends it to itself once
    it has joined, as the out-of-memory killer would) is reported as
    killed from outside the group, with the machine's free memory, even
    when the other rank raised first on losing its peer."""
    with one_group_at_a_time(), pytest.raises(
            RuntimeError, match="(?s)outside the group.*The machine: "
            "(MemAvailable|memory and load not readable).*"
            "rank [01] \\(killed by SIGKILL\\)"):
        spawn("signal:raise_signal", 2, (9,), timeout=60, device="cpu")


def test_spawn_diagnosis_reads_the_exit_codes():
    from raphtory_tpu_torch.cluster import bootstrap

    assert bootstrap._ended(None) == "still running, stopped by spawn"
    assert bootstrap._ended(-9) == "killed by SIGKILL"
    assert bootstrap._ended(1) == "exit 1"
    assert "outside the group" in bootstrap._diagnosis([0, -9, None])
    # a peer that raised on losing the killed rank does not hide the kill
    assert "outside the group" in bootstrap._diagnosis([1, -9, None])
    # a rank's own crash is named in its tail, not as a kill from outside
    assert "outside the group" not in bootstrap._diagnosis([1, -11, None])
    assert "The machine:" in bootstrap._diagnosis([None, None])


def test_mesh_shape_must_match_the_ranks():
    with pytest.raises(ValueError, match="mesh != 1 rank"):
        sharded.make_mesh(2, 1, device="cpu")


def test_programs_the_mesh_does_not_carry_raise():
    from raphtory_tpu_torch.algorithms import PageRank
    from raphtory_tpu_torch.engine.program import VertexProgram

    class Occ(VertexProgram):
        needs_occurrences = True

    class CustomBoth(VertexProgram):
        combiner = "custom"
        direction = "both"

    view = build_view(port_log(jax_log()), T)
    mesh = sharded.make_mesh(1, 1, device="cpu")
    # a view without occurrence rows: the reference's ValueError
    # (``raphtory_tpu/parallel/sharded.py:605-607``)
    with pytest.raises(ValueError, match="include_occurrences"):
        sharded.run(Occ(), view, mesh)
    with pytest.raises(ValueError, match="custom"):
        sharded.run(CustomBoth(), view, mesh)
    with pytest.raises(ValueError, match="monotone_min"):
        sharded.run(PageRank(), view, mesh, comm="sparse")


def test_backend_is_chosen_explicitly(monkeypatch):
    """Several ranks on one card take gloo only when asked; a card a rank
    cannot reach raises."""
    from raphtory_tpu_torch.cluster import bootstrap

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        bootstrap.bootstrap(0, 2, "file:///nonexistent", device="cuda")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(RuntimeError, match="share_card=True"):
        bootstrap.bootstrap(1, 2, "file:///nonexistent", device="cuda")
    with pytest.raises(ValueError, match="gloo"):
        bootstrap.bootstrap(1, 2, "file:///nonexistent", device="cuda",
                            share_card=True, backend="nccl")
    monkeypatch.delenv("WORLD_SIZE", raising=False)
    assert bootstrap.bootstrap() is False     # single-process mode
