"""K13, the port's sparse frontier route (``raphtory_tpu_torch/parallel/
frontier.py``) and its kernels' twins, against ``raphtory_tpu.parallel``.

* On an adversarial log (deletes, tombstones, weights) and on a small
  ``sparse_collectives``-style Zipf stream, 4 gloo CPU ranks (one spawned
  group for the module) run CC, BFS and weighted SSSP over ``sparse`` and
  the dense routes: sparse is BITWISE the dense routes and the reference's
  ``sharded.run``, with equal steps, on 1 x 4 and 2 x 2 meshes.
* ``frontier_compact`` / ``frontier_count`` and ``frontier_merge_min``
  (the CPU twins behind the wrappers) against ``np.flatnonzero`` and
  ``np.minimum.at``: empty, full and one-row frontiers, int32 / float32,
  trailing dims.
* ``COLLECTIVES`` rows, bytes and supersteps of a sparse dispatch equal
  to the reference's on one process (the whole-sweep branch, and the
  exchange branch forced with ``multi=True``); on 4 ranks they follow the
  reference's formula.
* ``choose_route`` gives the reference's record for the same arguments,
  and ``frontier_bucket`` the reference's ladder."""

import types

import numpy as np
import pytest
import torch
from test_sweep import random_log
from test_torch_sharded import (jax_mesh, log_desc, port_log, port_prog,
                                run_ranks, spec)

from raphtory_tpu.algorithms import ConnectedComponents as JCC
from raphtory_tpu.algorithms import PageRank as JPageRank
from raphtory_tpu.algorithms.traversal import BFS as JBFS
from raphtory_tpu.algorithms.traversal import SSSP as JSSSP
from raphtory_tpu.core.events import EventLog as JEventLog
from raphtory_tpu.core.snapshot import build_view as jbuild_view
from raphtory_tpu.ops import partition as jpartition
from raphtory_tpu.parallel import frontier as jfrontier
from raphtory_tpu.parallel import sharded as jsharded
from raphtory_tpu_torch.core.snapshot import build_view
from raphtory_tpu_torch.ops import exchange
from raphtory_tpu_torch.ops import partition
from raphtory_tpu_torch.parallel import frontier, sharded
from raphtory_tpu_torch.utils.synth import zipf_hub_arrays, zipf_hubs

SEEDS = (1, 5, 9)
ADV_T, ADV_WINDOWS = 60, [70, 25]
ZIPF = dict(n_vertices=1024, n_events=40_000, seed=11)
ZIPF_WINDOWS = [800, 400, 200, 100]
PROGRAMS = {"cc": JCC(max_steps=40),
            "bfs": JBFS(seeds=SEEDS, directed=False, max_steps=40),
            "sssp": JSSSP(seeds=SEEDS, weight_prop="w", max_steps=40)}
ROUTES = ("all_gather", "halo", "sparse")
#: (log, program, mesh [S, W], route)
CASES = ([("adv", p, (4, 1), r) for p in PROGRAMS for r in ROUTES]
         + [("adv", "cc", (2, 2), r) for r in ("all_gather", "sparse")]
         + [("zipf", p, (4, 1), r) for p in ("cc", "bfs")
            for r in ("all_gather", "sparse")])


def adv_log():
    return random_log(np.random.default_rng(20), n_events=700, n_ids=48,
                      t_span=80, props=True)


def zipf_log():
    """The bench's stream, built through the reference's own verbs."""
    src, dst, ts = zipf_hub_arrays(**ZIPF)
    log = JEventLog()
    for t, a, b in zip(ts, src, dst):
        log.add_edge(int(t), int(a), int(b))
    return log


def program(log_name, name):
    if log_name == "zipf" and name == "bfs":
        return JBFS(seeds=zipf_hubs(**ZIPF), directed=False)
    if log_name == "zipf":
        return JCC()
    return PROGRAMS[name]


def query(log_name):
    return ((ADV_T, ADV_WINDOWS) if log_name == "adv"
            else (1000, ZIPF_WINDOWS))


@pytest.fixture(scope="module")
def logs():
    return {"adv": adv_log(), "zipf": zipf_log()}


#: measuring replays of two cases: (case, request flags)
REPLAYS = ((("adv", "cc", (4, 1), "sparse"), dict(sample=True)),
           (("adv", "cc", (4, 1), "halo"), dict(sample=True,
                                                collectives=True)))


def request(case):
    log_name, p, mesh, route = case
    T, windows = query(log_name)
    return dict(op="sharded", log=log_name, T=T, mesh=mesh,
                program=spec(program(log_name, p)), windows=windows,
                comm=route)


@pytest.fixture(scope="module")
def group(logs):
    reqs = ([request(c) for c in CASES]
            + [dict(request(c), **flags) for c, flags in REPLAYS])
    return run_ranks({k: log_desc(v) for k, v in logs.items()}, reqs,
                     whole=True)


@pytest.fixture(scope="module")
def ranks(group):
    return dict(zip(CASES, group["results"]))


def test_measuring_replays_keep_their_inputs_apart_from_the_timing(group):
    """A ``sample`` replay keeps the exchange kernels' inputs and reports
    no seconds; a ``collectives`` replay times each collective; the timed
    requests carry neither, and every replay gives the timed answer."""
    results = group["results"]
    for r in results[:len(CASES)]:
        assert r["seconds"] > 0 and "collectives" not in r
    for (case, flags), r in zip(REPLAYS, results[len(CASES):]):
        timed = results[CASES.index(case)]
        np.testing.assert_array_equal(r["result"], timed["result"])
        assert r["steps"] == timed["steps"] and r["seconds"] is None
        if flags.get("collectives"):
            calls = {k: v[0] for k, v in r["collectives"].items()}
            # CC reads both directions: two all_to_alls a superstep (one
            # state leaf); a halting all_reduce a superstep; the results'
            # all_gather at the end
            assert calls["all_to_all"] == 2 * r["steps"]
            assert calls["all_gather"] >= 1 and calls["all_reduce"] >= 1
            assert all(v[1] >= 0 for v in r["collectives"].values())
    samples = group["samples"]
    assert set(samples) == {"halo_pack", "frontier_compact",
                            "frontier_merge_min"}
    a, send = samples["halo_pack"][1]
    assert samples["halo_pack"][0] == a.numel()
    assert exchange.halo_pack_plain(a, send).shape[:2] == (send.shape[0],
                                                           a.shape[0])


def test_zipf_stream_is_the_bench_stream(logs):
    src, dst, ts = zipf_hub_arrays(**ZIPF)
    cols = logs["zipf"].arrays()
    np.testing.assert_array_equal(cols["src"], src)
    np.testing.assert_array_equal(cols["time"], ts)
    from raphtory_tpu_torch.utils.synth import zipf_hub_log

    got = zipf_hub_log(**ZIPF).arrays()
    for k in ("time", "kind", "src", "dst"):
        np.testing.assert_array_equal(got[k], cols[k])


@pytest.mark.parametrize("case", [c for c in CASES if c[3] == "sparse"],
                         ids=lambda c: f"{c[0]}-{c[1]}-{c[2][1]}x{c[2][0]}")
def test_sparse_route_is_bitwise_the_dense_routes_and_reference(
        ranks, logs, case):
    log_name, p, (S, W), _ = case
    got = ranks[case]
    dense = ranks[(log_name, p, (S, W), "all_gather")]
    assert got["steps"] == dense["steps"]
    np.testing.assert_array_equal(got["result"], dense["result"])
    if (log_name, p, (S, W), "halo") in ranks:
        np.testing.assert_array_equal(
            got["result"], ranks[(log_name, p, (S, W), "halo")]["result"])
    T, windows = query(log_name)
    jprog = program(log_name, p)
    want, wsteps = jsharded.run(jprog, jbuild_view(logs[log_name], T),
                                jax_mesh(S, W), windows=windows,
                                comm="sparse")
    np.testing.assert_array_equal(got["result"], np.asarray(want))
    assert got["steps"] == int(wsteps)
    # the 4-rank exchange accounting, the reference's formula: B slots per
    # rank a superstep (each a power of two >= the floor), 16 bytes of
    # counts per rank a superstep
    acct = got["routes"][f"sparse/{jprog.direction}"]
    assert acct["supersteps"] == got["steps"] and acct["dispatches"] == 1
    slot = 8 + np.asarray(want).dtype.itemsize
    assert acct["rows"] % 4 == 0
    assert acct["bytes"] == acct["rows"] * slot + 16 * 4 * got["steps"]


# ---------------------------------------------------------------- twins

def _frontiers(n, rng):
    yield np.zeros(n, bool)
    yield np.ones(n, bool)
    one = np.zeros(n, bool)
    one[n // 3] = True
    yield one
    yield rng.random(n) < 0.1


@pytest.mark.parametrize("dtype", [np.int32, np.float32])
@pytest.mark.parametrize("trail", [(), (3,)])
def test_frontier_compact_is_flatnonzero(dtype, trail):
    rng = np.random.default_rng(1)
    n = 10_000
    values = (rng.random((n,) + trail) * 1000).astype(dtype)
    ident = exchange.min_identity(torch.from_numpy(values).dtype)
    for changed in _frontiers(n, rng):
        idx = np.flatnonzero(changed)
        B = partition.frontier_bucket(len(idx), 256, cap=n)
        counted = exchange.frontier_count(torch.from_numpy(changed))
        assert counted.total == len(idx)
        got_i, got_v = exchange.frontier_compact(
            torch.from_numpy(values), torch.from_numpy(changed), B, ident,
            counted)
        want_v = np.full((B,) + trail, ident, dtype)
        want_v[:len(idx)] = values[idx]
        want_i = np.zeros(B, np.int64)
        want_i[:len(idx)] = idx
        np.testing.assert_array_equal(got_i.numpy(), want_i)
        np.testing.assert_array_equal(got_v.numpy(), want_v)
    with pytest.raises(ValueError, match="bucket"):
        exchange.frontier_compact(torch.from_numpy(values),
                                  torch.ones(n, dtype=torch.bool), 8, ident)


@pytest.mark.parametrize("dtype", [np.int32, np.float32])
@pytest.mark.parametrize("trail", [(), (2,)])
def test_frontier_merge_min_is_minimum_at(dtype, trail):
    rng = np.random.default_rng(2)
    n, R, B = 4096, 4, 512
    replica = (rng.random((n,) + trail) * 100).astype(dtype)
    ident = np.asarray(exchange.min_identity(
        torch.from_numpy(replica).dtype), dtype)
    for frontier_kind in range(4):
        owners = rng.integers(0, R, n)       # each row has one owner
        counts = np.zeros(R, np.int64)
        idx = np.zeros((R, B), np.int64)
        val = np.full((R, B) + trail, ident, dtype)
        for r in range(R):
            rows = np.flatnonzero(owners == r)
            rows = (rows[:0] if frontier_kind == 0 else rows[:1]
                    if frontier_kind == 1 else rows[:B])
            if frontier_kind == 3:
                rows = rows[rng.random(len(rows)) < 0.5]
            counts[r] = len(rows)
            idx[r, :len(rows)] = rows
            val[r, :len(rows)] = (rng.random((len(rows),) + trail)
                                  * 120).astype(dtype)
        want = replica.copy()
        live = np.arange(B)[None, :] < counts[:, None]
        np.minimum.at(want, idx[live], val[live])
        got = torch.from_numpy(replica.copy())
        exchange.frontier_merge_min(got, torch.from_numpy(idx.reshape(-1)),
                                    torch.from_numpy(val.reshape(
                                        (-1,) + trail)),
                                    torch.from_numpy(counts))
        np.testing.assert_array_equal(got.numpy(), want)


def test_halo_pack_twin_gathers_the_send_rows():
    rng = np.random.default_rng(3)
    for dtype in (np.int32, np.float32, np.int64):
        a = (rng.random((3, 64, 2)) * 1e6).astype(dtype)
        send = rng.integers(0, 64, 4 * 8).astype(np.int32)
        got = exchange.halo_pack(torch.from_numpy(a), torch.from_numpy(send))
        np.testing.assert_array_equal(got.numpy(),
                                      a[:, send].transpose(1, 0, 2))


# ---------------------------------------------------------------- accounting

def _route_delta(before, after, key):
    return {f: after[key][f] - before.get(key, {}).get(f, 0)
            for f in ("dispatches", "supersteps", "rows", "bytes")}


@pytest.mark.parametrize("name", ["cc", "bfs"])
def test_one_process_accounting_matches_reference(logs, name):
    """A one-rank sparse dispatch accounts what the reference's
    one-process dispatch does: the whole-sweep branch, then the exchange
    branch forced with ``multi=True`` (``run_sparse`` called directly)."""
    jlog = logs["adv"]
    jprog = PROGRAMS[name]
    jview = jbuild_view(jlog, ADV_T)
    view = build_view(port_log(jlog), ADV_T)
    mesh = sharded.make_mesh(1, 1, device="cpu")
    key = f"sparse/{jprog.direction}"
    jb, b = (m.COLLECTIVES.snapshot()["routes"] for m in (jsharded, sharded))
    want, wsteps = jsharded.run(jprog, jview, jax_mesh(4, 1),
                                windows=ADV_WINDOWS, comm="sparse")
    got, steps = sharded.run(port_prog(jprog), view, mesh,
                             windows=ADV_WINDOWS, comm="sparse")
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert steps == int(wsteps)
    assert _route_delta(b, sharded.COLLECTIVES.snapshot()["routes"], key) \
        == _route_delta(jb, jsharded.COLLECTIVES.snapshot()["routes"], key)
    jres, jsteps, jacct = jfrontier.run_sparse(
        jprog, jview, jax_mesh(4, 1), jsharded.partition_view(
            jview, 4, tuple(jprog.edge_props)), ADV_WINDOWS, multi=True)
    res, psteps, acct = frontier.run_sparse(
        port_prog(jprog), view, mesh, sharded.partition_view(
            view, 1, tuple(jprog.edge_props)), ADV_WINDOWS, multi=True)
    np.testing.assert_array_equal(res.numpy(), np.asarray(jres))
    assert psteps == jsteps
    for f in ("rows", "bytes", "supersteps", "fallback_supersteps",
              "processes"):
        assert acct[f] == jacct[f], f
    assert acct["density"] == pytest.approx(jacct["density"], abs=0)


# ---------------------------------------------------------------- chooser

def test_frontier_bucket_ladder_matches_reference(monkeypatch):
    for count in (0, 1, 16, 17, 300, 1000, 5000):
        for floor in (None, 8, 16, 256):
            for cap in (None, 300, 4096):
                assert partition.frontier_bucket(count, floor, cap) == \
                    jpartition.frontier_bucket(count, floor, cap)
    for knob in ("32", "junk", "2", ""):
        monkeypatch.setenv("RTPU_SPARSE_BUCKETS", knob)
        assert partition.sparse_bucket_floor() == \
            jpartition.sparse_bucket_floor()


def test_choose_route_records_match_reference(logs, monkeypatch):
    """The reference's decision table (``test_sparse_route.py``), each
    record equal field for field, on a 4-device one-process mesh (the port
    told the same device and process counts)."""
    monkeypatch.setenv("RTPU_SPARSE_BUCKETS", "8")
    jlog = logs["adv"]
    jview = jbuild_view(jlog, ADV_T)
    view = build_view(port_log(jlog), ADV_T)
    jmesh = jax_mesh(4, 1)
    jsv = jsharded.partition_view(jview, 4)
    sv = sharded.partition_view(view, 4)
    like = types.SimpleNamespace(shape={"windows": 1, "vertices": 4},
                                 n_devices=4, n_processes=1)
    jsharded.COLLECTIVES.clear()
    sharded.COLLECTIVES.clear()
    cc, pr = JCC(max_steps=40), JPageRank(max_steps=5)
    cases = [(cc, "all_gather", True, "auto", 0.001),
             (cc, "auto", True, "sparse", None),
             (cc, "halo", True, "sparse", None),
             (pr, "auto", True, "sparse", None),
             (cc, "auto", True, "auto", 0.01),
             (cc, "auto", True, "auto", 1.0),
             (cc, "auto", False, "auto", 0.01),
             (pr, "auto", True, "auto", 0.01),
             (cc, "auto", True, "auto", None),
             (cc, "auto", True, "bogus", None)]
    for jprog, requested, multi, env, hint in cases:
        want = jsharded.choose_route(jprog, jview, jsv, jmesh, requested, 2,
                                     multi, env=env, density_hint=hint)
        got = sharded.choose_route(port_prog(jprog), view, sv, like,
                                   requested, 2, multi, env=env,
                                   density_hint=hint)
        assert got == want
    with pytest.raises(ValueError, match="monotone_min"):
        sharded.choose_route(port_prog(pr), view, sv, like, "sparse", 2,
                             True)


def test_measured_density_feeds_the_next_decision(logs):
    jlog = logs["adv"]
    view = build_view(port_log(jlog), ADV_T)
    mesh = sharded.make_mesh(1, 1, device="cpu")
    prog = port_prog(PROGRAMS["cc"])
    sv = sharded.partition_view(view, 1)
    key = sharded.choose_route(prog, view, sv, mesh, "auto", 1, True)["key"]
    sharded.run(prog, view, mesh, comm="sparse")
    assert sharded.COLLECTIVES.frontier_hint(key) is not None
    d = sharded.choose_route(prog, view, sv, mesh, "auto", 1, True)
    assert d["evidence"]["density_measured"] is True
    counts = sharded.COLLECTIVES.snapshot()["route_table"]["counts"]
    assert counts.get("ConnectedComponents/sparse", 0) >= 1
