"""The kernels' plain twins (``raphtory_tpu_torch/ops/columns.py``) and the
power iteration around them against the JAX package's jitted functions on
the same numpy inputs: K1 bitwise, K2 within the reference's own PageRank
tolerance (rtol 1e-5 / atol 1e-7, ``tests/test_hopbatch.py:145`` — f32 sums
in another order) with equal superstep counts."""

import ctypes
import functools
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_sweep import random_log

from raphtory_tpu.engine import hopbatch as jhb
from raphtory_tpu.utils.synth import gab_like_log
from raphtory_tpu_torch.core import bulk as tbulk
from raphtory_tpu_torch.engine import hopbatch as thb
from raphtory_tpu_torch.engine.device_sweep import GlobalTables
from raphtory_tpu_torch.core.sweep import SweepBuilder
from raphtory_tpu_torch.interop import event_log_from_arrays
from raphtory_tpu_torch.ops import columns
from raphtory_tpu_torch.ops import partition as part

T = torch.from_numpy


def _k1_inputs(rng, tdt, length, H, W):
    info = np.iinfo(tdt)
    edge = np.array([info.min, info.min + 1, info.max - 1, info.max],
                    np.int64)
    vals = np.concatenate([edge, rng.integers(-100, 100, 40)])
    base_lat = rng.choice(vals, length).astype(tdt)
    base_alive = rng.random(length) < 0.6
    deltas = []
    for _ in range(H):
        k = int(rng.integers(0, length // 2))
        deltas.append((rng.choice(length, k, replace=False).astype(np.int32),
                       rng.choice(vals, k).astype(tdt),
                       rng.random(k) < 0.5))
    if tdt == np.int32:
        hops = np.array([info.max - 2, 0, info.min + 2, 50][:H], np.int64)
    else:
        hops = np.array([1 << 61, 0, -(1 << 61), 50][:H], np.int64)
    windows = [-1, 0, 1 << 40, 20][:W]
    return base_lat, base_alive, deltas, hops, windows


@functools.lru_cache(maxsize=None)
def _jax_k1(tdt, H, W, h0):
    return jax.jit(functools.partial(jhb._masks_from_deltas,
                                     jnp.dtype(tdt), H, W, h0=h0))


@pytest.mark.parametrize("h0", [False, True])
@pytest.mark.parametrize("tdt", [np.int32, np.int64], ids=["i32", "i64"])
@pytest.mark.parametrize("seed", [0, 1])
def test_masks_from_deltas_twin_bitwise(seed, tdt, h0):
    rng = np.random.default_rng(seed)
    H, W = 4, 3
    inputs = {}
    for side, length in (("e", 300), ("v", 64)):
        base_lat, base_alive, deltas, hops, windows = _k1_inputs(
            rng, tdt, length, H, W)
        # the port's padding is the reference's, bitwise
        U, pos, lat, alive = jhb._pad_hop_deltas(deltas, H, tdt)
        for a, b in zip((U, pos, lat, alive),
                        thb._pad_hop_deltas(deltas, H, tdt)):
            np.testing.assert_array_equal(a, b)
        inputs[side] = (base_lat, base_alive, pos, lat, alive)
    _, C, _, T_col, w_col = thb._column_layout(hops, windows)
    me, mv, adv = _jax_k1(tdt, H, W, h0)(*inputs["e"][:2], *inputs["v"][:2],
                                         *inputs["e"][2:], *inputs["v"][2:],
                                         T_col, w_col)
    info = np.iinfo(tdt)
    lo = T(np.clip(T_col - w_col, info.min, info.max).astype(tdt))
    nowin = T(w_col < 0)
    for side, want_mask, want_adv in (("e", me, adv[:2]),
                                      ("v", mv, adv[2:])):
        mask, lat, alive = columns.masks_from_deltas(
            *(T(a) for a in inputs[side]), lo, nowin, H, W, h0)
        np.testing.assert_array_equal(mask.numpy(), np.asarray(want_mask))
        np.testing.assert_array_equal(lat.numpy(), np.asarray(want_adv[0]))
        np.testing.assert_array_equal(alive.numpy(),
                                      np.asarray(want_adv[1]))
        assert lat.dtype == T(inputs[side][0]).dtype


def _k1_hops(rng, tdt, length, H, W, hot=5, share=3):
    """K1 inputs over ``H`` hops: deltas at random positions plus ``hot``
    positions every hop touches (several hops in a row, hop 0 among them,
    which applies only with ``h0``; up to ``length / share`` a hop), lat at
    the dtype's limits among small values; hop times and windows reaching
    the limits too (``lo`` clips)."""
    info = np.iinfo(tdt)
    edge = np.array([info.min, info.min + 1, info.max - 1, info.max],
                    np.int64)
    vals = np.concatenate([edge, rng.integers(-100, 100, 40)])
    base_lat = rng.choice(vals, length).astype(tdt)
    base_alive = rng.random(length) < 0.6
    deltas = []
    for _ in range(H):
        k = int(rng.integers(0, length // share))
        pos = np.unique(np.concatenate([
            np.arange(hot), rng.choice(length, k, replace=False)]))
        pos = rng.permutation(pos).astype(np.int32)
        deltas.append((pos, rng.choice(vals, len(pos)).astype(tdt),
                       rng.random(len(pos)) < 0.5))
    span = (1 << 61) if tdt == np.int64 else (1 << 29)
    hops = rng.integers(-span, span, H)
    hops[: min(H, 3)] = [info.max - 2, info.min + 2, 0][: min(H, 3)]
    windows = [-1, 0, 1 << 40, 20][:W]
    return base_lat, base_alive, deltas, hops, windows


def _k1_call(tdt, H, W, h0, base_lat, base_alive, deltas, hops, windows):
    """(the wrapper's torch inputs, the JAX function's answer) of one
    table's K1 call."""
    _, pos, lat, alive = thb._pad_hop_deltas(deltas, H, tdt)
    _, C, _, T_col, w_col = thb._column_layout(hops, windows)
    info = np.iinfo(tdt)
    lo = np.clip(T_col - w_col, info.min, info.max).astype(tdt)
    args = tuple(T(a) for a in (base_lat, base_alive, pos, lat, alive, lo,
                                w_col < 0))
    return args, T_col, w_col


@pytest.mark.parametrize("tdt,H,h0", [
    (np.int32, 1, False), (np.int32, 1, True), (np.int32, 33, True),
    (np.int32, 65, False), (np.int64, 1, True), (np.int64, 33, False),
    (np.int64, 65, True)], ids=lambda v: getattr(v, "__name__", str(v)))
def test_masks_from_deltas_twin_bitwise_across_hops(tdt, H, h0):
    """The twin against the JAX ``_masks_from_deltas`` at H = 1, 33 and 65
    (one, two and three of the kernel's hop groups), with positions every
    hop touches and hop-0 deltas that apply only with ``h0``: masks and
    advanced state bitwise, for int32 and int64 times at their limits."""
    rng = np.random.default_rng(H)
    W = 3
    sides = {side: _k1_hops(rng, tdt, length, H, W)
             for side, length in (("e", 120), ("v", 40))}
    hops, windows = sides["e"][3:]
    calls = {side: _k1_call(tdt, H, W, h0, *v[:3], hops, windows)
             for side, v in sides.items()}
    T_col, w_col = calls["e"][1:]
    e_args, v_args = calls["e"][0], calls["v"][0]
    me, mv, adv = _jax_k1(tdt, H, W, h0)(
        *(a.numpy() for a in e_args[:2]), *(a.numpy() for a in v_args[:2]),
        *(a.numpy() for a in e_args[2:5]), *(a.numpy() for a in v_args[2:5]),
        T_col, w_col)
    for args, want_mask, want_adv in ((e_args, me, adv[:2]),
                                      (v_args, mv, adv[2:])):
        mask, lat, alive = columns.masks_from_deltas(*args, H, W, h0)
        np.testing.assert_array_equal(mask.numpy(), np.asarray(want_mask))
        np.testing.assert_array_equal(lat.numpy(), np.asarray(want_adv[0]))
        np.testing.assert_array_equal(alive.numpy(),
                                      np.asarray(want_adv[1]))


def test_masks_from_deltas_refuses_a_position_twice_in_a_hop():
    """The host fold emits each position once a hop; the twin refuses a
    delta that sets one twice (the kernel, which would race, relies on
    it)."""
    rng = np.random.default_rng(5)
    base_lat, base_alive, deltas, hops, windows = _k1_hops(
        rng, np.int32, 50, 2, 2)
    pos, lat, alive = deltas[1]
    deltas[1] = (np.concatenate([pos, pos[:1]]),
                 np.concatenate([lat, lat[:1]]),
                 np.concatenate([alive, alive[:1]]))
    args, _, _ = _k1_call(np.int32, 2, 2, False, base_lat, base_alive,
                          deltas, hops, windows)
    with pytest.raises(ValueError, match="hop 1 .* position twice"):
        columns.masks_from_deltas(*args, 2, 2)


def _tables(kind):
    if kind == "gab":
        jlog = gab_like_log(600, 5_000, t_span=1_000)
    else:
        jlog = random_log(np.random.default_rng(3), n_events=800, n_ids=60,
                          t_span=100)
    return GlobalTables(SweepBuilder(event_log_from_arrays(jlog.arrays()),
                                     track_rows=False, preseed_pairs=True))


@functools.lru_cache(maxsize=None)
def _jax_k2(n_pad, warm, max_steps):
    def run(me, mv, e_src, e_dst, r_init):
        return jhb._pagerank_columns(me, mv, e_src, e_dst, n_pad, 0.85, 1e-7,
                                     max_steps,
                                     r_init=r_init if warm else None,
                                     tile_budget=256 << 20)
    return jax.jit(run)


# max_steps=1 holds one superstep of the K2c twin (the epilogue after the
# pull-sum) against the reference loop body on its own
@pytest.mark.parametrize("max_steps", [1, 30])
@pytest.mark.parametrize("warm", [False, True])
@pytest.mark.parametrize("kind", ["gab", "random"])
def test_pagerank_columns_twin_matches_jax(kind, warm, max_steps):
    t = _tables(kind)
    rng = np.random.default_rng(7)
    C = 6
    me = rng.random((t.m_pad, C)) < 0.7
    me[t.m:] = False
    me[:, 2] = False                       # an all-masked edge column
    mv = rng.random((t.n_pad, C)) < 0.8
    mv[t.n:] = False
    mv[:, 4] = False                       # an empty view
    r_init = (rng.random((t.n_pad, C)) * 1e-3).astype(np.float32)
    want, want_steps = _jax_k2(t.n_pad, warm, max_steps)(
        me, mv, t.e_src, t.e_dst, r_init)
    got, steps = thb._pagerank_columns(
        T(me), T(mv), T(t.e_src), T(t.e_dst), T(t.in_indptr), t.n_pad, 0.85,
        1e-7, max_steps, r_init=T(r_init) if warm else None)
    assert got.shape == (C, t.n_pad)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-7)
    assert steps == int(want_steps)


@pytest.mark.parametrize("kind", ["gab", "random"])
def test_edge_pass_twins_match_jax_segment_sums(kind):
    t = _tables(kind)
    rng = np.random.default_rng(11)
    C = 5
    me = rng.random((t.m_pad, C)) < 0.5
    me[t.m:] = False
    rd = (rng.random((t.n_pad, C)) * 1e-2).astype(np.float32)
    want_deg = jax.ops.segment_sum(me.astype(np.float32), t.e_src,
                                   num_segments=t.n_pad)
    deg = columns.column_out_degree(T(me), T(t.e_src), t.n_pad)
    np.testing.assert_array_equal(deg.numpy(), np.asarray(want_deg))
    want_agg = jax.ops.segment_sum(
        jnp.where(me, rd[t.e_src, :], 0.0), t.e_dst, num_segments=t.n_pad,
        indices_are_sorted=True)
    agg = columns.column_pull_sum(T(me), T(rd), T(t.e_src), T(t.e_dst),
                                  T(t.in_indptr))
    np.testing.assert_allclose(agg.numpy(), np.asarray(want_agg), rtol=1e-5,
                               atol=1e-7)


def test_wrappers_check_inputs_and_count_only_launches():
    columns.reset_launches()
    me = torch.ones((8, 2), dtype=torch.bool)
    src = torch.zeros(8, dtype=torch.int32)
    with pytest.raises(TypeError, match="dtype"):
        columns.column_out_degree(me, src.long(), 4)
    with pytest.raises(ValueError, match="contiguous"):
        columns.column_out_degree(torch.ones((2, 8), dtype=torch.bool).t(),
                                  src, 4)
    with pytest.raises(ValueError, match="shape"):
        columns.column_pull_sum(me, torch.zeros((4, 2)), src, src,
                                torch.zeros(4, dtype=torch.int64))
    with pytest.raises(ValueError, match="device"):
        columns._on_cuda("x", torch.zeros(1, device="meta"))
    # CPU tensors run the twin, which is no kernel launch
    assert columns.column_out_degree(me, src, 4)[0].tolist() == [8.0, 8.0]
    assert columns.LAUNCHES == {k: 0 for k in columns.LAUNCHES}


def test_masks_twin_refuses_duplicate_positions():
    z = torch.zeros(4, dtype=torch.int32)
    pos = torch.tensor([[1, 1]], dtype=torch.int32).repeat(2, 1)
    with pytest.raises(ValueError, match="twice"):
        columns.masks_from_deltas(
            z, torch.zeros(4, dtype=torch.bool), pos,
            torch.zeros((2, 2), dtype=torch.int32),
            torch.ones((2, 2), dtype=torch.bool),
            torch.zeros(2, dtype=torch.int32),
            torch.zeros(2, dtype=torch.bool), 2, 1, False)


def test_pagerank_update_twin_freezes_halts_and_primes():
    rng = np.random.default_rng(5)
    n, C = 40, 3
    mv = T(rng.random((n, C)) < 0.7)
    mv[:, 2] = False                                  # an empty view
    deg = T(rng.integers(0, 3, (n, C)).astype(np.float32))
    n_act = torch.clamp(mv.float().sum(0), min=1.0)
    r = torch.where(mv, 1.0 / n_act, 0.0)
    st = columns.rank_state(r.clone())
    columns.pagerank_update(st, None, deg, mv, n_act, 0.85, 1e-7, prime=True)
    # prime derives the pull-sum input and the dangling mass, nothing else
    assert torch.equal(st.r, r)
    assert torch.equal(st.rd, r * (1.0 / torch.clamp(deg, min=1.0)))
    torch.testing.assert_close(
        st.dangling, torch.where(mv & (deg == 0), r, 0.0).sum(0))
    assert not st.halted.any() and not bool(st.done)
    st.halted[0] = True                               # column 0 is frozen
    agg = T(rng.random((n, C)).astype(np.float32) * 1e-2)
    columns.pagerank_update(st, agg, deg, mv, n_act, 0.85, 1e-7)
    assert torch.equal(st.r[:, 0], r[:, 0])
    assert not torch.equal(st.r[:, 1], r[:, 1])
    assert (st.r[:, 2] == 0).all()
    # column 2 has no alive vertex: it halts at once; column 1 moved
    assert st.halted.tolist() == [True, False, True]
    assert not bool(st.done)


def test_pagerank_update_checks_inputs_and_sizes_its_scratch():
    columns.reset_launches()
    for n, C in ((10, 12), (32_768, 12), (5, 300), (100_000, 1), (0, 4),
                 (5_308_416, 128), (7, 2_000_000)):
        gx = columns.update_grid(n, C)
        quads = -(-C // 4)
        tile = min(quads, 256)
        rows, tiles = 256 // tile, -(-quads // tile)
        # at most 264 blocks a grid (2 an SM) where the column tiles leave
        # room, every row reached, 4 rows a thread before the grid grows
        assert 1 <= gx and (gx == 1 or gx * tiles <= 264)
        assert gx * rows * 4 >= n or gx == max(1, 264 // tiles)
        assert gx == 1 or (gx - 1) * rows * 4 < n
        if n * C <= 10**6:
            st = columns.rank_state(torch.zeros((n, C)))
            assert st.part.shape == st.busy.shape == (gx, C)
            assert st.part.dtype == torch.float64
            assert st.busy.dtype == torch.int32
    st = columns.rank_state(torch.zeros((4, 2)))
    mv = torch.ones((4, 2), dtype=torch.bool)
    deg, n_act = torch.ones((4, 2)), torch.ones(2)
    with pytest.raises(TypeError, match="agg"):
        columns.pagerank_update(st, None, deg, mv, n_act, 0.85, 1e-7)
    with pytest.raises(TypeError, match="deg"):
        columns.pagerank_update(st, None, deg.double(), mv, n_act, 0.85,
                                1e-7, prime=True)
    with pytest.raises(ValueError, match="n_act"):
        columns.pagerank_update(st, None, deg, mv, torch.ones(3), 0.85, 1e-7,
                                prime=True)
    columns.pagerank_update(st, torch.zeros((4, 2)), deg, mv, n_act, 0.85,
                            1e-7)
    assert columns.LAUNCHES == {k: 0 for k in columns.LAUNCHES}


#: (n, C) -> K2c's blocks along the rows: whole rows of ceil(C / 4) quads
#: a block of 256 threads, 4 rows a thread, 264 blocks at most
_GRIDS = {(4_099, 1): 5, (4_099, 9): 13, (4_099, 128): 129,
          (4_099, 300): 264, (5_308_416, 1): 264, (5_308_416, 9): 264,
          (5_308_416, 128): 264, (5_308_416, 300): 264, (3, 300): 1}


@pytest.mark.parametrize("C", [1, 9, 128, 300])
def test_update_grid_and_scratch_at_each_column_count(C, monkeypatch):
    """K2c's grid and its cross-block scratch at the column counts the
    engines give it (one column, a K12 rank's 9, the scale sweep's 128,
    past a 256-column tile): the wrapper hands the kernel ``update_grid``
    blocks and ``[gx, C]`` f64 / int32 partials, one launch a call."""
    for n in (4_099, 5_308_416, 3):
        if (n, C) in _GRIDS:
            assert columns.update_grid(n, C) == _GRIDS[n, C]
    n = 4_099
    gx = columns.update_grid(n, C)
    rng = np.random.default_rng(C)
    mv = T(rng.random((n, C)) < 0.8)
    deg = T(rng.integers(0, 3, (n, C)).astype(np.float32))
    n_act = torch.clamp(mv.float().sum(0), min=1.0)
    st = columns.rank_state(torch.where(mv, 1.0 / n_act, 0.0))
    assert (st.part.shape, st.part.dtype) == ((gx, C), torch.float64)
    assert (st.busy.shape, st.busy.dtype) == ((gx, C), torch.int32)
    calls = []

    def kernel(*args):
        calls.append(args)
        return 0
    monkeypatch.setattr(columns, "_on_cuda", lambda name, *t: True)
    monkeypatch.setattr(columns, "_stream", lambda t: 0)
    monkeypatch.setattr(columns, "_fn", lambda lib, fn: kernel)
    columns.reset_launches()
    columns.pagerank_update(st, None, deg, mv, n_act, 0.85, 1e-7, prime=True)
    columns.pagerank_update(st, torch.zeros((n, C)), deg, mv, n_act, 0.85,
                            1e-7)
    assert columns.LAUNCHES["pagerank_update"] == 2
    (a0, a1) = calls
    assert a0[:4] == (n, C, gx, 1) and a1[:4] == (n, C, gx, 0)
    assert a0[7] is None and a1[7] is not None      # agg only to update
    assert a1[16:19] == (st.part.data_ptr(), st.busy.data_ptr(),
                         st.ticket.data_ptr())
    st.part = torch.empty((gx, C), dtype=torch.float32)
    with pytest.raises(TypeError, match="part"):
        columns.pagerank_update(st, None, deg, mv, n_act, 0.85, 1e-7,
                                prime=True)
    columns.reset_launches()


# ---------------------------------------------------- K2a's source walk

def _bulk():
    """A bulk graph with pad edges (m < m_pad)."""
    rng = np.random.default_rng(4)
    src = rng.integers(0, 50, 2000).astype(np.int64)
    dst = rng.integers(0, 50, 2000).astype(np.int64)
    times = np.sort(rng.integers(0, 300, 2000)).astype(np.int64)
    bulk = tbulk.bulk_hop_deltas(src, dst, times, [150, 299])[0]
    assert bulk.m < bulk.m_pad
    return bulk


def _walk_of(kind):
    """(e_src, walk, the real rows) of each source of K2a's walk: a
    GlobalTables' ``out_indptr``/``out_perm``, a bulk graph's
    ``source_walk``, a layout with cap-pad slots' ``walk(reverse=True)``."""
    if kind == "tables":
        t = _tables("gab")
        return (t.e_src, (T(t.out_indptr), T(t.out_perm)), np.arange(t.m),
                t.n_pad)
    if kind == "bulk":
        b = _bulk()
        e_src = T(b.e_src)
        return (b.e_src, columns.source_walk(e_src, b.m, b.n_pad),
                np.arange(b.m), b.n_pad)
    t = _tables("gab")
    lay = part.build_layout(t.e_src, t.e_dst, t.n_pad, t.m, 16)
    assert not lay.valid.all()                 # cap-pad slots
    return (lay.b_src, tuple(map(T, lay.walk(True))),
            np.flatnonzero(lay.valid), t.n_pad)


@pytest.mark.parametrize("kind", ["tables", "bulk", "layout"])
def test_source_walk_lists_each_real_row_once_by_source(kind):
    """Every real edge (or slot) once, grouped by ascending source with the
    CSR's runs, each source's rows in table order; no pad row."""
    e_src, (indptr, order), real, n_pad = _walk_of(kind)
    order, indptr = order.numpy(), indptr.numpy()
    assert order.dtype == np.int32 and indptr.dtype == np.int64
    np.testing.assert_array_equal(np.sort(order), real)
    srcs = e_src[order]
    assert (np.diff(srcs) >= 0).all()
    np.testing.assert_array_equal(np.repeat(np.arange(n_pad),
                                            np.diff(indptr)), srcs)
    # stable: within a source, the rows in table order
    same = np.diff(srcs) == 0
    assert (np.diff(order)[same] > 0).all()
    np.testing.assert_array_equal(order, real[np.argsort(e_src[real],
                                                         kind="stable")])
    columns._check_walk("test", T(np.ascontiguousarray(e_src)),
                        (T(indptr), T(order)), n_pad)


def test_source_walk_of_tables_is_their_out_perm():
    t = _tables("random")
    e_src = T(t.e_src)
    indptr, order = columns.source_walk(e_src, t.m, t.n_pad)
    assert torch.equal(order, T(t.out_perm))
    assert torch.equal(indptr, T(t.out_indptr))
    # built once and cached with the table
    assert columns.source_walk(e_src, t.m, t.n_pad)[1] is order


def _out_degree_by_walk(me, walk):
    """The out-degree summed over the source walk, a run of rows a
    source: ``me``'s rows gathered in walk order, integer prefix sums,
    their differences at the CSR offsets."""
    indptr, order = walk
    rows = me[order.long()].to(torch.int64)
    cs = torch.cat([torch.zeros((1, me.shape[1]), dtype=torch.int64),
                    rows.cumsum(0)])
    return (cs[indptr[1:]] - cs[indptr[:-1]]).to(torch.float32)


@pytest.mark.parametrize("kind", ["gab", "random"])
def test_out_degree_through_the_walk_matches_jax_segment_sum(kind):
    t = _tables(kind)
    rng = np.random.default_rng(11)
    C = 5
    me = rng.random((t.m_pad, C)) < 0.5
    me[t.m:] = False
    want = np.asarray(jax.ops.segment_sum(me.astype(np.float32), t.e_src,
                                          num_segments=t.n_pad))
    walk = (T(t.out_indptr), T(t.out_perm))
    got = _out_degree_by_walk(T(me), walk)
    np.testing.assert_array_equal(got.numpy(), want)
    # the wrapper with the walk (the twin on the CPU, the walk checked)
    deg = columns.column_out_degree(T(me), T(t.e_src), t.n_pad, walk)
    np.testing.assert_array_equal(deg.numpy(), want)


def test_out_degree_refuses_a_bad_walk(monkeypatch):
    t = _tables("random")
    me = torch.ones((t.m_pad, 2), dtype=torch.bool)
    e_src = T(t.e_src)
    indptr, order = T(t.out_indptr), T(t.out_perm)

    def refused(walk, match, exc=ValueError):
        with pytest.raises(exc, match=match):
            columns.column_out_degree(me, e_src, t.n_pad, walk)

    # two rows of different sources swapped: sources out of order
    k = int(np.flatnonzero(np.diff(t.e_src[t.out_perm]) > 0)[0])
    swapped = order.clone()
    swapped[[k, k + 1]] = swapped[[k + 1, k]]
    refused((indptr, swapped), "ascending source order")
    twice = order.clone()
    twice[1] = twice[0]
    refused((indptr, twice), "twice")
    refused((indptr[:-1], order), "out_indptr")
    shifted = indptr.clone()
    shifted[1:-1] += 1
    shifted[1:-1] = torch.minimum(shifted[1:-1], indptr[-1])
    refused((shifted, order), "does not match")
    # a real edge left out: the walk is shorter than the real row count
    short = indptr.clone()
    last = int(t.e_src[t.out_perm[-1]])
    short[last + 1:] -= 1
    refused((short, order[:-1]), "leaves out a real row")
    refused((indptr, order.long()), "dtype", TypeError)
    out = order.clone()
    out[0] = t.m_pad
    refused((indptr, out), "outside")
    # a walk that passed, then changed in place, is checked again
    walk = (indptr, order.clone())
    columns.column_out_degree(me, e_src, t.n_pad, walk)
    walk[1][[k, k + 1]] = walk[1][[k + 1, k]]
    refused(walk, "ascending source order")
    # the card branch counts over a walk and has none to fall back on
    monkeypatch.setattr(columns, "_on_cuda", lambda name, *ts: True)
    with pytest.raises(ValueError, match="source walk"):
        columns.column_out_degree(me, e_src, t.n_pad)


def _c_params(src: str, fn: str):
    """The parameter declarations of C entry point ``fn`` in ``src``."""
    m = re.search(r"\bint\s+" + fn + r"\s*\(([^)]*)\)\s*\{", src)
    assert m, f"{fn} not found"
    return [p.strip() for p in m.group(1).split(",") if p.strip()]


def _ctype_of(param: str):
    """The ctypes type a C parameter declaration is bound with."""
    if re.match(r"(const\s+)?int64_t\s*\*", param):
        return ctypes.POINTER(ctypes.c_int64)
    if "*" in param:
        return ctypes.c_void_p
    return {"int64_t": ctypes.c_int64, "float": ctypes.c_float}[
        param.split()[0]]


@pytest.mark.parametrize("lib", sorted(columns._LIBS))
def test_argtypes_match_the_c_entry_points(lib):
    """Every C entry point is bound with one ctypes type a parameter, in
    order, as its source declares it: a wrong count or kind would pass
    garbage (or crash the process) on the card, where nothing else
    checks it."""
    cu, fns = columns._LIBS[lib]
    src = (columns._CSRC / cu).read_text()
    for fn in fns:
        want = [_ctype_of(p) for p in _c_params(src, fn)]
        assert columns._ARGTYPES[fn] == want, fn


# ------------------------------------- the card branch (modelled kernels)

def _view(addr, dtype, n):
    """``n`` elements of ``dtype`` at a host address, as numpy."""
    if not n:
        return np.zeros(0, dtype)
    nbytes = n * np.dtype(dtype).itemsize
    return np.ctypeslib.as_array((ctypes.c_uint8 * nbytes).from_address(
        addr)).view(dtype)


_TOUCH_DTYPES = {1: np.uint8, 4: np.uint32, 8: np.uint64}


def _k1_passes(n, H, W, U, h0, tw, bl, ba, p, lt, al, cell, l_out, a_out,
               words, o, order_rng):
    """The passes of ``k1_kernel`` (K1 and K6w) as numpy, for each group of
    ``8 * tw`` hops: pass A writes the group's columns from its base (group
    0: the base, copied into the advanced state; later groups: the advanced
    state) and clears the touch words; B0 (where more than one hop of the
    group applies) sets bit h of each update's row; B1, its updates taken
    in a random order, writes columns ``[h W, next W)`` of the row and the
    advanced state where no later hop of the group touches it. Pads
    (positions outside ``[0, len)``) and hop 0 without ``h0`` are skipped.
    A group whose one applied hop is its last, with dense updates (``U * 8
    >= len``), takes the dense path: the base copied into the advanced
    state, the updates scattered into it, one row pass split at the hop's
    first column. ``cell(values, alive, columns)`` is a state's cells (K6w:
    no alive, its value in every column). Returns the groups that took the
    dense path."""
    dense = []
    alive = ba is not None
    for g0 in range(0, H, 8 * tw):
        Hg = min(8 * tw, H - g0)
        cols = slice(g0 * W, (g0 + Hg) * W)
        src_l = bl if g0 == 0 else l_out.copy()
        src_a = (ba if g0 == 0 else a_out.copy()) if alive else None
        h1 = 1 if g0 == 0 and not h0 else 0
        ups = [(h, u) for h in range(h1, Hg) for u in range(U)
               if 0 <= p[g0 + h, u] < n]

        def upd(h, u):
            return lt[g0 + h, u], (al[g0 + h, u] if alive else None)

        def put_state(r, v, a):
            l_out[r] = v
            if alive:
                a_out[r] = a
        if U > 0 and Hg - h1 == 1 and U * 8 >= n:
            # dense: copy, scatter the one hop, a row pass split at it
            if g0 == 0:
                l_out[:] = bl
                if alive:
                    a_out[:] = ba
            for h, u in ups:
                put_state(p[g0 + h, u], *upd(h, u))
            pre = slice(g0 * W, (g0 + h1) * W)
            post = slice((g0 + h1) * W, (g0 + Hg) * W)
            o[:, pre] = cell(src_l, src_a, pre)
            o[:, post] = cell(l_out, a_out if alive else None, post)
            dense.append(g0)
            continue
        o[:, cols] = cell(src_l, src_a, cols)
        if g0 == 0:
            l_out[:] = bl
            if alive:
                a_out[:] = ba
        words[:] = 0
        if U <= 0 or Hg <= h1:
            continue
        if Hg - h1 > 1:                     # B0
            for h, u in ups:
                words[p[g0 + h, u]] |= _TOUCH_DTYPES[tw](1) << h
        for i in order_rng.permutation(len(ups)):
            h, u = ups[i]
            r = p[g0 + h, u]
            above = int(words[r]) >> (h + 1)
            nxt = h + 1 + ((above & -above).bit_length() - 1) if above \
                else Hg
            c = slice((g0 + h) * W, (g0 + nxt) * W)
            v, a = upd(h, u)
            o[r, c] = cell(v, a, c)
            if nxt == Hg:
                put_state(r, v, a)
    return dense


def _model_k1(calls, tdt, order_rng):
    """``rtpu_masks_from_deltas_*`` as numpy over the wrapper's raw host
    addresses: one launch of ``_k1_passes`` (grid syncs between them) with
    mask cells ``alive && lat >= thr``."""
    def model(n, H, W, U, h0, tw, base_l, base_a, pos, lat, alive, lo,
              nowin, adv_l, adv_a, touch, out, stream, launched):
        C = H * W
        dense = []
        calls.append(dict(base=(base_l, base_a), adv=(adv_l, adv_a),
                          touch=touch, out=out, tw=tw, H=H, n=n,
                          dense=dense))
        assert out % 16 == 0 and adv_l not in (base_l, base_a)
        thr = np.where(_view(nowin, np.uint8, C) != 0, np.iinfo(tdt).min,
                       _view(lo, tdt, C))

        def cell(v, a, c):
            return ((np.asarray(a)[..., None] != 0)
                    & (np.asarray(v)[..., None] >= thr[c]))
        dense += _k1_passes(
            n, H, W, U, h0, tw, _view(base_l, tdt, n),
            _view(base_a, np.uint8, n),
            _view(pos, np.int32, H * U).reshape(H, U).astype(np.int64),
            _view(lat, tdt, H * U).reshape(H, U),
            _view(alive, np.uint8, H * U).reshape(H, U), cell,
            _view(adv_l, tdt, n), _view(adv_a, np.uint8, n),
            _view(touch, _TOUCH_DTYPES[tw], n),
            _view(out, np.uint8, n * C).reshape(n, C), order_rng)
        launched._obj.value += 1                # one cooperative launch
        return 0
    return model


def _model_k6w(calls, order_rng):
    """``rtpu_weights_from_deltas`` as numpy over the wrapper's raw host
    addresses: one launch of ``_k1_passes`` with W 1 and the weight itself
    as the cell."""
    def model(n, H, U, h0, tw, base, pos, val, adv, touch, out, stream,
              launched):
        dense = []
        calls.append(dict(base=base, adv=adv, touch=touch, out=out, tw=tw,
                          dense=dense))
        assert out % 16 == 0 and adv != base

        def cell(v, a, c):
            v = np.asarray(v, np.float32)[..., None]
            return np.broadcast_to(v, v.shape[:-1] + (c.stop - c.start,))
        dense += _k1_passes(
            n, H, 1, U, h0, tw, _view(base, np.float32, n), None,
            _view(pos, np.int32, H * U).reshape(H, U).astype(np.int64),
            _view(val, np.float32, H * U).reshape(H, U), None, cell,
            _view(adv, np.float32, n), None,
            _view(touch, _TOUCH_DTYPES[tw], n),
            _view(out, np.float32, n * H).reshape(n, H), order_rng)
        launched._obj.value += 1                # one cooperative launch
        return 0
    return model


@pytest.mark.parametrize("h0", [False, True])
@pytest.mark.parametrize("H,length", [(1, 90), (1, 2100), (2, 90), (2, 2100),
                                      (4, 90), (9, 90), (33, 90), (70, 90)])
@pytest.mark.parametrize("tdt", [np.int32, np.int64], ids=["i32", "i64"])
def test_masks_from_deltas_card_branch_one_launch(monkeypatch, tdt, H, length,
                                                  h0):
    """K1's card branch on CPU tensors through the numpy model of its
    passes: bitwise the twin (negative and pad positions, positions touched
    in many hops, hop 0 without ``h0``, groups of hops chained past a touch
    word; a single applied hop on the dense path at 90 rows, the touch
    path at 2,100), one launch a call whatever H, the touch word sized to
    H, the advanced state written by the kernel into fresh tensors, no
    clone."""
    rng = np.random.default_rng(H)
    W = 3
    base_lat, base_alive, deltas, hops, windows = _k1_hops(
        rng, tdt, length, H, W, hot=7, share=3 if length == 90 else 60)
    deltas[-1] = (np.concatenate([deltas[-1][0], [-3, -1]]).astype(np.int32),
                  np.concatenate([deltas[-1][1], deltas[-1][1][:2]]),
                  np.concatenate([deltas[-1][2], [True, True]]))
    args, _, _ = _k1_call(tdt, H, W, h0, base_lat, base_alive, deltas, hops,
                          windows)
    want = columns.masks_from_deltas(*args, H, W, h0)
    calls = []
    monkeypatch.setattr(columns, "_on_cuda", lambda name, *ts: True)
    monkeypatch.setattr(columns, "_stream", lambda t: 0)
    monkeypatch.setattr(columns, "_TOUCH", {})
    monkeypatch.setattr(columns, "_fn", lambda lib, fn: _model_k1(
        calls, tdt, np.random.default_rng(0)))

    def no_clone(*a, **k):
        raise AssertionError("K1's card branch cloned a tensor")
    monkeypatch.setattr(torch.Tensor, "clone", no_clone)
    columns.reset_launches()
    got = columns.masks_from_deltas(*args, H, W, h0)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    tw = 1 if H <= 8 else 4 if H <= 32 else 8
    (call,) = calls
    assert call["tw"] == tw
    assert call["adv"] == (got[1].data_ptr(), got[2].data_ptr())
    assert call["base"] == (args[0].data_ptr(), args[1].data_ptr())
    (scratch,) = columns._TOUCH.values()
    assert call["touch"] == scratch.data_ptr()
    assert scratch.numel() >= length * tw
    assert columns.LAUNCHES["masks_from_deltas"] == 1
    single = H - (not h0) == 1
    assert call["dense"] == ([0] if single and length == 90 else [])
    columns.reset_launches()


def _k6w_inputs(rng, length, H, U, hot=5):
    """K6w's operands: an f32 base with -0.0 and an infinity, H hops of U
    (pos, val) updates with pads (2^31-1) and negative positions, ``hot``
    rows updated at many hops and the rest drawn afresh each hop."""
    base = (rng.random(length) * 6 - 2).astype(np.float32)
    base[:2] = [-0.0, np.inf]
    pos = np.full((H, U), 2**31 - 1, np.int32)
    val = np.zeros((H, U), np.float32)
    for h in range(H):
        k = int(rng.integers(0, U + 1))
        hot_rows = rng.choice(hot, min(hot, k), replace=False) + 2
        cold = rng.choice(np.arange(hot + 2, length), k - len(hot_rows),
                          replace=False)
        pos[h, :k] = np.concatenate([hot_rows, cold])
        val[h, :k] = rng.random(k) * 5 - 0.5
        if U >= 3 and h % 4 == 1:
            pos[h, -1] = -1 - h % 3              # outside [0, len)
    return T(base), T(pos), T(val)


@pytest.mark.parametrize("h0", [False, True])
@pytest.mark.parametrize("H,length,U", [(1, 90, 12), (2, 90, 12),
                                        (2, 2100, 12), (10, 3000, 40),
                                        (33, 500, 9), (70, 400, 9)])
def test_weights_from_deltas_card_branch_one_launch(monkeypatch, H, length,
                                                    U, h0):
    """K6w's card branch on CPU tensors through the numpy model of K1's
    passes with f32 cells: bitwise the twin (pads, negative positions, rows
    updated at many hops; groups of hops chained past a touch word at H 70;
    one applied hop on the dense path at 90 rows, the touch path at 2,100),
    one launch a call whatever H, the touch word sized to H, the advanced
    state written by the kernel into a fresh tensor, no clone, the checks
    made once per signature."""
    rng = np.random.default_rng(H * 7 + h0)
    args = _k6w_inputs(rng, length, H, U)
    want = columns.weights_from_deltas(*args, H, h0)
    calls = []
    monkeypatch.setattr(columns, "_on_cuda", lambda name, *ts: True)
    monkeypatch.setattr(columns, "_stream", lambda t: 0)
    monkeypatch.setattr(columns, "_TOUCH", {})
    monkeypatch.setattr(columns, "_K2_SIGS", {})
    monkeypatch.setattr(columns, "_fn", lambda lib, fn: _model_k6w(
        calls, np.random.default_rng(0)))
    checks = []
    expect = columns._expect
    monkeypatch.setattr(columns, "_expect",
                        lambda *a: checks.append(a[2]) or expect(*a))

    def no_clone(*a, **k):
        raise AssertionError("K6w's card branch cloned a tensor")
    monkeypatch.setattr(torch.Tensor, "clone", no_clone)
    columns.reset_launches()
    for _ in range(2):
        got = columns.weights_from_deltas(*args, H, h0)
        for g, w in zip(got, want):
            assert g.dtype == torch.float32 and torch.equal(g, w)
    assert checks == ["base_w", "d_pos", "d_val"]     # the first call's
    tw = 1 if H <= 8 else 4 if H <= 32 else 8
    call = calls[-1]
    assert call["tw"] == tw
    assert call["adv"] == got[1].data_ptr()
    assert call["base"] == args[0].data_ptr()
    (scratch,) = columns._TOUCH.values()
    assert call["touch"] == scratch.data_ptr()
    assert scratch.numel() >= length * tw
    assert columns.LAUNCHES["weights_from_deltas"] == len(calls) == 2
    single = H - (not h0) == 1
    assert call["dense"] == ([0] if single and length == 90 else [])
    columns.reset_launches()


def _model_out_degree(calls, rows):
    """``rtpu_column_out_degree`` as numpy over the wrapper's raw host
    addresses: each source row counts the set mask bytes of the rows its
    walk run names."""
    def model(n, C, indptr, order, me, deg, stream):
        calls.append(dict(indptr=indptr, order=order, n=n, C=C))
        ip = _view(indptr, np.int64, n + 1)
        od = _view(order, np.int32, int(ip[-1]))
        mk = _view(me, np.uint8, rows * C).reshape(rows, C) != 0
        out = _view(deg, np.float32, n * C).reshape(n, C)
        for v in range(n):
            out[v] = mk[od[ip[v]:ip[v + 1]]].sum(0)
        return 0
    return model


def _model_pull_sum(calls, rows):
    """``rtpu_column_pull_sum`` as numpy: each destination row walks its
    CSR run, entry j the pair (src[j], j), and adds ``rd`` at the source
    row where the mask is set, in walk order (f32 adds)."""
    def model(n, C, indptr, src, me, rd, agg, stream):
        calls.append(dict(indptr=indptr, src=src, n=n, C=C))
        ip = _view(indptr, np.int64, n + 1)
        sr = _view(src, np.int32, rows)
        mk = _view(me, np.uint8, rows * C).reshape(rows, C) != 0
        r = _view(rd, np.float32, n * C).reshape(n, C)
        out = _view(agg, np.float32, n * C).reshape(n, C)
        for d in range(n):
            acc = np.zeros(C, np.float32)
            for j in range(ip[d], ip[d + 1]):
                acc = np.where(mk[j], acc + r[sr[j]], acc)
            out[d] = acc
        return 0
    return model


@pytest.fixture
def k2_card(monkeypatch):
    """K2a's and K2b's card branch on CPU tensors through the numpy models
    (K2c keeps its twin), with a fresh signature cache."""
    calls = {"rtpu_column_out_degree": [], "rtpu_column_pull_sum": []}
    rows = {}
    monkeypatch.setattr(columns, "_on_cuda", lambda name, *t: name in (
        "column_out_degree", "column_pull_sum"))
    monkeypatch.setattr(columns, "_stream", lambda t: 0)
    models = {"rtpu_column_out_degree": _model_out_degree,
              "rtpu_column_pull_sum": _model_pull_sum}
    monkeypatch.setattr(columns, "_fn", lambda lib, fn: models[fn](
        calls[fn], rows["m"]))
    monkeypatch.setattr(columns, "_K2_SIGS", {})
    columns.reset_launches()
    yield calls, rows
    columns.reset_launches()


@pytest.mark.parametrize("kind", ["gab", "random"])
def test_unbinned_pagerank_card_branch_launches_once_a_step(k2_card, kind):
    """The unbinned power iteration through K2a's and K2b's card branches
    (the modelled kernels): K2a one launch over the tables' source walk,
    K2b one a superstep over the destination CSR and the source ids,
    ranks bitwise the twins' loop."""
    calls, rows = k2_card
    t = _tables(kind)
    rows["m"] = t.m_pad
    rng = np.random.default_rng(7)
    C = 6
    me = rng.random((t.m_pad, C)) < 0.7
    me[t.m:] = False
    mv = rng.random((t.n_pad, C)) < 0.8
    mv[t.n:] = False
    args = (T(me), T(mv), T(t.e_src), T(t.e_dst), T(t.in_indptr), t.n_pad,
            0.85, 1e-7, 30)
    walk = (T(t.out_indptr), T(t.out_perm))
    saved = columns._on_cuda
    columns._on_cuda = lambda name, *ts: False
    try:
        want, want_steps = thb._pagerank_columns(*args)
    finally:
        columns._on_cuda = saved
    got, steps = thb._pagerank_columns(*args, walk=walk)
    assert torch.equal(got, want) and steps == want_steps > 1
    assert columns.LAUNCHES["column_out_degree"] == 1
    assert columns.LAUNCHES["column_pull_sum"] == steps
    (a,) = calls["rtpu_column_out_degree"]
    assert (a["indptr"], a["order"]) == (walk[0].data_ptr(),
                                        walk[1].data_ptr())
    assert {c["src"] for c in calls["rtpu_column_pull_sum"]} == {
        args[2].data_ptr()}
    assert {c["indptr"] for c in calls["rtpu_column_pull_sum"]} == {
        args[4].data_ptr()}


def test_binned_out_degree_card_branch_walks_the_layout(k2_card):
    """K2a on binned operands over the layout's source walk (its real
    slots only): the twin's counts, bit for bit."""
    calls, rows = k2_card
    t = _tables("gab")
    lay = part.build_layout(t.e_src, t.e_dst, t.n_pad, t.m, 16)
    be = lay.device_edges("cpu", reverse=True)
    rows["m"] = lay.B
    rng = np.random.default_rng(3)
    me = rng.random((lay.B, 7)) < 0.6
    me &= lay.valid[:, None]
    got = columns.column_out_degree(T(me), be.b_src, t.n_pad,
                                    (be.out_indptr, be.out_order))
    want = columns.column_out_degree_plain(T(me), be.b_src, t.n_pad)
    assert torch.equal(got, want)
    assert columns.LAUNCHES["column_out_degree"] == 1


def test_k2_wrappers_check_a_changed_signature_again(monkeypatch):
    """The card branch checks each input signature once: a second call
    with the same tensors skips the checks, and a wrong dtype or shape —
    a new tensor, or a cached one changed in place — still raises."""
    monkeypatch.setattr(columns, "_on_cuda", lambda name, *t: True)
    monkeypatch.setattr(columns, "_stream", lambda t: 0)
    monkeypatch.setattr(columns, "_fn", lambda lib, fn: lambda *a: 0)
    monkeypatch.setattr(columns, "_K2_SIGS", {})
    checks = []
    expect = columns._expect
    monkeypatch.setattr(columns, "_expect", lambda *a: (checks.append(a[2]),
                                                        expect(*a)))
    columns.reset_launches()
    n, m, C = 8, 20, 4
    me = torch.zeros((m, C), dtype=torch.bool)
    rd = torch.zeros((n, C))
    src = torch.zeros(m, dtype=torch.int32)
    indptr = torch.zeros(n + 1, dtype=torch.int64)
    for _ in range(3):
        columns.column_pull_sum(me, rd, src, src, indptr)
    assert checks.count("rd") == 1
    with pytest.raises(TypeError, match="rd"):
        columns.column_pull_sum(me, rd.double(), src, src, indptr)
    with pytest.raises(ValueError, match="indptr"):
        columns.column_pull_sum(me, rd, src, src, indptr[:-1])
    rd.unsqueeze_(0)                          # the cached tensor, reshaped
    with pytest.raises(ValueError, match="rd"):
        columns.column_pull_sum(me, rd, src, src, indptr)
    rd.squeeze_(0)
    columns.column_pull_sum(me, rd, src, src, indptr)

    st = columns.rank_state(torch.zeros((n, C)))
    deg, mv, n_act = torch.ones((n, C)), torch.ones((n, C), dtype=bool), \
        torch.ones(C)
    checks.clear()
    for _ in range(3):
        columns.pagerank_update(st, rd, deg, mv, n_act, 0.85, 1e-7)
    assert checks.count("deg") == 1 and checks.count("agg") == 3
    with pytest.raises(TypeError, match="agg"):
        columns.pagerank_update(st, rd.double(), deg, mv, n_act, 0.85, 1e-7)
    st.part = st.part.float()
    with pytest.raises(TypeError, match="part"):
        columns.pagerank_update(st, rd, deg, mv, n_act, 0.85, 1e-7)

    t = _tables("random")
    mk = torch.zeros((t.m_pad, C), dtype=torch.bool)
    walk = (T(t.out_indptr), T(t.out_perm))
    e_src = T(t.e_src)
    checks.clear()
    for _ in range(2):
        columns.column_out_degree(mk, e_src, t.n_pad, walk)
    assert checks.count("me") == 1
    with pytest.raises(TypeError, match="e_src"):
        columns.column_out_degree(mk, e_src.long(), t.n_pad, walk)
    assert columns.LAUNCHES["column_pull_sum"] == 4
    assert columns.LAUNCHES["pagerank_update"] == 3
    assert columns.LAUNCHES["column_out_degree"] == 2
    columns.reset_launches()


# --------------------------- the host-column route's one staging buffer

def _fold_engines(kind, jlog):
    from raphtory_tpu_torch.interop import numeric_prop_payloads

    log = event_log_from_arrays(jlog.arrays(),
                                props=numeric_prop_payloads(jlog.props))
    seeds = (1, 2, 3)
    if kind == "pagerank":
        return (jhb.HopBatchedPageRank(jlog, max_steps=20),
                thb.HopBatchedPageRank(log, max_steps=20, device="cpu"))
    if kind == "cc":
        return (jhb.HopBatchedCC(jlog, max_steps=40),
                thb.HopBatchedCC(log, max_steps=40, device="cpu"))
    if kind == "bfs":
        return (jhb.HopBatchedBFS(jlog, seeds, max_steps=40),
                thb.HopBatchedBFS(log, seeds, max_steps=40, device="cpu"))
    return (jhb.HopBatchedSSSP(jlog, seeds, "w", max_steps=40),
            thb.HopBatchedSSSP(log, seeds, "w", max_steps=40, device="cpu"))


@pytest.mark.parametrize("kind", ["pagerank", "cc", "bfs", "sssp"])
def test_fold_columns_are_views_of_one_staging_buffer(kind, monkeypatch):
    """``_fold_columns`` writes the host fold columns (and SSSP's weight
    columns) as views of ONE staging buffer, each at a 16-byte offset
    (plain memory for the CPU), bitwise the JAX package's separate arrays
    over two forward batches; the dispatch ships the whole buffer in one
    upload, with ``ship_bytes`` unchanged."""
    from raphtory_tpu_torch.ops import resident

    monkeypatch.setenv("RTPU_PCPM", "0")
    jlog = random_log(np.random.default_rng(21), n_events=700, n_ids=40,
                      t_span=100, props=True)
    j, t = _fold_engines(kind, jlog)
    uploads = []
    upload = resident.upload
    monkeypatch.setattr(resident, "upload", lambda data, dev: uploads.append(
        data) or upload(data, dev))
    for hops in ([20, 35, 50], [60, 99]):
        _, want = j._fold_columns(hops)
        _, got = t._fold_columns(hops)
        assert isinstance(got, resident.Staged)
        assert len(got) == len(want) == (5 if kind == "sssp" else 4)
        assert not got.data.is_pinned()
        offs, nbytes = resident.offsets16(a.nbytes for a in got)
        base = got.data.numpy().ctypes.data
        assert got.data.numel() == nbytes and got.offsets == offs
        for g, w, off in zip(got, want, offs):
            assert g.ctypes.data - base == off and g.shape == w.shape
            assert g.dtype == np.asarray(w).dtype
            np.testing.assert_array_equal(g, np.asarray(w))
        assert t.ship_bytes == j.ship_bytes
        before = len(uploads)
        t._active_layout = None
        t._dispatch_cols(got, hops, [30, None])
        assert len(uploads) == before + 1
        assert uploads[-1].data_ptr() == got.data.data_ptr()
        assert uploads[-1].numel() == offs[-1] + got[-1].nbytes


@pytest.mark.parametrize("count", [0, 1, 3, 4, 5])
def test_ship_uploads_the_span_of_the_arrays_it_ships(count, monkeypatch):
    """``resident.ship(staged, dev, count)`` uploads ONE copy of the bytes
    that the first ``count`` arrays span, no byte past them, and hands back
    views of it equal to the host arrays."""
    from raphtory_tpu_torch.ops import resident

    rng = np.random.default_rng(count)
    host = (rng.integers(0, 99, (3, 37)).astype(np.int32),
            rng.random((3, 37)) < 0.5,
            rng.integers(0, 99, (3, 5)).astype(np.int64),
            rng.random((3, 5)) < 0.5,
            rng.random((3, 37)).astype(np.float32))
    staged = resident.pack(host, pin=False)
    upload, uploaded = resident.upload, []
    monkeypatch.setattr(resident, "upload", lambda data, dev: uploaded.append(
        data) or upload(data, dev))
    got = resident.ship(staged, "cpu", count)
    end = staged.offsets[count - 1] + host[count - 1].nbytes if count else 0
    assert len(uploaded) == 1 and uploaded[0].numel() == end
    assert len(got) == count
    for g, a in zip(got, host):
        assert g.dtype == torch.from_numpy(a).dtype and g.is_contiguous()
        np.testing.assert_array_equal(g.numpy(), a)
