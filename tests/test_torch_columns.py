"""The kernels' plain twins (``raphtory_tpu_torch/ops/columns.py``) and the
power iteration around them against the JAX package's jitted functions on
the same numpy inputs: K1 bitwise, K2 within the reference's own PageRank
tolerance (rtol 1e-5 / atol 1e-7, ``tests/test_hopbatch.py:145`` — f32 sums
in another order) with equal superstep counts."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_sweep import random_log

from raphtory_tpu.engine import hopbatch as jhb
from raphtory_tpu.utils.synth import gab_like_log
from raphtory_tpu_torch.engine import hopbatch as thb
from raphtory_tpu_torch.engine.device_sweep import GlobalTables
from raphtory_tpu_torch.core.sweep import SweepBuilder
from raphtory_tpu_torch.interop import event_log_from_arrays
from raphtory_tpu_torch.ops import columns

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
