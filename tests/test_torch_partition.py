"""The destination-binned (PCPM) layout and kernels of the port
(``raphtory_tpu_torch/ops/partition.py``; KB1, K2b-P, K5-P/K6-P and K7-P
through their plain twins) against the JAX package's
``raphtory_tpu/ops/partition.py`` and the binned bodies of its jitted
functions, on the same numpy inputs, mirroring ``tests/test_partition.py``.

The layout arrays and spec are BITWISE the reference's (non-dividing P
included); the knobs resolve with the reference's rules (auto keeps tiny
graphs unbinned). Masks, CC labels and BFS/SSSP distances are bitwise with
equal superstep counts; PageRank within rtol 1e-5 / atol 1e-7 (the binned
float sums reorder in the reference). The port's binned walk keeps each
destination's slots in source order — the unbinned route's order — so its
binned PageRank equals its unbinned PageRank bit for bit, which is checked
too."""

import ctypes
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_sweep import random_log
from test_torch_scale import K3_GRIDS, _jax_hop_masks, _k3_case, k3_card  # noqa: F401 (a fixture)

from raphtory_tpu.engine import hopbatch as jhb
from raphtory_tpu.ops import partition as jpart
from raphtory_tpu.ops import segment as jseg
from raphtory_tpu.utils.synth import gab_like_log
from raphtory_tpu_torch.core.sweep import SweepBuilder
from raphtory_tpu_torch.engine import hopbatch as thb
from raphtory_tpu_torch.engine.device_sweep import GlobalTables
from raphtory_tpu_torch.interop import event_log_from_arrays
from raphtory_tpu_torch.ops import columns, minplus
from raphtory_tpu_torch.ops import partition as part
from raphtory_tpu_torch.ops import segment

T = torch.from_numpy
I32_MAX = np.iinfo(np.int32).max
BUDGET = 256 << 20
LAYOUT_FIELDS = ("perm", "inv", "b_src", "b_dst", "valid", "slot", "u_src")


@functools.lru_cache(maxsize=None)
def _tables(kind):
    if kind == "gab":
        jlog = gab_like_log(600, 5_000, t_span=1_000)
    else:
        jlog = random_log(np.random.default_rng(3), n_events=600, n_ids=40,
                          t_span=80)
    return GlobalTables(SweepBuilder(event_log_from_arrays(jlog.arrays()),
                                     track_rows=False, preseed_pairs=True))


def _layout(kind, P):
    t = _tables(kind)
    return t, part.build_layout(t.e_src, t.e_dst, t.n_pad, t.m, P)


# ------------------------------------------------------------------ layout

@pytest.mark.parametrize("P", [1, 2, 7, 16, None])
@pytest.mark.parametrize("kind", ["gab", "random"])
def test_layout_bitwise_matches_jax(kind, P):
    t = _tables(kind)
    if P is None:
        P = part.partition_count(t.n_pad, BUDGET)
        assert P == jpart.partition_count(t.n_pad, BUDGET)
    want = jpart.build_layout(t.e_src, t.e_dst, t.n_pad, t.m, P)
    got = part.build_layout(t.e_src, t.e_dst, t.n_pad, t.m, P)
    assert tuple(got.spec) == tuple(want.spec)
    assert got.B == len(want.perm) == want.spec.partitions * want.spec.cap
    for f in LAYOUT_FIELDS:
        g, w = getattr(got, f), getattr(want, f)
        assert g.dtype == w.dtype and np.array_equal(g, w), f
    assert (got.n_pad, got.m) == (want.n_pad, want.m)


@pytest.mark.parametrize("P", [1, 3, 7])
@pytest.mark.parametrize("kind", ["gab", "random"])
def test_layout_walks(kind, P):
    """The destination walk lists each row's real slots in engine
    ((dst, src)) order; the source walk each row's real slots by source —
    neither ever reaches a cap-pad slot."""
    t, lay = _layout(kind, P)
    indptr, order = lay.walk()
    assert indptr.dtype == np.int64 and order.dtype == np.int32
    assert np.array_equal(order, lay.inv[: t.m])
    assert np.array_equal(lay.b_dst[order], t.e_dst[: t.m])
    assert np.array_equal(lay.b_src[order], t.e_src[: t.m])
    assert np.array_equal(indptr, t.in_indptr)
    out_ptr, out_order = lay.walk(reverse=True)
    assert np.array_equal(out_ptr, t.out_indptr)
    assert lay.valid[out_order].all()
    assert np.array_equal(lay.b_src[out_order], t.e_src[t.out_perm])
    assert np.array_equal(np.sort(out_order), np.flatnonzero(lay.valid))
    be = lay.device_edges("cpu", reverse=True)
    assert be is lay.device_edges("cpu", reverse=True)   # cached per device
    assert be.U == (lay.spec.partitions * lay.spec.cap_u
                    if lay.spec.preagg else 0)
    for f, a in zip(part.BinnedEdges._fields[:6], lay.device_args("cpu")):
        assert getattr(be, f) is a


def test_walk_refuses_a_table_not_sorted_by_destination():
    """The destination walk is the engine order; a table that is not
    (dst, src)-sorted would give a wrong CSR, so it raises."""
    e_src = np.array([3, 1, 0, 2, 0, 0, 0, 0], np.int32)
    e_dst = np.array([2, 0, 1, 0, 0, 0, 0, 0], np.int32)
    lay = part.build_layout(e_src, e_dst, 4, 4, 2)
    with pytest.raises(ValueError, match="not sorted"):
        lay.walk()
    assert lay.walk(reverse=True)[0][-1] == 4


def test_remap_positions_preserves_skip_sentinel():
    t = _tables("random")
    want = jpart.build_layout(t.e_src, t.e_dst, t.n_pad, t.m, 4)
    lay = part.build_layout(t.e_src, t.e_dst, t.n_pad, t.m, 4)
    sent = np.int32(2**31 - 1)
    pos = np.array([[0, min(3, t.m - 1), sent], [sent, sent, 1]], np.int32)
    out = lay.remap_positions(pos)
    assert out.dtype == np.int32
    assert np.array_equal(out, want.remap_positions(pos))
    assert (out[pos == sent] == sent).all()
    assert (out[pos != sent] == lay.inv[pos[pos != sent]]).all()
    lat = np.arange(t.m_pad, dtype=np.int32)
    alive = np.ones(t.m_pad, bool)
    for g, w in zip(lay.bin_base(lat, alive), want.bin_base(lat, alive)):
        assert np.array_equal(g, w)
    assert not lay.bin_base(lat, alive)[1][~lay.valid].any()
    w = np.linspace(0, 1, t.m_pad).astype(np.float32)
    assert np.array_equal(lay.bin_values(w), want.bin_values(w))


def test_partition_count_and_auto_rule_match_jax():
    for n_pad, budget, ov in ((32768, BUDGET, None), (1024, BUDGET, None),
                              (32768, BUDGET, 7), (8, BUDGET, 1000),
                              (5_308_416, BUDGET, None),
                              (16384, 64 << 20, None), (100, 1 << 20, 0)):
        assert part.partition_count(n_pad, budget, ov) \
            == jpart.partition_count(n_pad, budget, ov)
    assert part.partition_count(32768, BUDGET) == 16   # 2048-row slices
    for m_pad in (1 << 10, (1 << 17) - 1, 1 << 17, 1 << 20):
        for mode in ("auto", "", "0", "1", "2", "yes"):
            assert part.pcpm_enabled(m_pad, mode) \
                == jpart.pcpm_enabled(m_pad, mode), (m_pad, mode)
    assert part.AUTO_MIN_PAIRS == jpart.AUTO_MIN_PAIRS == 1 << 17


@pytest.mark.parametrize("env", [
    {}, {"RTPU_PCPM": "auto"}, {"RTPU_PCPM": "0"}, {"RTPU_PCPM": "1"},
    {"RTPU_PCPM": "1", "RTPU_PARTITIONS": "7"},
    {"RTPU_PCPM": "1", "RTPU_TILE_BUDGET_MB": "1"}])
def test_resolve_reads_the_knobs_like_jax(monkeypatch, env):
    """Tiny graphs stay unbinned unless ``RTPU_PCPM=1``; the resolved spec
    is the reference's, and cached per owner."""
    for k in ("RTPU_PCPM", "RTPU_PARTITIONS", "RTPU_TILE_BUDGET_MB"):
        monkeypatch.delenv(k, raising=False)
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    t = _tables("random")
    owner_j, owner_t = object.__new__(type("J", (), {})), \
        object.__new__(type("P", (), {}))
    want = jpart.resolve(owner_j, t, jpart.tile_budget_bytes())
    got = part.resolve(owner_t, t, part.tile_budget_bytes())
    assert part.tile_budget_bytes() == jpart.tile_budget_bytes()
    assert (got is None) == (want is None)
    if got is not None:
        assert tuple(got.spec) == tuple(want.spec)
        assert part.resolve(owner_t, t, part.tile_budget_bytes()) is got


def test_auto_route_engages_at_the_reference_threshold(monkeypatch):
    """With no knob set, the engines bin exactly where the JAX package's
    do: a table of m_pad >= 2^17 pairs bins, a smaller one does not."""
    monkeypatch.delenv("RTPU_PCPM", raising=False)
    monkeypatch.delenv("RTPU_PARTITIONS", raising=False)
    jlog = random_log(np.random.default_rng(5), n_events=300, n_ids=30,
                      t_span=50)
    hb = thb.HopBatchedCC(event_log_from_arrays(jlog.arrays()),
                          device="cpu")
    hb.run([20, 49], [None])
    assert hb._active_layout is None and hb._dev_base_spec is None

    class Big:                                   # just the table surface
        e_src, e_dst = _tables("gab").e_src, _tables("gab").e_dst
        n_pad, m = _tables("gab").n_pad, _tables("gab").m
        m_pad = 1 << 17
    got, want = part.resolve(Big, Big, BUDGET), jpart.resolve(Big, Big, BUDGET)
    assert got is not None and tuple(got.spec) == tuple(want.spec)


@pytest.mark.parametrize("C", [3, 12, 128])
def test_edge_traffic_model_matches_jax(C):
    for m_pad, n_pad, spec in ((327_680, 32_768, (16, 2048, 20_672, 14_976,
                                                  True)),
                               (131_072, 16_384, (8, 2048, 24_704, 9_152,
                                                  True)),
                               (1 << 12, 1 << 8, (2, 128, 2_048, 2_048,
                                                  False)), (4096, 256, None)):
        assert part.edge_traffic_model(
            m_pad, C, n_pad, None if spec is None else part.PartitionSpec(
                *spec)) == jpart.edge_traffic_model(
            m_pad, C, n_pad, None if spec is None else jpart.PartitionSpec(
                *spec))


# ------------------------------------------------------- KB1 (binned masks)

@functools.lru_cache(maxsize=None)
def _jax_bin_k3(tdt):
    def run(e_lat, e_alive, v_lat, v_alive, hop_of_col, T_col, w_col, perm,
            valid):
        me, mv = jhb._column_masks(jnp.dtype(tdt), e_lat, e_alive, v_lat,
                                   v_alive, hop_of_col, T_col, w_col)
        me_b, _ = jhb._bin_masks(me, (None, perm, valid, None, None))
        return me_b, mv
    return jax.jit(run)


@pytest.mark.parametrize("P", [2, 7])
@pytest.mark.parametrize("tdt", [np.int32, np.int64], ids=["i32", "i64"])
def test_bin_column_masks_twin_matches_jax(tdt, P):
    t, lay = _layout("random", P)
    rng = np.random.default_rng(P)
    hops, windows = [20, 50, 79], [100, 15, None]
    H, C, hop_of_col, T_col, w_col = thb._column_layout(hops, windows)
    cols = (rng.integers(0, 80, (H, t.m_pad)).astype(tdt),
            rng.random((H, t.m_pad)) < 0.7,
            rng.integers(0, 80, (H, t.n_pad)).astype(tdt),
            rng.random((H, t.n_pad)) < 0.9)
    want = _jax_bin_k3(np.dtype(tdt).name)(*cols, hop_of_col, T_col, w_col,
                                           lay.perm, lay.valid)
    info = np.iinfo(tdt)
    lo = np.clip(T_col - w_col, info.min, info.max).astype(tdt)
    got = columns.bin_column_masks(*map(T, cols), T(hop_of_col), T(lo),
                                   T(w_col < 0), T(lay.perm), T(lay.valid))
    assert got[0].shape == (lay.B, C) and got[1].shape == (t.n_pad, C)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    assert not got[0][T(~lay.valid)].any()


@pytest.mark.parametrize("C", sorted(K3_GRIDS))
@pytest.mark.parametrize("tdt", [np.int32, np.int64], ids=["i32", "i64"])
def test_bin_column_masks_card_branch_passes_bounds_by_value(k3_card, tdt,
                                                             C):
    """KB1's card branch: the column bounds as one host int64 array (no
    tensor made of them), one launch a group of 64 columns, edge row b
    read from edge ``perm[b]`` and 0 on cap-pad slots; the modelled kernel
    equals the twin and the JAX package's ``_column_masks`` +
    ``_bin_masks`` (``raphtory_tpu/engine/hopbatch.py:50, 283``) bit for
    bit."""
    calls, made = k3_card
    t, lay = _layout("random", 5)
    cols, hops, windows = _k3_case(np.random.default_rng(C), tdt, C,
                                   m=t.m_pad, n=t.n_pad)
    _, _, hop_of_col, T_col, w_col = thb._column_layout(hops, windows)
    want = _jax_bin_k3(np.dtype(tdt).name)(*cols, hop_of_col, T_col, w_col,
                                           lay.perm, lay.valid)
    info = np.iinfo(tdt)
    lo = np.clip(T_col - w_col, info.min, info.max).astype(tdt)
    args = (*map(T, cols), hop_of_col, lo, w_col < 0, T(lay.perm),
            T(lay.valid))
    del made[:]
    got = columns.bin_column_masks(*args)
    assert made == []
    assert columns.LAUNCHES["bin_masks"] == -(-C // 64)
    assert got[0].shape == (lay.B, C) and got[1].shape == (t.n_pad, C)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    twin = columns.bin_column_masks_plain(
        *map(T, cols), T(hop_of_col), T(lo), T(w_col < 0), T(lay.perm),
        T(lay.valid))
    assert all(torch.equal(g, w) for g, w in zip(got, twin))


def test_binned_scale_masks_twin_matches_jax():
    """K4's binned emission: the hop state advances in engine order, the
    columns read it through the permutation (hopbatch.py:2126-2137)."""
    t, lay = _layout("gab", 5)
    rng = np.random.default_rng(4)
    H, W, U = 3, 2, 64
    base = np.where(rng.random(t.m_pad) < 0.5, rng.integers(0, 500, t.m_pad),
                    np.iinfo(np.int32).min).astype(np.int32)
    pos = rng.integers(0, t.m, (H, U)).astype(np.int32)
    tt = rng.integers(0, 900, (H, U)).astype(np.int32)
    pos[:, -4:], tt[:, -4:] = 0, np.iinfo(np.int32).min    # pads
    thr = rng.integers(0, 900, H * W).astype(np.int32)

    def ref(base, pos, tt, thr, perm, valid):
        cur, cols = base, []
        for h in range(H):
            cur = cur.at[pos[h]].max(tt[h])
            cols.append((cur[perm][:, None] >= thr[h * W:(h + 1) * W][None])
                        & valid[:, None])
        return jnp.concatenate(cols, axis=1)

    want = jax.jit(ref)(base, pos, tt, thr, lay.perm, lay.valid)
    got = columns.scale_hop_masks(T(base), T(pos), T(tt), T(thr), H, W,
                                  perm=T(lay.perm), valid=T(lay.valid))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_binned_wrappers_check_inputs_and_count_only_launches():
    t, lay = _layout("random", 3)
    be = lay.device_edges("cpu", reverse=True)
    columns.reset_launches()
    me = torch.zeros((lay.B, 4), dtype=torch.bool)
    rd = torch.ones((t.n_pad, 4))
    assert torch.equal(columns.binned_pull_sum(me, rd, be),
                       torch.zeros_like(rd))
    with pytest.raises(ValueError, match="shape"):
        columns.binned_pull_sum(me[:-1], rd, be)
    with pytest.raises(TypeError, match="dtype"):
        columns.binned_pull_sum(me, rd.double(), be)
    st = minplus.min_state(torch.zeros((t.n_pad, 4), dtype=torch.int32))
    with pytest.raises(ValueError, match="source walk"):
        minplus.binned_cc_superstep(st, me, me.new_ones((t.n_pad, 4)),
                                    lay.device_edges("cpu"))
    with pytest.raises(ValueError, match="unknown combiner"):
        segment.partition_reduce(torch.ones(8), segment.PartitionWalk(
            torch.zeros(3, dtype=torch.int64),
            torch.zeros(0, dtype=torch.int32), None, None), "mean",
            torch.ones(8, dtype=torch.bool))
    with pytest.raises(ValueError, match="shape"):
        columns.bin_column_masks(
            torch.zeros((1, t.m_pad), dtype=torch.int32),
            torch.zeros((1, t.m_pad), dtype=torch.bool),
            torch.zeros((1, t.n_pad), dtype=torch.int32),
            torch.zeros((1, t.n_pad), dtype=torch.bool),
            torch.zeros(2, dtype=torch.int32),
            torch.zeros(2, dtype=torch.int32),
            torch.zeros(2, dtype=torch.bool), T(lay.perm), T(lay.valid[:-1]))
    assert all(v == 0 for v in columns.LAUNCHES.values())   # twins only


# ------------------------------------------ K2b-P, K5-P, K6-P (the loops)

def _binned_masks(t, lay, rng, C):
    me = rng.random((t.m_pad, C)) < 0.6
    me[t.m:] = False
    me[:, 1] = False                       # an all-masked edge column
    mv = rng.random((t.n_pad, C)) < 0.85
    mv[t.n:] = False
    mv[:, 3] = False                       # an empty view
    return me[lay.perm] & lay.valid[:, None], mv


def _jax_pcpm(lay):
    return (jpart.PartitionSpec(*lay.spec), jnp.asarray(lay.slot),
            jnp.asarray(lay.u_src))


@pytest.mark.parametrize("max_steps", [1, 30])
@pytest.mark.parametrize("P", [3, 16])
@pytest.mark.parametrize("kind", ["gab", "random"])
def test_binned_pagerank_loop_matches_jax(kind, P, max_steps):
    """K2a + K2b-P + K2c on binned operands against the reference's PCPM
    body (``hopbatch.py:242-251``; pre-aggregated, or the plain binned
    gather where the layout does not pre-aggregate); and bitwise equal to
    the port's unbinned loop on the same masks."""
    t, lay = _layout(kind, P)
    rng = np.random.default_rng(P + max_steps)
    C = 5
    me_b, mv = _binned_masks(t, lay, rng, C)
    want, want_steps = jax.jit(lambda me, mv, es, ed: jhb._pagerank_columns(
        me, mv, es, ed, t.n_pad, 0.85, 1e-7, max_steps,
        tile_budget=BUDGET, pcpm=_jax_pcpm(lay)))(me_b, mv, lay.b_src,
                                                  lay.b_dst)
    be = lay.device_edges("cpu")
    got, steps = thb._pagerank_columns(
        T(me_b), T(mv), be.b_src, be.b_dst, be.in_indptr, t.n_pad, 0.85,
        1e-7, max_steps, pcpm=be)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-7)
    assert steps == int(want_steps)
    # the same masks in engine order through the unbinned K2b
    me = np.zeros((t.m_pad, C), bool)
    me[lay.perm[lay.valid]] = me_b[lay.valid]
    flat, fsteps = thb._pagerank_columns(
        T(me), T(mv), T(t.e_src), T(t.e_dst), T(t.in_indptr), t.n_pad, 0.85,
        1e-7, max_steps)
    assert torch.equal(got, flat) and fsteps == steps


def test_binned_pull_sum_forms_agree():
    """The bucket gather and the plain binned gather read the same values:
    equal sums bit for bit."""
    t, lay = _layout("gab", 4)
    assert lay.spec.preagg
    be = lay.device_edges("cpu")
    rng = np.random.default_rng(1)
    me_b, _ = _binned_masks(t, lay, rng, 6)
    rd = T(rng.random((t.n_pad, 6)).astype(np.float32))
    a = columns.binned_pull_sum(T(me_b), rd, be)
    b = columns.binned_pull_sum(T(me_b), rd, be._replace(U=0))
    assert torch.equal(a, b)


@pytest.mark.parametrize("P", [3, 16])
@pytest.mark.parametrize("kind", ["gab", "random"])
def test_binned_pull_walk_pairs_each_walk_entry_with_its_source(kind, P):
    """K2b-P's walk pairs: ``(b_src[s], s)`` for each walk entry's slot
    ``s = in_order[j]``, derived once per layout and cached; on a
    pre-aggregating layout each real slot's bucket reads the same source
    row (``u_src[slot[s]] == b_src[s]``), which is why the kernel may read
    ``rd`` at ``b_src`` where the twin reads the bucket."""
    t, lay = _layout(kind, P)
    be = lay.device_edges("cpu")
    pairs = columns.binned_pull_walk(be)
    _, order = lay.walk()
    assert pairs.dtype == torch.int32 and pairs.shape == (t.m, 2)
    np.testing.assert_array_equal(
        pairs.numpy(), np.stack([lay.b_src[order], order], 1))
    assert columns.binned_pull_walk(be) is pairs
    assert columns.binned_pull_walk(lay.device_edges("cpu")) is pairs
    real = np.flatnonzero(lay.valid)
    np.testing.assert_array_equal(lay.u_src[lay.slot[real]], lay.b_src[real])


def test_binned_pull_walk_refuses_buckets_that_miss_their_slots():
    """A pre-aggregating layout whose bucket of some real slot names
    another source than the slot is refused where the pairs are derived
    (the kernel and the twin would read different rows)."""
    t, lay = _layout("gab", 4)
    assert lay.spec.preagg
    be = lay.device_edges("cpu")
    s = int(be.in_order[7])
    bad = be.u_src.clone()
    bad[be.slot[s]] = (bad[be.slot[s]] + 1) % t.n_pad
    # a fresh walk tensor: the pairs are cached by the walk's identity
    broken = be._replace(u_src=bad, in_order=be.in_order.clone())
    with pytest.raises(ValueError, match="walk entry 7"):
        columns.binned_pull_walk(broken)
    me_b, _ = _binned_masks(t, lay, np.random.default_rng(0), 4)
    with pytest.raises(ValueError, match="do not match"):
        _on_card(columns.binned_pull_sum, T(me_b),
                 torch.ones((t.n_pad, 4)), broken)


def _view(addr, dtype, n):
    """``n`` elements of ``dtype`` at a host address, as numpy."""
    if not n:
        return np.zeros(0, dtype)
    nbytes = n * np.dtype(dtype).itemsize
    return np.ctypeslib.as_array((ctypes.c_uint8 * nbytes).from_address(
        addr)).view(dtype)


def _model_pull(calls):
    """``rtpu_binned_pull_sum`` as numpy over the raw host addresses the
    wrapper passes: each destination row walks the pairs from
    ``in_indptr``, reads the mask at each entry's slot and adds ``rd`` at
    its source row in walk order (f32 adds, one entry at a time)."""
    def model(n, C, indptr, pairs, me, rd, agg, stream):
        calls.append(dict(pairs=pairs, indptr=indptr, n=n, C=C))
        ip = _view(indptr, np.int64, n + 1)
        pr = _view(pairs, np.int32, 2 * int(ip[-1])).reshape(-1, 2)
        B = int(pr[:, 1].max()) + 1 if len(pr) else 0
        mk = _view(me, np.uint8, B * C).reshape(B, C) != 0
        r = _view(rd, np.float32, n * C).reshape(n, C)
        out = _view(agg, np.float32, n * C).reshape(n, C)
        for d in range(n):
            acc = np.zeros(C, np.float32)
            for src, s in pr[ip[d]:ip[d + 1]]:
                acc = np.where(mk[s], acc + r[src], acc)
            out[d] = acc
        return 0
    return model


def _on_card(fn, *args, calls=None):
    """``fn(*args)`` with K2b-P's card branch taken on CPU tensors (the C
    entry point is ``_model_pull``); the other kernels keep their twins."""
    calls = [] if calls is None else calls
    saved = columns._on_cuda, columns._fn, columns._stream
    columns._on_cuda = lambda name, *t: name == "binned_pull_sum"
    columns._fn = lambda lib, f: _model_pull(calls)
    columns._stream = lambda t: 0
    try:
        return fn(*args)
    finally:
        columns._on_cuda, columns._fn, columns._stream = saved


@pytest.mark.parametrize("P", [3, 16])
@pytest.mark.parametrize("kind", ["gab", "random"])
def test_binned_pagerank_card_branch_is_one_launch_a_superstep(kind, P):
    """The binned power iteration through K2b-P's card branch (the
    modelled kernel): one launch a superstep, over the layout's cached walk
    pairs and no bucket buffer, with ranks bitwise the twin loop's."""
    t, lay = _layout(kind, P)
    rng = np.random.default_rng(P)
    C = 5
    me_b, mv = _binned_masks(t, lay, rng, C)
    be = lay.device_edges("cpu")
    args = (T(me_b), T(mv), be.b_src, be.b_dst, be.in_indptr, t.n_pad, 0.85,
            1e-7, 30)
    want, want_steps = thb._pagerank_columns(*args, pcpm=be)
    columns.reset_launches()
    calls = []
    got, steps = _on_card(
        lambda: thb._pagerank_columns(*args, pcpm=be), calls=calls)
    assert torch.equal(got, want) and steps == want_steps > 1
    assert columns.LAUNCHES["binned_pull_sum"] == len(calls) == steps
    pairs = columns.binned_pull_walk(be)
    assert {c["pairs"] for c in calls} == {pairs.data_ptr()}
    assert {c["indptr"] for c in calls} == {be.in_indptr.data_ptr()}
    columns.reset_launches()


@functools.lru_cache(maxsize=None)
def _jax_cc_pcpm(n_pad, max_steps, spec):
    def run(me, mv, es, ed, slot, u_src):
        return jhb._cc_columns(me, mv, es, ed, n_pad, max_steps,
                               tile_budget=BUDGET,
                               pcpm=(jpart.PartitionSpec(*spec), slot, u_src))
    return jax.jit(run)


@functools.lru_cache(maxsize=None)
def _jax_bfs_pcpm(n_pad, max_steps, directed, weighted, spec):
    def run(me, mv, es, ed, seed, ew, slot, u_src):
        return jhb._bfs_columns(me, mv, es, ed, n_pad, max_steps, directed,
                                seed, ew if weighted else 1.0,
                                tile_budget=BUDGET,
                                pcpm=(jpart.PartitionSpec(*spec), slot,
                                      u_src))
    return jax.jit(run)


@pytest.mark.parametrize("max_steps", [2, 60])
@pytest.mark.parametrize("P", [3, 16])
@pytest.mark.parametrize("kind", ["gab", "random"])
def test_binned_cc_loop_bitwise(kind, P, max_steps):
    t, lay = _layout(kind, P)
    rng = np.random.default_rng(7 + P)
    me_b, mv = _binned_masks(t, lay, rng, 6)
    want, want_steps = _jax_cc_pcpm(t.n_pad, max_steps, tuple(lay.spec))(
        me_b, mv, lay.b_src, lay.b_dst, lay.slot, lay.u_src)
    got, steps = thb._cc_columns(T(me_b), T(mv),
                                 lay.device_edges("cpu", reverse=True),
                                 t.n_pad, max_steps)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert steps == int(want_steps)


@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("directed", [False, True])
@pytest.mark.parametrize("P", [3, 16])
def test_binned_bfs_loop_bitwise(P, directed, weighted):
    """Weights span negative, zero and fractional values and follow the
    permutation (``[B, H]``, hop-major columns)."""
    t, lay = _layout("gab", P)
    rng = np.random.default_rng(11 + P)
    H, W = 3, 2
    me_b, mv = _binned_masks(t, lay, rng, H * W)
    seed = np.zeros(t.n_pad, bool)
    seed[rng.choice(t.n, 3, replace=False)] = True
    ew = rng.choice(np.array([-0.25, 0.0, 0.5, 1.0, 2.75, 7.0], np.float32),
                    (t.m_pad, H))[lay.perm]
    want, want_steps = _jax_bfs_pcpm(t.n_pad, 40, directed, weighted,
                                     tuple(lay.spec))(
        me_b, mv, lay.b_src, lay.b_dst, seed, np.repeat(ew, W, axis=1),
        lay.slot, lay.u_src)
    got, steps = thb._bfs_columns(
        T(me_b), T(mv), lay.device_edges("cpu", reverse=not directed),
        t.n_pad, 40, directed, T(seed), T(ew) if weighted else None, W)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert steps == int(want_steps)


# ------------------------------------------------------------------- K7-P

@pytest.mark.parametrize("dtype", [np.int32, np.float32])
@pytest.mark.parametrize("op", ["sum", "min", "max"])
def test_partition_segment_reduce_matches_jax(op, dtype):
    """The reference's ``test_partition_segment_reduce_matches_flat``
    operands: P*n_per = 80 > n = 77 (the overhang is sliced away), masked
    slots, empty rows; and an F-wide leaf."""
    rng = np.random.default_rng(2)
    P, cap, n_per, n = 5, 48, 16, 77
    loc = rng.integers(0, n_per, (P, cap)).astype(np.int32)
    mask = rng.random((P, cap)) < 0.75
    for shape in ((P, cap), (P, cap, 3)):
        data = rng.integers(-50, 50, shape).astype(dtype)
        want = np.asarray(jseg.partition_segment_reduce(
            jnp.asarray(data), jnp.asarray(loc), n_per, n, op,
            jnp.asarray(mask)))
        got = segment.partition_segment_reduce(T(data), T(loc), n_per, n, op,
                                               T(mask))
        assert got.shape == want.shape and got.numpy().dtype == want.dtype
        np.testing.assert_array_equal(got.numpy(), want)
    with pytest.raises(ValueError, match="unknown combiner"):
        segment.partition_segment_reduce(T(data), T(loc), n_per, n, "mean")


@pytest.mark.parametrize("k", [1, 3])
def test_partition_reduce_through_a_layout(k):
    """The bsp route's form (``bsp.py:131-141``): each window's engine-order
    payload read through ``perm`` and masked by ``perm & valid`` — equal to
    the reference's gather-then-``partition_segment_reduce``, and to K7's
    flat combine over the same edges."""
    t, lay = _layout("random", 7)
    rng = np.random.default_rng(k)
    m = t.m_pad
    x = rng.standard_normal((k * m, 2)).astype(np.float32)
    em = rng.random(k * m) < 0.7
    em.reshape(k, m)[:, t.m:] = False
    be = lay.device_edges("cpu")
    walk = segment.PartitionWalk(be.in_indptr, be.in_order, be.perm,
                                 be.valid)
    got = segment.partition_reduce(T(x), walk, "sum", T(em), k)
    spec = lay.spec
    b_local = (lay.b_dst.reshape(spec.partitions, spec.cap)
               - np.arange(spec.partitions)[:, None] * spec.n_per)
    for w in range(k):
        xb = x.reshape(k, m, 2)[w][lay.perm]
        mb = em.reshape(k, m)[w][lay.perm] & lay.valid
        want = np.asarray(jseg.partition_segment_reduce(
            jnp.asarray(xb.reshape(spec.partitions, spec.cap, 2)),
            jnp.asarray(b_local), spec.n_per, t.n_pad, "sum",
            jnp.asarray(mb.reshape(spec.partitions, spec.cap))))
        np.testing.assert_allclose(got.numpy()[w * t.n_pad:(w + 1) * t.n_pad],
                                   want, rtol=1e-6, atol=1e-6)
    flat = segment.segment_combine(
        T(x), segment.SegmentCSR(T(t.e_dst), T(t.in_indptr), None), "sum",
        T(em), k)
    assert torch.equal(got, flat)


# ------------------------------------- binned K4's device inverse map

@pytest.mark.parametrize("P", [1, 3, 16])
@pytest.mark.parametrize("kind", ["gab", "random"])
def test_slot_inverse_maps_real_positions_and_marks_the_rest(kind, P):
    """``columns.slot_inverse`` (built on the tensors' device, here the
    CPU) equals the host layout's ``inv`` on the real positions and is -1
    on the engine's pad rows, which the host ``inv`` sends to slot B-1 —
    a real slot on a full last partition; cached with ``perm``."""
    t, lay = _layout(kind, P)
    perm, valid = T(lay.perm), T(lay.valid)
    inv = columns.slot_inverse(perm, valid, t.m_pad)
    assert inv.dtype == torch.int32 and inv.shape == (t.m_pad,)
    np.testing.assert_array_equal(inv.numpy()[:t.m], lay.inv[:t.m])
    assert (inv.numpy()[t.m:] == -1).all()
    assert (lay.inv[t.m:] == lay.B - 1).all()
    assert columns.slot_inverse(perm, valid, t.m_pad) is inv
    # each real position's slot holds it back
    real = inv[:t.m].long()
    assert torch.equal(perm[real], torch.arange(t.m, dtype=torch.int32))
    assert bool(valid[real].all())


def test_slot_inverse_refuses_a_layout_it_cannot_invert():
    t, lay = _layout("random", 3)
    s = np.flatnonzero(lay.valid)
    twice = lay.perm.copy()
    twice[s[1]] = twice[s[0]]
    with pytest.raises(ValueError, match="two valid slots"):
        columns.slot_inverse(T(twice), T(lay.valid), t.m_pad)
    past = lay.perm.copy()
    past[s[0]] = t.m_pad
    with pytest.raises(ValueError, match="outside"):
        columns.slot_inverse(T(past), T(lay.valid), t.m_pad)
    # a cached map is rebuilt when perm changes in place
    perm = T(lay.perm.copy())
    valid = T(lay.valid)
    columns.slot_inverse(perm, valid, t.m_pad)
    perm[s[0]] = t.m_pad
    with pytest.raises(ValueError, match="outside"):
        columns.slot_inverse(perm, valid, t.m_pad)


def test_binned_scale_masks_update_on_an_engine_pad_row_matches_jax():
    """Binned K4 with updates at the engine's pad positions [m, m_pad)
    (no slot holds them; the host ``inv`` would send them to slot B-1):
    the twin and the reference leave every slot's masks as they were."""
    t, lay = _layout("gab", 5)
    rng = np.random.default_rng(9)
    H, W, U = 3, 2, 32
    base = np.where(rng.random(t.m_pad) < 0.5,
                    rng.integers(0, 500, t.m_pad),
                    np.iinfo(np.int32).min).astype(np.int32)
    pos = rng.integers(0, t.m, (H, U)).astype(np.int32)
    tt = rng.integers(0, 900, (H, U)).astype(np.int32)
    pos[:, :6] = rng.integers(t.m, t.m_pad, (H, 6))     # engine pad rows
    tt[:, :6] = 899
    pos[:, -2:], tt[:, -2:] = 0, np.iinfo(np.int32).min
    thr = rng.integers(0, 900, H * W).astype(np.int32)
    assert (lay.inv[pos[:, :6]] == lay.B - 1).all()
    want = _jax_hop_masks(base, pos, tt, thr, H, W, lay.perm, lay.valid)
    got = columns.scale_hop_masks(T(base), T(pos), T(tt), T(thr), H, W,
                                  perm=T(lay.perm), valid=T(lay.valid))
    np.testing.assert_array_equal(got.numpy(), want)
    calm = tt.copy()
    calm[:, :6] = np.iinfo(np.int32).min
    np.testing.assert_array_equal(got.numpy(), _jax_hop_masks(
        base, pos, calm, thr, H, W, lay.perm, lay.valid))


# ------------------------- K5-P / K6-P twins against the unbinned twins

def _flat_layout(t):
    """A layout of ``t`` that does not pre-aggregate (U = 0)."""
    for P in (64, 256, t.n_pad):
        lay = part.build_layout(t.e_src, t.e_dst, t.n_pad, t.m, P)
        if not lay.spec.preagg:
            return lay
    raise AssertionError("every layout of the table pre-aggregates")


@pytest.mark.parametrize("op", ["cc", "bfs", "sssp_directed"])
@pytest.mark.parametrize("preagg", [True, False], ids=["U>0", "U=0"])
def test_binned_min_twins_bitwise_the_unbinned(preagg, op):
    """K5-P's and K6-P's twins (their buckets where the layout has them)
    give the unbinned K5 / K6 twins' labels and distances bit for bit,
    with equal supersteps, on the same masks."""
    from raphtory_tpu_torch.engine.device_sweep import DeviceEdges

    t, lay = _layout("gab", 3)
    if not preagg:
        lay = _flat_layout(t)
    assert lay.spec.preagg == preagg
    be = lay.device_edges("cpu", reverse=True)
    assert (be.U > 0) == preagg
    edges = DeviceEdges(*(T(getattr(t, f)) for f in DeviceEdges._fields))
    rng = np.random.default_rng(5)
    H, W = 3, 2
    C = H * W
    me = rng.random((t.m_pad, C)) < 0.6
    me[t.m:] = False
    me[:, 1] = False
    mv = rng.random((t.n_pad, C)) < 0.85
    mv[t.n:] = False
    me_b = me[lay.perm] & lay.valid[:, None]
    if op == "cc":
        want = thb._cc_columns(T(me), T(mv), edges, t.n_pad, 40)
        got = thb._cc_columns(T(me_b), T(mv), be, t.n_pad, 40)
    else:
        seed = np.zeros(t.n_pad, bool)
        seed[rng.choice(t.n, 3, replace=False)] = True
        ew = rng.choice(np.array([-0.25, 0.0, 0.5, 2.75], np.float32),
                        (t.m_pad, H))
        directed = op == "sssp_directed"
        w, w_b = (None, None) if op == "bfs" else (T(ew), T(ew[lay.perm]))
        want = thb._bfs_columns(T(me), T(mv), edges, t.n_pad, 40, directed,
                                T(seed), w, W)
        got = thb._bfs_columns(T(me_b), T(mv), be, t.n_pad, 40, directed,
                               T(seed), w_b, W)
    assert torch.equal(got[0], want[0]) and got[1] == want[1] > 1
