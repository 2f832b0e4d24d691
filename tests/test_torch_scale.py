"""K3 (``ops/columns.column_masks``) and K4 (``scale_hop_masks``) through
their plain twins, and the bulk-loaded runners around them
(``engine/hopbatch.run_columns`` over ``bulk_hop_columns``,
``run_scale_columns`` over ``bulk_hop_deltas``), against the JAX package's
functions on the same numpy inputs: masks bitwise, PageRank within the
reference's own tolerance (rtol 1e-5 / atol 1e-7 — f32 sums in another
order) with equal superstep counts, or, where a tol halting test sits on
float noise, the check of ``test_torch_bsp.assert_pagerank_steps``."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_bsp import assert_pagerank_steps
from test_torch_columns import _view

from raphtory_tpu.core import bulk as jbulk
from raphtory_tpu.engine import hopbatch as jhb
from raphtory_tpu_torch.core import bulk as tbulk
from raphtory_tpu_torch.engine import hopbatch as thb
from raphtory_tpu_torch.ops import columns

T = torch.from_numpy


@pytest.fixture(autouse=True)
def _unbinned_reference(monkeypatch):
    # the reference stays on the unbinned, untiled route at every size
    monkeypatch.setenv("RTPU_PCPM", "0")
    monkeypatch.delenv("RTPU_SCALE_MASKS", raising=False)


def _stream(seed, n_events=2500, n_ids=60, t_span=300):
    """An add-only stream whose pair (0, 0) — engine position 0 of both
    tables — gets an update in every hop of ``HOPS``."""
    rng = np.random.default_rng(seed)
    src = rng.integers(0, n_ids, n_events).astype(np.int64)
    dst = rng.integers(0, n_ids, n_events).astype(np.int64)
    times = rng.integers(0, t_span, n_events).astype(np.int64)
    src[:8] = dst[:8] = 0
    times[:8] = [5, 70, 90, 140, 160, 210, 250, 290]
    order = np.argsort(times, kind="stable")
    return src[order], dst[order], times[order]


HOPS = [80, 150, 220, 299]
WINDOWS = [100_000, 120, 40, None]


@functools.lru_cache(maxsize=None)
def _jax_k3(tdt):
    return jax.jit(functools.partial(jhb._column_masks, jnp.dtype(tdt)))


def _jax_masks(tdt, cols, hops, windows):
    _, _, hop_of_col, T_col, w_col = jhb._column_layout(hops, windows)
    me, mv = _jax_k3(np.dtype(tdt).name)(*cols, hop_of_col, T_col, w_col)
    return np.asarray(me), np.asarray(mv)


def _k3_args(cols, hops, windows, tdt):
    H, C, hop_of_col, T_col, w_col = thb._column_layout(hops, windows)
    info = np.iinfo(tdt)
    lo = np.clip(T_col - w_col, info.min, info.max).astype(tdt)
    return (*(T(a) for a in cols), T(hop_of_col), T(lo), T(w_col < 0))


@pytest.mark.parametrize("windows", [
    [-1], [1000, 25, -1], [7, 0],
    # 3 hops x 11 windows = 33 columns: past one of the kernel's
    # 32-column tiles
    [-1, 0, 1, 3, 5, 7, 10, 20, 40, 80, 1000]],
    ids=["unwindowed", "mixed", "windowed", "two_column_tiles"])
@pytest.mark.parametrize("tdt", [np.int32, np.int64], ids=["i32", "i64"])
@pytest.mark.parametrize("seed", [0, 1])
def test_column_masks_twin_matches_jax(seed, tdt, windows):
    """Random fold columns, times at the dtype's bounds among them."""
    rng = np.random.default_rng(seed)
    info = np.iinfo(tdt)
    vals = np.concatenate([[info.min, info.min + 1, info.max - 1, info.max],
                           rng.integers(-100, 100, 40)])
    H, m, n = 3, 300, 70
    cols = (rng.choice(vals, (H, m)).astype(tdt), rng.random((H, m)) < 0.6,
            rng.choice(vals, (H, n)).astype(tdt), rng.random((H, n)) < 0.6)
    hops = [info.max - 2, 0, 50] if tdt == np.int32 else [1 << 61, 0, 50]
    want = _jax_masks(tdt, cols, hops, windows)
    got = columns.column_masks(*_k3_args(cols, hops, windows, tdt))
    for w, g in zip(want, got):
        assert g.dtype == torch.bool and g.is_contiguous()
        np.testing.assert_array_equal(g.numpy(), w)


# ------------------------------------- K3 / KB1's card branch, modelled

_NP = {4: np.int32, 8: np.int64}


def _model_k3(calls, tbytes, binned):
    """``rtpu_column_masks_*`` / ``rtpu_bin_column_masks_*`` over the
    wrapper's raw addresses: the bounds read from the HOST array (3C int64:
    hop_of_col, lo, nowin), one launch a group of ``COLUMN_GROUP`` columns,
    and in each group every distinct hop's (lat, alive) row read once (the
    record ``calls`` keeps each group's hops) and compared against each of
    that hop's columns; KB1's edge row b reads entity ``perm[b]``, 0 where
    ``!valid[b]``."""
    tdt = _NP[tbytes]
    G = columns.COLUMN_GROUP

    def model(*a):
        if binned:
            (B, m, n, H, C, e_lat, e_alive, v_lat, v_alive, bounds, perm,
             valid, me, mv, stream, launched) = a
        else:
            (m, n, H, C, e_lat, e_alive, v_lat, v_alive, bounds, me, mv,
             stream, launched) = a
            B = m
        b = np.ctypeslib.as_array(bounds, (3 * C,)).copy()
        hop, lo, nowin = b[:C], b[C:2 * C], b[2 * C:]
        info = np.iinfo(tdt)
        assert ((hop >= 0) & (hop < H)).all()
        assert ((lo >= info.min) & (lo <= info.max)).all()
        assert set(nowin.tolist()) <= {0, 1}
        rows = np.arange(B)
        live = np.ones(B, bool)
        if binned:
            rows = _view(perm, np.int32, B).astype(np.int64)
            live = _view(valid, np.uint8, B) != 0
            rows = np.where(live, rows, 0)
        groups = []
        for lat_a, al_a, out_a, length, idx, ok in (
                (e_lat, e_alive, me, m, rows, live),
                (v_lat, v_alive, mv, n, np.arange(n), np.ones(n, bool))):
            lat = _view(lat_a, tdt, H * length).reshape(H, length)
            alive = _view(al_a, np.uint8, H * length).reshape(H, length)
            out = _view(out_a, np.uint8, len(idx) * C).reshape(len(idx), C)
            for c0 in range(0, C, G):
                cols = range(c0, min(C, c0 + G))
                hops = list(dict.fromkeys(int(hop[c]) for c in cols))
                groups.append(hops)
                for h in hops:
                    lt, al = lat[h][idx], (alive[h][idx] != 0) & ok
                    for c in cols:
                        if hop[c] == h:
                            out[:, c] = al & (bool(nowin[c])
                                              | (lt >= tdt(lo[c])))
        launched._obj.value += -(-C // G) if C and B + n else 0
        calls.append(dict(C=C, groups=groups))
        return 0
    return model


@pytest.fixture
def k3_card(monkeypatch):
    """K3's and KB1's card branch on CPU tensors: ``_on_cuda`` says True
    and the C entry points are ``_model_k3``; ``torch.tensor`` and
    ``torch.from_numpy`` record every call (the bounds must not become a
    tensor)."""
    calls, made = [], []
    monkeypatch.setattr(columns, "_on_cuda", lambda name, *ts: True)
    monkeypatch.setattr(columns, "_stream", lambda t: 0)
    monkeypatch.setattr(columns, "_fn", lambda lib, fn: _model_k3(
        calls, 4 if fn.endswith("i32") else 8, "bin" in fn))
    for fn in ("tensor", "from_numpy"):
        real = getattr(torch, fn)
        monkeypatch.setattr(torch, fn, lambda *a, _real=real, _fn=fn, **kw:
                            made.append(_fn) or _real(*a, **kw))
    columns.reset_launches()
    yield calls, made
    columns.reset_launches()


#: (hops, windows) of C = 12, 32, 33 and 70 columns: one group of 64, and
#: two
K3_GRIDS = {12: (4, [1000, 25, -1]), 32: (4, [-1, 0, 1, 3, 5, 7, 20, 90]),
            33: (3, [-1, 0, 1, 3, 5, 7, 10, 20, 40, 80, 1000]),
            70: (7, [-1, 0, 2, 4, 8, 16, 32, 64, 128, 1 << 40])}


def _k3_case(rng, tdt, C, m=300, n=70):
    H, windows = K3_GRIDS[C]
    info = np.iinfo(tdt)
    vals = np.concatenate([[info.min, info.min + 1, info.max - 1, info.max],
                           rng.integers(-100, 100, 40)])
    cols = (rng.choice(vals, (H, m)).astype(tdt), rng.random((H, m)) < 0.6,
            rng.choice(vals, (H, n)).astype(tdt), rng.random((H, n)) < 0.6)
    hops = ([info.max - 2] if tdt == np.int32 else [1 << 61]) \
        + [int(x) for x in rng.integers(-50, 60, H - 1)]
    return cols, hops, [None if w < 0 else w for w in windows]


@pytest.mark.parametrize("C", sorted(K3_GRIDS))
@pytest.mark.parametrize("tdt", [np.int32, np.int64], ids=["i32", "i64"])
def test_column_masks_card_branch_passes_bounds_by_value(k3_card, tdt, C):
    """K3's card branch hands the column bounds to the C entry as one host
    int64 array — no tensor is made of them — and launches once a group of
    64 columns, each group reading its distinct hops once; the modelled
    kernel equals the twin and the JAX package's ``_column_masks``
    (``raphtory_tpu/engine/hopbatch.py:50``) bit for bit."""
    calls, made = k3_card
    cols, hops, windows = _k3_case(np.random.default_rng(C), tdt, C)
    want = _jax_masks(tdt, cols, hops, windows)
    H, _, hop_of_col, T_col, w_col = thb._column_layout(hops, windows)
    info = np.iinfo(tdt)
    lo = np.clip(T_col - w_col, info.min, info.max).astype(tdt)
    dev_cols = tuple(T(a) for a in cols)
    del made[:]
    got = columns.column_masks(*dev_cols, hop_of_col, lo, w_col < 0)
    assert made == []
    assert columns.LAUNCHES["column_masks"] == -(-C // 64)
    assert [g for c in calls for g in c["groups"]][:-(-C // 64)] == [
        sorted(set(hop_of_col[c0:c0 + 64].tolist()))
        for c0 in range(0, C, 64)]
    for g, w in zip(got, want):
        assert g.dtype == torch.bool and g.is_contiguous()
        np.testing.assert_array_equal(g.numpy(), w)
    twin = columns.column_masks_plain(*dev_cols, T(hop_of_col), T(lo),
                                      T(w_col < 0))
    assert all(torch.equal(g, w) for g, w in zip(got, twin))
    # the bounds as Python sequences give the same bits
    seq = columns.column_masks(*dev_cols, hop_of_col.tolist(), lo.tolist(),
                               (w_col < 0).tolist())
    assert all(torch.equal(g, w) for g, w in zip(seq, got))


def test_column_masks_card_branch_checks_its_bounds(k3_card):
    """The bounds are checked on the host before the launch: a hop outside
    ``[0, H)``, a ``lo`` outside the time dtype, a device tensor, a length
    that differs from ``hop_of_col``'s."""
    calls, _ = k3_card
    cols, hops, windows = _k3_case(np.random.default_rng(9), np.int32, 12)
    dev_cols = tuple(T(a) for a in cols)
    hoc = np.repeat(np.arange(4, dtype=np.int32), 3)
    lo, nowin = np.zeros(12, np.int32), np.zeros(12, bool)
    with pytest.raises(ValueError, match="outside"):
        columns.column_masks(*dev_cols, hoc + 1, lo, nowin)
    with pytest.raises(ValueError, match="outside"):
        columns.column_masks(*dev_cols, hoc, [1 << 40] * 12, nowin)
    with pytest.raises(TypeError, match="lo"):
        columns.column_masks(*dev_cols, hoc, lo.astype(np.int64), nowin)
    with pytest.raises(ValueError, match="nowin"):
        columns.column_masks(*dev_cols, hoc, lo, nowin[:-1])
    with pytest.raises(ValueError, match="host arrays"):
        columns.column_masks(*dev_cols, hoc, torch.zeros(
            12, dtype=torch.int32, device="meta"), nowin)
    assert calls == [] and columns.LAUNCHES["column_masks"] == 0


@pytest.mark.parametrize("layout", [False, True])
def test_dispatch_columns_uploads_only_the_fold_columns(layout,
                                                        monkeypatch):
    """``_dispatch_columns`` puts the four fold columns on the device in
    ONE upload and nothing else: the bulk loader's plain numpy columns
    packed into one staging buffer at 16-byte offsets, the column bounds
    reaching K3 / KB1 as host arrays."""
    from raphtory_tpu_torch.ops import resident

    src, dst, times = _stream(3)
    tbg, *cols = tbulk.bulk_hop_columns(src, dst, times, HOPS)
    lay = None
    if layout:
        from raphtory_tpu_torch.ops import partition

        lay = partition.build_layout(tbg.e_src, tbg.e_dst, tbg.n_pad, tbg.m,
                                     3)
    upload, uploaded = resident.upload, []
    monkeypatch.setattr(resident, "upload", lambda data, dev: uploaded.append(
        data) or upload(data, dev))
    monkeypatch.setattr(thb, "_put", lambda a, dev: pytest.fail(
        "a column uploaded on its own"))
    H, W, me, mv = thb._dispatch_columns(tbg, cols, HOPS, WINDOWS, "cpu",
                                         lay)
    assert len(uploaded) == 1
    offs, _ = resident.offsets16(c.nbytes for c in cols)
    assert uploaded[0].numel() == offs[-1] + cols[-1].nbytes
    for c, off in zip(cols, offs):
        np.testing.assert_array_equal(
            uploaded[0][off: off + c.nbytes].numpy().view(c.dtype).reshape(
                c.shape), c)
    want = _jax_masks(np.int32, cols, HOPS, WINDOWS)
    if lay is not None:
        want = (want[0][lay.perm] & lay.valid[:, None], want[1])
    for g, w in zip((me, mv), want):
        np.testing.assert_array_equal(g.numpy(), w)


@pytest.mark.parametrize("windows", [WINDOWS, [None], [40, 3]],
                         ids=["mixed", "unwindowed", "windowed"])
@pytest.mark.parametrize("seed", [0, 1])
def test_scale_hop_masks_twin_matches_jax_column_masks(seed, windows):
    """K4's running scatter-max + threshold masks over the bulk deltas
    equal the JAX package's masks over the host-built bulk columns — the
    pads (position 0, INT32_MIN) are no-ops, and the real updates to
    position 0 (the pair (0, 0), vertex 0) land."""
    src, dst, times = _stream(seed)
    jcols = jbulk.bulk_hop_columns(src, dst, times, HOPS)
    want_e, want_v = _jax_masks(np.int32, jcols[1:], HOPS, windows)
    bulk, base_e, base_v, d_e, d_v = tbulk.bulk_hop_deltas(src, dst, times,
                                                           HOPS)
    assert bulk.e_src[0] == bulk.e_dst[0] == 0
    assert all(0 in p for p, _ in d_e[1:]) and all(0 in p for p, _ in d_v[1:])
    _, _, de_pos, de_t, dv_pos, dv_t, thr, _ = thb.prepare_scale_payload(
        d_e, d_v, HOPS, windows, device="cpu")
    assert int((de_pos[1:] == 0).sum()) > len(HOPS) - 1   # pads at 0 too
    H, W = len(HOPS), len(windows)
    got_e = columns.scale_hop_masks(T(base_e), de_pos, de_t, thr, H, W)
    got_v = columns.scale_hop_masks(T(base_v), dv_pos, dv_t, thr, H, W)
    np.testing.assert_array_equal(got_e.numpy(), want_e)
    np.testing.assert_array_equal(got_v.numpy(), want_v)
    # ... and K3 over the port's own bulk columns gives the same bits
    cols = tbulk.bulk_hop_columns(src, dst, times, HOPS)[1:]
    k3_e, k3_v = columns.column_masks(*_k3_args(cols, HOPS, windows,
                                                np.int32))
    assert torch.equal(k3_e, got_e) and torch.equal(k3_v, got_v)


def _pagerank_close(want, got, run_port, run_ref, tol):
    """Ranks within the tolerance; equal supersteps, or (``tol`` > 0) a
    halting test that sits on float noise (``test_torch_bsp``): the
    ``run_*`` callables map a step count to that side's ranks at tol 0."""
    (w, ws), (g, gs) = want, got
    w = np.asarray(w)
    assert g.shape == w.shape and g.dtype == torch.float32
    np.testing.assert_allclose(g.numpy(), w, rtol=1e-5, atol=1e-7)
    if tol == 0.0:
        assert gs == int(ws)
    else:
        assert_pagerank_steps(gs, ws, run_port, run_ref, tol)


@pytest.mark.parametrize("max_steps, tol", [(12, 0.0), (40, 1e-7)])
@pytest.mark.parametrize("seed", [2, 3])
def test_run_scale_columns_matches_jax(seed, max_steps, tol):
    src, dst, times = _stream(seed)
    jin = jbulk.bulk_hop_deltas(src, dst, times, HOPS)
    tin = tbulk.bulk_hop_deltas(src, dst, times, HOPS)

    def ref(steps, tol=0.0):
        return jhb.run_scale_columns(*jin, HOPS, WINDOWS, tol=tol,
                                     max_steps=steps)

    def port(steps, tol=0.0):
        return thb.run_scale_columns(*tin, HOPS, WINDOWS, tol=tol,
                                     max_steps=steps, device="cpu")

    got = port(max_steps, tol)
    _pagerank_close(ref(max_steps, tol), got, lambda k: port(k)[0],
                    lambda k: ref(k)[0], tol)
    assert got[1] == max_steps or tol > 0
    sums = got[0].double().sum(1)
    assert torch.allclose(sums, torch.ones_like(sums), atol=1e-4)


@pytest.mark.parametrize("warm", [False, True])
@pytest.mark.parametrize("seed", [4, 5])
def test_run_columns_matches_jax(seed, warm):
    """The bulk host columns through ``run_columns`` (K3 + K2); the warm
    start tiles the previous output's last hop's W rows per hop."""
    src, dst, times = _stream(seed)
    jbg, *jcols = jbulk.bulk_hop_columns(src, dst, times, HOPS)
    tbg, *tcols = tbulk.bulk_hop_columns(src, dst, times, HOPS)
    r_j = r_t = None
    if warm:
        prev = np.random.default_rng(seed).random((6, tbg.n_pad))
        prev = (prev / prev.sum(1, keepdims=True)).astype(np.float32)
        r_j, r_t = jnp.asarray(prev), T(prev)

    def ref(steps, tol=0.0):
        return jhb.run_columns(jbg, *jcols, HOPS, WINDOWS, r_init=r_j,
                               tol=tol, max_steps=steps)

    def port(steps, tol=0.0):
        return thb.run_columns(tbg, *tcols, HOPS, WINDOWS, r_init=r_t,
                               tol=tol, max_steps=steps, device="cpu")

    _pagerank_close(ref(30, 1e-7), port(30, 1e-7), lambda k: port(k)[0],
                    lambda k: ref(k)[0], 1e-7)


def test_scale_and_host_column_routes_agree_bitwise():
    """One add-only stream, two routes to the same masks (K4 from the
    deltas, K3 from the host columns): equal ranks and steps, bit for
    bit."""
    src, dst, times = _stream(6)
    kw = dict(tol=0.0, max_steps=10, device="cpu")
    a = thb.run_scale_columns(*tbulk.bulk_hop_deltas(src, dst, times, HOPS),
                              HOPS, WINDOWS, **kw)
    b = thb.run_columns(*tbulk.bulk_hop_columns(src, dst, times, HOPS),
                        HOPS, WINDOWS, **kw)
    assert torch.equal(a[0], b[0]) and a[1] == b[1] == 10


def test_prepared_payload_is_reused_and_checked():
    src, dst, times = _stream(7)
    bulk, base_e, base_v, d_e, d_v = tbulk.bulk_hop_deltas(src, dst, times,
                                                           HOPS)
    kw = dict(tol=0.0, max_steps=6, device="cpu")
    prep = thb.prepare_scale_payload(d_e, d_v, HOPS, WINDOWS, device="cpu")
    U_e, U_v = prep[:2]
    assert U_e >= 1024 and U_v >= 1024
    assert prep[2].shape == (len(HOPS), U_e) and prep[2].dtype == torch.int32
    fresh = thb.run_scale_columns(bulk, base_e, base_v, d_e, d_v, HOPS,
                                  WINDOWS, **kw)
    reused = thb.run_scale_columns(bulk, T(base_e), T(base_v), d_e, d_v,
                                   HOPS, WINDOWS, prepared=prep, **kw)
    assert torch.equal(fresh[0], reused[0]) and fresh[1] == reused[1]
    with pytest.raises(ValueError, match="different sweep grid"):
        thb.run_scale_columns(bulk, base_e, base_v, d_e, d_v, HOPS,
                              WINDOWS[:2], prepared=prep, **kw)
    with pytest.raises(ValueError, match="different sweep grid"):
        thb.run_scale_columns(bulk, base_e, base_v, d_e, d_v,
                              [h + 1 for h in HOPS], WINDOWS,
                              prepared=prep, **kw)
    other = [d_e[0]] + [(p, t + 1) for p, t in d_e[1:]]
    with pytest.raises(ValueError, match="DIFFERENT delta lists"):
        thb.run_scale_columns(bulk, base_e, base_v, other, d_v, HOPS,
                              WINDOWS, prepared=prep, **kw)


def test_k3_k4_wrappers_check_inputs_and_count_only_launches():
    columns.reset_launches()
    H, m, n = 2, 8, 4
    lat = torch.zeros((H, m), dtype=torch.int32)
    alive = torch.ones((H, m), dtype=torch.bool)
    vlat = torch.zeros((H, n), dtype=torch.int32)
    valive = torch.ones((H, n), dtype=torch.bool)
    hoc = torch.tensor([0, 1, 1], dtype=torch.int32)
    lo = torch.zeros(3, dtype=torch.int32)
    nowin = torch.zeros(3, dtype=torch.bool)
    me, mv = columns.column_masks(lat, alive, vlat, valive, hoc, lo, nowin)
    assert me.shape == (m, 3) and mv.shape == (n, 3) and bool(me.all())
    with pytest.raises(TypeError, match="lo"):
        columns.column_masks(lat, alive, vlat, valive, hoc, lo.long(), nowin)
    with pytest.raises(ValueError, match="v_alive"):
        columns.column_masks(lat, alive, vlat, valive[:, :2], hoc, lo, nowin)
    with pytest.raises(ValueError, match="no hop"):
        columns.column_masks(lat[:0], alive[:0], vlat[:0], valive[:0], hoc,
                             lo, nowin)
    base = torch.full((m,), -(2**31), dtype=torch.int32)
    pos = torch.tensor([[0, 9], [m - 1, -1]], dtype=torch.int32)
    t = torch.tensor([[4, 4], [2, 2]], dtype=torch.int32)
    thr = torch.tensor([0, 3], dtype=torch.int32)
    out = columns.scale_hop_masks(base, pos, t, thr, 2, 1)
    # positions outside [0, len) are dropped; a max never lowers a state
    assert out[:, 0].tolist() == [True] + [False] * (m - 1)
    assert out[:, 1].tolist() == [True] + [False] * (m - 2) + [False]
    with pytest.raises(TypeError, match="d_t"):
        columns.scale_hop_masks(base, pos, t.long(), thr, 2, 1)
    with pytest.raises(ValueError, match="thr"):
        columns.scale_hop_masks(base, pos, t, thr, 2, 2)
    assert columns.LAUNCHES == {k: 0 for k in columns.LAUNCHES}


# ------------------------------------------- the destination-binned route

@pytest.mark.parametrize("P", ["2", "7"])
@pytest.mark.parametrize("seed", [2, 3])
def test_binned_run_scale_columns_matches_jax(seed, P, monkeypatch):
    """``RTPU_PCPM=1``: both packages resolve the layout on the bulk graph;
    K4 advances in engine order and KB1 emits the masks binned. Ranks
    within the reference's tolerance, equal steps (tol 0), and bitwise the
    port's unbinned scale route."""
    monkeypatch.setenv("RTPU_PCPM", "1")
    monkeypatch.setenv("RTPU_PARTITIONS", P)
    src, dst, times = _stream(seed)
    jin = jbulk.bulk_hop_deltas(src, dst, times, HOPS)
    tin = tbulk.bulk_hop_deltas(src, dst, times, HOPS)
    kw = dict(tol=0.0, max_steps=12)
    want = jhb.run_scale_columns(*jin, HOPS, WINDOWS, **kw)
    got = thb.run_scale_columns(*tin, HOPS, WINDOWS, device="cpu", **kw)
    _pagerank_close(want, got, None, None, 0.0)
    monkeypatch.setenv("RTPU_PCPM", "0")
    flat = thb.run_scale_columns(*tin, HOPS, WINDOWS, device="cpu", **kw)
    assert torch.equal(flat[0], got[0]) and flat[1] == got[1]


def test_binned_scale_and_host_column_routes_agree_bitwise(monkeypatch):
    """KB1's two emissions over one add-only stream — from K4's snapshot
    and from the bulk host columns — give the same binned masks, so equal
    ranks and steps, bit for bit."""
    from raphtory_tpu_torch.ops import partition

    monkeypatch.setenv("RTPU_PCPM", "1")
    monkeypatch.setenv("RTPU_PARTITIONS", "3")
    src, dst, times = _stream(6)
    kw = dict(tol=0.0, max_steps=10, device="cpu")
    a = thb.run_scale_columns(*tbulk.bulk_hop_deltas(src, dst, times, HOPS),
                              HOPS, WINDOWS, **kw)
    bg, *cols = tbulk.bulk_hop_columns(src, dst, times, HOPS)
    lay = partition.resolve(bg, bg, partition.tile_budget_bytes())
    assert lay is not None and lay.spec.partitions == 3
    b = thb.run_columns(bg, *cols, HOPS, WINDOWS, layout=lay, **kw)
    assert torch.equal(a[0], b[0]) and a[1] == b[1] == 10


# ------------------------------------------- K4's edge cases, two passes

I32_MIN = np.iinfo(np.int32).min
I32_MAX = np.iinfo(np.int32).max


def _jax_hop_masks(base, d_pos, d_t, thr, H, W, perm=None, valid=None):
    """``_compiled_scale.hop_masks`` as the reference writes it
    (``raphtory_tpu/engine/hopbatch.py:2129-2150``, its unrolled shape;
    binned, its ``col_of`` through ``perm``/``valid``), on jnp arrays."""
    def run(base, d_pos, d_t, thr, perm, valid):
        def col_of(cur, th):
            if perm is not None:
                return (cur[perm][:, None] >= th[None, :]) & valid[:, None]
            return cur[:, None] >= th[None, :]

        cur, cols = base, []
        for h in range(H):
            cur = cur.at[d_pos[h]].max(d_t[h])
            cols.append(col_of(cur, thr[h * W:(h + 1) * W]))
        return jnp.concatenate(cols, axis=1)

    return np.asarray(jax.jit(run)(base, d_pos, d_t, thr, perm, valid))


def _k4_payload(seed, length, H, W, U, negative=False):
    """A K4 payload with every edge case the kernel must keep: row 2
    updated in every hop (times rising, then falling), row 1's INT32_MAX
    base with an update below it, never-seen (INT32_MIN) bases, positions
    >= len (and, with ``negative``, < 0: the reference never ships those,
    its pads sit at 0, and JAX would wrap them), the (0, INT32_MIN) pads,
    unwindowed (0) and extreme thresholds, and the last positions updated
    (the engine's pad rows in ``_k4_layout``)."""
    rng = np.random.default_rng(seed)
    base = rng.integers(-50, 50, length).astype(np.int32)
    base[::7] = I32_MIN
    base[1] = I32_MAX
    pos = rng.integers(0, length, (H, U)).astype(np.int32)
    t = rng.integers(-60, 60, (H, U)).astype(np.int32)
    pos[:, -2:], t[:, -2:] = 0, I32_MIN                  # the pads
    pos[:, 0] = 2
    t[:, 0] = 40 - 20 * np.abs(np.arange(H) - H // 2)    # row 2, every hop
    pos[-1, 1], t[-1, 1] = 1, -60                        # below its base
    pos[0, 2] = length                                   # past the table
    pos[0, 3] = -1 if negative else length + 5
    pos[0, 4] = length - 1                               # a last row
    thr = rng.integers(-55, 55, H * W).astype(np.int32)
    thr[::3] = 0                                         # unwindowed
    if H * W > 2:
        thr[1], thr[-1] = I32_MIN, I32_MAX
    return base, pos, t, thr


def _k4_layout(seed, length):
    """A synthetic binned layout over ``length`` engine positions: slots in
    a random order, 5 cap-pad slots (perm ``length - 1``, invalid), the
    last 3 positions — the engine's pad rows — in no slot."""
    rng = np.random.default_rng(seed)
    real = length - 3
    B = real + 5
    slots = rng.permutation(B)[:real]
    perm = np.full(B, length - 1, np.int32)
    perm[slots] = rng.permutation(real).astype(np.int32)
    valid = np.zeros(B, bool)
    valid[slots] = True
    return perm, valid


K4_SHAPES = [(37, 3, 4, 6), (200, 3, 5, 9), (64, 2, 8, 7), (90, 1, 1, 12),
             (101, 3, 11, 17), (50, 4, 32, 11)]
K4_IDS = ["C12", "C15", "C16", "C1", "C33", "C128"]


@pytest.mark.parametrize("binned", [False, True], ids=["flat", "binned"])
@pytest.mark.parametrize("shape", K4_SHAPES, ids=K4_IDS)
def test_scale_hop_masks_edge_cases_match_jax(shape, binned):
    """K4's twin on ``_k4_payload`` against the reference's hop masks,
    engine-order and binned (an update on an engine pad row included),
    bitwise."""
    length, H, W, U = shape
    base, pos, t, thr = _k4_payload(sum(shape), length, H, W, U)
    perm, valid = _k4_layout(length, length) if binned else (None, None)
    want = _jax_hop_masks(base, pos, t, thr, H, W, perm, valid)
    kw = dict(perm=T(perm), valid=T(valid)) if binned else {}
    got = columns.scale_hop_masks(T(base), T(pos), T(t), T(thr), H, W, **kw)
    assert got.shape == want.shape
    np.testing.assert_array_equal(got.numpy(), want)


def _model_scale_hop_masks(calls):
    """``rtpu_scale_hop_masks`` as numpy over the wrapper's raw host
    addresses, the kernel's two passes: pass A ``out[r] = live(r) &
    (val(r) >= thr)`` (binned: ``val`` read at ``perm[r]``, live where
    ``valid``), then pass B's 1s — each update at a position in ``[0,
    len)`` with ``t != INT32_MIN``, into row ``p`` (binned: ``inv[p]``,
    skipped where -1), at the columns ``[h * W, C)`` it reaches."""
    def model(rows, n, H, W, U, base, pos, t, thr, perm, valid, inv, out,
              stream, launched):
        C = H * W
        calls.append(dict(rows=rows, perm=perm, valid=valid, inv=inv,
                          out=out))
        b = _view(base, np.int32, n)
        th = _view(thr, np.int32, C)
        o = _view(out, np.uint8, rows * C).reshape(rows, C)
        if perm is None:
            live, v = np.ones(rows, bool), b
        else:
            live = _view(valid, np.uint8, rows) != 0
            v = np.where(live, b[np.where(live, _view(perm, np.int32, rows),
                                          0)], 0)
        o[:] = live[:, None] & (v[:, None] >= th[None, :])
        k = 1
        if U > 0 and n > 0:
            k = 2
            p = _view(pos, np.int32, H * U).astype(np.int64)
            tt = _view(t, np.int32, H * U)
            iv = None if perm is None else _view(inv, np.int32, n)
            for g in range(H * U):
                if not 0 <= p[g] < n or tt[g] == I32_MIN:
                    continue
                r = p[g] if iv is None else iv[p[g]]
                if r < 0:
                    continue
                c0 = (g // U) * W
                o[r, c0:] |= tt[g] >= th[c0:]
        launched._obj.value += k
        return 0
    return model


@pytest.mark.parametrize("binned", [False, True], ids=["flat", "binned"])
@pytest.mark.parametrize("shape", K4_SHAPES + [(64, 2, 8, 0)],
                         ids=K4_IDS + ["no_updates"])
def test_scale_hop_masks_card_branch_two_passes(monkeypatch, shape, binned):
    """K4's card branch on CPU tensors through the numpy model of its two
    passes: bitwise the twin's scatter-max on ``_k4_payload`` (negative
    positions included), two launches a call (one with no updates), the
    binned call given ``slot_inverse``'s map, only the output allocated."""
    length, H, W, U = shape
    base, pos, t, thr = (T(a) for a in _k4_payload(
        sum(shape), length, H, W, max(U, 5), negative=True))
    pos, t = pos[:, :U].contiguous(), t[:, :U].contiguous()
    kw = {}
    if binned:
        perm, valid = (T(a) for a in _k4_layout(length, length))
        kw = dict(perm=perm, valid=valid)
    want = columns.scale_hop_masks(base, pos, t, thr, H, W, **kw)
    calls = []
    monkeypatch.setattr(columns, "_on_cuda", lambda name, *ts: True)
    monkeypatch.setattr(columns, "_stream", lambda t: 0)
    monkeypatch.setattr(columns, "_fn", lambda lib, fn: (
        _model_scale_hop_masks(calls)))
    columns.reset_launches()
    got = columns.scale_hop_masks(base, pos, t, thr, H, W, **kw)
    assert torch.equal(got, want)
    assert columns.LAUNCHES["scale_hop_masks"] == (2 if U else 1)
    assert sum(columns.LAUNCHES.values()) == columns.LAUNCHES[
        "scale_hop_masks"]                       # no KB1 beside it
    (call,) = calls
    assert call["out"] == got.data_ptr()
    if binned:
        inv = columns.slot_inverse(perm, valid, length)
        assert call["inv"] == inv.data_ptr()
        assert (call["perm"], call["valid"]) == (perm.data_ptr(),
                                                 valid.data_ptr())
    else:
        assert call["perm"] is call["inv"] is None
    columns.reset_launches()
