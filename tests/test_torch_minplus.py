"""The min-combine kernels' plain twins (``raphtory_tpu_torch/ops/minplus.py``
K5/K6, and K6w in ``ops/columns.py``) and the traversal loops around them
against the JAX package's own functions (``_cc_columns``, ``_bfs_columns``
and the weight rebuild inside ``run_columns_delta``) on the same numpy
inputs: BITWISE equal labels, distances and advanced state, equal superstep
counts. Inputs carry pad edges and pad rows, an all-masked column, columns
that halt (and freeze) at different supersteps, and warm starts."""

import functools

import jax
import numpy as np
import pytest
import torch
from test_sweep import random_log
from test_torch_columns import _view

from raphtory_tpu.engine import hopbatch as jhb
from raphtory_tpu.utils.synth import gab_like_log
from raphtory_tpu_torch.core.sweep import SweepBuilder
from raphtory_tpu_torch.engine import hopbatch as thb
from raphtory_tpu_torch.engine.device_sweep import DeviceEdges, GlobalTables
from raphtory_tpu_torch.interop import event_log_from_arrays
from raphtory_tpu_torch.ops import columns, minplus

T = torch.from_numpy
I32_MAX = np.iinfo(np.int32).max


@pytest.fixture(autouse=True)
def _unbinned_reference(monkeypatch):
    monkeypatch.setenv("RTPU_PCPM", "0")


@functools.lru_cache(maxsize=None)
def _tables(kind):
    if kind == "gab":
        jlog = gab_like_log(600, 5_000, t_span=1_000)
    else:
        jlog = random_log(np.random.default_rng(3), n_events=800, n_ids=60,
                          t_span=100)
    return GlobalTables(SweepBuilder(event_log_from_arrays(jlog.arrays()),
                                     track_rows=False, preseed_pairs=True))


def _edges(t):
    return DeviceEdges(*(T(getattr(t, f)) for f in DeviceEdges._fields))


def _masks(t, rng, C):
    me = rng.random((t.m_pad, C)) < 0.5
    me[t.m:] = False                       # pad edges carry no mask
    me[:, 1] = False                       # an all-masked edge column
    mv = rng.random((t.n_pad, C)) < 0.85
    mv[t.n:] = False                       # pad rows
    mv[:, 3] = False                       # an empty view
    return me, mv


@functools.lru_cache(maxsize=None)
def _jax_cc(n_pad, max_steps, warm):
    def run(me, mv, e_src, e_dst, l_init):
        return jhb._cc_columns(me, mv, e_src, e_dst, n_pad, max_steps,
                               tile_budget=256 << 20,
                               l_init=l_init if warm else None)
    return jax.jit(run)


@functools.lru_cache(maxsize=None)
def _jax_bfs(n_pad, max_steps, directed, weighted, warm):
    def run(me, mv, e_src, e_dst, seed, ew, d_init):
        return jhb._bfs_columns(me, mv, e_src, e_dst, n_pad, max_steps,
                                directed, seed, ew if weighted else 1.0,
                                tile_budget=256 << 20,
                                d_init=d_init if warm else None)
    return jax.jit(run)


# max_steps=2 stops mid-propagation: the Jacobi step order must match
@pytest.mark.parametrize("max_steps", [2, 60])
@pytest.mark.parametrize("warm", [False, True])
@pytest.mark.parametrize("kind", ["gab", "random"])
def test_cc_columns_twin_bitwise(kind, warm, max_steps):
    t = _tables(kind)
    rng = np.random.default_rng(7)
    C = 6
    me, mv = _masks(t, rng, C)
    l_init = rng.integers(0, t.n_pad, (t.n_pad, C)).astype(np.int32)
    want, want_steps = _jax_cc(t.n_pad, max_steps, warm)(
        me, mv, t.e_src, t.e_dst, l_init)
    got, steps = thb._cc_columns(T(me), T(mv), _edges(t), t.n_pad,
                                 max_steps,
                                 l_init=T(l_init) if warm else None)
    assert got.shape == (C, t.n_pad) and got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert steps == int(want_steps)
    assert (got.numpy()[3] == I32_MAX).all()
    if max_steps == 60:
        assert steps < max_steps   # every column halted


@pytest.mark.parametrize("max_steps", [2, 40])
@pytest.mark.parametrize("warm", [False, True])
@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("directed", [False, True])
@pytest.mark.parametrize("kind", ["gab", "random"])
def test_bfs_columns_twin_bitwise(kind, directed, weighted, warm,
                                  max_steps):
    """Weights span negative, zero and fractional values: the min-plus
    relaxation is exact whatever their sign (no integer reinterpretation
    of floats)."""
    t = _tables(kind)
    rng = np.random.default_rng(11)
    H, W = 3, 2
    C = H * W
    me, mv = _masks(t, rng, C)
    seed = np.zeros(t.n_pad, bool)
    seed[rng.choice(t.n, 3, replace=False)] = True
    ew = rng.choice(np.array([-0.25, 0.0, 0.5, 1.0, 2.75, 7.0],
                             np.float32), (t.m_pad, H))
    d_init = np.where(rng.random((t.n_pad, C)) < 0.3,
                      rng.integers(0, 6, (t.n_pad, C)),
                      np.inf).astype(np.float32)
    want, want_steps = _jax_bfs(t.n_pad, max_steps, directed, weighted,
                                warm)(me, mv, t.e_src, t.e_dst, seed,
                                      np.repeat(ew, W, axis=1), d_init)
    got, steps = thb._bfs_columns(
        T(me), T(mv), _edges(t), t.n_pad, max_steps, directed, T(seed),
        T(ew) if weighted else None, W,
        d_init=T(d_init) if warm else None)
    assert got.shape == (C, t.n_pad) and got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert steps == int(want_steps)
    assert np.isfinite(got.numpy()).any()


def _np_superstep(cur, me, mv, e_src, e_dst, halted, pay, both, fill):
    """One synchronous min-combine superstep in numpy, written from the
    reference loop body (``hopbatch.py:580-588``, ``:662-670``)."""
    agg = np.full_like(cur, fill)
    pairs = [(e_src, e_dst)] + ([(e_dst, e_src)] if both else [])
    for a, b in pairs:
        vals = np.where(me, pay(cur[a]), fill)
        np.minimum.at(agg, b, vals)
    new = np.where(mv, np.minimum(cur, agg), fill)
    col_done = (new == cur).all(0)
    return np.where(halted[None, :], cur, new), halted | col_done


@pytest.mark.parametrize("op", ["cc", "bfs", "sssp_directed"])
def test_superstep_twins_freeze_and_halt(op):
    """One superstep with a column frozen BEFORE it: the frozen column keeps
    its state, halting is judged over every row, the all-halted flag
    follows; ``cur``/``nxt`` swap."""
    t = _tables("random")
    rng = np.random.default_rng(5)
    H, W = 2, 3
    C = H * W
    me, mv = _masks(t, rng, C)
    edges = _edges(t)
    halted = np.zeros(C, bool)
    halted[[0, 4]] = True
    if op == "cc":
        cur = np.where(mv, rng.integers(0, t.n_pad, (t.n_pad, C)),
                       I32_MAX).astype(np.int32)
        pay, fill, both = (lambda x: x), I32_MAX, True
    else:
        cur = np.where(mv & (rng.random((t.n_pad, C)) < 0.3),
                       rng.integers(0, 4, (t.n_pad, C)),
                       np.inf).astype(np.float32)
        fill, both = np.float32(np.inf), op == "bfs"
        ew = rng.random((t.m_pad, H)).astype(np.float32)
        w = np.float32(1.0) if op == "bfs" else np.repeat(ew, W, axis=1)
        pay = lambda x: x + w   # noqa: E731
    want, want_halted = _np_superstep(cur, me, mv, t.e_src, t.e_dst, halted,
                                      pay, both, fill)
    st = minplus.min_state(T(cur.copy()))
    st.halted[:] = T(halted)
    first = st.cur
    if op == "cc":
        minplus.cc_superstep(st, T(me), T(mv), edges)
    else:
        minplus.minplus_superstep(st, T(me), T(mv), edges,
                                  directed=op != "bfs",
                                  ew=None if op == "bfs" else T(ew), W=W)
    assert st.nxt is first                       # swapped
    np.testing.assert_array_equal(st.cur.numpy(), want)
    np.testing.assert_array_equal(st.cur.numpy()[:, [0, 4]],
                                  cur[:, [0, 4]])
    np.testing.assert_array_equal(st.halted.numpy(), want_halted)
    assert want_halted[1] and want_halted[3]     # empty columns halt
    assert bool(st.done) == bool(want_halted.all())
    # a second superstep from the frozen state: everything still agrees
    want2, halted2 = _np_superstep(want, me, mv, t.e_src, t.e_dst,
                                   want_halted, pay, both, fill)
    if op == "cc":
        minplus.cc_superstep(st, T(me), T(mv), edges)
    else:
        minplus.minplus_superstep(st, T(me), T(mv), edges,
                                  directed=op != "bfs",
                                  ew=None if op == "bfs" else T(ew), W=W)
    np.testing.assert_array_equal(st.cur.numpy(), want2)
    np.testing.assert_array_equal(st.halted.numpy(), halted2)


@pytest.mark.parametrize("h0", [False, True])
@pytest.mark.parametrize("directed", [False, True])
def test_weight_rebuild_matches_reference(directed, h0):
    """K6w inside ``run_columns_delta``: the same (pos, val) weight deltas
    (pads included, hop 0's only with ``h0``) onto the same base give the
    same distances, steps and advanced base — its weight state included —
    as the JAX package's ``_compiled_delta``."""
    t = _tables("random")
    rng = np.random.default_rng(13 + h0)
    hops, windows = [30, 60, 90], [1000, 20]
    H = len(hops)
    tdt = t.tdtype
    base = (rng.integers(0, 100, t.m_pad).astype(tdt),
            rng.random(t.m_pad) < 0.7,
            rng.integers(0, 100, t.n_pad).astype(tdt),
            rng.random(t.n_pad) < 0.9)

    def deltas(length, k):
        out = []
        for _ in range(H):
            p = rng.choice(length, k, replace=False).astype(np.int32)
            out.append((p, rng.integers(0, 100, k).astype(tdt),
                        rng.random(k) < 0.6))
        return out

    de, dv = deltas(t.m, 40), deltas(t.n, 10)
    w_base = rng.choice(np.array([0.5, 1.0, 3.0], np.float32), t.m_pad)
    wd = []
    for h in range(H):
        k = int(rng.integers(5, 60))
        wd.append((rng.choice(t.m, k, replace=False).astype(np.int32),
                   (rng.random(k) * 4 - 0.5).astype(np.float32)))
    seed = np.zeros(t.n_pad, bool)
    seed[:4] = True
    kw = dict(algo_args=(30, directed), weight_base=w_base, weight_deltas=wd,
              h0_delta=h0)
    want, want_steps, want_adv = jhb.run_columns_delta(
        "bfs", t, base, de, dv, hops, windows, seed_mask=seed, **kw)
    got, steps, adv = thb.run_columns_delta(
        "bfs", t, base, de, dv, hops, windows, edges=_edges(t),
        seed_mask=T(seed), **kw)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert steps == int(want_steps)
    assert len(adv) == len(want_adv) == 5
    for g, w in zip(adv, want_adv):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_weights_from_deltas_twin():
    base = T(np.arange(6, dtype=np.float32))
    pad = 2**31 - 1
    pos = T(np.array([[5, pad, 0], [1, 2, pad], [pad, pad, pad]], np.int32))
    val = T(np.array([[9, 9, 9], [-1, -2, 9], [9, 9, 9]], np.float32))
    for h0 in (False, True):
        ew, cur = columns.weights_from_deltas(base, pos, val, 3, h0)
        first = [9.0, 1, 2, 3, 4, 9] if h0 else [0.0, 1, 2, 3, 4, 5]
        assert ew[:, 0].tolist() == first
        assert ew[:, 1].tolist() == first[:1] + [-1, -2] + first[3:]
        assert torch.equal(ew[:, 2], ew[:, 1]) and torch.equal(cur, ew[:, 2])
    assert base.tolist() == list(range(6))       # the base is not touched
    with pytest.raises(ValueError, match="twice"):
        columns.weights_from_deltas(
            base, T(np.array([[3, 3]], np.int32)).repeat(2, 1),
            torch.zeros((2, 2)), 2, False)


def _jax_weight_rebuild(base, pos, val, H, h0):
    """``raphtory_tpu/engine/hopbatch.py:374-384``'s weight rebuild (inside
    the jitted ``_compiled_delta``) on its own: the hop's (pos, val) deltas
    scatter-set into the running state (``mode="drop"``: pads fall away),
    the state the hop's column. W = 1: the reference broadcasts each
    column to the hop's W windows, the port keeps it once."""
    import jax.numpy as jnp

    cur, cols = jnp.asarray(base), []
    for h in range(H):
        if h or h0:
            cur = cur.at[jnp.asarray(pos[h])].set(jnp.asarray(val[h]),
                                                  mode="drop")
        cols.append(cur)
    return np.asarray(jnp.stack(cols, axis=1)), np.asarray(cur)


@pytest.mark.parametrize("h0", [False, True])
def test_weights_from_deltas_twin_matches_the_jax_rebuild_at_h70(h0):
    """K6w's twin against the JAX rebuild at H 70 (two groups of 64 hops
    on the card's path): rows updated at many hops, at one, and never; pads
    (2^31-1, the host's only pad); the [len, H] block and the advanced
    state bitwise."""
    H, length, U = 70, 300, 9
    rng = np.random.default_rng(70 + h0)
    base = (rng.random(length) * 4 - 1).astype(np.float32)
    pos = np.full((H, U), 2**31 - 1, np.int32)
    val = np.zeros((H, U), np.float32)
    for h in range(H):
        k = int(rng.integers(1, U + 1))
        every = [3] if h % 5 else [3, 4]          # row 3 in every hop
        rest = rng.choice(np.arange(5, length), k - len(every),
                          replace=False) if k > len(every) else []
        pos[h, :k] = np.concatenate([every, rest])[:k]
        val[h, :k] = rng.random(k) * 5 - 0.5
    want_ew, want_cur = _jax_weight_rebuild(base, pos, val, H, h0)
    ew, cur = columns.weights_from_deltas(T(base), T(pos), T(val), H, h0)
    np.testing.assert_array_equal(ew.numpy(), want_ew)
    np.testing.assert_array_equal(cur.numpy(), want_cur)
    touched = np.unique(pos[0 if h0 else 1:][pos[0 if h0 else 1:] < length])
    assert 3 in touched and len(touched) < length          # some never


@pytest.mark.parametrize("kind", ["gab", "random"])
def test_source_index_orders_the_real_edges(kind):
    t = _tables(kind)
    perm = t.out_perm
    assert perm.dtype == np.int32 and len(perm) == t.m
    assert sorted(perm.tolist()) == list(range(t.m))   # pads left out
    key = t.e_src[perm].astype(np.int64) << 32 | t.e_dst[perm]
    assert (np.diff(key) > 0).all()                    # (src, dst) order
    assert t.out_indptr[0] == 0 and t.out_indptr[-1] == t.m
    rows = np.repeat(np.arange(t.n_pad), np.diff(t.out_indptr))
    np.testing.assert_array_equal(rows, t.e_src[perm])


def test_superstep_wrappers_check_inputs_and_count_only_launches():
    t = _tables("random")
    edges = _edges(t)
    columns.reset_launches()
    me = torch.zeros((t.m_pad, 2), dtype=torch.bool)
    mv = torch.ones((t.n_pad, 2), dtype=torch.bool)
    st = minplus.min_state(torch.zeros((t.n_pad, 2), dtype=torch.int32))
    with pytest.raises(TypeError, match="cur"):
        minplus.minplus_superstep(st, me, mv, edges, True)
    with pytest.raises(ValueError, match="shape"):
        minplus.cc_superstep(st, me[:5], mv, edges)
    with pytest.raises(TypeError, match="in_indptr"):
        minplus.cc_superstep(st, me, mv, edges._replace(
            in_indptr=edges.in_indptr.int()))
    fst = minplus.min_state(torch.zeros((t.n_pad, 2)))
    with pytest.raises(ValueError, match="ew"):
        minplus.minplus_superstep(fst, me, mv, edges, True,
                                  ew=torch.ones((t.m_pad, 2)), W=2)
    with pytest.raises(ValueError, match="H x W"):
        minplus.minplus_superstep(fst, me, mv, edges, True,
                                  ew=torch.ones((t.m_pad, 1)), W=3)
    # CPU tensors run the twins, which launch no kernel; no edge is
    # masked in, so every column halts at once
    minplus.cc_superstep(st, me, mv, edges)
    minplus.minplus_superstep(fst, me, mv, edges, False)
    assert bool(st.done) and bool(fst.done)
    assert columns.LAUNCHES == {k: 0 for k in columns.LAUNCHES}


def test_superstep_grid_keeps_k5_k6_within_264_blocks():
    """K5/K6's grid: a block holds 256 // G rows of G = min(ceil(C / 4),
    32) lanes (a lane 4 columns; wider C tiles the columns over the
    grid's second dimension); at most 264 blocks along the rows, one busy
    word a block and column, every row reached."""
    for n, C in ((10, 12), (32_768, 12), (5, 300), (100_000, 1),
                 (4_099, 9), (16_384, 20)):
        gx = minplus.superstep_grid(n, C)
        rows = 256 // min(-(-C // 4), 32)
        assert 1 <= gx <= 264 and (gx == 264 or gx * rows >= n)
        st = minplus.min_state(torch.zeros((n, C), dtype=torch.int32))
        assert st.busy.shape == (gx, C) and st.busy.dtype == torch.int32


# ------------------------------------- the card branch (modelled kernel)

def _model_min(calls, rows, cc):
    """``rtpu_cc_superstep`` (``cc``) / ``rtpu_minplus_superstep`` as numpy
    over the wrapper's raw host addresses: per row the min over its
    in-walk entries (entry j the edge ``in_order[j]``, or j itself when
    ``in_order`` is null; far end ``in_rows[e]``) and, CC or undirected,
    its out-walk's, of the masked payloads (``cur`` at the far end, plus 1
    or ``ew[e, c // W]`` as one f32 add); then the epilogue — mask, the
    halting test over every row, the freeze — into ``nxt``."""
    def model(*a):
        if cc:
            (n, C, gx, ip, order, in_rows, op_, oorder, out_rows, me, mv,
             cur, nxt, halted, done, busy, ticket, stream) = a
            W, H, directed, ew = 1, C, False, None
            dt, fill = np.int32, I32_MAX
        else:
            (n, C, W, H, gx, directed, ew, ip, order, in_rows, op_, oorder,
             out_rows, me, mv, cur, nxt, halted, done, busy, ticket,
             stream) = a
            dt, fill = np.float32, np.float32(np.inf)
        calls.append(dict(order=order, in_rows=in_rows, out_order=oorder,
                          out_rows=out_rows, gx=gx, directed=directed))
        m = rows["m"]
        mk = _view(me, np.uint8, m * C).reshape(m, C) != 0
        x = _view(cur, dt, n * C).reshape(n, C)
        w = None if ew is None else np.repeat(
            _view(ew, np.float32, m * H).reshape(m, H), W, axis=1)
        agg = np.full((n, C), fill, dt)

        def walk(indptr, order, far):
            ipa = _view(indptr, np.int64, n + 1)
            k = int(ipa[-1])
            e = (np.arange(k) if order is None
                 else _view(order, np.int32, k).astype(np.int64))
            vals = x[_view(far, np.int32, m)[e]]
            if not cc:
                vals = vals + (np.float32(1) if w is None else w[e])
            vals = np.where(mk[e], vals, fill)
            np.minimum.at(agg, np.repeat(np.arange(n), np.diff(ipa)), vals)

        walk(ip, order, in_rows)
        if not directed:
            walk(op_, oorder, out_rows)
        alive = _view(mv, np.uint8, n * C).reshape(n, C) != 0
        new = np.where(alive, np.minimum(x, agg), fill)
        hl = _view(halted, np.uint8, C)
        settled = (new == x).all(0)
        _view(nxt, dt, n * C).reshape(n, C)[:] = np.where(hl[None, :] != 0,
                                                          x, new)
        hl[:] = hl | settled
        _view(done, np.uint8, 1)[0] = hl.all()
        return 0
    return model


@pytest.fixture
def min_card(monkeypatch):
    """K5 / K6 / K5-P / K6-P's card branch on CPU tensors through the numpy
    model, with a fresh signature cache; ``rows["m"]`` is the mask's row
    count."""
    calls, rows = [], {}
    names = ("cc_superstep", "minplus_superstep", "binned_cc_superstep",
             "binned_minplus_superstep")
    for mod in (columns, minplus):
        monkeypatch.setattr(mod, "_on_cuda", lambda name, *t: name in names)
    monkeypatch.setattr(minplus, "_stream", lambda t: 0)
    monkeypatch.setattr(minplus, "_fn", lambda lib, fn: _model_min(
        calls, rows, fn == "rtpu_cc_superstep"))
    monkeypatch.setattr(columns, "_K2_SIGS", {})
    columns.reset_launches()
    yield calls, rows
    columns.reset_launches()


def _twins(fn):
    """``fn()`` with every kernel on its twin."""
    saved = minplus._on_cuda, columns._on_cuda
    minplus._on_cuda = columns._on_cuda = lambda name, *t: False
    try:
        return fn()
    finally:
        minplus._on_cuda, columns._on_cuda = saved


@pytest.mark.parametrize("op", ["cc", "bfs", "sssp", "sssp_directed"])
@pytest.mark.parametrize("route", ["flat", "preagg", "no_preagg"])
def test_min_card_branch_is_one_launch_a_superstep(min_card, route, op):
    """The CC / BFS / SSSP loops through the modelled kernel's card
    branch, unbinned and binned on layouts with and without buckets: one
    launch a superstep, the walks passed as they are (the unbinned
    destination walk the table itself; binned, the layout's walk reading
    ``b_src`` straight, no bucket buffer), results bitwise the twins'."""
    from raphtory_tpu_torch.ops import partition as part

    calls, rows = min_card
    t = _tables("gab")
    rng = np.random.default_rng(13)
    H, W = 3, 2
    C = H * W
    me, mv = _masks(t, rng, C)
    ew = rng.choice(np.array([-0.25, 0.0, 0.5, 2.75], np.float32),
                    (t.m_pad, H))
    edges = _edges(t)
    if route != "flat":
        for P in ((3,) if route == "preagg" else (64, 256, t.n_pad)):
            lay = part.build_layout(t.e_src, t.e_dst, t.n_pad, t.m, P)
            if lay.spec.preagg == (route == "preagg"):
                break
        assert lay.spec.preagg == (route == "preagg")
        edges = lay.device_edges("cpu", reverse=True)
        me, ew = me[lay.perm] & lay.valid[:, None], ew[lay.perm]
    rows["m"] = me.shape[0]
    seed = np.zeros(t.n_pad, bool)
    seed[[0, 5, 9]] = True
    if op == "cc":
        run = functools.partial(thb._cc_columns, T(me), T(mv), edges,
                                t.n_pad, 40)
    else:
        run = functools.partial(
            thb._bfs_columns, T(me), T(mv), edges, t.n_pad, 40,
            op == "sssp_directed", T(seed),
            None if op == "bfs" else T(ew), W)
    want, want_steps = _twins(run)
    got, steps = run()
    assert torch.equal(got, want) and steps == want_steps > 1
    name = ("binned_" if route != "flat" else "") + (
        "cc_superstep" if op == "cc" else "minplus_superstep")
    assert columns.LAUNCHES[name] == len(calls) == steps
    assert sum(columns.LAUNCHES.values()) == steps
    order = None if route == "flat" else edges.in_order.data_ptr()
    far = (edges.e_src if route == "flat" else edges.b_src).data_ptr()
    assert {(c["order"], c["in_rows"]) for c in calls} == {(order, far)}
    if op == "sssp_directed" and route != "flat":
        assert {c["out_order"] for c in calls} == {None}


def test_min_wrappers_check_a_changed_signature_again(monkeypatch):
    """The card branch checks each input signature once — a loop sees two,
    ``cur`` and ``nxt`` swapping every superstep — and a wrong dtype or
    shape, a new tensor or a cached one changed in place, still raises."""
    monkeypatch.setattr(columns, "_on_cuda", lambda name, *t: True)
    monkeypatch.setattr(minplus, "_on_cuda", lambda name, *t: True)
    monkeypatch.setattr(minplus, "_stream", lambda t: 0)
    monkeypatch.setattr(minplus, "_fn", lambda lib, fn: lambda *a: 0)
    monkeypatch.setattr(columns, "_K2_SIGS", {})
    checks = []
    expect = minplus._expect
    monkeypatch.setattr(minplus, "_expect", lambda *a: (
        checks.append(a[2]), expect(*a)))
    t = _tables("random")
    edges = _edges(t)
    C = 4
    me = torch.zeros((t.m_pad, C), dtype=torch.bool)
    mv = torch.ones((t.n_pad, C), dtype=torch.bool)
    st = minplus.min_state(torch.zeros((t.n_pad, C), dtype=torch.int32))
    for _ in range(5):
        minplus.cc_superstep(st, me, mv, edges)
    assert checks.count("cur") == 2 and checks.count("busy") == 2
    with pytest.raises(TypeError, match="me"):
        minplus.cc_superstep(st, me.to(torch.uint8), mv, edges)
    with pytest.raises(ValueError, match="me has shape"):
        minplus.cc_superstep(st, me[:, :-1], mv, edges)
    mv.unsqueeze_(0)                          # the cached tensor, reshaped
    with pytest.raises(ValueError, match="mv"):
        minplus.cc_superstep(st, me, mv, edges)
    mv.squeeze_(0)
    checks.clear()
    st.halted[0] = True                       # an in-place change
    minplus.cc_superstep(st, me, mv, edges)
    assert checks.count("halted") == 1
    # K6 keys its checks on the weights, the direction and W too
    fst = minplus.min_state(torch.zeros((t.n_pad, C)))
    ew = torch.ones((t.m_pad, 2))
    for _ in range(3):
        minplus.minplus_superstep(fst, me, mv, edges, False, ew, 2)
    with pytest.raises(ValueError, match="ew"):
        minplus.minplus_superstep(fst, me, mv, edges, False, ew[:, :1], 2)
    with pytest.raises(ValueError, match="H x W"):
        minplus.minplus_superstep(fst, me, mv, edges, False, ew, 3)
    ew.unsqueeze_(0)
    with pytest.raises(ValueError, match="ew"):
        minplus.minplus_superstep(fst, me, mv, edges, False, ew, 2)
    assert columns.LAUNCHES["cc_superstep"] == 6
