"""K10 / K10-P (``ops/features.py``), ``FeatureAggregator`` and
``TemporalEmbeddings`` in the port against the JAX package's
``engine/features.py`` and ``examples/embeddings.py``, on the same logs
(carried across as numpy arrays) and the same host features ``X`` (the
bits of ``jax.random`` cannot be reproduced, so both get one numpy draw).

Tolerances: float32 storage within atol 1e-6 on all ``n_pad`` rows (pad
rows too: they keep their normalised self term); bfloat16 storage within 2
bf16 ulps per element and a cosine above 0.9999 per row (the two
frameworks sum in another order, and one rounding apart moves a bf16
value by an ulp). An element that is a float32 cancellation residue (far
below its row's float32 rounding) is held to 2 float32 ulps of its row's
largest element instead (``_bf16_ulps``). Covers windowed and unwindowed calls, 1-3 rounds, F 16
to 64, an incremental sweep over ascending T, the binned (PCPM) route
with ``RTPU_PCPM=1`` and ``RTPU_PARTITIONS`` (the same spec as the
reference's), ``traffic_bytes`` and ``flops`` equal to the reference's,
the embeddings' ``at`` / ``nearest`` / ``drift``, and K10-P's card
branch driven on the CPU with its C entry point replaced by a numpy model
of the kernel (one launch a round, no bucket buffer, the layout's walk).
"""

import ctypes
import dataclasses

import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch
from test_sweep import random_log

from raphtory_tpu.engine import device_sweep as jds
from raphtory_tpu.engine import features as jfeat
from raphtory_tpu.examples import embeddings as jemb
from raphtory_tpu_torch.engine import device_sweep as tds
from raphtory_tpu_torch.engine import features as tfeat
from raphtory_tpu_torch.examples import embeddings as temb
from raphtory_tpu_torch.interop import event_log_from_arrays
from raphtory_tpu_torch.ops import columns, partition
from raphtory_tpu_torch.ops import features as ops_features


@pytest.fixture(autouse=True)
def _unbinned_reference(monkeypatch):
    monkeypatch.setenv("RTPU_PCPM", "0")
    monkeypatch.setenv("RTPU_PREFETCH", "0")


def _pair(seed, n_events=900, n_ids=60, t_span=100, dtype="float32",
          F=32, self_weight=0.3):
    jlog = random_log(np.random.default_rng(seed), n_events=n_events,
                      n_ids=n_ids, t_span=t_span)
    jfa = jfeat.FeatureAggregator(jds.DeviceSweep(jlog), feature_dim=F,
                                  self_weight=self_weight, dtype=dtype)
    fa = tfeat.FeatureAggregator(
        tds.DeviceSweep(event_log_from_arrays(jlog.arrays()), device="cpu"),
        feature_dim=F, self_weight=self_weight, dtype=dtype)
    X = np.random.default_rng(100 + seed).standard_normal(
        (fa.ds.n_pad, F)).astype(np.float32)
    return jfa, fa, X


def _bf16_ulps(got, want):
    """|got - want| in bf16 ulps of ``want`` (both bf16-valued), where an
    element below its row's float32 noise floor — a cancellation residue
    ``self_weight * h + (1 - self_weight) * mean`` whose two terms cancel
    to within float32 rounding, kept by bf16's wide exponent — counts in
    units of 1 float32 ulp of the row's largest element instead (a
    residue of ~1e-9 in a row of ~0.5 is no bf16 error of the result)."""
    w = want.astype(np.float32)
    ulp = np.spacing(np.abs(w).astype(ml_dtypes.bfloat16)).astype(
        np.float32)
    floor = np.spacing(np.abs(w).max(axis=1, keepdims=True))
    return np.abs(got.astype(np.float32) - w) / np.maximum(ulp, floor)


def assert_features_match(got, want, dtype):
    """The module docstring's tolerance, on every row."""
    got = got.float().numpy()
    want = (want.float().numpy() if isinstance(want, torch.Tensor)
            else np.asarray(jnp.asarray(want).astype(jnp.float32)))
    assert got.shape == want.shape
    if dtype == "float32":
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
        return
    assert _bf16_ulps(got, want).max() <= 2
    num = np.sum(got * want, axis=1)
    den = np.linalg.norm(got, axis=1) * np.linalg.norm(want, axis=1)
    live = den > 0
    assert (num[live] / den[live] > 0.9999).all()


def _run(jfa, fa, X, T, window, rounds):
    want = jfa.propagate(jnp.asarray(X), T, window=window, rounds=rounds)
    got = fa.propagate(torch.from_numpy(X), T, window=window, rounds=rounds)
    return got, want


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("seed,F,window,rounds",
                         [(0, 32, None, 2), (1, 16, 30, 1), (2, 64, 7, 3),
                          (3, 32, 60, 2), (4, 48, None, 3)])
def test_propagate_matches_reference(seed, F, window, rounds, dtype):
    jfa, fa, X = _pair(seed, dtype=dtype, F=F)
    for T in (40, 99):
        got, want = _run(jfa, fa, X, T, window, rounds)
        assert got.dtype == fa.dtype and tuple(got.shape) == (fa.ds.n_pad, F)
        assert_features_match(got, want, dtype)
    assert fa._active_spec is None and jfa._active_spec is None


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_incremental_sweep_over_ascending_times(dtype):
    """Ascending calls ride one sweep (the resident buffers advance by
    deltas); each equals the reference's call at that T."""
    jfa, fa, X = _pair(7, n_events=1_200, dtype=dtype)
    outs = []
    for T in (20, 40, 40, 59, 80, 99):
        got, want = _run(jfa, fa, X, T, 25, 2)
        assert_features_match(got, want, dtype)
        outs.append(got.float())
        assert fa.ds.t_now == T
    assert not torch.allclose(outs[0], outs[-1])   # the window moved


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("P", ["2", "5"])
def test_binned_route_matches_reference(P, dtype, monkeypatch):
    """``RTPU_PCPM=1``: the port resolves the reference's spec and runs
    K10-P's twin; within the same tolerance of the reference's binned
    run, and of its own unbinned run."""
    monkeypatch.setenv("RTPU_PCPM", "1")
    monkeypatch.setenv("RTPU_PARTITIONS", P)
    jfa, fa, X = _pair(5, n_events=1_500, n_ids=120, dtype=dtype)
    for T, window in ((50, None), (99, 30)):
        got, want = _run(jfa, fa, X, T, window, 2)
        assert fa._active_spec is not None
        assert tuple(fa._active_spec) == tuple(jfa._active_spec)
        assert fa._active_spec.partitions == int(P)
        assert_features_match(got, want, dtype)
        monkeypatch.setenv("RTPU_PCPM", "0")
        flat = fa.propagate(torch.from_numpy(X), T, window=window, rounds=2)
        monkeypatch.setenv("RTPU_PCPM", "1")
        assert_features_match(got, flat, dtype)


def test_binned_gate_follows_the_reference(monkeypatch):
    """The tile-budget gate declines the binned route where the reference
    does (``features.py:167-192``)."""
    monkeypatch.setenv("RTPU_PCPM", "1")
    monkeypatch.setenv("RTPU_PARTITIONS", "2")
    jfa, fa, X = _pair(8, n_events=1_500, n_ids=120)
    assert fa._pcpm_layout() is not None
    spec = fa._pcpm_layout().spec
    # a budget under one [cap, F] f32 tile: both decline
    monkeypatch.setenv("RTPU_TILE_BUDGET_MB", "0")
    assert fa._pcpm_layout() is None and jfa._pcpm_layout() is None
    monkeypatch.delenv("RTPU_TILE_BUDGET_MB")
    monkeypatch.setenv("RTPU_PCPM", "auto")    # tiny graph: auto declines
    assert fa._pcpm_layout() is None and jfa._pcpm_layout() is None
    assert spec.preagg


@pytest.mark.parametrize("pcpm", ["0", "1"])
def test_traffic_and_flops_equal_the_reference(pcpm, monkeypatch):
    monkeypatch.setenv("RTPU_PCPM", pcpm)
    monkeypatch.setenv("RTPU_PARTITIONS", "3")
    for dtype in ("float32", "bfloat16"):
        jfa, fa, X = _pair(9, n_events=1_500, n_ids=120, dtype=dtype, F=24)
        _run(jfa, fa, X, 70, 40, 2)
        assert (fa._active_spec is None) == (pcpm == "0")
        for rounds in (1, 2, 3):
            assert fa.traffic_bytes(rounds) == jfa.traffic_bytes(rounds)
            assert fa.flops(rounds) == jfa.flops(rounds)


def test_twin_chunks_and_wide_times():
    """The twin's edge chunks do not change its sums' meaning (a
    chunk of a few edges against one chunk), and int64 resident times clip
    the window bound to their own range."""
    jfa, fa, X = _pair(10)
    fa.propagate(torch.from_numpy(X), 80, window=20, rounds=1)
    e_lat, e_alive = fa.ds.edge_state
    H = torch.from_numpy(X)
    lo, nowin = ops_features.window_bound(80, 20, e_lat.dtype)
    one = ops_features.propagate_round_plain(H, fa.ds.edges, e_lat, e_alive,
                                             lo, nowin, 0.5, 1 << 22)
    small = ops_features.propagate_round_plain(H, fa.ds.edges, e_lat,
                                               e_alive, lo, nowin, 0.5, 8)
    np.testing.assert_allclose(small.numpy(), one.numpy(), atol=1e-6)
    assert ops_features.window_bound(5, -1, torch.int32) == (6, True)
    assert ops_features.window_bound(-2**31, 5, torch.int32)[0] == -2**31
    assert ops_features.window_bound(2**40, -2**40, torch.int32)[0] \
        == 2**31 - 1
    assert ops_features.window_bound(2**40, 1, torch.int64)[0] == 2**40 - 1


def test_random_features_are_unit_norm_rows():
    _, fa, _ = _pair(11, dtype="bfloat16")
    X = fa.random_features(3)
    assert X.dtype == torch.bfloat16 and X.shape == (fa.ds.n_pad, fa.F)
    np.testing.assert_allclose(torch.linalg.norm(X.float(), dim=1).numpy(),
                               1.0, atol=1e-2)
    assert torch.equal(X, fa.random_features(3))
    assert not torch.equal(X, fa.random_features(4))
    with pytest.raises(ValueError, match="advance"):
        tfeat.FeatureAggregator(fa.ds.__class__(fa.ds.sw.log, device="cpu"),
                                feature_dim=8).propagate(
            torch.zeros(fa.ds.n_pad, 8))


def test_wrappers_check_their_inputs():
    _, fa, X = _pair(12)
    fa.propagate(torch.from_numpy(X), 60, rounds=1)
    e_lat, e_alive = fa.ds.edge_state
    with pytest.raises(TypeError, match="H"):
        ops_features.propagate_round(torch.from_numpy(X).double(),
                                     fa.ds.edges, e_lat, e_alive, 0, True,
                                     0.5)
    with pytest.raises(ValueError, match="e_alive"):
        ops_features.propagate_round(torch.from_numpy(X), fa.ds.edges,
                                     e_lat, e_alive[:-1], 0, True, 0.5)
    with pytest.raises(ValueError, match="shape"):
        fa.propagate(torch.from_numpy(X[:, :4]), 60)


# ------------------------------------------------------------ embeddings

def _embeddings(monkeypatch, seed, dim=16):
    """(JAX, port) ``TemporalEmbeddings`` fed the same host ``X`` on every
    (re)build."""
    jlog = random_log(np.random.default_rng(seed), n_events=900, n_ids=60,
                      t_span=100)
    n_pad = tds.DeviceSweep(event_log_from_arrays(jlog.arrays()),
                            device="cpu").n_pad
    X = np.random.default_rng(seed).standard_normal(
        (n_pad, dim)).astype(np.float32)
    X /= np.linalg.norm(X, axis=1, keepdims=True)
    monkeypatch.setattr(jfeat.FeatureAggregator, "random_features",
                        lambda self, seed=0: jnp.asarray(X))
    monkeypatch.setattr(tfeat.FeatureAggregator, "random_features",
                        lambda self, seed=0, generator=None:
                        torch.from_numpy(X))
    return (jemb.TemporalEmbeddings(jlog, dim=dim),
            temb.TemporalEmbeddings(event_log_from_arrays(jlog.arrays()),
                                    dim=dim, device="cpu"))


def test_embeddings_at_and_backward_rebuild(monkeypatch):
    je, te = _embeddings(monkeypatch, 13)
    for T, w in ((60, 30), (90, None), (40, 20)):   # the last one rebuilds
        got, want = te.at(T, w), je.at(T, w)
        assert got.shape == want.shape == (te.ds.n, 16)
        np.testing.assert_allclose(got, np.asarray(want), atol=1e-6)
    assert te.ds.t_now == 40


def test_embeddings_nearest_and_drift(monkeypatch):
    je, te = _embeddings(monkeypatch, 14)
    vid = int(te.ds.uv[3])
    got, want = te.nearest(vid, 80, window=40, k=5), \
        je.nearest(vid, 80, window=40, k=5)
    assert len(got) == len(want) == 5
    np.testing.assert_allclose([s for _, s in got], [s for _, s in want],
                               atol=1e-5)
    # ids agree wherever the similarity is not tied within float noise
    sims = [s for _, s in want]
    for i, ((gv, _), (wv, _)) in enumerate(zip(got, want)):
        tied = any(abs(sims[i] - sims[j]) < 1e-5
                   for j in range(len(sims)) if j != i)
        assert tied or gv == wv
    with pytest.raises(KeyError):
        te.nearest(-12345, 80)
    np.testing.assert_allclose(te.drift(85, 99, 30), je.drift(85, 99, 30),
                               atol=1e-5)
    with pytest.raises(ValueError, match="t0"):
        te.drift(50, 40, 10)


def test_embeddings_default_features_drive_the_port(monkeypatch):
    """Without an injected X the port draws its own (a torch Generator)."""
    jlog = random_log(np.random.default_rng(15), n_events=500, n_ids=40,
                      t_span=80)
    te = temb.TemporalEmbeddings(event_log_from_arrays(jlog.arrays()),
                                 dim=8, device="cpu")
    H = te.at(70, 30)
    assert H.shape == (te.ds.n, 8) and np.isfinite(H).all()
    np.testing.assert_allclose(np.linalg.norm(H, axis=1), 1.0, atol=1e-5)
    assert dataclasses.is_dataclass(te) is False


def test_twitter_like_log_is_the_reference_generator():
    """``bench_scale_features``'s log: the port's ``twitter_like_log`` is
    the reference's generator statement for statement (docstrings aside),
    so it gives the reference's events at any shape, the bench's
    ``(2^22, 2^25, seed 11)`` included; and the arrays agree at a cut
    shape."""
    import ast
    import inspect

    from raphtory_tpu.utils import synth as jsynth
    from raphtory_tpu_torch.utils import synth

    def body(fn):
        tree = ast.parse(inspect.getsource(fn))
        for node in ast.walk(tree):
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)) \
                    and ast.get_docstring(node) is not None:
                node.body = node.body[1:]
        return ast.dump(tree)

    for name in ("twitter_like_log", "gab_like_log", "gab_like_arrays"):
        assert body(getattr(synth, name)) == body(getattr(jsynth, name))
    got = synth.twitter_like_log(1 << 12, 1 << 15).arrays()
    want = jsynth.twitter_like_log(1 << 12, 1 << 15).arrays()
    for k in ("time", "kind", "src", "dst"):
        np.testing.assert_array_equal(got[k], want[k])


# ------------------------------------- K10-P's card branch, kernel modelled

def _view(addr, dtype, n):
    """``n`` elements of ``dtype`` at a host address, as numpy."""
    if not n:
        return np.zeros(0, dtype)
    nbytes = n * np.dtype(dtype).itemsize
    return np.ctypeslib.as_array((ctypes.c_uint8 * nbytes).from_address(
        addr)).view(dtype)


def _model_walk(n_pad, F, fdtype, tbytes, lo, nowin, sw, sw1, ip, src, edge,
                e_lat, e_alive, H, out):
    """``ring_kernel`` as numpy: each destination row walks its entries
    ``ip[r] .. ip[r+1]`` — source row ``src[j]``, mask read at edge
    ``edge[j]`` — and adds the source rows of ``H`` in walk order (float32
    adds, one at a time), then the epilogue, written to ``out``."""
    m_pad = int(edge.max()) + 1 if len(edge) else 0
    lat = _view(e_lat, np.int32 if tbytes == 4 else np.int64, m_pad)
    alive = _view(e_alive, np.uint8, m_pad)
    store = np.float32 if fdtype == 0 else np.uint16
    h = _view(H, store, n_pad * F).reshape(n_pad, F)
    h = (h if fdtype == 0 else (h.astype(np.uint32) << 16)
         .view(np.float32))
    sw, sw1 = np.float32(sw), np.float32(sw1)
    rows = np.zeros((n_pad, F), np.float32)
    for r in range(n_pad):
        acc = np.zeros(F, np.float32)
        deg = 0
        for s, e in zip(src[ip[r]:ip[r + 1]], edge[ip[r]:ip[r + 1]]):
            if alive[e] and (nowin or lat[e] >= lo):
                acc = acc + h[s]
                deg += 1
        inv = np.float32(1) / np.float32(max(deg, 1))
        rows[r] = sw * h[r] + sw1 * (acc * inv)
    nrm = np.maximum(np.sqrt(np.sum(rows * rows, axis=1,
                                    dtype=np.float32)), np.float32(1e-12))
    y = torch.from_numpy(rows / nrm[:, None])
    y = y if fdtype == 0 else y.to(torch.bfloat16).view(torch.int16)
    _view(out, store, n_pad * F)[:] = y.numpy().reshape(-1).view(store)


def _model_binned(calls):
    """K10-P's C entry over the raw host addresses the wrapper passes: the
    walk read as ``walk``'s (source row, edge) pairs, the mask at each
    pair's edge (``_model_walk``). Records each call's arguments in
    ``calls``."""
    def model(n_pad, F, fdtype, tbytes, lo, nowin, sw, sw1, indptr, walk,
              e_lat, e_alive, H, out, stream):
        calls.append(dict(indptr=indptr, walk=walk, H=H, out=out,
                          n_pad=n_pad, F=F))
        ip = _view(indptr, np.int64, n_pad + 1)
        wk = _view(walk, np.int32, 2 * int(ip[-1])).reshape(-1, 2)
        _model_walk(n_pad, F, fdtype, tbytes, lo, nowin, sw, sw1, ip,
                    wk[:, 0], wk[:, 1], e_lat, e_alive, H, out)
        return 0
    return model


def _model_k10(calls):
    """K10's C entry (``rtpu_feature_propagate``) over the raw host
    addresses: entry j of the destination CSR is edge j itself, source row
    ``e_src[j]``, its mask read at j (``_model_walk`` with the implicit
    walk ``(e_src[j], j)``). Records each call's arguments in ``calls``."""
    def model(n_pad, F, fdtype, tbytes, lo, nowin, sw, sw1, indptr, e_src,
              e_lat, e_alive, H, out, stream):
        calls.append(dict(kernel="k10", indptr=indptr, e_src=e_src, H=H,
                          out=out, n_pad=n_pad, F=F))
        ip = _view(indptr, np.int64, n_pad + 1)
        m = int(ip[-1])
        _model_walk(n_pad, F, fdtype, tbytes, lo, nowin, sw, sw1, ip,
                    _view(e_src, np.int32, m), np.arange(m), e_lat, e_alive,
                    H, out)
        return 0
    return model


@pytest.fixture
def binned_card_branch(monkeypatch):
    """K10-P's card branch on CPU tensors: ``_on_cuda`` says True and the
    C entry point is ``_model_binned``; records the model's calls and the
    shapes every ``torch.empty*`` allocated."""
    calls, shapes = [], []
    monkeypatch.setattr(ops_features, "_on_cuda", lambda name, *t: True)
    monkeypatch.setattr(ops_features, "_stream", lambda t: 0)
    monkeypatch.setattr(ops_features, "_fn",
                        lambda lib, fn: _model_binned(calls))
    for fn in ("empty", "empty_like"):
        real = getattr(torch, fn)

        def record(*a, _real=real, **kw):
            t = _real(*a, **kw)
            shapes.append(tuple(t.shape))
            return t
        monkeypatch.setattr(torch, fn, record)
    columns.reset_launches()
    yield calls, shapes
    columns.reset_launches()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("P", ["2", "5"])
def test_binned_card_branch_is_one_launch_a_round(binned_card_branch, P,
                                                  dtype, monkeypatch):
    """``FeatureAggregator`` on the binned route through K10-P's card
    branch: one launch a round, no ``[U, F]`` bucket buffer, the layout's
    CSR and its walk pairs handed to the kernel; the modelled kernel
    equals the twin and the JAX package's binned route within the module
    docstring's tolerance."""
    calls, shapes = binned_card_branch
    monkeypatch.setenv("RTPU_PCPM", "1")
    monkeypatch.setenv("RTPU_PARTITIONS", P)
    jfa, fa, X = _pair(5, n_events=1_500, n_ids=120, dtype=dtype)
    for T, window in ((50, None), (99, 30)):
        want = jfa.propagate(jnp.asarray(X), T, window=window, rounds=2)
        columns.reset_launches()
        del calls[:], shapes[:]
        got = fa.propagate(torch.from_numpy(X), T, window=window, rounds=2)
        assert columns.LAUNCHES["feature_propagate_binned"] == 2
        assert len(calls) == 2
        assert_features_match(got, want, dtype)
        lay = fa._pcpm_layout()
        be = lay.device_edges(fa.ds.device)
        assert (be.U, fa.F) not in shapes
        walk = ops_features.binned_walk(be)
        s = be.in_order.long()
        assert calls[0]["indptr"] == be.in_indptr.data_ptr()
        assert calls[0]["walk"] == walk.data_ptr()
        assert torch.equal(walk, torch.stack(
            [be.u_src[be.slot[s].long()], be.perm[s]], 1))
        # against the twin round by round
        e_lat, e_alive = fa.ds.edge_state
        lo, nowin = ops_features.window_bound(
            T, -1 if window is None else window, e_lat.dtype)
        H = torch.from_numpy(X).to(fa.dtype)
        one = ops_features.propagate_round_binned(H, be, e_lat, e_alive, lo,
                                                  nowin, fa.self_weight)
        twin = ops_features.propagate_round_binned_plain(
            H, be, e_lat, e_alive, lo, nowin, fa.self_weight)
        assert_features_match(one, twin, dtype)


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("P", [2, 5, 64])
def test_binned_walk_reaches_k10s_edges_in_k10s_order(P, seed):
    """Why K10-P equals K10 bit for bit: the layout's destination walk
    visits the engine edges in engine order (``perm[in_order[j]] == j``)
    and each entry's bucket names the edge's source
    (``u_src[slot[in_order[j]]] == e_src[j]``), so the walk pairs are
    ``(e_src[j], j)``. The kernel reads the pairs and never relies on
    this."""
    rng = np.random.default_rng(seed)
    n_pad, m = 512, 3_000
    pairs = np.unique(rng.integers(0, 400, (m, 2)), axis=0)
    pairs = pairs[np.lexsort((pairs[:, 0], pairs[:, 1]))]   # (dst, src)
    m = len(pairs)
    e_src = np.full(m + 77, n_pad - 1, np.int32)
    e_dst = np.full(m + 77, n_pad - 1, np.int32)
    e_src[:m], e_dst[:m] = pairs[:, 0], pairs[:, 1]
    lay = partition.build_layout(e_src, e_dst, n_pad, m, P)
    assert lay.spec.partitions == P
    _, order = lay.walk()
    np.testing.assert_array_equal(lay.perm[order], np.arange(m))
    np.testing.assert_array_equal(lay.u_src[lay.slot[order]], e_src[:m])
    walk = ops_features.binned_walk(lay.device_edges("cpu"))
    np.testing.assert_array_equal(walk.numpy(), np.stack(
        [e_src[:m], np.arange(m, dtype=np.int32)], 1))


# ------------------------------------------ K10's card branch, modelled

@pytest.fixture
def card_branch(monkeypatch):
    """K10's and K10-P's card branch on CPU tensors: ``_on_cuda`` says True
    and the C entry points are ``_model_k10`` / ``_model_binned``; records
    the models' calls."""
    calls = []
    monkeypatch.setattr(ops_features, "_on_cuda", lambda name, *t: True)
    monkeypatch.setattr(ops_features, "_stream", lambda t: 0)
    monkeypatch.setattr(ops_features, "_fn", lambda lib, fn: (
        _model_k10(calls) if fn == "rtpu_feature_propagate"
        else _model_binned(calls)))
    columns.reset_launches()
    yield calls
    columns.reset_launches()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("window", [None, 30])
def test_k10_card_branch_is_one_launch_a_round(card_branch, window, dtype):
    """``FeatureAggregator`` on the unbinned route (``RTPU_PCPM=0``) through
    K10's card branch: one launch a round, the sweep's destination CSR
    (``in_indptr``) and ``e_src`` handed to the kernel (no walk pairs);
    the modelled kernel equals the JAX package's ``FeatureAggregator`` and,
    round by round, the twin within the module docstring's tolerance."""
    calls = card_branch
    jfa, fa, X = _pair(6, n_events=1_500, n_ids=120, dtype=dtype)
    for T in (50, 99):
        want = jfa.propagate(jnp.asarray(X), T, window=window, rounds=2)
        columns.reset_launches()
        del calls[:]
        got = fa.propagate(torch.from_numpy(X), T, window=window, rounds=2)
        assert fa._active_spec is None
        assert columns.LAUNCHES["feature_propagate"] == 2
        assert columns.LAUNCHES["feature_propagate_binned"] == 0
        assert [c["kernel"] for c in calls] == ["k10", "k10"]
        assert calls[0]["indptr"] == fa.ds.edges.in_indptr.data_ptr()
        assert calls[0]["e_src"] == fa.ds.edges.e_src.data_ptr()
        assert calls[1]["H"] == calls[0]["out"]
        assert_features_match(got, want, dtype)
        e_lat, e_alive = fa.ds.edge_state
        lo, nowin = ops_features.window_bound(
            T, -1 if window is None else window, e_lat.dtype)
        H = torch.from_numpy(X).to(fa.dtype)
        one = ops_features.propagate_round(H, fa.ds.edges, e_lat, e_alive,
                                           lo, nowin, fa.self_weight)
        twin = ops_features.propagate_round_plain(
            H, fa.ds.edges, e_lat, e_alive, lo, nowin, fa.self_weight)
        assert_features_match(one, twin, dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("P", ["2", "5"])
def test_k10_model_equals_k10p_model_bitwise(card_branch, P, dtype,
                                             monkeypatch):
    """K10 and K10-P are one kernel over two walks: on a layout whose walk
    pairs are ``(e_src[j], j)`` (every layout the port builds), K10's
    implicit walk and K10-P's explicit one give the same bits, at both a
    windowed and an unwindowed bound."""
    monkeypatch.setenv("RTPU_PCPM", "1")
    monkeypatch.setenv("RTPU_PARTITIONS", P)
    _, fa, X = _pair(8, n_events=1_500, n_ids=120, dtype=dtype)
    fa.ds.advance(99)
    be = fa._pcpm_layout().device_edges(fa.ds.device)
    m = int(fa.ds.edges.in_indptr[-1])
    assert torch.equal(ops_features.binned_walk(be), torch.stack(
        [fa.ds.edges.e_src[:m], torch.arange(m, dtype=torch.int32)], 1))
    e_lat, e_alive = fa.ds.edge_state
    H = torch.from_numpy(X).to(fa.dtype)
    for w in (-1, 30):
        lo, nowin = ops_features.window_bound(99, w, e_lat.dtype)
        k10 = ops_features.propagate_round(H, fa.ds.edges, e_lat, e_alive,
                                           lo, nowin, fa.self_weight)
        k10p = ops_features.propagate_round_binned(
            H, be, e_lat, e_alive, lo, nowin, fa.self_weight)
        assert torch.equal(k10, k10p)
    assert columns.LAUNCHES["feature_propagate"] == 2
    assert columns.LAUNCHES["feature_propagate_binned"] == 2
