"""The mesh path's ``halo_pack`` (K11) and ``frontier_merge_min`` (K13)
wrappers: their twins against the JAX function and the numpy merge they
replace, their cached input checks, and their launch plans.

* The twins against ``jnp.take(a, send_idx, axis=1)``
  (``raphtory_tpu/parallel/sharded.py:704``, slot-major) and
  ``np.minimum.at`` (``raphtory_tpu/parallel/frontier.py:499``) in the
  cases the mesh tests do not reach: int64 / float64 state, trailing
  dimensions, 1- and 2-byte rows, pad slots naming row n - 1, slices with
  count 0, a bucket of 0, NaN on either side of the merge, strided counts.
  Bitwise.
* Every wrapper check still raises after a good call with the same shapes
  (the signature cache): wrong dtype, shape, contiguity, a non-tensor, and
  tensors on several devices (a ``meta`` tensor beside a CPU one).
* ``halo_plan`` / ``merge_plan`` as plain functions, and the card branch
  of each wrapper driven on the CPU with the C entry point replaced by a
  numpy model of its kernel that reads the same plan array: the plan the
  wrapper hands over, the model's page and merge bitwise the twins'.
* ``frontier_count`` + ``frontier_compact`` (K13's compaction) through
  the models of the one-pass kernel, whose tiles finish in a random
  order, and of the pad fill: bitwise the twin (count 0, count N, a
  bucket of exactly the count, trailing dimensions, int32 / int64 /
  float32 / float64), the scratch's epochs across calls and their wrap,
  and every check raising after a good call.
"""

import ctypes

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raphtory_tpu.parallel.sharded import _build_halo as jbuild_halo
from raphtory_tpu_torch.ops import columns, exchange

HALO_CASES = [((3, 50), np.float32), ((2, 40), np.int64),
              ((3, 30, 3), np.float64), ((2, 25, 2, 2), np.int32),
              ((4, 33), np.float16), ((2, 31), np.int16),
              ((3, 20, 3), np.int8), ((1, 17), np.bool_),
              ((2, 9, 5), np.uint8)]


def _leaf(rng, shape, dtype):
    if dtype == np.bool_:
        return rng.random(shape) < 0.5
    if np.issubdtype(dtype, np.floating):
        return rng.standard_normal(shape).astype(dtype)
    return rng.integers(-100, 100, shape).astype(dtype)


def _send(rng, n, S=4, h=6):
    """A send page laid out as ``_build_halo`` writes it: S chunks of h
    slots, each chunk's rows sorted and unique, then pads naming row n -
    1."""
    send = np.full(S * h, n - 1, np.int32)
    for r in range(S):
        rows = np.sort(rng.choice(n, size=rng.integers(0, h + 1),
                                  replace=False))
        send[r * h:r * h + len(rows)] = rows
    return send


def _reference_page(rng, n, S=4, m=20):
    """Owner 0's send page from the reference's own ``_build_halo``, for
    random references of S shards over S blocks of n rows (its pads name
    row 0)."""
    idx_g = rng.integers(0, S * n, (S, m)).astype(np.int32)
    return jbuild_halo(idx_g, n, S)[2][0]


def _bits(x):
    x = np.ascontiguousarray(x)
    if np.issubdtype(x.dtype, np.floating):
        return x.view(np.dtype(f"i{x.dtype.itemsize}"))
    return x


def assert_merged(got, want):
    """Bitwise, but for NaN payloads: a NaN on either side wins (the
    rule of ``np.minimum``), whose bits numpy and torch's CPU kernels
    write differently."""
    nan = np.isnan(want) if np.issubdtype(want.dtype, np.floating) \
        else np.zeros(want.shape, bool)
    np.testing.assert_array_equal(np.isnan(got) if nan.any() else nan, nan)
    np.testing.assert_array_equal(_bits(got)[~nan], _bits(want)[~nan])


@pytest.mark.parametrize("shape,dtype", HALO_CASES,
                         ids=[f"{np.dtype(d).name}-{'x'.join(map(str, s))}"
                              for s, d in HALO_CASES])
def test_halo_twin_is_jnp_take(shape, dtype):
    rng = np.random.default_rng(len(shape) * 10 + np.dtype(dtype).itemsize)
    a = _leaf(rng, shape, dtype)
    for send in (_send(rng, shape[1]), _reference_page(rng, shape[1])):
        want = np.swapaxes(np.asarray(jnp.take(
            jnp.asarray(a), jnp.asarray(send), axis=1)), 0, 1)
        got = exchange.halo_pack(torch.from_numpy(a), torch.from_numpy(send))
        np.testing.assert_array_equal(_bits(got.numpy()), _bits(want))


def _merge_inputs(rng, dtype, trail, R=4, B=64, n=300, zero_slice=1,
                  nan=False):
    replica = _leaf(rng, (n,) + trail, dtype)
    owner = rng.integers(0, R, n)              # each row has one owner
    counts = np.zeros(R, np.int64)
    idx = np.zeros((R, B), np.int64)
    val = _leaf(rng, (R, B) + trail, dtype)    # pads hold junk
    for r in range(R):
        rows = np.flatnonzero(owner == r)[:B]
        rows = rows[rng.random(len(rows)) < 0.7]
        if r == zero_slice:
            rows = rows[:0]
        counts[r] = len(rows)
        idx[r, :len(rows)] = rows
    if nan:
        replica[::5] = np.nan                  # NaN in the replica
        val[:, ::3] = np.nan                   # and in the slices
    return replica, idx.reshape(-1), val.reshape((-1,) + trail), counts


def _minimum_at(replica, idx, val, counts):
    R = len(counts)
    B = len(idx) // R if R else 0
    live = (np.arange(B)[None, :] < counts[:, None]).reshape(-1)
    want = replica.copy()
    with np.errstate(invalid="ignore"):
        np.minimum.at(want, idx[live], val[live])
    return want


@pytest.mark.parametrize("dtype,trail,nan", [
    (np.int32, (), False), (np.int64, (2,), False), (np.float32, (), True),
    (np.float64, (3,), True), (np.float32, (40,), True)])
def test_merge_twin_is_minimum_at(dtype, trail, nan):
    rng = np.random.default_rng(7)
    replica, idx, val, counts = _merge_inputs(rng, dtype, trail, nan=nan)
    want = _minimum_at(replica, idx, val, counts)
    got = torch.from_numpy(replica.copy())
    exchange.frontier_merge_min(got, torch.from_numpy(idx),
                                torch.from_numpy(val),
                                torch.from_numpy(counts))
    assert_merged(got.numpy(), want)


def test_merge_takes_strided_counts_and_a_bucket_of_zero():
    rng = np.random.default_rng(8)
    replica, idx, val, counts = _merge_inputs(rng, np.int32, ())
    pairs = torch.stack([torch.from_numpy(counts),
                         torch.ones(len(counts), dtype=torch.int64)], 1)
    got = torch.from_numpy(replica.copy())
    exchange.frontier_merge_min(got, torch.from_numpy(idx),
                                torch.from_numpy(val), pairs[:, 0])
    np.testing.assert_array_equal(got.numpy(),
                                  _minimum_at(replica, idx, val, counts))
    rep = torch.arange(10, dtype=torch.int32)
    exchange.frontier_merge_min(rep, torch.zeros(0, dtype=torch.int64),
                                torch.zeros(0, dtype=torch.int32),
                                torch.zeros(4, dtype=torch.int64))
    assert torch.equal(rep, torch.arange(10, dtype=torch.int32))


# ---------------------------------------------------------------- checks

def _halo_good():
    return (torch.zeros(3, 40, dtype=torch.float32),
            torch.arange(16, dtype=torch.int32))


def _merge_good():
    return (torch.zeros(50, dtype=torch.int32),
            torch.zeros(4 * 8, dtype=torch.int64),
            torch.zeros(4 * 8, dtype=torch.int32),
            torch.zeros(4, dtype=torch.int64))


def _halo_bad():
    a, s = _halo_good()
    meta = torch.empty(16, dtype=torch.int32, device="meta")
    return [
        ((a, s.long()), TypeError, "send_idx has dtype"),
        ((a, s.reshape(4, 4)), ValueError, "send_idx has shape"),
        ((a.t().contiguous().t(), s), ValueError, "not contiguous"),
        ((a[0], s), ValueError, "want \\[k, n_loc"),
        ((a.numpy(), s), TypeError, "want a tensor"),
        ((a, meta), ValueError, "several devices"),
    ]


def _merge_bad():
    rep, idx, val, cnt = _merge_good()
    meta = torch.empty(4, dtype=torch.int64, device="meta")
    return [
        ((rep, idx.int(), val, cnt), TypeError, "idx has dtype"),
        ((rep, idx, val.long(), cnt), TypeError, "val has dtype"),
        ((rep, idx, val[:-1], cnt), ValueError, "val has shape"),
        ((rep, idx[:-1], val[:-1], cnt), ValueError, "do not split"),
        ((torch.zeros(2, 50, dtype=torch.int32).t(), idx,
          torch.zeros(32, 2, dtype=torch.int32), cnt), ValueError,
         "replica is not contiguous"),
        ((rep, idx, val, cnt.int()), TypeError, "counts has dtype"),
        ((rep, idx, val, cnt.reshape(2, 2)), TypeError, "counts has dtype"),
        ((rep, idx, val, [0, 0, 0, 0]), TypeError, "want a tensor"),
        ((rep, idx, val, meta), ValueError, "several devices"),
    ]


@pytest.mark.parametrize("case", range(len(_halo_bad())))
def test_halo_checks_raise_after_a_good_call(case):
    args, err, match = _halo_bad()[case]
    for _ in range(2):                  # the second good call hits the cache
        exchange.halo_pack(*_halo_good())
        with pytest.raises(err, match=match):
            exchange.halo_pack(*args)


@pytest.mark.parametrize("case", range(len(_merge_bad())))
def test_merge_checks_raise_after_a_good_call(case):
    args, err, match = _merge_bad()[case]
    for _ in range(2):
        exchange.frontier_merge_min(*_merge_good())
        with pytest.raises(err, match=match):
            exchange.frontier_merge_min(*args)


def test_merge_non_contiguous_slices_raise():
    rep, idx, val, cnt = _merge_good()
    exchange.frontier_merge_min(rep, idx, val, cnt)
    with pytest.raises(ValueError, match="idx is not contiguous"):
        exchange.frontier_merge_min(rep, torch.zeros(64, dtype=torch.int64)
                                    [::2], val, cnt)


# ---------------------------------------------------------------- plans

@pytest.mark.parametrize("k", [1, 3, 8])
@pytest.mark.parametrize("row_bytes", [1, 2, 3, 4, 6, 8, 12, 16, 24, 64, 132,
                                       4096, 65536])
def test_halo_plan_invariants(k, row_bytes):
    for align, sh in ((al, sh) for al in (1, 2, 4, 8, 16)
                      for sh in (0, 1, 24, 32_768, 8_388_608)):
        word, lanes, tile, staged, grid, smem = exchange.halo_plan(
            k, sh, row_bytes, align)
        assert word in (1, 2, 4, 8, 16)
        assert row_bytes % word == 0 and align % word == 0
        assert word == 16 or row_bytes % (2 * word) or align % (2 * word)
        words = row_bytes // word
        assert lanes & (lanes - 1) == 0 and lanes <= 32
        assert lanes >= min(words, 32) and (lanes == 1 or lanes < 2 * words)
        rows = exchange.THREADS // lanes
        if staged:
            assert align == 16 and tile % 16 == 0 and tile % rows == 0
            assert smem == tile * k * row_bytes <= exchange.STAGE_BYTES
        else:
            assert tile == rows and smem == 0
            assert align < 16 or max(rows, 16) * k * row_bytes \
                > exchange.STAGE_BYTES
        assert grid == (-(-sh // tile) if sh else 0)


def test_halo_plan_picks():
    p = exchange.halo_plan
    # scalar f32 state, 3 windows, the mesh path's page: a thread a slot,
    # 256-slot tiles (128 blocks), staged
    assert p(3, 32768, 4, 16) == (4, 1, 256, 1, 128, 3072)
    # the deployment page (k 8, S*h 2^23): tiles widen to 512 slots
    assert p(8, 8_388_608, 4, 16)[:4] == (4, 1, 512, 1)
    assert p(3, 100, 24, 16)[:2] == (8, 4)       # f64 x 3
    assert p(3, 100, 3, 16)[:2] == (1, 4)        # int8 x 3
    assert p(2, 100, 2, 16)[:2] == (2, 1)        # f16
    assert p(2, 100, 64, 16)[:2] == (16, 4)      # f32 x 16
    assert p(2, 100, 16, 4)[:2] == (4, 4)        # a leaf off 16 bytes
    assert p(2, 100, 32768, 16)[3] == 0          # too wide to stage


def test_merge_plan():
    assert exchange.merge_plan(4, 32768, 1) == (1, 256, 128)
    assert exchange.merge_plan(4, 100, 3) == (4, 64, 2)
    assert exchange.merge_plan(4, 100, 40) == (32, 8, 13)
    assert exchange.merge_plan(4, 0, 1)[2] == 0
    assert exchange.merge_plan(0, 0, 1)[2] == 0


# ------------------------------------------ the card branch, kernel modelled

def _read(addr, n):
    return np.ctypeslib.as_array((ctypes.c_uint8 * n).from_address(addr)) \
        if n else np.zeros(0, np.uint8)


def _model_halo(plan, send_idx, src, out, stream):
    """``halo_pack_kernel`` as numpy, block by block, over the plan array
    the wrapper passes (k, n, S*h, row bytes, word, lanes, tile, staged,
    grid, shared bytes) and raw host addresses."""
    k, n, sh, rb, word, lanes, tile, staged, grid, smem = \
        (ctypes.c_int64 * 10).from_address(plan)
    assert src % word == 0 and out % word == 0
    ids = np.ctypeslib.as_array((ctypes.c_int32 * sh).from_address(
        send_idx)) if sh else np.zeros(0, np.int32)
    leaf, page = _read(src, k * n * rb), _read(out, sh * k * rb)
    for b in range(grid):
        j0 = b * tile
        cnt = min(tile, sh - j0)
        dst = np.zeros(smem, np.uint8) if staged else page[j0 * k * rb:]
        for jl in range(cnt):
            s = int(ids[j0 + jl])
            for kk in range(k):
                d = (jl * k + kk) * rb
                row = leaf[(kk * n + s) * rb:(kk * n + s + 1) * rb] \
                    if 0 <= s < n else np.zeros(rb, np.uint8)
                for w in range(0, rb, word):        # a lane's word
                    dst[d + w:d + w + word] = row[w:w + word]
        if staged:
            nbytes, base = cnt * k * rb, j0 * k * rb
            assert nbytes <= smem and (out + base) % 16 == 0
            n16 = nbytes // 16 * 16
            page[base:base + n16] = dst[:n16]                  # 16-byte words
            page[base + n16:base + nbytes] = dst[n16:nbytes]   # tail words
    return 0


def _model_merge(plan, counts, idx, val, replica, stream):
    """``merge_min_kernel`` as numpy over the plan array (R, B, F, n,
    dtype, counts' stride, lanes, tile, grid x)."""
    R, B, F, n, code, cstride, lanes, tile, gx = \
        (ctypes.c_int64 * 9).from_address(plan)
    dt = {0: np.float32, 1: np.int32, 2: np.float64, 3: np.int64}[code]
    size = np.dtype(dt).itemsize
    cnt = np.ctypeslib.as_array((ctypes.c_int64 * max(1, (R - 1) * cstride
                                                      + 1)).from_address(
        counts))[::cstride] if R else []
    ix = np.ctypeslib.as_array((ctypes.c_int64 * (R * B)).from_address(idx)) \
        if R * B else np.zeros(0, np.int64)
    vv = _read(val, R * B * F * size).view(dt)
    rep = _read(replica, n * F * size).view(dt)
    for r in range(R):
        live = min(max(int(cnt[r]), 0), B)
        for bx in range(gx):
            s0 = bx * tile
            if s0 >= live:
                continue
            for slot in range(r * B + s0, r * B + min(s0 + tile, live)):
                row = int(ix[slot])
                if 0 <= row < n:
                    cur, v = rep[row * F:(row + 1) * F], vv[slot * F:(slot + 1)
                                                           * F]
                    pick = (v < cur) | (v != v)
                    cur[pick] = v[pick]
    return 0


#: the order the modelled compaction's tiles take their steps in
_TILE_ORDER = np.random.default_rng(0)
_TILE_ROWS = 8192
_EPOCH_SHIFT, _FLAG_SHIFT = 42, 40


def _model_compact(plan, epoch, changed, values, out_idx, out_val, count,
                   scratch, stream):
    """``compact_kernel`` as numpy over the plan array (N, F, element
    bytes, tiles) and the scratch the wrapper hands over (the ticket, then
    a status word a tile): every tile publishes its count, then looks back
    and publishes its inclusive prefix and writes its rows — each step
    taken by the tiles in a random order, as blocks finish on the card.
    Holds the wrapper to the scratch's contract: the ticket starts at 0,
    the epoch is new to every status word, and the look-back only ever
    meets words of this call's epoch."""
    n, f, esize, tiles = (ctypes.c_int64 * 4).from_address(plan)
    assert 0 < epoch < 1 << 22 and tiles == max(1, -(-n // _TILE_ROWS))
    sc = np.ctypeslib.as_array((ctypes.c_int64 * (1 + tiles)).from_address(
        scratch)).view(np.uint64)
    status = sc[1:]
    assert sc[0] == 0
    assert not ((status >> np.uint64(_EPOCH_SHIFT)) == epoch).any()
    ch = _read(changed, n).astype(bool)
    dt = np.dtype(f"u{esize}")
    vals = _read(values, n * f * esize).view(dt).reshape(n, f)

    def word(flag, value):
        return np.uint64((epoch << _EPOCH_SHIFT) | (flag << _FLAG_SHIFT)
                         | int(value))

    agg = [int(ch[t * _TILE_ROWS:(t + 1) * _TILE_ROWS].sum())
           for t in range(tiles)]
    for t in _TILE_ORDER.permutation(tiles):
        status[t] = word(2 if t == 0 else 1, agg[t])
    total = int(ch.sum())
    idx = _read(out_idx, total * 8).view(np.int64)
    out = _read(out_val, total * f * esize).view(dt).reshape(total, f)
    for t in _TILE_ORDER.permutation(tiles):
        excl, p = 0, t - 1
        while p >= 0:
            w = int(status[p])
            assert w >> _EPOCH_SHIFT == epoch
            excl += w & ((1 << _FLAG_SHIFT) - 1)
            if (w >> _FLAG_SHIFT) & 3 == 2:
                break
            p -= 1
        status[t] = word(2, excl + agg[t])
        rows = t * _TILE_ROWS + np.flatnonzero(
            ch[t * _TILE_ROWS:(t + 1) * _TILE_ROWS])
        idx[excl:excl + len(rows)] = rows
        out[excl:excl + len(rows)] = vals[rows]
    _read(count, 8).view(np.int64)[0] = total
    sc[0] = 0                                 # the last ticket resets it
    return 0


def _model_pad(plan, count, out_idx, out_val, stream):
    """``pad_kernel`` as numpy over the plan array (bucket, F, element
    bytes, the identity's bits, grid): slots [count, bucket) get index 0
    and the identity, the count read from its device word."""
    bucket, f, esize, bits, grid = (ctypes.c_int64 * 5).from_address(plan)
    assert grid == min(1024, -(-bucket * f // exchange.THREADS))
    c = int(_read(count, 8).view(np.int64)[0])
    dt = np.dtype(f"u{esize}")
    _read(out_idx, bucket * 8).view(np.int64)[c:] = 0
    _read(out_val, bucket * f * esize).view(dt)[c * f:] = \
        np.uint64(bits & ((1 << 8 * esize) - 1)).astype(dt)
    return 0


@pytest.fixture
def card_branch(monkeypatch):
    """Each wrapper's card branch on CPU tensors: ``_on_cuda`` says True,
    the C entry points are the numpy models, fresh signature caches and
    compaction scratch."""
    monkeypatch.setattr(exchange, "_on_cuda", lambda name, *t: True)
    monkeypatch.setattr(exchange, "_stream", lambda t: 0)
    models = {"rtpu_halo_pack": _model_halo,
              "rtpu_frontier_merge_min": _model_merge,
              "rtpu_frontier_compact": _model_compact,
              "rtpu_frontier_pad": _model_pad}
    monkeypatch.setattr(exchange, "_fn", lambda lib, fn: models[fn])
    for cache in ("_HALO_SIGS", "_MERGE_SIGS", "_COUNT_SIGS", "_PAD_SIGS",
                  "_SCRATCH"):
        monkeypatch.setattr(exchange, cache, {})
    columns.reset_launches()
    yield
    columns.reset_launches()


@pytest.mark.parametrize("shape,dtype", HALO_CASES + [
    ((2, 6, 4096), np.float32), ((3, 300), np.float32)],
    ids=lambda x: str(x))
def test_halo_card_branch_matches_twin(card_branch, shape, dtype):
    rng = np.random.default_rng(11)
    a = _leaf(rng, shape, dtype)
    send = torch.from_numpy(_send(rng, shape[1], h=40 if shape[1] >= 300
                                  else 6))
    flat = torch.from_numpy(np.concatenate([a.reshape(-1)[:1],
                                            a.reshape(-1)]))
    for leaf in (torch.from_numpy(a), flat[1:].view(shape)):   # off-aligned
        want = exchange.halo_pack_plain(leaf, send)
        for _ in range(2):
            got = exchange.halo_pack(leaf, send)
            assert torch.equal(got, want)
    assert columns.LAUNCHES["halo_pack"] == 4


@pytest.mark.parametrize("dtype,trail,nan", [
    (np.int32, (), False), (np.int64, (2,), False), (np.float32, (), True),
    (np.float64, (3,), True)])
def test_merge_card_branch_matches_twin(card_branch, dtype, trail, nan):
    rng = np.random.default_rng(12)
    replica, idx, val, counts = _merge_inputs(rng, dtype, trail, B=600,
                                              n=3000, nan=nan)
    want = _minimum_at(replica, idx, val, counts)
    pairs = torch.stack([torch.from_numpy(counts),
                         torch.zeros(len(counts), dtype=torch.int64)], 1)
    for cnt in (torch.from_numpy(counts), pairs[:, 0]):
        got = torch.from_numpy(replica.copy())
        exchange.frontier_merge_min(got, torch.from_numpy(idx),
                                    torch.from_numpy(val), cnt)
        assert_merged(got.numpy(), want)
    assert columns.LAUNCHES["frontier_merge_min"] == 2


def _compact_cases(rng, n):
    """(changed, bucket): count 0, count N, a bucket of exactly the count,
    a sparse frontier in a power-of-two bucket, one row."""
    yield np.zeros(n, bool), 8
    yield np.ones(n, bool), n
    few = rng.random(n) < 0.07
    yield few, int(few.sum())
    yield rng.random(n) < 0.2, 1 << (n - 1).bit_length() - 1
    one = np.zeros(n, bool)
    one[n - 1] = True
    yield one, 1


@pytest.mark.parametrize("dtype,trail", [
    (np.int32, ()), (np.float32, (3,)), (np.int64, ()), (np.float64, (2,))])
@pytest.mark.parametrize("n", [3 * 8192 + 17, 1000])
def test_compact_card_branch_matches_twin(card_branch, dtype, trail, n):
    """Both launches through their models, back to back on one scratch
    (each call a new epoch): bitwise the twin, ``np.flatnonzero``'s order
    whatever order the tiles finish in, through the sparse route's calls
    (the count pass, then the pad with the pass handed over) and through
    ``frontier_compact`` alone; two launches a compaction."""
    rng = np.random.default_rng(n)
    values = torch.from_numpy(_leaf(rng, (n,) + trail, dtype))
    ident = exchange.min_identity(values.dtype)
    calls = 0
    for changed, bucket in _compact_cases(rng, n):
        ch = torch.from_numpy(changed)
        want = exchange.frontier_compact_plain(values, ch, bucket, ident)
        counted = exchange.frontier_count(ch, values)
        assert counted.total == int(changed.sum())
        assert counted.idx.shape == (n,)
        for got in (exchange.frontier_compact(values, ch, bucket, ident,
                                              counted),
                    exchange.frontier_compact(values, ch, bucket, ident)):
            assert got[0].shape == (bucket,)
            np.testing.assert_array_equal(got[0].numpy(), want[0].numpy())
            np.testing.assert_array_equal(_bits(got[1].numpy()),
                                          _bits(want[1].numpy()))
        calls += 2
    assert columns.LAUNCHES["frontier_compact"] == 2 * calls
    # the scratch: one epoch a call, the ticket back at 0
    (scratch, epoch), = exchange._SCRATCH.values()
    assert epoch == calls and int(scratch[0]) == 0


@pytest.mark.parametrize("trail", [(), (3,)])
def test_compact_card_branch_of_an_empty_state(card_branch, trail):
    """N = 0: one tile counts nothing, and the pad fills every slot of the
    bucket with the whole row's identity (trailing dimensions included)."""
    values = torch.zeros((0,) + trail, dtype=torch.float32)
    ch = torch.zeros(0, dtype=torch.bool)
    for bucket in (0, 1):
        want = exchange.frontier_compact_plain(values, ch, bucket, np.inf)
        for counted in (exchange.frontier_count(ch, values), None):
            got = exchange.frontier_compact(values, ch, bucket, np.inf,
                                            counted)
            assert torch.equal(got[0], want[0])
            assert torch.equal(got[1], want[1])


@pytest.mark.parametrize("host", [False, True])
def test_compact_card_branch_refuses_more_rows_than_the_bucket(card_branch,
                                                               host):
    """With the count pass handed over, a bucket smaller than the count
    raises before the pad launches, whether the count is read back or held
    on the host (``counted.host``, as the sparse route holds it), and the
    host's count spares the read-back."""
    values = torch.arange(9000, dtype=torch.int32)
    ch = torch.from_numpy(np.random.default_rng(6).random(9000) < 0.3)
    cnt = int(ch.sum())
    ident = exchange.min_identity(values.dtype)
    counted = exchange.frontier_count(ch, values)
    if host:
        counted = counted._replace(host=cnt)
        assert counted._replace(count=None).total == cnt
    with pytest.raises(ValueError, match=f"{cnt} set rows > bucket "
                                         f"{cnt - 1}"):
        exchange.frontier_compact(values, ch, cnt - 1, ident, counted)
    assert columns.LAUNCHES["frontier_compact"] == 1       # no pad
    want = exchange.frontier_compact_plain(values, ch, cnt, ident)
    got = exchange.frontier_compact(values, ch, cnt, ident, counted)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


def test_compact_epochs_wrap_by_clearing_the_scratch(card_branch,
                                                     monkeypatch):
    """Past the last epoch the scratch is cleared and the epochs start
    again at 1: no status word of an earlier call can pass for the new
    one's (the model asserts it)."""
    monkeypatch.setattr(exchange, "_EPOCHS", 3)
    values = torch.arange(9000, dtype=torch.int32)
    ch = torch.from_numpy(np.random.default_rng(4).random(9000) < 0.3)
    want = exchange.frontier_compact_plain(values, ch, 4096, 2**31 - 1)
    seen = []
    for _ in range(5):
        got = exchange.frontier_compact(values, ch, 4096, 2**31 - 1)
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
        seen.append(next(iter(exchange._SCRATCH.values()))[1])
    assert seen == [1, 2, 1, 2, 1]


def _compact_good():
    return (torch.arange(50, dtype=torch.int32),
            torch.arange(50) % 3 == 0, 32, 2**31 - 1)


def _compact_bad():
    v, ch, B, ident = _compact_good()
    meta = torch.empty(50, dtype=torch.bool, device="meta")
    return [
        ((v, ch.int(), B, ident), TypeError, "changed has dtype"),
        ((v, ch[:-1], B, ident), ValueError, "changed has shape"),
        ((torch.zeros(2, 50, dtype=torch.int32).t(), ch, B, ident),
         ValueError, "values is not contiguous"),
        ((v, ch.numpy(), B, ident), TypeError, "want a tensor"),
        ((v, meta, B, ident), ValueError, "several devices"),
        ((v, ch, -1, ident), ValueError, "bucket -1"),
    ]


@pytest.mark.parametrize("card", [False, True])
@pytest.mark.parametrize("case", range(len(_compact_bad())))
def test_compact_checks_raise_after_a_good_call(case, card, monkeypatch):
    """A wrong input after good calls of the same shapes still takes the
    full checks and raises (the signature caches), on the CPU and through
    the card branch; on the card the count pass needs the values."""
    if card:
        on_cuda = exchange._on_cuda       # still raises on several devices
        monkeypatch.setattr(exchange, "_on_cuda",
                            lambda name, *t: on_cuda(name, *t) or True)
        monkeypatch.setattr(exchange, "_stream", lambda t: 0)
        monkeypatch.setattr(exchange, "_fn", lambda lib, fn: {
            "rtpu_frontier_compact": _model_compact,
            "rtpu_frontier_pad": _model_pad}[fn])
        for cache in ("_COUNT_SIGS", "_PAD_SIGS", "_SCRATCH"):
            monkeypatch.setattr(exchange, cache, {})
    args, err, match = _compact_bad()[case]
    for _ in range(2):
        v, ch, B, ident = _compact_good()
        exchange.frontier_compact(v, ch, B, ident,
                                  exchange.frontier_count(ch, v))
        with pytest.raises(err, match=match):
            exchange.frontier_compact(*args)
        if case < 5:
            with pytest.raises(err, match=match):
                exchange.frontier_count(args[1], args[0])
    if card:
        with pytest.raises(TypeError, match="pass the values"):
            exchange.frontier_count(ch)
        with pytest.raises(ValueError, match="> bucket"):
            exchange.frontier_compact(v, ch, 4, ident)
        with pytest.raises(ValueError, match="bucket 64 > the count pass"):
            exchange.frontier_compact(v, ch, 64, ident,
                                      exchange.frontier_count(ch, v))
