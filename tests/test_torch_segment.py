"""The twins of K7 (masked segment combine), K9a (resident delta apply),
K9b (resident window masks) and K8u (mask-bit unpack) against the JAX
functions they replace, on the same numpy inputs:

* K7 ``segment_combine_plain`` against ``raphtory_tpu.ops.segment.
  segment_combine``: sum, min and max; float32 and int32; the sorted
  (destination) and unsorted (source) directions; masked rows, empty
  segments, pad edges, k = 3 flat windows and a feature axis. Min and max
  bitwise, sum within rtol 1e-5 / atol 1e-7. The CSR each kernel walks is
  checked too, by a plain walk of it that does what the kernel does.
* K9a against ``device_sweep._compiled_apply``, K9b against the mask half
  of ``_compiled_run`` and K8u against ``bsp._unpack_bits``: bitwise, with
  int32 and int64 times and pad rows. K8u's one-buffer pack and unpack
  (``pack_view_masks`` / ``unpack_view_masks``) also through its card
  branch, over a numpy model of the C entry (``card_branch``), alone and
  on the cold route (``bsp.run_async``).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_columns import _view

from raphtory_tpu.engine import bsp as jbsp
from raphtory_tpu.engine import device_sweep as jds
from raphtory_tpu.ops import segment as jseg
from raphtory_tpu_torch.engine.hopbatch import HopBatchedPageRank
from raphtory_tpu_torch.ops import columns, partition, resident, segment
from raphtory_tpu_torch.utils.synth import bitcoin_like_log

N_REAL, N_PAD, M_REAL, M_PAD = 13, 16, 50, 64
T = torch.from_numpy


def _edges(seed):
    """(dst, src)-sorted endpoints over N_REAL of N_PAD vertices (so some
    segments are empty), padded as the snapshot pads (dst = src =
    N_PAD-1), with both CSRs over the real edges only."""
    rng = np.random.default_rng(seed)
    src = rng.integers(0, N_REAL, M_REAL)
    dst = rng.integers(0, N_REAL - 2, M_REAL)   # rows 11, 12 get no in-edge
    order = np.lexsort((src, dst))
    e_src = np.full(M_PAD, N_PAD - 1, np.int32)
    e_dst = np.full(M_PAD, N_PAD - 1, np.int32)
    e_src[:M_REAL], e_dst[:M_REAL] = src[order], dst[order]
    in_indptr = np.zeros(N_PAD + 1, np.int64)
    np.cumsum(np.bincount(e_dst[:M_REAL], minlength=N_PAD),
              out=in_indptr[1:])
    out_perm = np.argsort(e_src[:M_REAL], kind="stable").astype(np.int32)
    out_indptr = np.zeros(N_PAD + 1, np.int64)
    np.cumsum(np.bincount(e_src[:M_REAL], minlength=N_PAD),
              out=out_indptr[1:])
    return e_src, e_dst, in_indptr, out_perm, out_indptr


def _csr(seed, direction):
    e_src, e_dst, in_indptr, out_perm, out_indptr = _edges(seed)
    if direction == "dst":
        return segment.SegmentCSR(torch.from_numpy(e_dst),
                                  torch.from_numpy(in_indptr), None)
    return segment.SegmentCSR(torch.from_numpy(e_src),
                              torch.from_numpy(out_indptr),
                              torch.from_numpy(out_perm))


def _payload(rng, dtype, k, F):
    shape = (k * M_PAD,) + ((F,) if F else ())
    if dtype == np.float32:
        x = rng.normal(size=shape).astype(np.float32)
    else:
        x = rng.integers(-1000, 1000, shape).astype(np.int32)
    mask = rng.random(k * M_PAD) < 0.7
    mask.reshape(k, M_PAD)[:, M_REAL:] = False   # pads: masked everywhere
    mask.reshape(k, M_PAD)[0, :] &= rng.random(M_PAD) < 0.5
    return x, mask


def _jax_ref(x, mask, csr, op, k):
    ids = (csr.ids.numpy().astype(np.int64)[None, :]
           + np.arange(k)[:, None] * N_PAD).reshape(-1)
    return np.asarray(jseg.segment_combine(
        jnp.asarray(x), jnp.asarray(ids, jnp.int32), k * N_PAD, op,
        jnp.asarray(mask), indices_are_sorted=csr.perm is None))


def _walk(x, mask, csr, op, k):
    """What the kernel does, in plain numpy: one (window, row, feature)
    walks its CSR run in order."""
    x2 = x.reshape(k * M_PAD, -1)
    fill = segment.neutral(op, torch.from_numpy(x2[:0]).dtype)
    out = np.full((k * N_PAD, x2.shape[1]), fill, x.dtype)
    indptr = csr.indptr.numpy()
    perm = None if csr.perm is None else csr.perm.numpy()
    fn = {"sum": np.add, "min": np.minimum, "max": np.maximum}[op]
    for w in range(k):
        for r in range(N_PAD):
            for j in range(indptr[r], indptr[r + 1]):
                e = w * M_PAD + (j if perm is None else perm[j])
                if mask[e]:
                    out[w * N_PAD + r] = fn(out[w * N_PAD + r], x2[e])
    return out.reshape((k * N_PAD,) + x.shape[1:])


def _same(got, want, op):
    assert got.shape == want.shape and got.dtype == want.dtype
    if op == "sum" and got.dtype == np.float32:
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-7)
    else:
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("F", [0, 3])
@pytest.mark.parametrize("k", [1, 3])
@pytest.mark.parametrize("direction", ["dst", "src"])
@pytest.mark.parametrize("dtype", [np.float32, np.int32])
@pytest.mark.parametrize("op", ["sum", "min", "max"])
def test_segment_combine_twin_matches_jax(op, dtype, direction, k, F):
    rng = np.random.default_rng(7)
    csr = _csr(1, direction)
    x, mask = _payload(rng, dtype, k, F)
    want = _jax_ref(x, mask, csr, op, k)
    got = segment.segment_combine(torch.from_numpy(x), csr, op,
                                  torch.from_numpy(mask), k)
    assert got.shape == (k * N_PAD,) + x.shape[1:]
    _same(got.numpy(), want, op)
    # the CSR the kernel walks gives the same answer as the ids
    _same(_walk(x, mask, csr, op, k), want, op)
    # empty and fully masked rows take the neutral value
    fill = segment.neutral(op, got.dtype)
    assert (got.reshape(k, N_PAD, -1)[:, 13:] == fill).all()


def test_segment_combine_neutrals_and_refusals():
    assert segment.neutral("min", torch.float32) == float("inf")
    assert segment.neutral("max", torch.float32) == float("-inf")
    assert segment.neutral("min", torch.int32) == 2**31 - 1
    assert segment.neutral("max", torch.int32) == -2**31
    assert segment.neutral("sum", torch.int32) == 0
    csr = _csr(2, "dst")
    x = torch.zeros(M_PAD)
    with pytest.raises(ValueError, match="combiner"):
        segment.segment_combine(x, csr, "mean", torch.ones(M_PAD, dtype=bool))
    with pytest.raises(ValueError, match="shape"):
        segment.segment_combine(x, csr, "sum",
                                torch.ones(M_PAD, dtype=bool), k=2)
    with pytest.raises(TypeError, match="mask"):
        segment.segment_combine(x, csr, "sum", torch.ones(M_PAD))


def _graph_tables():
    """The port's GlobalTables CSRs are what the kernel walks on the
    resident route: walking them equals the scatter by ids."""
    from test_sweep import random_log

    from raphtory_tpu_torch.core.sweep import SweepBuilder
    from raphtory_tpu_torch.engine.device_sweep import GlobalTables
    from raphtory_tpu_torch.interop import event_log_from_arrays

    jlog = random_log(np.random.default_rng(3), n_events=300, n_ids=20)
    return GlobalTables(SweepBuilder(event_log_from_arrays(jlog.arrays()),
                                     track_rows=False, preseed_pairs=True))


@pytest.mark.parametrize("direction", ["dst", "src"])
def test_global_tables_csr_walk_matches_ids(direction):
    t = _graph_tables()
    ids = t.e_dst if direction == "dst" else t.e_src
    indptr = t.in_indptr if direction == "dst" else t.out_indptr
    perm = None if direction == "dst" else t.out_perm
    seen = np.zeros(t.m_pad, int)
    for r in range(t.n_pad):
        rows = np.arange(indptr[r], indptr[r + 1])
        e = rows if perm is None else perm[rows]
        assert (ids[e] == r).all()
        seen[e] += 1
    # every real edge in exactly one run, no pad edge in any
    assert (seen[: t.m] == 1).all() and (seen[t.m:] == 0).all()


# ---------------------------------------------------------------- K9a

def _chunk(rng, n, m, cap_v, cap_e, tdt):
    info = np.iinfo(tdt)
    edge = np.array([info.min, info.min + 1, -5, 0, 7, info.max - 1,
                     info.max], tdt)

    def rows(cap, length):
        k = int(rng.integers(cap // 3, cap))
        idx = np.full(cap, 2**31 - 1, np.int32)      # pads
        idx[:k] = rng.choice(length, k, replace=False)
        return (idx, rng.choice(edge, cap).astype(tdt),
                rng.random(cap) < 0.5, rng.choice(edge, cap).astype(tdt))

    return rows(cap_v, n) + rows(cap_e, m)


@pytest.mark.parametrize("tdt", [np.int32, np.int64])
def test_apply_delta_chunk_twin_matches_jax(tdt):
    rng = np.random.default_rng(11)
    n, m, cap_v, cap_e = 64, 256, 32, 96
    info = np.iinfo(tdt)
    bufs = (np.full(n, info.min, tdt), np.zeros(n, bool),
            np.full(n, info.min, tdt), np.full(m, info.min, tdt),
            np.zeros(m, bool), np.full(m, info.min, tdt))
    tbufs = tuple(torch.from_numpy(b.copy()) for b in bufs)
    jbufs = tuple(jnp.asarray(b) for b in bufs)
    apply = jds._compiled_apply(cap_v, cap_e, np.dtype(tdt).name)
    for _ in range(3):                       # three chunks in a row
        chunk = _chunk(rng, n, m, cap_v, cap_e, tdt)
        jbufs = apply(*jbufs, *(jnp.asarray(a) for a in chunk))
        resident.apply_delta_chunk(tbufs, resident.pack_chunk(
            chunk, cap_v, cap_e, tbufs[0].dtype))
        for g, w in zip(tbufs, jbufs):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_apply_delta_chunk_refuses_bad_inputs():
    bufs = (torch.zeros(8, dtype=torch.int32), torch.zeros(8, dtype=bool),
            torch.zeros(8, dtype=torch.int32),
            torch.zeros(16, dtype=torch.int32), torch.zeros(16, dtype=bool),
            torch.zeros(16, dtype=torch.int32))
    dup = (np.array([1, 1], np.int32), np.zeros(2, np.int32),
           np.zeros(2, bool), np.zeros(2, np.int32),
           np.array([2**31 - 1], np.int32), np.zeros(1, np.int32),
           np.zeros(1, bool), np.zeros(1, np.int32))
    with pytest.raises(ValueError, match="twice"):
        resident.apply_delta_chunk(bufs, resident.pack_chunk(
            dup, 2, 1, torch.int32))
    wide = resident.pack_chunk(dup, 2, 1, torch.int64)
    with pytest.raises(TypeError, match="vd_lat"):
        resident.apply_delta_chunk(bufs, wide)


# ---------------------------------------------------------------- K9b

def _jax_masks(v_lat, v_alive, e_lat, e_alive, T, windows):
    """device_sweep.py:273-277, the mask half of ``_compiled_run``."""
    info = jnp.iinfo(v_lat.dtype)
    windows = jnp.asarray(windows, jnp.int64)
    lo = jnp.clip(jnp.int64(T) - windows, info.min,
                  info.max).astype(v_lat.dtype)[:, None]
    nowin = (windows < 0)[:, None]
    return (v_alive[None, :] & (nowin | (v_lat[None, :] >= lo)),
            e_alive[None, :] & (nowin | (e_lat[None, :] >= lo)))


@pytest.mark.parametrize("tdt", [np.int32, np.int64])
def test_window_masks_twin_matches_jax(tdt):
    rng = np.random.default_rng(5)
    info = np.iinfo(tdt)
    edge = np.array([info.min, info.min + 1, -100, 0, 50, 99, 100,
                     info.max - 1, info.max], tdt)
    n, m = 64, 200
    v_lat, e_lat = (rng.choice(edge, s).astype(tdt) for s in (n, m))
    v_alive, e_alive = (rng.random(s) < 0.7 for s in (n, m))
    cases = [(100, [-1, 0, 1, 50, 1 << 40]),
             (int(info.max) - 3, [-1, 5, 1 << 62]),
             # (T - w stays inside int64: the reference subtracts there)
             (int(info.min) + 20, [0, 10, -1])]
    for T, windows in cases:
        want = _jax_masks(*(jnp.asarray(a) for a in
                            (v_lat, v_alive, e_lat, e_alive)), T, windows)
        got = resident.window_masks(
            *(torch.from_numpy(a) for a in (v_lat, v_alive, e_lat,
                                            e_alive)), T, windows)
        for g, w in zip(got, want):
            assert g.dtype == torch.bool
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("tdt", [np.int32, np.int64])
def test_window_masks_match_compiled_run_vertex_masks(tdt):
    """Through the reference's own ``_compiled_run``: a probe program whose
    result is ``ctx.v_mask`` and the in-degree under the edge masks."""
    from dataclasses import dataclass

    from raphtory_tpu.engine.program import VertexProgram as JVP

    @dataclass(frozen=True)
    class Probe(JVP):
        max_steps: int = 0
        needs_vids = needs_vertex_times = needs_edge_times = False

        def init(self, ctx):
            return {}

        def finalize(self, state, ctx):
            return {"v": ctx.v_mask, "in": ctx.in_deg}

    rng = np.random.default_rng(6)
    info = np.iinfo(tdt)
    n, m = 16, 32
    v_lat = rng.integers(-50, 50, n).astype(tdt)
    e_lat = rng.integers(-50, 50, m).astype(tdt)
    v_lat[0] = e_lat[0] = info.min
    v_alive, e_alive = (rng.random(s) < 0.8 for s in (n, m))
    e_dst = np.sort(rng.integers(0, n, m)).astype(np.int32)
    e_src = rng.integers(0, n, m).astype(np.int32)
    windows = [-1, 30, 0]
    run = jds._compiled_run(Probe(), n, m, len(windows), np.dtype(tdt).name)
    res, _ = run(*(jnp.asarray(a) for a in (v_lat, v_alive, v_lat, e_lat,
                                            e_alive, e_lat)),
                 jnp.full((n,), -1, jnp.int64), jnp.asarray(e_src),
                 jnp.asarray(e_dst), jnp.asarray(20, jnp.int64),
                 jnp.asarray(windows, jnp.int64))
    vm, em = resident.window_masks(
        *(torch.from_numpy(a) for a in (v_lat, v_alive, e_lat, e_alive)),
        20, windows)
    np.testing.assert_array_equal(vm.numpy(), np.asarray(res["v"]))
    in_deg = np.zeros((len(windows), n), np.int32)
    for w in range(len(windows)):
        np.add.at(in_deg[w], e_dst, em[w].numpy().astype(np.int32))
    np.testing.assert_array_equal(in_deg, np.asarray(res["in"]))


def test_window_bounds_clamp_into_the_narrow_dtype():
    lo, nowin = resident.window_bounds(5, [-1, 1 << 40, 3], torch.int32,
                                       "cpu")
    assert lo.tolist() == [6, -2**31, 2] and nowin.tolist() == [True,
                                                                False, False]


# ---------------------------------------------------------------- K8u

def _packed_view(rng, k, n, m):
    """Random vertex / edge masks and K8u's one packed buffer of them."""
    v, e = rng.random((k, n)) < 0.4, rng.random((k, m)) < 0.6
    return v, e, resident.pack_view_masks(v, e)


def _check_view_masks(got, v, e):
    """Both masks bitwise the numpy masks, contiguous bool views of one
    allocation, the edge view at its 16-byte aligned offset."""
    (gv, ge), (k, n), m = got, v.shape, e.shape[1]
    _, _, e_out, total = resident.view_mask_layout(k, n, m)
    for g, want in ((gv, v), (ge, e)):
        assert g.dtype == torch.bool and g.is_contiguous()
        np.testing.assert_array_equal(g.numpy(), want)
    base = gv.untyped_storage().data_ptr()
    assert ge.untyped_storage().data_ptr() == base
    assert gv.untyped_storage().nbytes() == total
    assert gv.storage_offset() == 0 and ge.storage_offset() == e_out
    assert (base + e_out) % 16 == 0


@pytest.mark.parametrize("n", [8, 64, 1024])
def test_unpack_mask_bits_twin_matches_jax(n):
    """The cold route's vertex masks through K8u's pack and unpack (a View
    with no edges) against ``raphtory_tpu/engine/bsp.py:39``."""
    rng = np.random.default_rng(n)
    masks = rng.random((3, n)) < 0.4
    packed = np.packbits(masks, axis=1, bitorder="little")
    want = np.asarray(jbsp._unpack_bits(jnp.asarray(packed), n))
    got, _ = resident.unpack_view_masks(resident.pack_view_masks(
        masks, np.zeros((3, 0), bool)), 3, n, 0)
    assert got.dtype == torch.bool
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(got.numpy(), masks)


#: (n_pad, m_pad) of the K8u cases: regions under 16 bytes (8, 16 and 64
#: bits a row at small k), k*n not a multiple of 128, several blocks
VIEW_SHAPES = [(8, 8), (16, 64), (64, 1024), (1024, 1 << 16),
               (1 << 16, 16), (8, 1 << 16)]


@pytest.mark.parametrize("shape", VIEW_SHAPES, ids=str)
@pytest.mark.parametrize("k", [1, 2, 3, 4, 5])
def test_view_masks_pack_unpack_match_jax(k, shape):
    """``pack_view_masks`` + ``unpack_view_masks`` against the JAX
    package's per-array pack (``bsp.py:377-378``) and ``_unpack_bits``,
    bitwise: the packed regions equal its per-row bytes, laid out at
    ``view_mask_layout``'s offsets."""
    n, m = shape
    rng = np.random.default_rng(k * 7 + n + m)
    v, e, packed = _packed_view(rng, k, n, m)
    e_in, nbytes, _, _ = resident.view_mask_layout(k, n, m)
    assert packed.dtype == torch.uint8 and packed.numel() == nbytes
    raw = packed.numpy()
    for off, a in ((0, v), (e_in, e)):
        jp = np.packbits(a, axis=1, bitorder="little")
        np.testing.assert_array_equal(raw[off: off + jp.size],
                                      jp.reshape(-1))
        np.testing.assert_array_equal(
            np.asarray(jbsp._unpack_bits(jnp.asarray(jp), a.shape[1])), a)
    _check_view_masks(resident.unpack_view_masks(packed, k, n, m), v, e)


def test_wrappers_refuse_other_devices():
    """Only CPU tensors take the twins; other device types raise."""
    meta = torch.zeros(resident.view_mask_layout(2, 16, 0)[1],
                       dtype=torch.uint8, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        resident.unpack_view_masks(meta, 2, 16, 0)


def test_unpack_view_masks_checks_its_buffer():
    packed = resident.pack_view_masks(np.ones((2, 8), bool),
                                      np.ones((2, 8), bool))
    with pytest.raises(ValueError, match="shape"):
        resident.unpack_view_masks(packed[:-1], 2, 8, 8)
    with pytest.raises(TypeError, match="dtype"):
        resident.unpack_view_masks(packed.view(torch.int8), 2, 8, 8)
    with pytest.raises(ValueError, match="k=-1"):
        resident.unpack_view_masks(packed, -1, 8, 8)


def _spread(b):
    """``spread`` of ``csrc/sweep.cu`` in numpy: each byte's 8 bits as 8
    bytes of 0 / 1 (a uint64, bit j in byte j)."""
    x = (b.astype(np.uint64) * np.uint64(0x0101010101010101)) \
        & np.uint64(0x8040201008040201)
    return ((x + np.uint64(0x7f7f7f7f7f7f7f7f))
            & np.uint64(0x8080808080808080)) >> np.uint64(7)


def test_spread_puts_each_bit_in_its_byte():
    """The kernel's byte spread (one multiply and masks) is bit j of the
    byte in byte j, for every byte value."""
    b = np.arange(256)
    np.testing.assert_array_equal(
        _spread(b).view(np.uint8).reshape(256, 8),
        np.unpackbits(b.astype(np.uint8)[:, None], axis=1,
                      bitorder="little"))


def _model_unpack(calls, rng):
    """``rtpu_unpack_view_masks`` over the wrapper's raw addresses: the
    edge bits and masks at ``view_offsets``, the vertex region's blocks
    first; its blocks run in a random order, each staging its 4,096 bytes
    of bits (16 a thread, zero past the region), then each warp writes
    store q of lane L from bits bytes 2(32q + L) and 2(32q + L) + 1: 16
    mask bytes, or bytes up to the region's end, each byte's bits spread
    by ``_spread``."""

    def model(vbits, ebits, packed, out, stream):
        assert packed % 16 == 0 and out % 16 == 0
        e_in = -(-(-(-vbits // 8)) // 16) * 16
        e_out = -(-vbits // 16) * 16
        vb = -(-(-(-vbits // 8)) // 4096)
        eb = -(-(-(-ebits // 8)) // 4096)
        calls.append(dict(vbits=vbits, ebits=ebits, packed=packed,
                          blocks=vb + eb))
        for blk in rng.permutation(vb + eb):
            vert = blk < vb
            bits = vbits if vert else ebits
            nbytes = -(-bits // 8)
            src = _view(packed + (0 if vert else e_in), np.uint8, nbytes)
            dst = _view(out + (0 if vert else e_out), np.uint8, bits)
            b0 = (blk if vert else blk - vb) * 4096
            stage = np.zeros(4096, np.uint8)
            here = min(4096, nbytes - b0)
            stage[:here] = src[b0: b0 + here]
            for warp in range(8):
                h = np.arange(256)                  # q * 32 + lane
                j0 = (b0 + warp * 512 + 2 * h) * 8
                pair = stage[warp * 512:][: 512].reshape(256, 2)
                words = _spread(pair)
                for hh in np.flatnonzero(j0 < bits):
                    cnt = min(16, bits - j0[hh])
                    dst[j0[hh]: j0[hh] + cnt] = words[hh].view(
                        np.uint8)[:cnt]
        return 0
    return model


@pytest.fixture
def card_branch(monkeypatch):
    """K8u's card branch on CPU tensors through ``_model_unpack``; the
    calls it received."""
    calls = []
    monkeypatch.setattr(resident, "_on_cuda", lambda name, *ts: True)
    monkeypatch.setattr(resident, "_stream", lambda t: 0)
    monkeypatch.setattr(resident, "_fn", lambda lib, fn: _model_unpack(
        calls, np.random.default_rng(len(calls))) if fn ==
        "rtpu_unpack_view_masks" else pytest.fail(fn))
    columns.reset_launches()
    return calls


@pytest.mark.parametrize("k, n, m", [(1, 8, 8), (3, 8, 64), (5, 16, 24),
                                     (2, 1024, 1 << 16), (3, 4096, 40),
                                     (1, 1 << 16, 0), (4, 0, 1000),
                                     (2, 24, 0), (5, 64, 4104), (1, 0, 0),
                                     (2, 8, 1 << 16), (3, 40, 8),
                                     (4, 4104, 64), (1, 32768, 32776)])
def test_view_masks_card_branch_one_launch(card_branch, k, n, m):
    """The card branch of ``unpack_view_masks``: one launch a call over
    the packed buffer, bitwise the twin and the numpy masks; ragged
    regions (under 16 bytes, k*n not a multiple of 128, a block's end)
    and empty ones."""
    v, e, packed = _packed_view(np.random.default_rng(k + n + m), k, n, m)
    got = resident.unpack_view_masks(packed, k, n, m)
    assert len(card_branch) == 1
    assert card_branch[0]["vbits"] == k * n and card_branch[0]["ebits"] \
        == k * m
    assert columns.LAUNCHES["unpack_mask_bits"] == 1
    _check_view_masks(got, v, e)
    for g, w in zip(got, resident.unpack_view_masks_plain(packed, k, n, m)):
        assert torch.equal(g, w)


def test_view_masks_card_branch_refuses_an_unaligned_buffer(card_branch):
    packed = torch.zeros(33, dtype=torch.uint8)[1:]
    with pytest.raises(ValueError, match="16-byte aligned"):
        resident.unpack_view_masks(packed, 1, 8, 8)
    assert card_branch == []


@pytest.mark.parametrize("windows", [[100, 30, 7], [-1], [30]],
                         ids=["three", "plain", "one"])
@pytest.mark.parametrize("occurrences", [False, True],
                         ids=["edges", "occurrences"])
def test_cold_route_ships_one_buffer_and_unpacks_once(
        card_branch, windows, occurrences, monkeypatch):
    """``bsp.run_async`` packs the View's vertex and edge (or occurrence)
    masks into one buffer, uploads it once and unpacks it in one launch:
    the kernel reads each region at its offset, and the result stays
    bitwise the JAX package's cold route."""
    from test_sweep import random_log

    from raphtory_tpu.algorithms import ConnectedComponents as JCC
    from raphtory_tpu.algorithms import TaintTracking as JTaint
    from raphtory_tpu.core.snapshot import build_view as jbuild_view
    from raphtory_tpu_torch.algorithms import (ConnectedComponents,
                                               TaintTracking)
    from raphtory_tpu_torch.core.snapshot import build_view
    from raphtory_tpu_torch.engine import bsp
    from raphtory_tpu_torch.interop import event_log_from_arrays

    monkeypatch.setenv("RTPU_PCPM", "0")
    jlog = random_log(np.random.default_rng(5), n_events=600, n_ids=40,
                      t_span=100)
    log = event_log_from_arrays(jlog.arrays())
    if occurrences:
        kw = dict(seeds=(1, 2), start_time=0, stop_list=(3,))
        jprog, prog = JTaint(**kw), TaintTracking(**kw)
    else:
        jprog, prog = JCC(max_steps=60), ConnectedComponents(max_steps=60)
    uploaded = []
    monkeypatch.setattr(bsp, "upload", lambda data, dev: uploaded.append(
        data.clone()) or resident.upload(data, dev))
    seen = []
    real_pack = resident.pack_view_masks
    monkeypatch.setattr(bsp, "pack_view_masks", lambda v, e, pin: seen.append(
        (v.copy(), e.copy(), pin)) or real_pack(v, e, pin))
    view = build_view(log, 80, include_occurrences=occurrences)
    got, steps = bsp.run(prog, view, windows=windows, device="cpu")
    want, wsteps = jbsp.run(jprog, jbuild_view(
        jlog, 80, include_occurrences=occurrences), windows=windows)
    np.testing.assert_array_equal(leaves_of(got), leaves_of(want))
    assert steps == int(wsteps)
    # one pack, one upload, one launch, the regions at their offsets
    assert len(seen) == len(uploaded) == len(card_branch) == 1
    v, e, pin = seen[0]
    assert pin is False
    k, m = len(windows), e.shape[1]
    assert v.shape == (k, view.n_pad) and m == (
        len(view.occ_src) if occurrences else view.m_pad)
    e_in, nbytes, _, _ = resident.view_mask_layout(k, view.n_pad, m)
    raw = uploaded[0].numpy()
    assert raw.size == nbytes
    for off, a in ((0, v), (e_in, e)):
        np.testing.assert_array_equal(
            raw[off: off + -(-a.size // 8)],
            np.packbits(a.reshape(-1), bitorder="little"))
    assert card_branch[0]["vbits"] == v.size and card_branch[0]["ebits"] \
        == e.size
    assert columns.LAUNCHES["unpack_mask_bits"] == 1


def test_cold_route_stage_seconds_switch(monkeypatch):
    """``bsp.STAGE_SECONDS``: while it is a dict, ``bsp.run`` adds the cold
    dispatch's seconds into its seven stages, call after call; the result
    is the run's without it; None, the default, records nothing."""
    from test_sweep import random_log

    from raphtory_tpu_torch.algorithms import ConnectedComponents
    from raphtory_tpu_torch.core.snapshot import build_view
    from raphtory_tpu_torch.engine import bsp
    from raphtory_tpu_torch.interop import event_log_from_arrays

    assert bsp.STAGE_SECONDS is None
    log = event_log_from_arrays(random_log(
        np.random.default_rng(6), n_events=400, n_ids=30,
        t_span=100).arrays())
    view, prog = build_view(log, 80), ConnectedComponents(max_steps=60)
    want, wsteps = bsp.run(prog, view, windows=[50, 10], device="cpu")
    split = {}
    monkeypatch.setattr(bsp, "STAGE_SECONDS", split)
    for calls in (1, 2):
        got, steps = bsp.run(prog, view, windows=[50, 10], device="cpu")
        assert torch.equal(got, want) and steps == wsteps
        assert list(split) == ["mask_build", "pack", "mask_upload_unpack",
                               "view_edges", "props", "layout",
                               "supersteps"]
        assert all(sec >= 0 for sec in split.values())
    once = dict(split)
    monkeypatch.setattr(bsp, "STAGE_SECONDS", None)
    bsp.run(prog, view, windows=[50, 10], device="cpu")
    assert split == once


def leaves_of(tree):
    """The first result leaf as numpy (CC labels, taint times)."""
    if isinstance(tree, dict):
        tree = tree[sorted(tree)[0]]
    return np.asarray(tree.numpy() if isinstance(tree, torch.Tensor)
                      else tree)


# ------------------------- K7 / K7-P long rows (Pareto senders) and plans

@pytest.fixture(scope="module")
def pareto():
    """A cut ``bitcoin_like_log``'s tables: its source CSR is Pareto, with
    runs past 32 entries (the long rows, a block each) and past 1,024 (more
    than one chunk a long-row block stages at once)."""
    t = HopBatchedPageRank(bitcoin_like_log(n_addresses=4_000, n_txs=60_000,
                                            t_span=2_600_000),
                           device="cpu").tables
    lens = np.diff(t.out_indptr)
    assert (lens > 32).sum() > 100 and (lens > 1024).any()
    return t


def _long_rows(indptr):
    """numpy reference of ``combine_plan``'s list: the runs past 32
    entries, longest first, ties by row."""
    lens = np.diff(indptr)
    rows = np.flatnonzero(lens > segment.SHORT_RUN)
    return rows[np.argsort(-lens[rows], kind="stable")]


def _source_bins(t, P):
    """The reference's binned operands over the SOURCE rows of ``t``:
    partition ``src // n_per``, slots in engine order within it, cap-pad
    slots with an out-of-block local id (dropped). Returns ``(n_per, slot
    of each real edge [m], local_ids [P, cap])``."""
    n_per = -(-t.n_pad // P)
    part = t.e_src[:t.m] // n_per
    order = np.argsort(part, kind="stable")
    counts = np.bincount(part, minlength=P)
    cap = int(counts.max())
    starts = np.concatenate([[0], np.cumsum(counts)[:-1]])
    slot = np.empty(t.m, np.int64)
    slot[order] = (part[order] * cap
                   + np.arange(t.m) - starts[part[order]])
    loc = np.full(P * cap, n_per, np.int32)
    loc[slot] = t.e_src[:t.m] - part * n_per
    return n_per, slot, loc.reshape(P, cap)


def test_combine_plan_lists_the_long_runs_longest_first(pareto):
    """``combine_plan`` against numpy on the Pareto source CSR, the
    destination CSR and K7-P's walks (a destination layout's, and one over
    the source rows), and its refusals: an ``indptr`` that is not a CSR,
    slots outside the walk's slots, a perm naming payload rows outside
    ``[0, m)`` at a counted slot (an uncounted slot may hold anything)."""
    t = pareto
    rows = segment.combine_plan(T(t.out_indptr), T(t.out_perm), None, None,
                                t.m_pad)
    assert rows.dtype == torch.int32
    want = _long_rows(t.out_indptr)
    np.testing.assert_array_equal(rows.numpy(), want)
    lens = np.diff(t.out_indptr)[want]
    assert lens[0] > 1024 and lens[-1] == lens.min() > 32
    np.testing.assert_array_equal(
        segment.combine_plan(T(t.in_indptr), None, None, None,
                             t.m_pad).numpy(),
        _long_rows(t.in_indptr))
    be = partition.build_layout(t.e_src, t.e_dst, t.n_pad, t.m,
                                3).device_edges(torch.device("cpu"))
    np.testing.assert_array_equal(
        segment.combine_plan(be.in_indptr, be.in_order, be.perm, be.valid,
                             t.m_pad).numpy(),
        _long_rows(be.in_indptr.numpy()))
    n_per, _, loc = _source_bins(t, 4)
    walk = segment.partition_walk(T(loc), n_per, t.n_pad)
    got = segment.combine_plan(walk.indptr, walk.order, None, None,
                               loc.size).numpy()
    np.testing.assert_array_equal(got, want)
    ip, order = T(t.out_indptr), T(t.out_perm)
    for bad, what in ((ip + 1, "not a CSR"), (ip.flip(0).contiguous(),
                                               "not a CSR")):
        with pytest.raises(ValueError, match=what):
            segment.combine_plan(bad, order, None, None, t.m_pad)
    with pytest.raises(ValueError, match="slots outside"):
        segment.combine_plan(ip, order, None, None, t.m - 1)
    perm = be.perm.clone()
    counted = be.in_order[:int(be.in_indptr[-1])].long()
    s = int(counted[be.valid[counted]][0])
    perm[s] = t.m_pad
    with pytest.raises(ValueError, match="payload rows outside"):
        segment.combine_plan(be.in_indptr, be.in_order, perm, be.valid,
                             t.m_pad)
    free = torch.nonzero(~be.valid).reshape(-1)
    if free.numel():
        perm = be.perm.clone()
        perm[free] = -7
        segment.combine_plan(be.in_indptr, be.in_order, perm, be.valid,
                             t.m_pad)


def _pareto_payload(rng, dtype, shape):
    if dtype == np.float32:
        return rng.normal(size=shape).astype(np.float32)
    if dtype == np.int32:
        return rng.integers(-10**6, 10**6, shape).astype(np.int32)
    x = rng.integers(-(1 << 62), 1 << 62, shape)
    pick = rng.random(shape) < 0.2
    x[pick] = rng.choice([-(1 << 63), (1 << 63) - 1, -1, 0], int(pick.sum()))
    return x


def _in_order(x, mask, indptr, order, op, k, m, n):
    """The sequential walk the kernel keeps for every row: window w's row r
    combines its entries in walk order (f32 sums bitwise)."""
    fn = {"sum": np.add, "min": np.minimum, "max": np.maximum}[op]
    out = np.full((k * n,) + x.shape[1:],
                  segment.neutral(op, torch.from_numpy(x[:0]).dtype),
                  x.dtype)
    with np.errstate(over="ignore"):
        for w in range(k):
            for r in range(n):
                for j in range(indptr[r], indptr[r + 1]):
                    e = w * m + (j if order is None else order[j])
                    if mask[e]:
                        out[w * n + r] = fn(out[w * n + r], x[e])
    return out


@pytest.mark.parametrize("dtype", [np.float32, np.int32, np.int64])
@pytest.mark.parametrize("op", ["sum", "min", "max"])
def test_combine_twins_match_jax_on_pareto_sources(pareto, op, dtype):
    """K7's and K7-P's twins at k 3 in the source direction of the Pareto
    CSR (runs of up to 1,176 entries), every op and dtype: against the JAX
    ``segment_combine`` over the flat source ids and the JAX
    ``partition_segment_reduce`` over the same edges binned by source (K7-P
    through ``partition_walk``, window by window); min, max and integer sums
    bitwise, f32 sums within rtol 1e-5 / atol 1e-7 of JAX's scatter and
    bitwise the sequential walk the kernel keeps."""
    t, k = pareto, 3
    rng = np.random.default_rng(11)
    x = _pareto_payload(rng, dtype, k * t.m_pad)
    mask = rng.random(k * t.m_pad) < 0.7
    mask.reshape(k, t.m_pad)[:, t.m:] = False
    csr = segment.SegmentCSR(T(t.e_src), T(t.out_indptr), T(t.out_perm))
    flat = (t.e_src.astype(np.int64)[None, :]
            + np.arange(k)[:, None] * t.n_pad).reshape(-1)
    want = np.asarray(jseg.segment_combine(
        jnp.asarray(x), jnp.asarray(flat, jnp.int32), k * t.n_pad, op,
        jnp.asarray(mask), indices_are_sorted=False))
    got = segment.segment_combine(T(x), csr, op, T(mask), k).numpy()
    _same(got, want, op)
    seq = _in_order(x, mask, t.out_indptr, t.out_perm, op, k, t.m_pad,
                    t.n_pad)
    np.testing.assert_array_equal(got, seq)
    # K7-P: the same edges binned by source, the reference per window
    P = 4
    n_per, slot, loc = _source_bins(t, P)
    B = loc.size
    xb = np.zeros((k, B), x.dtype)
    mb = np.zeros((k, B), bool)
    xb[:, slot] = x.reshape(k, t.m_pad)[:, :t.m]
    mb[:, slot] = mask.reshape(k, t.m_pad)[:, :t.m]
    walk = segment.partition_walk(T(loc), n_per, t.n_pad)
    got = segment.partition_reduce(T(xb.reshape(-1)), walk, op,
                                   T(mb.reshape(-1)), k).numpy()
    for w in range(k):
        ref = np.asarray(jseg.partition_segment_reduce(
            jnp.asarray(xb[w].reshape(P, -1)), jnp.asarray(loc), n_per,
            t.n_pad, op, jnp.asarray(mb[w].reshape(P, -1))))
        _same(got.reshape(k, t.n_pad)[w], ref, op)
    np.testing.assert_array_equal(got, seq)


#: the C entry's launch groups: at most this many grid rows a launch
GRID_ROWS = 65_535


def _model_combine(calls, kind):
    """``rtpu_segment_combine`` (``kind`` "k7") or ``rtpu_partition_reduce``
    ("k7p") as numpy over the wrapper's raw host addresses, as the C entry
    and the kernel take it: the F * k / KW grid rows (KW = k where k <= 3
    and k * n >= 2^20, else 1) in launches of at most 65,535, each launch
    writing only its rows' (window group, feature) pairs and counted in
    ``launched``; in each, the listed long rows (refused unless exactly the
    runs past 32 entries, longest first) and the short rows each combine in
    walk order, except a long row's integers, which combine in a shuffled
    order (any order is exact for them)."""
    shuffle = np.random.default_rng(0)

    def model(k, n, m, F, op, dtype, nl, indptr, *rest):
        if kind == "k7":
            order, long_rows, x, mask, out, _, launched = rest
            perm = valid = None
        else:
            order, perm, valid, long_rows, x, mask, out, _, launched = rest
        ip = _view(indptr, np.int64, n + 1)
        lr = _view(long_rows, np.int32, nl)
        assert lr.tolist() == _long_rows(ip).tolist()
        nnz = int(ip[-1])
        od = None if order is None else _view(order, np.int32, nnz)
        B = int(od.max()) + 1 if od is not None and nnz else m
        pm = None if perm is None else _view(perm, np.int32, B)
        vd = None if valid is None else _view(valid, np.uint8, B)
        dt = {0: np.float32, 1: np.int32, 2: np.int64}[dtype]
        xs = _view(x, dt, k * m * F).reshape(k * m, F)
        mk = _view(mask, np.uint8, k * m)
        o = _view(out, dt, k * n * F).reshape(k * n, F)
        fn = (np.add, np.minimum, np.maximum)[op]
        fill = segment.neutral(("sum", "min", "max")[op],
                               torch.from_numpy(np.zeros(0, dt)).dtype)
        kw = k if k <= 3 and k * n >= 1 << 20 else 1
        gy = F * (k // kw)
        groups = [np.arange(y0, min(gy, y0 + GRID_ROWS))
                  for y0 in range(0, gy, GRID_ROWS)]
        calls.append(dict(nl=nl, launches=len(groups)))
        with np.errstate(over="ignore"):
            for ys in groups:
                launched._obj.value += 1
                for g in np.unique(ys // F):
                    fs = ys[ys // F == g] % F
                    for r in range(n):
                        js = np.arange(ip[r], ip[r + 1])
                        if r in set(lr.tolist()) and dt != np.float32:
                            js = shuffle.permutation(js)
                        for w in range(g * kw, g * kw + kw):
                            acc = np.full(len(fs), fill, dt)
                            for j in js:
                                s = j if od is None else int(od[j])
                                if vd is not None and not vd[s]:
                                    continue
                                e = w * m + (s if pm is None else int(pm[s]))
                                if mk[e]:
                                    acc = fn(acc, xs[e, fs])
                            o[w * n + r, fs] = acc
        return 0
    return model


@pytest.fixture
def combine_card(monkeypatch):
    """K7's and K7-P's card branch on CPU tensors through the numpy model,
    a fresh signature cache, and the plans counted."""
    calls, plans = [], []
    plan = segment.combine_plan
    monkeypatch.setattr(segment, "_on_cuda", lambda name, *ts: True)
    monkeypatch.setattr(columns, "_on_cuda", lambda name, *ts: True)
    monkeypatch.setattr(segment, "_stream", lambda t: 0)
    monkeypatch.setattr(segment, "_fn", lambda lib, fn: _model_combine(
        calls, "k7" if fn == "rtpu_segment_combine" else "k7p"))
    monkeypatch.setattr(segment, "combine_plan",
                        lambda *a: plans.append(a) or plan(*a))
    monkeypatch.setattr(columns, "_K2_SIGS", {})
    columns.reset_launches()
    yield calls, plans
    columns.reset_launches()


def _runs_csr(rng, runs, permuted):
    """A CSR whose rows have the given run lengths (long rows of 33, 40 and
    1,100 entries among short ones), its edges in engine order shuffled
    when ``permuted`` (the source direction: walked through ``perm``, a
    stable sort by row, as ``out_perm`` is)."""
    ids = np.repeat(np.arange(len(runs)), runs).astype(np.int32)
    m = len(ids)
    indptr = np.concatenate([[0], np.cumsum(runs)]).astype(np.int64)
    if not permuted:
        return segment.SegmentCSR(T(ids), T(indptr), None), m
    e_ids = ids[rng.permutation(m)]
    perm = np.argsort(e_ids, kind="stable").astype(np.int32)
    return segment.SegmentCSR(T(e_ids), T(indptr), T(perm)), m


@pytest.mark.parametrize("permuted", [False, True], ids=["dst", "src"])
def test_combine_card_branch_one_launch_checks_once(combine_card, permuted):
    """The card branch of K7 and K7-P through the model: every op and dtype
    at k 1 and 3 with a feature axis, bitwise the twins (f32 sums too: both
    add in walk order), one launch a call, the long rows passed; the walk's
    plan made once for every call over it, and again after an in-place
    change of the walk."""
    calls, plans = combine_card
    rng = np.random.default_rng(2 + permuted)
    runs = [0, 3, 33, 7, 40, 1, 0, 1100, 32, 5]
    csr, m = _runs_csr(rng, runs, permuted)
    walk = segment.PartitionWalk(csr.indptr, csr.perm if permuted else
                                 T(np.arange(m, dtype=np.int32)), None, None)
    n = len(runs)
    cases = 0
    for dtype in (np.float32, np.int32, np.int64):
        for k, F in ((1, 0), (3, 2)):
            x = T(_pareto_payload(rng, dtype, (k * m,) + ((F,) if F else ())))
            mask = T(rng.random(k * m) < 0.8)
            for op in ("sum", "min", "max"):
                got = segment.segment_combine(x, csr, op, mask, k)
                with pytest.MonkeyPatch.context() as mp:
                    mp.setattr(segment, "_on_cuda", lambda *a: False)
                    mp.setattr(columns, "_on_cuda", lambda *a: False)
                    want = segment.segment_combine(x, csr, op, mask, k)
                    wantp = segment.partition_reduce(x, walk, op, mask, k)
                assert got.shape == (k * n,) + x.shape[1:]
                assert torch.equal(got, want)
                assert torch.equal(segment.partition_reduce(
                    x, walk, op, mask, k), wantp)
                assert torch.equal(wantp, want)
                cases += 2
    assert columns.LAUNCHES["segment_combine"] \
        + columns.LAUNCHES["segment_combine_i64"] == cases // 2
    assert columns.LAUNCHES["partition_segment_reduce"] \
        + columns.LAUNCHES["partition_segment_reduce_i64"] == cases // 2
    assert len(calls) == cases and all(c["nl"] == 3 for c in calls)
    assert len(plans) == 2                    # one a walk, K7's and K7-P's
    # a walk changed in place is planned again (row 1 made long, row 2
    # short)
    csr.indptr[2] += 30
    x = T(_pareto_payload(rng, np.int32, m))
    mask = T(rng.random(m) < 0.8)
    segment.segment_combine(x, csr, "sum", mask, 1)
    assert len(plans) == 3 and calls[-1]["nl"] == 3
    csr.indptr[1] = -1
    with pytest.raises(ValueError, match="not a CSR"):
        segment.segment_combine(x, csr, "sum", mask, 1)


def test_combine_card_branch_checks_the_payload_every_call(combine_card):
    """The walk and the mask are checked once a signature; the payload at
    every call: its dtype, contiguity and device. A payload past the
    kernel's 65,535 grid rows (features x windows) is not refused: the
    C entry launches once a group of them, the output the twin's."""
    rng = np.random.default_rng(4)
    csr, m = _runs_csr(rng, [2, 3, 1], False)
    mask = T(np.ones(m, bool))
    x = T(np.arange(m, dtype=np.float32))
    segment.segment_combine(x, csr, "sum", mask, 1)
    with pytest.raises(TypeError, match="no kernel"):
        segment.segment_combine(x.double(), csr, "sum", mask, 1)
    with pytest.raises(ValueError, match="contiguous"):
        segment.segment_combine(T(np.zeros((2, m), np.float32)).t(), csr,
                                "sum", mask, 1)
    wide = T(rng.random((m, 70_000)).astype(np.float32))
    before = columns.LAUNCHES["segment_combine"]
    got = segment.segment_combine(wide, csr, "sum", mask, 1)
    assert columns.LAUNCHES["segment_combine"] - before == 2
    assert torch.equal(got, segment.segment_combine_plain(wide, csr, "sum",
                                                          mask, 1))
    with pytest.raises(ValueError, match="several devices|mask on"):
        segment.segment_combine(x.to("meta"), csr, "sum", mask, 1)
