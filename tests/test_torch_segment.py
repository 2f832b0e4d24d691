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
  int32 and int64 times and pad rows.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raphtory_tpu.engine import bsp as jbsp
from raphtory_tpu.engine import device_sweep as jds
from raphtory_tpu.ops import segment as jseg
from raphtory_tpu_torch.ops import resident, segment

N_REAL, N_PAD, M_REAL, M_PAD = 13, 16, 50, 64


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
        resident.apply_delta_chunk(
            tbufs, tuple(torch.from_numpy(a) for a in chunk))
        for g, w in zip(tbufs, jbufs):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_apply_delta_chunk_refuses_bad_inputs():
    bufs = (torch.zeros(8, dtype=torch.int32), torch.zeros(8, dtype=bool),
            torch.zeros(8, dtype=torch.int32),
            torch.zeros(16, dtype=torch.int32), torch.zeros(16, dtype=bool),
            torch.zeros(16, dtype=torch.int32))
    dup = (torch.tensor([1, 1], dtype=torch.int32),
           torch.zeros(2, dtype=torch.int32), torch.zeros(2, dtype=bool),
           torch.zeros(2, dtype=torch.int32),
           torch.tensor([2**31 - 1], dtype=torch.int32),
           torch.zeros(1, dtype=torch.int32), torch.zeros(1, dtype=bool),
           torch.zeros(1, dtype=torch.int32))
    with pytest.raises(ValueError, match="twice"):
        resident.apply_delta_chunk(bufs, dup)
    wide = dup[:1] + (dup[1].long(),) + dup[2:]
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

@pytest.mark.parametrize("n", [8, 64, 1024])
def test_unpack_mask_bits_twin_matches_jax(n):
    rng = np.random.default_rng(n)
    masks = rng.random((3, n)) < 0.4
    packed = np.packbits(masks, axis=1, bitorder="little")
    want = np.asarray(jbsp._unpack_bits(jnp.asarray(packed), n))
    got = resident.unpack_mask_bits(torch.from_numpy(packed))
    assert got.dtype == torch.bool
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(got.numpy(), masks)


def test_wrappers_refuse_other_devices():
    """Only CPU tensors take the twins; other device types raise."""
    meta = torch.zeros((2, 4), dtype=torch.uint8, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        resident.unpack_mask_bits(meta)
