"""The card branches of K9a (``apply_delta_chunk``: one packed chunk a
call) and K9b (``window_masks``: bounds passed by value, 32 windows a
launch), and the grid-row split of K7 / K7-P / K7-mode, on the CPU.

The CUDA entry points cannot run here, so each is modelled in numpy over
the raw host addresses the wrapper passes (as ``test_torch_features.
_model_binned`` does): the wrappers run their card branch as they would on
the card (checks, allocation, packing, the ctypes arguments, launch counts)
and the model stands in for the kernel. Every result is held against the
plain twin and against the JAX package on the same numpy inputs: K9b
against ``raphtory_tpu/engine/device_sweep.py:261`` ``_compiled_run``'s
masks, K9a against ``_compiled_apply`` (``:239``), and ``DeviceSweep``
over the packed staging against the JAX package's sweep, bitwise, with
equal ``ship_bytes``.
"""

from dataclasses import dataclass

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_sweep import random_log
from test_torch_columns import _view
from test_torch_device_sweep import _check_run, _same_buffers
from test_torch_lpa import _edge_inboxes, _model_mode
from test_torch_segment import _model_combine, _runs_csr

from raphtory_tpu.algorithms import ConnectedComponents as JCC
from raphtory_tpu.algorithms import PageRank as JPageRank
from raphtory_tpu.engine import device_sweep as jds
from raphtory_tpu.engine.program import VertexProgram as JVP
from raphtory_tpu_torch.engine import device_sweep as tds
from raphtory_tpu_torch.interop import event_log_from_arrays
from raphtory_tpu_torch.ops import columns, resident, segment

T = torch.from_numpy
_NP = {4: np.int32, 8: np.int64}


def _align16(n):
    return -(-n // 16) * 16


# ------------------------------------------------ the kernels as numpy

def _model_window_masks(calls):
    """``rtpu_window_masks`` over the wrapper's raw addresses: the bounds
    read from the HOST array (2k int64: lo, then nowin), one launch a group
    of 32 windows, each window's row ``alive & (nowin | lat >= lo)`` with
    ``lo`` cast to the times' dtype (refused unless it fits). The masks must
    be one allocation, the edge rows starting at the next 16-byte boundary
    past the vertex rows."""
    def model(k, n, m, tbytes, v_lat, v_alive, e_lat, e_alive, bounds,
              v_out, e_out, stream, launched):
        tdt = _NP[tbytes]
        b = np.ctypeslib.as_array(bounds, (2 * k,)).copy()
        lo, nowin = b[:k], b[k:]
        info = np.iinfo(tdt)
        assert ((lo >= info.min) & (lo <= info.max)).all()
        assert set(nowin.tolist()) <= {0, 1}
        assert e_out - v_out == _align16(k * n) and e_out % 16 == 0
        calls.append(dict(k=k, launches=-(-k // 32)))
        for lat_a, al_a, out_a, ln in ((v_lat, v_alive, v_out, n),
                                       (e_lat, e_alive, e_out, m)):
            lat = _view(lat_a, tdt, ln)
            alive = _view(al_a, np.uint8, ln) != 0
            out = _view(out_a, np.uint8, k * ln).reshape(k, ln)
            for w0 in range(0, k, 32):
                for w in range(w0, min(k, w0 + 32)):
                    out[w] = alive & (bool(nowin[w])
                                      | (lat >= tdt(lo[w])))
        launched._obj.value += -(-k // 32)
        return 0
    return model


def _chunk_offsets(cap_v, cap_e, tb):
    """The packed chunk's layout as ``csrc/sweep.cu`` ``chunk_offset``
    computes it: fields v_idx, v_lat, v_alive, v_first, e_idx, e_lat,
    e_alive, e_first of widths 4, tb, 1, tb, each at the next multiple of
    16 bytes."""
    offs, off = [], 0
    for f in range(8):
        offs.append(off)
        off += _align16((cap_v if f < 4 else cap_e) * (4, tb, 1, tb)[f % 4])
    return offs, off


def _model_apply(calls):
    """``rtpu_apply_delta_chunk`` over the raw addresses: the eight fields
    read from the one packed buffer at the kernel's offsets, a thread 4
    rows; rows whose index lies outside ``[0, len)`` skipped."""
    def model(n_pad, m_pad, cap_v, cap_e, tbytes, v_lat, v_alive, v_first,
              e_lat, e_alive, e_first, packed, stream):
        tdt = _NP[tbytes]
        assert packed % 16 == 0
        offs, total = _chunk_offsets(cap_v, cap_e, tbytes)
        calls.append(dict(cap_v=cap_v, cap_e=cap_e, nbytes=total))
        raw = _view(packed, np.uint8, total)

        def field(f, dt, cap):
            return raw[offs[f]: offs[f] + cap * np.dtype(dt).itemsize] \
                .view(dt)

        for side, (ln, cap, bufs) in enumerate((
                (n_pad, cap_v, (v_lat, v_alive, v_first)),
                (m_pad, cap_e, (e_lat, e_alive, e_first)))):
            f0 = 4 * side
            idx = field(f0, np.int32, cap).astype(np.int64)
            src = (field(f0 + 1, tdt, cap), field(f0 + 2, np.uint8, cap),
                   field(f0 + 3, tdt, cap))
            dst = (_view(bufs[0], tdt, ln), _view(bufs[1], np.uint8, ln),
                   _view(bufs[2], tdt, ln))
            for q0 in range(0, cap, 4):            # a thread's rows
                for q in range(q0, min(cap, q0 + 4)):
                    p = idx[q]
                    if 0 <= p < ln:
                        for d, s in zip(dst, src):
                            d[p] = s[q]
        return 0
    return model


@pytest.fixture
def card(monkeypatch):
    """The card branches of K9a and K9b (and K7 / K7-P / K7-mode) on CPU
    tensors through the numpy models, with fresh signature caches."""
    calls = {"window_masks": [], "apply": [], "combine": [], "mode": []}
    models = {"rtpu_window_masks": _model_window_masks(calls["window_masks"]),
              "rtpu_apply_delta_chunk": _model_apply(calls["apply"])}
    for mod in (resident, columns, segment):
        monkeypatch.setattr(mod, "_on_cuda", lambda name, *ts: True)
    monkeypatch.setattr(resident, "_stream", lambda t: 0)
    monkeypatch.setattr(segment, "_stream", lambda t: 0)
    monkeypatch.setattr(resident, "_fn", lambda lib, fn: models[fn])
    monkeypatch.setattr(segment, "_fn", lambda lib, fn: (
        _model_mode(calls["mode"]) if fn == "rtpu_segment_mode"
        else _model_combine(calls["combine"], "k7" if fn ==
                            "rtpu_segment_combine" else "k7p")))
    monkeypatch.setattr(columns, "_K2_SIGS", {})
    monkeypatch.setattr(segment, "_MODE_PLANS", {})
    columns.reset_launches()
    yield calls
    columns.reset_launches()


# ---------------------------------------------------------------- K9b

def _state(rng, tdt, n, m):
    info = np.iinfo(tdt)
    edge = np.array([info.min, info.min + 1, -100, 0, 50, 99, 100,
                     info.max - 1, info.max], tdt)
    v_lat, e_lat = (rng.choice(edge, s).astype(tdt) for s in (n, m))
    v_alive, e_alive = (rng.random(s) < 0.7 for s in (n, m))
    return v_lat, v_alive, e_lat, e_alive


def _windows(rng, k, tdt):
    """k windows: unbounded (negative), 0, inside the data, and past the
    dtype's range (``lo`` clamped)."""
    pool = [-1, -7, 0, 1, 50, 150, 1 << 40, 1 << 62]
    return [int(w) for w in rng.choice(pool, k)]


def test_window_masks_card_branch_passes_bounds_by_value(card,
                                                         monkeypatch):
    """The card branch makes no tensor for its bounds (``torch.tensor`` is
    never called, nor ``window_bounds``): they reach the C entry as a host
    int64 array; one launch for k <= 32, the masks views of one
    allocation; the state is checked once per signature."""
    rng = np.random.default_rng(1)
    st = tuple(T(a) for a in _state(rng, np.int32, 40, 72))
    made, checked = [], []
    real = torch.tensor
    monkeypatch.setattr(torch, "tensor",
                        lambda *a, **kw: made.append(a) or real(*a, **kw))
    monkeypatch.setattr(resident, "window_bounds", None)
    check = resident._check_state
    monkeypatch.setattr(resident, "_check_state",
                        lambda *a: checked.append(a) or check(*a))
    for _ in range(3):
        vm, em = resident.window_masks(*st, 100, [-1, 30, 1 << 40])
    assert made == [] and len(checked) == 1
    assert columns.LAUNCHES["window_masks"] == 3
    assert vm.shape == (3, 40) and em.shape == (3, 72)
    assert vm.untyped_storage().data_ptr() == em.untyped_storage().data_ptr()
    monkeypatch.undo()
    lo, nowin = resident.window_bounds(100, [-1, 30, 1 << 40], torch.int32,
                                       "cpu")
    want = resident.window_masks_plain(*st, lo, nowin)
    assert torch.equal(vm, want[0]) and torch.equal(em, want[1])


@dataclass(frozen=True)
class _Probe(JVP):
    """``ctx.v_mask`` and the in-degree under the edge masks: with edge i's
    destination vertex i, the in-degree IS the edge mask."""
    max_steps: int = 0
    needs_vids = needs_vertex_times = needs_edge_times = False

    def init(self, ctx):
        return {}

    def finalize(self, state, ctx):
        return {"v": ctx.v_mask, "in": ctx.in_deg}


@pytest.mark.parametrize("tdt", [np.int32, np.int64])
@pytest.mark.parametrize("k", [1, 3, 32, 33, 70])
def test_window_masks_card_branch_matches_twin_and_compiled_run(card, k,
                                                                tdt):
    """k windows in groups of 32 (one launch a group), int32 and int64
    times at the dtype's limits, a ``lo`` clamped to the dtype's range and
    negative (unbounded) windows: bitwise the twin and the masks of the
    JAX package's ``_compiled_run``."""
    rng = np.random.default_rng(k)
    n = m = 50                       # edge i's destination is vertex i
    arrs = _state(rng, tdt, n, m)
    windows = _windows(rng, k, tdt)
    Tq = 100
    got = resident.window_masks(*(T(a) for a in arrs), Tq, windows)
    assert columns.LAUNCHES["window_masks"] == -(-k // 32)
    assert card["window_masks"][-1] == dict(k=k, launches=-(-k // 32))
    lo, nowin = resident.window_bounds(Tq, windows, T(arrs[0]).dtype, "cpu")
    want = resident.window_masks_plain(*(T(a) for a in arrs), lo, nowin)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    v_lat, v_alive, e_lat, e_alive = arrs
    run = jds._compiled_run(_Probe(), n, m, k, np.dtype(tdt).name)
    res, _ = run(*(jnp.asarray(a) for a in (v_lat, v_alive, v_lat, e_lat,
                                            e_alive, e_lat)),
                 jnp.full((n,), -1, jnp.int64),
                 jnp.zeros(m, jnp.int32), jnp.arange(m, dtype=jnp.int32),
                 jnp.asarray(Tq, jnp.int64),
                 jnp.asarray(windows, jnp.int64))
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(res["v"]))
    np.testing.assert_array_equal(got[1].numpy().astype(np.int32),
                                  np.asarray(res["in"]))


@pytest.mark.parametrize("tdt", [np.int32, np.int64])
def test_window_masks_card_branch_at_the_time_limits(card, tdt):
    """``T`` at both ends of the dtype's range: every ``lo`` clamped one way
    or the other, the compares in the narrow dtype, bitwise the twin."""
    rng = np.random.default_rng(9)
    arrs = _state(rng, tdt, 33, 17)
    info = np.iinfo(tdt)
    for Tq, windows in ((int(info.max) - 3, [-1, 5, 1 << 62, 0]),
                        (int(info.min) + 20, [0, 10, -1, 1 << 40])):
        got = resident.window_masks(*(T(a) for a in arrs), Tq, windows)
        lo, nowin = resident.window_bounds(Tq, windows, T(arrs[0]).dtype,
                                           "cpu")
        want = resident.window_masks_plain(*(T(a) for a in arrs), lo,
                                           nowin)
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


# ---------------------------------------------------------------- K9a

@pytest.mark.parametrize("tdt", [torch.int32, torch.int64])
@pytest.mark.parametrize("caps", [(8, 16), (13, 7), (1024, 4096), (0, 5)])
def test_chunk_layout_is_aligned_and_ships_the_arrays_bytes(caps, tdt):
    """The eight fields start at multiples of 16 bytes, in order, without
    overlap, as the kernel's ``chunk_offset`` places them; the chunk's
    ``payload_bytes`` are the eight arrays' own bytes (what the parent's
    eight uploads shipped), alignment padding excluded."""
    cap_v, cap_e = caps
    offs, nbytes = resident.chunk_offsets(cap_v, cap_e, tdt)
    assert (list(offs), nbytes) == _chunk_offsets(cap_v, cap_e,
                                                  tdt.itemsize)
    assert all(o % 16 == 0 for o in offs) and list(offs) == sorted(offs)
    arrays = (np.zeros(0, np.int32),) * 8
    ch = resident.pack_chunk(arrays, cap_v, cap_e, tdt)
    assert ch.data.dtype == torch.uint8 and ch.data.numel() == nbytes
    views = ch.arrays()
    for (name, dt, side), v, o in zip(resident._FIELDS, views, offs):
        assert v.dtype == (dt or tdt)
        assert v.numel() == (cap_e if side else cap_v)
        if v.numel():                 # (an empty view has no address)
            assert v.data_ptr() - ch.data.data_ptr() == o
        if name.endswith("idx"):
            assert bool((v == 2**31 - 1).all())       # every row a pad
    assert ch.payload_bytes == sum(v.numel() * v.element_size()
                                   for v in views)


def _rows(rng, cap, length, tdt, fill, low):
    """``fill`` rows of distinct positions in ``[0, length)``, two of them
    replaced by indices outside it: ``length`` itself, and ``low`` (-3, or
    2^31 - 2 where the JAX package reads the chunk: its scatter wraps a
    negative index, which the host fold never emits)."""
    info = np.iinfo(tdt)
    edge = np.array([info.min, info.min + 1, -5, 0, 7, info.max - 1,
                     info.max], tdt)
    idx = rng.choice(length, fill, replace=False).astype(np.int32)
    if fill >= 4:
        idx[1], idx[2] = low, length
    return (idx, rng.choice(edge, fill).astype(tdt), rng.random(fill) < 0.5,
            rng.choice(edge, fill).astype(tdt))


@pytest.mark.parametrize("tdt", [np.int32, np.int64])
def test_apply_delta_chunk_card_branch_matches_twin_and_jax(card, tdt):
    """Four chunks in a row through the card branch (the model reads the
    ONE packed buffer at the kernel's offsets): pads (rows past each
    side's fill) and indices outside ``[0, len)`` skipped; the six buffers
    bitwise the twin's after every chunk, and the JAX package's
    ``_compiled_apply``'s after the three without a negative index. The
    buffers are checked once; each call checks the packed chunk."""
    rng = np.random.default_rng(11)
    n, m, cap_v, cap_e = 64, 256, 30, 97
    tt = torch.int32 if tdt == np.int32 else torch.int64
    info = np.iinfo(tdt)
    init = (np.full(n, info.min, tdt), np.zeros(n, bool),
            np.full(n, info.min, tdt), np.full(m, info.min, tdt),
            np.zeros(m, bool), np.full(m, info.min, tdt))
    got = tuple(T(b.copy()) for b in init)
    want = tuple(T(b.copy()) for b in init)
    jbufs = tuple(jnp.asarray(b) for b in init)
    apply = jds._compiled_apply(cap_v, cap_e, np.dtype(tdt).name)
    checked = []
    check = resident._check_bufs
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(resident, "_check_bufs",
                   lambda *a: checked.append(a) or check(*a))
        for low in (2**31 - 2, -3, 2**31 - 2, 2**31 - 2):
            rows = (_rows(rng, cap_v, n, tdt, int(rng.integers(4, cap_v)),
                          low)
                    + _rows(rng, cap_e, m, tdt, int(rng.integers(4, cap_e)),
                            low))
            ch = resident.pack_chunk(rows, cap_v, cap_e, tt)
            resident.apply_delta_chunk(got, ch)
            resident.apply_delta_chunk_plain(want, ch.arrays())
            for g, w in zip(got, want):
                assert torch.equal(g, w)
            if low < 0:        # restart the reference from this state
                jbufs = tuple(jnp.asarray(g.numpy()) for g in got)
                continue
            jbufs = apply(*jbufs, *(jnp.asarray(a) for a in ch.arrays()))
            for g, j in zip(got, jbufs):
                np.testing.assert_array_equal(g.numpy(), np.asarray(j))
    assert len(checked) == 1 and len(card["apply"]) == 4
    assert columns.LAUNCHES["apply_delta_chunk"] == 4
    assert card["apply"][-1]["nbytes"] == ch.data.numel()


def test_apply_delta_chunk_card_branch_checks_the_chunk_every_call(card):
    """A chunk of the wrong size, byte dtype, time dtype or alignment
    raises, on a signature already checked."""
    bufs = (torch.zeros(8, dtype=torch.int32), torch.zeros(8, dtype=bool),
            torch.zeros(8, dtype=torch.int32),
            torch.zeros(16, dtype=torch.int32), torch.zeros(16, dtype=bool),
            torch.zeros(16, dtype=torch.int32))
    empty = (np.zeros(0, np.int32),) * 8
    ch = resident.pack_chunk(empty, 4, 4, torch.int32)
    resident.apply_delta_chunk(bufs, ch)
    with pytest.raises(ValueError, match="packed chunk"):
        resident.apply_delta_chunk(bufs, ch._replace(data=ch.data[:-16]))
    with pytest.raises(TypeError, match="packed chunk"):
        resident.apply_delta_chunk(bufs, ch._replace(
            data=ch.data.view(torch.int8)))
    with pytest.raises(TypeError, match="vd_lat"):
        resident.apply_delta_chunk(bufs, resident.pack_chunk(
            empty, 4, 4, torch.int64))
    shifted = torch.zeros(ch.data.numel() + 1, dtype=torch.uint8)[1:]
    with pytest.raises(ValueError, match="aligned"):
        resident.apply_delta_chunk(bufs, ch._replace(data=shifted))
    with pytest.raises(ValueError, match="capacity"):
        resident.pack_chunk((np.zeros(5, np.int32),) + empty[1:], 4, 4,
                            torch.int32)
    assert columns.LAUNCHES["apply_delta_chunk"] == 1


# ------------------------------------------- DeviceSweep over the packing

def _pair(jlog):
    return (jds.DeviceSweep(jlog),
            tds.DeviceSweep(event_log_from_arrays(jlog.arrays()),
                            device="cpu"))


@pytest.mark.parametrize("through", ["twin", "card"])
def test_device_sweep_packed_staging_matches_reference(request, through):
    """Hops with multi-chunk deltas (capacities shrunk to 8 / 16) through
    the packed staging, on the twins and through the card branches' models
    (K9a reading the packed chunk, K9b its bounds by value): the resident
    buffers bitwise the JAX package's after every hop, CC and PageRank as
    the reference's, and ``ship_bytes`` equal to the reference's (the eight
    arrays' bytes) hop for hop."""
    if through == "card":
        request.getfixturevalue("card")
    jlog = random_log(np.random.default_rng(9), n_events=800, n_ids=60,
                      t_span=100)
    jsw, tsw = _pair(jlog)
    jsw.cap_v, jsw.cap_e = tsw.cap_v, tsw.cap_e = 8, 16
    seen = []
    for Tq in [20, 21, 50, 72, 99]:
        payload = tsw._fold_hop_inner(Tq)
        seen.append(len(payload.get("chunks", ())))
        tsw._apply_staged(payload)
        jsw.advance(Tq)
        _same_buffers(jsw, tsw)
        assert tsw.ship_bytes == jsw.ship_bytes
        _check_run(jsw, tsw, JCC(max_steps=50), Tq, windows=[30, -1])
        _check_run(jsw, tsw, JPageRank(max_steps=10, tol=1e-7), Tq,
                   windows=[200, 40, 5])
    assert max(seen) >= 2
    if through == "card":
        assert columns.LAUNCHES["apply_delta_chunk"] >= sum(seen)


def test_staging_pins_for_a_card_and_ships_one_non_blocking_copy(
        monkeypatch):
    """A sweep on a card stages each chunk in pinned memory and ships it
    in ONE non-blocking copy (recorded here with a stand-in for the host
    buffer)."""
    jlog = random_log(np.random.default_rng(9), n_events=300, n_ids=30,
                      t_span=100)
    _, tsw = _pair(jlog)
    tsw.cap_v, tsw.cap_e = 8, 16
    tsw.advance(45)
    pins, copies, applied = [], [], []

    class Host:
        def to(self, device, non_blocking=False):
            copies.append((device, non_blocking))
            return self

    def pack(arrays, cap_v, cap_e, tdtype, pin=False):
        pins.append(pin)
        return resident.PackedChunk(Host(), cap_v, cap_e, tdtype)

    monkeypatch.setattr(tds, "pack_chunk", pack)
    monkeypatch.setattr(tds, "apply_delta_chunk",
                        lambda bufs, ch: applied.append(ch))
    tsw.device = torch.device("cuda")
    payload = tsw._fold_hop_inner(50)
    assert payload["kind"] == "chunks" and len(payload["chunks"]) >= 2
    tsw._apply_staged(payload)
    assert pins == [True] * len(payload["chunks"])
    assert copies == [(torch.device("cuda"), True)] * len(pins)
    assert len(applied) == len(pins)


# ------------------------------------------- K7 / K7-mode past 65,535 rows

@pytest.mark.parametrize("k, F, launches", [(1, 65_535, 1), (1, 65_536, 2),
                                            (3, 21_846, 2), (2, 70_000, 3)])
def test_combine_splits_past_the_grid_row_limit(card, k, F, launches):
    """K7 and K7-P with F * k grid rows at, just past and far past 65,535:
    one launch up to the limit, one a group of 65,535 rows past it (each
    launch writing its own rows), bitwise the twins."""
    rng = np.random.default_rng(F + k)
    csr, m = _runs_csr(rng, [2, 0, 3, 1], False)
    walk = segment.PartitionWalk(csr.indptr, T(np.arange(m, dtype=np.int32)),
                                 None, None)
    x = T(rng.random((k * m, F)).astype(np.float32))
    mask = T(rng.random(k * m) < 0.8)
    for op in ("sum", "max"):
        got = segment.segment_combine(x, csr, op, mask, k)
        gotp = segment.partition_reduce(x, walk, op, mask, k)
        want = segment.segment_combine_plain(x, csr, op, mask, k)
        assert torch.equal(got, want) and torch.equal(gotp, want)
    assert columns.LAUNCHES["segment_combine"] == 2 * launches
    assert columns.LAUNCHES["partition_segment_reduce"] == 2 * launches
    assert all(c["launches"] == launches for c in card["combine"])


@pytest.mark.parametrize("k, launches", [(65_535, 1), (65_538, 2)])
def test_segment_mode_splits_past_the_window_limit(card, k, launches):
    """K7-mode with k windows at and past 65,535: one launch up to the
    limit, one a group of 65,535 windows past it, bitwise the twin."""
    rng = np.random.default_rng(k)
    vals, _, csr, mask = _edge_inboxes(rng, k, False, [2, 0, 3, 1], 1)
    v, mk = T(vals), T(mask)
    got = segment.segment_mode(v, csr, k * csr.n, mk, -1, k)
    assert torch.equal(got, segment.segment_mode_plain(v, csr, k * csr.n,
                                                       mk, -1, k))
    assert columns.LAUNCHES["segment_mode"] == launches
    assert card["mode"][-1]["launches"] == launches

