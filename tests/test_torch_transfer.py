"""The port's chunked transfer engine (``utils/transfer.py``) against plain
copies: ``put`` equals one plain copy across window boundaries at depths
1, 2 and 4; ``put_many`` keeps its order across arrays and passes device
tensors through; the stats count bytes, windows and the window high-water
mark; the staging copy puts each part where a plain copy does. The card
branch (pinned buffers reused across puts, non-blocking copies, events)
runs here over stand-ins whose events record the window."""

import contextlib
import threading

import numpy as np
import pytest
import torch

from raphtory_tpu_torch.ops import partition, resident
from raphtory_tpu_torch.utils import transfer
from raphtory_tpu_torch.utils.transfer import TransferEngine, shared_engine

SHAPES = [(1003,), (517, 7), (64, 3, 5), (), (0, 4), (1,)]
DTYPES = [np.int32, np.int64, np.float32, np.float64, bool, np.uint8]


def _array(rng, shape, dt):
    a = rng.integers(-1000, 1000, shape)
    return (a % 2 == 0) if dt is bool else a.astype(dt)


def _windows(nbytes) -> int:
    """Windows of one put of arrays of ``nbytes`` (16-byte aligned)."""
    total = resident.offsets16(nbytes)[1]
    return -(-total // transfer.CHUNK_BYTES)


@pytest.mark.parametrize("depth", [1, 2, 4])
@pytest.mark.parametrize("chunk", [16, 96, 1 << 12, 32 << 20])
def test_put_equals_a_plain_copy(monkeypatch, depth, chunk):
    monkeypatch.setattr(transfer, "DEPTH", depth)
    monkeypatch.setattr(transfer, "CHUNK_BYTES", chunk)
    rng = np.random.default_rng(depth * 7 + chunk)
    for shape in SHAPES:
        for dt in DTYPES:
            a = _array(rng, shape, dt)
            eng = TransferEngine()
            got = eng.put(a, "cpu")
            want = torch.as_tensor(a)
            assert got.dtype == want.dtype and got.shape == want.shape
            assert torch.equal(got, want), (shape, dt)
            st = eng.stats.as_dict()
            assert st["slices"] == _windows([a.nbytes])
            assert st["bytes_shipped"] == resident.offsets16([a.nbytes])[1]
            assert st["inflight_depth_high_water"] <= depth
    # a strided (non-contiguous) source stages contiguously
    a = np.arange(4000, dtype=np.int64).reshape(400, 10)[::3, ::2]
    assert torch.equal(TransferEngine().put(a, "cpu"),
                       torch.as_tensor(np.ascontiguousarray(a)))


def test_put_many_keeps_order_and_passes_tensors_through(monkeypatch):
    monkeypatch.setattr(transfer, "CHUNK_BYTES", 64)
    rng = np.random.default_rng(3)
    arrays = [_array(rng, (n, 3), dt) for n, dt in
              ((100, np.int32), (1, np.float32), (333, bool),
               (0, np.int64), (50, np.uint8))]
    held = torch.arange(10)
    eng = TransferEngine()
    out = eng.put_many(arrays[:2] + [held] + arrays[2:], "cpu")
    assert out[2] is held
    for got, a in zip(out[:2] + out[3:], arrays):
        assert got.dtype == torch.as_tensor(a).dtype
        assert torch.equal(got, torch.as_tensor(a))
        # 16-byte aligned views of one buffer
        assert got.data_ptr() % 16 == 0 and got.is_contiguous()
    assert eng.stats.as_dict()["slices"] == _windows(
        [a.nbytes for a in arrays])
    # a host tensor is copied, not passed through, on another device kind
    t = torch.arange(6, dtype=torch.int16)
    assert torch.equal(eng.put(t.numpy(), "cpu"), t)
    assert eng.put_many([], "cpu") == []


def test_stats_delta_and_shared_engine():
    eng = shared_engine()
    assert shared_engine() is eng
    prior = eng.stats.as_dict()
    a = np.zeros((1000, 8), np.float32)
    eng.put(a, "cpu")
    d = eng.stats.delta_since(prior)
    assert d["bytes_shipped"] == a.nbytes and d["slices"] == 1
    assert d["inflight_depth_high_water"] >= 1


@pytest.mark.parametrize("gaps", [(0, 0), (15, 1), (0, 4000)])
def test_fill_places_each_part_as_a_plain_copy(gaps):
    """``_fill`` puts each part's bytes at its offset and leaves the bytes
    between the parts as they were."""
    rng = np.random.default_rng(sum(gaps))
    sizes, at, parts = (4321, 17, 9000), 0, []
    for size, gap in zip(sizes, (0,) + gaps):
        at += gap
        parts.append((at, rng.integers(0, 255, size).astype(np.uint8)))
        at += size
    got = np.full(at + 7, 3, np.uint8)
    want = got.copy()
    for off, src in parts:
        want[off: off + len(src)] = src
    transfer._fill(got, parts)
    np.testing.assert_array_equal(got, want)


class _FakeEvent:
    LOG: list = []

    def record(self, stream):
        _FakeEvent.LOG.append(("record", id(self)))

    def synchronize(self):
        _FakeEvent.LOG.append(("sync", id(self)))


class _FakeStream:
    device = torch.device("cpu")

    def wait_stream(self, other):
        _FakeEvent.LOG.append(("wait_stream",))


class _FakeRing:
    """``_Ring`` with unpinned buffers (this torch cannot pin) and a
    stand-in stream; every ring made is counted."""
    MADE: list = []

    def __init__(self, dev):
        self.size = (transfer.DEPTH, transfer.CHUNK_BYTES)
        self.bufs = [torch.empty(transfer.CHUNK_BYTES, dtype=torch.uint8)
                     for _ in range(transfer.DEPTH)]
        self.stream = _FakeStream()
        self.events = [None] * transfer.DEPTH
        _FakeRing.MADE.append(self)


@pytest.fixture
def card(monkeypatch):
    """The card branch over stand-ins: ``_on_card`` True, the ring, its
    stream, its events and the stream context faked."""
    _FakeEvent.LOG, _FakeRing.MADE = [], []
    monkeypatch.setattr(transfer, "_on_card", lambda dev: True)
    monkeypatch.setattr(transfer, "_Ring", _FakeRing)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    monkeypatch.setattr(torch.cuda, "Event", _FakeEvent)
    monkeypatch.setattr(torch.cuda, "stream",
                        lambda s: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda dev=None: _FakeStream())
    monkeypatch.setattr(transfer, "CHUNK_BYTES", 1008)


@pytest.mark.parametrize("depth", [1, 2, 4])
def test_card_branch_pipelines_pinned_slices(card, monkeypatch, depth):
    monkeypatch.setattr(transfer, "DEPTH", depth)
    rng = np.random.default_rng(depth)
    arrays = [_array(rng, (700, 3), np.int32), _array(rng, (90,), bool),
              _array(rng, (), np.float64)]
    eng = TransferEngine()
    out = eng.put_many(arrays, "cpu")
    for got, a in zip(out, arrays):
        assert torch.equal(got, torch.as_tensor(a))
    n = eng.stats.as_dict()["slices"]
    assert n == _windows([a.nbytes for a in arrays]) == 9
    log = _FakeEvent.LOG
    assert log[0] == ("wait_stream",)
    inflight = peak = 0
    for entry in log[1:]:
        inflight += 1 if entry[0] == "record" else -1
        assert inflight >= 0
        peak = max(peak, inflight)
    assert inflight == 0 and peak == min(depth, n)
    assert eng.stats.as_dict()["inflight_depth_high_water"] == peak


def test_staging_buffers_are_made_once_and_reused(card, monkeypatch):
    """Puts through one engine reuse its ring (no pinned allocation after
    the first, the same buffers); another depth makes a new ring."""
    eng = TransferEngine()
    rng = np.random.default_rng(5)
    for _ in range(3):
        a = _array(rng, (1500,), np.int64)
        assert torch.equal(eng.put(a, "cpu"), torch.as_tensor(a))
    assert len(_FakeRing.MADE) == 1
    assert eng._rings[torch.device("cpu", 0)] is _FakeRing.MADE[0]
    monkeypatch.setattr(transfer, "DEPTH", 3)
    a = np.arange(1000)
    assert torch.equal(eng.put(a, "cpu"), torch.as_tensor(a))
    assert len(_FakeRing.MADE) == 2 and len(_FakeRing.MADE[1].bufs) == 3
    assert torch.equal(eng.put(a, "cpu"), torch.as_tensor(a))
    assert len(_FakeRing.MADE) == 2


def test_concurrent_puts_through_the_shared_engine(card):
    """Job threads share the engine's staging buffers: their puts take
    turns, and each gets its own bytes back."""
    eng = TransferEngine()
    rng = np.random.default_rng(9)
    arrays = [_array(rng, (2000 + 37 * i,), np.int32) for i in range(8)]
    got = [None] * len(arrays)

    def put(i):
        got[i] = eng.put(arrays[i], "cpu")

    threads = [threading.Thread(target=put, args=(i,))
               for i in range(len(arrays))]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    for g, a in zip(got, arrays):
        assert torch.equal(g, torch.as_tensor(a))
    assert len(_FakeRing.MADE) == 1
    assert eng.stats.as_dict()["bytes_shipped"] == sum(
        resident.offsets16([a.nbytes])[1] for a in arrays)


def test_binned_tables_ship_through_the_engine():
    """``PartitionLayout.device_edges``' tables come out of the shared
    engine bitwise the host arrays, and its stats count their bytes."""
    rng = np.random.default_rng(0)
    n_pad, m = 256, 2000
    dst = np.sort(rng.integers(0, 200, m))
    src = rng.integers(0, 200, m)
    order = np.lexsort((src, dst))
    e_src = np.full(2048, n_pad - 1, np.int32)
    e_dst = np.full(2048, n_pad - 1, np.int32)
    e_src[:m], e_dst[:m] = src[order], dst[order]
    lay = partition.build_layout(e_src, e_dst, n_pad, m, 4)
    prior = shared_engine().stats.as_dict()
    be = lay.device_edges("cpu", reverse=True)
    d = shared_engine().stats.delta_since(prior)
    host = (lay.b_src, lay.b_dst, lay.valid, lay.slot, lay.u_src, lay.perm)
    for got, want in zip(lay.device_args("cpu"), host):
        assert got.dtype == torch.as_tensor(want).dtype
        assert torch.equal(got, torch.as_tensor(want))
    walks = lay.walk(False) + lay.walk(True)
    for got, want in zip((be.in_indptr, be.in_order, be.out_indptr,
                          be.out_order), walks):
        assert torch.equal(got, torch.as_tensor(want))
    assert d["bytes_shipped"] == resident.offsets16(
        [a.nbytes for a in host])[1] + resident.offsets16(
        [a.nbytes for a in walks])[1]
