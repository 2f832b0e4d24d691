"""Chunked, pipelined host-to-device transfers.

The port of ``raphtory_tpu/utils/transfer.py:124-434``. A put lays its
arrays end to end at 16-byte offsets (``ops/resident.offsets16``, the
layout of every staged upload in the port) in ONE device byte buffer, and
ships that buffer in windows of ``CHUNK_BYTES``, so that staging window
i+1 on the host overlaps the copy of window i. The outputs are views of the
buffer, bitwise ``torch.as_tensor(a).to(device)``.

On a card each window is staged in one of ``DEPTH`` pinned buffers that
the engine allocates once per card and reuses, then copied non-blocking
on the engine's copy stream; a CUDA event per buffer says when it may be
refilled, so at most ``DEPTH`` windows are in flight. The staging copy is
torch's ``copy_``, which runs on the intra-op threads (numpy's copy did
not scale over threads on the card's host). Every window has completed
when ``put_many`` returns. On the CPU the windows are plain copies into
the output.

Not ported: the reference's retry of transient transport failures (its
``UNAVAILABLE`` / ``DEADLINE_EXCEEDED`` markers come from a remote link; a
copy to a local card raises no such error, and a CUDA error raises at
once), ``device_put_chunked`` (no caller), and the fault-injection, tracer
and metrics hooks. They wait for the serving stack (ROADMAP queue 1 item
6).

``TransferEngine.stats`` (and ``shared_engine().stats``, the process's)
keep the bytes shipped, the windows, the seconds spent staging and waiting
on copies, and the high-water mark of windows in flight.
"""

from __future__ import annotations

import contextlib
import threading
import time
from dataclasses import dataclass, field

import numpy as np
import torch

from ..ops.resident import offsets16
from .device import resolve_device

#: bytes a window: the unit of staging and of one copy
CHUNK_BYTES = 32 << 20
#: windows in flight: the pinned staging buffers of a card
DEPTH = 2


def _on_card(dev: torch.device) -> bool:
    """Whether uploads to ``dev`` take the card's pipeline (pinned windows,
    non-blocking copies on the copy stream) or plain copies."""
    return dev.type == "cuda"


@dataclass
class TransferStats:
    """Cumulative telemetry of one engine (or the shared one). Every
    mutation goes through ``bump`` under the stats' own lock."""

    bytes_shipped: int = 0
    slices: int = 0
    stage_seconds: float = 0.0   # host copies into the staging buffers
    wire_seconds: float = 0.0    # waiting on an in-flight copy (a buffer
    #                              to refill, or the drain)
    depth_high_water: int = 0
    _mu: threading.Lock = field(default_factory=threading.Lock,
                                repr=False, compare=False)

    def bump(self, **deltas) -> None:
        """Add ``deltas`` to the counters; ``depth_high_water`` is a max."""
        with self._mu:
            for k, v in deltas.items():
                if k == "depth_high_water":
                    self.depth_high_water = max(self.depth_high_water, v)
                else:
                    setattr(self, k, getattr(self, k) + v)

    def as_dict(self) -> dict:
        with self._mu:
            return {
                "bytes_shipped": int(self.bytes_shipped),
                "slices": int(self.slices),
                "stage_stall_seconds": round(self.stage_seconds, 4),
                "wire_stall_seconds": round(self.wire_seconds, 4),
                "inflight_depth_high_water": int(self.depth_high_water),
            }

    def totals(self) -> dict:
        """Cumulative bytes shipped and stage + wire stall seconds — what
        the ``/slz`` series ring differences into per-interval rates."""
        with self._mu:
            return {
                "bytes_shipped": int(self.bytes_shipped),
                "stall_seconds": round(
                    self.stage_seconds + self.wire_seconds, 6),
            }

    def delta_since(self, prior: dict) -> dict:
        """What accumulated since a ``prior`` ``as_dict()`` snapshot (the
        high-water mark absolute)."""
        now = self.as_dict()
        out = {k: round(now[k] - prior.get(k, 0), 4)
               if isinstance(now[k], float) else now[k] - prior.get(k, 0)
               for k in now}
        out["inflight_depth_high_water"] = now["inflight_depth_high_water"]
        return out


class _Ring:
    """A card's staging: ``DEPTH`` pinned byte buffers of ``CHUNK_BYTES``,
    the copy stream, and each buffer's event (None: never used)."""

    def __init__(self, dev: torch.device):
        self.size = (DEPTH, CHUNK_BYTES)
        self.bufs = [torch.empty(CHUNK_BYTES, dtype=torch.uint8,
                                 pin_memory=True) for _ in range(DEPTH)]
        self.stream = torch.cuda.Stream(dev)
        self.events = [None] * DEPTH


def _fill(dst: np.ndarray, parts) -> None:
    """Copy ``parts`` (``(offset in dst, source bytes)``) into the byte
    array ``dst``, each by torch's threaded ``copy_``."""
    for at, src in parts:
        torch.from_numpy(dst[at: at + len(src)]).copy_(
            torch.from_numpy(src))


class TransferEngine:
    """Bounded-depth pipelined upload. One put at a time drives a card's
    staging buffers; concurrent puts through one engine wait their turn."""

    def __init__(self):
        #: windows in flight (``/statusz``'s ``transfer.depth``)
        self.depth = DEPTH
        self.stats = TransferStats()
        self._rings: dict = {}
        self._mu = threading.Lock()

    def _ring(self, dev: torch.device) -> _Ring:
        """The engine's staging on ``dev``, made at its first put (again
        if ``DEPTH`` or ``CHUNK_BYTES`` changed)."""
        if dev.index is None:
            dev = torch.device(dev.type, torch.cuda.current_device())
        ring = self._rings.get(dev)
        if ring is None or ring.size != (DEPTH, CHUNK_BYTES):
            ring = self._rings[dev] = _Ring(dev)
        return ring

    # ---- public API ----

    def put(self, a, device=None) -> torch.Tensor:
        """``a`` (numpy, a sequence or a host tensor) on ``device`` (None:
        the CUDA card), bitwise ``torch.as_tensor(a).to(device)``. A tensor
        already on the device passes through."""
        return self.put_many([a], device)[0]

    def put_many(self, arrays, device=None) -> list:
        """``arrays`` on ``device`` in one pipelined upload: laid end to end
        in one device buffer, so array k+1's staging overlaps array k's
        copy. Tensors already on the device pass through; order is kept."""
        dev = resolve_device(device)
        out, todo = list(arrays), []
        for i, a in enumerate(arrays):
            if isinstance(a, torch.Tensor):
                if a.device == dev:
                    continue
                a = a.cpu().numpy()
            a = np.asarray(a)
            todo.append((i, a if a.flags.c_contiguous else a.copy()))
        if not todo:
            return out
        offs, total = offsets16([a.nbytes for _, a in todo])
        data = torch.empty(total, dtype=torch.uint8, device=dev)
        self._pump([(off, a.reshape(-1).view(np.uint8))
                    for (_, a), off in zip(todo, offs) if a.nbytes],
                   data, total)
        for (i, a), off in zip(todo, offs):
            dt = torch.from_numpy(np.empty(0, a.dtype)).dtype
            out[i] = data[off: off + a.nbytes].view(dt).view(a.shape)
        return out

    def _pump(self, pieces, data: torch.Tensor, total: int) -> None:
        """Ship ``pieces`` (``(offset, source bytes)``, ascending) into
        ``data`` window by window: staged into the ring's next buffer once
        its last copy is done, then copied non-blocking (a card), or copied
        straight into ``data`` (the CPU)."""
        card = _on_card(data.device)
        with self._mu if card else contextlib.nullcontext():
            ring = self._ring(data.device) if card else None
            if card:
                # ``data`` was allocated on the current stream: the copies
                # may not start before its earlier work on that memory
                ring.stream.wait_stream(
                    torch.cuda.current_stream(data.device))
            host = None if card else data.numpy()
            first = 0
            try:
                for k, w0 in enumerate(range(0, total, CHUNK_BYTES)):
                    w1 = min(w0 + CHUNK_BYTES, total)
                    while first < len(pieces) and \
                            pieces[first][0] + len(pieces[first][1]) <= w0:
                        first += 1
                    parts = []
                    for off, src in pieces[first:]:
                        if off >= w1:
                            break
                        lo, hi = max(off, w0), min(off + len(src), w1)
                        parts.append((lo - w0, src[lo - off: hi - off]))
                    if not card:
                        t0 = time.perf_counter()
                        _fill(host[w0:w1], parts)
                        self.stats.bump(
                            slices=1, bytes_shipped=w1 - w0,
                            stage_seconds=time.perf_counter() - t0,
                            depth_high_water=1)
                        continue
                    slot = k % len(ring.bufs)
                    self._wait(ring, slot)
                    t0 = time.perf_counter()
                    _fill(ring.bufs[slot].numpy(), parts)
                    self.stats.bump(stage_seconds=time.perf_counter() - t0)
                    ring.events[slot] = self._copy(
                        data[w0:w1], ring.bufs[slot][: w1 - w0], ring.stream)
                    self.stats.bump(
                        slices=1, bytes_shipped=w1 - w0,
                        depth_high_water=sum(e is not None
                                             for e in ring.events))
            finally:
                for slot in range(len(ring.bufs) if card else 0):
                    self._wait(ring, slot)

    def _wait(self, ring: _Ring, slot: int) -> None:
        """Wait for the copy out of buffer ``slot`` (if one is in flight)."""
        ev = ring.events[slot]
        if ev is None:
            return
        t0 = time.perf_counter()
        ev.synchronize()
        ring.events[slot] = None
        self.stats.bump(wire_seconds=time.perf_counter() - t0)

    @staticmethod
    def _copy(dst: torch.Tensor, staged: torch.Tensor, stream):
        """One window's copy, non-blocking on ``stream`` from its pinned
        buffer; returns the event that marks it done."""
        with torch.cuda.stream(stream):
            dst.copy_(staged, non_blocking=True)
            ev = torch.cuda.Event()
            ev.record(stream)
        return ev


_SHARED: TransferEngine | None = None
_SHARED_LOCK = threading.Lock()


def shared_engine() -> TransferEngine:
    """The process-wide engine: one stats bundle, one set of staging
    buffers a card."""
    global _SHARED
    if _SHARED is None:
        with _SHARED_LOCK:
            if _SHARED is None:
                _SHARED = TransferEngine()
    return _SHARED
