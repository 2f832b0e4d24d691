"""Deterministic failpoints, armed via ``RTPU_FAULTS``.

Spec grammar (comma-separated entries)::

    site=mode:prob[:count][:seed]

    RTPU_FAULTS="transfer.wire=error:0.1:3:42,peer.scrape=hang:1.0"

* ``site`` — one of :data:`SITES` (unknown names log a warning and are
  skipped: an operator typo is data, never a crash).
* ``mode`` — ``error`` raises :class:`FaultError` (classified transient
  by every retry loop: the message carries ``UNAVAILABLE``), ``hang``
  sleeps ``RTPU_FAULT_HANG_S`` (bounded — a CI chaos run must never
  wedge forever), ``slow`` sleeps ``RTPU_FAULT_SLOW_S``.
* ``prob`` — per-pass injection probability in [0, 1].
* ``count`` — max injections (empty/omitted = unlimited).
* ``seed`` — RNG seed; omitted derives a stable one from the site name,
  so the SAME spec replays the SAME injection sequence, run after run.

The disarmed fast path is one module-global bool load — production with
``RTPU_FAULTS`` unset pays ~ns per check. ``RTPU_RESIL=0`` is the kill
switch: the plane stays disarmed even with a spec set (the bench's A/B
off arm). Armed state is parsed once at import; tests and the chaos
bench re-arm explicitly via :func:`arm` / :func:`disarm`.
"""

from __future__ import annotations

import logging
import os
import random
import threading
import time
import zlib

_log = logging.getLogger("raphtory_tpu_torch.resilience")

SITES = (
    "transfer.wire",      # utils/transfer.py — the device_put wire
    "device.dispatch",    # engine/device_sweep.py — compiled-program run
    "peer.scrape",        # obs/cluster.py — /clusterz federation fetch
    "ingest.sink",        # ingestion/router.py — shard delivery
    "watermark.advance",  # ingestion/watermark.py — fence advance
    "sched.dispatch",     # jobs/scheduler.py — coalesced batch dispatch
    "rest.handler",       # jobs/rest.py — request handler entry
)

MODES = ("error", "hang", "slow")


class FaultError(RuntimeError):
    """An injected failure. The message carries ``UNAVAILABLE`` so every
    classifier in the repo (transfer's ``_is_transient``, the shared
    :class:`~raphtory_tpu_torch.resilience.policy.RetryPolicy`) files it
    transient — injected faults exercise the retry path, they don't
    masquerade as programming errors."""


def hang_s() -> float:
    """``RTPU_FAULT_HANG_S`` — bounded sleep for ``hang`` injections."""
    try:
        return float(os.environ.get("RTPU_FAULT_HANG_S", "") or 30.0)
    except ValueError:
        return 30.0


def slow_s() -> float:
    """``RTPU_FAULT_SLOW_S`` — sleep for ``slow`` injections."""
    try:
        return float(os.environ.get("RTPU_FAULT_SLOW_S", "") or 0.1)
    except ValueError:
        return 0.1


class _Failpoint:
    __slots__ = ("site", "mode", "prob", "count", "seed", "rng",
                 "injected", "passes")

    def __init__(self, site: str, mode: str, prob: float,
                 count: int | None, seed: int):
        self.site = site
        self.mode = mode
        self.prob = prob
        self.count = count          # None = unlimited
        self.seed = seed
        self.rng = random.Random(seed)
        self.injected = 0
        self.passes = 0

    def snapshot(self) -> dict:
        return {"mode": self.mode, "prob": self.prob, "count": self.count,
                "seed": self.seed, "passes": self.passes,
                "injected": self.injected,
                "exhausted": (self.count is not None
                              and self.injected >= self.count)}


_MU = threading.Lock()
_ARMED: dict[str, _Failpoint] = {}
_SPEC = ""
_ACTIVE = False     # the disarmed fast path reads ONLY this


def _derived_seed(site: str) -> int:
    # stable across processes and runs — hash() is salted, crc32 is not
    return zlib.crc32(site.encode())


def _parse(spec: str) -> dict[str, _Failpoint]:
    armed: dict[str, _Failpoint] = {}
    for entry in spec.split(","):
        entry = entry.strip()
        if not entry:
            continue
        try:
            site, rest = entry.split("=", 1)
            site = site.strip()
            parts = rest.split(":")
            mode = parts[0].strip()
            prob = float(parts[1])
            count = int(parts[2]) if len(parts) > 2 and parts[2] else None
            seed = (int(parts[3]) if len(parts) > 3 and parts[3]
                    else _derived_seed(site))
        except (ValueError, IndexError) as e:
            _log.warning("RTPU_FAULTS: malformed entry %r skipped (%s)",
                         entry, e)
            continue
        if site not in SITES:
            _log.warning("RTPU_FAULTS: unknown site %r skipped; sites=%s",
                         site, ",".join(SITES))
            continue
        if mode not in MODES:
            _log.warning("RTPU_FAULTS: unknown mode %r for %s skipped; "
                         "modes=%s", mode, site, ",".join(MODES))
            continue
        if not 0.0 <= prob <= 1.0:
            _log.warning("RTPU_FAULTS: prob %r for %s outside [0,1], "
                         "skipped", prob, site)
            continue
        armed[site] = _Failpoint(site, mode, prob, count, seed)
    return armed


def _resil_enabled() -> bool:
    """``RTPU_RESIL`` — the plane-wide kill switch (``0`` keeps every
    failpoint disarmed even when ``RTPU_FAULTS`` is set)."""
    return os.environ.get("RTPU_RESIL", "1") != "0"


def arm(spec: str | None = None) -> dict:
    """(Re)arm from ``spec`` (default: the ``RTPU_FAULTS`` env var).
    Returns the armed-sites snapshot. Tests and the chaos bench call
    this directly; production arms once at import."""
    global _ARMED, _SPEC, _ACTIVE
    if spec is None:
        spec = os.environ.get("RTPU_FAULTS", "")
    with _MU:
        _SPEC = spec
        _ARMED = _parse(spec) if (spec and _resil_enabled()) else {}
        _ACTIVE = bool(_ARMED)
        return {s: fp.snapshot() for s, fp in _ARMED.items()}


def disarm() -> None:
    """Drop every armed failpoint (the disarmed fast path returns)."""
    global _ARMED, _SPEC, _ACTIVE
    with _MU:
        _ARMED = {}
        _SPEC = ""
        _ACTIVE = False


def _instant(name: str, **attrs) -> None:
    try:
        from ..obs.trace import TRACER

        TRACER.instant(name, **attrs)
    except Exception:   # telemetry must never become a second fault
        pass


def _journal_emit(kind: str, data: dict) -> None:
    try:
        from ..obs import journal

        if journal.enabled():
            journal.emit(kind, data)
    except Exception:   # durability must never become a second fault
        pass


def fire(site: str) -> None:
    """The failpoint check. Disarmed: one global load, returns. Armed:
    roll the site's seeded RNG; inject by raising / sleeping."""
    if not _ACTIVE:
        return
    with _MU:
        fp = _ARMED.get(site)
        if fp is None:
            return
        fp.passes += 1
        if fp.count is not None and fp.injected >= fp.count:
            return
        if fp.rng.random() >= fp.prob:
            return
        fp.injected += 1
        n, mode = fp.injected, fp.mode
    # the injection itself happens OUTSIDE the registry lock: a hang
    # must stall the caller, not every other failpoint in the process
    _instant("fault.inject", site=site, mode=mode, n=n)
    _journal_emit("fault", {"site": site, "mode": mode, "n": n})
    if mode == "error":
        raise FaultError(f"UNAVAILABLE: injected fault at {site} (#{n})")
    time.sleep(hang_s() if mode == "hang" else slow_s())


def faultz() -> dict:
    """The ``/faultz`` document: armed sites with injection counts,
    breaker states, degraded-results ledger."""
    with _MU:
        sites = {s: fp.snapshot() for s, fp in _ARMED.items()}
        doc = {"enabled": _ACTIVE, "spec": _SPEC, "sites": sites}
    try:
        from .breaker import BREAKERS

        doc["breakers"] = BREAKERS.snapshot()
    except Exception:
        doc["breakers"] = {}
    try:
        from .degrade import DEGRADED

        doc["degraded"] = DEGRADED.snapshot()
    except Exception:
        doc["degraded"] = {}
    return doc


arm()

_fault_dump = os.environ.get("RTPU_FAULT_DUMP")
if _fault_dump:
    import json as _json

    from ..obs import exitdump as _exitdump

    def _dump_faultz(path=_fault_dump):
        with open(path, "w") as f:
            _json.dump(faultz(), f, indent=1)

    _exitdump.register("fault", _dump_faultz)
