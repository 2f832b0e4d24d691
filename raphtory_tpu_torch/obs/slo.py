"""SLO latency histograms with trace exemplars + a bounded series ring.

Two gaps this module closes for serving:

* **"p99 is bad — WHICH request?"** Aggregate histograms prove a tail
  exists but can't name a culprit. Each per-(algorithm, phase) latency
  histogram here keeps one **trace-ID exemplar per bucket** — the last
  request that landed there — so the p99 bucket resolves to an actual
  end-to-end trace at ``/tracez?trace_id=…`` (obs/trace.py). This is the
  Canopy workflow: sampled per-request traces joined to the aggregate
  that flagged them.
* **"/statusz is a point-in-time snapshot."** Saturation is a shape over
  time (queue depth climbing while throughput flattens), invisible at
  scrape instants. The ``SeriesRing`` samples a small signal set (queue
  depth, in-flight jobs, fold-cache bytes, H2D stall seconds) every
  interval into a bounded ring, surfaced at ``/slz`` as JSON plus text
  sparklines.

Everything is stdlib-only; observations mirror into the Prometheus
``raphtory_request_seconds{algorithm,phase}`` histogram when
``obs.metrics`` is importable.

Knobs
-----
* ``RTPU_SLO`` — per-request SLO observation (default on; the
  ``telemetry_overhead`` bench's off arm).
* ``RTPU_SLO_BUCKETS`` — comma-separated upper bounds in seconds.
* ``RTPU_SERIES_RING`` — series-ring capacity in samples (default 512).
* ``RTPU_SERIES_DUMP`` — file path; implies the ring sampler on, rows
  written there at interpreter exit (the CI failure-artifact hook).
"""

from __future__ import annotations

import bisect
import json
import os
import threading
import time
import weakref
from collections import deque

from . import journal as _journal

#: Canopy-style default grid: sub-10ms cache hits through multi-minute
#: cold scale sweeps, denser where SLOs actually get set
DEFAULT_BUCKETS = (0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5,
                   1.0, 2.5, 5.0, 10.0, 30.0, 120.0)
DEFAULT_RING = 512
#: (algorithm, phase) key cap — the REST surface must not be able to grow
#: the histogram table without bound (rtpulint RT011); the registry names
#: a few dozen programs, so 256 keys is generous
MAX_KEYS = 256
_SPARK = "▁▂▃▄▅▆▇█"


def enabled() -> bool:
    """Re-read per observation so the A/B bench (and operators) can flip
    it without a process restart — one getenv per completed request."""
    return os.environ.get("RTPU_SLO", "1") not in ("", "0", "false")


def slo_buckets() -> tuple:
    """Histogram upper bounds (seconds), ascending. ``RTPU_SLO_BUCKETS``
    is a comma-separated override; unparseable values fall back to the
    default grid (telemetry must never take a process down)."""
    raw = os.environ.get("RTPU_SLO_BUCKETS", "")
    if raw:
        try:
            bounds = tuple(sorted(float(x) for x in raw.split(",") if x))
            if bounds and all(b > 0 for b in bounds):
                return bounds
        except ValueError:
            pass
    return DEFAULT_BUCKETS


class _Hist:
    """One (algorithm, phase) histogram: per-bucket counts plus one
    trace-ID exemplar per bucket (the LAST request that landed there —
    recency beats reservoir sampling for debugging: the exemplar must
    still be in the flight-recorder ring to resolve)."""

    __slots__ = ("bounds", "counts", "count", "sum_seconds", "exemplars")

    def __init__(self, bounds: tuple):
        self.bounds = bounds
        self.counts = [0] * (len(bounds) + 1)   # +1: overflow bucket
        self.count = 0
        self.sum_seconds = 0.0
        self.exemplars: list = [None] * (len(bounds) + 1)

    def observe(self, seconds: float, trace_id: str | None,
                unix: float) -> None:
        i = bisect.bisect_left(self.bounds, seconds)
        self.counts[i] += 1
        self.count += 1
        self.sum_seconds += seconds
        if trace_id:
            self.exemplars[i] = {"trace_id": trace_id,
                                 "seconds": round(seconds, 6),
                                 "unix": round(unix, 3)}

    def quantile(self, q: float) -> float:
        """Upper bound of the bucket holding the q-quantile (the standard
        Prometheus-style estimate; the overflow bucket reports the last
        finite bound). 0.0 when empty. Shares ``quantile_bucket`` so the
        reported p99 and the p99 exemplar can never name different
        buckets."""
        if not self.count:
            return 0.0
        return self.bounds[min(self.quantile_bucket(q),
                               len(self.bounds) - 1)]

    def quantile_bucket(self, q: float) -> int:
        if not self.count:
            return 0
        need = q * self.count
        cum = 0
        for i, c in enumerate(self.counts):
            cum += c
            if cum >= need:
                return i
        return len(self.counts) - 1

    def exemplar_near(self, q: float):
        """The exemplar of the q-quantile's bucket, walking DOWN to the
        nearest populated one when that bucket's observations all lacked
        trace ids (tracing off for those requests)."""
        for i in range(self.quantile_bucket(q), -1, -1):
            if self.exemplars[i] is not None:
                return self.exemplars[i]
        return None

    def as_dict(self) -> dict:
        return {
            "count": self.count,
            "sum_seconds": round(self.sum_seconds, 6),
            "buckets": list(self.bounds),
            "counts": list(self.counts),
            "p50": self.quantile(0.50),
            "p90": self.quantile(0.90),
            "p99": self.quantile(0.99),
            "exemplars": list(self.exemplars),
            "p99_exemplar": self.exemplar_near(0.99),
        }


def _metrics():
    """obs.metrics bundle, or None when prometheus isn't importable."""
    try:
        from .metrics import METRICS

        return METRICS
    except Exception:
        return None


class SLORegistry:
    """Process-wide per-(algorithm, phase) latency histograms. All
    mutation under one lock (observations come from every job thread);
    bucket bounds are pinned at first observation so an env flip mid-run
    can't tear a histogram."""

    def __init__(self):
        self._lock = threading.Lock()
        self._hists: dict[tuple, _Hist] = {}
        self.dropped_keys = 0

    def observe(self, algorithm: str, phase: str, seconds: float,
                trace_id: str | None = None) -> None:
        if not enabled():
            return
        seconds = float(seconds)
        key = (str(algorithm), str(phase))
        now = time.time()
        with self._lock:
            h = self._hists.get(key)
            if h is None:
                if len(self._hists) >= MAX_KEYS:
                    self.dropped_keys += 1
                    return
                h = self._hists[key] = _Hist(slo_buckets())
            h.observe(seconds, trace_id, now)
        m = _metrics()
        if m is not None:
            m.request_seconds.labels(algorithm, phase).observe(seconds)

    def exemplar(self, algorithm: str, phase: str = "e2e",
                 q: float = 0.99):
        with self._lock:
            h = self._hists.get((str(algorithm), str(phase)))
            return h.exemplar_near(q) if h is not None else None

    def totals_below(self, algorithm: str, phase: str,
                     threshold_s: float) -> tuple[int, int]:
        """``(total, good)`` observation counts for ``algorithm``/
        ``phase`` where *good* counts observations in buckets whose
        upper bound is ≤ ``threshold_s`` — the error-budget numerator
        (obs/budget.py). Algorithm matching is case-insensitive (targets
        are operator-typed env strings; ledger algorithm labels are
        class names). A threshold between bucket bounds counts its
        bucket as BAD — conservative, and exact when targets align with
        the (configurable) ``RTPU_SLO_BUCKETS`` grid."""
        alg = str(algorithm).lower()
        ph = str(phase)
        total = good = 0
        with self._lock:
            for (a, p), h in self._hists.items():
                if p != ph or a.lower() != alg:
                    continue
                total += h.count
                for i, bound in enumerate(h.bounds):
                    if bound <= threshold_s:
                        good += h.counts[i]
        return total, good

    def as_dict(self) -> dict:
        with self._lock:
            hists = {f"{alg}/{ph}": h.as_dict()
                     for (alg, ph), h in sorted(self._hists.items())}
            dropped = self.dropped_keys
        return {"enabled": enabled(), "histograms": hists,
                "dropped_keys": dropped}

    def clear(self) -> None:
        with self._lock:
            self._hists.clear()
            self.dropped_keys = 0


SLO = SLORegistry()


def _fold_cache_bytes() -> float:
    from ..core.sweep import fold_cache

    cache = fold_cache()
    return float(cache.stats()["bytes"]) if cache is not None else 0.0


def _h2d_totals() -> dict:
    from ..utils.transfer import shared_engine

    return shared_engine().stats.totals()


def _device_bytes_in_use() -> float:
    """Device-memory occupancy collector (obs/device.py): raises on
    backends without memory counters so the sample records None — the
    ring's failing-collector contract, the thread never dies."""
    from .device import series_bytes_in_use

    return series_bytes_in_use()


def _device_resident_bytes() -> float:
    from .device import RESIDENT

    return float(RESIDENT.snapshot()["total_bytes"])


def _ingest_events_total() -> float:
    """Freshness-plane collector (obs/freshness.py): cumulative ingested
    events — the ring's ``_total`` differencing renders updates/s."""
    from .freshness import FRESH

    return FRESH.total_events()


def _ingest_backlog_events() -> float:
    from .freshness import FRESH

    return FRESH.backlog_events()


def _queryable_lag_seconds() -> float:
    from .freshness import FRESH

    return FRESH.queryable_lag_seconds()


def sparkline(values: list[float]) -> str:
    """Text sparkline over ``values`` (min..max scaled to 8 levels);
    constant series render flat-low."""
    vals = [float(v) for v in values]
    if not vals:
        return ""
    lo, hi = min(vals), max(vals)
    if hi <= lo:
        return _SPARK[0] * len(vals)
    return "".join(_SPARK[int((v - lo) / (hi - lo) * (len(_SPARK) - 1))]
                   for v in vals)


class SeriesRing:
    """Bounded ring of periodic samples over registered collectors —
    saturation as a SHAPE over time, not a scrape instant.

    Collectors are zero-arg callables returning a float; a failing
    collector contributes None for that sample (telemetry never takes
    the server down). Cumulative signals use a ``_total`` suffix — the
    sparkline/rate surfaces difference them per interval."""

    def __init__(self, ring: int | None = None, interval: float = 1.0):
        if ring is None:
            try:
                ring = int(os.environ.get("RTPU_SERIES_RING", DEFAULT_RING))
            except ValueError:
                ring = DEFAULT_RING
        self.interval = float(interval)
        self._rows: deque = deque(maxlen=max(16, int(ring)))
        self._lock = threading.Lock()   # collectors map + thread lifecycle
        self._collectors: dict[str, object] = {}
        self._thread: threading.Thread | None = None
        # per-GENERATION stop event, replaced on every start — see
        # obs/sampler.py: a stop racing a concurrent start must only
        # affect the generation it swapped out
        self._stop = threading.Event()
        self.samples = 0
        # process-wide signals every deployment has; job-table signals
        # join via attach_manager
        self.register("fold_cache_bytes", _fold_cache_bytes)
        self.register("h2d_stall_seconds_total",
                      lambda: _h2d_totals()["stall_seconds"])
        self.register("h2d_bytes_total",
                      lambda: float(_h2d_totals()["bytes_shipped"]))
        # device runtime plane (obs/device.py): live memory occupancy
        # (None on backends without memory_stats — this CPU rig) and
        # the resident-buffer registry's total
        self.register("device_bytes_in_use", _device_bytes_in_use)
        self.register("device_resident_bytes", _device_resident_bytes)
        # freshness plane (obs/freshness.py): ingested events (the
        # ``_total`` differencing renders updates/s), the staged
        # parse→append backlog, and the age of the oldest batch the
        # safe-time fence has not yet covered
        self.register("ingest_events_total", _ingest_events_total)
        self.register("ingest_backlog_events", _ingest_backlog_events)
        self.register("queryable_lag_seconds", _queryable_lag_seconds)

    # ---- collectors ----

    def register(self, name: str, fn) -> None:
        with self._lock:
            self._collectors[str(name)] = fn

    def unregister(self, name: str) -> None:
        """Drop a collector (unknown names are a no-op) — how the
        error-budget registry retires a retargeted algorithm's
        collectors instead of leaving dead histogram walks sampling at
        1 Hz forever (obs/budget.py)."""
        with self._lock:
            self._collectors.pop(str(name), None)

    def attach_manager(self, manager) -> None:
        """Register job-table collectors for ``manager`` (weakly — the
        ring is process-wide and must not pin a dead manager): in-flight
        jobs and queue depth. Today queue depth counts submitted-but-not-
        yet-running jobs (thread-spawn latency); the admission-control
        scheduler will put real queueing behind the same signal."""
        ref = weakref.ref(manager)

        def _count(statuses):
            mgr = ref()
            if mgr is None:
                return 0.0
            return float(sum(1 for s in mgr.jobs().values()
                             if s in statuses))

        self.register("jobs_in_flight", lambda: _count(("running",)))
        self.register("jobs_queued", lambda: _count(("pending",)))
        # serving-scheduler signals (jobs/scheduler.py): collect-window
        # queue depth + ledger-priced admitted backlog — the saturation
        # shape a coalescing storm is diagnosed with at /slz
        sched = getattr(manager, "scheduler", None)
        if sched is not None:
            sref = weakref.ref(sched)

            def _sched_depth():
                s = sref()
                return float(s.queue_depth()) if s is not None else 0.0

            def _sched_backlog():
                s = sref()
                return (float(s.backlog_seconds())
                        if s is not None else 0.0)

            self.register("scheduler_queue_depth", _sched_depth)
            self.register("scheduler_backlog_seconds", _sched_backlog)

    # ---- sampling ----

    def sample_once(self) -> dict:
        with self._lock:
            collectors = list(self._collectors.items())
        row: dict = {"unix": round(time.time(), 3)}
        for name, fn in collectors:   # outside the lock: a collector may
            try:                      # take its own (manager/cache) locks
                row[name] = float(fn())
            except Exception:
                row[name] = None
        self._rows.append(row)
        self.samples += 1
        # durable mirror (obs/journal.py): the 1 Hz saturation series is
        # exactly the shape a postmortem wants around a death
        if _journal.enabled():
            _journal.emit("series", row)
        return row

    def _loop(self, stop: threading.Event) -> None:
        while not stop.wait(self.interval):
            self.sample_once()

    def start(self, interval: float | None = None) -> "SeriesRing":
        """Start the background sampler (idempotent)."""
        with self._lock:
            if interval is not None:
                self.interval = float(interval)
            if self._thread is not None and self._thread.is_alive():
                return self
            self._stop = stop = threading.Event()
            self._thread = threading.Thread(
                target=self._loop, args=(stop,),
                name="series-sampler", daemon=True)
            self._thread.start()
        return self

    def stop(self) -> None:
        with self._lock:
            t, self._thread = self._thread, None
            self._stop.set()   # this generation's event, under the lock
        if t is not None:
            t.join(timeout=5.0)

    @property
    def running(self) -> bool:
        t = self._thread
        return t is not None and t.is_alive()

    # ---- export ----

    def rows(self) -> list[dict]:
        return list(self._rows)

    def _series(self, rows: list[dict], name: str) -> list[float]:
        vals = [r.get(name) for r in rows]
        if name.endswith("_total"):
            # cumulative → per-interval deltas; a boundary touching a
            # failed sample (None) is DROPPED, never merged — filtering
            # Nones first would difference across the gap and render two
            # intervals' growth as one 2x "spike" in the sparkline
            return [b - a for a, b in zip(vals, vals[1:])
                    if a is not None and b is not None]
        return [v for v in vals if v is not None]

    def as_dict(self, last: int = 120) -> dict:
        rows = self.rows()
        names = sorted({k for r in rows for k in r} - {"unix"})
        window = rows[-max(1, int(last)):]
        return {
            "running": self.running,
            "interval_seconds": self.interval,
            "ring": self._rows.maxlen,
            "samples": self.samples,
            "signals": names,
            "rows": window,
            "sparklines": {n: sparkline(self._series(window, n))
                           for n in names},
        }

    def clear(self) -> None:
        self._rows.clear()
        self.samples = 0


SERIES = SeriesRing()


def slz_payload(series_last: int = 120) -> dict:
    """The ``/slz`` document: SLO histograms + exemplars + the series
    ring — everything needed to go from "p99 moved" to a trace id."""
    return {"slo": SLO.as_dict(), "series": SERIES.as_dict(series_last)}


_series_dump = os.environ.get("RTPU_SERIES_DUMP")
if _series_dump:
    from . import exitdump as _exitdump

    SERIES.start()

    def _dump_series(path=_series_dump):
        with open(path, "w") as f:
            json.dump({"interval_seconds": SERIES.interval,
                       "samples": SERIES.samples,
                       "rows": SERIES.rows()}, f)

    _exitdump.register("series", _dump_series)
