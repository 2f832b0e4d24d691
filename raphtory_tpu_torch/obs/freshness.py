"""Freshness plane — how fresh is what we serve?

The serving side has a full SLO stack (latency histograms
with trace exemplars, error budgets, burn-rate grading); the ingest/live
side — the half the paper's "live temporal graph" identity rests on —
had two span instants and one watermark-lag gauge. This module is the
streaming mirror of ``obs/slo.py`` + ``obs/budget.py``:

* **Per-source ingest telemetry.** Every pipeline sink batch reports
  updates/s, batch sizes, op-type/tombstone mix, and an
  **out-of-orderness histogram**: the event-time distance each event
  arrived behind its source's high-water mark. The commutative
  bitemporal store makes disorder *safe*; this makes it *visible* — and
  an observed distance past the source's declared ``disorder`` bound is
  a watermark-promise violation the ``out-of-order-excess`` advisor
  rule alarms on.
* **Ingest-to-queryable latency.** Each sink batch is wall-stamped at
  arrival and becomes *queryable* when the global safe time passes its
  max event time (that is when ``view_at(T, exact=True)`` unblocks for
  it) — per-source "event at T became queryable at wall W" histograms
  whose buckets carry trace-ID exemplars (the SLO machinery,
  ``obs/slo._Hist``), drained by ``WatermarkRegistry`` on every fence
  advance.
* **Live-query staleness.** Every Live job run records its
  ``result_watermark`` against the ingest head into per-algorithm
  staleness-seconds histograms (a bounded head clock maps event-time
  heads to wall time). ``RTPU_FRESH_TARGET`` (``pagerank=p99:5s``)
  judges them through the ``obs/budget.py`` multi-window burn-rate
  machinery and grades ``/healthz``.
* **Surfaces.** ``/freshz`` (full document, ``RTPU_FRESH_DUMP`` CI
  artifact), a compact ``/statusz`` block, ``/slz`` series collectors
  (updates/s, queryable lag, backlog), ``raphtory_ingest_*`` /
  ``raphtory_freshness_*`` metrics, and ``/clusterz`` federation with a
  merged min-watermark + per-process watermark spread.

Everything follows the telemetry prime directive: no call here may
raise into the ingest hot path, all state is bounded (RT011), and
``RTPU_FRESH=0`` silences observation entirely (the
``ingest_obs_overhead`` bench's off arm).

Knobs
-----
* ``RTPU_FRESH`` — the whole plane's observation (default on).
* ``RTPU_FRESH_TARGET`` — staleness targets ``<algorithm>=p<Q>:<lat>``.
* ``RTPU_FRESH_PENDING`` — per-source pending-batch record cap.
* ``RTPU_FRESH_DUMP`` — file path; ``/freshz`` dumped at exit.
* ``RTPU_INGEST_OOO_BUCKETS`` — out-of-orderness histogram bounds
  (event-time units, comma-separated).
"""

from __future__ import annotations

import json
import os
import threading
import time
import weakref
from collections import deque

from ..analysis.sanitizer import (note_shared as _san_note,
                                  track_shared as _san_track)
from . import journal as _journal
from .slo import _Hist, _metrics
from .trace import TRACER

#: ingest→queryable / staleness histogram grid (seconds): live analytics
#: SLOs live in the sub-second..minutes band
DEFAULT_SECONDS_BUCKETS = (0.01, 0.05, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0,
                           10.0, 30.0, 60.0, 300.0)
#: out-of-orderness bounds in EVENT-TIME units (domain-specific; the
#: knob overrides). Bucket i counts distances in (bounds[i-1], bounds[i]].
DEFAULT_OOO_BOUNDS = (1, 10, 100, 1_000, 10_000, 100_000, 1_000_000)
DEFAULT_PENDING = 4096
#: registry caps (RT011): a misbehaving deployment must not mint
#: unbounded per-source/per-algorithm state through the ingest surface
MAX_SOURCES = 256
MAX_ALGOS = 64
#: live-subscription table cap (RT011): one row per live job, keyed by
#: job id — a runaway submitter must not mint unbounded registry state
MAX_LIVE_SUBS = 64
#: per-subscription ring of recent epochs (mode, delta rows, shipped
#: bytes, staleness) — the /freshz epoch SERIES, bounded per sub
MAX_LIVE_RECENT = 128
#: head-clock ring: (event_time_head, wall) pairs, ~1 per sink batch
HEAD_RING = 4096
#: per-source batch-arrival ring for the updates/s window
RATE_RING = 512
RATE_WINDOW_S = 10.0
#: per-event pass sampling: batches at or past DEEP_EXACT_N events pay
#: the O(n) accounting passes (op-mix bincount + out-of-orderness
#: check) only 1 in DEEP_SAMPLE batches — on a multi-M-updates/s
#: columnar stream those two passes ARE the plane's cost, and both
#: signals are fractions/distributions a deterministic batch sample
#: estimates without bias (the RTPU_DEVICE_TIMING rationale). Smaller
#: (row-path) batches are counted exactly. Event totals, batch sizes,
#: high-water marks, pending queryable records and the head clock stay
#: EXACT on every batch — only the mix and the disorder distribution
#: are sampled, and their coverage counters ride on /freshz.
DEEP_EXACT_N = 1024
DEEP_SAMPLE = 4
_NEG_INF = -(2**62)
_GRADE_ORDER = {"ok": 0, "degraded": 1, "burning": 2}
#: live-evaluation cache TTL (obs/budget.py rationale: /healthz probes,
#: /statusz scrapes and advisor ticks share one pass per second)
EVAL_CACHE_S = 1.0


def enabled() -> bool:
    """Re-read per observation so the A/B bench (and operators) can
    flip the plane without a restart — one getenv per sink BATCH, not
    per event."""
    return os.environ.get("RTPU_FRESH", "1") not in ("", "0", "false")


def pending_cap() -> int:
    try:
        v = int(os.environ.get("RTPU_FRESH_PENDING", "") or DEFAULT_PENDING)
        return max(16, v)
    except ValueError:
        return DEFAULT_PENDING


def ooo_bounds() -> tuple:
    """Out-of-orderness histogram upper bounds (event-time units),
    ascending; unparseable overrides fall back to the default grid
    (telemetry must never take ingest down)."""
    raw = os.environ.get("RTPU_INGEST_OOO_BUCKETS", "")
    if raw:
        try:
            bounds = tuple(sorted(int(float(x)) for x in raw.split(",")
                                  if x))
            if bounds and all(b > 0 for b in bounds):
                return bounds
        except ValueError:
            pass
    return DEFAULT_OOO_BOUNDS


#: event-kind display order (core/events.py constants 0..3)
_KIND_NAMES = ("vertex_add", "vertex_delete", "edge_add", "edge_delete")
_TOMBSTONE_KINDS = (1, 3)   # VERTEX_DELETE, EDGE_DELETE


class _SourceStats:
    """One ingest source's telemetry (mutated under the registry lock)."""

    __slots__ = ("name", "disorder", "stage", "events", "batches",
                 "large_batches", "batch_events_max", "kinds",
                 "kinds_events", "ooo_counts", "ooo_events",
                 "ooo_events_seen", "ooo_max", "max_t", "queryable",
                 "pending", "pending_dropped", "recent", "prom")

    def __init__(self, name: str, disorder: int, stage: str):
        self.name = name
        self.disorder = int(disorder)
        self.stage = stage
        self.events = 0
        self.batches = 0
        # counter of DEEP_EXACT_N-sized batches ONLY — the 1-in-
        # DEEP_SAMPLE decision keys on it, so a stream mixing small and
        # large batches still deep-samples exactly 1 in 4 of its LARGE
        # batches (keying on the global batch counter would let the
        # small batches alias the phase and over/under-sample the large
        # half arbitrarily)
        self.large_batches = 0
        self.batch_events_max = 0
        # op-mix + out-of-orderness counts over DEEP-SAMPLED events
        # (see DEEP_EXACT_N/DEEP_SAMPLE): kinds_events / ooo_events_seen
        # record the coverage so the fractions stay exact ratios of
        # what was actually counted
        self.kinds = [0, 0, 0, 0]
        self.kinds_events = 0            # events the mix counts cover
        self.ooo_events_seen = 0         # events the ooo pass covered
        self.ooo_counts = [0] * (len(ooo_bounds()) + 1)
        self.ooo_events = 0
        self.ooo_max = 0
        self.max_t = _NEG_INF            # source event-time high water
        # cached per-source Prometheus children — .labels() costs a
        # registry lock + dict walk per call, too much for the per-batch
        # hot path; None until the first mirror (or forever, without
        # prometheus)
        self.prom: tuple | None = None
        self.queryable = _Hist(DEFAULT_SECONDS_BUCKETS)
        # (batch max event time, arrival wall, trace_id) — queryable
        # once the global safe time passes the max event time
        self.pending: deque = deque()
        self.pending_dropped = 0
        self.recent: deque = deque(maxlen=RATE_RING)   # (wall, n_events)

    def updates_per_s(self, now: float) -> float:
        n = sum(c for w, c in self.recent if now - w <= RATE_WINDOW_S)
        span = RATE_WINDOW_S
        if self.recent and len(self.recent) == self.recent.maxlen:
            # the ring truncated history: at high batch rates 512
            # entries span far less than the nominal window, and
            # dividing by the full window would under-report the rate
            # by the truncation factor
            span = min(RATE_WINDOW_S,
                       max(now - self.recent[0][0], 1e-3))
        return n / span

    def as_dict(self, now: float, bounds: tuple) -> dict:
        """``bounds`` are the REGISTRY's cached counting bounds — the
        labels must describe the grid the counts accumulated against,
        not a live env re-read (a mid-run knob flip would otherwise
        silently relabel old counts)."""
        covered = max(1, self.kinds_events)
        tomb = sum(self.kinds[k] for k in _TOMBSTONE_KINDS)
        return {
            "stage": self.stage,
            "disorder_bound": self.disorder,
            "events": self.events,
            "batches": self.batches,
            "mean_batch_events": round(self.events / max(1, self.batches),
                                       1),
            "max_batch_events": self.batch_events_max,
            "updates_per_s": round(self.updates_per_s(now), 1),
            "kinds": dict(zip(_KIND_NAMES, self.kinds)),
            "mix_sampled_events": self.kinds_events,
            "tombstone_fraction": round(tomb / covered, 4),
            "out_of_order": {
                "bounds": list(bounds)[:len(self.ooo_counts) - 1],
                "counts": list(self.ooo_counts),
                "events": self.ooo_events,
                "sampled_events": self.ooo_events_seen,
                "max_distance": self.ooo_max,
                "past_disorder_bound": self.ooo_max > self.disorder,
            },
            "high_water_time": (self.max_t if self.max_t > _NEG_INF
                                else None),
            "queryable_seconds": self.queryable.as_dict(),
            "pending_batches": len(self.pending),
            "pending_dropped": self.pending_dropped,
        }


class FreshnessRegistry:
    """Process-wide freshness plane. All mutation under one lock; numpy
    batch math happens before the lock is taken, Prometheus mirroring
    after it is released (RT009 hygiene — the lock only ever guards
    dict/deque ops)."""

    def __init__(self):
        self._lock = threading.Lock()
        self._sources: dict[str, _SourceStats] = {}
        self.dropped_sources = 0
        #: (event_time_head, wall) ring mapping event-time heads to wall
        #: clocks — what dates a live result's staleness
        self._head: deque = deque(maxlen=HEAD_RING)
        self._staleness: dict[str, _Hist] = {}
        self.dropped_algos = 0
        #: per-live-subscription epoch table (bounded, keyed by job id):
        #: what /statusz + /freshz surface about the epoch engine
        self._live_subs: dict = {}
        self.dropped_live_subs = 0
        self.undated_results = 0
        self.last_safe: int | None = None
        self.last_safe_wall = 0.0
        #: weakly-held ingestion pipelines (backlog + queue bound)
        self._pipes: list = []
        #: router stage: per-shard routed event counts + dead-letter depth
        self._routed: dict[int, int] = {}
        self._route_pending = 0
        # freshness budget state (the RTPU_FRESH_TARGET judgment)
        self._registered: dict[str, float] = {}
        self._last_grades: dict[str, str] = {}
        self._eval_cache: tuple | None = None
        # cached knobs (a getenv — and for the bounds a parse+sort —
        # per batch is hot-path cost); re-read on clear(), the
        # test/bench reset point
        self._pending_cap = pending_cap()
        self._ooo_bounds = ooo_bounds()
        self._san_tracker = _san_track("freshness_registry")

    # ---- registration ----

    def register_source(self, name: str, disorder: int = 0,
                        stage: str = "source") -> None:
        with self._lock:
            _san_note(self._san_tracker, True)
            if name in self._sources:
                return
            if len(self._sources) >= MAX_SOURCES:
                self.dropped_sources += 1
                return
            self._sources[name] = _SourceStats(str(name), disorder, stage)

    def attach_pipeline(self, pipe) -> None:
        """Weakly attach an IngestionPipeline so /freshz and the series
        ring can read its staged backlog + queue bound without pinning a
        dead pipeline (the registry is process-wide)."""
        with self._lock:
            self._pipes = [r for r in self._pipes if r() is not None]
            if len(self._pipes) < 64:   # bounded (RT011)
                self._pipes.append(weakref.ref(pipe))

    # ---- ingest-side observation ----

    def note_batch(self, source: str, t, k=None,
                   trace_id: str | None = None,
                   now: float | None = None,
                   stage: str | None = None) -> None:
        """One sink batch arrived from ``source``: op mix, batch size,
        out-of-orderness vs the source high water, and a pending
        queryable record stamped at arrival. ``stage`` labels the sink
        mode (direct/staged). Numpy math runs before the lock; never
        raises into the ingest path."""
        if not enabled():
            return
        try:
            self._note_batch(source, t, k, trace_id, now, stage)
        except Exception:   # telemetry never takes ingest down
            pass

    def _note_batch(self, source, t, k, trace_id, now, stage) -> None:
        import numpy as np

        n = int(len(t))
        if not n:
            return
        now = time.time() if now is None else float(now)
        # CPython dict reads are atomic: the racy fast-path get saves a
        # lock round-trip per batch; a miss (first batch of an
        # unregistered source) takes the locked create path once
        st = self._sources.get(source)
        if st is None:
            with self._lock:
                st = self._sources.get(source)
                if st is None:
                    _san_note(self._san_tracker, True)
                    if len(self._sources) >= MAX_SOURCES:
                        self.dropped_sources += 1
                        return
                    st = self._sources[source] = _SourceStats(
                        str(source), 0, "source")
        # a source's batches arrive from ONE thread (its consume loop /
        # the staged writer runs the pipeline's ordering), so reading
        # its high water outside the lock is single-writer-consistent;
        # the numpy passes below then run lock-free (RT009 hygiene)
        prev_max = st.max_t
        t = np.asarray(t)
        ooo_n = 0
        # DEEP batches pay the O(n) accounting passes (ooo check + mix
        # bincount); shallow ones only the exact O(n)-but-SIMD max.
        # Deterministic on the LARGE-batch counter (see
        # _SourceStats.large_batches), so both arms of an A/B stream do
        # identical work per pair and mixed-size streams stay unbiased.
        large = n >= DEEP_EXACT_N
        deep = not large or st.large_batches % DEEP_SAMPLE == 0
        mix_scale = DEEP_SAMPLE if large else 1
        kind_counts = None
        # batch_max is the BATCH's own max event time — the queryable
        # record's fence bar (a late batch unblocks exact views once
        # the fence covers ITS events, not the source's high water);
        # the high water folds in separately at st.max_t below
        if not deep:
            batch_max = int(t.max())
        elif int(t[0]) >= prev_max \
                and (n < 2 or bool((t[1:] >= t[:-1]).all())):
            # a time-sorted batch landing at or past the high water
            # carries ZERO out-of-order events — one comparison pass
            # proves it and the distance math is skipped entirely
            batch_max = int(t[-1])
        else:
            # out-of-orderness: distance behind the running high water
            # (previous batches' max folded in) — the arrival-side view
            # of the disorder the watermark promise must absorb
            run = np.maximum.accumulate(t)
            high = np.maximum(prev_max, run) if prev_max > _NEG_INF \
                else run
            dist = high - t
            ooo = dist[dist > 0]
            ooo_n = int(len(ooo))
            batch_max = int(run[-1])
            bounds = self._ooo_bounds
            if ooo_n:
                bucket_i, bucket_c = np.unique(
                    np.searchsorted(bounds, ooo, side="left"),
                    return_counts=True)
                ooo_max = int(ooo.max())
        if deep and k is not None:
            kind_counts = np.bincount(np.asarray(k), minlength=4)
        if trace_id is None and TRACER.enabled:
            ctx = TRACER.capture()
            trace_id = ctx.trace_id if ctx is not None else None
        with self._lock:
            _san_note(self._san_tracker, True)
            if stage is not None:
                st.stage = stage
            if ooo_n:
                if len(st.ooo_counts) != len(bounds) + 1:
                    st.ooo_counts = [0] * (len(bounds) + 1)   # knob flip
                for i, c in zip(bucket_i.tolist(), bucket_c.tolist()):
                    st.ooo_counts[int(i)] += int(c)
                st.ooo_events += ooo_n
                st.ooo_max = max(st.ooo_max, ooo_max)
            st.events += n
            st.batches += 1
            if large:
                st.large_batches += 1
            if deep:
                st.ooo_events_seen += n
            if n > st.batch_events_max:
                st.batch_events_max = n
            st.recent.append((now, n))
            if kind_counts is not None:
                st.kinds_events += n
                for i in range(min(4, len(kind_counts))):
                    st.kinds[i] += int(kind_counts[i])
            if batch_max > st.max_t:
                st.max_t = batch_max
            # queryable pending record, stamped at ARRIVAL (staged-queue
            # wait is part of ingest-to-queryable by design)
            st.pending.append((batch_max, now, trace_id))
            while len(st.pending) > self._pending_cap:
                st.pending.popleft()
                st.pending_dropped += 1
            # head clock: only appended when the process-wide ingest
            # head actually advances, so the ring stays monotone in
            # event time (bisect depends on it)
            if not self._head or batch_max > self._head[-1][0]:
                self._head.append((batch_max, now))
        prom = st.prom
        if prom is None:
            m = _metrics()
            if m is None:
                return
            prom = st.prom = (m.ingest_batches.labels(source),
                              m.ingest_batch_events,
                              m.ingest_ooo_events.labels(source),
                              m.ingest_tombstones.labels(source),
                              m.freshness_queryable.labels(source))
        prom[0].inc()   # mirror outside the lock, cached children
        prom[1].observe(n)
        if ooo_n:
            prom[2].inc(ooo_n * mix_scale)
        if kind_counts is not None:
            tomb = int(sum(kind_counts[i] for i in _TOMBSTONE_KINDS
                           if i < len(kind_counts)))
            if tomb:
                # sampled batches scale up for an unbiased total
                # estimate (documented on the metric's /freshz twin,
                # whose raw sampled counts stay exact)
                prom[3].inc(tomb * mix_scale)

    def note_safe(self, safe_time: int, now: float | None = None) -> None:
        """The global safe-time fence moved to ``safe_time``
        (``WatermarkRegistry`` calls this OUTSIDE its own lock): every
        pending batch whose max event time the fence now covers became
        queryable — observe its arrival→now latency with its trace
        exemplar. Never raises into the watermark path."""
        if not enabled():
            return
        try:
            self._note_safe(safe_time, now)
        except Exception:   # telemetry never takes the fence down
            pass

    def _note_safe(self, safe_time, now) -> None:
        now = time.time() if now is None else float(now)
        safe_time = int(safe_time)
        # the fence sentinels (±2^62: all-done / idle-registered) are
        # not times — report null rather than garbage. The drain below
        # still runs: the positive sentinel drains EVERYTHING, the
        # negative one naturally drains nothing. Down-moves and the
        # rare out-of-order delivery of two concurrent advances are
        # stored as-is: the drain is idempotent (a lower fence drains
        # batches a newer call already popped — a no-op), and a
        # transiently-low reported last_safe self-corrects on the next
        # advance, whereas refusing non-monotone values froze the
        # plane after any legitimate fence down-move (a new live
        # source joining lowers the min).
        observed: list[tuple[_SourceStats, float]] = []
        with self._lock:
            _san_note(self._san_tracker, True)
            self.last_safe = (safe_time if abs(safe_time) < 2**62
                              else None)
            self.last_safe_wall = now
            for st in self._sources.values():
                if not st.pending:
                    continue
                # records carry each batch's OWN max, so a disordered
                # source's deque is not max_t-monotone — scan it, not
                # just the head (a late low-max batch must not wait
                # behind an earlier high-max one). The deque stays
                # arrival-ordered and small: every fence advance
                # drains, and a stalled fence generates no calls.
                kept: deque = deque()
                for bm, arrival, tid in st.pending:
                    if bm <= safe_time:
                        lat = max(0.0, now - arrival)
                        st.queryable.observe(lat, tid, now)
                        observed.append((st, lat))
                    else:
                        kept.append((bm, arrival, tid))
                if len(kept) != len(st.pending):
                    st.pending = kept
        for st, lat in observed:   # cached children, outside the lock
            if st.prom is not None:
                st.prom[4].observe(lat)
            if _journal.enabled():
                _journal.emit("fresh", {
                    "source": st.name,
                    "queryable_latency_s": round(lat, 6),
                    "safe_time": self.last_safe})

    def note_route(self, owner_counts: dict,
                   pending_events: int = 0) -> None:
        """Router-stage telemetry (ingestion/router.ShardRouter): events
        routed per shard this batch + the dead-letter (down-shard) queue
        depth. Never raises into the routing path."""
        if not enabled():
            return
        try:
            with self._lock:
                _san_note(self._san_tracker, True)
                for sid, n in owner_counts.items():
                    if len(self._routed) < 4096 \
                            or int(sid) in self._routed:
                        self._routed[int(sid)] = \
                            self._routed.get(int(sid), 0) + int(n)
                self._route_pending = int(pending_events)
        except Exception:   # telemetry never takes routing down
            pass

    # ---- live-query staleness ----

    def note_live_result(self, algorithm: str, result_time: int,
                         head_time: int | None = None,
                         trace_id: str | None = None,
                         now: float | None = None) -> float | None:
        """One Live job run emitted a result computed at event time
        ``result_time``: record its staleness — how long ago the data it
        reflects stopped being the ingest head — into the per-algorithm
        histogram, and return it (None when the result can't be dated)
        so the epoch engine can feed its per-subscription table and
        cadence without re-walking the head ring. ``head_time`` (the
        caller's ``graph.latest_time``) backs up the head clock for
        graphs ingested outside the pipeline; a result we cannot date is
        counted, never guessed. Never raises into the live-job loop."""
        if not enabled():
            return None
        try:
            return self._note_live_result(algorithm, result_time,
                                          head_time, trace_id, now)
        except Exception:   # telemetry never fails a live job
            return None

    def _note_live_result(self, algorithm, result_time, head_time,
                          trace_id, now) -> float | None:
        now = time.time() if now is None else float(now)
        result_time = int(result_time)
        staleness: float | None = None
        with self._lock:
            _san_note(self._san_tracker, True)
            head = self._head[-1][0] if self._head else head_time
            if head is None:
                self.undated_results += 1
                return None
            if result_time >= int(head):
                staleness = 0.0    # the result reflects the whole head
            else:
                # EARLIEST head-clock entry past the result's watermark
                # = the wall time the result became stale. Reverse walk
                # (the ring is event-time monotone): live results sit
                # near the head, so this terminates in a few steps and
                # never materializes the ring as a list under the lock
                wall = None
                for ev_t, w in reversed(self._head):
                    if ev_t <= result_time:
                        break
                    wall = w
                if wall is None:   # ring empty (head_time backstop only)
                    self.undated_results += 1
                    return None
                staleness = max(0.0, now - wall)
            alg = str(algorithm)
            h = self._staleness.get(alg)
            if h is None:
                if len(self._staleness) >= MAX_ALGOS:
                    self.dropped_algos += 1
                    return staleness
                h = self._staleness[alg] = _Hist(DEFAULT_SECONDS_BUCKETS)
            h.observe(staleness, trace_id, now)
        m = _metrics()
        if m is not None:
            m.freshness_staleness.labels(str(algorithm)).observe(staleness)
        return staleness

    def note_live_epoch(self, key: str, *, algorithm: str, mode: str,
                        delta_rows: int = 0, ship_bytes: int = 0,
                        staleness_s: float | None = None,
                        result_time: int | None = None,
                        now: float | None = None) -> None:
        """One epoch of a live subscription was served: update the
        bounded per-subscription table /statusz + /freshz surface.
        ``key`` identifies the subscription (job id), ``mode`` is the
        epoch mode (incremental|rebase|resweep|skipped|resync).
        Never raises into the live-job loop."""
        if not enabled():
            return
        try:
            now = time.time() if now is None else float(now)
            with self._lock:
                _san_note(self._san_tracker, True)
                row = self._live_subs.get(key)
                if row is None:
                    if len(self._live_subs) >= MAX_LIVE_SUBS:
                        self.dropped_live_subs += 1
                        return
                    row = self._live_subs[key] = {
                        "algorithm": str(algorithm), "epochs": 0,
                        "incremental": 0, "fallback": 0,
                        "modes": {},
                        "last_delta_rows": 0, "last_ship_bytes": 0,
                        "last_staleness_seconds": None,
                        "last_result_time": None, "last_wall": 0.0,
                        "recent": deque(maxlen=MAX_LIVE_RECENT),
                    }
                row["epochs"] += 1
                row["modes"][str(mode)] = row["modes"].get(str(mode), 0) + 1
                if mode in ("incremental", "resync"):
                    row["incremental"] += 1
                elif mode in ("resweep", "rebase"):
                    row["fallback"] += 1
                row["last_delta_rows"] = int(delta_rows)
                row["last_ship_bytes"] = int(ship_bytes)
                if staleness_s is not None:
                    row["last_staleness_seconds"] = round(
                        float(staleness_s), 4)
                if result_time is not None:
                    row["last_result_time"] = int(result_time)
                row["last_wall"] = now
                # bounded per-epoch ring: lets /freshz (and the
                # live_stream bench's median-staleness / ship-bytes
                # verification) see the epoch SERIES, not just the last
                row["recent"].append({
                    "mode": str(mode),
                    "delta_rows": int(delta_rows),
                    "ship_bytes": int(ship_bytes),
                    "staleness_seconds": (None if staleness_s is None
                                          else round(float(staleness_s),
                                                     4)),
                })
        except Exception:   # telemetry never fails a live job
            pass

    def live_subscription_rows(self) -> dict:
        """Snapshot of the per-subscription epoch table (exported on
        /statusz + /freshz; jobs/manager embeds it in failure-artifact
        dumps)."""
        with self._lock:
            return {k: dict(v, modes=dict(v["modes"]),
                            recent=[dict(r) for r in v["recent"]])
                    for k, v in self._live_subs.items()}

    def live_grade(self, algorithm: str) -> str:
        """Most recent staleness-budget grade for ``algorithm`` (as
        written by ``budget_evaluate``; "ok" when the algorithm has no
        target). The epoch engine's cadence reads this — a burning
        budget shortens the inter-epoch wait to the floor."""
        self.budget_evaluate()   # refresh (cached for EVAL_CACHE_S)
        with self._lock:
            return self._last_grades.get(str(algorithm), "ok")

    # ---- readers (series-ring collectors, surfaces) ----

    def total_events(self) -> float:
        with self._lock:
            return float(sum(s.events for s in self._sources.values()))

    def backlog_events(self) -> float:
        """Staged parse→append backlog summed over attached pipelines."""
        with self._lock:
            pipes = [r() for r in self._pipes]
        return float(sum(p.backlog() for p in pipes if p is not None))

    def queue_max_events(self) -> int:
        with self._lock:
            pipes = [r() for r in self._pipes]
        return max((int(p.queue_max_events) for p in pipes
                    if p is not None), default=0)

    def staged_queues(self) -> list[dict]:
        """Per-pipeline (backlog, bound) rows for the STAGED pipelines —
        saturation is a per-queue property (the ``ingest-backlog``
        advisor rule judges the worst queue, not a sum-vs-max mix)."""
        with self._lock:
            pipes = [r() for r in self._pipes]
        return [{"backlog_events": int(p.backlog()),
                 "queue_max_events": int(p.queue_max_events)}
                for p in pipes
                if p is not None and p.queue_max_events > 0]

    def pending_batches(self) -> int:
        """Not-yet-queryable batch count (the prometheus gauge's read)."""
        with self._lock:
            return sum(len(s.pending) for s in self._sources.values())

    def queryable_lag_seconds(self, now: float | None = None) -> float:
        """Age of the OLDEST not-yet-queryable batch — the live
        ingest-to-queryable lag signal the series ring samples (0 when
        everything appended is already behind the fence)."""
        now = time.time() if now is None else float(now)
        with self._lock:
            oldest = min((st.pending[0][1]
                          for st in self._sources.values() if st.pending),
                         default=None)
        return 0.0 if oldest is None else max(0.0, now - oldest)

    def staleness_totals_below(self, algorithm: str,
                               threshold_s: float) -> tuple[int, int]:
        """``(total, good)`` staleness observations for ``algorithm``
        where *good* means buckets ≤ ``threshold_s`` — the freshness
        error-budget numerator (same conservative rule as
        ``slo.totals_below``; case-insensitive, targets are
        operator-typed)."""
        alg = str(algorithm).lower()
        total = good = 0
        with self._lock:
            for a, h in self._staleness.items():
                if a.lower() != alg:
                    continue
                total += h.count
                for i, bound in enumerate(h.bounds):
                    if bound <= threshold_s:
                        good += h.counts[i]
        return total, good

    # ---- the RTPU_FRESH_TARGET staleness budget ----

    def _ensure_collectors(self, targets: list) -> None:
        """Register per-target cumulative (observations, breaches)
        collectors into the /slz series ring — ``fresh_obs_<alg>_total``
        / ``fresh_bad_<alg>_total``, the windowed-burn inputs. Retired
        on retarget exactly like obs/budget (changed thresholds
        re-register: the closures capture them). ONLY the process
        singleton registers: the closures capture ``self``, so a
        throwaway registry (tests, tooling) would otherwise be pinned
        alive by the process-global ring and clobber the singleton's
        collectors; non-singleton registries keep the cumulative-burn
        fallback instead."""
        from .slo import SERIES

        if globals().get("FRESH") is not self:
            return
        current = {t.algorithm for t in targets}
        fresh, stale = [], []
        with self._lock:
            _san_note(self._san_tracker, True)
            for t in targets:
                if self._registered.get(t.algorithm) != t.threshold_s:
                    self._registered[t.algorithm] = t.threshold_s
                    fresh.append(t)
            for alg in set(self._registered) - current:
                del self._registered[alg]
                self._last_grades.pop(alg, None)
                stale.append(alg)
        for t in fresh:
            alg, thr = t.algorithm, t.threshold_s

            def _obs(alg=alg, thr=thr):
                return float(self.staleness_totals_below(alg, thr)[0])

            def _bad(alg=alg, thr=thr):
                total, good = self.staleness_totals_below(alg, thr)
                return float(total - good)

            SERIES.register(f"fresh_obs_{alg}_total", _obs)
            SERIES.register(f"fresh_bad_{alg}_total", _bad)
        for alg in stale:
            SERIES.unregister(f"fresh_obs_{alg}_total")
            SERIES.unregister(f"fresh_bad_{alg}_total")
            m = _metrics()
            if m is not None:
                for window in ("fast", "slow"):
                    try:
                        m.freshness_burn_rate.remove(alg, window)
                    except Exception:
                        pass

    def budget_evaluate(self, now: float | None = None,
                        rows: list | None = None) -> dict:
        """The staleness-budget judgment: per-target cumulative +
        fast/slow windowed burns over the series ring, graded
        ok|degraded|burning — ``RTPU_FRESH_TARGET`` through the
        obs/budget machinery (same parser, same ``window_burn``, same
        dead-ring fallback to the cumulative burn). Live evaluations are
        cached for ``EVAL_CACHE_S`` keyed on the knob env."""
        from . import budget as _budget
        from .slo import SERIES

        live = now is None and rows is None
        env_key = (os.environ.get("RTPU_FRESH_TARGET"),
                   os.environ.get("RTPU_BUDGET_FAST_S"),
                   os.environ.get("RTPU_BUDGET_SLOW_S"))
        if live:
            with self._lock:
                cached = self._eval_cache
            if cached is not None and cached[0] == env_key and \
                    time.monotonic() - cached[1] < EVAL_CACHE_S:
                return cached[2]
        targets, errors = _budget.parse_targets(
            os.environ.get("RTPU_FRESH_TARGET", ""))
        self._ensure_collectors(targets)
        if rows is None:
            rows = SERIES.rows()
        if now is None:
            now = time.time()
        fast_s = _budget.fast_window_s()
        slow_s = _budget.slow_window_s()
        out_targets = []
        transitions = []
        grade = "ok"
        m = _metrics()
        for t in targets:
            # the SHARED grading core (obs/budget.judge_target): burn
            # math and the 2-of-2 grade ladder can never diverge
            # between the latency and staleness planes
            row, t_grade, eff_fast, eff_slow = _budget.judge_target(
                t, rows, now, fast_s, slow_s,
                self.staleness_totals_below, prefix="fresh")
            if _GRADE_ORDER[t_grade] > _GRADE_ORDER[grade]:
                grade = t_grade
            out_targets.append(row)
            if m is not None:
                m.freshness_burn_rate.labels(t.algorithm,
                                             "fast").set(eff_fast)
                m.freshness_burn_rate.labels(t.algorithm,
                                             "slow").set(eff_slow)
            with self._lock:
                prev = self._last_grades.get(t.algorithm, "ok")
                self._last_grades[t.algorithm] = t_grade
            if _GRADE_ORDER[t_grade] > _GRADE_ORDER[prev]:
                transitions.append((t.algorithm, prev, t_grade, row))
        for alg, prev, cur, row in transitions:   # instants outside locks
            TRACER.instant("freshness.burn", algorithm=alg, grade=cur,
                           previous=prev, fast_burn=row["fast_burn"],
                           slow_burn=row["slow_burn"],
                           cumulative_burn=row["cumulative_burn"])
        result = {"targets": out_targets, "errors": errors,
                  "grade": grade,
                  "windows_seconds": {"fast": fast_s, "slow": slow_s}}
        if live:
            with self._lock:
                self._eval_cache = (env_key, time.monotonic(), result)
        return result

    # ---- export ----

    def status_block(self) -> dict:
        """The compact ``freshness`` block /statusz embeds (what
        /clusterz federates — per-source tables stay on /freshz)."""
        now = time.time()
        with self._lock:
            _san_note(self._san_tracker, False)
            ups = sum(s.updates_per_s(now) for s in self._sources.values())
            n_sources = len(self._sources)
            pending = sum(len(s.pending) for s in self._sources.values())
            stale_p99 = {a: h.quantile(0.99)
                         for a, h in self._staleness.items()}
            last_safe = self.last_safe
            # compact block: the per-epoch ``recent`` ring stays on
            # /freshz (this block is federated via /clusterz)
            live_subs = {k: {f: (dict(val) if f == "modes" else val)
                             for f, val in v.items() if f != "recent"}
                         for k, v in self._live_subs.items()}
        bud = self.budget_evaluate()
        return {
            "enabled": enabled(),
            "sources": n_sources,
            "updates_per_s": round(ups, 1),
            "backlog_events": int(self.backlog_events()),
            "pending_batches": pending,
            "queryable_lag_seconds": round(
                self.queryable_lag_seconds(now), 3),
            "last_safe_time": last_safe,
            "staleness_p99_seconds": {a: round(v, 4)
                                      for a, v in stale_p99.items()},
            "live_subscriptions": live_subs,
            "grade": bud["grade"],
        }

    def freshz(self) -> dict:
        """The full ``/freshz`` document: per-source tables, staleness
        histograms + exemplars, the head clock's span, the router-stage
        table, and the staleness-budget judgment."""
        now = time.time()
        with self._lock:
            _san_note(self._san_tracker, False)
            sources = {name: st.as_dict(now, self._ooo_bounds)
                       for name, st in sorted(self._sources.items())}
            staleness = {a: h.as_dict()
                         for a, h in sorted(self._staleness.items())}
            head = {
                "entries": len(self._head),
                "event_time": self._head[-1][0] if self._head else None,
                "oldest_event_time": (self._head[0][0] if self._head
                                      else None),
            }
            router = {"routed_events_by_shard": dict(self._routed),
                      "dead_letter_events": self._route_pending}
            meta = {"dropped_sources": self.dropped_sources,
                    "dropped_algorithms": self.dropped_algos,
                    "dropped_live_subscriptions": self.dropped_live_subs,
                    "undated_results": self.undated_results,
                    "last_safe_time": self.last_safe}
            live_subs = {k: dict(v, modes=dict(v["modes"]),
                                 recent=[dict(r) for r in v["recent"]])
                         for k, v in self._live_subs.items()}
        return {
            "enabled": enabled(),
            "sources": sources,
            "staleness_seconds": staleness,
            "head": head,
            "router": router,
            "backlog_events": int(self.backlog_events()),
            "queue_max_events": self.queue_max_events(),
            "staged_queues": self.staged_queues(),
            "queryable_lag_seconds": round(
                self.queryable_lag_seconds(now), 3),
            "live_subscriptions": live_subs,
            "budget": self.budget_evaluate(),
            **meta,
        }

    def advisor_signals(self) -> dict:
        """The compact signals dict the advisor rules read
        (obs/advisor.py ``ingest-backlog`` / ``out-of-order-excess`` /
        ``freshness-burn``)."""
        now = time.time()
        with self._lock:
            _san_note(self._san_tracker, False)
            sources = {name: {
                "events": st.events,
                "disorder_bound": st.disorder,
                "ooo_events": st.ooo_events,
                "ooo_max": st.ooo_max,
                "updates_per_s": round(st.updates_per_s(now), 1),
                "pending_batches": len(st.pending),
            } for name, st in self._sources.items()}
            stale_p99 = {a: round(h.quantile(0.99), 4)
                         for a, h in self._staleness.items()}
        return {
            "sources": sources,
            "backlog_events": int(self.backlog_events()),
            "queue_max_events": self.queue_max_events(),
            "staged_queues": self.staged_queues(),
            "queryable_lag_seconds": round(
                self.queryable_lag_seconds(now), 3),
            "staleness_p99_seconds": stale_p99,
            "budget": self.budget_evaluate(),
        }

    def clear(self) -> None:
        with self._lock:
            registered = list(self._registered)
            self._sources.clear()
            self._head.clear()
            self._staleness.clear()
            self._live_subs.clear()
            self.dropped_live_subs = 0
            self._routed.clear()
            self._route_pending = 0
            self._pipes = []
            self.dropped_sources = 0
            self.dropped_algos = 0
            self.undated_results = 0
            self.last_safe = None
            self._registered.clear()
            self._last_grades.clear()
            self._eval_cache = None
            self._pending_cap = pending_cap()
            self._ooo_bounds = ooo_bounds()
        from .slo import SERIES

        for alg in registered:
            SERIES.unregister(f"fresh_obs_{alg}_total")
            SERIES.unregister(f"fresh_bad_{alg}_total")


#: the process singleton the pipeline, watermark registry, jobs layer
#: and REST surfaces all feed/read
FRESH = FreshnessRegistry()


def note_live_result(algorithm, result_time, head_time=None,
                     trace_id=None, now=None) -> float | None:
    """Module-level convenience for the jobs layer."""
    return FRESH.note_live_result(algorithm, result_time,
                                  head_time=head_time,
                                  trace_id=trace_id, now=now)


def freshz() -> dict:
    return FRESH.freshz()


_fresh_dump = os.environ.get("RTPU_FRESH_DUMP")
if _fresh_dump:
    from . import exitdump as _exitdump

    def _dump_freshz(path=_fresh_dump):
        with open(path, "w") as f:
            json.dump(freshz(), f, default=str)

    _exitdump.register("fresh", _dump_freshz)
