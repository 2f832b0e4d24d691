"""Per-tenant workload accounts — WHO is spending the cluster's budget.

The ledger (``obs/ledger.py``) answers "what did this query cost"; the
serving path needs the roll-up one level higher: "what
has each TENANT cost", because admission control prices tenants, not
queries, and load shedding must name a victim. Requests carry an
optional tenant identity — the ``X-RTPU-Tenant`` header or a ``tenant``
body field, default ``anon`` — and every completed job's ledger is
merged into a bounded per-tenant account here (this is the sub-ledger
role :meth:`obs.ledger.Ledger.merge` was built and tested for).

Identity rules (mirrors the trace wire-header contract: an observability
header can never fail a request):

* missing / empty → ``anon``;
* malformed — non-ASCII, longer than 64 chars, or characters outside
  ``[A-Za-z0-9._-]`` — → ``invalid`` (one shared account: a client typo,
  or an adversarial header, must not mint unbounded label cardinality
  or 4xx the request);
* past ``RTPU_TENANT_CAP`` distinct tenants, new names aggregate into
  ``other`` — per-tenant Prometheus label cardinality is PROVABLY
  bounded by cap + 3 sentinel names.

Each account carries: cost seconds by phase (fold/stage/ship/compute/
device_wait/emit/other + queue wait), est HBM + DCN + H2D bytes,
fold-cache hits consumed vs folds paid for (misses that populated the
cache), query counts by status, a bounded query-shape top-K, and the
most expensive recent queries with their trace ids (the advisor's
shed-this-tenant evidence). Surfaces: ``/workloadz``, a compact
``workload`` block in ``/statusz`` (what ``/clusterz`` federates into
the merged per-tenant view), and ``raphtory_tenant_*`` counters.

Knobs
-----
* ``RTPU_WORKLOAD`` — tenant-attributed accounting (default on; the
  ``advisor_overhead`` bench's off arm).
* ``RTPU_TENANT_CAP`` — distinct named tenant accounts (default 64);
  overflow tenants aggregate into ``other``.
"""

from __future__ import annotations

import os
import threading
import time

from ..analysis.sanitizer import (note_shared as _san_note,
                                  track_shared as _san_track)
from . import ledger as _ledger
from .slo import _metrics

#: request header carrying the tenant identity (jobs/rest.py reads it)
TENANT_HEADER = "X-RTPU-Tenant"
TENANT_DEFAULT = "anon"
TENANT_INVALID = "invalid"
TENANT_OVERFLOW = "other"
MAX_TENANT_LEN = 64
#: distinct query shapes tracked per account before aggregating
MAX_SHAPES = 32
#: most-expensive-query exemplars kept per account
TOP_QUERIES = 3

_ALLOWED = frozenset(
    "abcdefghijklmnopqrstuvwxyzABCDEFGHIJKLMNOPQRSTUVWXYZ0123456789._-")


def enabled() -> bool:
    """Re-read per completed job so the bench A/B (and operators) can
    flip attribution without a restart."""
    return os.environ.get("RTPU_WORKLOAD", "1") not in ("", "0", "false")


def tenant_cap() -> int:
    try:
        return max(1, int(os.environ.get("RTPU_TENANT_CAP", "64") or 64))
    except ValueError:
        return 64


def normalize_tenant(raw) -> str:
    """Normalize a client-supplied tenant identity to a safe account /
    metric-label name. NEVER raises — a malformed observability header
    must not fail the request it rides on, and must not
    mint unbounded label cardinality either, so everything suspicious
    lands in the one shared ``invalid`` account."""
    if raw is None:
        return TENANT_DEFAULT
    if not isinstance(raw, str):
        return TENANT_INVALID
    s = raw.strip()
    if not s:
        return TENANT_DEFAULT
    if len(s) > MAX_TENANT_LEN:
        return TENANT_INVALID
    if not all(c in _ALLOWED for c in s):
        return TENANT_INVALID
    if s == TENANT_OVERFLOW:
        # a client claiming the overflow aggregate by name would merge
        # into it cap-exempt and without the overflow count — `other`
        # must keep meaning "past-cap tenants", so the claim is invalid
        return TENANT_INVALID
    return s


class _Account:
    """One tenant's rolling account: a long-lived sub-ledger every
    completed query's ledger merges into, plus the scalars
    ``Ledger.merge`` deliberately leaves per-query (wall, queue wait,
    status counts) and the bounded shape/exemplar tables."""

    __slots__ = ("tenant", "ledger", "queries", "wall_seconds",
                 "queue_wait_seconds", "cost_seconds", "shapes",
                 "shapes_overflow", "top_queries", "first_unix",
                 "last_unix")

    def __init__(self, tenant: str):
        self.tenant = tenant
        self.ledger = _ledger.Ledger(query_id=f"tenant:{tenant}")
        self.queries: dict[str, int] = {}
        self.wall_seconds = 0.0
        self.queue_wait_seconds = 0.0
        self.cost_seconds = 0.0
        self.shapes: dict[str, int] = {}
        self.shapes_overflow = 0
        self.top_queries: list[dict] = []
        self.first_unix = time.time()
        self.last_unix = self.first_unix

    def add(self, led: "_ledger.Ledger", status: str) -> None:
        self.ledger.merge(led)
        self.queries[status] = self.queries.get(status, 0) + 1
        self.wall_seconds += led.wall_seconds
        self.queue_wait_seconds += led.queue_wait_seconds
        with led._lock:
            self.cost_seconds += sum(led.phase_seconds.values())
        shape = f"{led.algorithm or 'unknown'}/{led.views}v/{led.hops}h"
        if shape in self.shapes or len(self.shapes) < MAX_SHAPES:
            self.shapes[shape] = self.shapes.get(shape, 0) + 1
        else:
            self.shapes_overflow += 1
        self.top_queries.append({
            "query_id": led.query_id, "algorithm": led.algorithm,
            "trace_id": led.trace_id,
            "wall_seconds": round(led.wall_seconds, 6)})
        self.top_queries.sort(key=lambda q: -q["wall_seconds"])
        del self.top_queries[TOP_QUERIES:]
        self.last_unix = time.time()

    def as_dict(self, top_shapes: int = 8) -> dict:
        snap = self.ledger.as_dict()
        shapes = sorted(self.shapes.items(), key=lambda kv: -kv[1])
        out = {
            "tenant": self.tenant,
            "queries": dict(self.queries),
            "queries_total": sum(self.queries.values()),
            "wall_seconds": round(self.wall_seconds, 6),
            "queue_wait_seconds": round(self.queue_wait_seconds, 6),
            "cost_seconds": round(self.cost_seconds, 6),
            "phase_seconds": snap["phase_seconds"],
            "est_hbm_bytes": sum(
                k.get("est_hbm_bytes", 0.0)
                for k in snap["device"]["kernels"].values()),
            "est_bytes_accessed": snap["device"]["est_bytes_accessed"],
            "dcn_bytes": snap["dcn"]["bytes"],
            "h2d_bytes": snap["h2d"]["bytes"],
            # consumed = served from the cross-request fold cache;
            # paid = misses, i.e. folds this tenant ran that populated
            # the cache others (or its own repeats) then hit
            "fold_cache": {"hits_consumed": snap["fold"]["cache_hits"],
                           "folds_paid": snap["fold"]["cache_misses"]},
            "sweeps": snap["sweeps"], "views": snap["views"],
            "hops": snap["hops"],
            "shapes_top": dict(shapes[:max(0, int(top_shapes))]),
            "shapes_overflow": self.shapes_overflow,
            "top_queries": list(self.top_queries),
            "first_unix": round(self.first_unix, 3),
            "last_unix": round(self.last_unix, 3),
        }
        return out


class WorkloadRegistry:
    """Process-wide bounded per-tenant accounts. All mutation under one
    lock (publication runs on every job thread); the named-account table
    never exceeds ``RTPU_TENANT_CAP`` — later tenants merge into the
    ``other`` aggregate, counted so the overflow is visible."""

    def __init__(self):
        self._lock = threading.Lock()
        self._accounts: dict[str, _Account] = {}
        self.overflow_queries = 0
        self._san_tracker = _san_track("workload_accounts")

    def _account_locked(self, tenant: str) -> _Account:
        acct = self._accounts.get(tenant)
        if acct is None:
            if (tenant not in (TENANT_OVERFLOW, TENANT_INVALID,
                               TENANT_DEFAULT)
                    and len(self._accounts) >= tenant_cap()):
                tenant = TENANT_OVERFLOW
                acct = self._accounts.get(tenant)
                self.overflow_queries += 1
            if acct is None:
                acct = self._accounts[tenant] = _Account(tenant)
        return acct

    def record(self, led: "_ledger.Ledger", status: str = "done") -> None:
        """Roll one completed job's ledger into its tenant's account and
        mirror the bounded-cardinality counters. Called by the jobs
        layer after ``Ledger.finish()``; a no-op when ``RTPU_WORKLOAD``
        is off."""
        if not enabled():
            return
        tenant = normalize_tenant(getattr(led, "tenant", None))
        with self._lock:
            _san_note(self._san_tracker, True)
            acct = self._account_locked(tenant)
            acct.add(led, status)
            label = acct.tenant   # post-cap name: bounded cardinality
        m = _metrics()
        if m is None:
            return
        m.tenant_queries.labels(label, status).inc()
        for ph, sec in dict(led.phase_seconds).items():
            m.tenant_cost_seconds.labels(label, ph).inc(max(0.0, sec))
        m.tenant_cost_seconds.labels(label, "queue_wait").inc(
            max(0.0, led.queue_wait_seconds))
        hbm = sum(float(k.get("est_hbm_bytes") or 0.0)
                  for k in dict(led.kernels).values())
        if hbm:
            m.tenant_est_hbm_bytes.labels(label).inc(hbm)
        dcn = sum(d["bytes"] for d in dict(led.dcn).values())
        if dcn:
            m.tenant_dcn_bytes.labels(label).inc(dcn)

    # ---- export ----

    def tenants(self) -> list[str]:
        with self._lock:
            self._san_note_read()
            return sorted(self._accounts)

    def _san_note_read(self) -> None:
        _san_note(self._san_tracker, False)

    def top_by_cost(self, n: int = 8) -> list[dict]:
        """Accounts by total attributed cost seconds, descending — the
        advisor's shed-candidate ordering. Ranks on the cheap scalar and
        snapshots only the selected accounts, so the lock (which every
        completing job's record() also wants) is held for O(n) as_dict
        work, not the whole table's."""
        with self._lock:
            self._san_note_read()
            order = sorted(self._accounts.values(),
                           key=lambda a: -a.cost_seconds)
            return [a.as_dict() for a in order[:max(0, int(n))]]

    def account(self, tenant: str) -> dict | None:
        with self._lock:
            self._san_note_read()
            acct = self._accounts.get(tenant)
            return acct.as_dict() if acct is not None else None

    def status_block(self) -> dict:
        """The compact ``workload`` block /statusz embeds — and what
        ``/clusterz`` federates, so it stays small: per-tenant totals
        only, top 8 by cost."""
        with self._lock:
            self._san_note_read()
            rows = {t: {
                "queries": sum(a.queries.values()),
                "cost_seconds": round(a.cost_seconds, 6),
                "queue_wait_seconds": round(a.queue_wait_seconds, 6),
            } for t, a in self._accounts.items()}
            overflow = self.overflow_queries
        top = sorted(rows.items(), key=lambda kv: -kv[1]["cost_seconds"])
        return {"enabled": enabled(), "tenant_cap": tenant_cap(),
                "n_tenants": len(rows),
                "overflow_queries": overflow,
                "tenants": dict(top[:8])}

    def workloadz(self) -> dict:
        """The full ``/workloadz`` document."""
        with self._lock:
            self._san_note_read()
            accounts = [a.as_dict() for a in self._accounts.values()]
            overflow = self.overflow_queries
        accounts.sort(key=lambda a: -a["cost_seconds"])
        return {
            "enabled": enabled(),
            "tenant_cap": tenant_cap(),
            "n_tenants": len(accounts),
            "overflow_queries": overflow,
            "header": TENANT_HEADER,
            "identity_rule": (
                f"missing -> {TENANT_DEFAULT!r}; non-ASCII / >"
                f"{MAX_TENANT_LEN} chars / outside [A-Za-z0-9._-] -> "
                f"{TENANT_INVALID!r}; past RTPU_TENANT_CAP distinct "
                f"names -> {TENANT_OVERFLOW!r}"),
            "tenants": accounts,
        }

    def clear(self) -> None:
        with self._lock:
            self._accounts.clear()
            self.overflow_queries = 0


#: the process singleton the jobs layer records into
WORKLOAD = WorkloadRegistry()
