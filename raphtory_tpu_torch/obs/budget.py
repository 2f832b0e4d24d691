"""SLO error budgets — operator targets judged as multi-window burn rates.

``obs/slo.py`` builds the measurement (per-algorithm latency histograms with trace
exemplars, ``obs/slo.py``); this module adds the JUDGMENT: operators
declare targets in ``RTPU_SLO_TARGET`` (e.g. ``pagerank=p99:2.5s`` — at
most 1% of PageRank requests may take longer than 2.5 s) and the
registry evaluates each as an error budget:

* **Cumulative burn** — over this process's lifetime histograms:
  ``bad_fraction / allowed_fraction`` where ``allowed = 1 - quantile``.
  ``budget_remaining = 1 - burn`` (negative = overspent).
* **Windowed burn** — the alerting-grade signal. Two collectors per
  target (``slo_obs_<alg>_total`` / ``slo_bad_<alg>_total``) join the
  ``/slz`` series ring; differencing the ring over a FAST window
  (``RTPU_BUDGET_FAST_S``, default 60 s) and a SLOW window
  (``RTPU_BUDGET_SLOW_S``, default 600 s) gives the classic
  multi-window burn-rate pair: the fast window catches a cliff, the
  slow window keeps one bad minute from paging.

Grades (what ``/healthz`` serves — load balancers act on the HTTP code,
no JSON parsing needed, behind ``RTPU_HEALTH_STRICT=1``):

* ``ok`` — every target burns < 1 in both windows.
* ``degraded`` — some target burns ≥ 1 in ONE window (a blip, or a
  burn that has not yet sustained).
* ``burning`` — some target burns ≥ 1 in BOTH windows: sustained
  overspend that will exhaust the budget. HTTP 503 under strict mode.

With the series ring not running (library use, tests) both windows fall
back to the cumulative burn — a breached target then grades straight to
``burning``, which is the honest reading of "all the evidence we have
says overspent". Everything here follows the telemetry prime directive:
a malformed target, an empty histogram, or a dead ring NEVER raises —
parse errors are data (``errors`` in every payload).

Knobs
-----
* ``RTPU_SLO_TARGET`` — comma-separated ``<algorithm>=p<Q>:<latency>``
  targets (``2.5s``, ``250ms``, or bare seconds; ``pagerank=p99:2.5s``).
* ``RTPU_BUDGET_FAST_S`` / ``RTPU_BUDGET_SLOW_S`` — burn windows.
* ``RTPU_HEALTH_STRICT`` — ``1`` makes ``/healthz`` answer 503 while
  some budget is burning (default: always 200, grade in the body).
"""

from __future__ import annotations

import os
import threading
import time

from ..analysis.sanitizer import (note_shared as _san_note,
                                  track_shared as _san_track)
from .slo import _metrics
from .trace import TRACER

DEFAULT_FAST_S = 60.0
DEFAULT_SLOW_S = 600.0
#: live-evaluation cache TTL: /healthz probes, /statusz scrapes (one
#: per peer per /clusterz pass) and advisor ticks all call evaluate();
#: within a second they share one computation instead of each copying
#: the series ring and walking every histogram. The ring itself only
#: samples at 1 Hz, so a fresher answer does not exist anyway.
EVAL_CACHE_S = 1.0
#: parsed-target cap — the per-target Prometheus labels must stay
#: bounded even against a pathological RTPU_SLO_TARGET string
MAX_TARGETS = 16
_GRADE_ORDER = {"ok": 0, "degraded": 1, "burning": 2}


def _window_env(name: str, default: float) -> float:
    try:
        v = float(os.environ.get(name, "") or default)
        return v if v > 0 else default
    except ValueError:
        return default


def fast_window_s() -> float:
    return _window_env("RTPU_BUDGET_FAST_S", DEFAULT_FAST_S)


def slow_window_s() -> float:
    return _window_env("RTPU_BUDGET_SLOW_S", DEFAULT_SLOW_S)


def health_strict() -> bool:
    return os.environ.get("RTPU_HEALTH_STRICT", "0") not in ("", "0",
                                                             "false")


class Target:
    """One parsed SLO target: ``algorithm=pQ:threshold``."""

    __slots__ = ("algorithm", "quantile", "threshold_s", "raw")

    def __init__(self, algorithm: str, quantile: float, threshold_s: float,
                 raw: str):
        self.algorithm = algorithm
        self.quantile = quantile
        self.threshold_s = threshold_s
        self.raw = raw

    @property
    def allowed(self) -> float:
        """Allowed bad fraction — a p99 target tolerates 1% breaches."""
        return max(1e-9, 1.0 - self.quantile)

    def as_dict(self) -> dict:
        return {"algorithm": self.algorithm, "quantile": self.quantile,
                "threshold_s": self.threshold_s, "raw": self.raw,
                "allowed_bad_fraction": round(self.allowed, 9)}


def _parse_latency(s: str) -> float:
    s = s.strip().lower()
    if s.endswith("ms"):
        return float(s[:-2]) / 1000.0
    if s.endswith("s"):
        return float(s[:-1])
    return float(s)


def parse_targets(raw: str | None = None) -> tuple[list, list]:
    """``(targets, errors)`` from a ``RTPU_SLO_TARGET``-shaped string.
    NEVER raises — an operator typo in an env var must not take the
    health surface down; each bad entry becomes an error string."""
    if raw is None:
        raw = os.environ.get("RTPU_SLO_TARGET", "")
    targets: list[Target] = []
    errors: list[str] = []
    seen: set[str] = set()
    for entry in str(raw).split(","):
        entry = entry.strip()
        if not entry:
            continue
        if len(targets) >= MAX_TARGETS:
            errors.append(f"{entry!r}: past the {MAX_TARGETS}-target cap")
            continue
        try:
            alg, spec = entry.split("=", 1)
            qs, thr = spec.split(":", 1)
            qs = qs.strip().lower()
            if not qs.startswith("p"):
                raise ValueError(f"quantile {qs!r} must look like p99")
            q = float(qs[1:]) / 100.0
            if not 0.0 < q < 1.0:
                raise ValueError(f"quantile {qs!r} outside (p0, p100)")
            threshold = _parse_latency(thr)
            if threshold <= 0:
                raise ValueError(f"threshold {thr!r} must be positive")
            alg = alg.strip().lower()
            if not alg:
                raise ValueError("empty algorithm")
            if alg in seen:
                raise ValueError(f"duplicate target for {alg!r}")
            seen.add(alg)
            targets.append(Target(alg, q, threshold, entry))
        except (ValueError, IndexError) as e:
            errors.append(f"{entry!r}: {e}")
    return targets, errors


def window_burn(rows: list, algorithm: str, now: float, window_s: float,
                allowed: float, prefix: str = "slo") -> float | None:
    """Burn rate over series-ring ``rows`` inside ``[now - window_s,
    now]``: (breaches / observations in the window) / allowed. ``None``
    when the window holds fewer than two usable samples (nothing to
    difference — the ring may be off or younger than the window);
    ``0.0`` when the window saw no traffic (no requests burn nothing).
    Pure over its inputs so the burn math tests under injected clocks.
    ``prefix`` selects the collector family: ``slo`` (latency budgets,
    this module) or ``fresh`` (staleness budgets, obs/freshness.py)."""
    obs_name = f"{prefix}_obs_{algorithm}_total"
    bad_name = f"{prefix}_bad_{algorithm}_total"
    inside = [r for r in rows
              if r.get("unix", 0.0) >= now - window_s
              and r.get(obs_name) is not None
              and r.get(bad_name) is not None]
    if len(inside) < 2:
        return None
    d_obs = inside[-1][obs_name] - inside[0][obs_name]
    d_bad = inside[-1][bad_name] - inside[0][bad_name]
    if d_obs <= 0:
        return 0.0
    return max(0.0, d_bad / d_obs) / allowed


def judge_target(t: Target, rows: list, now: float, fast_s: float,
                 slow_s: float, totals_below, prefix: str = "slo"
                 ) -> tuple[dict, str, float, float]:
    """One target's full burn judgment — the grading core BOTH budget
    planes share (latency here, staleness in obs/freshness.py), so the
    burn math and the 2-of-2 grade ladder can never diverge between
    them. ``totals_below(algorithm, threshold_s) -> (total, good)`` is
    the plane's histogram walk; returns ``(row, grade, eff_fast,
    eff_slow)`` where the eff burns fall back to the cumulative burn
    when a window has no usable ring samples (dead/young ring — the
    honest reading of "all the evidence we have")."""
    total, good = totals_below(t.algorithm, t.threshold_s)
    bad = total - good
    cum = ((bad / total) / t.allowed) if total else 0.0
    fast = window_burn(rows, t.algorithm, now, fast_s, t.allowed,
                       prefix=prefix)
    slow = window_burn(rows, t.algorithm, now, slow_s, t.allowed,
                       prefix=prefix)
    eff_fast = cum if fast is None else fast
    eff_slow = cum if slow is None else slow
    if eff_fast >= 1.0 and eff_slow >= 1.0:
        grade = "burning"
    elif eff_fast >= 1.0 or eff_slow >= 1.0:
        grade = "degraded"
    else:
        grade = "ok"
    row = dict(t.as_dict())
    row.update({
        "observations": total, "breaches": bad,
        "cumulative_burn": round(cum, 4),
        "budget_remaining": round(1.0 - cum, 4),
        "fast_burn": None if fast is None else round(fast, 4),
        "slow_burn": None if slow is None else round(slow, 4),
        "windows_seconds": [fast_s, slow_s],
        "grade": grade,
    })
    return row, grade, eff_fast, eff_slow


def _retire(alg: str) -> None:
    """Drop a no-longer-targeted algorithm's ring collectors and
    Prometheus burn gauges (label removal is best-effort: the series
    may never have exported)."""
    from .slo import SERIES

    SERIES.unregister(f"slo_obs_{alg}_total")
    SERIES.unregister(f"slo_bad_{alg}_total")
    m = _metrics()
    if m is None:
        return
    for window in ("fast", "slow"):
        try:
            m.slo_burn_rate.remove(alg, window)
        except Exception:
            pass
    try:
        m.slo_budget_remaining.remove(alg)
    except Exception:
        pass


class BudgetRegistry:
    """Process-wide error-budget evaluator over the SLO histograms +
    series ring. Mutation (grade memory for transition instants,
    collector registration marks) under one lock; all histogram/ring
    reads happen OUTSIDE it (each surface has its own lock)."""

    def __init__(self):
        self._lock = threading.Lock()
        # algorithm -> registered threshold_s: the ring closures capture
        # the threshold, so a CHANGED threshold must re-register too
        self._registered: dict[str, float] = {}
        self._last_grades: dict[str, str] = {}
        # (env_key, monotonic, result) of the last LIVE evaluation —
        # injected now/rows (tests) always bypass; an env change
        # (operator retargets, strict flip) misses by key
        self._cache: tuple | None = None
        self.evaluations = 0
        self._san_tracker = _san_track("budget_registry")

    # ---- collectors ----

    def _ensure_collectors(self, targets: list) -> None:
        """Register the per-target (observations, breaches) cumulative
        collectors into the /slz series ring, once per algorithm — the
        ring's ``_total`` differencing turns them into windowed rates.
        Algorithms no longer targeted (operator retarget) get their
        collectors and gauges RETIRED, not left walking histograms at
        1 Hz forever with frozen burn gauges misleading dashboards."""
        from .slo import SERIES, SLO

        current = {t.algorithm for t in targets}
        fresh, stale = [], []
        with self._lock:
            _san_note(self._san_tracker, True)
            for t in targets:
                # new algorithm OR retargeted threshold: the closures
                # judge breaches against the captured threshold, so a
                # tightened target must replace them or the windowed
                # burns keep reading the OLD target until restart (the
                # first window spanning the swap differences totals from
                # two thresholds — one transient sample, clamped ≥ 0)
                if self._registered.get(t.algorithm) != t.threshold_s:
                    self._registered[t.algorithm] = t.threshold_s
                    fresh.append(t)
            for alg in set(self._registered) - current:
                del self._registered[alg]
                self._last_grades.pop(alg, None)
                stale.append(alg)
        for t in fresh:     # ring registration takes the RING's lock —
            alg, thr = t.algorithm, t.threshold_s   # outside ours

            def _obs(alg=alg, thr=thr):
                return float(SLO.totals_below(alg, "e2e", thr)[0])

            def _bad(alg=alg, thr=thr):
                total, good = SLO.totals_below(alg, "e2e", thr)
                return float(total - good)

            SERIES.register(f"slo_obs_{alg}_total", _obs)
            SERIES.register(f"slo_bad_{alg}_total", _bad)
        for alg in stale:
            _retire(alg)

    # ---- evaluation ----

    def evaluate(self, now: float | None = None,
                 rows: list | None = None) -> dict:
        """The full budget judgment: per-target cumulative + windowed
        burns, per-target and overall grades. ``now``/``rows`` are
        injectable for the burn-math tests; production callers pass
        nothing and get the live ring — those LIVE evaluations are
        cached for ``EVAL_CACHE_S`` (keyed on the knob env, so operator
        retargets take effect immediately): health probes, peer scrapes
        and advisor ticks share one pass per second."""
        from .slo import SERIES, SLO

        live = now is None and rows is None
        env_key = tuple(os.environ.get(k) for k in
                        ("RTPU_SLO_TARGET", "RTPU_HEALTH_STRICT",
                         "RTPU_BUDGET_FAST_S", "RTPU_BUDGET_SLOW_S"))
        if live:
            with self._lock:
                cached = self._cache
            if cached is not None and cached[0] == env_key and \
                    time.monotonic() - cached[1] < EVAL_CACHE_S:
                return cached[2]
        targets, errors = parse_targets()
        self._ensure_collectors(targets)
        if rows is None:
            rows = SERIES.rows()
        if now is None:
            now = time.time()
        fast_s, slow_s = fast_window_s(), slow_window_s()
        out_targets = []
        transitions = []
        grade = "ok"
        m = _metrics()
        for t in targets:
            row, t_grade, eff_fast, eff_slow = judge_target(
                t, rows, now, fast_s, slow_s,
                lambda alg, thr: SLO.totals_below(alg, "e2e", thr))
            if _GRADE_ORDER[t_grade] > _GRADE_ORDER[grade]:
                grade = t_grade
            out_targets.append(row)
            if m is not None:
                m.slo_burn_rate.labels(t.algorithm, "fast").set(eff_fast)
                m.slo_burn_rate.labels(t.algorithm, "slow").set(eff_slow)
                m.slo_budget_remaining.labels(t.algorithm).set(
                    row["budget_remaining"])
            with self._lock:
                prev = self._last_grades.get(t.algorithm, "ok")
                self._last_grades[t.algorithm] = t_grade
            if _GRADE_ORDER[t_grade] > _GRADE_ORDER[prev]:
                transitions.append((t.algorithm, prev, t_grade, row))
        with self._lock:
            _san_note(self._san_tracker, True)
            self.evaluations += 1
        for alg, prev, cur, row in transitions:   # instants outside locks
            TRACER.instant("budget.burn", algorithm=alg, grade=cur,
                           previous=prev, fast_burn=row["fast_burn"],
                           slow_burn=row["slow_burn"],
                           cumulative_burn=row["cumulative_burn"])
        result = {"targets": out_targets, "errors": errors,
                  "grade": grade, "strict": health_strict(),
                  "windows_seconds": {"fast": fast_s, "slow": slow_s}}
        if live:
            with self._lock:
                self._cache = (env_key, time.monotonic(), result)
        return result

    def grade(self) -> str:
        return self.evaluate()["grade"]

    def status_block(self) -> dict:
        """The compact ``budget`` block /statusz embeds (and /clusterz
        federates): grade + one row per target, no ring rows."""
        ev = self.evaluate()
        return {"grade": ev["grade"], "errors": ev["errors"],
                "targets": {t["algorithm"]: {
                    "grade": t["grade"],
                    "budget_remaining": t["budget_remaining"],
                    "fast_burn": t["fast_burn"],
                    "slow_burn": t["slow_burn"],
                } for t in ev["targets"]}}

    def clear(self) -> None:
        with self._lock:
            registered = list(self._registered)
            self._last_grades.clear()
            self._registered.clear()
            self._cache = None
            self.evaluations = 0
        for alg in registered:   # ring + gauge teardown outside our lock
            _retire(alg)


#: the process singleton /healthz and the advisor evaluate through
BUDGET = BudgetRegistry()


def healthz() -> tuple[int, dict]:
    """``(http_status, payload)`` for ``GET /healthz``: the liveness
    answer graded from the error-budget state — latency budgets (this
    module) joined with the staleness budgets (obs/freshness.py,
    ``RTPU_FRESH_TARGET``); the worse grade wins. 503 ONLY when the
    joined grade is burning AND ``RTPU_HEALTH_STRICT=1`` — the default
    keeps the pre-budget contract (always 200, grade in the body) so
    existing probes never flap on an operator's first target."""
    ev = BUDGET.evaluate()
    grade = ev["grade"]
    payload = {"status": grade, "strict": ev["strict"],
               "targets": ev["targets"]}
    if ev["errors"]:
        payload["target_errors"] = ev["errors"]
    try:   # lazy + tolerant: a freshness-plane bug must not take the
        from .freshness import FRESH   # liveness probe down

        fr = FRESH.budget_evaluate()
    except Exception:
        fr = None
    if fr is not None and (fr["targets"] or fr["errors"]):
        payload["freshness"] = fr["targets"]
        if fr["errors"]:
            payload["freshness_target_errors"] = fr["errors"]
        if _GRADE_ORDER[fr["grade"]] > _GRADE_ORDER[grade]:
            grade = fr["grade"]
            payload["status"] = grade
    try:   # same lazy-join contract as freshness: the resilience plane
        from ..resilience.degrade import DEGRADED   # must not kill probes

        recent = DEGRADED.recent(fast_window_s())
    except Exception:
        recent = 0
    if recent:
        # partial answers served inside the fast window: the process is
        # up but shedding coverage — at most "degraded" (a breaker doing
        # its job is not a 503-worthy burn; sustained latency/staleness
        # breaches still grade "burning" through their own budgets)
        payload["degraded_results_recent"] = recent
        if _GRADE_ORDER[grade] < _GRADE_ORDER["degraded"]:
            grade = "degraded"
            payload["status"] = grade
    code = 503 if grade == "burning" and ev["strict"] else 200
    return code, payload
