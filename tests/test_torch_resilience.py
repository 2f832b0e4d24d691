"""The port's ``resilience/`` against the JAX package's: the same
sequences of calls through circuit breakers, retry policies, failpoints
and the degraded-results ledger, under one injected clock and seeded
randomness, give the same transitions, decisions and documents."""

import random

import numpy as np
import pytest

import raphtory_tpu.resilience.breaker as j_breaker
import raphtory_tpu.resilience.degrade as j_degrade
import raphtory_tpu.resilience.faults as j_faults
import raphtory_tpu.resilience.policy as j_policy
import raphtory_tpu_torch.resilience.breaker as p_breaker
import raphtory_tpu_torch.resilience.degrade as p_degrade
import raphtory_tpu_torch.resilience.faults as p_faults
import raphtory_tpu_torch.resilience.policy as p_policy

REF = (j_breaker, j_degrade, j_faults, j_policy)
PORT = (p_breaker, p_degrade, p_faults, p_policy)


class Clock:
    def __init__(self):
        self.t = 1000.0

    def __call__(self):
        return self.t


def _script(seed=4, n=120):
    rng = np.random.default_rng(seed)
    return [(float(rng.exponential(1.5)), bool(rng.random() < 0.55))
            for _ in range(n)]


@pytest.mark.parametrize("threshold,window", [(3, 10.0), (1, 2.5)])
def test_breaker_transitions_equal(threshold, window):
    script = _script()

    def drive(breaker_mod):
        clock = Clock()
        b = breaker_mod.CircuitBreaker("peer-1", threshold=threshold,
                                       window_s=window, clock=clock)
        trail = []
        for dt, ok in script:
            clock.t += dt
            allowed = b.allow()
            if allowed:
                b.record(ok, "" if ok else "UNAVAILABLE: peer down")
            trail.append((allowed, b.state(), b.snapshot()))
        return trail

    want, got = drive(j_breaker), drive(p_breaker)
    assert got == want
    assert {s for _, s, _ in want} >= {"closed", "open"}


def test_breaker_registry_snapshots_equal(monkeypatch):
    def drive(breaker_mod):
        reg = breaker_mod.BreakerRegistry(cap=4)
        clock = Clock()
        for i in range(6):
            b = reg.get(f"p{i}", threshold=2, window_s=5.0, clock=clock)
            for _ in range(i % 3):
                if b.allow():
                    b.record(False, "DEADLINE_EXCEEDED")
        return reg.snapshot()

    assert drive(p_breaker) == drive(j_breaker)


class Transient(Exception):
    pass


@pytest.mark.parametrize("fails,attempts,deadline", [
    (2, 4, None), (5, 3, None), (3, 5, 4.0), (0, 2, None)])
def test_retry_policy_decisions_equal(monkeypatch, fails, attempts,
                                      deadline):
    def drive(policy_mod):
        slept, retries, calls = [], [], [0]
        monkeypatch.setattr(policy_mod.time, "sleep", slept.append)
        clock = Clock()

        def fn():
            calls[0] += 1
            clock.t += 0.5
            if calls[0] <= fails:
                raise Transient("UNAVAILABLE: link reset")
            return calls[0]

        pol = policy_mod.RetryPolicy(
            attempts=attempts, base_s=0.5, cap_s=2.0,
            classify=lambda e: policy_mod.is_transient_message(str(e))
            is True, rng=random.Random(7))
        try:
            out = pol.run(fn, site="transfer.wire",
                          deadline=None if deadline is None
                          else clock.t + deadline, clock=clock,
                          on_retry=lambda a, e, w: retries.append(
                              (a, str(e), round(w, 12))))
        except Transient as e:
            out = f"raised: {e}"
        return out, calls[0], [round(s, 12) for s in slept], retries

    assert drive(p_policy) == drive(j_policy)


def test_transient_classifiers_equal():
    msgs = ["UNAVAILABLE: socket closed", "DEADLINE_EXCEEDED", "ValueError",
            "INVALID_ARGUMENT: shape", "connection reset by peer", ""]
    for m in msgs:
        assert p_policy.is_transient_message(m) == \
            j_policy.is_transient_message(m)
        for exc in (RuntimeError(m), TimeoutError(m), ValueError(m)):
            assert p_policy.default_classify(exc) == \
                j_policy.default_classify(exc)


def test_failpoints_inject_the_same_sequence(monkeypatch):
    spec = ("transfer.wire=error:0.35:4:42,sched.dispatch=error:1.0:2,"
            "rest.handler=slow:0.5,bogus.site=error:1.0")

    def drive(faults_mod, breaker_mod, degrade_mod):
        monkeypatch.setattr(faults_mod.time, "sleep", lambda s: None)
        try:
            armed = faults_mod.arm(spec)
            trail = []
            for i in range(30):
                for site in ("transfer.wire", "sched.dispatch",
                             "rest.handler", "device.dispatch"):
                    try:
                        faults_mod.fire(site)
                        trail.append((i, site, "pass"))
                    except faults_mod.FaultError as e:
                        trail.append((i, site, str(e)))
            doc = faults_mod.faultz()
        finally:
            faults_mod.disarm()
        doc["degraded"] = {}
        return sorted(armed), trail, doc, faults_mod.faultz()["enabled"]

    want = drive(j_faults, j_breaker, j_degrade)
    got = drive(p_faults, p_breaker, p_degrade)
    assert got == want
    assert any("injected fault at sched.dispatch" in t[2] for t in want[1])


def test_degraded_ledger_notes_equal():
    def drive(degrade_mod):
        clock = Clock()
        led = degrade_mod.DegradedLedger(ring=4, clock=clock)
        out = []
        for i, reason in enumerate(("deadline", "retry_budget") * 4):
            clock.t += 3.0
            led.note(f"job{i}", reason, covered_time=100 * i)
            out.append((led.recent(7.0), led.total(), led.snapshot()))
        return out

    assert drive(p_degrade) == drive(j_degrade)
