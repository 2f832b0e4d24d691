"""Shared exit-artifact writers — one atexit hook, one SIGTERM handler.

Six modules (trace, series, sample, device, sched, fault — plus the
freshness plane) grew copy-pasted ``RTPU_*_DUMP`` atexit blocks, and
only ``obs/trace.py`` bothered with the SIGTERM case — a wedged run
killed by ``timeout`` (CI's kill) skipped every OTHER module's dump.
This module is the single registry they all feed:

* ``register(name, fn)`` — ``fn()`` writes one artifact (it owns its
  path; failures are swallowed — an exit dump must never mask the real
  exit reason). Registration is idempotent by name.
* One ``atexit`` hook runs every writer, in registration order, with
  ``last=True`` writers (the journal's close/flush) at the end — the
  journal must drain AFTER other writers in case their work emits
  final records.
* One SIGTERM handler (installed with the obs/trace.py guards: main
  thread only, and only when SIGTERM is still ``SIG_DFL`` so a
  server's own shutdown handler always wins) runs the same writers,
  then restores the default disposition and re-kills — the exit code
  stays 143 and the CI failure artifacts survive the kill.

stdlib-only: ``obs.trace`` (and the standalone-loadable journal) import
this module, so it must carry no runtime deps.
"""

from __future__ import annotations

import atexit
import os
import signal
import threading

_LOCK = threading.Lock()
_WRITERS: dict[str, tuple] = {}     # name -> (fn, last)
_INSTALLED = False


def register(name: str, fn, last: bool = False) -> None:
    """Add (or replace) an exit writer. ``last=True`` writers run after
    every ordinary one — the journal close slot."""
    global _INSTALLED
    with _LOCK:
        _WRITERS[str(name)] = (fn, bool(last))
        if not _INSTALLED:
            _INSTALLED = True
            atexit.register(run_all)
            _install_sigterm()


def unregister(name: str) -> None:
    with _LOCK:
        _WRITERS.pop(str(name), None)


def registered() -> list[str]:
    with _LOCK:
        return list(_WRITERS)


def run_all() -> None:
    """Run every writer (ordinary first, ``last`` writers after), each
    inside its own try/except — one broken artifact must not cost the
    others. Idempotent by construction: writers overwrite their own
    files and the journal close is itself idempotent, so running at
    SIGTERM and again at atexit is safe."""
    with _LOCK:
        writers = list(_WRITERS.values())
    ordered = [fn for fn, last in writers if not last] \
        + [fn for fn, last in writers if last]
    for fn in ordered:
        try:
            fn()
        except Exception:
            pass


def _install_sigterm() -> None:
    """Dump-then-default SIGTERM, with the guards obs/trace.py
    established: only from the main thread, and only while nothing
    else has claimed the signal."""
    try:
        if (threading.current_thread() is not threading.main_thread()
                or signal.getsignal(signal.SIGTERM)
                is not signal.SIG_DFL):
            return

        def _on_term(signum, frame):
            run_all()
            signal.signal(signal.SIGTERM, signal.SIG_DFL)
            os.kill(os.getpid(), signal.SIGTERM)   # keep exit code 143

        signal.signal(signal.SIGTERM, _on_term)
    except Exception:
        pass
