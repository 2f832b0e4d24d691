"""Algorithm registry — the reflection/runtime-compilation surface.

The reference resolves analysers by ``Class.forName`` and, failing that,
compiles Scala source shipped in the REST payload with a ToolBox
(``AnalysisManager.scala:192-213``, ``Analyser.scala:23-28``). Here:
a name registry for built-ins + plain-Python dynamic definitions ("dynamic
analyser" = a Python snippet defining ``program``), no compiler machinery.
"""

from __future__ import annotations

import threading

from ..engine.program import VertexProgram

_REGISTRY: dict[str, type] = {}
_REGISTRY_LOCK = threading.Lock()   # REST threads register dynamic
_BUILTINS_LOADED = False            # analysers while jobs resolve built-ins


def register(name: str | None = None):
    def deco(cls):
        with _REGISTRY_LOCK:
            _REGISTRY[name or cls.__name__] = cls
        return cls
    return deco


def names() -> list[str]:
    _ensure_builtins()
    with _REGISTRY_LOCK:
        return sorted(_REGISTRY)


def resolve(name: str, params: dict | None = None) -> VertexProgram:
    """Instantiate a registered program by name with hyperparams."""
    _ensure_builtins()
    with _REGISTRY_LOCK:
        cls = _REGISTRY.get(name)
        known = sorted(_REGISTRY)
    if cls is None:
        raise KeyError(
            f"unknown analyser {name!r}; registered: {known}")
    # REST params arrive as JSON, so sequence hyperparams (e.g. SSSP
    # seeds) come in as lists — programs must stay hashable (the
    # compiled-runner cache keys on them), so freeze them here
    params = {k: tuple(v) if isinstance(v, list) else v
              for k, v in (params or {}).items()}
    return cls(**params)


def compile_source(source: str) -> VertexProgram:
    """Dynamic analyser: exec Python source that binds ``program`` (the
    LoadExternalAnalyser capability — the reference accepts raw analyser
    source over REST, ``AnalysisRestApi`` rawFile field). Runs with full
    interpreter privileges, exactly like the reference's ToolBox compile;
    deployments that do not want this must not expose the REST port."""
    ns: dict = {}
    exec(source, ns)  # noqa: S102 — capability parity with reference
    prog = ns.get("program")
    if prog is None:
        raise ValueError("dynamic analyser source must define `program`")
    return prog


def _ensure_builtins() -> None:
    global _BUILTINS_LOADED
    if _BUILTINS_LOADED:   # benign racy fast-path; the slow path locks
        return
    from .. import algorithms as A   # import OUTSIDE the lock: an import

    with _REGISTRY_LOCK:             # that re-enters the registry (the
        if _BUILTINS_LOADED:         # @register decorators) must not
            return                   # deadlock against it
        for nm in A.__all__:
            # bounded by the builtin algorithm list (loaded once behind
            # _BUILTINS_LOADED); dynamic rawFile programs are instantiated
            # per request, never registered — the table cannot grow with
            # traffic.  # rtpulint: disable=unbounded-growth-on-request-path
            _REGISTRY.setdefault(nm, getattr(A, nm))
        _BUILTINS_LOADED = True
