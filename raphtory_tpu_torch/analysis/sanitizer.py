"""The sanitizer's hooks, with the reference's signatures
(``raphtory_tpu/analysis/sanitizer.py``), doing nothing.

The serving stack's shared structures register with the lockset sanitizer
(``track_shared``) and report each access (``note_shared``); the mesh
engines ask for the mesh sanitizer (``mesh_active``) and note their
dispatches and barrier waits. In the port no sanitizer is installed yet:
``track_shared`` and ``mesh_active`` return None, so every call site takes
the reference's unsanitized path (one falsy check), and the module-level
``note_dispatch`` / ``barrier_watch`` return nothing.
"""

from __future__ import annotations


def note_shared(tracker, write: bool = False) -> None:
    """One access to a registered structure (no sanitizer: nothing)."""


def track_shared(name: str):
    """Register ``name`` with the active sanitizer: None, none is."""
    return None


def mesh_active():
    """The installed mesh sanitizer: None, none is."""
    return None


def note_dispatch(site: str, route: str, shape_sig: str,
                  dtype: str) -> None:
    """One mesh dispatch's fingerprint (no mesh sanitizer: nothing)."""


def barrier_watch(site: str, route: str):
    """Arm a stall watchdog for a barrier wait: None, the watchdog is
    off."""
    return None
