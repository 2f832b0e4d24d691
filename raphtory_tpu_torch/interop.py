"""State carried across from the JAX package: its event log and programs.

The system holds no weights; what a ``raphtory_tpu`` deployment holds is its
event log. These helpers build the port's objects from plain numpy arrays
and dataclass fields, so nothing here imports the JAX package.
"""

from __future__ import annotations

import numpy as np

from .algorithms import PageRank
from .core.events import EventLog

_PROGRAMS = {"PageRank": PageRank}


def event_log_from_arrays(cols: dict[str, np.ndarray],
                          props=None) -> EventLog:
    """The port's ``EventLog`` from the numpy columns of an
    ``EventLog.arrays()`` (``time``, ``kind``, ``src``, ``dst``). ``props``
    is an optional list of ``(row, {key: value})`` property payloads, the
    ``append_batch`` convention (a ``"!key"`` marks an immutable key)."""
    log = EventLog()
    log.append_batch(np.asarray(cols["time"]), np.asarray(cols["kind"]),
                     np.asarray(cols["src"]), np.asarray(cols["dst"]),
                     props=props)
    return log


def program_from_params(name: str, **hyper):
    """The port's vertex program ``name`` with the JAX program's dataclass
    fields as hyperparameters (``dataclasses.asdict(program)``)."""
    cls = _PROGRAMS.get(name)
    if cls is None:
        raise NotImplementedError(
            f"program {name!r} is not ported yet: this slice carries "
            f"{sorted(_PROGRAMS)}; the generic vertex-program engine and the "
            "other algorithms are ROADMAP queue 1 item 4")
    return cls(**hyper)
