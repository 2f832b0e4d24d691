"""State carried across from the JAX package: its event log and programs.

The system holds no weights; what a ``raphtory_tpu`` deployment holds is its
event log. These helpers build the port's objects from plain numpy arrays
and dataclass fields, so nothing here imports the JAX package.
"""

from __future__ import annotations

import numpy as np

from .algorithms import (BFS, SSSP, BinaryDiffusion, ConnectedComponents,
                         DegreeBasic, DegreeRanking, Density, FlowGraph,
                         LabelPropagation, PageRank, StarNode, TaintTracking)
from .core.events import EventLog

_PROGRAMS = {"PageRank": PageRank, "ConnectedComponents": ConnectedComponents,
             "SSSP": SSSP, "BFS": BFS, "DegreeBasic": DegreeBasic,
             "LabelPropagation": LabelPropagation,
             "TaintTracking": TaintTracking, "DegreeRanking": DegreeRanking,
             "StarNode": StarNode, "Density": Density,
             "FlowGraph": FlowGraph, "BinaryDiffusion": BinaryDiffusion}


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


def numeric_prop_payloads(props) -> list:
    """The numeric property rows of an event log's property store (the
    ``props`` of either package's ``EventLog``: columns ``event``, ``key``,
    ``tag`` and ``num``, plus ``key_name``/``is_immutable``/``NUM_TAG``) as
    the ``(row, {key: value})`` payloads ``event_log_from_arrays`` takes,
    one per run of rows on the same event, in row order; an immutable key
    keeps its ``"!"`` mark. String values are left out."""
    num = props.column("tag") == props.NUM_TAG
    events = props.column("event")[num]
    keys = props.column("key")[num]
    vals = props.column("num")[num]
    names = {int(k): ("!" if props.is_immutable(int(k)) else "")
             + props.key_name(int(k)) for k in np.unique(keys)}
    out = []
    for ev, k, v in zip(events.tolist(), keys.tolist(), vals.tolist()):
        if out and out[-1][0] == ev and names[k] not in out[-1][1]:
            out[-1][1][names[k]] = v
        else:
            out.append((ev, {names[k]: v}))
    return out


def program_from_params(name: str, **hyper):
    """The port's vertex program ``name`` with the JAX program's dataclass
    fields as hyperparameters (``dataclasses.asdict(program)``)."""
    cls = _PROGRAMS.get(name)
    if cls is None:
        raise KeyError(
            f"unknown program {name!r}: the port carries every program of "
            f"the reference's library, {sorted(_PROGRAMS)}")
    return cls(**hyper)
