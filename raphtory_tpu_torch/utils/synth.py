"""Synthetic temporal-graph workload generators.

The parity target is the reference's ``RandomSpout`` stress workload
(``examples/random/actors/RandomSpout.scala:27-59``: rate-controlled mix of
30% vertex adds / 70% edge adds over a bounded ID pool, the paper's §6.1
benchmark definition) plus a GAB-like social graph (preferential attachment →
heavy-tailed degrees, timestamped over a long span) standing in for the
README's demo dataset in zero-egress environments. Same seeds, same arrays
as the JAX package's generators.
"""

from __future__ import annotations

import numpy as np

from ..core.events import EDGE_ADD, EDGE_DELETE, VERTEX_ADD, VERTEX_DELETE, EventLog


def random_update_stream(
    n_events: int,
    id_pool: int = 1_000_000,
    seed: int = 0,
    t_start: int = 0,
    t_end: int | None = None,
    mix=(0.3, 0.7, 0.0, 0.0),  # (vertex add, edge add, vertex del, edge del)
):
    """The paper's workload: add-only default mix 30/70; 'worst case' is
    (0.3, 0.4, 0.1, 0.2). Returns columnar arrays ready for
    ``EventLog.append_batch``."""
    rng = np.random.default_rng(seed)
    t_end = t_end if t_end is not None else n_events
    kinds_choice = rng.choice(4, size=n_events, p=list(mix))
    kind_map = np.array([VERTEX_ADD, EDGE_ADD, VERTEX_DELETE, EDGE_DELETE])
    kinds = kind_map[kinds_choice].astype(np.uint8)
    times = np.sort(rng.integers(t_start, t_end, n_events)).astype(np.int64)
    src = rng.integers(0, id_pool, n_events).astype(np.int64)
    dst = rng.integers(0, id_pool, n_events).astype(np.int64)
    dst[(kinds == VERTEX_ADD) | (kinds == VERTEX_DELETE)] = -1
    return times, kinds, src, dst


def gab_like_arrays(
    n_vertices: int = 30_000,
    n_edges: int = 300_000,
    seed: int = 7,
    t_span: int = 2_600_000,
):
    """(src, dst, times) arrays of the GAB-style preferential-attachment
    stream."""
    rng = np.random.default_rng(seed)
    # preferential attachment via repeated-endpoint sampling trick: draw dst
    # from previously used endpoints with prob p, else uniform
    src = rng.integers(0, n_vertices, n_edges).astype(np.int64)
    dst = np.empty(n_edges, np.int64)
    pool = rng.integers(0, n_vertices, n_edges)  # fallback uniform draws
    reuse = rng.random(n_edges) < 0.6
    # vectorised approximation: reuse samples index into earlier positions
    earlier = (rng.random(n_edges) * np.maximum(np.arange(n_edges), 1)).astype(np.int64)
    dst[~reuse] = pool[~reuse]
    dst[reuse] = src[earlier[reuse]]
    times = np.sort(rng.integers(0, t_span, n_edges)).astype(np.int64)
    return src, dst, times


def gab_like_log(
    n_vertices: int = 30_000,
    n_edges: int = 300_000,
    seed: int = 7,
    t_span: int = 2_600_000,  # ~a month of seconds
) -> EventLog:
    """GAB-style social graph: preferential attachment (heavy-tailed in-degree,
    one giant component ~ the README demo's 22k-vertex biggest cluster),
    timestamps spread over the span so windowed views are non-trivial."""
    src, dst, times = gab_like_arrays(n_vertices, n_edges, seed, t_span)
    kinds = np.full(n_edges, EDGE_ADD, np.uint8)
    log = EventLog()
    log.append_batch(times, kinds, src, dst)
    return log


def twitter_like_log(
    n_vertices: int = 5_300_000,
    n_edges: int = 100_000_000,
    seed: int = 11,
    t_span: int = 2_600_000,
) -> EventLog:
    """Twitter-2010-class synthetic follow graph (the BASELINE.md scale
    config shape): tens of millions of preferential-attachment edges over a
    month of timestamps. Same generator as ``gab_like_log`` at a scale where
    the vertex state stops fitting any host cache."""
    return gab_like_log(n_vertices=n_vertices, n_edges=n_edges, seed=seed,
                        t_span=t_span)
