"""Windowed feature aggregation over a device-resident sweep.

The port of ``raphtory_tpu/engine/features.py``: a GNN-style mean
aggregation of F-wide vertex feature rows over the temporal window — the
"embedding over a temporal window" workload the reference cannot express
(its analysers push scalars through actor mailboxes,
``Analyser.scala:30-63``), where every edge moves a whole feature row.

``FeatureAggregator`` works on a ``DeviceSweep``'s resident fold state:
the window mask ``alive & latest >= T - W`` is computed inside the kernel
from the resident ``(e_lat, e_alive)`` buffers, nothing ships per call
but the sweep's own deltas. Each round is one launch of K10
(``ops/features.propagate_round``) over the destination CSR or, where the
reference bins (``_pcpm_layout``), one of K10-P over the
destination-binned layout's walk (``propagate_round_binned``). Storage is
float32 or bfloat16, accumulation float32.
"""

from __future__ import annotations

import os

import torch

from ..ops import partition as _partition
from ..ops.features import (propagate_round, propagate_round_binned,
                            window_bound)
from .device_sweep import DeviceSweep

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


class FeatureAggregator:
    """GNN-style windowed mean aggregation over a device-resident sweep.

    ``propagate(X, T, window, rounds)`` advances the sweep to T and returns
    the propagated ``[n_pad, F]`` features on the sweep's device, in the
    storage dtype. Rows are the sweep's global dense vertex space
    (``ds.uv``)."""

    def __init__(self, ds: DeviceSweep, feature_dim: int = 128,
                 chunk: int = 1 << 22, self_weight: float = 0.5,
                 dtype: str = "float32"):
        self.ds = ds
        self.F = int(feature_dim)
        # the twins' edge chunk must divide m_pad; shrink for small graphs
        self.chunk = min(chunk, ds.m_pad)
        while ds.m_pad % self.chunk:
            self.chunk //= 2
        self.self_weight = float(self_weight)
        if dtype not in _DTYPES:
            raise ValueError(f"feature dtype {dtype!r}: use one of "
                             f"{sorted(_DTYPES)}")
        self.dtype = _DTYPES[dtype]
        # the sweep's host edge tables, for the partition-layout build (no
        # device round trip: the port keeps them)
        self._host_tables = None
        #: the spec the LAST propagate dispatched with (None = unbinned)
        self._active_spec = None

    def _pcpm_layout(self):
        """Resolved partition layout, or None — the reference's gate
        (``raphtory_tpu/engine/features.py:167-192``): ``RTPU_PCPM`` (read
        here, at dispatch), a layout that pre-aggregates, and per-partition
        ``[cap, F]`` and ``[cap_u, F]`` f32 tiles within
        ``tile_budget_bytes()``."""
        ds = self.ds
        if not _partition.pcpm_enabled(ds.m_pad,
                                       os.environ.get("RTPU_PCPM", "auto")):
            return None
        if self._host_tables is None:
            t = ds.tables
            self._host_tables = _partition.HostTables(t.e_src, t.e_dst,
                                                      ds.n_pad, ds.m)
        budget = _partition.tile_budget_bytes()
        lay = _partition.resolve(ds, self._host_tables, budget)
        if lay is None or not lay.spec.preagg \
                or lay.spec.cap * self.F * 4 > budget \
                or lay.spec.cap_u * self.F * 4 > budget:
            return None
        return lay

    def random_features(self, seed: int = 0, generator=None):
        """Unit-norm random rows ``[n_pad, F]`` in the storage dtype on the
        sweep's device, drawn on the host from a ``torch.Generator`` seeded
        with ``seed`` (or ``generator``). The reference draws from
        ``jax.random``, whose bits cannot be reproduced: comparisons with
        it feed both the same ``X``."""
        if generator is None:
            generator = torch.Generator().manual_seed(int(seed))
        X = torch.randn((self.ds.n_pad, self.F), generator=generator,
                        dtype=torch.float32)
        X = X / torch.linalg.norm(X, dim=1, keepdim=True)
        return X.to(self.dtype).to(self.ds.device)

    def propagate(self, X, time: int | None = None, *,
                  window: int | None = None, rounds: int = 2):
        """``rounds`` rounds from ``X [n_pad, F]`` (any float tensor or
        array; cast to the storage dtype first, as the reference does) at
        ``time`` (advancing the sweep) over the window (None: none)."""
        ds = self.ds
        if time is not None:
            ds.advance(time)
        if ds.t_now is None:
            raise ValueError("advance the sweep (or pass time=) first")
        layout = self._pcpm_layout()
        self._active_spec = None if layout is None else layout.spec
        e_lat, e_alive = ds.edge_state
        lo, nowin = window_bound(ds.t_now, -1 if window is None
                                 else int(window), e_lat.dtype)
        H = torch.as_tensor(X).to(device=ds.device, dtype=self.dtype)
        if tuple(H.shape) != (ds.n_pad, self.F):
            raise ValueError(f"X has shape {tuple(H.shape)}, want "
                             f"({ds.n_pad}, {self.F})")
        H = H.contiguous()
        if layout is not None:
            be = layout.device_edges(ds.device)
            for _ in range(int(rounds)):
                H = propagate_round_binned(H, be, e_lat, e_alive, lo, nowin,
                                           self.self_weight, self.chunk)
        else:
            for _ in range(int(rounds)):
                H = propagate_round(H, ds.edges, e_lat, e_alive, lo, nowin,
                                    self.self_weight, self.chunk)
        return H

    def traffic_bytes(self, rounds: int) -> int:
        """Approximate device-memory bytes per propagate call, with the
        reference's formula (``features.py:225-248``) for the mode the
        LAST propagate dispatched in: per round the edge axis gathers an
        F-row and writes it once into the accumulator, plus index and mask
        columns; the masked-degree pass counted once a call; on the binned
        route the gather shrinks to one row per (partition, source)
        bucket."""
        fb = self.dtype.itemsize
        per_edge = self.F * (fb + 4) + 2 * 4 + 1
        per_vertex = self.F * (2 * 4 + fb)
        s = self._active_spec
        if s is not None:
            B = s.partitions * s.cap
            u_rows = s.partitions * s.cap_u
            deg_pass = B * (4 + 1)
            per_round = (u_rows * self.F * fb
                         + B * (self.F * (fb + 4) + 4 + 1)
                         + self.ds.n_pad * per_vertex)
            return deg_pass + rounds * per_round
        deg_pass = self.ds.m_pad * (4 + 1)
        return deg_pass + rounds * (self.ds.m_pad * per_edge
                                    + self.ds.n_pad * per_vertex)

    def flops(self, rounds: int) -> int:
        """Adds/multiplies per propagate call (mean-aggregate + mix + norm),
        the reference's count (``features.py:250-254``)."""
        return rounds * (self.ds.m_pad * self.F
                         + self.ds.n_pad * self.F * 6)
