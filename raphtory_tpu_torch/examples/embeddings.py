"""Temporal vertex embeddings — the port of
``raphtory_tpu/examples/embeddings.py``.

Unsupervised structural embeddings over a temporal window: random features
propagated through the windowed graph (``engine/features.py``, the
GraphSAGE-mean shape, K10 on the card), and the two queries people run on
embeddings: nearest neighbours and drift over time (how much a vertex's
neighbourhood changed between two windows).
"""

from __future__ import annotations

import numpy as np

from ..engine.device_sweep import DeviceSweep
from ..engine.features import FeatureAggregator


class TemporalEmbeddings:
    """Windowed structural embeddings over a pinned log, on ``device``
    (None: the CUDA card).

    Ascending query times ride one incremental device sweep; a backward
    query rebuilds the sweep (a full re-fold and re-upload: fine for
    exploration, expensive in a tight loop)."""

    def __init__(self, log, dim: int = 64, rounds: int = 2, seed: int = 0,
                 device=None):
        self._log = log
        self._dim = dim
        self._seed = seed
        self._device = device
        self.rounds = rounds
        self._fresh()

    def _fresh(self) -> None:
        self.ds = DeviceSweep(self._log, device=self._device)
        self.fa = FeatureAggregator(self.ds, feature_dim=self._dim)
        self._X = self.fa.random_features(seed=self._seed)

    def at(self, time: int, window: int | None = None) -> np.ndarray:
        """``[n, dim]`` embeddings at ``time`` (rows follow ``self.ds.uv``)."""
        if self.ds.t_now is not None and int(time) < self.ds.t_now:
            self._fresh()   # backward in history: rebuild the sweep
        H = self.fa.propagate(self._X, int(time), window=window,
                              rounds=self.rounds)
        return H.float().cpu().numpy()[: self.ds.n]

    def _window_alive(self, window: int | None) -> np.ndarray:
        """bool[n]: in-view (and in-window) vertices at the sweep's time —
        dead or not-yet-born vertices keep their random rows and must not
        pollute similarity rankings."""
        sw = self.ds.sw
        alive = sw.v_alive.copy()
        if window is not None:
            alive &= sw.v_lat >= self.ds.t_now - int(window)
        return alive

    def nearest(self, vid: int, time: int, window: int | None = None,
                k: int = 5) -> list[tuple[int, float]]:
        """``k`` most similar IN-WINDOW vertices to ``vid`` by cosine."""
        H = self.at(time, window)
        i = int(np.searchsorted(self.ds.uv, vid))
        if i >= len(self.ds.uv) or self.ds.uv[i] != vid:
            raise KeyError(f"unknown vertex {vid}")
        sims = H @ H[i]
        sims = np.where(self._window_alive(window), sims, -np.inf)
        order = np.argsort(-sims)
        out = []
        for j in order:
            if j != i and np.isfinite(sims[j]) and len(out) < k:
                out.append((int(self.ds.uv[j]), float(sims[j])))
        return out

    def drift(self, t0: int, t1: int, window: int) -> np.ndarray:
        """Per-vertex cosine distance between the [t0-window, t0] and
        [t1-window, t1] embeddings — large drift = the neighbourhood
        changed (ascending t0 <= t1; one incremental sweep)."""
        if t1 < t0:
            raise ValueError("drift requires t0 <= t1")
        H0 = self.at(t0, window)
        H1 = self.at(t1, window)
        sim = np.sum(H0 * H1, axis=1)
        return 1.0 - sim
