"""BinaryDiffusion — randomised infection spread.

Capability parity with ``raphtory_tpu/algorithms/diffusion.py``
(``core/analysis/Algorithms/BinaryDefusion.scala``, sic): a seed vertex is
infected; each superstep every infected vertex infects a random subset of
its out-neighbours, until nothing changes. The randomness is
counter-based, an integer hash of the edge's endpoints, the superstep and
the seed, so a rerun reproduces exactly and every window of a batch draws
the same coins. The combine is ``max`` on int32 (K7 / K7-P).

The reference hashes in uint32. Torch has no full uint32 arithmetic, so
the hash runs in int64 on values below 2^32: every multiply keeps the low
32 bits of the product (``_mul32``, in halves so no int64 product
overflows) and every xor and shift acts on such values, which makes each
``>>`` a logical shift. The coin ``f32(h) / 2^32 < p`` rounds the int64
value to f32 as the reference rounds the uint32 one.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..engine.program import Context, Edges, VertexProgram
from .traversal import _member

_M32 = 0xFFFFFFFF
_I64_MAX = int(np.iinfo(np.int64).max)


def _mul32(x: torch.Tensor, c: int) -> torch.Tensor:
    """``(x * c) mod 2^32`` for int64 ``x`` in ``[0, 2^32)`` and a 32-bit
    constant ``c``: the product of each 16-bit half stays below 2^48."""
    lo = (x & 0xFFFF) * c
    hi = ((x >> 16) * c) & 0xFFFF
    return (lo + (hi << 16)) & _M32


def edge_hash(src: torch.Tensor, dst: torch.Tensor, step: int,
              seed: int) -> torch.Tensor:
    """The reference's uint32 coin hash of ``(src, dst, step, seed)`` as
    int64 values in ``[0, 2^32)`` (``raphtory_tpu/algorithms/
    diffusion.py:53-60``); ``src`` / ``dst`` are cast to uint32 there, so
    a negative index wraps the same way here."""
    s = src.to(torch.int64) & _M32
    d = dst.to(torch.int64) & _M32
    c = (((int(step) + int(seed)) & _M32) * 0xC2B2AE3D) & _M32
    h = _mul32(s, 0x9E3779B1) ^ _mul32(d, 0x85EBCA77) ^ c
    h = h ^ (h >> 15)
    h = _mul32(h, 0x2C1B3C6D)
    h = h ^ (h >> 12)
    h = _mul32(h, 0x297A2D39)
    return h ^ (h >> 15)


@dataclass(frozen=True)
class BinaryDiffusion(VertexProgram):
    seeds: tuple = ()          # empty -> the vertex with the min global id
    seed: int = 42             # the coin stream
    spread_prob: float = 0.5
    max_steps: int = 50
    combiner = "max"
    direction = "out"
    needs_vertex_times = False
    needs_edge_times = False

    def init(self, ctx: Context):
        if self.seeds:
            infected = _member(ctx.vids, self.seeds)
        else:
            masked = torch.where(ctx.v_mask, ctx.vids, _I64_MAX)
            global_min = torch.amin(masked, dim=-1, keepdim=True)
            if ctx.axis is not None:
                global_min = ctx.axis.all_reduce(global_min, "min")
            infected = ctx.vids == global_min
        return (infected & ctx.v_mask).to(torch.int32)

    def message(self, src_state, edge: Edges):
        # a counter-based coin per (edge endpoints, superstep, seed), not a
        # draw over the array's shape: the engine lays the window batch out
        # flat (k*m), and position-based draws would give each window
        # other coins
        h = edge_hash(edge.src, edge.dst, edge.step, self.seed)
        p = torch.tensor(self.spread_prob, dtype=torch.float32,
                         device=h.device)
        coin = (h.to(torch.float32) / 2.0 ** 32) < p
        return torch.where(coin, src_state, 0)

    def update(self, state, agg, ctx: Context):
        new = torch.maximum(state, agg)
        new = torch.where(ctx.v_mask, new, 0)
        return new, new == state

    def finalize(self, state, ctx: Context):
        return state

    def reduce(self, result, view, window=None):
        inf = np.asarray(result)
        mask = np.asarray(view.v_mask)
        return {
            "infected": int(inf[mask].sum()),
            "fraction": float(inf[mask].sum() / max(mask.sum(), 1)),
        }
