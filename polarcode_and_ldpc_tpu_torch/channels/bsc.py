"""Binary symmetric channel: each bit flips with probability ``p``.

The flips are keyed draws (``core.rng.bernoulli``): one key per frame, or one
key for a whole tensor, as ``AWGNChannel`` draws its noise.  ``bsc_llr`` turns
the received bits into ±log((1 − p)/p) LLRs so the soft decoders can take
them.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from ..core import rng
from ..core.device import resolve_device

# the LLR magnitude of a degenerate channel (p = 0 or 1), the BP decoders'
# saturation
_SAT = 20.0


def bsc_transmit(key, bits, crossover_prob: float, x64: bool = False):
    """Flip each bit independently with probability ``crossover_prob``.

    ``key``: keys ``[..., 2]`` whose leading axes match ``bits``' leading
    axes (one key per frame), or one key ``[2]`` for the whole tensor.
    ``x64`` draws the uniforms in float64, as ``jax.random.bernoulli`` does
    under ``jax_enable_x64``; the two give other flips from the same key.
    """
    bits = torch.as_tensor(bits).to(torch.int8)
    key = torch.as_tensor(key, device=bits.device)
    flips = rng.draw(lambda k, n: rng.bernoulli(k, crossover_prob, n, x64), key, bits.shape)
    return torch.where(flips, 1 - bits, bits)


def bsc_llr(bits, crossover_prob: float, dtype=torch.float32):
    """LLR of a received bit: log((1 − p)/p) for a 0, −log((1 − p)/p) for a 1.

    The magnitude saturates at ±20, so ``p ∈ {0, 1}`` gives finite LLRs; at
    ``p = 0.5`` it is 0, and a received 1 gives −0.0.
    """
    if crossover_prob <= 0.0 or crossover_prob >= 1.0:
        mag = -_SAT if crossover_prob >= 1.0 else _SAT
    else:
        mag = min(max(math.log((1.0 - crossover_prob) / crossover_prob), -_SAT), _SAT)
    return (1.0 - 2.0 * torch.as_tensor(bits).to(dtype)) * mag


class BSCChannel:
    """Class wrapper with explicit-key randomness: every ``transmit`` without
    a key consumes a fresh split of the channel's own key, and draws the
    batch as one flat stream from it."""

    def __init__(self, crossover_prob: float, seed: Optional[int] = None, device="cuda"):
        assert 0.0 <= crossover_prob <= 1.0, "crossover probability must be in [0, 1]"
        self.crossover_prob = crossover_prob
        self.device = resolve_device(device)
        self._key = rng.prng_key(0 if seed is None else seed, self.device)

    def transmit(self, bits, key=None, return_llr: bool = False):
        if key is None:
            self._key, key = rng.split(self._key)
        out = bsc_transmit(key, torch.as_tensor(bits, device=self.device), self.crossover_prob)
        return bsc_llr(out, self.crossover_prob) if return_llr else out

    def __repr__(self) -> str:
        return f"BSCChannel(crossover_prob={self.crossover_prob})"
