"""Unrolled recursive SC decoder — the plain PyTorch version of the
whole-decode SC kernel (``ops/sc_mega_cuda.py``).

True SC work is O(N log N); this module emits it directly by unrolling the SC
recursion into a static program over x-subchannel segments:

* the natural-order code (encoder stage 0 = adjacent pairs) decodes u-even
  indices through ``f(α[2i], α[2i+1])`` and u-odd through ``g`` — so each
  node deinterleaves its α, recurses on the even u-subcode, then the odd,
  and re-interleaves the partial sums;
* frozen structure is static, so constituent nodes collapse (Sarkis et al.,
  "Fast Polar Decoders: Algorithm and Implementation", JSAC 2014):
  **rate-0** (all frozen → β = 0) and **REP** (one trailing info bit →
  β = hard(Σα)) are exact equivalents of min-sum SC under all inputs and
  are always enabled; **rate-1** (no frozen → β = hard(α)) and **SPC** (one
  leading frozen bit → hard(α) + parity-fixing flip of the least-reliable
  position) are exact except on exact-zero LLRs / tied minimum magnitudes
  and are gated behind ``fast_nodes``.

The REP sum is written as the halving adds the g-chain performs (all partial
sums zero: ``α' = α_odd + α_even``), so this version and the kernel add in
one order and agree bit for bit.  SPC flips the *first* position of the
minimum magnitude in natural order, as ``argmin`` does.
"""

from __future__ import annotations

import numpy as np
import torch

from .encoder import polar_transform
from .trellis import f_minsum


def _hard(alpha: torch.Tensor) -> torch.Tensor:
    """Hard decision: llr ≥ 0 → 0."""
    return (alpha < 0).to(torch.int8)


def _rep_sum(alpha: torch.Tensor) -> torch.Tensor:
    """Σα over the last axis by halving adds, ``[..., M] → [..., 1]``."""
    while alpha.shape[-1] > 1:
        alpha = alpha[..., 1::2] + alpha[..., 0::2]
    return alpha


def make_sc_decoder_unrolled(N: int, frozen_mask: np.ndarray,
                             dtype=torch.float32, fast_nodes: bool = True):
    """Build the unrolled SC decoder.

    Returns ``decode(llr: [..., N]) -> u: [..., N] int8`` (natural order) on
    the device of ``llr``.
    """
    frozen_mask = np.asarray(frozen_mask, bool)
    assert frozen_mask.shape == (N,)

    def node(alpha, off: int, step: int, size: int):
        """Decode u indices {off + k·step, k < size}; α is the x-subchannel
        vector [..., size].  Returns β (re-encoded x bits) [..., size]."""
        sub = frozen_mask[off: off + size * step: step]
        n_frozen = int(sub.sum())
        if n_frozen == size:  # rate-0
            return torch.zeros(alpha.shape, dtype=torch.int8, device=alpha.device)
        if size == 1:  # info leaf
            return _hard(alpha)
        if n_frozen == size - 1 and not sub[-1]:  # REP
            return _hard(_rep_sum(alpha)).expand(alpha.shape)
        if fast_nodes and n_frozen == 0:  # rate-1: β = hard(α)
            return _hard(alpha)
        if fast_nodes and n_frozen == 1 and sub[0]:  # SPC (Wagner decode)
            bits = _hard(alpha)
            parity = (bits.sum(dim=-1, dtype=torch.int32) & 1).to(torch.int8)
            # first minimum: torch.min(dim) does not promise the first index
            # on ties, so rank (magnitude, position) pairs explicitly
            mag = alpha.abs()
            mmin = mag.min(dim=-1, keepdim=True).values
            iota = torch.arange(size, device=alpha.device)
            worst = torch.where(mag == mmin, iota, size).min(dim=-1, keepdim=True).values
            flip = (iota == worst).to(torch.int8) * parity[..., None]
            return bits ^ flip
        half = size // 2
        a_even, a_odd = alpha[..., 0::2], alpha[..., 1::2]
        beta_even = node(f_minsum(a_even, a_odd), off, 2 * step, half)
        sgn = 1.0 - 2.0 * beta_even.to(alpha.dtype)
        beta_odd = node(a_odd + sgn * a_even, off + step, 2 * step, half)
        # x[2i] = βe[i] ⊕ βo[i]; x[2i+1] = βo[i]
        return torch.stack([beta_even ^ beta_odd, beta_odd], dim=-1).reshape(
            *alpha.shape[:-1], size)

    def decode(llr):
        llr = torch.as_tensor(llr).to(dtype)
        beta = node(llr, 0, 1, N)
        # β is the re-encoded codeword; u = β·G (G its own inverse)
        return polar_transform(beta)

    return decode
