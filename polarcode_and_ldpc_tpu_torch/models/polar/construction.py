"""Polar code construction (host-side NumPy, float64).

Code construction is a one-time, host-side computation whose output (a frozen
mask) is a *static* input to the decoders.  It stays NumPy float64 so the
frozen sets equal the JAX package's exactly.

Index convention: trellis stage *s* selects f/g by bit *s* of the u-index, so
the *first* channel split lives at the LSB.  The recursions here therefore
concatenate children block-wise (old index in the low bits).
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np


def bit_reverse_permutation(N: int) -> np.ndarray:
    """Vector of bit-reversed indices: ``perm[i] = bit_reverse(i, log2 N)``."""
    n = int(np.log2(N))
    idx = np.arange(N, dtype=np.int64)
    out = np.zeros(N, dtype=np.int64)
    for b in range(n):
        out |= ((idx >> b) & 1) << (n - 1 - b)
    return out


def bhattacharyya_bounds(N: int, snr_db: float) -> np.ndarray:
    """Bhattacharyya parameters Z for every bit channel: base channel
    Z = exp(−SNR_lin), recursion Z → (2Z−Z², Z²), each new split placed at
    the LSB of the index (children concatenated block-wise)."""
    n = int(np.log2(N))
    snr_linear = 10.0 ** (snr_db / 10.0)
    Z = np.array([np.exp(-snr_linear)], dtype=np.float64)
    for _ in range(n):
        bad = 2.0 * Z - Z * Z
        good = Z * Z
        Z = np.concatenate([bad, good])
    return Z


def gaussian_approximation(N: int, snr_db: float) -> np.ndarray:
    """Heuristic "Gaussian approximation": ×0.9 for the degraded child below
    saturation, ×2 capped at 100 for the upgraded child.  For a principled
    construction use :func:`dega_llr_means`."""
    n = int(np.log2(N))
    snr_linear = 10.0 ** (snr_db / 10.0)
    mu = np.array([2.0 * snr_linear], dtype=np.float64)
    for _ in range(n):
        bad = np.where(mu < 10.0, mu * 0.9, mu)
        good = np.minimum(2.0 * mu, 100.0)
        mu = np.concatenate([bad, good])
    return mu


def _phi(x: np.ndarray) -> np.ndarray:
    """Trifonov's two-piece approximation of the DE-GA φ function."""
    x = np.maximum(x, 1e-12)
    small = np.exp(-0.4527 * np.power(x, 0.859) + 0.0218)
    large = np.sqrt(np.pi / x) * np.exp(-x / 4.0) * (1.0 - 10.0 / (7.0 * x))
    return np.where(x < 10.0, small, np.maximum(large, 0.0))


def _phi_inv(y: np.ndarray) -> np.ndarray:
    """Numerical inverse of :func:`_phi` by bisection (φ is decreasing)."""
    y = np.clip(y, 1e-300, 1.0 - 1e-15)
    lo = np.full_like(y, 1e-12)
    hi = np.full_like(y, 1e4)
    for _ in range(80):
        mid = 0.5 * (lo + hi)
        too_big = _phi(mid) > y  # φ(mid) > y  →  mid too small
        lo = np.where(too_big, mid, lo)
        hi = np.where(too_big, hi, mid)
    return 0.5 * (lo + hi)


def dega_llr_means(N: int, snr_db: float) -> np.ndarray:
    """Density-evolution Gaussian approximation (DE-GA) LLR means:
    μ → (φ⁻¹(1−(1−φ(μ))²), 2μ).  Larger mean ⇒ better channel."""
    n = int(np.log2(N))
    snr_linear = 10.0 ** (snr_db / 10.0)
    mu = np.array([2.0 * snr_linear], dtype=np.float64)
    for _ in range(n):
        phi_mu = _phi(mu)
        bad = _phi_inv(1.0 - (1.0 - phi_mu) ** 2)
        good = 2.0 * mu
        mu = np.concatenate([bad, good])
    return mu


def generate_frozen_bits(
    N: int, K: int, channel_param: Optional[np.ndarray] = None
) -> Tuple[np.ndarray, np.ndarray]:
    """Default frozen/info split.

    Without channel parameters, sorts indices by bit-reversed value and takes
    the top-K as info bits.  With ``channel_param`` (smaller = better), takes
    the best K as info bits.
    """
    if channel_param is None:
        brev = bit_reverse_permutation(N)
        order = np.argsort(brev)
        info = order[-K:]
        frozen = order[:-K]
    else:
        order = np.argsort(channel_param)
        info = order[:K]
        frozen = order[K:]
    return np.sort(frozen), np.sort(info)


def construct_polar_code(
    N: int, K: int, method: str = "bhattacharyya", snr_db: float = 0.0
) -> Tuple[np.ndarray, np.ndarray]:
    """Pick frozen/info positions.

    Methods: ``bhattacharyya`` (Z ascending → best K),
    ``gaussian_approximation`` (heuristic, μ descending), ``dega`` (proper
    DE-GA) and ``default`` (bit-reversal heuristic).  ``monte_carlo``
    (genie-aided simulation) is not in this package yet.
    Returns ``(frozen_positions, info_positions)``, both sorted.
    """
    if method == "bhattacharyya":
        z = bhattacharyya_bounds(N, snr_db)
        order = np.argsort(z)
        info, frozen = order[:K], order[K:]
    elif method == "gaussian_approximation":
        mu = gaussian_approximation(N, snr_db)
        order = np.argsort(mu)[::-1]
        info, frozen = order[:K], order[K:]
    elif method == "dega":
        mu = dega_llr_means(N, snr_db)
        order = np.argsort(-mu, kind="stable")
        info, frozen = order[:K], order[K:]
    elif method == "monte_carlo":
        raise NotImplementedError(
            "monte_carlo construction needs the genie-aided SC path, which "
            "is not in this package yet")
    elif method == "default":
        return generate_frozen_bits(N, K)
    else:
        raise ValueError(f"unknown construction method: {method!r}")
    return np.sort(frozen), np.sort(info)


def frozen_mask_from_positions(N: int, frozen_positions: np.ndarray) -> np.ndarray:
    """Boolean mask [N], True at frozen positions."""
    mask = np.zeros(N, dtype=bool)
    mask[np.asarray(frozen_positions, dtype=np.int64)] = True
    return mask
