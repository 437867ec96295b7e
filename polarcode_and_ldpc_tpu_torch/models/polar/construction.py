"""Polar code construction (host-side NumPy, float64).

Code construction is a one-time, host-side computation whose output (a frozen
mask) is a *static* input to the decoders.  It stays NumPy float64 so the
frozen sets equal the JAX package's exactly.  The exception is the
Monte-Carlo construction (:func:`monte_carlo_reliabilities`), which samples
genie-aided SC decisions in torch on ``device``.

Index convention: trellis stage *s* selects f/g by bit *s* of the u-index, so
the *first* channel split lives at the LSB.  The recursions here therefore
concatenate children block-wise (old index in the low bits).
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from ...channels.awgn import awgn_noise_std
from ...core import rng
from ...core.device import resolve_device
from .trellis import f_minsum


def bit_reverse(x: int, num_bits: int) -> int:
    """Reverse the ``num_bits``-bit binary representation of ``x``."""
    out = 0
    for _ in range(num_bits):
        out = (out << 1) | (x & 1)
        x >>= 1
    return out


def bit_reverse_permutation(N: int) -> np.ndarray:
    """Vector of bit-reversed indices: ``perm[i] = bit_reverse(i, log2 N)``."""
    n = int(np.log2(N))
    idx = np.arange(N, dtype=np.int64)
    out = np.zeros(N, dtype=np.int64)
    for b in range(n):
        out |= ((idx >> b) & 1) << (n - 1 - b)
    return out


def bit_reverse_array(arr: np.ndarray, num_bits: int) -> np.ndarray:
    """Permute: element ``i`` moves to position ``bit_reverse(i)``."""
    perm = bit_reverse_permutation(1 << num_bits)
    out = np.zeros_like(arr)
    out[perm] = arr
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


def genie_leaf_llrs(llr: torch.Tensor) -> torch.Tensor:
    """Genie-aided SC decision LLRs for the all-zero codeword, every leaf.

    With all prior bits known (0 for the all-zero codeword), leaf *l*'s
    decision LLR is a deterministic function of the channel LLRs: the f/g
    recursion with all partial sums zero (g degenerates to a sum).  Returns
    ``[..., N]`` indexed by u-position, in the dtype and on the device of
    ``llr``.

    Level-parallel: every node of a level splits its even / odd entries in
    one op, node ``j``'s f child becoming node ``2j`` and its g child ``2j +
    1``.  After ``log2 N`` levels node ``i`` is the leaf whose u-index is
    ``bit_reverse(i)`` (the first split is the u-index's LSB).  Each value
    is the same float expression as in the node-by-node recursion."""
    N = llr.shape[-1]
    lead = llr.shape[:-1]
    x = llr.reshape(*lead, 1, N)
    size = N
    while size > 1:
        e, o = x[..., 0::2], x[..., 1::2]
        x = torch.stack([f_minsum(e, o), o + e], dim=-2)
        size //= 2
        x = x.reshape(*lead, -1, size)
    perm = torch.from_numpy(bit_reverse_permutation(N)).to(llr.device)
    return x.reshape(*lead, N)[..., perm]


def monte_carlo_reliabilities(N: int, snr_db: float, num_frames: int = 10000,
                              seed: int = 0, batch: int = 1024, device="cuda",
                              rng_x64: bool = False) -> np.ndarray:
    """Per-bit-channel error probabilities by Monte-Carlo (genie-aided SC).

    Samples AWGN LLRs for the all-zero codeword, computes every leaf's genie
    decision LLR in one pass and counts sign errors per u-position.  Lower =
    better channel.  Chunk ``i`` of ``batch`` frames draws its noise with the
    key ``fold_in(prng_key(seed), i)`` as one shaped ``[batch, N]`` normal
    draw, the draws of ``jax.random.normal``; chunks run until ``num_frames``
    frames are counted (a whole number of chunks).

    The noise and the LLR arithmetic are float32 (the card's path, and JAX's
    default), or float64 with ``rng_x64=True``, which mirrors JAX under
    ``jax_enable_x64``: there ``jax.random.normal`` draws float64."""
    dev = resolve_device(device)
    dtype = torch.float64 if rng_x64 else torch.float32
    std = awgn_noise_std(float(snr_db))
    root = rng.prng_key(seed, dev)
    errors = torch.zeros(N, dtype=torch.int64, device=dev)
    frames = 0
    i = 0
    while frames < num_frames:
        key = rng.fold_in(root, i)
        noise = rng.draw(lambda k, n: rng.normal(k, n, dtype), key, (batch, N))
        llr = 2.0 * (1.0 + std * noise) / (std * std)  # all-zero codeword → s = +1
        errors += (genie_leaf_llrs(llr) < 0).sum(dim=0)
        frames += batch
        i += 1
    return errors.cpu().numpy() / frames


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
    N: int, K: int, method: str = "bhattacharyya", snr_db: float = 0.0,
    device="cuda",
) -> Tuple[np.ndarray, np.ndarray]:
    """Pick frozen/info positions.

    Methods: ``bhattacharyya`` (Z ascending → best K),
    ``gaussian_approximation`` (heuristic, μ descending), ``dega`` (proper
    DE-GA), ``monte_carlo`` (genie-aided simulation on ``device``, with
    :func:`monte_carlo_reliabilities`' defaults, float32) and
    ``default`` (bit-reversal heuristic).  Only ``monte_carlo`` uses
    ``device``.  Returns ``(frozen_positions, info_positions)``, both sorted.
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
        pe = monte_carlo_reliabilities(N, snr_db, device=device)
        order = np.argsort(pe, kind="stable")  # lowest error prob first
        info, frozen = order[:K], order[K:]
    elif method == "default":
        return generate_frozen_bits(N, K)
    else:
        raise ValueError(f"unknown construction method: {method!r}")
    return np.sort(frozen), np.sort(info)


def calculate_channel_capacities(N: int, snr_db: float) -> np.ndarray:
    """Per-bit-channel capacity estimate C = 1 − H₂((1−Z)/2) from the
    Bhattacharyya parameters."""
    z = bhattacharyya_bounds(N, snr_db)
    cap = np.zeros(N)
    lo = z < 1e-10
    hi = z > 1.0 - 1e-10
    mid = ~(lo | hi)
    p = (1.0 - z[mid]) / 2.0
    valid = (p > 0) & (p < 1)
    h = np.zeros_like(p)
    h[valid] = -p[valid] * np.log2(p[valid]) - (1 - p[valid]) * np.log2(1 - p[valid])
    cap[mid] = np.where(valid, 1.0 - h, 0.0)
    cap[lo] = 1.0
    cap[hi] = 0.0
    return cap


def frozen_mask_from_positions(N: int, frozen_positions: np.ndarray) -> np.ndarray:
    """Boolean mask [N], True at frozen positions."""
    mask = np.zeros(N, dtype=bool)
    mask[np.asarray(frozen_positions, dtype=np.int64)] = True
    return mask
