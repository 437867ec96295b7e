"""NumPy twin of the reference AWGN channel (``src/channel/awgn.py``).

The twin takes the standard-normal noise realization as an explicit argument
so the exact same noise can be fed to the device path
(``channels.awgn.awgn_transmit(..., noise=...)``) for bit-exact parity.
"""

from __future__ import annotations

import numpy as np


def noise_std(snr_db: float) -> float:
    return float(np.sqrt(1.0 / (2.0 * 10.0 ** (snr_db / 10.0))))


def bpsk_modulate_np(bits: np.ndarray) -> np.ndarray:
    return 1.0 - 2.0 * np.asarray(bits, np.float64)


def awgn_llr_np(bits: np.ndarray, snr_db: float, noise: np.ndarray) -> np.ndarray:
    """modulate → add σ·noise → LLR = 2y/σ² (reference ``awgn.py:91-112``)."""
    std = noise_std(snr_db)
    received = bpsk_modulate_np(bits) + std * np.asarray(noise, np.float64)
    return 2.0 * received / (std * std)


def awgn_hard_np(bits: np.ndarray, snr_db: float, noise: np.ndarray) -> np.ndarray:
    std = noise_std(snr_db)
    received = bpsk_modulate_np(bits) + std * np.asarray(noise, np.float64)
    return (received <= 0).astype(np.int64)


def bsc_np(bits: np.ndarray, flips: np.ndarray) -> np.ndarray:
    """BSC with an explicit flip mask (reference ``bsc.py:32-49``)."""
    return (np.asarray(bits, np.int64) ^ np.asarray(flips, np.int64))


def fading_llr_np(bits: np.ndarray, snr_db: float, h_mag: np.ndarray,
                  noise: np.ndarray) -> np.ndarray:
    """Fading chain with explicit |h| and standard-normal noise:
    received = |h|·s + σ·noise; CSI-aware LLR = 2·y·|h|/σ²
    (reference ``fading.py:41-63``)."""
    std = noise_std(snr_db)
    received = (np.asarray(h_mag, np.float64) * bpsk_modulate_np(bits)
                + std * np.asarray(noise, np.float64))
    return 2.0 * received * np.asarray(h_mag, np.float64) / (std * std)
