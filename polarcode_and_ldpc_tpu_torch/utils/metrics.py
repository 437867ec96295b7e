"""Error-rate and throughput metrics used by the Monte-Carlo result."""

from __future__ import annotations

import math

import numpy as np


def calculate_ber(original, decoded) -> float:
    """Bit error rate."""
    original = np.asarray(original)
    decoded = np.asarray(decoded)
    assert original.shape == decoded.shape, "shape mismatch"
    if original.size == 0:
        return 0.0
    return float(np.mean(original != decoded))


def calculate_fer(original_frames, decoded_frames) -> float:
    """Frame error rate over batches of frames."""
    original = np.asarray(original_frames)
    decoded = np.asarray(decoded_frames)
    assert original.shape == decoded.shape, "shape mismatch"
    if original.ndim == 1:
        return float(np.any(original != decoded))
    frames = original.reshape(-1, original.shape[-1])
    dframes = decoded.reshape(-1, decoded.shape[-1])
    if frames.shape[0] == 0:
        return 0.0
    return float(np.mean(np.any(frames != dframes, axis=-1)))


def calculate_throughput(num_bits: int, elapsed_seconds: float) -> float:
    """Throughput in Mbps."""
    if elapsed_seconds <= 0:
        return 0.0
    return num_bits / elapsed_seconds / 1e6


def wilson_confidence_interval(errors: int, trials: int, confidence: float = 0.95):
    """Wilson score interval for an error probability."""
    if trials == 0:
        return 0.0, 0.0
    # two-sided normal quantile via inverse error function
    z = math.sqrt(2.0) * _erfinv(confidence)
    p = errors / trials
    denom = 1.0 + z * z / trials
    center = (p + z * z / (2 * trials)) / denom
    half = (z / denom) * math.sqrt(p * (1 - p) / trials + z * z / (4 * trials * trials))
    return max(0.0, center - half), min(1.0, center + half)


def _erfinv(x: float) -> float:
    # inverse erf: Winitzki approximation refined by Newton steps
    a = 0.147
    ln1mx2 = math.log(1 - x * x)
    t = 2.0 / (math.pi * a) + ln1mx2 / 2.0
    y = math.copysign(math.sqrt(math.sqrt(t * t - ln1mx2 / a) - t), x)
    for _ in range(2):  # f(y) = erf(y) - x
        err = math.erf(y) - x
        y -= err * math.sqrt(math.pi) / 2.0 * math.exp(y * y)
    return y
