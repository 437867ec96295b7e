"""Fading channels: Rayleigh, and Rician with a K-factor line-of-sight term.

* per-symbol complex gain h; received = |h|·s + noise, s the BPSK symbol
* CSI-aware LLR = 2·y·|h| / σ², σ as for AWGN (``snr_db`` is Es/N0)
* hard decision y ≤ 0 → 1

Rayleigh: h ~ CN(0, 1).  Rician: h = sqrt(K/(K+1)) + CN(0, 1/(K+1)); K = 0 is
Rayleigh.  The key tree of one transmission is the JAX package's: the key
splits into (k_h, k_n), k_h into the real and imaginary parts' keys, and each
draws standard normals (``core.rng.normal``).
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from ..core import rng
from ..core.device import resolve_device
from .awgn import awgn_noise_std, bpsk_modulate


def fading_apply(bits, snr_db, h_mag, noise, return_llr: bool = True, dtype=torch.float32):
    """The fading chain on given |h| and standard-normal noise (both of
    ``bits``' shape).  ``snr_db``: a Python number or a tensor (runtime SNR)."""
    bits = torch.as_tensor(bits)
    std = awgn_noise_std(snr_db)
    if isinstance(std, torch.Tensor):
        std = std.to(device=bits.device, dtype=dtype)
    symbols = bpsk_modulate(bits, dtype)
    received = h_mag * symbols + torch.as_tensor(noise, device=bits.device).to(dtype) * std
    if return_llr:
        return 2.0 * received * h_mag / (std * std)
    return (received <= 0).to(torch.int8)


def _normal(key, shape, dtype):
    return rng.draw(lambda k, n: rng.normal(k, n, dtype), key, shape)


def _fading_core(key, bits, snr_db, los: float, scale: float, return_llr, dtype):
    bits = torch.as_tensor(bits)
    key = torch.as_tensor(key, device=bits.device)
    k_h, k_n = rng.split(key).unbind(-2)
    k_r, k_i = rng.split(k_h).unbind(-2)
    h_real = _normal(k_r, bits.shape, dtype) * scale
    if los != 0.0:  # a +0.0 term would only turn −0.0 into +0.0: |h| is the same
        h_real = los + h_real
    h_imag = _normal(k_i, bits.shape, dtype) * scale
    h_mag = torch.sqrt(h_real * h_real + h_imag * h_imag)
    noise = _normal(k_n, bits.shape, dtype)
    return fading_apply(bits, snr_db, h_mag, noise, return_llr, dtype)


def rayleigh_transmit(key, bits, snr_db, return_llr: bool = True, dtype=torch.float32):
    """Rayleigh-faded BPSK over AWGN.  ``key``: keys ``[..., 2]`` whose
    leading axes match ``bits``' leading axes (one key per frame), or one key
    ``[2]`` for the whole tensor."""
    return _fading_core(key, bits, snr_db, 0.0, 1.0 / math.sqrt(2.0), return_llr, dtype)


def rician_transmit(key, bits, snr_db, k_factor: float = 1.0, return_llr: bool = True,
                    dtype=torch.float32):
    """Rician fading with K-factor (line-of-sight power / scattered power);
    ``key`` as for ``rayleigh_transmit``."""
    los = math.sqrt(k_factor / (k_factor + 1.0))
    scale = math.sqrt(1.0 / (2.0 * (k_factor + 1.0)))
    return _fading_core(key, bits, snr_db, los, scale, return_llr, dtype)


class RayleighFadingChannel:
    """Class wrapper with explicit-key randomness: every ``transmit`` without
    a key consumes a fresh split of the channel's own key, and draws the
    batch as one flat stream from it."""

    def __init__(self, snr_db: float, seed: Optional[int] = None, dtype=torch.float32,
                 device="cuda"):
        self.snr_db = snr_db
        self.snr_linear = 10.0 ** (snr_db / 10.0)
        self.noise_std = awgn_noise_std(snr_db)
        self.dtype = dtype
        self.device = resolve_device(device)
        self._key = rng.prng_key(0 if seed is None else seed, self.device)

    def _next_key(self, key):
        if key is not None:
            return torch.as_tensor(key, device=self.device)
        self._key, key = rng.split(self._key)
        return key

    def _transmit(self, key, bits, return_llr):
        return rayleigh_transmit(key, bits, self.snr_db, return_llr, self.dtype)

    def transmit(self, bits, return_llr: bool = True, key=None):
        key = self._next_key(key)
        return self._transmit(key, torch.as_tensor(bits, device=self.device), return_llr)

    def __repr__(self) -> str:
        return f"RayleighFadingChannel(SNR={self.snr_db:.2f}dB)"


class RicianFadingChannel(RayleighFadingChannel):
    """Rician fading with K-factor ``k_factor``; otherwise as
    ``RayleighFadingChannel``."""

    def __init__(self, snr_db: float, k_factor: float = 1.0, seed: Optional[int] = None,
                 dtype=torch.float32, device="cuda"):
        super().__init__(snr_db, seed, dtype, device)
        self.k_factor = k_factor

    def _transmit(self, key, bits, return_llr):
        return rician_transmit(key, bits, self.snr_db, self.k_factor, return_llr, self.dtype)

    def __repr__(self) -> str:
        return f"RicianFadingChannel(SNR={self.snr_db:.2f}dB, K={self.k_factor})"
