"""AWGN channel with BPSK modulation and LLR demodulation.

* BPSK map 0 → +1, 1 → −1
* noise std σ = sqrt(1 / (2·SNR_lin)) — ``snr_db`` is Es/N0, no code-rate
  adjustment
* LLR = 2·y / σ² with LLR > 0 meaning "bit 0 more likely"
* hard demod: y ≤ 0 → 1
* capacity approximation C ≈ 1 − log2(1 + exp(−SNR_lin))

The device path is batched and key-based (``core.rng``); ``noise`` can be
supplied explicitly so that two implementations see identical realizations.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from ..core import rng
from ..core.device import resolve_device


def awgn_noise_std(snr_db):
    """σ = sqrt(1/(2·SNR_lin)).

    A Python number is computed on the host in float64 (and cast where it is
    used); a tensor is computed on its device, so one Monte-Carlo step serves
    a whole SNR sweep (the runtime-SNR pipelines of ``sim.pipelines``)."""
    if isinstance(snr_db, (int, float)):
        snr_linear = 10.0 ** (snr_db / 10.0)
        return math.sqrt(1.0 / (2.0 * snr_linear))
    snr_linear = 10.0 ** (snr_db / 10.0)
    return torch.sqrt(1.0 / (2.0 * snr_linear))


def bpsk_modulate(bits, dtype=torch.float32):
    """0 → +1, 1 → −1."""
    return 1.0 - 2.0 * torch.as_tensor(bits).to(dtype)


def bpsk_demodulate_hard(symbols):
    """y ≤ 0 → 1."""
    return (symbols <= 0).to(torch.int8)


def symbols_to_llr(symbols, noise_std):
    """LLR = 2y/σ²."""
    return 2.0 * symbols / (noise_std * noise_std)


def awgn_transmit(key, bits, snr_db, return_llr: bool = True,
                  dtype=torch.float32, noise: Optional[torch.Tensor] = None):
    """Modulate → add noise → demodulate.

    Args:
        key: key(s) ``[..., 2]`` whose leading axes match ``bits``' leading
            axes (one key per frame), or one key ``[2]`` for a single frame;
            ignored when ``noise`` is given.
        bits: ``[..., n]`` bit tensor.
        snr_db: Python number or tensor (runtime SNR).
        noise: optional pre-drawn *standard-normal* noise of ``bits.shape``.
    """
    bits = torch.as_tensor(bits)
    std = awgn_noise_std(snr_db)
    if isinstance(std, torch.Tensor):
        std = std.to(device=bits.device, dtype=dtype)
    symbols = bpsk_modulate(bits, dtype)
    if noise is None:
        noise = rng.normal(key, symbols.shape[-1], dtype)
    received = symbols + std * torch.as_tensor(noise, device=bits.device).to(dtype)
    if return_llr:
        return symbols_to_llr(received, std)
    return bpsk_demodulate_hard(received)


def awgn_capacity(snr_db: float) -> float:
    """C ≈ 1 − log2(1 + exp(−SNR_lin))."""
    snr_linear = 10.0 ** (snr_db / 10.0)
    return float(1.0 - math.log2(1.0 + math.exp(-snr_linear)))


class AWGNChannel:
    """Class wrapper with explicit-key randomness: every ``transmit`` without
    a key or noise consumes a fresh split of the channel's own key.  A batch
    ``[..., n]`` is drawn as one flat stream of ``prod(shape)`` values from
    that key, as a shaped ``jax.random.normal`` draw is."""

    def __init__(self, snr_db: float, seed: Optional[int] = None,
                 dtype=torch.float32, device="cuda"):
        self.dtype = dtype
        self.device = resolve_device(device)
        self._key = rng.prng_key(0 if seed is None else seed, self.device)
        self.update_snr(snr_db)

    def update_snr(self, snr_db: float) -> None:
        self.snr_db = snr_db
        self.snr_linear = 10.0 ** (snr_db / 10.0)
        self.noise_std = awgn_noise_std(snr_db)

    def modulate_bpsk(self, bits):
        return bpsk_modulate(self._dev(bits), self.dtype)

    def demodulate_bpsk_hard(self, symbols):
        return bpsk_demodulate_hard(self._dev(symbols))

    def symbols_to_llr(self, symbols):
        return symbols_to_llr(self._dev(symbols).to(self.dtype), self.noise_std)

    def add_noise(self, symbols, key=None):
        symbols = self._dev(symbols).to(self.dtype)
        return symbols + self.noise_std * self._draw(self._next_key(key), symbols.shape)

    def transmit(self, bits, return_llr: bool = True, key=None, noise=None):
        bits = self._dev(bits)
        key = self._next_key(key)
        if noise is None:
            noise = self._draw(key, bits.shape)
        return awgn_transmit(key, bits, self.snr_db, return_llr, self.dtype,
                             self._dev(noise))

    def get_capacity(self) -> float:
        return awgn_capacity(self.snr_db)

    # -- internals -----------------------------------------------------------
    def _dev(self, x):
        return torch.as_tensor(x, device=self.device)

    def _draw(self, key, shape):
        count = math.prod(shape)
        return rng.normal(key, count, self.dtype).reshape(shape)

    def _next_key(self, key):
        if key is not None:
            return torch.as_tensor(key, device=self.device)
        pair = rng.split(self._key)
        self._key = pair[0]
        return pair[1]

    def __repr__(self) -> str:
        return f"AWGNChannel(SNR={self.snr_db:.2f}dB, noise_std={self.noise_std:.4f})"
