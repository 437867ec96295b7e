"""Polar encoder: Kronecker-butterfly transform over a batch.

x = u·F^⊗n with F = [[1,0],[1,1]], realized as log₂N stages where stage *s*
XORs each element at offset < 2^s of a 2^(s+1)-block with its partner 2^s
away.  No bit-reversal permutation is applied (natural-order convention):
stage 0 pairs adjacent positions.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch
from torch import nn

from ...core.device import resolve_device
from .construction import frozen_mask_from_positions, generate_frozen_bits
from .crc import CRCCodec


def polar_transform(u: torch.Tensor) -> torch.Tensor:
    """Butterfly transform x = u·F^⊗n over the last axis: stage *s* pairs
    positions ``j`` (bit *s* = 0) with ``j + 2^s`` and XORs into the former."""
    u = torch.as_tensor(u)
    N = u.shape[-1]
    n = int(np.log2(N))
    assert 1 << n == N, "length must be a power of two"
    lead = u.shape[:-1]
    # a contiguous int8 copy; the stages update it in place
    x = u.to(torch.int8).clone(memory_format=torch.contiguous_format)
    for s in range(n):
        stride = 1 << s
        xr = x.view(*lead, N // (2 * stride), 2, stride)
        xr[..., 0, :] ^= xr[..., 1, :]
    return x


class PolarEncoder(nn.Module):
    """Batched polar encoder with optional CRC concatenation.

    ``encode`` accepts ``[K]`` (``[K - crc_len]`` with ``use_crc``) or any
    batched ``[..., K]`` shape and returns ``[..., N]`` int8 codewords on the
    encoder's device.
    """

    def __init__(self, N: int, K: int, frozen_bits: Optional[np.ndarray] = None,
                 use_crc: bool = False, crc_polynomial: str = "CRC-8",
                 device="cuda"):
        super().__init__()
        assert N > 0 and (N & (N - 1)) == 0, "N must be a power of 2"
        assert 0 < K < N, "K must be in range (0, N)"
        dev = resolve_device(device)
        self.N = N
        self.K = K
        self.n = int(np.log2(N))
        self.use_crc = use_crc
        self.crc_polynomial = crc_polynomial
        if use_crc:
            self._crc = CRCCodec(K - int(crc_polynomial.split("-")[1]),
                                 crc_polynomial, dev)
            self.crc_len = self._crc.crc_len
            assert K > self.crc_len, f"K must exceed CRC length ({self.crc_len})"
            self.K_data = K - self.crc_len
        else:
            self._crc = None
            self.crc_len = 0
            self.K_data = K
        if frozen_bits is None:
            self.frozen_bits, self.info_bits = generate_frozen_bits(N, K)
        else:
            self.frozen_bits = np.sort(np.asarray(frozen_bits, dtype=np.int64))
            self.info_bits = np.setdiff1d(np.arange(N), self.frozen_bits)
            assert len(self.info_bits) == K, "number of info bits must equal K"
        self.frozen_mask = frozen_mask_from_positions(N, self.frozen_bits)
        self.register_buffer(
            "_info_idx", torch.as_tensor(self.info_bits, dtype=torch.int64, device=dev))

    def encode(self, message) -> torch.Tensor:
        message = torch.as_tensor(message, device=self._info_idx.device).to(torch.int8)
        assert message.shape[-1] == self.K_data, (
            f"message length must be {self.K_data}, got {message.shape[-1]}")
        if self._crc is not None:
            message = self._crc.encode(message)
        u = torch.zeros((*message.shape[:-1], self.N), dtype=torch.int8,
                        device=message.device)
        u[..., self._info_idx] = message
        return polar_transform(u)

    forward = encode

    def get_info_bits_positions(self) -> np.ndarray:
        return self.info_bits.copy()

    def get_frozen_bits_positions(self) -> np.ndarray:
        return self.frozen_bits.copy()

    def get_code_rate(self) -> float:
        return self.K / self.N

    def __repr__(self) -> str:
        return f"PolarEncoder(N={self.N}, K={self.K}, rate={self.get_code_rate():.3f})"
