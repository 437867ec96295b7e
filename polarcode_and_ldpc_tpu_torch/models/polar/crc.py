"""CRC codec over GF(2), batched.

The CRC is bit-serial in its definition (MSB-first, init 0, no reflection,
no final XOR; polynomials CRC-8 0x1D, CRC-16 0x1021, CRC-24 0x1864CFB).  A
CRC with zero init is *linear* over GF(2), so for a fixed message length it
is a GF(2) matrix product, which is how the device path computes it: one
small matrix product per batch instead of a per-bit loop.  The matrix is
built on the host by running the bit-serial recurrence on unit vectors.

The product runs in float32 (PyTorch has no integer matmul on CUDA): the
operands are 0/1 and a row sum is at most the message length, far below
2^24, so every partial sum is an exact integer whatever the reduction order
or the tensor-core precision setting; the sum is then reduced mod 2 in
integers.
"""

from __future__ import annotations

import functools
from typing import Optional, Sequence

import numpy as np
import torch

from ...core.device import resolve_device

CRC_POLYNOMIALS = {
    "CRC-8": 0x1D,
    "CRC-16": 0x1021,
    "CRC-24": 0x1864CFB,  # 5G NR CRC24A
}


def crc_length(polynomial: str) -> int:
    return int(polynomial.split("-")[1])


def crc_remainder_scalar(bits: Sequence[int], polynomial: str = "CRC-8") -> int:
    """Bit-serial CRC register.  Host-side / test use only."""
    poly = CRC_POLYNOMIALS.get(polynomial, CRC_POLYNOMIALS["CRC-8"])
    crc_len = crc_length(polynomial if polynomial in CRC_POLYNOMIALS else "CRC-8")
    msb = 1 << (crc_len - 1)
    mask = (1 << crc_len) - 1
    crc = 0
    for bit in bits:
        crc ^= int(bit) << (crc_len - 1)
        crc = ((crc << 1) ^ poly) if (crc & msb) else (crc << 1)
        crc &= mask
    return crc


@functools.lru_cache(maxsize=None)
def _crc_matrix(data_len: int, polynomial: str) -> np.ndarray:
    """GF(2) matrix M [data_len, crc_len] with CRC(data) = data @ M mod 2."""
    crc_len = crc_length(polynomial)
    M = np.zeros((data_len, crc_len), dtype=np.int8)
    for i in range(data_len):
        unit = np.zeros(data_len, dtype=np.int8)
        unit[i] = 1
        r = crc_remainder_scalar(unit, polynomial)
        M[i] = [(r >> (crc_len - 1 - b)) & 1 for b in range(crc_len)]
    return M


def _gf2_product(bits: torch.Tensor, matrix_f32: torch.Tensor) -> torch.Tensor:
    """``bits [..., n]`` (0/1, any integer dtype) times a 0/1 float32 matrix
    ``[n, m]``, mod 2 → int8 ``[..., m]``.  Exact: see the module note."""
    prod = torch.matmul(bits.to(torch.float32), matrix_f32)
    return (prod.to(torch.int32) & 1).to(torch.int8)


class CRCCodec:
    """Batched CRC encode/check for a fixed data length.

    ``enc_matrix`` / ``chk_matrix`` carry given matrices instead of deriving
    them (see ``convert.crc_codec_from_numpy``)."""

    def __init__(self, data_len: int, polynomial: str = "CRC-8", device="cuda",
                 enc_matrix: Optional[np.ndarray] = None,
                 chk_matrix: Optional[np.ndarray] = None):
        if polynomial not in CRC_POLYNOMIALS:
            polynomial = "CRC-8"
        self.polynomial = polynomial
        self.crc_len = crc_length(polynomial)
        self.data_len = data_len
        self.device = resolve_device(device)
        enc = _crc_matrix(data_len, polynomial) if enc_matrix is None else np.asarray(enc_matrix)
        chk = (_crc_matrix(data_len + self.crc_len, polynomial) if chk_matrix is None
               else np.asarray(chk_matrix))
        if enc.shape != (data_len, self.crc_len):
            raise ValueError(f"enc_matrix must be [{data_len}, {self.crc_len}], got {enc.shape}")
        if chk.shape != (data_len + self.crc_len, self.crc_len):
            raise ValueError(
                f"chk_matrix must be [{data_len + self.crc_len}, {self.crc_len}], got {chk.shape}")
        self.enc_matrix = (enc % 2).astype(np.int8)
        self.chk_matrix = (chk % 2).astype(np.int8)
        self._enc = torch.as_tensor(self.enc_matrix.astype(np.float32), device=self.device)
        self._chk = torch.as_tensor(self.chk_matrix.astype(np.float32), device=self.device)

    def encode(self, data) -> torch.Tensor:
        """Append CRC bits: ``[..., data_len] → [..., data_len + crc_len]``."""
        data = torch.as_tensor(data, device=self.device).to(torch.int8)
        return torch.cat([data, _gf2_product(data, self._enc)], dim=-1)

    def check(self, data_with_crc) -> torch.Tensor:
        """True where the CRC of ``[..., data_len + crc_len]`` passes."""
        bits = torch.as_tensor(data_with_crc, device=self.device)
        return (_gf2_product(bits, self._chk) == 0).all(dim=-1)


def crc_encode(data, polynomial: str = "CRC-8", device="cuda") -> torch.Tensor:
    """Functional form: accepts ``[..., L]``; appends the CRC along the last
    axis."""
    codec = CRCCodec(int(np.shape(data)[-1]), polynomial, device)
    return codec.encode(data)


def crc_check(data, polynomial: str = "CRC-8", device="cuda"):
    """Functional form: a boolean (or a boolean tensor for batched input)."""
    if polynomial not in CRC_POLYNOMIALS:
        polynomial = "CRC-8"
    total_len = int(np.shape(data)[-1])
    codec = CRCCodec(total_len - crc_length(polynomial), polynomial, device)
    out = codec.check(data)
    if out.dim() == 0:
        return bool(out)
    return out
