"""LDPC encoder: systematic GF(2) encoding as one matrix product.

Prefer ``c = m·G mod 2`` with a (k,n) generator (accepting (n,k) by
transposition); else derive an information-set generator from H.  Every path
reduces to one static GF(2) matrix, so the device encode is a single matmul
+ mod 2, batched over frames.  The product runs in float32 (integer matmul is
not available on CUDA): 0/1 inputs accumulate exactly up to k < 2²⁴.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch
from torch import nn

from ...core.device import resolve_device
from .matrix import encodable_form, generate_ldpc_matrix


def gf2_solve(A: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Solve A·x = b over GF(2) by Gaussian elimination + back-substitution
    (free variables → 0)."""
    A = (np.asarray(A) % 2).astype(np.uint8)
    b = (np.asarray(b) % 2).astype(np.uint8)
    m, n = A.shape
    aug = np.hstack([A, b.reshape(-1, 1)])
    pivot_row = 0
    pivot_cols = []
    for col in range(n):
        if pivot_row >= m:
            break
        hit = np.nonzero(aug[pivot_row:, col])[0]
        if hit.size == 0:
            continue
        prow = pivot_row + hit[0]
        if prow != pivot_row:
            aug[[pivot_row, prow]] = aug[[prow, pivot_row]]
        elim = (aug[:, col] == 1) & (np.arange(m) != pivot_row)
        aug[elim] ^= aug[pivot_row]
        pivot_cols.append(col)
        pivot_row += 1
    x = np.zeros(n, dtype=np.int64)
    for r, col in enumerate(pivot_cols):
        # after full elimination each pivot row determines x[col] directly
        x[col] = aug[r, -1] ^ (int(np.sum(aug[r, col + 1:n] & x[col + 1:n])) & 1)
    return x


def gf2_matmul(msgs: torch.Tensor, G_f32: torch.Tensor) -> torch.Tensor:
    """``[..., k] × [k, n] → [..., n]`` int8 over GF(2), exact in float32."""
    assert G_f32.shape[0] < (1 << 24)
    prod = torch.matmul(msgs.to(torch.float32), G_f32)
    return prod.to(torch.int32).bitwise_and_(1).to(torch.int8)


class LDPCEncoder(nn.Module):
    """Batched LDPC encoder."""

    def __init__(self, n: int, k: int, H: Optional[np.ndarray] = None,
                 G: Optional[np.ndarray] = None, dv: int = 3, dc: int = 6,
                 seed: Optional[int] = None, method: str = "regular",
                 device="cuda"):
        super().__init__()
        assert n > k > 0, "invalid code parameters"
        self.n = n
        self.k = k
        if H is None:
            self.m = n - k
            self.H = generate_ldpc_matrix(n, k, method=method, dv=dv, dc=dc, seed=seed)
        else:
            self.H = np.asarray(H)
            m_actual, n_actual = self.H.shape
            assert n_actual == n, f"H matrix must have {n} columns"
            self.m = m_actual
            if n - m_actual != k:
                print(f"Warning: H implies k={n - m_actual}, but k={k} was provided")

        self.use_direct_solving = False
        self.info_positions = np.arange(k, dtype=np.int64)  # systematic default
        if G is not None:
            G = np.asarray(G)
            if G.shape == (n, k):
                self.G = G.T % 2
            elif G.shape == (k, n):
                self.G = G % 2
            else:
                raise ValueError(f"G shape {G.shape} doesn't match (n,k) or (k,n)")
            self.P = None
        else:
            # one right-side-pivot elimination covers both cases: when the
            # last m columns are nonsingular its result IS the systematic
            # G = [I | Pᵀ] (info = 0..k−1); otherwise it yields a general
            # information set
            self.P = None
            self.G, info = encodable_form(self.H, k)
            if self.G is None:
                print("Warning: H admits no rank-compatible information set; "
                      "encoding will return zero codewords")
            else:
                self.info_positions = np.asarray(info, dtype=np.int64)
                systematic = bool((self.info_positions == np.arange(k)).all())
                if systematic:
                    self.P = self.G[:, k:].T  # G = [I | Pᵀ] ⇒ recover P
                self.use_direct_solving = not systematic

        dev = resolve_device(device)
        G_host = np.zeros((k, n), np.float32) if self.G is None else self.G.astype(np.float32)
        self.register_buffer("_G_dev", torch.as_tensor(G_host, device=dev))
        self.register_buffer(
            "_info_idx", torch.as_tensor(self.info_positions, dtype=torch.int64, device=dev))

    def encode(self, message) -> torch.Tensor:
        """Encode ``[k]`` or ``[..., k]`` messages → ``[..., n]`` int8 codewords."""
        message = torch.as_tensor(message, device=self._G_dev.device)
        assert message.shape[-1] == self.k, f"message length must be {self.k}"
        return gf2_matmul(message, self._G_dev)

    forward = encode

    def extract_message(self, codeword) -> torch.Tensor:
        """Recover the k message bits from a (decoded) codeword."""
        return torch.as_tensor(codeword, device=self._info_idx.device)[..., self._info_idx]

    def verify_codeword(self, codeword):
        """H·cᵀ ≡ 0 check; batched input returns a boolean array."""
        if isinstance(codeword, torch.Tensor):
            codeword = codeword.detach().cpu().numpy()
        syn = (np.asarray(codeword).astype(np.int64) @ self.H.T) % 2
        ok = np.all(syn == 0, axis=-1)
        return bool(ok) if np.ndim(ok) == 0 else ok

    def get_code_rate(self) -> float:
        return self.k / self.n

    def get_parity_check_matrix(self) -> np.ndarray:
        return self.H.copy()

    def __repr__(self) -> str:
        return f"LDPCEncoder(n={self.n}, k={self.k}, rate={self.get_code_rate():.3f})"
