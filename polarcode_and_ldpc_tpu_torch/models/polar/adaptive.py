"""Adaptive CA-SCL: SC first, list decode only the CRC-failing frames.

The standard throughput decoder (Li, Shen & Tse, "An adaptive successive
cancellation list decoder for polar codes with cyclic redundancy check", IEEE
Comm. Letters 2012): at working SNRs the single-pass SC decoder satisfies the
CRC for the overwhelming majority of frames, so the expensive list decoder
only ever sees the residue.

The whole step stays on the device:

* SC decodes the batch (the whole-decode kernel on a CUDA device), the CRC
  screens it, and the failure count reduces ON DEVICE; that count is the one
  number the host reads per batch;
* when the whole batch passes, the list decode is skipped entirely, so the
  cost at 0 % fallback is the SC pass + CRC;
* otherwise the failing frames are compacted to the front by a stable sort on
  the pass flags (order preserving) and the first ``fallback_budget`` of them
  re-decode through CA-SCL in one call — the results scatter back over the
  failing rows only;
* a budget OVERFLOW (more failures than the budget, i.e. operation far below
  the design SNR) re-decodes the residue in ``fallback_batch`` slices.

Output per frame: the SC result when its CRC passes, else the CA-SCL result —
identical to pure CA-SCL whenever SC fails, and a CRC-valid codeword either
way when one exists.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch
from torch import nn

from ...core.device import resolve_device
from .construction import frozen_mask_from_positions, generate_frozen_bits
from .crc import CRCCodec
from .sc import make_sc_decoder
from .scl import make_scl_decoder, select_best_path


class AdaptiveCASCLDecoder(nn.Module):
    """SC-first CA-SCL (see module docstring).

    ``decode(llr [B, N]) → info bits [B, K]`` (CRC bits included, like
    ``SCLDecoder``); ``decode(..., return_stats=True)`` also reports the SC
    pass rate and fallback count.

    ``fallback_budget``: how many CRC failures of a batch the first list
    decode absorbs; ``None`` sizes it as ``max(batch // 16, 128)`` (capped at
    the batch) — at the design operating point (fallback rate ≤ 2 %) overflows
    are practically impossible.  ``sc_impl`` / ``scl_control_impl``: ``None``
    picks the kernels on a CUDA device and the plain versions on the CPU;
    ``scl_control_impl="mega"`` takes the one-launch list decode.
    ``scl_node_mode="fast"`` puts the SSCL fast list nodes on the fallback
    path (the CRC re-screens its outputs); the one-launch control has none.
    """

    def __init__(self, N: int, K: int, list_size: int = 8,
                 frozen_bits: Optional[np.ndarray] = None,
                 crc_polynomial: str = "CRC-8",
                 fallback_batch: int = 128,
                 fallback_budget: Optional[int] = None, dtype=torch.float32,
                 sc_impl: Optional[str] = None, scl_node_mode: str = "exact",
                 scl_control_impl: Optional[str] = None, device="cuda"):
        super().__init__()
        assert N > 0 and (N & (N - 1)) == 0, "N must be a power of 2"
        assert 0 < K < N
        dev = resolve_device(device)
        self.N, self.K, self.L = N, K, list_size
        if frozen_bits is None:
            self.frozen_bits, self.info_bits = generate_frozen_bits(N, K)
        else:
            self.frozen_bits = np.sort(np.asarray(frozen_bits, np.int64))
            self.info_bits = np.setdiff1d(np.arange(N), self.frozen_bits)
        mask = frozen_mask_from_positions(N, self.frozen_bits)
        self.crc_polynomial = crc_polynomial
        crc_len = int(crc_polynomial.split("-")[1])
        assert K > crc_len
        self._crc = CRCCodec(K - crc_len, crc_polynomial, dev)
        self.register_buffer(
            "_info_idx", torch.as_tensor(self.info_bits, dtype=torch.int64, device=dev))
        self.fallback_batch = fallback_batch
        self.fallback_budget = fallback_budget
        self.dtype = dtype
        self._sc = make_sc_decoder(N, mask, dtype, impl=sc_impl, device=dev)
        self._scl = make_scl_decoder(N, mask, list_size, dtype,
                                     control_impl=scl_control_impl,
                                     node_mode=scl_node_mode, device=dev)
        self.sc_impl = self._sc.impl
        self.scl_control_impl = self._scl.control_impl

    def _budget(self, B: int) -> int:
        if self.fallback_budget is not None:
            return min(self.fallback_budget, B)
        return min(max(B // 16, 128), B)

    def _scl_pass(self, llr):
        u_paths, metrics = self._scl(llr)
        return select_best_path(u_paths[..., self._info_idx], metrics, self._crc)

    def decode(self, llr, return_stats: bool = False):
        llr = torch.atleast_2d(
            torch.as_tensor(llr, device=self._info_idx.device).to(self.dtype))
        B = llr.shape[0]
        budget = self._budget(B)
        out = self._sc(llr)[..., self._info_idx]
        ok = self._crc.check(out)  # [B] bool
        n_fail = int((~ok).sum())  # the one host read of a batch
        if n_fail > 0:
            # stable compaction: failing rows first, original order kept
            order = torch.sort(ok.to(torch.int8), stable=True).indices
            fail = order[:n_fail]
            first = fail[:budget]
            out[first] = self._scl_pass(llr[first])
            # budget overflow (operation far below the design SNR): the
            # residue re-decodes in fixed-size slices — same outputs, slower
            for start in range(budget, n_fail, self.fallback_batch):
                idx = fail[start:start + self.fallback_batch]
                out[idx] = self._scl_pass(llr[idx])
        if return_stats:
            return out, {"frames": B, "sc_passed": B - n_fail,
                         "scl_fallbacks": n_fail,
                         "budget_overflow": max(n_fail - budget, 0),
                         "sc_pass_rate": 1.0 - n_fail / B}
        return out

    forward = decode

    def __repr__(self) -> str:
        return (f"AdaptiveCASCLDecoder(N={self.N}, K={self.K}, L={self.L}, "
                f"crc={self.crc_polynomial})")
