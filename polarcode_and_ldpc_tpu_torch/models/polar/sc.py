"""Successive-cancellation (SC) polar decoder over a batch of frames.

All frames decode in lock-step — the control flow (leaf order, frozen
pattern) is identical across frames, only the data differs.  Same min-sum f,
same g, same ``llr ≥ 0 → 0`` hard decision and decode order as the reference
decoder, so float64 inputs reproduce its bits exactly.

``impl="scan"`` is the trellis twin: the reference's ``[n+1, N]`` LLR and
bit trellises per frame, walked leaf by leaf in the order of a host-side
schedule (``schedule.py``), each stage a full-width masked vector op
(``trellis.py``).  It is an independent formulation of the same decoder —
slow by design (N sequential steps of a few dozen small ops each) — against
which the recursive decoders and the CUDA kernel are held.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch
from torch import nn

from ...core.device import resolve_device
from .construction import frozen_mask_from_positions, generate_frozen_bits
from .schedule import build_schedule
from .trellis import leaf_llr, propagate_bits, set_leaf_bit, update_llr_columns


def make_sc_decoder_trellis(N: int, frozen_mask: np.ndarray, dtype=torch.float32):
    """The trellis SC decoder: ``decode(llr [..., N]) → u [..., N] int8`` on
    the device of ``llr``, one schedule step per leaf."""
    sched = build_schedule(N, frozen_mask)
    n = sched.n

    def decode(llr):
        llr = llr.to(dtype)
        lead = llr.shape[:-1]
        L = torch.zeros((*lead, n + 1, N), dtype=dtype, device=llr.device)
        L[..., 0, :] = llr
        B = torch.zeros((*lead, n + 1, N), dtype=torch.int8, device=llr.device)
        for i in range(N):
            l = int(sched.leaf[i])
            update_llr_columns(L, B, l, sched.llr_active[i])
            # hard decision: llr >= 0 → 0; a frozen leaf keeps B's 0
            if not sched.frozen[i]:
                set_leaf_bit(B, l, (leaf_llr(L, l) < 0).to(torch.int8))
            propagate_bits(B, l, sched.bit_active[i])
        return B[..., n, :].clone()

    return decode


def make_sc_decoder(N: int, frozen_mask: np.ndarray, dtype=torch.float32,
                    impl: Optional[str] = None, device="cuda"):
    """Build an SC decoder for a fixed code.

    Returns ``decode(llr: [..., N]) -> u: [..., N] int8`` (full u-vector in
    natural order; callers extract info positions).

    ``impl``: ``"mega"`` (the whole recursion in ONE CUDA kernel per batch,
    ``ops/sc_mega_cuda.py``; float32, the default on a CUDA device) or
    ``"unrolled"`` (the O(N log N) recursion in plain PyTorch with the
    rate-0/rate-1/REP/SPC node shortcuts, ``fastsc.py``; the default on the
    CPU), or ``"scan"`` (the trellis twin, plain PyTorch, any float dtype;
    ``make_sc_decoder_trellis``).  All give the same bits.
    """
    dev = resolve_device(device)
    if impl is None:
        impl = "mega" if dev.type == "cuda" else "unrolled"
    if impl == "unrolled":
        from .fastsc import make_sc_decoder_unrolled

        inner = make_sc_decoder_unrolled(N, frozen_mask, dtype)
    elif impl == "mega":
        from ...ops.sc_mega_cuda import make_sc_decoder_mega

        inner = make_sc_decoder_mega(N, frozen_mask, dtype)
    elif impl == "scan":
        inner = make_sc_decoder_trellis(N, frozen_mask, dtype)
    else:
        raise ValueError(f"unknown impl {impl!r}")

    def decode(llr):
        return inner(torch.as_tensor(llr, device=dev))

    decode.impl = impl
    return decode


class SCDecoder(nn.Module):
    """Batched SC decoder.

    ``decode`` accepts ``[N]`` or ``[..., N]`` channel LLRs (positive ⇒ bit 0
    more likely) and returns the K info bits per frame.
    """

    def __init__(self, N: int, K: int, frozen_bits: Optional[np.ndarray] = None,
                 dtype=torch.float32, impl: Optional[str] = None, device="cuda"):
        super().__init__()
        assert N > 0 and (N & (N - 1)) == 0, "N must be a power of 2"
        assert 0 < K < N, "K must be in (0, N)"
        self.N = N
        self.K = K
        self.n = int(np.log2(N))
        if frozen_bits is None:
            self.frozen_bits, self.info_bits = generate_frozen_bits(N, K)
        else:
            self.frozen_bits = np.sort(np.asarray(frozen_bits, dtype=np.int64))
            self.info_bits = np.setdiff1d(np.arange(N), self.frozen_bits)
        self.frozen_mask = frozen_mask_from_positions(N, self.frozen_bits)
        self.dtype = dtype
        dev = resolve_device(device)
        self.register_buffer(
            "_info_idx", torch.as_tensor(self.info_bits, dtype=torch.int64, device=dev))
        self._decode_full = make_sc_decoder(N, self.frozen_mask, dtype, impl, dev)
        self.impl = self._decode_full.impl

    def decode_full(self, llr):
        """Decode to the full u-vector ``[..., N]``."""
        return self._decode_full(torch.as_tensor(llr, device=self._info_idx.device).to(self.dtype))

    def decode(self, llr):
        """Decode to info bits ``[..., K]``."""
        return self.decode_full(llr)[..., self._info_idx]

    forward = decode

    def __repr__(self) -> str:
        return f"SCDecoder(N={self.N}, K={self.K})"
