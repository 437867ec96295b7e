"""Min-Sum LDPC decoders: plain/normalized (NMS) and offset (OMS).

Check update is sign-product × leave-one-out min-magnitude × normalization α
(``sign(0) = 0`` zero-propagation is preserved); variable update and early
stop are identical to BP.  The offset variant (β): magnitude
``max(min − β, 0)``.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from .bp import BPDecoder, _exclusive_products, _exclusive_sweep, make_bp_decoder
from .graph import TannerGraph


def _exclusive_min(x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Leave-one-out minimum along the last axis (masked slots → +inf)."""
    x = torch.where(mask, x, torch.full_like(x, float("inf")))
    return _exclusive_sweep(x, float("inf"), torch.minimum)


def ms_check_update(v2c_checkmajor: torch.Tensor, mask: torch.Tensor,
                    normalization: float = 1.0, offset: float = 0.0,
                    dtype=torch.float32) -> torch.Tensor:
    """Min-sum check-node update."""
    signs = torch.sign(v2c_checkmajor)  # sign(0) = 0, as in the reference
    sign_prod = _exclusive_products(signs, mask)
    mags = _exclusive_min(v2c_checkmajor.abs(), mask)
    if offset:
        mags = torch.clamp_min(mags - offset, 0.0)
    out = sign_prod * mags * normalization
    # a degree-1 (or fully padded) row yields inf·0 → NaN; treat as 0
    return torch.nan_to_num(out, nan=0.0, posinf=0.0, neginf=0.0).to(dtype)


def make_ms_decoder(graph: TannerGraph, max_iter: int = 50,
                    normalization: float = 1.0, offset: float = 0.0,
                    early_stop: bool = True, dtype=torch.float32):
    check = lambda msgs, mask: ms_check_update(msgs, mask, normalization, offset, dtype)
    return make_bp_decoder(graph, max_iter, early_stop, dtype, check_update=check)


class MSDecoder(BPDecoder):
    """Batched Min-Sum decoder, with optional normalization and offset.

    Shares the resolve/run/decode machinery with ``BPDecoder`` (only the
    check rule differs); ``impl`` as there.
    """

    _check_rule = "ms"

    def __init__(self, H: np.ndarray, max_iter: int = 50,
                 normalization: float = 1.0, offset: float = 0.0,
                 early_stop: bool = True, dtype=torch.float32,
                 impl: Optional[str] = None, device="cuda"):
        self.normalization = normalization
        self.offset = offset
        super().__init__(H, max_iter, early_stop, dtype, impl, device)

    def _make_plain_decoder(self):
        return make_ms_decoder(self.graph, self.max_iter, self.normalization,
                               self.offset, self.early_stop, self.dtype)

    def __repr__(self) -> str:
        return (f"MSDecoder(n={self.n}, m={self.m}, max_iter={self.max_iter}, "
                f"norm={self.normalization}, offset={self.offset})")


class NMSDecoder(MSDecoder):
    """Normalized Min-Sum (α-scaled)."""

    def __init__(self, H, max_iter: int = 50, normalization: float = 0.75,
                 early_stop: bool = True, dtype=torch.float32,
                 impl: Optional[str] = None, device="cuda"):
        super().__init__(H, max_iter, normalization, 0.0, early_stop, dtype,
                         impl, device)


class OMSDecoder(MSDecoder):
    """Offset Min-Sum (β-offset)."""

    def __init__(self, H, max_iter: int = 50, offset: float = 0.5,
                 early_stop: bool = True, dtype=torch.float32,
                 impl: Optional[str] = None, device="cuda"):
        super().__init__(H, max_iter, 1.0, offset, early_stop, dtype,
                         impl, device)
