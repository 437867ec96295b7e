"""Row-layered (scheduled) min-sum LDPC decoding — the serving schedule, and
the plain PyTorch version of the layered mode of the fused LDPC kernel
(``ops/bp_cuda.py``, ``schedule="layered"``).

Flooding updates all checks from one message snapshot; row-layered scheduling
updates check groups one after the other within an iteration, so later groups
see fresher variable totals and the decoder converges in clearly fewer
iterations.  Opt-in: flooding stays the default.

Semantics (those of the JAX package's ``models/ldpc/layered.py`` and its
float64 NumPy twin):

* layers = ``np.array_split`` contiguous check groups (``layer_bounds``);
* per layer: ``qtemp = Q[v] − R_old`` per edge, read for the WHOLE layer
  before any total changes; min-sum leave-one-out with the α / β /
  ``sign(0) = 0`` / degree-1 → 0 rules of ``minsum.ms_check_update``; then the
  totals absorb ``R_new − R_old`` in variable-slot order.  Contiguous layers
  may hold two edges of one variable; each (variable, slot) pair receives
  from exactly one edge, so the slot-wise adds are the entire float ordering;
* hard decision, syndrome early stop after a whole iteration and
  first-converged latching exactly as ``bp.make_bp_decoder``.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from .graph import TannerGraph
from .minsum import MSDecoder, ms_check_update


def layer_bounds(m: int, num_layers: int) -> list[tuple[int, int]]:
    """Contiguous (start, stop) check-index bounds shared by the plain
    decoder, the kernel and the QC roll path."""
    splits = np.array_split(np.arange(m), num_layers)
    return [(int(s[0]), int(s[-1]) + 1) for s in splits if len(s)]


def make_layered_ms_decoder(graph: TannerGraph, max_iter: int = 50,
                            normalization: float = 1.0, offset: float = 0.0,
                            early_stop: bool = True, dtype=torch.float32,
                            num_layers: int = 4):
    """Build the plain layered min-sum decoder.

    Returns ``decode(llr [batch, n]) → (bits [batch, n] int8, iters [batch]
    int32)`` on the graph's device: the contract and latching of
    ``bp.make_bp_decoder``.
    """
    g = graph
    bounds = layer_bounds(g.m, num_layers)

    def decode(llr):
        llr = torch.as_tensor(llr, device=g.device).to(dtype)
        assert llr.dim() == 2, "decode expects [batch, n]"
        batch = llr.shape[0]
        Q = llr
        R = torch.zeros((batch, g.m, g.dc_max), dtype=dtype, device=llr.device)
        bits = (llr <= 0).to(torch.int8)
        done = torch.zeros(batch, dtype=torch.bool, device=llr.device)
        latched = bits
        iters = torch.full((batch,), max_iter, dtype=torch.int32, device=llr.device)
        for it in range(max_iter):
            if early_stop and bool(done.all()):
                break
            for c0, c1 in bounds:
                r_old = R[:, c0:c1]
                q_at = Q[:, g.check_vars[c0:c1]]  # [B, mg, dc]
                mask = g.check_mask[c0:c1]
                qtemp = torch.where(mask, q_at - r_old, torch.zeros_like(r_old))
                r_new = ms_check_update(qtemp, mask, normalization, offset, dtype)
                # route the deltas through the check→var gather: each (v, slot)
                # receives from exactly one edge, so the order of the slot-wise
                # adds below is the entire float ordering
                delta_cm = torch.zeros_like(R)
                delta_cm[:, c0:c1] = torch.where(mask, r_new - r_old,
                                                 torch.zeros_like(r_old))
                delta_vm = g.gather_check_to_var(delta_cm)
                delta_vm = torch.where(g.var_mask, delta_vm, torch.zeros_like(delta_vm))
                for sp in range(g.dv_max):
                    Q = Q + delta_vm[..., sp]
                R[:, c0:c1] = torch.where(mask, r_new, torch.zeros_like(r_new))
            bits = (Q <= 0).to(torch.int8)
            if early_stop:
                ok = (g.syndrome(bits) == 0).all(dim=-1)
                newly = ok & ~done
                latched = torch.where(newly[:, None], bits, latched)
                iters = torch.where(newly, it + 1, iters).to(torch.int32)
                done = done | ok
        if early_stop:
            bits = torch.where(done[:, None], latched, bits)
        return bits, iters

    return decode


class LayeredMSDecoder(MSDecoder):
    """Row-layered min-sum decoder (serving schedule; opt-in — flooding stays
    the default).

    Same public API as ``MSDecoder``; ``num_layers`` picks the check grouping.
    ``impl``: ``"cuda"`` (the layered mode of the fused kernel; float32, the
    default on a CUDA device) or ``"torch"`` (the plain version, the default
    on the CPU); both give the same bits and iteration counts.
    """

    _schedule = "layered"

    def __init__(self, H: np.ndarray, max_iter: int = 50,
                 normalization: float = 1.0, offset: float = 0.0,
                 early_stop: bool = True, dtype=torch.float32,
                 impl: Optional[str] = None, num_layers: int = 4, device="cuda"):
        self.num_layers = num_layers
        super().__init__(H, max_iter, normalization, offset, early_stop,
                         dtype, impl, device)

    def _make_plain_decoder(self):
        return make_layered_ms_decoder(self.graph, self.max_iter,
                                       self.normalization, self.offset,
                                       self.early_stop, self.dtype,
                                       self.num_layers)

    def __repr__(self) -> str:
        return (f"LayeredMSDecoder(n={self.n}, m={self.m}, "
                f"max_iter={self.max_iter}, layers={self.num_layers}, "
                f"norm={self.normalization}, offset={self.offset})")
