"""Belief-propagation (sum-product) LDPC decoder over a batch of frames —
the plain PyTorch version of the fused BP kernel (``ops/bp_cuda.py``).

Dense padded-edge tensor ops (see ``graph.py``) with the reference semantics:

* check update ``2·atanh(Π_{v'≠v} tanh(m/2))`` with tanh clipped to
  ±0.999999 pre- and post-product and ±20 infinity saturation; the
  leave-one-out product is computed by exclusive prefix/suffix products (no
  division — exact even with zero messages), swept slot by slot so this
  version and the kernel multiply in one order; ``2·atanh(p)`` is written
  ``log1p(p) − log1p(−p)``, again as the kernel writes it;
* variable update total-minus-self, the slot sum taken in slot order;
* hard decision ``total ≤ 0 → 1``;
* early stop on zero syndrome with per-frame actual iteration counts —
  frames in a batch latch their first converged output independently; the
  loop exits early only when *every* frame in the batch has converged.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch
from torch import nn

from ...core.device import resolve_device
from .graph import TannerGraph

_TANH_CLIP = 0.999999
_SAT = 20.0


def _exclusive_sweep(x: torch.Tensor, identity: float, op) -> torch.Tensor:
    """Leave-one-out reduction along the last axis: ``op`` of the exclusive
    prefix and the exclusive suffix, each swept one slot at a time."""
    d = x.shape[-1]
    run = torch.full_like(x[..., 0], identity)
    pre = []
    for s in range(d):
        pre.append(run)
        run = op(run, x[..., s])
    run = torch.full_like(x[..., 0], identity)
    out = [None] * d
    for s in range(d - 1, -1, -1):
        out[s] = op(pre[s], run)
        run = op(run, x[..., s])
    return torch.stack(out, dim=-1)


def _exclusive_products(x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Leave-one-out products along the last axis (masked slots → 1)."""
    x = torch.where(mask, x, torch.ones_like(x))
    return _exclusive_sweep(x, 1.0, torch.mul)


def bp_check_update(v2c_checkmajor: torch.Tensor, mask: torch.Tensor, dtype) -> torch.Tensor:
    """Sum-product check-node update."""
    t = torch.tanh(v2c_checkmajor * 0.5)
    t = torch.clamp(t, -_TANH_CLIP, _TANH_CLIP)
    prod = _exclusive_products(t, mask)
    prod = torch.clamp(prod, -_TANH_CLIP, _TANH_CLIP)
    out = torch.log1p(prod) - torch.log1p(-prod)  # 2·atanh(prod)
    # clipped atanh is finite; keep the reference saturation all the same
    return torch.nan_to_num(out, nan=0.0, posinf=_SAT, neginf=-_SAT).to(dtype)


def make_bp_decoder(graph: TannerGraph, max_iter: int = 50, early_stop: bool = True,
                    dtype=torch.float32, check_update=None):
    """Build the plain message-passing decoder for a fixed Tanner graph.

    Returns ``decode(llr: [batch, n]) -> (bits [batch, n] int8,
    iters [batch] int32)`` on the graph's device.
    """
    if check_update is None:
        check_update = lambda msgs, mask: bp_check_update(msgs, mask, dtype)
    g = graph

    def decode(llr):
        llr = torch.as_tensor(llr, device=g.device).to(dtype)
        assert llr.dim() == 2, "decode expects [batch, n]"
        batch = llr.shape[0]
        v2c = llr[..., None].expand(batch, g.n, g.dv_max)
        bits = (llr <= 0).to(torch.int8)
        done = torch.zeros(batch, dtype=torch.bool, device=llr.device)
        latched = bits
        iters = torch.full((batch,), max_iter, dtype=torch.int32, device=llr.device)
        for it in range(max_iter):
            if early_stop and bool(done.all()):
                break
            # 1. check-node update
            c2v_cm = check_update(g.gather_var_to_check(v2c), g.check_mask)
            # 2. variable-node update
            c2v_vm = g.gather_check_to_var(c2v_cm)
            c2v_vm = torch.where(g.var_mask, c2v_vm, torch.zeros_like(c2v_vm))
            acc = c2v_vm[..., 0]
            for sp in range(1, g.dv_max):
                acc = acc + c2v_vm[..., sp]
            totals = llr + acc
            v2c = totals[..., None] - c2v_vm
            # 3. hard decision
            bits = (totals <= 0).to(torch.int8)
            # 4. convergence
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


class BPDecoder(nn.Module):
    """Batched sum-product decoder.

    ``impl``: ``"cuda"`` (the fused kernel of ``ops/bp_cuda.py`` — float32,
    the default on a CUDA device) or ``"torch"`` (the plain version, the
    default on the CPU).
    """

    # kernel check rule and schedule; the min-sum and layered subclasses
    # override them
    _check_rule = "bp"
    _schedule = "flooding"
    normalization = 1.0
    offset = 0.0
    num_layers = 4

    def __init__(self, H: np.ndarray, max_iter: int = 50, early_stop: bool = True,
                 dtype=torch.float32, impl: Optional[str] = None, device="cuda"):
        super().__init__()
        self.H = np.asarray(H)
        self.m, self.n = self.H.shape
        self.max_iter = max_iter
        self.early_stop = early_stop
        self.dtype = dtype
        dev = resolve_device(device)
        self.graph = TannerGraph.from_H(self.H, dev)
        from ...ops.bp_cuda import resolve_bp_impl

        self._run_fn, self.impl = resolve_bp_impl(
            self.graph, self._make_plain_decoder(), max_iter, early_stop,
            dtype, impl, self._check_rule, self.normalization, self.offset,
            schedule=self._schedule, num_layers=self.num_layers)

    def _make_plain_decoder(self):
        return make_bp_decoder(self.graph, self.max_iter, self.early_stop,
                               self.dtype)

    def decode(self, llr, return_iterations: bool = False):
        """Decode ``[n]`` or ``[batch, n]`` LLRs to hard bits (full codeword).

        With ``return_iterations=True`` also returns per-frame iteration
        counts.
        """
        llr = torch.as_tensor(llr, device=self.graph.device).to(self.dtype)
        squeeze = llr.dim() == 1
        bits, iters = self._run_fn(torch.atleast_2d(llr))
        if squeeze:
            bits, iters = bits[0], iters[0]
        return (bits, iters) if return_iterations else bits

    forward = decode

    def __repr__(self) -> str:
        return f"BPDecoder(n={self.n}, m={self.m}, max_iter={self.max_iter})"
