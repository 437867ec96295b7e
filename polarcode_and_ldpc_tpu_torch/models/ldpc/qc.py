"""Quasi-cyclic LDPC message passing — the large-code path.

The generic decoder (``bp.py`` + ``graph.py``) moves messages between the
check-major and the var-major layout through gather tables, and its fused
kernel keeps every message of a frame in one thread block's shared memory;
neither the tables nor the block hold the n=8192 code.

For quasi-cyclic codes the permutation *is* structure: every H block is a
circulant ``roll(I_z, s)``, so moving a z-block of messages between layouts is
``torch.roll(block, ±s)``.  Messages live check-major as ``[batch, mb, dc, z]``;
one iteration is a static loop over the *base-graph* edges (a few dozen) of
roll / add ops plus the same leave-one-out reductions as the generic decoder.
This module is plain PyTorch on the device it is given: its counterpart in the
JAX package reaches no hand-written kernel either.

Numerics are those of the generic decoder (same clip / ±20 saturation, same
exclusive-sweep order, base edges enumerated in ascending variable / check
order exactly as ``graph.py`` orders neighbour slots, the slot sum taken in
slot order before the channel LLR is added), so a QC code decodes identically
through either path; tests hold it to that.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch
from torch import nn

from ...core.device import resolve_device
from .bp import bp_check_update
from .minsum import ms_check_update

_MS_VARIANTS = ("ms", "nms", "oms", "min-sum")


def _base_edges(base: np.ndarray):
    """Edge lists of the base graph.

    Returns ``(check_rows, var_cols)``: ``check_rows[bi]`` is the list of
    ``(bj, shift, slot_in_var)`` ascending in bj; ``var_cols[bj]`` the list of
    ``(bi, slot_in_check, shift)`` ascending in bi.  Slot orders match
    ``graph.tanner_tables_from_H`` neighbour ordering (ascending indices), so
    reduction orders, and therefore float32 results, agree with the generic
    decoder.
    """
    base = np.asarray(base)
    mb, nb = base.shape
    check_rows = [[(bj, int(base[bi, bj])) for bj in range(nb)
                   if base[bi, bj] >= 0] for bi in range(mb)]
    var_cols = [[(bi, int(base[bi, bj])) for bi in range(mb)
                 if base[bi, bj] >= 0] for bj in range(nb)]
    slot_in_check = {(bi, bj): s_c for bi, row in enumerate(check_rows)
                     for s_c, (bj, _) in enumerate(row)}
    slot_in_var = {(bi, bj): s_v for bj, col in enumerate(var_cols)
                   for s_v, (bi, _) in enumerate(col)}
    rows = [[(bj, sh, slot_in_var[(bi, bj)]) for (bj, sh) in row]
            for bi, row in enumerate(check_rows)]
    cols = [[(bi, slot_in_check[(bi, bj)], sh) for (bi, sh) in col]
            for bj, col in enumerate(var_cols)]
    return rows, cols


def make_qc_bp_decoder(base: np.ndarray, z: int, max_iter: int = 50,
                       early_stop: bool = True, dtype=torch.float32,
                       variant: str = "bp", normalization: float = 1.0,
                       offset: float = 0.0, schedule: str = "flooding",
                       device="cuda"):
    """Build a roll-based BP / min-sum decoder for a QC code.

    ``base`` is the ``[mb, nb]`` shift matrix (−1 = no edge) from
    ``matrix.qc_base_matrix``; the code length is ``nb·z``.  Returns
    ``decode(llr [batch, n]) → (bits [batch, n] int8, iters [batch] int32)``
    with the early-stop latching of ``bp.make_bp_decoder`` (per-frame
    first-converged outputs).

    ``schedule="layered"`` (min-sum only): the base rows ARE the layers — each
    block row touches every variable block at most once, so the update within
    a layer is conflict-free by construction.  Equal (bits and iteration
    counts) to the generic layered decoder (``layered.py``) on the expanded H
    with ``num_layers = mb``.
    """
    dev = resolve_device(device)
    base = np.asarray(base)
    mb, nb = base.shape
    rows, cols = _base_edges(base)
    if schedule not in ("flooding", "layered"):
        raise ValueError(f"unknown schedule {schedule!r}")
    if schedule == "layered" and variant not in _MS_VARIANTS:
        raise ValueError("the layered schedule is min-sum only")
    dcs = {len(r) for r in rows}
    dvs = {len(c) for c in cols}
    if len(dcs) != 1 or len(dvs) != 1:
        raise ValueError(
            "the roll-based QC decoder expects a regular base graph; use the "
            "generic TannerGraph decoder for irregular codes")
    dc = dcs.pop()
    n = nb * z
    mask = torch.ones((dc,), dtype=torch.bool, device=dev)  # regular rows: no padded slots

    if variant == "bp":
        update = lambda msgs: bp_check_update(msgs, mask, dtype)
    elif variant in _MS_VARIANTS:
        update = lambda msgs: ms_check_update(msgs, mask, normalization, offset, dtype)
    else:
        raise ValueError(f"unknown QC BP variant {variant!r}")

    def check_update(msgs):
        """The leave-one-out reductions run along the LAST axis; messages live
        ``[..., dc, z]``, so put dc last for the update and back."""
        return update(msgs.transpose(-1, -2)).transpose(-1, -2)

    def row_to_check_major(blocks, bi):
        """var blocks ``[B, nb, z]`` → block row bi check-major ``[B, dc, z]``:
        check r of block (bi, bj, s) reads variable (r + s) mod z."""
        return torch.stack([torch.roll(blocks[:, bj], -sh, dims=-1)
                            for (bj, sh, _sv) in rows[bi]], dim=1)

    def to_check_major(blocks):
        return torch.stack([row_to_check_major(blocks, bi) for bi in range(mb)], dim=1)

    def syndrome_ok(bits_blocks):
        """``[B, nb, z]`` int8 → ``[B]`` bool: every check block's XOR of its
        connected variable bits is zero."""
        ok = None
        for bi in range(mb):
            syn = row_to_check_major(bits_blocks, bi).sum(dim=1, dtype=torch.int32) % 2
            row_ok = (syn == 0).all(dim=-1)
            ok = row_ok if ok is None else ok & row_ok
        return ok

    def run(llr, init, one_iteration):
        """The shared iteration loop with per-frame first-converged latching."""
        batch = llr.shape[0]
        state = init
        bits = (llr <= 0).to(torch.int8)
        done = torch.zeros(batch, dtype=torch.bool, device=llr.device)
        latched = bits
        iters = torch.full((batch,), max_iter, dtype=torch.int32, device=llr.device)
        for it in range(max_iter):
            if early_stop and bool(done.all()):
                break
            state, totals = one_iteration(state)
            bits_blocks = (totals <= 0).to(torch.int8)
            bits = bits_blocks.reshape(batch, n)
            if early_stop:
                ok = syndrome_ok(bits_blocks)
                newly = ok & ~done
                latched = torch.where(newly[:, None], bits, latched)
                iters = torch.where(newly, it + 1, iters).to(torch.int32)
                done = done | ok
        if early_stop:
            bits = torch.where(done[:, None], latched, bits)
        return bits, iters

    def prepare(llr):
        llr = torch.as_tensor(llr, device=dev).to(dtype)
        assert llr.dim() == 2 and llr.shape[1] == n, f"expected [batch, {n}]"
        return llr

    def decode_layered(llr):
        llr = prepare(llr)
        batch = llr.shape[0]
        Q0 = llr.reshape(batch, nb, z).clone()
        R0 = torch.zeros((batch, mb, dc, z), dtype=dtype, device=llr.device)

        def one_iteration(state):
            Q, R = state  # updated in place: this decode owns both
            for bi in range(mb):  # base rows ARE the layers (conflict-free)
                r_old = R[:, bi]
                r_new = check_update(row_to_check_major(Q, bi) - r_old)
                delta = r_new - r_old
                R[:, bi] = r_new
                for si, (bj, sh, _sv) in enumerate(rows[bi]):
                    Q[:, bj] += torch.roll(delta[:, si], sh, dims=-1)
            return (Q, R), Q

        return run(llr, (Q0, R0), one_iteration)

    def decode(llr):
        llr = prepare(llr)
        batch = llr.shape[0]
        llr_blocks = llr.reshape(batch, nb, z)

        def one_iteration(v2c):
            c2v = check_update(v2c)  # [B, mb, dc, z]
            # variable totals: the incident c2v summed in ascending check order
            # (the var-major slot order of graph.py), then the channel LLR
            totals = []
            for bj in range(nb):
                acc = None
                for (bi, sc, sh) in cols[bj]:
                    contrib = torch.roll(c2v[:, bi, sc], sh, dims=-1)
                    acc = contrib if acc is None else acc + contrib
                totals.append(llr_blocks[:, bj] + acc)
            totals = torch.stack(totals, dim=1)  # [B, nb, z]
            return to_check_major(totals) - c2v, totals  # v2c = total − self

        return run(llr, to_check_major(llr_blocks), one_iteration)

    return decode_layered if schedule == "layered" else decode


class QCBPDecoder(nn.Module):
    """Roll-based QC-LDPC decoder (BP or min-sum) for large codes.

    Construct from a shift matrix (``matrix.qc_base_matrix``) + lift size.
    ``.H`` exposes the dense parity-check for the encoder path.
    """

    def __init__(self, base: np.ndarray, z: int, max_iter: int = 50,
                 early_stop: bool = True, dtype=torch.float32,
                 variant: str = "bp", normalization: float = 1.0,
                 offset: float = 0.0, schedule: str = "flooding", device="cuda"):
        super().__init__()
        self.base = np.asarray(base)
        self.z = z
        self.mb, self.nb = self.base.shape
        self.n = self.nb * z
        self.m = self.mb * z
        self.max_iter = max_iter
        self.variant = variant
        self.schedule = schedule
        self.dtype = dtype
        self._H: Optional[np.ndarray] = None
        self._device = resolve_device(device)
        self._decode = make_qc_bp_decoder(
            self.base, z, max_iter, early_stop, dtype, variant, normalization,
            offset, schedule, self._device)

    @property
    def H(self) -> np.ndarray:
        if self._H is None:
            from .matrix import qc_expand

            self._H = qc_expand(self.base, self.z)
        return self._H

    def decode(self, llr, return_iterations: bool = False):
        llr = torch.as_tensor(llr, device=self._device).to(self.dtype)
        squeeze = llr.dim() == 1
        bits, iters = self._decode(torch.atleast_2d(llr))
        if squeeze:
            bits, iters = bits[0], iters[0]
        return (bits, iters) if return_iterations else bits

    forward = decode

    def __repr__(self) -> str:
        return (f"QCBPDecoder(n={self.n}, m={self.m}, z={self.z}, "
                f"variant={self.variant!r}, max_iter={self.max_iter})")
