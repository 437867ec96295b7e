"""Unrolled recursive SCL decoder (``make_scl_decoder(impl="unrolled")``).

The recursion of ``fastsc.py`` with a list axis: state is ``alpha [B, L, M]``
per node plus path metrics ``pm [B, L]``, in natural order (even / odd
deinterleave at every node).

Lazy permutation composition: pruning at an info leaf permutes the list axis
of all live state.  Nothing is re-indexed at the prune except the metrics;
each subtree *returns* the relative permutation ``R`` accumulated inside it
(``state_after[l] = state_before[R[l]]``, composed leaf to root), and each
live alpha / beta segment is re-indexed once, when its parent consumes it.
``R`` is a *selection*, not a bijection (survivors duplicate forked parents),
so it is composed forward like this.  A subtree prunes iff it holds an info
leaf, which is static: rate-0 subtrees collapse into a metric update.

``use_onehot=True`` (the default, as in the JAX package) carries ``R`` as a
one-hot plane ``[B, L, L]`` and re-indexes by one-hot multiply-add sums
(``scanscl._apply_perm``); ``False`` carries rank vectors and gathers.  The
candidate order (bit-0 block, then bit-1 block, stable descending, the lower
index winning a tie) and the −inf phantom paths are those of the chunked
decoder, so the outputs are equal to it.  The root returns the re-encoded
codeword β; ``u = β·G_N``.

Plain PyTorch on the device of the decoder; the JAX package's counterpart is
plain XLA too (no Pallas kernel).
"""

from __future__ import annotations

import numpy as np
import torch

from ...core.device import resolve_device
from .encoder import polar_transform
from .scanscl import (_apply_perm, _apply_perm_bits, _compose, _d0_d1, _prune_onehot,
                      _prune_rank)
from .trellis import f_minsum


def _reindex(x, r):
    """Gather the list axis of ``x [B, L, M]`` by the rank vector ``r [B, L]``."""
    return torch.gather(x, 1, r[:, :, None].expand(-1, -1, x.shape[-1]))


def make_scl_decoder_unrolled(N: int, frozen_mask: np.ndarray, list_size: int,
                              dtype=torch.float32, use_onehot: bool = True, device="cuda"):
    """Build an unrolled SCL decoder: ``decode(llr [B, N]) → (u [B, L, N]
    int8, metrics [B, L])``, the contract of ``scl.make_scl_decoder``.

    ``use_onehot`` runs the prunes' selections and the re-indexing as one-hot
    planes (``True``, the default) or as rank vectors and gathers; the
    outputs are equal either way."""
    frozen_mask = np.asarray(frozen_mask, bool)
    assert frozen_mask.shape == (N,)
    dev = resolve_device(device)
    Lsz = list_size

    def rate0_metric(alpha):
        """Σ log P(0 | leaf llr) over an all-frozen subtree → ``[B, L]``."""
        if alpha.shape[-1] == 1:
            return _d0_d1(alpha[..., 0])[0]
        e, o = alpha[..., 0::2], alpha[..., 1::2]
        return rate0_metric(f_minsum(e, o)) + rate0_metric(o + e)

    def node(alpha, pm, off: int, step: int, size: int):
        """``(beta, pm, R)``: beta under the post-subtree list order, ``R``
        (None when the subtree never prunes) mapping post-subtree slots to
        node-entry slots."""
        sub = frozen_mask[off: off + size * step: step]
        if sub.all():  # rate-0: metrics only, no prune
            return (torch.zeros(alpha.shape, dtype=torch.int8, device=alpha.device),
                    pm + rate0_metric(alpha), None)
        if size == 1:  # info leaf: branch + prune
            d0, d1 = _d0_d1(alpha[..., 0])
            cand = torch.cat([pm + d0, pm + d1], dim=1)  # [B, 2L]
            prune = _prune_onehot if use_onehot else _prune_rank
            second, pm, R = prune(cand, Lsz)
            return second.to(torch.int8)[:, :, None], pm, R
        half = size // 2
        a_even, a_odd = alpha[..., 0::2], alpha[..., 1::2]
        beta_e, pm, R_l = node(f_minsum(a_even, a_odd), pm, off, 2 * step, half)
        if R_l is not None:  # one re-index of the whole alpha
            alpha = _apply_perm(R_l, alpha) if use_onehot else _reindex(alpha, R_l)
            a_even, a_odd = alpha[..., 0::2], alpha[..., 1::2]
        sgn = 1.0 - 2.0 * beta_e.to(alpha.dtype)
        beta_o, pm, R_r = node(a_odd + sgn * a_even, pm, off + step, 2 * step, half)
        if R_r is not None:
            beta_e = _apply_perm_bits(R_r, beta_e) if use_onehot else _reindex(beta_e, R_r)
        upper = beta_e ^ beta_o
        beta = torch.stack([upper, beta_o], dim=-1).reshape(*upper.shape[:-1], 2 * half)
        if R_l is None:
            R = R_r
        elif R_r is None:
            R = R_l
        elif use_onehot:  # out = R_r · (R_l · in)
            R = _compose(R_r, R_l)
        else:  # state_out[l] = state_in[R_l[R_r[l]]]
            R = torch.gather(R_l, 1, R_r)
        return beta, pm, R

    def decode(llr):
        llr = torch.as_tensor(llr, device=dev).to(dtype)
        assert llr.dim() == 2 and llr.shape[1] == N, "SCL decode expects [batch, N]"
        batch = llr.shape[0]
        alpha = llr[:, None, :].expand(batch, Lsz, N)
        pm = torch.full((batch, Lsz), -torch.inf, dtype=dtype, device=dev)
        pm[:, 0] = 0.0
        beta, pm, _ = node(alpha, pm, 0, 1, N)
        return polar_transform(beta), pm

    decode.control_impl = None
    decode.live_width = False
    return decode
