"""Chunked SCL decoder: the plain PyTorch version and the decoder factory.

The code tree is cut at subtree size ``S``; the ``C = N/S`` chunks are
decoded in DFS order by a straight-line program.  Between chunks the alphas
and left betas of the outer levels ``1..t`` (``t = log2 C``) live in
per-level stacks.  Pruning at info leaves permutes the list axis of all live
state; each outer level keeps a *pending* list permutation that is composed
with a chunk's relative permutation after the chunk and applied only when a
schedule event actually reads the level (lazy list permutations).

* **frame-major layout**: every tensor carries the frame batch first:
  alphas ``[B, L, M]``, metrics ``[B, L]``; list permutations as rank
  vectors ``[B, L]`` (``perm_impl="rank"``: ``out[l] = in[r[l]]``, a
  *selection*, rows may repeat, so it is applied with a gather) or as one-hot
  planes ``[B, L, L]`` in the decoder's dtype (``perm_impl="onehot"``:
  ``out[l] = Σ_j P[l, j]·in[j]``, applied and composed by multiply-adds);
* **bit-reversed storage**: the channel LLRs are permuted once so every
  even/odd deinterleave of the natural-order recursion is a contiguous
  half-split, and the leaf visit order in storage equals the decode order;
* **order of the candidates is the result**: at an info leaf the ``2L``
  candidates are the bit-0 paths then the bit-1 paths, ranked stable
  descending, the lower candidate index winning a tie; ``-inf`` phantom
  paths tie with each other by index and take bit 0;
* **order of the float additions is the result** too: a rate-0 subtree adds
  ONE number to a path metric, the adjacent-pair binary-tree sum of
  ``log P(0 | leaf llr)`` over the subtree's leaves in storage order.

Everything in this module is plain PyTorch on the device of its inputs; it
is the version the CUDA kernels of ``ops/scl_cuda.py`` are held against bit
for bit, and the one that runs on the CPU.  ``make_scl_decoder_scan`` builds
a decoder with a plain control (``"split"``, ``"fused"``, ``"unroll-fused"``),
a kernel control (``"unroll-kernel"`` / ``"kernel"``: one ``scl_chunk_step``
launch per chunk and one ``scl_last_chunk`` launch) or the one-launch control
(``"mega"``: the whole decode in one ``scl_decode_mega`` launch).
"""

from __future__ import annotations

import warnings
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from ...core.device import resolve_device
from .construction import bit_reverse_permutation
from .encoder import polar_transform
from .trellis import f_minsum

#: widest repetition subtree decoded by ``_rep_exact``; wider ones split
#: through the generic recursion first (the identical addition tree)
_LEVELPAR_MAX = 64

# The first multi-threaded ``torch.exp`` of a process on the CPU can return one
# thread's share of a tensor with a relative error of 1e-4 (seen in one process
# in four with torch 2.13 + MKL, an initialisation race inside the library;
# every later call is right to 1e-7).  One single-threaded call settles it:
# path metrics must not depend on which call of a process computed them.
torch.exp(torch.zeros(1))

#: the interpret-mode twins of the JAX package's Pallas controls: a CUDA
#: kernel has no interpret mode
_UNPORTED_CONTROLS = ("kernel-interpret", "unroll-kernel-interpret", "mega-interpret")
_CONTROLS = ("split", "fused", "kernel", "unroll-fused", "unroll-kernel", "mega")


# ---------------------------------------------------------------------------
# rank-vector list algebra, frame-major
# ---------------------------------------------------------------------------

def _d0_d1(a):
    """``(log P(0|llr), log P(1|llr))`` = ``(−logaddexp(0, −a),
    −logaddexp(0, a))`` with the shared ``log1p(exp(−|a|))`` term explicit."""
    t = torch.log1p(torch.exp(-a.abs()))
    zero = torch.zeros_like(a)
    return -(torch.maximum(zero, -a) + t), -(torch.maximum(zero, a) + t)


def _leaf_llrs_zero_dec(alpha):
    """All leaf LLRs of a subtree under all-zero decisions, level-parallel:
    ``alpha [B, L, M] → y [B, L, M]`` (storage order).  With every decided
    bit 0 the g update is ``second + first``, so every node of a level
    computes in one op; the float expressions are those of the serial
    recursion."""
    B, L, M = alpha.shape
    z = alpha
    m = M
    while m > 1:
        h = m // 2
        z4 = z.reshape(B, L, M // m, m)
        first, second = z4[..., :h], z4[..., h:]
        z = torch.cat([f_minsum(first, second), second + first], dim=-1).reshape(B, L, M)
        m = h
    return z


def _rate0_metric_levelpar(alpha):
    """Σ log P(0 | leaf llr) over an all-frozen subtree, ``[B, L, M] →
    [B, L]``: the adjacent-pair bottom-up sum, which is the addition tree the
    serial ``rate0(f(a, b)) + rate0(b + a)`` recursion unfolds to."""
    s = _d0_d1(_leaf_llrs_zero_dec(alpha))[0]
    while s.shape[-1] > 1:
        s = s[..., 0::2] + s[..., 1::2]
    return s[..., 0]


def _rep_exact(alpha, pm, Lsz, info_leaf, leaf_impl="onehot"):
    """Exact repetition node (all leaves frozen except the last in decode
    order), equal to the leaf-by-leaf recursion: all leaf LLRs come from the
    zero-decision pass; the left rate-0 blocks' tree sums (the intermediate
    values of the adjacent-pair reduction of the leaf ``d0`` array) are
    added to the metric one by one from the largest block to the smallest;
    the last leaf runs the algebra's info-leaf prune and the node codeword is
    its bit repeated.  ``alpha [B, L, M]``, ``pm [B, L]`` → ``(beta, pm',
    R)``."""
    M = alpha.shape[-1]
    y = _leaf_llrs_zero_dec(alpha)
    s = _d0_d1(y)[0]
    captures = []
    while True:
        m = s.shape[-1]
        captures.append(s[..., m - 2])
        if m == 2:
            break
        s = s[..., 0::2] + s[..., 1::2]
    for b in reversed(captures):
        pm = pm + b
    bits, pm, R = info_leaf(y[..., M - 1], pm, Lsz, leaf_impl)
    return bits.expand(-1, -1, M), pm, R


def _apply_perm_rank(r, x):
    """Rank vector ``r [B, L]`` applied to ``x [B, J, M]`` → ``[B, L, M]``:
    ``out[l] = x[r[l]]``.  A gather: exact for any dtype and values."""
    return torch.gather(x, 1, r[:, :, None].expand(-1, -1, x.shape[-1]))


def _apply_perm_rank_bits_packed(r, x):
    """Rank apply on 0/1 bit planes ``x [B, J, M]`` int8.  The same gather
    (the kernels apply it on path bits packed into one word per position)."""
    return _apply_perm_rank(r, x)


def _compose_rank(a, b):
    """Composition (apply ``b`` first, then ``a``): ``c[l] = b[a[l]]``."""
    return torch.gather(b, 1, a)


def _cand_ranks(cand):
    """Stable-descending rank of each candidate of ``cand [B, 2·lv]``:
    candidate ``i`` goes before candidate ``j`` iff its metric is larger, or
    equal with ``i < j`` (all-pairs ranks: exact, stable, no reliance on a
    sort's tie behaviour)."""
    two = cand.shape[1]
    ci, cj = cand[:, :, None], cand[:, None, :]
    idx = torch.arange(two, device=cand.device)
    jlti = idx[None, :] < idx[:, None]  # [i, j]: j < i
    return ((cj > ci) | ((cj == ci) & jlti)).sum(dim=2)  # [B, 2·lv]


def _prune_rank(cand, out: int, leaf_impl: str = "onehot"):
    """Stable top-``out`` of the ordered candidates ``cand [B, 2·lv]`` (first
    half: keep / bit 0, second half: flip / bit 1) → (second-half flags
    ``[B, out]`` bool, metrics ``[B, out]``, source slots ``[B, out]``).
    ``leaf_impl="onehot"`` ranks all pairs (``_cand_ranks``); ``"sort"``
    takes a stable sort of ``−cand``, which keeps the lower index first on a
    tie (finite sums never produce −0.0, so the two orders agree)."""
    two = cand.shape[1]
    lv = two // 2
    if leaf_impl == "sort":
        neg, order = torch.sort(-cand, dim=1, stable=True)
        top = order[:, :out]
        second = top >= lv
        return second, -neg[:, :out], top - lv * second.to(top.dtype)
    rank = _cand_ranks(cand)
    idx = torch.arange(two, device=cand.device)
    order = torch.empty_like(rank).scatter_(1, rank, idx.expand_as(rank))
    top = order[:, :out]
    second = top >= lv
    return second, torch.gather(cand, 1, top), top - lv * second.to(top.dtype)


def _info_leaf_rank(a, pm, Lsz, leaf_impl: str = "onehot"):
    """Branch + stable top-L prune at one info leaf.

    ``a [B, lv]`` leaf LLRs, ``pm [B, lv]`` → (bit plane ``[B, lv', 1]``
    int8, pm ``[B, lv']``, rank vector ``[B, lv']``) with ``lv' = min(2·lv,
    Lsz)``.  Width-generic: while ``lv < Lsz`` no candidate is discarded,
    only reordered."""
    lv = pm.shape[1]
    d0, d1 = _d0_d1(a)
    second, pm, r = _prune_rank(torch.cat([pm + d0, pm + d1], dim=1), min(2 * lv, Lsz),
                                leaf_impl)
    return second.to(torch.int8)[:, :, None], pm, r


def _tree_sum(x):
    """Halving-tree sum over the last axis (power-of-two extent): ``x[:h] +
    x[h:]`` until one element is left — the JAX package's ``_tree_sum`` and
    the float64 twin's order.  The fast nodes use it; rate-0 and exact REP
    nodes sum adjacent pairs instead (``_rate0_metric_levelpar``)."""
    while x.shape[-1] > 1:
        h = x.shape[-1] // 2
        x = x[..., :h] + x[..., h:]
    return x[..., 0]


def _rate1_fast(alpha, pm, Lsz, leaf_impl: str = "onehot"):
    """Fast rate-1 (all-info) list node, SSCL semantics (Hashemi et al.,
    "Fast and Flexible Successive-Cancellation List Decoders for Polar
    Codes").  Every position is hard-decided (``a < 0`` → 1) and the metric
    pays ``Σ log1p(exp(−|a|))`` (halving tree); then ``K = min(L−1, M)``
    stages walk the least-reliable positions (stable ascending ``|a|``, ties
    to the lower position), each offering every path a flip of its s-th
    least-reliable position at cost ``−|a|_(s)`` through the stable top-L
    prune.  ``alpha [B, L, M]``, ``pm [B, L]`` → ``(beta [B, L, M] int8, pm,
    R [B, L] or None)``; full list width only."""
    mags = alpha.abs()
    hard = (alpha < 0).to(torch.int8)
    pm = pm - _tree_sum(torch.log1p(torch.exp(-mags)))
    K = min(Lsz - 1, alpha.shape[-1])
    if K == 0:  # L = 1: plain hard decision, no branching
        return hard, pm, None
    smags, sidx = torch.sort(mags, dim=-1, stable=True)
    magsK, idxK = smags[..., :K], sidx[..., :K]
    fdec = torch.zeros(magsK.shape, dtype=torch.int8, device=alpha.device)
    R_tot = None
    for s in range(K):
        flip, pm, r = _prune_rank(torch.cat([pm, pm - magsK[..., s]], dim=1), Lsz, leaf_impl)
        magsK, idxK, fdec = (_apply_perm_rank(r, x) for x in (magsK, idxK, fdec))
        fdec[..., s] = flip.to(torch.int8)
        R_tot = r if R_tot is None else _compose_rank(r, R_tot)
    # the flipped positions of a path are distinct: a scatter is exact
    flips = torch.zeros_like(hard).scatter_(2, idxK, fdec)
    return _apply_perm_rank(R_tot, hard) ^ flips, pm, R_tot


def _rep_fast(alpha, pm, Lsz, leaf_impl: str = "onehot"):
    """Fast repetition node (every position frozen but the last in decode
    order): the node codeword is one bit repeated, so its two candidates are
    scored whole, ``pm + Σ log P(b | a_i)`` (halving tree), in ONE stable
    top-L prune.  ``alpha [B, L, M]`` → ``(beta [B, L, M] int8, pm, R)``."""
    d0, d1 = _d0_d1(alpha)
    bit, pm, r = _prune_rank(torch.cat([pm + _tree_sum(d0), pm + _tree_sum(d1)], dim=1), Lsz,
                             leaf_impl)
    return bit.to(torch.int8)[:, :, None].expand(-1, -1, alpha.shape[-1]), pm, r


def _identity_r_rank(Lsz, batch, device, dtype=None):
    """Identity rank vector ``[B, L]`` (``dtype`` unused: rank vectors are
    integers)."""
    return torch.arange(Lsz, device=device).expand(batch, Lsz)


def _broadcast_rows(x, L):
    """``[B, 1, M] → [B, L, M]`` (no-op when already L rows)."""
    if x.shape[1] == L:
        return x
    return x.expand(-1, L, -1)


#: rank-vector list algebra
_RANK_ALGEBRA = {
    "perm": "rank",
    "apply_perm": _apply_perm_rank,
    "apply_perm_bits": _apply_perm_rank_bits_packed,
    "compose": _compose_rank,
    "info_leaf": _info_leaf_rank,
    "identity_r": _identity_r_rank,
    "broadcast_rows": _broadcast_rows,
    "rate1_fast": _rate1_fast,
    "rep_fast": _rep_fast,
}


# ---------------------------------------------------------------------------
# one-hot list algebra, frame-major (``perm_impl="onehot"``)
#
# A selection is a one-hot plane P [B, L_out, L_in] in the decoder's dtype:
# out[l] = Σ_j P[l, j]·in[j].  Applications and compositions are literal
# multiply-add sums over j, never gathers and never a matrix product: the
# outputs equal the rank algebra's on every decision and metric, and the
# state differs from it only in the sign of a zero (a selected −0.0 comes out
# −0.0 only if every term of its sum is −0.0).  Metrics are never multiplied
# by a plane (−inf phantoms would make 0·(−inf) = NaN): they are selected by a
# masked sum.  Payloads applied through a plane are finite (alphas, bits, fast
# node magnitudes and positions), a precondition every channel meets.
# ---------------------------------------------------------------------------

def _apply_perm(P, x):
    """One-hot ``P [B, L, J]`` applied to ``x [B, J, M]`` → ``[B, L, M]``:
    ``Σ_j P[:, l, j]·x[:, j]``, the products added in ``j`` order from the
    first (no ``+0.0`` start: a sum of zeros is −0.0 iff every term is)."""
    out = P[:, :, 0, None] * x[:, None, 0, :]
    for j in range(1, x.shape[1]):
        out = out + P[:, :, j, None] * x[:, None, j, :]
    return out


def _apply_perm_bits(P, bits):
    """One-hot apply on int8 0/1 planes (exact through the float sum)."""
    return _apply_perm(P, bits.to(P.dtype)).to(torch.int8)


def _compose(A, Bm):
    """Composition (apply ``Bm`` first, then ``A``): ``C[l, k] = Σ_j A[l, j]
    ·Bm[j, k]``, the one-hot apply of ``A`` to the rows of ``Bm``.  One-hot
    inputs give a one-hot output of exact ``+0.0`` / ``1.0``."""
    return _apply_perm(A, Bm)


def _stable_topk_onehot(cand, out: int):
    """Stable-descending top-``out`` selection ``S [B, out, 2·lv]`` over the
    candidates ``cand [B, 2·lv]`` (order of ``_cand_ranks``)."""
    slots = torch.arange(out, device=cand.device)
    return (_cand_ranks(cand)[:, None, :] == slots[None, :, None]).to(cand.dtype)


def _sel_metrics(S, cand):
    """Select metrics ``[B, 2·lv] → [B, out]`` by one-hot ``S [B, out, 2·lv]``:
    a masked sum, not a product (−inf phantoms would poison ``0·(−inf)``)."""
    return torch.where(S != 0, cand[:, None, :], 0.0).sum(dim=2)


def _prune_onehot(cand, out: int, leaf_impl: str = "onehot"):
    """``_prune_rank`` with the selection as a one-hot plane: (second-half
    flags ``[B, out]`` in ``cand.dtype``, metrics ``[B, out]``, ``R [B, out,
    lv]``)."""
    lv = cand.shape[1] // 2
    if leaf_impl == "sort":
        second, pm, src = _prune_rank(cand, out, "sort")
        R = (src[:, :, None] == torch.arange(lv, device=cand.device)).to(cand.dtype)
        return second.to(cand.dtype), pm, R
    S2 = _stable_topk_onehot(cand, out)
    return S2[:, :, lv:].sum(dim=2), _sel_metrics(S2, cand), S2[:, :, :lv] + S2[:, :, lv:]


def _info_leaf(a, pm, Lsz, leaf_impl: str = "onehot"):
    """``_info_leaf_rank`` with the permutation as a one-hot ``[B, lv', lv]``
    plane."""
    lv = pm.shape[1]
    d0, d1 = _d0_d1(a)
    second, pm, R = _prune_onehot(torch.cat([pm + d0, pm + d1], dim=1), min(2 * lv, Lsz),
                                  leaf_impl)
    return second.to(torch.int8)[:, :, None], pm, R


def _rate1_fast_onehot(alpha, pm, Lsz, leaf_impl: str = "onehot"):
    """``_rate1_fast`` in the one-hot algebra: the K flip stages move the
    picked magnitudes, their positions (exact small integers in the float
    dtype) and the stage decisions through each stage's plane, compose the
    planes, and XOR the flips of every stage into the hard decisions moved
    through the composed plane."""
    dtype = alpha.dtype
    M = alpha.shape[-1]
    mags = alpha.abs()
    hard = (alpha < 0).to(torch.int8)
    pm = pm - _tree_sum(torch.log1p(torch.exp(-mags)))
    K = min(Lsz - 1, M)
    if K == 0:
        return hard, pm, None
    smags, sidx = torch.sort(mags, dim=-1, stable=True)
    magsK, idxK = smags[..., :K], sidx[..., :K].to(dtype)
    fdec = torch.zeros_like(magsK)
    R_tot = None
    for s in range(K):
        flip, pm, R = _prune_onehot(torch.cat([pm, pm - magsK[..., s]], dim=1), Lsz, leaf_impl)
        magsK, idxK, fdec = (_apply_perm(R, x) for x in (magsK, idxK, fdec))
        fdec[..., s] = flip
        R_tot = R if R_tot is None else _compose(R, R_tot)
    pos = torch.arange(M, device=alpha.device)
    hit = (pos[None, None, None, :] == torch.round(idxK).to(torch.int64)[..., None]).to(dtype)
    flips = (hit * fdec[..., None]).sum(dim=2)  # [B, L, M]
    return _apply_perm_bits(R_tot, hard) ^ torch.round(flips).to(torch.int8), pm, R_tot


def _rep_fast_onehot(alpha, pm, Lsz, leaf_impl: str = "onehot"):
    """``_rep_fast`` in the one-hot algebra."""
    d0, d1 = _d0_d1(alpha)
    bit, pm, R = _prune_onehot(torch.cat([pm + _tree_sum(d0), pm + _tree_sum(d1)], dim=1), Lsz,
                               leaf_impl)
    return bit.to(torch.int8)[:, :, None].expand(-1, -1, alpha.shape[-1]), pm, R


def _identity_r(Lsz, batch, device, dtype):
    """Identity one-hot plane ``[B, L, L]``."""
    return torch.eye(Lsz, dtype=dtype, device=device).expand(batch, Lsz, Lsz)


#: one-hot list algebra (the JAX package's default algebra of its Pallas
#: kernels and of ``make_scl_decoder_scan(perm_impl="onehot")``)
_BROADCAST_ALGEBRA = {
    "perm": "onehot",
    "apply_perm": _apply_perm,
    "apply_perm_bits": _apply_perm_bits,
    "compose": _compose,
    "info_leaf": _info_leaf,
    "identity_r": _identity_r,
    "broadcast_rows": _broadcast_rows,
    "rate1_fast": _rate1_fast_onehot,
    "rep_fast": _rep_fast_onehot,
}

_ALGEBRAS = {"rank": _RANK_ALGEBRA, "onehot": _BROADCAST_ALGEBRA}


def _ctz(x: int) -> int:
    return (x & -x).bit_length() - 1


def _make_chunk_body(flags: np.ndarray, Lsz: int, node_mode: str = "exact",
                     perm_impl: str = "rank", leaf_impl: str = "onehot"):
    """Size-S subtree list decoder for one *static* frozen pattern.

    ``body(alpha [B, L, S], pm [B, L]) → (beta [B, L, S] int8, pm, R)``; ``R``
    (a rank vector ``[B, L]``, or a one-hot plane ``[B, L, L]`` with
    ``perm_impl="onehot"``) maps post-chunk list slots to pre-chunk slots
    (``after[l] = before[R[l]]``).  Rate-0 subtrees collapse to a pure metric
    update and permutation re-indexing is skipped wherever no prune can
    occur.  Width-generic in ``node_mode="exact"``: alpha / pm may carry
    fewer than ``Lsz`` live rows; any float dtype.  ``node_mode="fast"``
    decodes rate-1 and repetition subtrees whole (``rate1_fast``,
    ``rep_fast`` of the algebra), at full list width."""
    flags = np.asarray(flags, bool)
    S = len(flags)
    fast = node_mode == "fast"
    alg = _ALGEBRAS[perm_impl]
    apply_perm, apply_perm_bits = alg["apply_perm"], alg["apply_perm_bits"]
    compose, info_leaf = alg["compose"], alg["info_leaf"]

    def node(alpha, pm, off: int, size: int):
        sub = flags[off:off + size]
        if sub.all():  # rate-0: metrics only, no prune
            return (torch.zeros(alpha.shape, dtype=torch.int8, device=alpha.device),
                    pm + _rate0_metric_levelpar(alpha), None)
        if size == 1:
            return info_leaf(alpha[:, :, 0], pm, Lsz, leaf_impl)
        if fast and not sub.any():
            return alg["rate1_fast"](alpha, pm, Lsz, leaf_impl)
        if fast and sub[:-1].all() and not sub[-1]:
            return alg["rep_fast"](alpha, pm, Lsz, leaf_impl)
        if not fast and sub[:-1].all() and not sub[-1] and size <= _LEVELPAR_MAX:
            return _rep_exact(alpha, pm, Lsz, info_leaf, leaf_impl)
        half = size // 2
        first, second = alpha[..., :half], alpha[..., half:]
        beta_l, pm, R_l = node(f_minsum(first, second), pm, off, half)
        if R_l is not None:
            alpha = apply_perm(R_l, alpha)
            first, second = alpha[..., :half], alpha[..., half:]
        sgn = 1.0 - 2.0 * beta_l.to(alpha.dtype)
        beta_r, pm, R_r = node(second + sgn * first, pm, off + half, half)
        if R_r is not None:
            beta_l = apply_perm_bits(R_r, beta_l)
        beta = torch.cat([beta_l ^ beta_r, beta_r], dim=-1)
        if R_l is None:
            R = R_r
        elif R_r is None:
            R = R_l
        else:
            R = compose(R_r, R_l)
        return beta, pm, R

    def body(alpha, pm):
        beta, pm, R = node(alpha, pm, 0, S)
        if R is None:
            R = alg["identity_r"](alpha.shape[1], alpha.shape[0], alpha.device, alpha.dtype)
        return beta, pm, R

    return body


# ---------------------------------------------------------------------------
# the static schedule
# ---------------------------------------------------------------------------

def decode_selector(sel: int, t: int) -> tuple[int, bool]:
    """Descend-selector encoding shared by the schedule and the kernels:
    ``0..t`` are plain variants (k = sel), ``t+1+k`` are invariant-parent
    variants.  Returns ``(k, invariant_parent)``."""
    if sel <= t:
        return sel, False
    return sel - t - 1, True


def pend_liveness(desc_k, asc_j, t: int, C: int):
    """Static per-chunk compose masks: which pending permutations actually
    need this chunk's relative permutation R composed in.

    A compose into a pending at chunk c is *dead* unless the next schedule
    event touching that pending (descend reads / resets at the next chunks,
    this chunk's ascend reads, ascend reset) is a READ: a reset overwrites
    the accumulated value unread.

    Returns ``(compose_a, compose_b)``: tuples (len C−1) of frozensets of
    level indices for chunks ``0..C−2``.  The last chunk never composes into
    storage."""
    events: list[tuple[tuple[int, int], str, tuple[str, int]]] = []
    for c in range(C):
        k, inv = decode_selector(int(desc_k[c]), t)
        if c == 0:
            for l in range(t):
                events.append(((c, 0), "reset", ("a", l)))
        else:
            lo = t - k
            if lo >= 2 and not inv:
                events.append(((c, 0), "read", ("a", lo - 2)))
            events.append(((c, 0), "read", ("b", lo - 1)))
            for l in range(lo - 1, t):
                events.append(((c, 0), "reset", ("a", l)))
        j = int(asc_j[c]) if c < C - 1 else t
        for s in range(j):
            events.append(((c, 2), "read", ("b", t - 1 - s)))
        if c < C - 1:
            events.append(((c, 2), "reset", ("b", t - j - 1)))
    compose_a: list[frozenset] = []
    compose_b: list[frozenset] = []
    for c in range(C - 1):
        ca, cb = set(), set()
        for kind, out in (("a", ca), ("b", cb)):
            for l in range(t):
                nxt = None
                for (tm, ty, p) in events:
                    if p == (kind, l) and tm > (c, 1):
                        nxt = ty
                        break
                if nxt == "read":
                    out.add(l)
        compose_a.append(frozenset(ca))
        compose_b.append(frozenset(cb))
    return tuple(compose_a), tuple(compose_b)


def super_touch_sets(sel: int, j: int, t: int, compose_a=None, compose_b=None):
    """Static I/O footprint of one chunk-step variant (list indices into the
    level stacks, level l ↔ index l−1): which levels the step reads and
    writes.  ``compose_a`` / ``compose_b`` are the chunk's live-compose masks
    (``None``: compose everything).  The byte bounds of the chunk-step kernel
    are computed from it."""
    k, inv = decode_selector(sel, t)
    if k == t:
        needs_llr = True
        alpha_read: list[int] = []
        alpha_write = list(range(t))
        beta_read_desc: list[int] = []
        pend_a_read_desc: list[int] = []
        a_resets = set(range(t))
    else:
        lo = t - k
        needs_llr = lo == 1
        alpha_read = [] if lo == 1 else [lo - 2]
        alpha_write = list(range(lo - 1, t))
        beta_read_desc = [lo - 1]
        pend_a_read_desc = [lo - 2] if (lo >= 2 and not inv) else []
        a_resets = set(range(lo - 1, t))
    beta_read = sorted(set(beta_read_desc) | {t - 1 - s for s in range(j)})
    beta_write = [t - j - 1]
    ca = set(range(t)) if compose_a is None else set(compose_a)
    cb = set(range(t)) if compose_b is None else set(compose_b)
    b_reset = t - j - 1
    return dict(needs_llr=needs_llr, alpha_read=alpha_read,
                alpha_write=alpha_write, beta_read=beta_read,
                beta_write=beta_write,
                pend_a_in=sorted(set(pend_a_read_desc) | (ca - a_resets)),
                pend_a_out=sorted(ca),
                pend_a_eye=sorted(a_resets - ca),
                # every beta read also reads its pend_b, whatever the compose
                # mask says: an all-frozen chunk composes nothing yet still
                # applies pendings from earlier chunks on its ascend
                pend_b_in=sorted(set(beta_read) | cb),
                pend_b_out=sorted(cb - {b_reset}),
                pend_b_eye=[b_reset])


@dataclass(frozen=True)
class SCLSchedule:
    """Everything static about one chunked decode: geometry, the chunks'
    frozen patterns, the descend / ascend variant of every chunk, the live
    compose masks and the live path counts."""
    N: int
    S: int
    C: int
    t: int
    L: int
    sizes: tuple           # alpha / beta width per level 0..t
    chunk_flags: np.ndarray  # [C, S] bool, storage order
    pattern_ids: np.ndarray  # [C]
    unique_flags: tuple
    desc_k: np.ndarray     # [C] descend selector
    asc_j: np.ndarray      # [C] ascend count
    comp_a: tuple          # [C−1] frozensets
    comp_b: tuple
    lv_in: tuple           # live paths entering chunk c (live width on)
    lv_out: tuple


def build_scl_schedule(N: int, frozen_mask: np.ndarray, list_size: int,
                       chunk: int = 128) -> SCLSchedule:
    """The static schedule of a code: chunk c's descend is fully determined
    by ctz(c) and its ascend by ctz(c+1).

    Descend variant ``k = ctz(c)`` (``k = t`` for c = 0): one g at level
    ``t−k``, then an f chain down to level t.  Ascend variant ``j =
    ctz(c+1)``: j combines (levels ``t .. t−j+1``), then park the result as
    the left beta at level ``t−j``.  Invariant-parent variants (selector
    ``t+1+k``, ``k ≤ t−2``): chunk ``c = 2^k`` performs the FIRST g-read of
    level ``t−k−1``, whose stored alpha is still chunk 0's path-invariant
    plane, so its pending refresh is an exact no-op and is skipped."""
    frozen_mask = np.asarray(frozen_mask, bool)
    assert frozen_mask.shape == (N,)
    S = min(chunk, N)
    assert S & (S - 1) == 0 and N % S == 0
    C = N // S
    t = int(np.log2(C))
    rev = np.asarray(bit_reverse_permutation(N))
    chunk_flags = frozen_mask[rev].reshape(C, S)
    pattern_ids = np.zeros(C, np.int32)
    unique: dict[bytes, int] = {}
    unique_flags: list[np.ndarray] = []
    for c in range(C):
        key = chunk_flags[c].tobytes()
        if key not in unique:
            unique[key] = len(unique_flags)
            unique_flags.append(chunk_flags[c])
        pattern_ids[c] = unique[key]
    desc_k = np.array(
        [t if c == 0
         else (t + 1 + _ctz(c) if c == (1 << _ctz(c)) and _ctz(c) <= t - 2
               else _ctz(c))
         for c in range(C)], np.int32)
    asc_j = np.array([_ctz(c + 1) for c in range(C)], np.int32)
    if C > 1:
        comp_a, comp_b = pend_liveness(desc_k, asc_j, t, C)
        # all-frozen chunks prune nothing: their R is the identity, so
        # composing it anywhere is an exact no-op
        comp_a = tuple(frozenset() if chunk_flags[c].all() else comp_a[c]
                       for c in range(C - 1))
        comp_b = tuple(frozenset() if chunk_flags[c].all() else comp_b[c]
                       for c in range(C - 1))
    else:
        comp_a = comp_b = ()
    # live-width schedule: the live path count doubles per info leaf, capped at L
    info_before = np.concatenate([[0], np.cumsum((~chunk_flags).sum(axis=1))])

    def lv_at(n_info):
        return int(min(list_size, 1 << min(int(n_info), 30)))

    return SCLSchedule(
        N=N, S=S, C=C, t=t, L=list_size,
        sizes=tuple(N >> l for l in range(t + 1)),
        chunk_flags=chunk_flags, pattern_ids=pattern_ids,
        unique_flags=tuple(unique_flags), desc_k=desc_k, asc_j=asc_j,
        comp_a=comp_a, comp_b=comp_b,
        lv_in=tuple(lv_at(info_before[c]) for c in range(C)),
        lv_out=tuple(lv_at(info_before[c + 1]) for c in range(C)))


def union_masks(sched: SCLSchedule):
    """The compose masks united over the chunk positions that share a
    (descend, pattern, ascend) triple (``mask_dedup="union"``, and always
    under the controls ``"fused"`` and ``"kernel"``): the JAX package builds
    one branch or kernel per triple instead of one per position.  Exact:
    composing into a level that is reset before it is read changes nothing
    that is read.  Returns ``(comp_a, comp_b)`` like ``pend_liveness``."""
    keys = [(int(sched.desc_k[c]), int(sched.pattern_ids[c]), int(sched.asc_j[c]))
            for c in range(sched.C - 1)]
    union: dict[tuple, tuple[set, set]] = {}
    for c, key in enumerate(keys):
        ca, cb = union.setdefault(key, (set(), set()))
        ca |= sched.comp_a[c]
        cb |= sched.comp_b[c]
    return (tuple(frozenset(union[k][0]) for k in keys),
            tuple(frozenset(union[k][1]) for k in keys))


def step_masks(sched: SCLSchedule, union: bool, live: bool):
    """The compose masks ``(comp_a, comp_b)`` the chunk steps run with: the
    united ones with ``union`` (``mask_dedup="union"``, the controls
    ``"fused"`` and ``"kernel"``), else the per-position ones.  With ``live``
    the per-position ones in every case: a united mask adds levels that are
    dead at that position (reset before they are read again), and under live
    width such a level may be narrower than the chunk's permutation (the JAX
    package composes it reading zeros there); leaving it out changes nothing
    that is read, so the outputs equal JAX's ``live_width=True,
    mask_dedup="union"`` decode."""
    return union_masks(sched) if union and not live else (sched.comp_a, sched.comp_b)


def variant_table(sched: SCLSchedule, masks, lv_in, lv_out, extra=None):
    """Chunk positions ``0..C−2`` grouped by step variant: ``(variants, tid)``
    with ``variants`` the distinct keys ``(descend selector, pattern id,
    ascend j, compose_a, compose_b, lv_in, lv_out[, extra])`` in order of
    first use and ``tid[c]`` the variant of position ``c``.  ``masks`` is
    ``(comp_a, comp_b)``; ``extra`` an optional per-position key (the live
    widths a kernel launch reads)."""
    comp_a, comp_b = masks
    variants: dict[tuple, int] = {}
    tid = []
    for c in range(sched.C - 1):
        key = (int(sched.desc_k[c]), int(sched.pattern_ids[c]), int(sched.asc_j[c]),
               comp_a[c], comp_b[c], lv_in[c], lv_out[c]) + (
                   () if extra is None else (extra[c],))
        tid.append(variants.setdefault(key, len(variants)))
    return list(variants), tid


def live_state_widths(sched: SCLSchedule, masks=None):
    """The row widths the plain live-width control keeps its level stacks at,
    before each chunk: a list of ``C`` tuples ``(wa, wb, wpa, wpb)``, one
    width per level index ``0..t−1`` for the alphas, the left betas and the
    two pendings.  A level written by a chunk holds that chunk's live count
    (its ``lv_in`` for the descend's alphas and resets, ``lv_out`` for
    composes, the parked beta and its pending); the first chunk's
    path-invariant planes hold one row.  The same bookkeeping as the JAX
    package's live-width control (``scanscl.py``, its per-position width
    simulation); the kernels read the width-1 pendings from it.  ``masks``:
    the compose masks ``(comp_a, comp_b)`` the steps run with (the
    schedule's own by default)."""
    t, C = sched.t, sched.C
    comp_a, comp_b = masks or (sched.comp_a, sched.comp_b)
    wa, wb, wpa, wpb = ([1] * t for _ in range(4))
    out = []
    for c in range(C):
        out.append((tuple(wa), tuple(wb), tuple(wpa), tuple(wpb)))
        if c == C - 1:
            break
        lvi, lvo = sched.lv_in[c], sched.lv_out[c]
        touch = super_touch_sets(int(sched.desc_k[c]), int(sched.asc_j[c]), t,
                                 comp_a[c], comp_b[c])
        for i in touch["alpha_write"]:
            wa[i] = lvi
        for i in touch["pend_a_out"]:
            wpa[i] = lvo
        for i in touch["pend_a_eye"]:
            wpa[i] = lvi
        for i in touch["beta_write"]:
            wb[i] = lvo
        for i in touch["pend_b_out"] + touch["pend_b_eye"]:
            wpb[i] = lvo
    return out


# ---------------------------------------------------------------------------
# one chunk step and the last chunk, as pure functions of explicit operands
# ---------------------------------------------------------------------------

def _make_super_fn(sel: int, j: int, t: int, sizes, Lsz: int, body_fn,
                   compose_a=None, compose_b=None,
                   lv_in: Optional[int] = None, lv_out: Optional[int] = None,
                   perm_impl: str = "rank"):
    """One whole chunk step: descend(sel) → body → pending composes →
    ascend(j).

    ``fn(llr [B, N], alpha tuple, pend_a tuple, beta tuple, pend_b tuple,
    pm [B, L]) → (alpha', pend_a', beta', pend_b', pm')``; level l of a
    stack is entry ``l−1``: alpha ``[B, L, N>>l]``, beta ``[B, L, N>>l]``
    int8, pendings ``[B, L]`` rank vectors (``[B, L, L]`` one-hot planes with
    ``perm_impl="onehot"``).  ``llr`` is in bit-reversed storage.

    ``compose_a`` / ``compose_b``: compose the chunk's R only into the listed
    pending levels; skipped levels pass through stale, provably unread
    before their next reset.  ``None`` composes into every pending (the
    control ``"split"``).

    ``lv_in`` / ``lv_out`` (live-width decoding): the static LIVE path counts
    entering / leaving this chunk.  When ``lv_in < Lsz`` the whole step runs
    at the live width: no phantom rows are computed at all, and for finite
    LLRs the result is the full-width program with its dead rows deleted
    (slot order included)."""
    if lv_in is None:
        lv_in = Lsz
    if lv_out is None:
        lv_out = Lsz
    live = lv_in < Lsz or lv_out < Lsz
    k, invariant_parent = decode_selector(sel, t)
    alg = _ALGEBRAS[perm_impl]
    apply_perm, apply_perm_bits, compose = (alg["apply_perm"], alg["apply_perm_bits"],
                                            alg["compose"])

    def fn(llr, alpha, pend_a, beta, pend_b, pm):
        batch, dev = pm.shape[0], pm.device
        eye_in = alg["identity_r"](lv_in, batch, dev, pm.dtype)
        eye_out = eye_in if lv_out == lv_in else alg["identity_r"](lv_out, batch, dev, pm.dtype)
        alpha, pend_a = list(alpha), list(pend_a)
        beta, pend_b = list(beta), list(pend_b)
        # ---- descend: g at level t−k (all-f from the root when k = t),
        # then an f chain down to level t
        if k == t:  # chunk 0: f all the way from the channel LLRs
            parent = llr[:, None, :]  # [B, 1, N]: path-invariant
            lo = 1
        else:
            lo = t - k
            M = sizes[lo]
            if lo == 1:
                parent = llr[:, None, :]
            elif invariant_parent:
                parent = alpha[lo - 2][:, :1]
            else:
                parent = apply_perm(pend_a[lo - 2], alpha[lo - 2])
            left = apply_perm_bits(pend_b[lo - 1], beta[lo - 1]).to(pm.dtype)
            first = _broadcast_rows(parent[..., :M], lv_in)
            second = _broadcast_rows(parent[..., M:], lv_in)
            parent = second + (1.0 - 2.0 * left) * first  # g
            alpha[lo - 1] = parent
            pend_a[lo - 1] = eye_in
            lo += 1
        for l in range(lo, t + 1):
            M = sizes[l]
            parent = f_minsum(parent[..., :M], parent[..., M:])
            # live mode stores path-invariant f-chain planes un-broadcast
            alpha[l - 1] = parent if live else _broadcast_rows(parent, Lsz)
            pend_a[l - 1] = eye_in
        # ---- chunk body
        beta_c, pm, R = body_fn(alpha[t - 1], pm)
        # ---- compose the chunk's relative permutation into the live pendings
        ca = range(t) if compose_a is None else compose_a
        cb = range(t) if compose_b is None else compose_b
        pend_a = [compose(R, p) if i in ca else p for i, p in enumerate(pend_a)]
        pend_b = [compose(R, p) if i in cb else p for i, p in enumerate(pend_b)]
        # ---- ascend: combine completed right subtrees, park left
        cur = beta_c
        for step_i in range(j):
            i = t - step_i - 1
            left_bits = apply_perm_bits(pend_b[i], beta[i])
            cur = torch.cat([left_bits ^ cur, cur], dim=-1)
        stop = t - j - 1
        beta[stop] = cur
        pend_b[stop] = eye_out
        return tuple(alpha), tuple(pend_a), tuple(beta), tuple(pend_b), pm

    return fn


def _transform_lnb(beta):
    """Final butterfly ``u = β·G`` per path on ``[B, L, N]`` int8 planes in
    bit-reversed storage (the transform commutes with simultaneous row and
    column bit reversal; callers un-permute once afterwards)."""
    return polar_transform(beta)


def _make_last_fn(t: int, sizes, Lsz: int, body_fn, transform: bool = False,
                  lv_in: Optional[int] = None, perm_impl: str = "rank"):
    """The LAST chunk (c = C−1): descend is a single g at level t, then
    ascend through every level to the root; no parking, the chunk's R
    composes into each level's pending on the way up.

    ``fn(llr, alpha, pend_a, beta, pend_b, pm) → (root [B, L, N] int8 in
    bit-reversed storage, pm)``; with ``transform=True`` the root plane is
    the decoded u (butterfly applied) instead of β."""
    if lv_in is None:
        lv_in = Lsz
    alg = _ALGEBRAS[perm_impl]
    apply_perm, apply_perm_bits, compose = (alg["apply_perm"], alg["apply_perm_bits"],
                                            alg["compose"])

    def fn(llr, alpha, pend_a, beta, pend_b, pm):
        M = sizes[t]
        parent = llr[:, None, :] if t == 1 else apply_perm(pend_a[t - 2], alpha[t - 2])
        left = apply_perm_bits(pend_b[t - 1], beta[t - 1]).to(pm.dtype)
        first = _broadcast_rows(parent[..., :M], lv_in)
        second = _broadcast_rows(parent[..., M:], lv_in)
        alpha_t = second + (1.0 - 2.0 * left) * first  # g
        beta_c, pm, R = body_fn(alpha_t, pm)
        cur = beta_c
        for l in range(t, 0, -1):
            left_bits = apply_perm_bits(compose(R, pend_b[l - 1]), beta[l - 1])
            cur = torch.cat([left_bits ^ cur, cur], dim=-1)
        if transform:
            cur = _transform_lnb(cur)
        return cur, pm

    return fn


def init_stacks(sched: SCLSchedule, llr_rev: torch.Tensor, width: int,
                perm_impl: str = "rank"):
    """The level stacks before chunk 0 at list width ``width``: every level
    is written before its first read, so the values are shape seeds."""
    batch, dev, dtype = llr_rev.shape[0], llr_rev.device, llr_rev.dtype
    eye = _ALGEBRAS[perm_impl]["identity_r"](width, batch, dev, dtype)
    t, sizes = sched.t, sched.sizes
    return dict(
        alpha=tuple(torch.zeros((batch, width, sizes[l]), dtype=dtype, device=dev)
                    for l in range(1, t + 1)),
        pend_a=tuple(eye for _ in range(t)),
        beta=tuple(torch.zeros((batch, width, sizes[l]), dtype=torch.int8, device=dev)
                   for l in range(1, t + 1)),
        pend_b=tuple(eye for _ in range(t)))


def pad_paths(x: torch.Tensor, L: int, value) -> torch.Tensor:
    """Live-width output pad ``[B, w, ...] → [B, L, ...]``: a code with fewer
    than log2 L info leaves ends with fewer than L live slots; the missing
    slots are the phantom rows' exact values (``value``: 0 for the all-zero
    codeword, −inf for the metric)."""
    w = x.shape[1]
    if w == L:
        return x
    pad = torch.full((x.shape[0], L - w, *x.shape[2:]), value, dtype=x.dtype, device=x.device)
    return torch.cat([x, pad], dim=1)


def init_metrics(batch: int, width: int, Lsz: int, dtype, device):
    """One live path: metric 0 in slot 0; at full width the other slots are
    ``-inf`` phantoms."""
    if width < Lsz:
        return torch.zeros((batch, width), dtype=dtype, device=device)
    pm = torch.full((batch, Lsz), -torch.inf, dtype=dtype, device=device)
    pm[:, 0] = 0.0
    return pm


# ---------------------------------------------------------------------------
# the decoder
# ---------------------------------------------------------------------------

def mega_reaches(list_size: int, chunk: int) -> bool:
    """Whether the one-launch list decode (``scl_decode_mega``) takes a code of
    list ``list_size`` and chunk ``chunk``: a frame's chunk context fits one
    thread block's shared memory and the list is at most ``NARROW_LIST_MAX``
    (the one-launch kernel has no wide instance).  Sizes only: the control
    ``"mega"`` runs ``"unroll-kernel"`` past it, as the JAX package's mega
    control degrades to its per-chunk kernels past its VMEM budget."""
    from ...ops.scl_cuda import NARROW_LIST_MAX, SMEM_LIMIT_BYTES, smem_per_frame

    return (list_size <= NARROW_LIST_MAX
            and smem_per_frame(list_size, chunk, depth0=False) <= SMEM_LIMIT_BYTES)


def make_scl_decoder_scan(N: int, frozen_mask: np.ndarray, list_size: int,
                          chunk: int = 128, dtype=torch.float32,
                          leaf_impl: str = "onehot",
                          body_impl: Optional[str] = None,
                          control_impl: Optional[str] = None,
                          node_mode: str = "exact",
                          perm_impl: str = "rank",
                          mask_dedup: str = "exact",
                          live_width="auto", device="cuda"):
    """Build a chunked SCL decoder: ``decode(llr [B, N]) → (u [B, L, N] int8
    natural order, metrics [B, L])``, paths in selection-slot order.

    ``chunk`` is the subtree size S (a power of two ≤ N).

    ``control_impl`` (identical outputs):

    * ``"unroll-fused"``: the plain PyTorch chunk program, one step function
      per chunk position (the default on the CPU);
    * ``"split"``: the plain chunk program as the JAX package's scan control
      runs it: per chunk the descend variant of its selector, the chunk body,
      the body's R composed into EVERY pending (no liveness masks), the
      ascend variant of its ``j``; the variants are built once and the
      positions walked in Python;
    * ``"fused"``: the plain chunk program, one step function per distinct
      (descend, pattern, ascend) variant, with the compose masks united over
      the positions of a variant (``union_masks``);
    * ``"unroll-kernel"``: one ``scl_chunk_step`` kernel launch per chunk
      ``0..C−2`` and one ``scl_last_chunk`` launch (``ops/scl_cuda.py``); a
      single-chunk code (``C == 1``) is one ``scl_chunk_body`` launch followed
      by the butterfly.  The default on a CUDA device; float32 only;
    * ``"kernel"``: the same launches at the united masks of ``"fused"``, one
      launch argument set per variant, at full list width (no live width);
      on the CPU the wrappers run the plain chunk steps;
    * ``"mega"``: the whole decode in ONE ``scl_decode_mega`` launch (bit
      reversal of the LLRs, state set-up, every chunk, the root butterfly) on
      a CUDA device, float32 only; on the CPU it runs the plain chunk program,
      which computes the same function.  Any batch.  A code the one launch
      cannot take (``mega_reaches``: a frame's context beyond one thread
      block's shared memory, or a list above 32) runs ``"unroll-kernel"``
      instead, at full width, as the JAX package's mega control degrades to
      its per-chunk kernels past its VMEM budget; the decoder's
      ``control_impl`` says which runs.  The kernel keeps rank vectors
      whatever ``perm_impl`` says (equal outputs).

    The kernels take lists up to 256: above 32 with exact nodes and rank
    vectors, two paths a lane up to 64 (the ``_wide`` instances), four up to
    128 and eight up to 256 (the ``_xl`` instances; ``ops/scl_cuda.py``); a
    context beyond one block runs in device memory (L = 256 at chunk 128).
    Fast nodes and one-hot permutations above 32, and lists above 256, raise
    ``ValueError`` on a kernel path; the plain controls take any list.

    ``body_impl``: ``"torch"`` (the plain chunk bodies) or ``"cuda"`` (the
    ``scl_chunk_body`` kernel inside the plain glue of ``"unroll-fused"``,
    ``"fused"`` or ``"split"``; under ``"mega"`` the one launch, or the
    per-chunk kernels past its reach, run the bodies, as the JAX package's
    ``body_impl="pallas"`` there).

    ``perm_impl``: ``"rank"`` (list permutations as rank vectors) or
    ``"onehot"`` (as one-hot planes in ``dtype``, the JAX package's Pallas
    default); the kernel controls and ``body_impl="cuda"`` then run the
    one-hot modes of the kernels.  Equal outputs.

    ``leaf_impl``: ``"onehot"`` (all-pairs stable ranking) or ``"sort"`` (a
    stable sort) for the prunes of the plain chunk bodies; the kernels always
    rank all pairs.  Equal outputs.

    ``mask_dedup``: ``"exact"`` (per-position compose masks on the
    ``unroll-*`` controls) or ``"union"`` (the masks united per variant, as
    ``"fused"`` and ``"kernel"`` always do).  Equal outputs.

    ``node_mode``: ``"exact"`` (leaf-by-leaf list decoding) or ``"fast"``:
    the SSCL fast list nodes, rate-1 and repetition subtrees inside a chunk
    decoded whole (``min(L−1, M)`` flip stages, or one prune, instead of one
    prune per leaf).  *Approximate*: its error rates match exact SCL
    statistically, its outputs are its own; the float64 twin
    ``parity/polar_np.scl_decode_fast_np`` of the JAX package is its oracle.
    It runs on the plain controls and on the per-chunk kernels; the one-launch
    control ``"mega"`` has no fast nodes (``ValueError``), nor have the one-hot
    kernels (with ``perm_impl="onehot"`` fast nodes run on ``"split"``,
    ``"fused"`` and ``"unroll-fused"`` with plain bodies only), and live
    width stays off.  A list above 16 warns: the rate-1 stages grow as O(L²)
    per stage times ``L − 1`` stages.

    ``live_width``: run the early chunks at the actual LIVE path count (1 →
    2 → … → L, doubling per info leaf) instead of the full list width.
    ``node_mode="exact"`` and ``perm_impl="rank"`` only (with
    ``mask_dedup="union"`` the live steps compose at the per-position masks,
    ``step_masks``: equal outputs), on the plain control
    ``"unroll-fused"`` (or any plain control of a single-chunk code) with
    ``body_impl="torch"`` and, for a code of more than one chunk, on the
    kernel control ``"unroll-kernel"`` (narrow ``scl_chunk_step`` launches;
    the last chunk at full width); ``"auto"`` enables it there.  Equal to the
    full-width program for FINITE channel LLRs, a precondition every channel
    in this package meets; not for ±inf LLRs.

    Not in this package (``NotImplementedError``): the interpret twins of the
    JAX package's Pallas controls (a CUDA kernel has no interpret mode).
    """
    dev = resolve_device(device)
    if perm_impl not in _ALGEBRAS:
        raise ValueError(f"unknown perm_impl {perm_impl!r}")
    if node_mode not in ("exact", "fast"):
        raise ValueError(f"unknown node_mode {node_mode!r}")
    if leaf_impl not in ("onehot", "sort"):
        raise ValueError(f"unknown leaf_impl {leaf_impl!r}")
    if mask_dedup not in ("exact", "union"):
        raise ValueError(f"unknown mask_dedup {mask_dedup!r}")
    if control_impl in _UNPORTED_CONTROLS:
        raise NotImplementedError(
            f"control_impl={control_impl!r} is not in this package: a CUDA kernel has no "
            f"interpret mode")
    if control_impl is None:
        control_impl = "unroll-kernel" if dev.type == "cuda" else "unroll-fused"
    if control_impl not in _CONTROLS:
        raise ValueError(f"unknown control_impl {control_impl!r}")
    if body_impl is None:
        body_impl = "torch"
    if body_impl not in ("torch", "cuda"):
        raise ValueError(f"unknown body_impl {body_impl!r}")
    fast = node_mode == "fast"
    onehot = perm_impl == "onehot"
    if fast and control_impl == "mega":
        raise ValueError("node_mode='fast' is not supported by the mega control: the "
                         "one-launch list decode has no fast nodes")
    if fast and onehot and (body_impl == "cuda" or control_impl not in
                            ("split", "fused", "unroll-fused")):
        raise ValueError("node_mode='fast' with perm_impl='onehot' runs on the plain controls "
                         "('split', 'fused', 'unroll-fused') with body_impl='torch' only: the "
                         "one-hot kernels have no fast nodes; use perm_impl='rank'")
    if fast and list_size > 16:
        warnings.warn(
            f"node_mode='fast' is a small-list serving mode: its rate-1 flip stages "
            f"scale O(L^2) per stage x min(L-1, S) stages. With list_size={list_size} "
            f"> 16, use node_mode='exact'.", stacklevel=2)
    mega = mega_asked = control_impl == "mega"
    if mega and not mega_reaches(list_size, min(chunk, N)):
        # the JAX package's own rule (its mega control past its VMEM budget):
        # the per-chunk kernels, equal outputs, chosen on the host from sizes
        control_impl, mega = "unroll-kernel", False
    kernel_control = control_impl in ("unroll-kernel", "kernel")
    if mega and dev.type == "cpu":
        control_impl = "unroll-fused"  # the plain version of the same function
    kernel_path = kernel_control or control_impl == "mega" or body_impl == "cuda"
    if kernel_path and dtype != torch.float32:
        raise TypeError(f"the SCL kernels are float32 only, got {dtype}")

    sched = build_scl_schedule(N, frozen_mask, list_size, chunk)
    C, t, sizes, Lsz = sched.C, sched.t, sched.sizes, list_size
    union = control_impl in ("fused", "kernel") or mask_dedup == "union"
    live_capable = not fast and not mega_asked and not onehot and (
        (body_impl == "torch" and (control_impl == "unroll-fused"
                                   or (C == 1 and control_impl in ("split", "fused"))))
        or (control_impl == "unroll-kernel" and C > 1))
    if live_width == "auto":
        live_on = live_capable and any(w < Lsz for w in sched.lv_in)
    else:
        live_on = bool(live_width)
        if live_on and not live_capable:
            raise ValueError(
                "live_width needs node_mode='exact', perm_impl='rank' and the plain control "
                "(control_impl='unroll-fused', body_impl='torch') or, for a code of more than "
                "one chunk, the kernel control 'unroll-kernel': the other kernels, the one-hot "
                "algebra and the fast nodes run at full list width")
    lv_in_c = sched.lv_in if live_on else (Lsz,) * C
    lv_out_c = sched.lv_out if live_on else (Lsz,) * C
    rev = torch.as_tensor(np.asarray(bit_reverse_permutation(N)), dtype=torch.int64,
                          device=dev)

    def _finish(root_bits, pm):
        """``[B, L, N]`` bit-reversed β and metrics → the public outputs."""
        return (polar_transform(pad_paths(root_bits, Lsz, 0)[..., rev]),
                pad_paths(pm, Lsz, -torch.inf))

    def _prepare(llr):
        llr = torch.as_tensor(llr, device=dev).to(dtype)
        assert llr.dim() == 2 and llr.shape[1] == N, "SCL decode expects [batch, N]"
        return llr[:, rev].contiguous()

    def _tag(fn, control=None):
        fn.schedule = sched
        fn.control_impl = control or ("mega" if mega else control_impl)
        fn.live_width = live_on
        return fn

    if control_impl == "mega":
        from ...ops.scl_cuda import SCLMegaPlan, scl_decode_mega_cuda

        plan = SCLMegaPlan(sched)  # exact nodes only: fast + mega raised above

        def decode_mega(llr):
            llr = torch.as_tensor(llr, device=dev).to(dtype)
            assert llr.dim() == 2 and llr.shape[1] == N, "SCL decode expects [batch, N]"
            return scl_decode_mega_cuda(llr.contiguous(), plan)

        return _tag(decode_mega)

    if kernel_control:
        from ...ops.scl_cuda import make_scl_kernel_decoder

        inner = make_scl_kernel_decoder(sched, node_mode, live=live_on, union=union,
                                        perm_impl=perm_impl)

        def decode_kernel(llr):
            return inner(_prepare(llr))

        return _tag(decode_kernel)

    if body_impl == "cuda":
        from ...ops.scl_cuda import make_chunk_body_cuda

        bodies = [make_chunk_body_cuda(f, Lsz, node_mode, perm_impl) for f in sched.unique_flags]
    else:
        bodies = [_make_chunk_body(f, Lsz, node_mode, perm_impl, leaf_impl)
                  for f in sched.unique_flags]

    if C == 1:
        def decode_single(llr):
            llr_rev = _prepare(llr)
            width = 1 if live_on else Lsz
            alpha = llr_rev[:, None, :].expand(-1, width, -1)
            beta, pm, _ = bodies[0](alpha, init_metrics(
                llr_rev.shape[0], width, Lsz, dtype, dev))
            return _finish(beta, pm)

        return _tag(decode_single)

    if control_impl == "split":
        masks = ((None,) * (C - 1), (None,) * (C - 1))
    else:
        masks = step_masks(sched, union, live_on)
    variants, tid = variant_table(sched, masks, lv_in_c, lv_out_c)
    if control_impl == "unroll-fused":  # one step function per position
        variants = [variants[tid[c]] for c in range(C - 1)]
        tid = list(range(C - 1))
    step_fns = [_make_super_fn(sel, j, t, sizes, Lsz, bodies[pid], compose_a=ca, compose_b=cb,
                               lv_in=lvi, lv_out=lvo, perm_impl=perm_impl)
                for sel, pid, j, ca, cb, lvi, lvo in variants]
    last_fn = _make_last_fn(t, sizes, Lsz, bodies[sched.pattern_ids[C - 1]],
                            lv_in=lv_in_c[C - 1], perm_impl=perm_impl)

    def decode(llr):
        llr_rev = _prepare(llr)
        width = 1 if live_on else Lsz
        st = init_stacks(sched, llr_rev, width, perm_impl)
        alpha, pend_a, beta, pend_b = st["alpha"], st["pend_a"], st["beta"], st["pend_b"]
        pm = init_metrics(llr_rev.shape[0], width, Lsz, dtype, dev)
        for c in range(C - 1):
            alpha, pend_a, beta, pend_b, pm = step_fns[tid[c]](llr_rev, alpha, pend_a, beta,
                                                               pend_b, pm)
        cur, pm = last_fn(llr_rev, alpha, pend_a, beta, pend_b, pm)
        return _finish(cur, pm)

    return _tag(decode)
