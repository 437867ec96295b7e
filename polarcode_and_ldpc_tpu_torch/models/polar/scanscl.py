"""Chunked SCL decoder: the plain PyTorch version and the decoder factory.

The code tree is cut at subtree size ``S``; the ``C = N/S`` chunks are
decoded in DFS order by a straight-line program.  Between chunks the alphas
and left betas of the outer levels ``1..t`` (``t = log2 C``) live in
per-level stacks.  Pruning at info leaves permutes the list axis of all live
state; each outer level keeps a *pending* list permutation that is composed
with a chunk's relative permutation after the chunk and applied only when a
schedule event actually reads the level (lazy list permutations).

* **frame-major layout**: every tensor carries the frame batch first:
  alphas ``[B, L, M]``, metrics ``[B, L]``, permutations as rank vectors
  ``[B, L]`` (``out[l] = in[r[l]]``: a *selection*, rows may repeat, so it is
  applied with a gather);
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
a decoder with the plain control (``"unroll-fused"``), the kernel control
(``"unroll-kernel"``: one ``scl_chunk_step`` launch per chunk and one
``scl_last_chunk`` launch) or the one-launch control (``"mega"``: the whole
decode in one ``scl_decode_mega`` launch).
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

_UNPORTED_CONTROLS = ("split", "fused", "kernel", "kernel-interpret",
                      "unroll-kernel-interpret", "mega-interpret")


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


def _rep_exact(alpha, pm, Lsz):
    """Exact repetition node (all leaves frozen except the last in decode
    order), equal to the leaf-by-leaf recursion: all leaf LLRs come from the
    zero-decision pass; the left rate-0 blocks' tree sums (the intermediate
    values of the adjacent-pair reduction of the leaf ``d0`` array) are
    added to the metric one by one from the largest block to the smallest;
    the last leaf runs the info-leaf prune and the node codeword is its bit
    repeated.  ``alpha [B, L, M]``, ``pm [B, L]`` → ``(beta, pm', R)``."""
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
    bits, pm, R = _info_leaf_rank(y[..., M - 1], pm, Lsz)
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


def _prune_rank(cand, out: int):
    """Stable top-``out`` of the ordered candidates ``cand [B, 2·lv]`` (first
    half: keep / bit 0, second half: flip / bit 1) → (second-half flags
    ``[B, out]`` bool, metrics ``[B, out]``, source slots ``[B, out]``).
    Candidate ``i`` goes before candidate ``j`` iff its metric is larger, or
    equal with ``i < j`` (all-pairs ranks: exact, stable, no reliance on a
    sort's tie behaviour)."""
    two = cand.shape[1]
    lv = two // 2
    ci, cj = cand[:, :, None], cand[:, None, :]
    idx = torch.arange(two, device=cand.device)
    jlti = idx[None, :] < idx[:, None]  # [i, j]: j < i
    rank = ((cj > ci) | ((cj == ci) & jlti)).sum(dim=2)  # [B, 2·lv]
    order = torch.empty_like(rank).scatter_(1, rank, idx.expand_as(rank))
    top = order[:, :out]
    second = top >= lv
    return second, torch.gather(cand, 1, top), top - lv * second.to(top.dtype)


def _info_leaf_rank(a, pm, Lsz):
    """Branch + stable top-L prune at one info leaf.

    ``a [B, lv]`` leaf LLRs, ``pm [B, lv]`` → (bit plane ``[B, lv', 1]``
    int8, pm ``[B, lv']``, rank vector ``[B, lv']``) with ``lv' = min(2·lv,
    Lsz)``.  Width-generic: while ``lv < Lsz`` no candidate is discarded,
    only reordered."""
    lv = pm.shape[1]
    d0, d1 = _d0_d1(a)
    second, pm, r = _prune_rank(torch.cat([pm + d0, pm + d1], dim=1), min(2 * lv, Lsz))
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


def _rate1_fast(alpha, pm, Lsz):
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
        flip, pm, r = _prune_rank(torch.cat([pm, pm - magsK[..., s]], dim=1), Lsz)
        magsK, idxK, fdec = (_apply_perm_rank(r, x) for x in (magsK, idxK, fdec))
        fdec[..., s] = flip.to(torch.int8)
        R_tot = r if R_tot is None else _compose_rank(r, R_tot)
    # the flipped positions of a path are distinct: a scatter is exact
    flips = torch.zeros_like(hard).scatter_(2, idxK, fdec)
    return _apply_perm_rank(R_tot, hard) ^ flips, pm, R_tot


def _rep_fast(alpha, pm, Lsz):
    """Fast repetition node (every position frozen but the last in decode
    order): the node codeword is one bit repeated, so its two candidates are
    scored whole, ``pm + Σ log P(b | a_i)`` (halving tree), in ONE stable
    top-L prune.  ``alpha [B, L, M]`` → ``(beta [B, L, M] int8, pm, R)``."""
    d0, d1 = _d0_d1(alpha)
    bit, pm, r = _prune_rank(torch.cat([pm + _tree_sum(d0), pm + _tree_sum(d1)], dim=1), Lsz)
    return bit.to(torch.int8)[:, :, None].expand(-1, -1, alpha.shape[-1]), pm, r


def _identity_r_rank(Lsz, batch, device):
    """Identity rank vector ``[B, L]``."""
    return torch.arange(Lsz, device=device).expand(batch, Lsz)


def _broadcast_rows(x, L):
    """``[B, 1, M] → [B, L, M]`` (no-op when already L rows)."""
    if x.shape[1] == L:
        return x
    return x.expand(-1, L, -1)


def _ctz(x: int) -> int:
    return (x & -x).bit_length() - 1


def _make_chunk_body(flags: np.ndarray, Lsz: int, node_mode: str = "exact"):
    """Size-S subtree list decoder for one *static* frozen pattern.

    ``body(alpha [B, L, S], pm [B, L]) → (beta [B, L, S] int8, pm, R [B, L])``;
    ``R`` maps post-chunk list slots to pre-chunk slots (``after[l] =
    before[R[l]]``).  Rate-0 subtrees collapse to a pure metric update and
    permutation re-indexing is skipped wherever no prune can occur.  Width-
    generic in ``node_mode="exact"``: alpha / pm may carry fewer than ``Lsz``
    live rows; any float dtype.  ``node_mode="fast"`` decodes rate-1 and
    repetition subtrees whole (``_rate1_fast``, ``_rep_fast``), at full list
    width."""
    flags = np.asarray(flags, bool)
    S = len(flags)
    fast = node_mode == "fast"

    def node(alpha, pm, off: int, size: int):
        sub = flags[off:off + size]
        if sub.all():  # rate-0: metrics only, no prune
            return (torch.zeros(alpha.shape, dtype=torch.int8, device=alpha.device),
                    pm + _rate0_metric_levelpar(alpha), None)
        if size == 1:
            return _info_leaf_rank(alpha[:, :, 0], pm, Lsz)
        if fast and not sub.any():
            return _rate1_fast(alpha, pm, Lsz)
        if fast and sub[:-1].all() and not sub[-1]:
            return _rep_fast(alpha, pm, Lsz)
        if not fast and sub[:-1].all() and not sub[-1] and size <= _LEVELPAR_MAX:
            return _rep_exact(alpha, pm, Lsz)
        half = size // 2
        first, second = alpha[..., :half], alpha[..., half:]
        beta_l, pm, R_l = node(f_minsum(first, second), pm, off, half)
        if R_l is not None:
            alpha = _apply_perm_rank(R_l, alpha)
            first, second = alpha[..., :half], alpha[..., half:]
        sgn = 1.0 - 2.0 * beta_l.to(alpha.dtype)
        beta_r, pm, R_r = node(second + sgn * first, pm, off + half, half)
        if R_r is not None:
            beta_l = _apply_perm_rank_bits_packed(R_r, beta_l)
        beta = torch.cat([beta_l ^ beta_r, beta_r], dim=-1)
        if R_l is None:
            R = R_r
        elif R_r is None:
            R = R_l
        else:
            R = _compose_rank(R_r, R_l)
        return beta, pm, R

    def body(alpha, pm):
        beta, pm, R = node(alpha, pm, 0, S)
        if R is None:
            R = _identity_r_rank(alpha.shape[1], alpha.shape[0], alpha.device)
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


# ---------------------------------------------------------------------------
# one chunk step and the last chunk, as pure functions of explicit operands
# ---------------------------------------------------------------------------

def _make_super_fn(sel: int, j: int, t: int, sizes, Lsz: int, body_fn,
                   compose_a=None, compose_b=None,
                   lv_in: Optional[int] = None, lv_out: Optional[int] = None):
    """One whole chunk step: descend(sel) → body → pending composes →
    ascend(j).

    ``fn(llr [B, N], alpha tuple, pend_a tuple, beta tuple, pend_b tuple,
    pm [B, L]) → (alpha', pend_a', beta', pend_b', pm')``; level l of a
    stack is entry ``l−1``: alpha ``[B, L, N>>l]``, beta ``[B, L, N>>l]``
    int8, pendings ``[B, L]``.  ``llr`` is in bit-reversed storage.

    ``compose_a`` / ``compose_b``: compose the chunk's R only into the listed
    pending levels; skipped levels pass through stale, provably unread
    before their next reset.

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

    def fn(llr, alpha, pend_a, beta, pend_b, pm):
        batch, dev = pm.shape[0], pm.device
        eye_in = _identity_r_rank(lv_in, batch, dev)
        eye_out = eye_in if lv_out == lv_in else _identity_r_rank(lv_out, batch, dev)
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
                parent = _apply_perm_rank(pend_a[lo - 2], alpha[lo - 2])
            left = _apply_perm_rank_bits_packed(pend_b[lo - 1], beta[lo - 1]).to(pm.dtype)
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
        pend_a = [_compose_rank(R, p) if i in ca else p for i, p in enumerate(pend_a)]
        pend_b = [_compose_rank(R, p) if i in cb else p for i, p in enumerate(pend_b)]
        # ---- ascend: combine completed right subtrees, park left
        cur = beta_c
        for step_i in range(j):
            i = t - step_i - 1
            left_bits = _apply_perm_rank_bits_packed(pend_b[i], beta[i])
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
                  lv_in: Optional[int] = None):
    """The LAST chunk (c = C−1): descend is a single g at level t, then
    ascend through every level to the root; no parking, the chunk's R
    composes into each level's pending on the way up.

    ``fn(llr, alpha, pend_a, beta, pend_b, pm) → (root [B, L, N] int8 in
    bit-reversed storage, pm)``; with ``transform=True`` the root plane is
    the decoded u (butterfly applied) instead of β."""
    if lv_in is None:
        lv_in = Lsz

    def fn(llr, alpha, pend_a, beta, pend_b, pm):
        M = sizes[t]
        parent = (llr[:, None, :] if t == 1
                  else _apply_perm_rank(pend_a[t - 2], alpha[t - 2]))
        left = _apply_perm_rank_bits_packed(pend_b[t - 1], beta[t - 1]).to(pm.dtype)
        first = _broadcast_rows(parent[..., :M], lv_in)
        second = _broadcast_rows(parent[..., M:], lv_in)
        alpha_t = second + (1.0 - 2.0 * left) * first  # g
        beta_c, pm, R = body_fn(alpha_t, pm)
        cur = beta_c
        for l in range(t, 0, -1):
            left_bits = _apply_perm_rank_bits_packed(
                _compose_rank(R, pend_b[l - 1]), beta[l - 1])
            cur = torch.cat([left_bits ^ cur, cur], dim=-1)
        if transform:
            cur = _transform_lnb(cur)
        return cur, pm

    return fn


def init_stacks(sched: SCLSchedule, llr_rev: torch.Tensor, width: int):
    """The level stacks before chunk 0 at list width ``width``: every level
    is written before its first read, so the values are shape seeds."""
    batch, dev, dtype = llr_rev.shape[0], llr_rev.device, llr_rev.dtype
    eye = _identity_r_rank(width, batch, dev)
    t, sizes = sched.t, sched.sizes
    return dict(
        alpha=tuple(torch.zeros((batch, width, sizes[l]), dtype=dtype, device=dev)
                    for l in range(1, t + 1)),
        pend_a=tuple(eye for _ in range(t)),
        beta=tuple(torch.zeros((batch, width, sizes[l]), dtype=torch.int8, device=dev)
                   for l in range(1, t + 1)),
        pend_b=tuple(eye for _ in range(t)))


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

def make_scl_decoder_scan(N: int, frozen_mask: np.ndarray, list_size: int,
                          chunk: int = 128, dtype=torch.float32,
                          leaf_impl: str = "onehot",
                          body_impl: Optional[str] = None,
                          control_impl: Optional[str] = None,
                          node_mode: str = "exact",
                          perm_impl: str = "rank",
                          live_width="auto", device="cuda"):
    """Build a chunked SCL decoder: ``decode(llr [B, N]) → (u [B, L, N] int8
    natural order, metrics [B, L])``, paths in selection-slot order.

    ``chunk`` is the subtree size S (a power of two ≤ N).

    ``control_impl`` (identical outputs):

    * ``"unroll-fused"``: the plain PyTorch chunk program (the default on
      the CPU);
    * ``"unroll-kernel"``: one ``scl_chunk_step`` kernel launch per chunk
      ``0..C−2`` and one ``scl_last_chunk`` launch (``ops/scl_cuda.py``); a
      single-chunk code (``C == 1``) is one ``scl_chunk_body`` launch followed
      by the butterfly.  The default on a CUDA device; float32 only;
    * ``"mega"``: the whole decode in ONE ``scl_decode_mega`` launch (bit
      reversal of the LLRs, state set-up, every chunk, the root butterfly) on
      a CUDA device, float32 only; on the CPU it runs the plain chunk program,
      which computes the same function.  Any batch; a code whose working set
      one thread block cannot hold raises ``ValueError``.

    ``body_impl``: ``"torch"`` (the plain chunk bodies) or ``"cuda"`` (the
    ``scl_chunk_body`` kernel inside the plain glue of ``"unroll-fused"``).

    ``node_mode``: ``"exact"`` (leaf-by-leaf list decoding) or ``"fast"``:
    the SSCL fast list nodes, rate-1 and repetition subtrees inside a chunk
    decoded whole (``min(L−1, M)`` flip stages, or one prune, instead of one
    prune per leaf).  *Approximate*: its error rates match exact SCL
    statistically, its outputs are its own; the float64 twin
    ``parity/polar_np.scl_decode_fast_np`` of the JAX package is its oracle.
    It runs on the plain control and on the per-chunk kernels; the one-launch
    control ``"mega"`` has no fast nodes (``ValueError``), and live width
    stays off.  A list above 16 warns: the rate-1 stages grow as O(L²) per
    stage times ``L − 1`` stages.

    ``live_width``: run the early chunks at the actual LIVE path count (1 →
    2 → … → L, doubling per info leaf) instead of the full list width.  The
    plain control and ``node_mode="exact"`` only (the kernels run at full
    width with ``-inf`` phantom rows); ``"auto"`` enables it there.  Equal to
    the full-width program for FINITE channel LLRs, a precondition every
    channel in this package meets; not for ±inf LLRs.

    Not in this package yet (``NotImplementedError``): ``perm_impl="onehot"``,
    ``leaf_impl="sort"``, the scan and per-chunk-kernel controls ``"split"``,
    ``"fused"``, ``"kernel"``, and the interpret twins of the kernel controls
    (a CUDA kernel has no interpret mode).
    """
    dev = resolve_device(device)
    if perm_impl == "onehot":
        raise NotImplementedError("perm_impl='onehot' is not in this package yet")
    if perm_impl != "rank":
        raise ValueError(f"unknown perm_impl {perm_impl!r}")
    if node_mode not in ("exact", "fast"):
        raise ValueError(f"unknown node_mode {node_mode!r}")
    fast = node_mode == "fast"
    if fast and control_impl == "mega":
        raise ValueError("node_mode='fast' is not supported by the mega control: the "
                         "one-launch list decode has no fast nodes")
    if fast and list_size > 16:
        warnings.warn(
            f"node_mode='fast' is a small-list serving mode: its rate-1 flip stages "
            f"scale O(L^2) per stage x min(L-1, S) stages. With list_size={list_size} "
            f"> 16, use node_mode='exact'.", stacklevel=2)
    if leaf_impl == "sort":
        raise NotImplementedError("leaf_impl='sort' is not in this package yet")
    if leaf_impl != "onehot":
        raise ValueError(f"unknown leaf_impl {leaf_impl!r}")
    if control_impl in _UNPORTED_CONTROLS:
        raise NotImplementedError(
            f"control_impl={control_impl!r} is not in this package yet")
    if control_impl is None:
        control_impl = "unroll-kernel" if dev.type == "cuda" else "unroll-fused"
    if control_impl not in ("unroll-fused", "unroll-kernel", "mega"):
        raise ValueError(f"unknown control_impl {control_impl!r}")
    mega = control_impl == "mega"
    if mega and body_impl == "cuda":
        raise ValueError("control_impl='mega' runs the chunk bodies inside its one "
                         "kernel; body_impl='cuda' does not apply")
    if mega and dev.type == "cpu":
        control_impl = "unroll-fused"  # the plain version of the same function
    if body_impl is None:
        body_impl = "torch"
    if body_impl not in ("torch", "cuda"):
        raise ValueError(f"unknown body_impl {body_impl!r}")
    kernel_path = control_impl in ("unroll-kernel", "mega") or body_impl == "cuda"
    if kernel_path and dtype != torch.float32:
        raise TypeError(f"the SCL kernels are float32 only, got {dtype}")

    sched = build_scl_schedule(N, frozen_mask, list_size, chunk)
    C, t, sizes, Lsz = sched.C, sched.t, sched.sizes, list_size
    live_capable = not kernel_path and not fast
    if live_width == "auto":
        live_on = live_capable and any(w < Lsz for w in sched.lv_in)
    else:
        live_on = bool(live_width)
        if live_on and not live_capable:
            raise ValueError(
                "live_width needs node_mode='exact' and the plain control "
                "(control_impl='unroll-fused', body_impl='torch'): the kernels and "
                "the fast nodes run at full list width")
    lv_in_c = sched.lv_in if live_on else (Lsz,) * C
    lv_out_c = sched.lv_out if live_on else (Lsz,) * C
    rev = torch.as_tensor(np.asarray(bit_reverse_permutation(N)), dtype=torch.int64,
                          device=dev)

    def _pad_rows(x, value):
        """Live-width output pad: a code with fewer than log2 L info leaves
        ends with fewer than L live slots; the missing slots are the phantom
        rows' exact values (all-zero codeword, −inf metric)."""
        w = x.shape[1]
        if w == Lsz:
            return x
        pad = torch.full((x.shape[0], Lsz - w, *x.shape[2:]), value,
                         dtype=x.dtype, device=x.device)
        return torch.cat([x, pad], dim=1)

    def _finish(root_bits, pm):
        """``[B, L, N]`` bit-reversed β and metrics → the public outputs."""
        return polar_transform(_pad_rows(root_bits, 0)[..., rev]), _pad_rows(pm, -torch.inf)

    def _prepare(llr):
        llr = torch.as_tensor(llr, device=dev).to(dtype)
        assert llr.dim() == 2 and llr.shape[1] == N, "SCL decode expects [batch, N]"
        return llr[:, rev].contiguous()

    if control_impl == "mega":
        from ...ops.scl_cuda import SCLMegaPlan, scl_decode_mega_cuda

        plan = SCLMegaPlan(sched)  # exact nodes only: fast + mega raised above

        def decode_mega(llr):
            llr = torch.as_tensor(llr, device=dev).to(dtype)
            assert llr.dim() == 2 and llr.shape[1] == N, "SCL decode expects [batch, N]"
            return scl_decode_mega_cuda(llr.contiguous(), plan)

        decode_mega.schedule = sched
        decode_mega.control_impl = "mega"
        decode_mega.live_width = False
        return decode_mega

    if control_impl == "unroll-kernel":
        from ...ops.scl_cuda import make_scl_kernel_decoder

        inner = make_scl_kernel_decoder(sched, node_mode)

        def decode_kernel(llr):
            return inner(_prepare(llr))

        decode_kernel.schedule = sched
        decode_kernel.control_impl = control_impl
        decode_kernel.live_width = False
        return decode_kernel

    if body_impl == "cuda":
        from ...ops.scl_cuda import make_chunk_body_cuda

        bodies = [make_chunk_body_cuda(f, Lsz, node_mode) for f in sched.unique_flags]
    else:
        bodies = [_make_chunk_body(f, Lsz, node_mode) for f in sched.unique_flags]

    if C == 1:
        def decode_single(llr):
            llr_rev = _prepare(llr)
            width = 1 if live_on else Lsz
            alpha = llr_rev[:, None, :].expand(-1, width, -1)
            beta, pm, _ = bodies[0](alpha, init_metrics(
                llr_rev.shape[0], width, Lsz, dtype, dev))
            return _finish(beta, pm)

        decode_single.schedule = sched
        decode_single.control_impl = "mega" if mega else control_impl
        decode_single.live_width = live_on
        return decode_single

    steps = [_make_super_fn(int(sched.desc_k[c]), int(sched.asc_j[c]), t, sizes, Lsz,
                            bodies[sched.pattern_ids[c]],
                            compose_a=sched.comp_a[c], compose_b=sched.comp_b[c],
                            lv_in=lv_in_c[c], lv_out=lv_out_c[c])
             for c in range(C - 1)]
    last_fn = _make_last_fn(t, sizes, Lsz, bodies[sched.pattern_ids[C - 1]],
                            lv_in=lv_in_c[C - 1])

    def decode(llr):
        llr_rev = _prepare(llr)
        width = 1 if live_on else Lsz
        st = init_stacks(sched, llr_rev, width)
        alpha, pend_a, beta, pend_b = st["alpha"], st["pend_a"], st["beta"], st["pend_b"]
        pm = init_metrics(llr_rev.shape[0], width, Lsz, dtype, dev)
        for step in steps:
            alpha, pend_a, beta, pend_b, pm = step(llr_rev, alpha, pend_a, beta, pend_b, pm)
        cur, pm = last_fn(llr_rev, alpha, pend_a, beta, pend_b, pm)
        return _finish(cur, pm)

    decode.schedule = sched
    decode.control_impl = "mega" if mega else control_impl
    decode.live_width = live_on
    return decode
