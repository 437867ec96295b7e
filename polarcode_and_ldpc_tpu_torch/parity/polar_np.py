"""NumPy twin of the reference polar encoder/decoders.

Reproduces, rule for rule, the semantics of ``src/polar/encoder.py``,
``src/polar/utils.py`` (butterfly, CRC, bit reversal) and
``src/polar/decoder.py`` (SC at :12-173, SCL at :176-444): natural-order
butterfly with adjacent-pairs-first stages, bit-reversed decode order,
min-sum f, exact g, ``llr ≥ 0 → 0`` hard decision, stable descending
metric sort with candidates ordered (bit 0 paths, then bit 1 paths), full
state copies for survivors, final argmax-metric selection.
"""

from __future__ import annotations

import numpy as np

from ..models.polar.construction import bit_reverse
from ..models.polar.crc import CRC_POLYNOMIALS, crc_length, crc_remainder_scalar


# ---------------------------------------------------------------------------
# encoder (reference src/polar/utils.py:219-228, encoder.py:63-95)
# ---------------------------------------------------------------------------

def polar_transform_np(u: np.ndarray) -> np.ndarray:
    x = np.asarray(u, dtype=np.int64).copy()
    N = x.size
    n = int(np.log2(N))
    for s in range(n):
        stride = 1 << s
        for base in range(0, N, 2 * stride):
            for j in range(stride):
                x[base + j] ^= x[base + j + stride]
    return x


def crc_encode_np(data: np.ndarray, polynomial: str = "CRC-8") -> np.ndarray:
    if polynomial not in CRC_POLYNOMIALS:
        polynomial = "CRC-8"
    clen = crc_length(polynomial)
    r = crc_remainder_scalar(np.asarray(data, np.int64), polynomial)
    crc_bits = np.array([(r >> (clen - 1 - b)) & 1 for b in range(clen)], dtype=np.int64)
    return np.concatenate([np.asarray(data, np.int64), crc_bits])


def crc_check_np(data: np.ndarray, polynomial: str = "CRC-8") -> bool:
    if polynomial not in CRC_POLYNOMIALS:
        polynomial = "CRC-8"
    return crc_remainder_scalar(np.asarray(data, np.int64), polynomial) == 0


def polar_encode_np(message, N, info_bits, use_crc=False, crc_polynomial="CRC-8"):
    msg = np.asarray(message, np.int64)
    if use_crc:
        msg = crc_encode_np(msg, crc_polynomial)
    u = np.zeros(N, dtype=np.int64)
    u[np.asarray(info_bits, np.int64)] = msg
    return polar_transform_np(u)


# ---------------------------------------------------------------------------
# shared trellis rules (reference decoder.py:73-170)
# ---------------------------------------------------------------------------

def _f(a: float, b: float) -> float:
    return np.sign(a) * np.sign(b) * min(abs(a), abs(b))


def _g(btm: float, top: float, bit: float) -> float:
    return btm + top if bit == 0 else btm - top


def _active_llr_level(l: int, n: int) -> int:
    count = 1
    for k in range(n - 1, -1, -1):
        if (l >> k) & 1:
            break
        count += 1
    return min(count, n)


def _active_bit_level(l: int, n: int) -> int:
    count = 1
    for k in range(n - 1, -1, -1):
        if not ((l >> k) & 1):
            break
        count += 1
    return min(count, n)


def _update_llrs(L, B, l, n, N):
    for s in range(n - _active_llr_level(l, n), n):
        block = 1 << (s + 1)
        branch = block >> 1
        for j in range(l, N, block):
            if j % block < branch:
                L[j, s + 1] = _f(L[j, s], L[j + branch, s])
            else:
                L[j, s + 1] = _g(L[j, s], L[j - branch, s], B[j - branch, s + 1])


def _update_bits(B, l, n):
    if l < B.shape[0] / 2:
        return
    for s in range(n, n - _active_bit_level(l, n), -1):
        block = 1 << s
        branch = block >> 1
        for j in range(l, -1, -block):
            if j % block >= branch:
                B[j - branch, s - 1] = int(B[j, s]) ^ int(B[j - branch, s])
                B[j, s - 1] = B[j, s]


# ---------------------------------------------------------------------------
# SC (reference decoder.py:38-71)
# ---------------------------------------------------------------------------

def sc_decode_np(llr: np.ndarray, frozen_mask: np.ndarray) -> np.ndarray:
    """Decode one frame; returns the full u-vector [N]."""
    llr = np.asarray(llr, np.float64)
    N = llr.size
    n = int(np.log2(N))
    L = np.full((N, n + 1), np.nan)
    B = np.full((N, n + 1), np.nan)
    L[:, 0] = llr
    for i in range(N):
        l = bit_reverse(i, n)
        _update_llrs(L, B, l, n, N)
        if frozen_mask[l]:
            B[l, n] = 0
        else:
            B[l, n] = 0 if L[l, n] >= 0 else 1
        _update_bits(B, l, n)
    return B[:, n].astype(np.int64)


# ---------------------------------------------------------------------------
# SCL (reference decoder.py:225-339, 374-406)
# ---------------------------------------------------------------------------

def _log_likelihood(llr: float, bit: int) -> float:
    if bit == 0:
        if llr >= 0:
            return -np.log1p(np.exp(-llr))
        return llr - np.log1p(np.exp(llr))
    if llr >= 0:
        return -llr - np.log1p(np.exp(-llr))
    return -np.log1p(np.exp(llr))


def scl_decode_np(llr: np.ndarray, frozen_mask: np.ndarray, list_size: int):
    """Decode one frame with list decoding.

    Returns ``(u_best [N], metrics [L], u_paths [L, N])`` where path order is
    the reference's survivor slot order.
    """
    llr = np.asarray(llr, np.float64)
    N = llr.size
    n = int(np.log2(N))
    Lsz = list_size
    Lp = np.full((Lsz, N, n + 1), np.nan)
    Bp = np.full((Lsz, N, n + 1), np.nan)
    metrics = np.full(Lsz, -np.inf)
    active = np.zeros(Lsz, dtype=bool)
    active[0] = True
    metrics[0] = 0.0
    for p in range(Lsz):
        Lp[p, :, 0] = llr

    for i in range(N):
        l = bit_reverse(i, n)
        if frozen_mask[l]:
            for p in range(Lsz):
                if not active[p]:
                    continue
                _update_llrs(Lp[p], Bp[p], l, n, N)
                Bp[p][l, n] = 0
                metrics[p] += _log_likelihood(Lp[p][l, n], 0)
                _update_bits(Bp[p], l, n)
        else:
            candidates = []
            for bit in (0, 1):
                for p in np.where(active)[0]:
                    if bit == 0:
                        _update_llrs(Lp[p], Bp[p], l, n, N)
                    candidates.append(
                        (metrics[p] + _log_likelihood(Lp[p][l, n], bit), p, bit)
                    )
            # stable descending sort by metric (reference decoder.py:306-307)
            candidates.sort(key=lambda c: c[0], reverse=True)
            survivors = candidates[: min(len(candidates), Lsz)]
            oldL, oldB = Lp.copy(), Bp.copy()
            metrics[:] = -np.inf
            active[:] = False
            for slot, (m, p, bit) in enumerate(survivors):
                Lp[slot] = oldL[p].copy()
                Bp[slot] = oldB[p].copy()
                Bp[slot][l, n] = bit
                metrics[slot] = m
                active[slot] = True
                _update_bits(Bp[slot], l, n)

    best = int(np.argmax(metrics))
    u_paths = Bp[:, :, n]
    # inactive slots hold NaN trellises; report zeros there
    u_paths = np.where(np.isnan(u_paths), 0, u_paths).astype(np.int64)
    return u_paths[best], metrics.copy(), u_paths


# ---------------------------------------------------------------------------
# fast-node SCL twin (SSCL rate-1 / repetition list nodes)
#
# Float64 oracle for ``scanscl.make_scl_decoder_scan(node_mode="fast")`` —
# the *approximate* fast serving mode.  Semantics are defined HERE (there is
# no reference counterpart): the recursion, candidate orderings, tie rules
# and float addition orders below are mirrored 1:1 by the chunked list
# decoder, so it is bit-exact against this twin in float64.
# ---------------------------------------------------------------------------

def _f_np(a, b):
    return np.sign(a) * np.sign(b) * np.minimum(np.abs(a), np.abs(b))


def _tree_sum_np(x, axis=1):
    """Halving-tree float reduction (power-of-two extent) — mirrors
    ``scanscl._tree_sum`` bit-for-bit."""
    while x.shape[axis] > 1:
        h = x.shape[axis] // 2
        lo = np.take(x, range(h), axis=axis)
        hi = np.take(x, range(h, x.shape[axis]), axis=axis)
        x = lo + hi
    return np.squeeze(x, axis=axis)


def _prune_2l_np(cand, Lsz):
    """Stable descending top-L over ordered candidates ``cand [2L]``:
    ``(pm [L], second_half [L] int, src [L])`` — mirrors
    ``scanscl._prune_2l``."""
    top = np.argsort(-cand, kind="stable")[:Lsz]
    return cand[top], (top >= Lsz).astype(np.int64), top % Lsz


def scl_decode_fast_np(llr, frozen_mask, list_size, chunk=128):
    """Fast-node SCL list decode of one frame (float64).

    Returns ``(u_best [N], metrics [L], u_paths [L, N])`` with paths in
    survivor slot order — same contract as ``scl_decode_np``.  ``chunk``
    gates fast-node (and rate-0 collapse) sizes to match the chunk-scan
    decoder's subtree cut: special handling applies only to subtrees of
    size ≤ chunk, and larger regions recurse with the same f/g descent
    the scan performs between chunks.
    """
    llr = np.asarray(llr, np.float64)
    N = llr.size
    n = int(np.log2(N))
    Lsz = list_size
    rev = np.array([bit_reverse(i, n) for i in range(N)], np.int64)
    flags = np.asarray(frozen_mask, bool)[rev]
    chunk = min(chunk, N)

    def d0(a):
        return -np.logaddexp(0.0, -a)

    def d1(a):
        return -np.logaddexp(0.0, a)

    def rate0(a):
        if a.shape[1] == 1:
            return d0(a[:, 0])
        h = a.shape[1] // 2
        first, second = a[:, :h], a[:, h:]
        return rate0(_f_np(first, second)) + rate0(second + first)

    def rate1(a, pm):
        S = a.shape[1]
        mags = np.abs(a)
        hard = (a < 0).astype(np.int64)
        pm = pm - _tree_sum_np(np.logaddexp(0.0, -mags), axis=1)
        K = min(Lsz - 1, S)
        if K == 0:
            return hard, pm, None
        order = np.argsort(mags, axis=1, kind="stable")
        magsK = np.take_along_axis(mags, order[:, :K], axis=1)
        idxK = order[:, :K].copy()
        fdec = np.zeros((Lsz, K), np.int64)
        src_tot = np.arange(Lsz)
        for s in range(K):
            cand = np.concatenate([pm, pm - magsK[:, s]])
            pm, flip, src = _prune_2l_np(cand, Lsz)
            magsK, idxK, fdec = magsK[src], idxK[src], fdec[src]
            fdec[:, s] = flip
            src_tot = src_tot[src]
        beta = hard[src_tot]
        for p in range(Lsz):
            for s in range(K):
                if fdec[p, s]:
                    beta[p, idxK[p, s]] ^= 1
        return beta, pm, src_tot

    def rep(a, pm):
        cand = np.concatenate([pm + _tree_sum_np(d0(a), axis=1),
                               pm + _tree_sum_np(d1(a), axis=1)])
        pm, bit, src = _prune_2l_np(cand, Lsz)
        return np.tile(bit[:, None], (1, a.shape[1])), pm, src

    def node(alpha, pm, off, size):
        sub = flags[off:off + size]
        if size <= chunk and sub.all():
            return np.zeros((Lsz, size), np.int64), pm + rate0(alpha), None
        if size == 1:
            a = alpha[:, 0]
            cand = np.concatenate([pm + d0(a), pm + d1(a)])
            pm, bits, src = _prune_2l_np(cand, Lsz)
            return bits[:, None], pm, src
        if size <= chunk:
            if not sub.any():
                return rate1(alpha, pm)
            if sub[:-1].all() and not sub[-1]:
                return rep(alpha, pm)
        half = size // 2
        first, second = alpha[:, :half], alpha[:, half:]
        beta_l, pm, src_l = node(_f_np(first, second), pm, off, half)
        if src_l is not None:
            alpha = alpha[src_l]
            first, second = alpha[:, :half], alpha[:, half:]
        sgn = 1.0 - 2.0 * beta_l.astype(np.float64)
        beta_r, pm, src_r = node(second + sgn * first, pm, off + half, half)
        if src_r is not None:
            beta_l = beta_l[src_r]
        beta = np.concatenate([beta_l ^ beta_r, beta_r], axis=1)
        if src_l is None:
            src = src_r
        elif src_r is None:
            src = src_l
        else:
            src = src_l[src_r]
        return beta, pm, src

    pm0 = np.full(Lsz, -np.inf)
    pm0[0] = 0.0
    root_beta, metrics, _ = node(np.tile(llr[rev], (Lsz, 1)), pm0, 0, N)
    beta_nat = root_beta[:, rev]  # bit-reversal is an involution
    u_paths = np.stack([polar_transform_np(b) for b in beta_nat])
    best = int(np.argmax(metrics))
    return u_paths[best], metrics.copy(), u_paths
