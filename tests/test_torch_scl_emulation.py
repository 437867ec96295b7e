"""Host-side emulation of the SCL kernels' programs.

A CUDA kernel cannot run on a CPU host.  What the kernels of
``ops/csrc/scl_decode.cu`` READ, however, is built in Python: the chunk's node
program (``build_scl_body_program``), the step arguments ``(k, inv, j, compose
masks)`` and the packed, flat device state (``SCLState``).  This file walks
those tables exactly as the kernels do — same flat offsets, same in-place
passes, same packed path bits, same order of float additions, one op at a
time — with the frame batch as a leading axis, and holds the result against
the plain PyTorch versions bit for bit.  The float expressions use the same
torch operators as the plain version, so equality is exact.

Live-width (narrow) chunk steps are walked the same way, over the first
``w`` rows and lanes only, with the one-lane pendings read at lane 0, against
the plain live-width step on the live-width state; and the narrow prefix,
the narrow steps of a decode in one launch, row by row from its step table.

The fast node ops (``node_mode="fast"``) are walked the same way: a larger
fast node on its paths' lane groups (lane (q, j) holds positions j + G·k in
registers), the halving-tree sums over the registers then the group's
xor-shuffles, each selection round (the least ``(|a|, position)`` pair
strictly above the previous pick, the group's argmin) fused with its prune
stage, the slot → original-path composition the kernel keeps in a register
per lane, the per-slot flip bits composed the same way, the words by ballots
and the XOR of the flips into them; a fast ``OP_SUBTREE`` lane by lane (the
path's magnitudes on each lane, each lane's stable rank, the flips by rank).
``fastnode_device.cuh``'s ``halving_sum`` and ``select_k`` and the selection
kernel ``fastnode.cu`` (one or two lanes a path and frame, the K least keys
in a sorted register list, the halving-tree sum in bit-reversed order as a
binary counter) are walked against their plain version too, and the last
chunk's butterfly and output stores (``root_out``) lane by lane, with the
banks of their shared-memory accesses.
"""

import dataclasses
import zlib
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import polarcode_and_ldpc_tpu_torch as tfec
from polarcode_and_ldpc_tpu_torch.models.polar.construction import (
    bit_reverse_permutation, frozen_mask_from_positions)
from polarcode_and_ldpc_tpu_torch.models.polar.scanscl import (_d0_d1, build_scl_schedule,
                                                               make_scl_decoder_scan)
from polarcode_and_ldpc_tpu_torch.models.polar import scanscl as tscan
from polarcode_and_ldpc_tpu_torch.models.polar.trellis import f_minsum
from polarcode_and_ldpc_tpu_torch.ops import scl_cuda
from polarcode_and_ldpc_tpu_torch.ops.fastnode_cuda import fastnode_select, fastnode_select_plain
from polarcode_and_ldpc_tpu_torch.ops.scl_cuda import (FLAG_FAST, FLAG_RL, FLAG_RR, OP_COMBINE,
                                                       OP_F, OP_G,
                                                       OP_LEAF, OP_RATE0, OP_RATE1_FAST, OP_REP,
                                                       OP_REP_FAST, OP_SUBTREE, SUBTREE_SHIFT,
                                                       SCLBodyProgram, SCLState,
                                                       build_scl_body_program, make_step_specs,
                                                       unpack_paths)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread for the port's side, module fixtures included: many
    small ops cost a fraction on one thread of what waking torch's thread pool
    costs on a busy host, and the cores of the other test workers are left
    alone.  The count is restored after the module."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


class Ctx:
    """One warp's shared memory, for every frame at once."""

    def __init__(self, B, L, S):
        self.L, self.S, self.lgS = L, S, int(np.log2(S))
        self.alpha = torch.zeros((B, 2 * S * L), dtype=torch.float32)
        self.beta = torch.zeros((B, S), dtype=torch.int64)  # packed words
        self.pm = torch.zeros((B, L), dtype=torch.float32)
        self.R = torch.zeros((B, L), dtype=torch.int64)
        self.Rstack = torch.zeros((B, self.lgS + 1, L), dtype=torch.int64)
        self.top = None  # the chunk's top plane where it lies ([B, L·S]), else in alpha

    def depth_base(self, d):
        return self.L * (2 * self.S - ((2 * self.S) >> d))

    def plane(self, d):
        """The alpha plane at depth d and on (a view: writes go in place)."""
        if d == 0 and self.top is not None:
            return self.top
        return self.alpha[:, self.depth_base(d):]


def perm_word(w, r, L):
    """bit l of the result is bit r[l] of w; ``w [B, n]``, ``r [B, L]``."""
    out = torch.zeros_like(w)
    for l in range(L):
        out |= ((w >> r[:, l:l + 1]) & 1) << l
    return out


def perm_words_ballot(w, r, n):
    """``scl::perm_words_ballot`` lane by lane: position i's word ``w [B, m]``
    is shuffled from lane i to the warp, lane l < n votes its bit r[l], and
    the ballot is position i's result."""
    lane = torch.arange(32)
    rl = torch.zeros((w.shape[0], 32), dtype=torch.int64)
    rl[:, :n] = r[:, :n]  # lanes >= n hold what they hold: their vote is masked
    out = torch.zeros_like(w)
    for i in range(w.shape[1]):
        vote = (lane < n) & (((w[:, i:i + 1] >> rl) & 1) == 1)
        out[:, i] = (vote.long() << lane).sum(dim=1)
    return out


def zero_dec_inplace(z, total, M):
    m = M
    while m > 1:
        h = m // 2
        q = np.arange(total // 2)
        p = (q // h) * m + (q % h)
        a, b = z[:, p].clone(), z[:, p + h].clone()
        z[:, p] = f_minsum(a, b)
        z[:, p + h] = b + a
        m = h


def info_leaf(c, leaf_a, w):
    d0, d1 = _d0_d1(leaf_a)
    return prune(c, torch.cat([c.pm[:, :w] + d0, c.pm[:, :w] + d1], dim=1), w)


def _pow2_ceil(w):
    return 1 if w <= 1 else 1 << (w - 1).bit_length()


def prune_lanes(cand, w, keep):
    """``scl::prune`` as the warp runs it, lane by lane: ``cand [B, 2w]``
    (bit-0 candidates, then bit-1) → ``(src [B, keep], word [B])``, the
    candidate index each slot lane takes and the ballot of the bit-1 flags.
    Lane ``g·P + p`` (P = w rounded up to a power of two) holds path p's two
    candidates; group g counts the candidates above them over its share of
    the paths (one shuffle pair per path), an xor-shuffle tree sums the
    groups; then each lane looks for the ranks p and p + P the same way (P <
    32), or slot lane s intersects, bit by bit of s, the ballots of the live
    lanes whose rank has that bit (P = 32)."""
    B = cand.shape[0]
    P = _pow2_ceil(w)
    G, per = 32 // P, -(-w // (32 // P))
    lane = np.arange(32)
    g, p = lane // P, lane % P
    hold = np.minimum(p, w - 1)  # a lane of a path >= w holds what it holds: never read
    c0, c1 = cand[:, :w][:, hold], cand[:, w:][:, hold]
    pt = torch.as_tensor(p)
    r0 = torch.zeros((B, 32), dtype=torch.int64)
    r1 = torch.zeros((B, 32), dtype=torch.int64)
    for k in range(per):
        j = torch.as_tensor(g * per + k)
        a, b = c0[:, j % 32], c1[:, j % 32]
        valid = j < w
        r0 += (valid & ((a > c0) | ((a == c0) & (j < pt)))).long() + (valid & (b > c0)).long()
        r1 += (valid & (a >= c1)).long() + (valid & ((b > c1) | ((b == c1) & (j < pt)))).long()
    off = P
    while off < 32:
        r0, r1 = r0 + r0[:, lane ^ off], r1 + r1[:, lane ^ off]
        off *= 2
    if P < 32:
        s0 = torch.full((B, 32), -1, dtype=torch.int64)
        s1 = torch.full((B, 32), -1, dtype=torch.int64)
        for k in range(per):
            j = torch.as_tensor(g * per + k)
            a, b = r0[:, j % 32], r1[:, j % 32]
            valid = j < w
            for tgt, sv in ((pt, s0), (pt + P, s1)):
                sv[:] = torch.where(valid & (a == tgt), j, sv)
                sv[:] = torch.where(valid & (b == tgt), w + j, sv)
        off = P
        while off < 32:
            s0, s1 = torch.maximum(s0, s0[:, lane ^ off]), torch.maximum(s1, s1[:, lane ^ off])
            off *= 2
        return _src_word(torch.where(torch.as_tensor(lane < P), s0, s1)[:, :keep], w, keep)
    own = torch.as_tensor(lane < w)
    m0 = own[None, None, :].expand(B, 32, 32).clone()  # [frame, slot lane, lane j]
    m1 = m0.clone()
    for bit in range((2 * w - 1).bit_length()):
        b0 = own & ((r0 >> bit) & 1).bool()  # each ballot: [frame, lane j]
        b1 = own & ((r1 >> bit) & 1).bool()
        want = torch.as_tensor((lane >> bit) & 1).bool()[None, :, None]
        m0 &= torch.where(want, b0[:, None, :], ~b0[:, None, :])
        m1 &= torch.where(want, b1[:, None, :], ~b1[:, None, :])

    def first(m):  # __ffs(m) - 1
        return torch.where(m.any(-1), m.int().argmax(-1), -1)

    return _src_word(torch.where(m0.any(-1), first(m0), w + first(m1))[:, :keep], w, keep)


def _src_word(src, w, keep):
    """Each slot's candidate and the ballot of the slots' bit-1 flags."""
    return src, ((src >= w).long() << torch.arange(keep)).sum(dim=1)


def prune(c, cand, w):
    """The stable top-min(2w, L) of the 2w candidates of w live paths, as the
    kernel's register prune ranks them (``prune_lanes``)."""
    keep = min(2 * w, c.L)
    src, word = prune_lanes(cand, w, keep)
    c.pm[:, :keep] = torch.gather(cand, 1, src)
    c.R[:, :keep] = torch.where(src < w, src, src - w)
    return word


def softplus(a):
    return torch.log1p(torch.exp(-a.abs()))


def halving_sum(a, L, M, f):
    """``fastnode::halving_sum`` on flat ``a [B, L·M]``: the kernel's flat
    indices, level by level; returns the scratch ``z [B, L·H]`` (row l's sum
    at ``l·H``) and ``H``."""
    H = M // 2 if M > 1 else 1
    q = np.arange(L * H)
    l, i = q // H, q % H
    z = f(a[:, l * M + i]) + f(a[:, l * M + i + H]) if M > 1 else f(a[:, l])
    h = H // 2
    while h >= 1:
        q = np.arange(L * h)
        l, i = q // h, q % h
        z[:, l * H + i] = z[:, l * H + i] + z[:, l * H + i + h]
        h //= 2
    return z, H


def select_k(a, L, M, K):
    """``fastnode::select_k`` on flat ``a [B, L·M]``: per round, each lane of
    a path's group of G takes its least pair above the previous pick, then
    the xor-shuffle tree of the group; returns ``idx [B, L, K]``."""
    B = a.shape[0]
    G = 32
    while G * L > 32:
        G //= 2
    mags = a.reshape(B, L, M).abs()
    last_m = torch.full((B, L), -np.inf)
    last_p = torch.full((B, L), -1, dtype=torch.int64)
    idx = torch.zeros((B, L, K), dtype=torch.int64)
    for k in range(K):
        bm = torch.full((B, L, G), np.inf)
        bp = torch.full((B, L, G), 2 ** 31 - 1, dtype=torch.int64)
        for i in range(M):  # lane `i % G` of the path's group meets position i
            m, sub = mags[:, :, i], i % G
            above = (m > last_m) | ((m == last_m) & (i > last_p))
            better = above & ((m < bm[:, :, sub]) | ((m == bm[:, :, sub]) & (i < bp[:, :, sub])))
            bm[:, :, sub] = torch.where(better, m, bm[:, :, sub])
            bp[:, :, sub] = torch.where(better, i, bp[:, :, sub])
        off = G // 2
        while off >= 1:
            partner = torch.as_tensor(np.arange(G) ^ off)
            om, op = bm[:, :, partner], bp[:, :, partner]
            take = (om < bm) | ((om == bm) & (op < bp))
            bm, bp = torch.where(take, om, bm), torch.where(take, op, bp)
            off //= 2
        last_m, last_p = bm[:, :, 0], bp[:, :, 0]
        idx[:, :, k] = last_p
    return idx


def fast_group(L, sz):
    """``scl::group_of``: each path's G lanes (the most with G·L <= 32, at most
    sz) and the E = sz / G elements a lane holds (positions j + G·k)."""
    G = 32
    while G * L > 32:
        G //= 2
    G = min(G, sz)
    return G, sz // G


def group_halving_sum(x, G):
    """``scl::group_halving_sum``: ``x [B, L, E, G]`` (lane j's registers k)
    halved over k, then xor-shuffled over the group's lanes j."""
    h = x.shape[2] // 2
    while h >= 1:
        x = x[:, :, :h] + x[:, :, h:2 * h]
        h //= 2
    z = x[:, :, 0]
    d = G // 2
    while d >= 1:
        z = z + z[:, :, np.arange(G) ^ d]
        d //= 2
    return z[:, :, 0]


def rate1_fast(c, a, sz, off):
    """``scl::rate1_fast<kE>`` on the node's flat plane ``a [B, L·sz]``: lane
    (q, j) holds positions j + G·k of path q, in registers for E <= 8 (else
    the sums go through ``fastnode::halving_sum`` and each round re-reads the
    plane: the same values); selection round s fused with stage s — each
    lane's least pair above the last pick, then the group's xor-shuffle
    argmin, slot p's cost from its original path rtot[p]'s group —; the
    words by ballots over slots of the original paths' hard decisions, then
    each slot's flips at its original path's picks."""
    L, B = c.L, a.shape[0]
    G, E = fast_group(L, sz)
    x = a.reshape(B, L, E, G)  # [frame, path q, register k, lane j]
    if E <= 8:
        pen = group_halving_sum(softplus(x), G)
    else:
        z, H = halving_sum(a, L, sz, softplus)
        pen = z[:, np.arange(L) * H]
    c.pm = c.pm - pen
    K = min(L - 1, sz)
    mags = x.abs()
    pos = torch.arange(sz).reshape(E, G)
    last_m = torch.full((B, L), -np.inf)
    last_p = torch.full((B, L), -1, dtype=torch.int64)
    idx = torch.zeros((B, L, K), dtype=torch.int64)
    rtot = torch.arange(L).expand(B, L).clone()  # slot lane l's register
    flips = torch.zeros((B, L), dtype=torch.int64)  # lane l's: bit s = stage s's flip
    rows = torch.arange(B)[:, None]
    for s in range(K):
        above = (mags > last_m[:, :, None, None]) | (
            (mags == last_m[:, :, None, None]) & (pos > last_p[:, :, None, None]))
        bm = torch.full((B, L, G), np.inf)
        bp = torch.full((B, L, G), 2 ** 31 - 1, dtype=torch.int64)
        for k in range(E):  # the lane's registers in order
            m, i = mags[:, :, k], pos[k]
            take = above[:, :, k] & ((m < bm) | ((m == bm) & (i < bp)))
            bm, bp = torch.where(take, m, bm), torch.where(take, i, bp)
        d = G // 2
        while d >= 1:  # the group's argmin
            partner = torch.as_tensor(np.arange(G) ^ d)
            om, op = bm[:, :, partner], bp[:, :, partner]
            take = (om < bm) | ((om == bm) & (op < bp))
            bm, bp = torch.where(take, om, bm), torch.where(take, op, bp)
            d //= 2
        last_m, last_p = bm[:, :, 0], bp[:, :, 0]
        idx[:, :, s] = last_p
        mg = last_m[rows, rtot]  # slot p's flip cost, from its original path's group
        word = prune(c, torch.cat([c.pm, c.pm - mg], dim=1), L)
        flips = torch.gather(flips, 1, c.R) | (((word[:, None] >> torch.arange(L)) & 1) << s)
        rtot = torch.gather(rtot, 1, c.R)
    if K:
        c.R = rtot
    # the ballots: lane jj·P + l votes slot l's hard decision of position
    # base + jj of its original path; position base + jj's word is bits jj·P..
    P = _pow2_ceil(L)
    hard = (torch.gather(a.reshape(B, L, sz), 1, rtot[:, :, None].expand(B, L, sz)) < 0).long()
    for base in range(0, sz, 32 // P):
        ballot = torch.zeros(B, dtype=torch.int64)
        for lane in range(32):
            jj, l = lane // P, lane % P
            if l < L and base + jj < sz:
                ballot |= hard[:, l, base + jj] << lane
        for jj in range(min(32 // P, sz - base)):
            c.beta[:, off + base + jj] = (ballot >> (jj * P)) & ((1 << P) - 1)
    for q in range(L * K):
        l, s = q // K, q % K
        hit = ((flips[:, l] >> s) & 1).bool()
        p = off + idx[torch.arange(B), rtot[:, l], s]
        c.beta[rows[hit, 0], p[hit]] ^= 1 << l


def rep_fast(c, a, sz, off):
    """``scl::rep_fast<kE>``: both sums from one softplus an element, on the
    group's registers (E <= 8) or through ``fastnode::halving_sum``."""
    L, B = c.L, a.shape[0]
    G, E = fast_group(L, sz)
    if E <= 8:
        d0, d1 = _d0_d1(a.reshape(B, L, E, G))
        s0, s1 = group_halving_sum(d0, G), group_halving_sum(d1, G)
    else:
        z0, H = halving_sum(a, L, sz, lambda x: _d0_d1(x)[0])
        z1, _ = halving_sum(a, L, sz, lambda x: _d0_d1(x)[1])
        s0, s1 = z0[:, np.arange(L) * H], z1[:, np.arange(L) * H]
    word = prune(c, torch.cat([c.pm + s0, c.pm + s1], dim=1), L)
    c.beta[:, off:off + sz] = word[:, None]


_LANE = np.arange(32)


def _shfl(v, src):
    """``__shfl_sync(v, src & 31)`` over the frames: ``v [B, 32]``, ``src``
    one lane per lane (``[32]``) or per frame and lane (``[B, 32]``)."""
    src = torch.as_tensor(src) & 31
    return v[:, src] if src.dim() == 1 else torch.gather(v, 1, src)


def _slots(x, fill=0):
    """A slot register (``[B, L]``: lane l holds x[l]) as all 32 lanes."""
    out = torch.full((x.shape[0], 32), fill, dtype=x.dtype)
    out[:, :x.shape[1]] = x
    return out


def sub_zero_dec(K, i, z):
    h = (1 << K) // 2
    while h >= 1:
        o = z[:, _LANE ^ h]
        z = torch.where(torch.as_tensor(i & h != 0), z + o, f_minsum(z, o))
        h //= 2
    return z


def sub_halving_sum(K, z):
    """``scl::sub_halving_sum<K>``: xor-shuffles at distance 2^K / 2 first."""
    h = (1 << K) // 2
    while h >= 1:
        z = z + z[:, _LANE ^ h]
        h //= 2
    return z


def sub_rate1_fast(K, s, a, c):
    """``scl::sub_rate1_fast<K>`` lane by lane (full width): the penalty by
    xor-shuffles, each lane's stable rank and the magnitude of rank i from
    the path's 2^K magnitudes, ``min(L − 1, 2^K)`` register prunes, and lane
    (l, i)'s bit from slot l's original path and the flip of its rank's
    stage."""
    M, L, B = 1 << K, c.L, a.shape[0]
    lane, l, i, lg = _LANE, s["l"], s["i"], s["lg"]
    c.pm = c.pm - _shfl(sub_halving_sum(K, softplus(a)), lane << lg)[:, :L]
    mag = a.abs()
    m = [_shfl(mag, (l << lg) + j) for j in range(M)]
    rank = torch.zeros((B, 32), dtype=torch.int64)
    smag = torch.zeros((B, 32))
    ii = torch.as_tensor(i)
    for j in range(M):
        rj = sum(((m[q] < m[j]) | ((m[q] == m[j]) & (q < j))).long() for q in range(M) if q != j)
        smag = torch.where(rj == ii, m[j], smag)
        rank = torch.where(ii == j, rj, rank)
    n = min(L - 1, M)
    rtot = torch.as_tensor(lane).expand(B, 32).clone()
    flips = torch.zeros((B, 32), dtype=torch.int64)
    slots = torch.as_tensor(lane < L)
    for st in range(n):
        mg = torch.gather(smag, 1, (rtot[:, :L] << lg) + st)  # slot p's flip cost
        word = prune(c, torch.cat([c.pm, c.pm - mg], dim=1), L)
        frm = torch.where(slots, _slots(c.R), 0)
        flips = torch.gather(flips, 1, frm) | (((word[:, None] >> torch.as_tensor(lane)) & 1) << st)
        rtot = torch.gather(rtot, 1, frm)
    if n:
        c.R = rtot[:, :L].clone()
    src = ((_shfl(rtot, l) if n else torch.as_tensor(l).expand(B, 32)) << lg) + ii
    hard = (torch.gather(a, 1, src) < 0).long()
    rk = torch.gather(rank, 1, src)
    fl = _shfl(flips, l)
    return hard ^ torch.where(rk < n, (fl >> rk.clamp(max=31)) & 1, 0), n > 0


def sub_rep_fast(K, s, a, c):
    """``scl::sub_rep_fast<K>``: one softplus for both sums, one prune."""
    d0, d1 = (sub_halving_sum(K, x) for x in _d0_d1(a))
    rows = np.arange(c.L) << s["lg"]
    word = prune(c, torch.cat([c.pm + d0[:, rows], c.pm + d1[:, rows]], dim=1), c.L)
    return (word[:, None] >> torch.as_tensor(s["l"])) & 1, True


def sub_node(K, s, a, fz, c, st, fast=False):
    """``scl::sub_node<K>`` lane by lane: ``a [B, 32]`` the node's alpha on
    lanes ``(l, i < 2^K)`` (lane = l·sz + i), ``fz`` its frozen bits, slot
    registers ``c.pm`` / ``c.R``, the live width in ``st["w"]``; returns the
    bit on each lane and whether the node pruned.  ``fast``: the fast
    program's dispatch (all-info and repetition nodes whole)."""
    M = 1 << K
    full = (1 << M) - 1
    lane, l, i, lg = _LANE, s["l"], s["i"], s["lg"]
    w, L = st["w"], c.L
    if fz & full == full:  # rate-0
        z = sub_zero_dec(K, i, a)
        z = _d0_d1(z)[0]
        step = 1
        while step < M:
            o = z[:, lane ^ step]
            z = torch.where(torch.as_tensor(i & (2 * step - 1) == 0), z + o, z)
            step *= 2
        v = _shfl(z, lane << lg)
        c.pm[:, :w] = c.pm[:, :w] + v[:, :w]
        return torch.zeros_like(a, dtype=torch.int64), False
    if fast and K > 0 and fz & full == 0:
        return sub_rate1_fast(K, s, a, c)
    if fast and K > 0 and fz & full == full >> 1:
        return sub_rep_fast(K, s, a, c)
    if K == 0 or fz & full == full >> 1:  # an info leaf, or REP
        p = np.arange(w)
        if K == 0:
            leaf = a[:, (p << lg) & 31]
        else:
            z = sub_zero_dec(K, i, a)
            leaf = z[:, ((p << lg) + M - 1) & 31]
            z = _d0_d1(z)[0]
            k = 0
            while (M >> k) > 2:
                step = 1 << k
                o = z[:, lane ^ step]
                z = torch.where(torch.as_tensor((i & (2 * step - 1) == 0) & (i < M - 2 * step)),
                                z + o, z)
                k += 1
            acc = _slots(c.pm)
            for j in range(1, K + 1):
                acc = acc + _shfl(z, (lane << lg) + M - (M >> (j - 1)))
            c.pm[:, :w] = acc[:, :w]
        word = info_leaf(c, leaf, w)
        st["w"] = min(2 * w, L)
        return (word[:, None] >> torch.as_tensor(l)) & 1, True
    h = M // 2
    down = np.where(lane + h < 32, lane + h, lane)
    bl, rl = sub_node(K - 1, s, f_minsum(a, a[:, down]), fz, c, st, fast)
    Rl = _slots(c.R)
    r = _shfl(Rl, l) if rl else torch.as_tensor(l).expand_as(Rl)
    first = _shfl(a, (r << lg) + torch.as_tensor(i))
    second = _shfl(a, (r << lg) + torch.as_tensor(i) + h)
    sgn = 1.0 - 2.0 * bl.to(torch.float32)
    br, rr = sub_node(K - 1, s, second + sgn * first, fz >> h, c, st, fast)
    Rr = _slots(c.R)
    lsrc = _shfl(Rr, l) if rr else torch.as_tensor(l).expand_as(Rr)
    left = _shfl(bl, (lsrc << lg) + torch.as_tensor(i))
    up = br[:, np.where(lane >= h, lane - h, lane)]
    composed = _shfl(Rl, Rr if rr else torch.as_tensor(lane).expand_as(Rr))
    if rl:
        c.R = composed[:, :L].clone()
    return torch.where(torch.as_tensor(i < h), left ^ br, up), rl or rr


def subtree(c, plane, sz, fz, st, fast=False):
    """``scl::subtree``: the node's plane ``[B, L·sz]`` onto the lanes, the
    node decoded (``fast``: by the fast dispatch), the bits of the live paths
    packed per position."""
    B, L = plane.shape[0], c.L
    lg = int(np.log2(sz))
    s = {"l": _LANE >> lg, "i": _LANE & (sz - 1), "lg": lg}
    a = torch.zeros((B, 32), dtype=torch.float32)
    a[:, :L * sz] = plane
    bits, _ = sub_node(lg, s, a, fz, c, st, fast)
    live = torch.as_tensor(s["l"] < st["w"])
    words = torch.zeros((B, sz), dtype=torch.int64)
    for i in range(sz):
        for l in range(L):
            words[:, i] |= ((bits[:, (l << lg) + i] != 0) & live[(l << lg) + i]).long() << l
    return words


def chunk_body(c, ops, has_r, w=None):
    """The body over ``w`` live paths (default: the full list), the width
    doubling at every info leaf up to L."""
    L = c.L
    w = L if w is None else w
    for op, d, sz, off in ops.tolist():
        kind = op & 0xFF
        nxt = c.depth_base(d + 1)
        src = c.plane(d)
        if kind == OP_F:
            idx = np.arange(w * sz)
            l, i = idx // sz, idx % sz
            c.alpha[:, nxt + idx] = f_minsum(src[:, l * 2 * sz + i], src[:, l * 2 * sz + sz + i])
        elif kind == OP_G:
            if op & FLAG_RL:
                c.Rstack[:, d, :w] = c.R[:, :w]
            idx = np.arange(w * sz)
            l, i = torch.as_tensor(idx // sz), torch.as_tensor(idx % sz)
            r = c.Rstack[:, d][:, l] if op & FLAG_RL else l[None, :].expand(c.pm.shape[0], -1)
            bit = (c.beta[:, off + i] >> l[None, :]) & 1
            sgn = 1.0 - 2.0 * bit.to(torch.float32)
            second = torch.gather(src, 1, r * 2 * sz + sz + i[None, :])
            first = torch.gather(src, 1, r * 2 * sz + i[None, :])
            c.alpha[:, nxt + idx] = second + sgn * first
        elif kind == OP_COMBINE:
            word = c.beta[:, off:off + sz]
            if op & FLAG_RR:  # few positions and a wide list: by ballots, as the kernel
                word = perm_words_ballot(word, c.R, w) if 2 * sz < w else perm_word(word, c.R, w)
            c.beta[:, off:off + sz] = word ^ c.beta[:, off + sz:off + 2 * sz]
            if op & FLAG_RL:
                saved = c.Rstack[:, d]
                c.R[:, :w] = (torch.gather(saved, 1, c.R[:, :w]) if op & FLAG_RR
                              else saved[:, :w].clone())
        elif kind == OP_RATE0:
            z = src[:, :w * sz]  # a view: in place
            zero_dec_inplace(z, w * sz, sz)
            z[:] = _d0_d1(z)[0]
            s = 1
            while s < sz:
                p = np.arange((w * sz) // (2 * s)) * 2 * s
                z[:, p] = z[:, p] + z[:, p + s]
                s *= 2
            c.pm[:, :w] = c.pm[:, :w] + z[:, np.arange(w) * sz]
            c.beta[:, off:off + sz] = 0
        elif kind == OP_LEAF:
            word = info_leaf(c, src[:, :w].clone(), w)
            c.beta[:, off] = word
            w = min(2 * w, L)
        elif kind == OP_REP:
            z = src[:, :w * sz]
            lgM = int(np.log2(sz))
            zero_dec_inplace(z, w * sz, sz)
            leaf_a = z[:, np.arange(w) * sz + sz - 1].clone()
            z[:] = _d0_d1(z)[0]
            k = 0
            while (sz >> k) > 2:
                pairs = (sz >> (k + 1)) - 1
                q = np.arange(w * pairs)
                l, i = q // pairs, q % pairs
                p = l * sz + (i << (k + 1))
                z[:, p] = z[:, p] + z[:, p + (1 << k)]
                k += 1
            pm = c.pm[:, :w].clone()
            for j in range(1, lgM + 1):
                pm = pm + z[:, np.arange(w) * sz + sz - (sz >> (j - 1))]
            c.pm[:, :w] = pm
            word = info_leaf(c, leaf_a, w)
            c.beta[:, off:off + sz] = word[:, None]
            w = min(2 * w, L)
        elif kind == OP_RATE1_FAST:
            rate1_fast(c, src[:, :L * sz].clone(), sz, off)
        elif kind == OP_REP_FAST:
            rep_fast(c, src[:, :L * sz].clone(), sz, off)
        elif kind == OP_SUBTREE:
            st = {"w": w}
            c.beta[:, off:off + sz] = subtree(c, src[:, :L * sz].clone(), sz,
                                              op >> SUBTREE_SHIFT, st, bool(op & FLAG_FAST))
            w = st["w"]
        else:
            raise AssertionError(kind)
    if not has_r:
        c.R = torch.arange(L).expand(c.pm.shape[0], L).clone()


def works_in_place(ops) -> bool:
    """``chunk_top``'s rule: a chunk that is one rate-0 or REP node works on
    its top plane in place, so it takes a copy in the context."""
    return len(ops) == 1 and (int(ops[0][0]) & 0xFF) in (OP_RATE0, OP_REP)


def byte_perm(a, b, sel):
    """``__byte_perm(a, b, sel)`` on words held as int64: byte i of the result
    is byte ``(sel >> 4 i) & 7`` of the eight bytes of a (0-3) and b (4-7)."""
    out = torch.zeros_like(a)
    for i in range(4):
        k = (sel >> (4 * i)) & 7
        out |= (((a if k < 4 else b) >> (8 * (k & 3))) & 0xFF) << (8 * i)
    return out


def beta_out_lanes(words, L, S):
    """The body kernel's β stores lane by lane (``body_out``): piece k of the
    L · S / 16 pieces is path ``l = k mod L`` (path fastest, so the lanes of a
    16-byte shared-memory read phase share its words), positions ``16 (k / L)``
    on; its 16 packed words' byte ``l / 8`` gathered four at a time by
    ``__byte_perm``, a shift and mask leaves one 0 / 1 byte a position, one
    16-byte store.  S < 16: one byte a store."""
    B = words.shape[0]
    out = torch.full((B, L * S), -1, dtype=torch.int64)
    if S < 16:
        for idx in range(L * S):
            out[:, idx] = (words[:, idx % S] >> (idx // S)) & 1
    else:
        pieces = L * S // 16
        for k in range(pieces):
            ib, l = divmod(k, L)
            sel = (l >> 3) | ((4 + (l >> 3)) << 4)
            for q in range(4):
                w = [words[:, 16 * ib + 4 * q + e] for e in range(4)]
                x = byte_perm(byte_perm(w[0], w[1], sel), byte_perm(w[2], w[3], sel), 0x5410)
                v = (x >> (l & 7)) & 0x01010101
                for e in range(4):
                    assert (out[:, l * S + 16 * ib + 4 * q + e] == -1).all()  # written once
                    out[:, l * S + 16 * ib + 4 * q + e] = (v >> (8 * e)) & 0xFF
    assert (out >= 0).all()  # every position written
    return out.reshape(B, L, S).to(torch.int8)


def _pow2_vectors(L) -> bool:
    """The one-hot planes go by 16-byte pieces of four columns when L is a
    power of two of at least 4 (row and column by shift and mask)."""
    return L >= 4 and L & (L - 1) == 0


def r_plane_lanes(R, L):
    """The body kernel's one-hot R stores: piece v of row ``4v >> lg L``,
    columns ``4v & (L − 1)`` on, the row's rank shuffled from lane row, four
    exact 1.0 / +0.0 in one 16-byte store; else one float a store."""
    B = R.shape[0]
    out = torch.full((B, L * L), float("nan"))
    if _pow2_vectors(L):
        lg = L.bit_length() - 1
        for v in range(L * L // 4):
            idx = 4 * v
            row, col0 = idx >> lg, idx & (L - 1)
            for q in range(4):
                out[:, idx + q] = (col0 + q == R[:, row]).float()
    else:
        for idx in range(L * L):
            out[:, idx] = (idx % L == R[:, idx // L]).float()
    return out.reshape(B, L, L)


def emulate_body(program: SCLBodyProgram, alpha, pm):
    """K5 as the kernel runs it: the body on the input plane where it lies (a
    view: a write would show in ``alpha``), a chunk that is one rate-0 or REP
    node on a copy in the context; β by 16-byte stores."""
    B, L, S = alpha.shape
    c = Ctx(B, L, S)
    flat = alpha.reshape(B, L * S)
    if works_in_place(program.ops):
        c.alpha[:, :L * S] = flat
    else:
        c.top = flat
    c.pm = pm.clone()
    chunk_body(c, program.ops, program.has_r)
    return beta_out_lanes(c.beta, L, S), c.pm, c.R


class Stacks:
    """Flat views of one ``SCLState``, addressed as the kernels address them."""

    def __init__(self, state: SCLState):
        s = state.sched
        self.N, self.S, self.L, self.t = s.N, s.S, s.L, s.t
        self.A, self.PA, self.PB = state.alpha, state.pend_a, state.pend_b
        self.Bt = state.beta.to(torch.int64) & 0xFFFFFFFF  # words as unsigned

    def a_off(self, l):
        return self.L * (self.N - (self.N >> (l - 1)))

    def b_off(self, l):
        return self.N - (self.N >> (l - 1))


def descend_g(st, x, lo, inv, w, one_a=0, one_b=0, onehot=False):
    """g at level ``lo`` over ``w`` rows; a pending whose level bit is set in
    ``one_a`` / ``one_b`` is read at lane 0 by every slot.  ``onehot``: the
    parent read through the pending is the one-hot apply's sum (a selected
    zero is −0.0 only if the whole column of the parent's L rows is negative)."""
    N = st.N
    M = N >> lo
    idx = np.arange(w * M)
    l, i = torch.as_tensor(idx // M), torch.as_tensor(idx % M)
    B = x.shape[0]
    bl = st.Bt[:, st.b_off(lo):st.b_off(lo) + M]
    pb = st.PB[:, lo - 1].to(torch.int64)
    pb_lane = torch.zeros_like(l) if (one_b >> (lo - 1)) & 1 else l
    if lo == 1:
        first, second = x[:, i], x[:, M + i]
    else:
        parent = st.A[:, st.a_off(lo - 1):]
        pa_lane = torch.zeros_like(l) if (one_a >> (lo - 2)) & 1 else l
        row = (torch.zeros((B, w * M), dtype=torch.int64) if inv
               else st.PA[:, lo - 2].to(torch.int64)[:, pa_lane])
        first = torch.gather(parent, 1, row * 2 * M + i[None, :])
        second = torch.gather(parent, 1, row * 2 * M + M + i[None, :])
        if onehot and not inv:
            neg = (parent[:, :st.L * 2 * M].reshape(B, st.L, 2 * M).view(torch.int32) < 0).all(1)
            for pos, v in ((i, first), (M + i, second)):
                v[:] = torch.where(v == 0, torch.where(neg[:, pos], -0.0, 0.0), v)
    bit = (bl[:, i] >> pb[:, pb_lane]) & 1
    return second + (1.0 - 2.0 * bit.to(torch.float32)) * first


def emulate_step(state: SCLState, spec, onehot=False):
    """One chunk step at the spec's live widths (``lv_in`` rows in, ``lv_out``
    out; both L at full width); ``onehot``: the g's one-hot zero rule."""
    st = Stacks(state)
    N, S, L, t = st.N, st.S, st.L, st.t
    B = state.pm.shape[0]
    x = state.llr
    wi, wo = spec.lv_in, spec.lv_out
    eye_i, eye_o = torch.arange(wi, dtype=torch.int32), torch.arange(wo, dtype=torch.int32)
    if spec.k == t:
        for l in range(1, t + 1):
            M = N >> l
            src = x if l == 1 else st.A[:, st.a_off(l - 1):]
            v = f_minsum(src[:, :M], src[:, M:2 * M])
            st.A[:, st.a_off(l):st.a_off(l) + wi * M] = v.repeat(1, wi)
            st.PA[:, l - 1, :wi] = eye_i
    else:
        lo = t - spec.k
        M = N >> lo
        st.A[:, st.a_off(lo):st.a_off(lo) + wi * M] = descend_g(st, x, lo, spec.inv, wi,
                                                                spec.one_a, spec.one_b, onehot)
        st.PA[:, lo - 1, :wi] = eye_i
        for l in range(lo + 1, t + 1):
            M = N >> l
            idx = np.arange(wi * M)
            r, i = idx // M, idx % M
            src = st.A[:, st.a_off(l - 1):]
            st.A[:, st.a_off(l) + idx] = f_minsum(src[:, r * 2 * M + i], src[:, r * 2 * M + M + i])
            st.PA[:, l - 1, :wi] = eye_i
    c = Ctx(B, L, S)
    c.alpha[:, :wi * S] = st.A[:, st.a_off(t):st.a_off(t) + wi * S]
    c.pm[:, :wi] = state.pm[:, :wi]
    chunk_body(c, spec.program.ops, spec.program.has_r, wi)
    state.pm[:, :wo] = c.pm[:, :wo]
    R = c.R[:, :wo]
    for l in range(1, t + 1):
        if (spec.mask_a >> (l - 1)) & 1:
            st.PA[:, l - 1, :wo] = torch.gather(st.PA[:, l - 1].to(torch.int64), 1, R).to(torch.int32)
        if (spec.mask_b >> (l - 1)) & 1:
            st.PB[:, l - 1, :wo] = torch.gather(st.PB[:, l - 1].to(torch.int64), 1, R).to(torch.int32)
    j = spec.j
    D = S << j
    d0 = st.b_off(t - j)
    st.Bt[:, d0 + D - S:d0 + D] = c.beta
    for s in range(j):
        lev, size = t - s, S << s
        left = st.Bt[:, st.b_off(lev):st.b_off(lev) + size]
        pend = st.PB[:, lev - 1].to(torch.int64)
        one = (spec.one_b >> (lev - 1)) & 1 and not (spec.mask_b >> (lev - 1)) & 1
        word = perm_word(left, pend[:, :1].expand(-1, wo) if one else pend[:, :wo], wo)
        st.Bt[:, d0 + D - 2 * size:d0 + D - size] = word ^ st.Bt[:, d0 + D - size:d0 + D]
    st.PB[:, t - j - 1, :wo] = eye_o
    state.beta = torch.where(st.Bt >= 2 ** 31, st.Bt - 2 ** 32, st.Bt).to(torch.int32)


def emulate_last(state: SCLState, spec, onehot=False):
    """The last chunk: the descend's g (into the kernel's scratch plane), the
    body on it, the ascend to the root, ``root_out``."""
    st = Stacks(state)
    N, S, L, t = st.N, st.S, st.L, st.t
    B = state.pm.shape[0]
    c = Ctx(B, L, S)
    c.alpha[:, :L * S] = descend_g(st, state.llr, t, False, L, spec.one_a, spec.one_b, onehot)
    c.pm = state.pm.clone()
    chunk_body(c, spec.program.ops, spec.program.has_r)
    root = torch.zeros((B, N), dtype=torch.int64)
    root[:, N - S:] = c.beta
    for lev in range(t, 0, -1):
        size = N >> lev
        eff = torch.gather(st.PB[:, lev - 1].to(torch.int64), 1, c.R)
        left = st.Bt[:, st.b_off(lev):st.b_off(lev) + size]
        root[:, N - 2 * size:N - size] = perm_word(left, eff, L) ^ root[:, N - size:]
    return root_out(root, N, L), c.pm


def _brev(x, n):
    return int(f"{x:0{n}b}"[::-1], 2) if n else 0


def root_out(root, N, L, banks=None):
    """``root_out`` of ``csrc/scl_kernels.cuh`` lane by lane on ``root [B, N]``
    (storage-order words): the stages on index bits 0-4 on word 32 j + lane
    by xor-shuffles, the higher ones two at a time on four words a lane, then
    runs of 16 natural positions (run k = lane · R + j) read from their
    bit-reversed words and each path's bits packed from the byte-permuted
    words into one 16-byte store; ``u [B, L, N]`` int8.  ``banks``: a list
    that collects, per shared-memory instruction of the lanes that access
    distinct words, their banks."""
    B, n = root.shape[0], int(np.log2(N))
    root = root.clone()
    lane = np.arange(32)
    for j in range(0, N, 32):
        on = j + lane < N
        w = torch.zeros((B, 32), dtype=torch.int64)
        w[:, on] = root[:, j + lane[on]]
        for k in range(min(5, n)):
            low = torch.as_tensor(((lane >> k) & 1) == 0)
            w = torch.where(low, w ^ w[:, lane ^ (1 << k)], w)
        root[:, j + lane[on]] = w[:, on]
    for k in range(5, n, 2):
        s = 1 << k
        if k + 1 < n:
            for q0 in range(0, N // 4, 32):
                q = q0 + lane[q0 + lane < N // 4]
                p = ((q >> k) << (k + 2)) | (q & (s - 1))
                if banks is not None:
                    banks.extend((p + t * s) % 32 for t in range(4))
                a, b, x, y = (root[:, p + t * s].clone() for t in range(4))
                a ^= b
                x ^= y
                root[:, p], root[:, p + s], root[:, p + 2 * s] = a ^ x, b ^ y, x
        else:
            for q0 in range(0, N // 2, 32):
                q = q0 + lane[q0 + lane < N // 2]
                p = ((q >> k) << (k + 1)) | (q & (s - 1))
                if banks is not None:
                    banks.extend((p + t * s) % 32 for t in range(2))
                root[:, p] ^= root[:, p + s]
    u = torch.zeros((B, L * N), dtype=torch.int64)
    if n < 4:
        idx = np.arange(L * N)
        u[:] = (root[:, [_brev(i & (N - 1), n) for i in idx]] >> torch.as_tensor(idx >> n)) & 1
        return u.reshape(B, L, N).to(torch.int8)
    runs, hi = N >> 4, n - 4
    per = max(1, runs // 32)
    lanes = lane[lane < runs]
    for j in range(per):
        k = lanes * per + j
        rk = np.asarray([_brev(int(v), hi) for v in k])
        for b in range(0, L, 8):
            paths = torch.arange(b, min(b + 8, L))
            for q in range(4):  # __byte_perm: byte b / 8 of the run's words 4q .. 4q + 3
                addr = [rk + (_brev(4 * q + t, 4) << hi) for t in range(4)]
                if banks is not None and b == 0:
                    banks.extend(a % 32 for a in addr)
                x = sum(((root[:, addr[t]] >> b) & 0xFF) << (8 * t) for t in range(4))
                word = (x[:, :, None] >> (paths - b)) & 0x01010101  # [B, lanes, paths]
                for t in range(4):  # the 16-byte store of each path, little-endian
                    pos = paths[None, :] * N + torch.as_tensor(16 * k)[:, None] + 4 * q + t
                    u[:, pos] = (word >> (8 * t)) & 0xFF
    return u.reshape(B, L, N).to(torch.int8)


# ---------------------------------------------------------------------------

def _pattern(kind, S, rng):
    if kind == "frozen":
        return np.ones(S, bool)
    if kind == "rep":
        f = np.ones(S, bool)
        f[-1] = False
        return f
    if kind == "dense":
        return np.zeros(S, bool)
    if kind == "mixed":
        return rng.random(S) < 0.5
    fm = frozen_mask_from_positions(
        1024, tfec.construct_polar_code(1024, 512, "bhattacharyya", 2.0)[0])
    return fm[np.asarray(bit_reverse_permutation(1024))].reshape(8, 128)[int(kind)]


def _body_inputs(rng, B, L, S, case):
    if case == "ties":  # small-integer LLRs: many equal candidates
        alpha = rng.integers(-2, 3, (B, L, S)).astype(np.float32)
        pm = -rng.integers(0, 3, (B, L)).astype(np.float32)
    else:
        alpha = (2 * rng.standard_normal((B, L, S))).astype(np.float32)
        pm = -np.abs(rng.standard_normal((B, L))).astype(np.float32)
    if case == "phantoms":
        pm[:, max(1, L // 4):] = -np.inf
    return torch.from_numpy(alpha), torch.from_numpy(pm)


@pytest.mark.parametrize("case", ["random", "phantoms", "ties"])
@pytest.mark.parametrize("kind,S,L", [
    ("frozen", 32, 4), ("rep", 32, 4), ("rep", 128, 2), ("dense", 16, 8), ("dense", 8, 1),
    ("mixed", 64, 8), ("mixed", 32, 2), ("3", 128, 8), ("5", 128, 8), ("7", 128, 4)])
def test_body_program_walk_equals_plain_body(kind, S, L, case):
    rng = np.random.default_rng(zlib.crc32(repr((kind, S, L, case)).encode()))
    program = SCLBodyProgram(_pattern(kind, S, rng), L)
    alpha, pm = _body_inputs(rng, 9, L, S, case)
    b0, p0, r0 = program.plain(alpha, pm)
    b1, p1, r1 = emulate_body(program, alpha, pm)
    assert torch.equal(b0, b1)
    assert torch.equal(p0, p1)
    assert torch.equal(r0, r1)


@pytest.mark.parametrize("case", ["random", "phantoms", "ties"])
@pytest.mark.parametrize("kind,S,L", [
    ("dense", 16, 8), ("dense", 32, 8), ("dense", 64, 8), ("dense", 8, 1), ("dense", 4, 8),
    ("rep", 128, 4), ("rep", 32, 8), ("mixed", 64, 8), ("mixed", 32, 3), ("mixed", 32, 16),
    ("mixed", 16, 1), ("3", 128, 8), ("5", 128, 8), ("6", 128, 4), ("7", 128, 2)])
def test_fast_body_program_walk_equals_plain_body(kind, S, L, case):
    """The fast ops as the kernel walks them: rate-1 nodes up to the whole
    chunk (``dense``), ``K = L − 1`` against ``K = size``, L = 1 (no stage),
    a list of 3 (lane groups of 8, idle lanes); the larger nodes' lanes with
    1, 2, 4 or 8 elements in registers and wider ones (``dense`` 64, ``rep``
    128 at L = 4) read from the plane; the fast ``OP_SUBTREE`` in
    registers (``dense`` 4, the patterns and mixed chunks at L ≤ 16, its
    rate-1 nodes with ``K`` = size, below it at L = 2 and 4, and none at
    L = 1)."""
    rng = np.random.default_rng(zlib.crc32(repr(("fast", kind, S, L, case)).encode()))
    program = SCLBodyProgram(_pattern(kind, S, rng), L, "fast")
    assert program.fast
    alpha, pm = _body_inputs(rng, 9, L, S, case)
    b0, p0, r0 = program.plain(alpha, pm)
    b1, p1, r1 = emulate_body(program, alpha, pm)
    assert torch.equal(b0, b1)
    assert torch.equal(p0, p1)
    assert torch.equal(r0, r1)


def test_fast_body_program_shape_and_flags():
    ops, has_r = build_scl_body_program(np.zeros(64, bool), "fast", 8)
    assert ops.tolist() == [[OP_RATE1_FAST, 0, 64, 0]] and has_r
    ops, has_r = build_scl_body_program(np.zeros(8, bool), "fast", 1)  # L = 1: no prune
    assert ops.tolist() == [[OP_RATE1_FAST, 0, 8, 0]] and not has_r
    f = np.ones(128, bool)
    f[-1] = False  # a repetition node of any width is one op
    ops, has_r = build_scl_body_program(f, "fast", 4)
    assert ops.tolist() == [[OP_REP_FAST, 0, 128, 0]] and has_r
    mixed = np.array([True, True, True, False, False, False, False, False])
    ops, _ = build_scl_body_program(mixed, "fast", 16)
    assert [o[0] & 0xFF for o in ops.tolist()] == [OP_F, OP_REP_FAST, OP_G, OP_RATE1_FAST,
                                                   OP_COMBINE]
    ops, _ = build_scl_body_program(mixed)  # the exact program has no fast op
    assert not {OP_RATE1_FAST, OP_REP_FAST} & {o[0] & 0xFF for o in ops.tolist()}
    assert not any(o[0] & FLAG_FAST for o in build_scl_body_program(mixed, "exact", 2)[0])
    with pytest.raises(ValueError, match="list_size"):
        build_scl_body_program(np.zeros(4, bool), "fast")
    # a node of size 2 .. SUBTREE_MAX whose list x size fits a warp is one fast
    # OP_SUBTREE (FLAG_FAST, its frozen bits in the op word), whatever its kind;
    # has_r follows the fast dispatch (an all-info node prunes only when L > 1)
    sub = OP_SUBTREE | FLAG_FAST
    for flags, L, want, prunes in (
            (np.zeros(4, bool), 8, [[sub, 0, 4, 0]], True),
            (np.zeros(4, bool), 1, [[sub, 0, 4, 0]], False),
            (np.zeros(2, bool), 16, [[sub, 0, 2, 0]], True),
            (np.zeros(4, bool), 16, [[OP_RATE1_FAST, 0, 4, 0]], True),
            (np.array([True, True, True, False]), 8, [[sub | (0b0111 << SUBTREE_SHIFT), 0, 4, 0]],
             True),
            (np.ones(4, bool), 8, [[sub | (0b1111 << SUBTREE_SHIFT), 0, 4, 0]], False),
            (np.array([False, True]), 1, [[sub | (0b10 << SUBTREE_SHIFT), 0, 2, 0]], True),
            (mixed, 2, [[OP_F, 0, 4, 0], [sub | (0b0111 << SUBTREE_SHIFT), 1, 4, 0],
                        [OP_G | FLAG_RL, 0, 4, 0], [sub, 1, 4, 4],
                        [OP_COMBINE | FLAG_RL | FLAG_RR, 0, 4, 0]], True)):
        ops, has_r = build_scl_body_program(flags, "fast", L)
        assert ops.tolist() == want and has_r == prunes, (flags, L)
        assert SCLBodyProgram(flags, L, "fast").ops.tolist() == want


@pytest.mark.parametrize("L,S,B,case", [(8, 64, 128, "normal"), (8, 64, 16, "integer ties"),
                                        (3, 16, 8, "integer ties"), (32, 8, 4, "normal"),
                                        (1, 2, 5, "normal")])
def test_fastnode_select_walk_equals_plain(L, S, B, case):
    """The selection kernel ``fastnode.cu``: the frame's ``[L, S]`` plane,
    ``halving_sum`` of the softplus, ``select_k``, mags re-read at the picked
    positions — against ``fastnode_select`` on a CPU tensor, the plain
    version (the probe's shape first)."""
    rng = np.random.default_rng(L * S + B)
    a = torch.from_numpy((rng.integers(-2, 3, (L, S, B)) if case == "integer ties"
                          else 2 * rng.standard_normal((L, S, B))).astype(np.float32))
    K = max(1, min(L - 1, S))
    mags, idx, pen = fastnode_select(a, K)
    flat = a.permute(2, 0, 1).reshape(B, L * S)
    z, H = halving_sum(flat, L, S, softplus)
    picks = select_k(flat, L, S, K)
    assert idx.dtype == torch.int32 and torch.equal(picks.permute(1, 2, 0).to(torch.int32), idx)
    assert torch.equal(torch.gather(flat.reshape(B, L, S).abs(), 2, picks).permute(1, 2, 0), mags)
    assert torch.equal(z[:, np.arange(L) * H].T[:, None, :], pen)


def test_body_program_shape_and_flags():
    ops, has_r = build_scl_body_program(np.ones(64, bool))
    assert ops.tolist() == [[OP_RATE0, 0, 64, 0]] and not has_r
    ops, has_r = build_scl_body_program(np.array([True, True, True, False]))
    assert ops.tolist() == [[OP_REP, 0, 4, 0]] and has_r
    # a REP wider than 64 splits once through the generic recursion
    f = np.ones(128, bool)
    f[-1] = False
    ops, has_r = build_scl_body_program(f)
    assert [o[0] & 0xFF for o in ops.tolist()] == [OP_F, OP_RATE0, OP_G, OP_REP, OP_COMBINE]
    assert ops[2, 0] == OP_G and ops[4, 0] == OP_COMBINE | FLAG_RR and has_r
    ops, _ = build_scl_body_program(np.array([False, False]))
    assert ops.tolist() == [[OP_F, 0, 1, 0], [OP_LEAF, 1, 1, 0], [OP_G | FLAG_RL, 0, 1, 0],
                            [OP_LEAF, 1, 1, 1], [OP_COMBINE | FLAG_RL | FLAG_RR, 0, 1, 0]]
    # given the list size, a node of size 2 .. SUBTREE_MAX whose list x size fits a
    # warp is one op in registers, its frozen bits in the op word; wider lists keep
    # the per-node ops
    generic = [[OP_F, 0, 1, 0], [OP_LEAF, 1, 1, 0], [OP_G | FLAG_RL, 0, 1, 0],
               [OP_LEAF, 1, 1, 1], [OP_COMBINE | FLAG_RL | FLAG_RR, 0, 1, 0]]
    assert build_scl_body_program(np.array([False, False]), "exact", 32)[0].tolist() == generic
    ops, has_r = build_scl_body_program(np.array([False, False]), "exact", 16)
    assert ops.tolist() == [[OP_SUBTREE, 0, 2, 0]] and has_r
    rep4 = np.array([True, True, True, False])
    ops, has_r = build_scl_body_program(rep4, "exact", 8)
    assert ops.tolist() == [[OP_SUBTREE | (0b0111 << SUBTREE_SHIFT), 0, 4, 0]] and has_r
    assert build_scl_body_program(rep4, "exact", 16)[0].tolist() == [[OP_REP, 0, 4, 0]]
    ops, has_r = build_scl_body_program(np.ones(4, bool), "exact", 8)  # rate-0: no rank vector
    assert ops.tolist() == [[OP_SUBTREE | (0b1111 << SUBTREE_SHIFT), 0, 4, 0]] and not has_r
    f8 = np.array([True, True, False, True, False, False, True, False])
    ops, _ = build_scl_body_program(f8, "exact", 8)
    assert ops.tolist() == [[OP_F, 0, 4, 0], [OP_SUBTREE | (0b1011 << SUBTREE_SHIFT), 1, 4, 0],
                            [OP_G | FLAG_RL, 0, 4, 0],
                            [OP_SUBTREE | (0b0100 << SUBTREE_SHIFT), 1, 4, 4],
                            [OP_COMBINE | FLAG_RL | FLAG_RR, 0, 4, 0]]
    assert SCLBodyProgram(f8, 8).ops.tolist() == ops.tolist()


def _code(N, K):
    return frozen_mask_from_positions(N, tfec.construct_polar_code(N, K, "bhattacharyya", 2.0)[0])


def _assert_state_equal(a: SCLState, b: SCLState, c):
    for name in ("alpha", "beta", "pend_a", "pend_b", "pm"):
        assert torch.equal(getattr(a, name), getattr(b, name)), (name, c)


@pytest.mark.parametrize("N,K,S,L", [(128, 64, 16, 4), (256, 128, 32, 8), (64, 40, 32, 2),
                                     (128, 100, 8, 2)])
def test_step_and_last_walk_equal_plain_on_every_chunk(N, K, S, L):
    """The level stacks after EVERY chunk, not only the decode's end: a stale
    pending shows up chunks later."""
    fm = _code(N, K)
    sched = build_scl_schedule(N, fm, L, S)
    steps, last = make_step_specs(sched)
    rng = np.random.default_rng(N + S + L)
    llr = torch.from_numpy((1.5 + 2 * rng.standard_normal((7, N))).astype(np.float32))
    llr[0] = torch.from_numpy(rng.integers(-2, 3, N).astype(np.float32))  # tie-heavy frame
    rev = torch.as_tensor(np.asarray(bit_reverse_permutation(N)), dtype=torch.int64)
    plain = SCLState(sched, llr[:, rev].contiguous())
    emu = plain.clone()
    for c, spec in enumerate(steps):
        scl_cuda.scl_chunk_step(plain, spec)  # on the CPU: the plain version
        emulate_step(emu, spec)
        _assert_state_equal(plain, emu, c)
    u0, p0 = scl_cuda.scl_last_chunk(plain, last)
    u1, p1 = emulate_last(emu, last)
    assert torch.equal(u0, u1) and torch.equal(p0, p1)
    # and the whole thing is the plain decoder
    u2, p2 = make_scl_decoder_scan(N, fm, L, chunk=S, control_impl="unroll-fused",
                                   live_width=False, device="cpu")(llr)
    assert torch.equal(u0, u2) and torch.equal(p0, p2)


@pytest.mark.parametrize("N", [64, 128, 256, 512, 1024, 2048])
def test_root_out_lanes_equal_the_polar_transform(N):
    """``root_out``'s lane scheme (the low stages by shuffles, the higher ones
    two at a time in shared memory, runs of 16 natural positions packed into
    16-byte stores) equals u = beta · G in natural order at every list size,
    and every shared-memory access of its passes and runs hits as many banks
    as it has lanes (32, or N / 16 runs below N = 512)."""
    rng = np.random.default_rng(N)
    rev = torch.as_tensor(np.asarray(bit_reverse_permutation(N)), dtype=torch.int64)
    for L in range(1, 33):
        root = torch.from_numpy(rng.integers(0, 2 ** 32, (2, N), dtype=np.uint64).astype(np.int64))
        banks = []
        got = root_out(root, N, L, banks)
        bits = ((root[:, None, :] >> torch.arange(L)[None, :, None]) & 1).to(torch.int8)
        assert torch.equal(got, tfec.polar_transform(bits[..., rev]))
        assert banks and all(len(set(b.tolist())) == len(b) in (32, N // 16) for b in banks)


@pytest.mark.parametrize("N,K,S,L,onehot,own_root", [(1024, 512, 128, 8, False, False),
                                                     (1024, 512, 128, 8, True, False),
                                                     (4096, 2048, 64, 32, False, True)])
def test_last_chunk_context_plan(N, K, S, L, onehot, own_root):
    """The last chunk's shared memory per frame: the chunk step's context and,
    one-hot, the staged rank vectors (4,928 / 5,120 B at the flagship: at
    most 7,168, 32 warps per SM); its root plane lies on the context's alpha
    region unless N > L · S."""
    sched = build_scl_schedule(N, _code(N, K), L, S)
    got = scl_cuda.smem_per_frame(L, S, scl_cuda.last_root_words(L, S, N),
                                  sched.t if onehot else 0, depth0=False)
    step = scl_cuda.smem_per_frame(L, S, depth0=False) + (8 * sched.t * L if onehot else 0)
    assert scl_cuda.last_root_words(L, S, N) == (N if own_root else 0)
    assert got == step + (4 * N if own_root else 0)
    if N == 1024:
        assert got == (5120 if onehot else 4928) <= 7168


@pytest.mark.parametrize("N,K,S,L", [(128, 64, 16, 4), (256, 130, 32, 8), (64, 40, 64, 2)])
def test_fast_step_and_last_walk_equal_plain_on_every_chunk(N, K, S, L):
    fm = _code(N, K)
    sched = build_scl_schedule(N, fm, L, S)
    rng = np.random.default_rng(N + S + L)
    llr = torch.from_numpy((1.5 + 2 * rng.standard_normal((7, N))).astype(np.float32))
    llr[0] = torch.from_numpy(rng.integers(-2, 3, N).astype(np.float32))  # tie-heavy frame
    rev = torch.as_tensor(np.asarray(bit_reverse_permutation(N)), dtype=torch.int64)
    want = make_scl_decoder_scan(N, fm, L, chunk=S, node_mode="fast", device="cpu")(llr)
    if sched.C == 1:  # a single chunk: the body on the LLRs, then the butterfly
        program = SCLBodyProgram(sched.unique_flags[0], L, "fast")
        alpha = llr[:, rev][:, None, :].expand(-1, L, -1).contiguous()
        pm = torch.full((7, L), -np.inf)
        pm[:, 0] = 0.0
        beta, p1, _ = emulate_body(program, alpha, pm)
        u1 = tfec.polar_transform(beta[..., rev])
        assert torch.equal(u1, want[0]) and torch.equal(p1, want[1])
        return
    steps, last = make_step_specs(sched, node_mode="fast")
    assert all(s.program.fast for s in steps) and last.program.fast
    plain = SCLState(sched, llr[:, rev].contiguous())
    emu = plain.clone()
    for c, spec in enumerate(steps):
        scl_cuda.scl_chunk_step(plain, spec)
        emulate_step(emu, spec)
        _assert_state_equal(plain, emu, c)
    u0, p0 = scl_cuda.scl_last_chunk(plain, last)
    u1, p1 = emulate_last(emu, last)
    assert torch.equal(u0, u1) and torch.equal(p0, p1)
    assert torch.equal(u0, want[0]) and torch.equal(p0, want[1])


@pytest.mark.parametrize("N,K,S,L", [(128, 64, 16, 4), (256, 128, 32, 8), (64, 40, 8, 8),
                                     (128, 100, 8, 2), (64, 3, 8, 8)])
def test_narrow_step_walk_equals_plain_live_step_on_every_chunk(N, K, S, L):
    """Live width on the kernel control: every chunk step at its live path
    counts (the early ones narrow), walked as the kernel walks it on the
    full-width state, equals the plain live-width step on the whole state
    after every chunk; the plain step hands back exactly the widths the
    schedule's bookkeeping gives the next step; the full-width last chunk
    then equals the plain live-width decoder (K = 3 < log2 L: the list never
    fills, the missing slots are the phantoms' zero bits and −inf)."""
    fm = _code(N, K)
    sched = build_scl_schedule(N, fm, L, S)
    (prefix, *rest), last = make_step_specs(sched, live=True)
    steps = prefix.steps + rest  # the narrow prefix's steps, then the full-width ones
    assert steps[0].narrow and steps[0].lv_in == 1 and not last.narrow
    rng = np.random.default_rng(N + S + L + 1)
    llr = torch.from_numpy((1.5 + 2 * rng.standard_normal((7, N))).astype(np.float32))
    llr[0] = torch.from_numpy(rng.integers(-2, 3, N).astype(np.float32))  # tie-heavy frame
    rev = torch.as_tensor(np.asarray(bit_reverse_permutation(N)), dtype=torch.int64)
    plain = SCLState(sched, llr[:, rev].contiguous())
    emu = plain.clone()
    for c, spec in enumerate(steps):
        alpha, pend_a, beta, pend_b, pm = spec.plain(plain.llr, *plain.to_plain(spec.widths))
        wa, wb, wpa, wpb, wpm = (steps + [last])[c + 1].widths
        assert [a.shape[1] for a in alpha] == list(wa) and [b.shape[1] for b in beta] == list(wb)
        assert [p.shape[1] for p in pend_a] == list(wpa)
        assert [p.shape[1] for p in pend_b] == list(wpb) and pm.shape[1] == wpm
        plain.load_plain(alpha, pend_a, beta, pend_b, pm)
        emulate_step(emu, spec)
        _assert_state_equal(plain, emu, c)
    assert torch.isinf(plain.pm[:, sched.lv_in[-1]:]).all()  # phantoms never written
    u0, p0 = scl_cuda.scl_last_chunk(plain, last)
    u1, p1 = emulate_last(emu, last)
    assert torch.equal(u0, u1) and torch.equal(p0, p1)
    u2, p2 = make_scl_decoder_scan(N, fm, L, chunk=S, control_impl="unroll-fused",
                                   live_width=True, device="cpu")(llr)
    assert torch.equal(u0, u2) and torch.equal(p0, p2)


def test_step_arguments_cover_every_variant():
    sched = build_scl_schedule(256, _code(256, 128), 4, 32)  # C = 8, t = 3
    steps, last = make_step_specs(sched)
    assert [(s.k, s.inv, s.j) for s in steps] == [
        (3, False, 0), (0, True, 1), (1, True, 0), (0, False, 2),
        (2, False, 0), (0, False, 1), (1, False, 0)]
    assert (last.k, last.j) == (0, 3)
    for c, s in enumerate(steps):
        assert s.mask_a == sum(1 << i for i in sched.comp_a[c])
        assert s.mask_b == sum(1 << i for i in sched.comp_b[c])
        assert s.program.flags.tolist() == sched.chunk_flags[c].tolist()


def test_state_roundtrip_and_packing():
    sched = build_scl_schedule(64, _code(64, 32), 8, 16)
    rng = np.random.default_rng(3)
    st = SCLState(sched, torch.from_numpy(rng.standard_normal((5, 64)).astype(np.float32)))
    st.alpha.copy_(torch.from_numpy(rng.standard_normal(tuple(st.alpha.shape)).astype(np.float32)))
    st.beta.copy_(torch.from_numpy(rng.integers(0, 256, tuple(st.beta.shape)).astype(np.int32)))
    st.pend_a.copy_(torch.from_numpy(rng.integers(0, 8, tuple(st.pend_a.shape)).astype(np.int32)))
    other = st.clone()
    other.load_plain(*st.to_plain())
    _assert_state_equal(st, other, "roundtrip")
    bits = torch.from_numpy(rng.integers(0, 2, (3, 32, 5)).astype(np.int8))  # L = 32: sign bit
    assert torch.equal(unpack_paths(scl_cuda.pack_paths(bits), 32), bits)


def test_cuda_wrappers_refuse_cpu_tensors_and_oversize():
    program = SCLBodyProgram(np.zeros(8, bool), 2)
    with pytest.raises(ValueError, match="CUDA tensor"):
        scl_cuda.scl_chunk_body_cuda(torch.zeros(1, 2, 8), torch.zeros(1, 2), program)
    sched = build_scl_schedule(64, _code(64, 32), 2, 16)
    st = SCLState(sched, torch.zeros(2, 64))
    steps, last = make_step_specs(sched)
    with pytest.raises(ValueError, match="CUDA tensor"):
        scl_cuda.scl_chunk_step_cuda(st, steps[0])
    with pytest.raises(ValueError, match="CUDA tensor"):
        scl_cuda.scl_last_chunk_cuda(st, last)
    with pytest.raises(ValueError, match="shared memory"):
        scl_cuda._warps_per_block(scl_cuda.smem_per_frame(32, 4096), "a chunk")
    with pytest.raises(ValueError, match="list sizes"):
        SCLBodyProgram(np.zeros(8, bool), 64)


@pytest.mark.cuda
def test_kernels_equal_plain_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode); run chip_smoke.py "
                    "on the card")
    N, K, S, L = 256, 128, 32, 8
    fm = _code(N, K)
    llr = torch.from_numpy((1.5 + 2 * np.random.default_rng(0).standard_normal((333, N))).astype(
        np.float32)).cuda()
    want = make_scl_decoder_scan(N, fm, L, chunk=S, control_impl="unroll-fused",
                                 live_width=False, device="cuda")(llr)
    for kw in (dict(control_impl="unroll-kernel"),
               dict(control_impl="unroll-fused", body_impl="cuda")):
        got = make_scl_decoder_scan(N, fm, L, chunk=S, device="cuda", **kw)(llr)
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


@pytest.mark.cuda
def test_fast_kernels_equal_plain_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode); run chip_smoke.py "
                    "on the card")
    N, K, S, L = 256, 130, 32, 8
    fm = _code(N, K)
    g = np.random.default_rng(1)
    llr = torch.from_numpy((1.5 + 2 * g.standard_normal((333, N))).astype(np.float32)).cuda()
    want = make_scl_decoder_scan(N, fm, L, chunk=S, control_impl="unroll-fused",
                                 node_mode="fast", device="cuda")(llr)
    for kw in (dict(control_impl="unroll-kernel"),
               dict(control_impl="unroll-fused", body_impl="cuda")):
        got = make_scl_decoder_scan(N, fm, L, chunk=S, node_mode="fast", device="cuda", **kw)(llr)
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    a = torch.from_numpy(g.integers(-3, 4, (8, 64, 128)).astype(np.float32)).cuda()
    for x, y in zip(fastnode_select(a, 7), fastnode_select_plain(a.cpu(), 7)):
        assert torch.equal(x.cpu(), y)


# ---------------------------------------------------------------------------
# one-hot permutations (perm_impl="onehot"): the kernels stage each plane's
# rank vector, run the rank walk with the one-hot apply's zero rule in the
# descend's g, and store the planes of the levels they wrote

def onehot_ranks(planes):
    """Each row's column of its 1, as the kernel scans a row (the last
    nonzero entry)."""
    idx = torch.arange(planes.shape[-1])
    return torch.where(planes != 0, idx, 0).amax(dim=-1).to(torch.int32)


def onehot_planes(ranks, L, dtype):
    return (ranks[..., None].to(torch.int64) == torch.arange(L)).to(dtype)


def read_levels(spec, t):
    """``read_levels`` of ``csrc/scl_kernels.cuh``: the level bits of pend_a
    and pend_b that a full-width chunk step reads before it writes them.
    pend_a: the parent's level lo − 1 when the g reads through it, and the
    composed levels that the descend did not reset (it resets lo .. t);
    pend_b: the g's level lo, the composed levels, and the ascend's j levels
    t − j + 1 .. t.  Chunk 0 (k = t) reads no pending in its descend."""
    full = (1 << t) - 1
    ascend = full & ~((1 << (t - spec.j)) - 1)
    if spec.k == t:
        return 0, spec.mask_b | ascend
    lo = t - spec.k
    reset = full & ~((1 << (lo - 1)) - 1)
    ra = (1 << (lo - 2) if lo > 1 and not spec.inv else 0) | (spec.mask_a & ~reset)
    return ra, (1 << (lo - 1)) | spec.mask_b | ascend


def written_levels(spec, t):
    """``written_levels``: pend_a at the descend's resets and the composes,
    pend_b at the composes and the parked level t − j."""
    lo = 1 if spec.k == t else t - spec.k
    return ((1 << t) - 1) & ~((1 << (lo - 1)) - 1) | spec.mask_a, spec.mask_b | 1 << (t - spec.j - 1)


def _levels_of(m):
    """The set bits of m, lowest first, as the lanes find them (the which-th
    set bit: clear the lowest bit which times)."""
    return [i for i in range(32) if (m >> i) & 1]


def onehot_load_lanes(planes, m, L, ranks):
    """``onehot_load`` lane by lane: ``planes [B, 2t, L·L]`` (pend_a's levels,
    then pend_b's), the levels of bit mask m staged into ``ranks [B, 2t, L]``
    (the others untouched).  Piece idx of the warp's walk is the which-th set
    level's piece ``p`` of four floats (row ``4p >> lg L``, columns ``4p &
    (L − 1)`` on: consecutive lanes, consecutive 16 bytes); a lane keeps the
    last nonzero column of its four (or −1), the L / 4 lanes of a row take
    the max by xor-shuffles, and the row's first lane writes it (0 if none:
    the rule of a row scan).  L < 4 or not a power of two: a row scan a lane."""
    B = planes.shape[0]
    levels = _levels_of(m)
    if not _pow2_vectors(L):
        for bit in levels:
            ranks[:, bit] = onehot_ranks(planes[:, bit].reshape(B, L, L))
        return
    P, lgL, G = L * L // 4, L.bit_length() - 1, L // 4
    lgP = P.bit_length() - 1
    total = len(levels) * P
    for base in range(0, total, 32):
        v, where = [], []
        for lane in range(32):
            idx = base + lane
            if idx >= total:
                v.append(torch.full((B,), -1, dtype=torch.int64))
                where.append(None)
                continue
            bit, piece = levels[idx >> lgP], idx & (P - 1)
            row, col0 = (4 * piece) >> lgL, (4 * piece) & (L - 1)
            four = planes[:, bit, 4 * piece:4 * piece + 4]
            last = torch.full((B,), -1, dtype=torch.int64)
            for q in range(4):
                last = torch.where(four[:, q] != 0, col0 + q, last)
            v.append(last)
            where.append((bit, row) if piece & (G - 1) == 0 else None)
        off = 1
        while off < G:
            v = [torch.maximum(v[lane], v[lane ^ off]) for lane in range(32)]
            off *= 2
        for lane in range(32):
            if where[lane] is not None:
                ranks[:, where[lane][0], where[lane][1]] = v[lane].clamp(min=0).to(ranks.dtype)


def onehot_store_lanes(planes, ranks, m, L):
    """``onehot_store`` lane by lane: the levels of bit mask m written into
    ``planes [B, 2t, L·L]`` from ``ranks [B, 2t, L]``, piece p (row and
    columns by shift and mask) as four exact 1.0 / +0.0 in one 16-byte store;
    L < 4 or not a power of two: one float a store."""
    for bit in _levels_of(m):
        r = ranks[:, bit].to(torch.int64)
        if _pow2_vectors(L):
            lgL = L.bit_length() - 1
            for piece in range(L * L // 4):
                row, col0 = (4 * piece) >> lgL, (4 * piece) & (L - 1)
                for q in range(4):
                    planes[:, bit, 4 * piece + q] = (col0 + q == r[:, row]).to(planes.dtype)
        else:
            for idx in range(L * L):
                planes[:, bit, idx] = (idx % L == r[:, idx // L]).to(planes.dtype)


# a staged rank vector the walk did not load: an index no gather can take
_GARBAGE = 1 << 20


def staged_rank_state(state: SCLState, ra: int, rb: int) -> SCLState:
    """A rank state whose pendings are what the kernel stages from the
    one-hot state: the levels of ra / rb by ``onehot_load_lanes``, every
    other one garbage."""
    s, B = state.sched, state.pm.shape[0]
    t, L = s.t, s.L
    planes = torch.cat([state.pend_a, state.pend_b], 1).reshape(B, 2 * t, L * L)
    ranks = torch.full((B, 2 * t, L), _GARBAGE, dtype=torch.int32)
    onehot_load_lanes(planes, ra | rb << t, L, ranks)
    out = state.clone()
    out.onehot = False
    out.pend_a, out.pend_b = ranks[:, :t].clone(), ranks[:, t:].clone()
    return out


def emulate_step_onehot(state: SCLState, spec):
    """The one-hot chunk step as the kernel walks it, on a one-hot state: the
    levels of ``read_levels`` staged, the rank walk with the one-hot zero
    rule, the levels of ``written_levels`` stored."""
    s, B = state.sched, state.pm.shape[0]
    t, L = s.t, s.L
    work = staged_rank_state(state, *read_levels(spec, t))
    emulate_step(work, spec, onehot=True)
    state.alpha, state.beta, state.pm = work.alpha, work.beta, work.pm
    la, lb = written_levels(spec, t)
    planes = torch.cat([state.pend_a, state.pend_b], 1).reshape(B, 2 * t, L * L).clone()
    onehot_store_lanes(planes, torch.cat([work.pend_a, work.pend_b], 1), la | lb << t, L)
    state.pend_a = planes[:, :t].reshape(B, t, L, L).contiguous()
    state.pend_b = planes[:, t:].reshape(B, t, L, L).contiguous()


def last_read_levels(t):
    """The levels the one-hot last chunk stages: pend_a of the parent of its
    g (level t − 1), every pend_b (its ascend to the root)."""
    return (1 << (t - 2) if t > 1 else 0), (1 << t) - 1


def emulate_last_onehot(state: SCLState, spec):
    return emulate_last(staged_rank_state(state, *last_read_levels(state.sched.t)), spec,
                        onehot=True)


def _assert_bits_equal(a: SCLState, b: SCLState, c):
    for name in ("alpha", "beta", "pend_a", "pend_b", "pm"):
        x, y = getattr(a, name), getattr(b, name)
        if x.is_floating_point():
            x, y = x.view(torch.int32), y.view(torch.int32)
        assert torch.equal(x, y), (name, c)


@pytest.mark.parametrize("N,K,S,L,union", [(128, 64, 16, 4, False), (256, 128, 32, 8, True),
                                           (64, 40, 8, 8, False), (128, 100, 8, 2, True)])
def test_onehot_step_and_last_walk_equal_plain_by_bit_pattern(N, K, S, L, union):
    """The one-hot modes of K3 / K4 walked on a one-hot state against the plain
    one-hot step after EVERY chunk, by bit pattern (the sign of a zero counts:
    integer LLRs make exact zeros, and the one-hot apply's +0.0 then differs
    from the rank gather's −0.0 in the stacks); K5's one-hot plane; the whole
    decode equals the rank decoder."""
    fm = _code(N, K)
    sched = build_scl_schedule(N, fm, L, S)
    steps, last = make_step_specs(
        sched, [SCLBodyProgram(f, L, perm_impl="onehot") for f in sched.unique_flags], union=union)
    rank_steps, _ = make_step_specs(sched, union=union)
    assert last.program.onehot and all(s.program.onehot for s in steps)
    rng = np.random.default_rng(N + S + L + 2)
    llr = torch.from_numpy(rng.integers(-3, 4, (9, N)).astype(np.float32))
    llr[:4] = torch.from_numpy((1.5 + 2 * rng.standard_normal((4, N))).astype(np.float32))
    rev = torch.as_tensor(np.asarray(bit_reverse_permutation(N)), dtype=torch.int64)
    plain = SCLState(sched, llr[:, rev].contiguous(), "onehot")
    rank = SCLState(sched, llr[:, rev].contiguous())
    emu = plain.clone()
    zero_signs = 0
    for c, spec in enumerate(steps):
        program = spec.program
        body_in = plain.to_plain()[0][sched.t - 1].contiguous()
        beta, pm, R = emulate_body(program, body_in, plain.pm.clone())
        want = program.plain(body_in, plain.pm.clone())
        assert torch.equal(r_plane_lanes(R, L).view(torch.int32), want[2].view(torch.int32)), c
        assert torch.equal(beta, want[0]) and torch.equal(pm, want[1])
        scl_cuda.scl_chunk_step(plain, spec)  # on the CPU: the plain one-hot step
        scl_cuda.scl_chunk_step(rank, rank_steps[c])
        emulate_step_onehot(emu, spec)
        _assert_bits_equal(plain, emu, c)
        assert torch.equal(plain.alpha, rank.alpha)
        zero_signs += int((plain.alpha.view(torch.int32) != rank.alpha.view(torch.int32)).sum())
    if N == 256:  # the zero rule is exercised, not vacuous
        assert zero_signs > 0
    u0, p0 = scl_cuda.scl_last_chunk(plain, last)
    u1, p1 = emulate_last_onehot(emu, last)
    assert torch.equal(u0, u1) and torch.equal(p0, p1)
    u2, p2 = make_scl_decoder_scan(N, fm, L, chunk=S, control_impl="unroll-fused",
                                   live_width=False, device="cpu")(llr)
    assert torch.equal(u0, u2) and torch.equal(p0, p2)


def _nan_unread(state: SCLState, ra: int, rb: int) -> SCLState:
    """A copy of a one-hot state with NaN in every plane outside ra / rb."""
    out = state.clone()
    for i in range(state.sched.t):
        if not (ra >> i) & 1:
            out.pend_a[:, i] = float("nan")
        if not (rb >> i) & 1:
            out.pend_b[:, i] = float("nan")
    return out


@pytest.mark.parametrize("N,K,S,L,union", [(128, 64, 16, 4, False), (256, 128, 32, 8, True),
                                           (64, 40, 8, 8, False), (256, 128, 8, 4, True)])
def test_onehot_step_and_last_stage_only_the_levels_they_read(N, K, S, L, union):
    """K3-onehot and K4-onehot stage only ``read_levels``: with NaN in every
    plane the step does not read, the walk equals the plain one-hot step on
    every chunk by bit pattern, the planes it writes equal the plain step's,
    and those it neither reads nor writes stay as they were; the last chunk
    with NaN outside its levels equals the plain last chunk."""
    sched = build_scl_schedule(N, _code(N, K), L, S)
    t = sched.t
    steps, last = make_step_specs(
        sched, [SCLBodyProgram(f, L, perm_impl="onehot") for f in sched.unique_flags], union=union)
    rng = np.random.default_rng(N + S + L + 3)
    llr = torch.from_numpy(rng.integers(-3, 4, (6, N)).astype(np.float32))
    llr[:3] = torch.from_numpy((1.5 + 2 * rng.standard_normal((3, N))).astype(np.float32))
    rev = torch.as_tensor(np.asarray(bit_reverse_permutation(N)), dtype=torch.int64)
    plain = SCLState(sched, llr[:, rev].contiguous(), "onehot")
    staged = 0
    for c, spec in enumerate(steps):
        ra, rb = read_levels(spec, t)
        la, lb = written_levels(spec, t)
        staged += bin(ra).count("1") + bin(rb).count("1")
        emu = _nan_unread(plain, ra, rb)
        before = emu.clone()
        scl_cuda.scl_chunk_step(plain, spec)  # on the CPU: the plain one-hot step
        emulate_step_onehot(emu, spec)
        for name in ("alpha", "beta", "pm"):
            x, y = getattr(emu, name), getattr(plain, name)
            assert torch.equal(x.view(torch.int32), y.view(torch.int32)), (name, c)
        for name, written in (("pend_a", la), ("pend_b", lb)):
            for i in range(t):
                want = getattr(plain if (written >> i) & 1 else before, name)[:, i]
                got = getattr(emu, name)[:, i]
                assert torch.equal(got.view(torch.int32), want.view(torch.int32)), (name, i, c)
    assert staged < 2 * t * len(steps)  # fewer levels than the whole state
    u0, p0 = scl_cuda.scl_last_chunk(plain, last)
    u1, p1 = emulate_last_onehot(_nan_unread(plain, *last_read_levels(t)), last)
    assert torch.equal(u0, u1) and torch.equal(p0, p1)


@pytest.mark.parametrize("L", [1, 2, 4, 8, 16, 32])
def test_onehot_vector_load_and_store_lanes(L):
    """``onehot_load`` / ``onehot_store`` lane by lane (16-byte pieces, the
    row's lanes combined by xor-shuffles, row and column by shift and mask)
    against the row scan (``onehot_ranks``) and the plane (``onehot_planes``)
    on three levels of each pending, two of them selected; rows with no 1 and
    with stray nonzeros take the row scan's rule (the last nonzero, else 0)."""
    t, B = 3, 4
    g = np.random.default_rng(L)
    ranks = torch.from_numpy(g.integers(0, L, (B, 2 * t, L)).astype(np.int32))
    planes = onehot_planes(ranks, L, torch.float32).reshape(B, 2 * t, L * L)
    odd = planes.clone().reshape(B, 2 * t, L, L)
    odd[0, 1, 0] = 0.0                      # a row with no 1
    odd[1, 1, -1, 0] = -0.0                 # a stray -0.0 counts as zero
    odd[2, 1, 0, L // 2] = float("nan")     # a stray NaN counts as nonzero
    odd = odd.reshape(B, 2 * t, L * L)
    m = 0b100110  # pend_a levels 1, 2; pend_b level 2
    for src in (planes, odd):
        got = torch.full_like(ranks, _GARBAGE)
        onehot_load_lanes(src, m, L, got)
        want = onehot_ranks(src.reshape(B, 2 * t, L, L))
        for bit in range(2 * t):
            assert torch.equal(got[:, bit], want[:, bit] if (m >> bit) & 1
                               else torch.full_like(got[:, bit], _GARBAGE)), (bit, L)
    out = torch.full_like(planes, float("nan"))
    onehot_store_lanes(out, ranks, m, L)
    for bit in range(2 * t):
        want = planes[:, bit] if (m >> bit) & 1 else torch.full_like(planes[:, bit], float("nan"))
        assert torch.equal(out[:, bit].view(torch.int32), want.view(torch.int32)), (bit, L)


@pytest.mark.parametrize("kind,S,L", [("frozen", 32, 4), ("rep", 32, 4), ("mixed", 64, 8),
                                      ("3", 128, 8), ("mixed", 16, 32), ("mixed", 8, 4),
                                      ("mixed", 32, 3)])
def test_body_walk_on_its_input_plane_and_vector_outputs(kind, S, L):
    """K5 on its input plane where it lies: the input unchanged afterwards,
    and a chunk that is one rate-0 or REP node (which works in place) on a
    copy, without which its input would change; β by 16-byte stores (S < 16:
    by bytes) and the one-hot R plane by 16-byte stores (L not a power of
    two: by floats) equal the plain rank and one-hot bodies."""
    rng = np.random.default_rng(zlib.crc32(repr((kind, S, L)).encode()))
    flags = _pattern(kind, S, rng)
    program = SCLBodyProgram(flags, L)
    alpha, pm = _body_inputs(rng, 5, L, S, "ties" if L == 8 else "random")
    keep = alpha.clone()
    beta, pm1, R = emulate_body(program, alpha, pm)
    assert torch.equal(alpha.view(torch.int32), keep.view(torch.int32))
    assert works_in_place(program.ops) == (kind in ("frozen", "rep"))
    if works_in_place(program.ops):
        c = Ctx(5, L, S)
        c.top, c.pm = alpha.clone().reshape(5, L * S), pm.clone()
        chunk_body(c, program.ops, program.has_r)
        assert not torch.equal(c.top, keep.reshape(5, L * S))
    b0, p0, r0 = program.plain(alpha, pm)
    assert torch.equal(beta, b0) and torch.equal(pm1, p0) and torch.equal(R, r0)
    b2, p2, plane = SCLBodyProgram(flags, L, perm_impl="onehot").plain(alpha, pm)
    assert torch.equal(b2, b0) and torch.equal(p2, p0)
    assert torch.equal(r_plane_lanes(R, L).view(torch.int32), plane.view(torch.int32))


class _Planned(Exception):
    pass


def test_body_context_plan(monkeypatch):
    """The body kernel's context is the chunk step's (no top plane: it reads
    its input where it lies): 4,928 B a flagship frame, rank and one-hot (the
    one-hot R plane is written from the lanes' registers, nothing staged),
    so 32 warps per SM fit (at most 7,168 B); the device-memory threshold is
    still the context with its top plane, so no code changes mode."""
    seen = []

    def plan(L, S, root_words, B, device, onehot_levels=0):  # _context_plan's sizes
        seen.append((scl_cuda.smem_per_frame(L, S, root_words, onehot_levels, depth0=False),
                     scl_cuda.context_in_device_memory(L, S, root_words, onehot_levels)))
        raise _Planned

    monkeypatch.setattr(scl_cuda, "_check_cuda_f32", lambda *args: None)
    monkeypatch.setattr(scl_cuda, "_context_plan", plan)
    flags = _pattern("5", 128, None)
    for L, S, perm in ((8, 128, "rank"), (8, 128, "onehot"), (32, 1024, "rank"), (32, 512, "rank")):
        program = SCLBodyProgram(flags if S == 128 else np.zeros(S, bool), L, perm_impl=perm)
        with pytest.raises(_Planned):
            scl_cuda.launch_chunk_body(torch.zeros(2, L, S), torch.zeros(2, L), program,
                                       "scl_body")
    assert seen[0] == seen[1] == (4928, False) and 4928 <= 7168
    # the modes of the top-plane context: S=1024, L=32 in device memory (its
    # 136,832 B without the top plane would fit one block, at one warp an SM)
    assert seen[2] == (scl_cuda.smem_per_frame(32, 1024, depth0=False), True)
    assert seen[3] == (scl_cuda.smem_per_frame(32, 512, depth0=False), False)
    assert seen[2][0] < scl_cuda.SMEM_LIMIT_BYTES < scl_cuda.smem_per_frame(32, 1024)


def test_onehot_state_roundtrip_and_union_specs():
    """A one-hot ``SCLState`` through ``to_plain`` / ``load_plain``; the
    united step specs: one spec per (descend, pattern, ascend) variant, its
    masks the union over the variant's positions."""
    sched = build_scl_schedule(256, _code(256, 128), 4, 8)  # C = 32, t = 5: 25 variants
    rng = np.random.default_rng(4)
    st = SCLState(sched, torch.from_numpy(rng.standard_normal((5, 256)).astype(np.float32)),
                  "onehot")
    assert st.pend_a.shape == (5, 5, 4, 4) and st.pend_a.dtype == torch.float32
    st.alpha.copy_(torch.from_numpy(rng.standard_normal(tuple(st.alpha.shape)).astype(np.float32)))
    st.pend_a.copy_(onehot_planes(torch.from_numpy(rng.integers(0, 4, (5, 5, 4))), 4,
                                  torch.float32))
    ops = st.to_plain()
    assert all(p.shape == (5, 4, 4) for p in ops[1] + ops[3])
    other = SCLState(sched, st.llr, "onehot")
    other.load_plain(*ops)
    _assert_bits_equal(st, other, "roundtrip")
    exact, _ = make_step_specs(sched)
    united, _ = make_step_specs(sched, union=True)
    by_key = {}
    for c, (e, u) in enumerate(zip(exact, united)):
        key = (int(sched.desc_k[c]), int(sched.pattern_ids[c]), int(sched.asc_j[c]))
        assert by_key.setdefault(key, u) is u  # one spec per variant
        assert e.mask_a & ~u.mask_a == 0 and e.mask_b & ~u.mask_b == 0
    for key, u in by_key.items():
        pos = [c for c in range(sched.C - 1) if (int(sched.desc_k[c]), int(sched.pattern_ids[c]),
                                                 int(sched.asc_j[c])) == key]
        assert u.mask_a == np.bitwise_or.reduce([exact[c].mask_a for c in pos])
        assert u.mask_b == np.bitwise_or.reduce([exact[c].mask_b for c in pos])
    assert len(by_key) < sched.C - 1  # some variants repeat at this code
    with pytest.raises(ValueError, match="live width"):
        make_step_specs(sched, live=True, union=True)
    with pytest.raises(ValueError, match="fast"):
        SCLBodyProgram(np.zeros(8, bool), 4, "fast", "onehot")


@pytest.mark.parametrize("L", range(1, 33))
def test_register_prune_rank_rule_equals_plain_prune(L):
    """The register prune's walk (``prune_lanes``) against the plain prune
    (``scanscl._prune_rank``) at list L and every live width w <= L (keeping
    min(2w, L)): ties (small integers), equal metrics across a row, +0.0
    against -0.0 (equal under the rule: the lower index wins), -inf phantom
    rows, and Gaussian metrics."""
    rng = np.random.default_rng(L)
    for w in range(1, L + 1):
        keep = min(2 * w, L)
        rows = [rng.integers(-2, 3, (6, 2 * w)).astype(np.float32),
                np.full((2, 2 * w), 1.5, np.float32),
                rng.choice(np.array([0.0, -0.0, 1.0], np.float32), (4, 2 * w)),
                (rng.standard_normal((4, 2 * w))).astype(np.float32)]
        phantom = rng.standard_normal((4, 2 * w)).astype(np.float32)
        live = max(1, w // 2)  # paths >= live are -inf phantoms in both halves
        phantom[:, live:w] = -np.inf
        phantom[:, w + live:] = -np.inf
        cand = torch.from_numpy(np.concatenate(rows + [phantom]))
        second, pm, r = tscan._prune_rank(cand, keep)
        src, word = prune_lanes(cand, w, keep)
        assert torch.equal(src >= w, second), (L, w)
        assert torch.equal(torch.where(src < w, src, src - w), r), (L, w)
        assert torch.equal(torch.gather(cand, 1, src).view(torch.int32), pm.view(torch.int32))
        assert torch.equal(word, (second.long() << torch.arange(keep)).sum(dim=1))


# ---------------------------------------------------------------------------
# K8: the row roll of an int8 tile (tools/r4_tpu_queue7.sh:14)

def test_sublane_roll_plain_equals_np_roll_on_the_probe_tile():
    """The plain version of the roll kernel on the probe's seeded [32, 128]
    0/1 int8 tile and shift 30, as the probe checks its kernel, and on other
    shapes and shifts; a CPU tensor never reaches the kernel."""
    from polarcode_and_ldpc_tpu_torch import ops
    from polarcode_and_ldpc_tpu_torch.ops.roll_cuda import (PROBE_SHAPE, PROBE_SHIFT,
                                                            sublane_roll, sublane_roll_cuda)
    x = np.random.default_rng(0).integers(0, 2, PROBE_SHAPE).astype(np.int8)
    before = ops.launch_counts()["sublane_roll"]
    assert np.array_equal(sublane_roll(torch.from_numpy(x), PROBE_SHIFT).numpy(),
                          np.roll(x, PROBE_SHIFT, 0))
    for shape, shift in (((7, 40), 3), ((24, 64), -53), ((32, 128), 64)):
        y = np.random.default_rng(shape[0]).integers(-128, 128, shape).astype(np.int8)
        assert np.array_equal(sublane_roll(torch.from_numpy(y), shift).numpy(),
                              np.roll(y, shift, 0))
    assert ops.launch_counts()["sublane_roll"] == before
    with pytest.raises(ValueError, match="CUDA tensor"):
        sublane_roll_cuda(torch.from_numpy(x), PROBE_SHIFT)


# ---------------------------------------------------------------------------
# K3-live: the narrow prefix of a live decode in one launch (scl_narrow_prefix)

# the flagship (CA-SCL-8), the reference's large code (N=4096 SCL-32, chunk
# 64), two small codes, and a code whose prefix is longer than one launch's
# table (124 narrow positions)
PREFIX_CODES = [(1024, 512, 128, 8), (4096, 2048, 64, 32), (128, 64, 16, 4), (256, 100, 32, 8),
                (1024, 128, 4, 16)]


@pytest.mark.parametrize("N,K,S,L", PREFIX_CODES)
def test_narrow_prefix_table_equals_the_per_position_specs(N, K, S, L):
    """``make_step_specs(live=True)`` puts the narrow positions first, as one
    ``SCLPrefixSpec``: its step table, row by row, is the per-position narrow
    specs (``StepArgs`` order; each row's node program at its offset of the
    programs back to back); the prefix holds exactly the positions entering
    below L, and the full-width steps follow from the first full-width
    position on; a longer prefix runs as launches of at most
    ``PREFIX_PARAM_ROWS`` rows; a narrow step alone is refused by the
    chunk-step launch, and a prefix of a fast or one-hot program, of a
    full-width step or of none by the spec."""
    sched = build_scl_schedule(N, _code(N, K), L, S)
    (prefix, *rest), last = make_step_specs(sched, live=True)
    full, _ = make_step_specs(sched)
    P = len(prefix.steps)
    assert isinstance(prefix, scl_cuda.SCLPrefixSpec) and P == len(full) - len(rest)
    assert P == sum(w < L for w in sched.lv_in[:-1]) and all(s.narrow for s in prefix.steps)
    assert not any(isinstance(s, scl_cuda.SCLPrefixSpec) or s.narrow for s in rest)
    assert not last.narrow
    assert prefix.rows.dtype == np.int32 and prefix.rows.flags.c_contiguous
    assert prefix.rows.shape == (P, len(scl_cuda.PREFIX_TABLE_COLUMNS))
    for row, spec, wide in zip(prefix.rows.tolist(), prefix.steps, full):
        k, inv, j, ma, mb, off, n_ops, has_r, lvi, lvo, oa, ob = row
        assert (k, inv, j, ma, mb, lvi, lvo, oa, ob) == (
            spec.k, int(spec.inv), spec.j, spec.mask_a, spec.mask_b, spec.lv_in, spec.lv_out,
            spec.one_a, spec.one_b)
        assert (k, inv, j) == (wide.k, int(wide.inv), wide.j)
        assert np.array_equal(prefix.prog[off:off + n_ops], spec.program.ops)
        assert has_r == int(spec.program.has_r) and lvi < L
    assert len(range(0, P, scl_cuda.PREFIX_PARAM_ROWS)) == (2 if P > 64 else 1)
    st = SCLState(sched, torch.zeros(2, N))
    with pytest.raises(ValueError, match="narrow"):
        scl_cuda.scl_chunk_step_cuda(st, prefix.steps[0])
    with pytest.raises(ValueError, match="CUDA tensor"):
        scl_cuda.scl_narrow_prefix_cuda(st, prefix)
    with pytest.raises(ValueError, match="narrow"):
        scl_cuda.SCLPrefixSpec(prefix.steps[:1] + full[-1:])
    with pytest.raises(ValueError, match="narrow"):
        scl_cuda.SCLPrefixSpec([])
    fast = SCLBodyProgram(sched.unique_flags[0], L, "fast")
    with pytest.raises(ValueError, match="exact"):
        scl_cuda.SCLPrefixSpec([dataclasses.replace(prefix.steps[0], program=fast)])
    assert not any(isinstance(s, scl_cuda.SCLPrefixSpec) for s in full)


def emulate_prefix(state: SCLState, prefix):
    """The prefix kernel's walk: the rows of its step table in order on one
    state, each a narrow chunk step whose node program is read at its
    offset of the programs back to back."""
    for row in prefix.rows.tolist():
        k, inv, j, ma, mb, off, n_ops, has_r, lvi, lvo, oa, ob = row
        program = SimpleNamespace(ops=prefix.prog[off:off + n_ops], has_r=bool(has_r))
        emulate_step(state, SimpleNamespace(k=k, inv=bool(inv), j=j, mask_a=ma, mask_b=mb,
                                            lv_in=lvi, lv_out=lvo, one_a=oa, one_b=ob,
                                            program=program))


@pytest.mark.parametrize("N,K,S,L", [(128, 64, 16, 4), (256, 100, 32, 8), (64, 3, 8, 8),
                                     (512, 64, 4, 8)])
def test_narrow_prefix_walk_equals_plain_narrow_steps(N, K, S, L):
    """The prefix walked from its table on one state, as the kernel walks
    it, equals the plain narrow steps in order (``scl_narrow_prefix`` on a
    CPU state) bit for bit on the whole state; then the full-width steps
    and the last chunk from there equal the plain live-width decoder."""
    fm = _code(N, K)
    sched = build_scl_schedule(N, fm, L, S)
    (prefix, *rest), last = make_step_specs(sched, live=True)
    rng = np.random.default_rng(N + K + L)
    llr = torch.from_numpy((1.5 + 2 * rng.standard_normal((6, N))).astype(np.float32))
    llr[0] = torch.from_numpy(rng.integers(-2, 3, N).astype(np.float32))  # tie-heavy frame
    rev = torch.as_tensor(np.asarray(bit_reverse_permutation(N)), dtype=torch.int64)
    plain = SCLState(sched, llr[:, rev].contiguous())
    emu = plain.clone()
    scl_cuda.scl_narrow_prefix(plain, prefix)
    emulate_prefix(emu, prefix)
    _assert_state_equal(plain, emu, "prefix")
    for spec in rest:
        scl_cuda.scl_chunk_step(plain, spec)
    u0, p0 = scl_cuda.scl_last_chunk(plain, last)
    u1, p1 = make_scl_decoder_scan(N, fm, L, chunk=S, control_impl="unroll-fused",
                                   live_width=True, device="cpu")(llr)
    assert torch.equal(u0, u1) and torch.equal(p0, p1)


# ---------------------------------------------------------------------------
# K7: the streaming selection (fastnode.cu, fastnode_stream_kernel)

def fastnode_stream_walk(a, K):
    """The streaming kernel on ``a [L, S, B]``: per (path, frame) two lanes
    (one when S < 32 or the list is 32 long), each on its half of the
    positions in bit-reversed order, in runs of 16 (of 1 when S < 16); each
    value's 64-bit key (``|a|``'s bits above its position) inserted into the
    lane's sorted list of ``kMaxK`` keys (7, 15 or 32: the first that holds
    K) by the compare-exchange pass; each run's softplus summed pairwise, its
    sum pushed into the lane's counter of levels; then the second lane's
    first K keys inserted into the first lane's list and the two halves' sums
    added (the halving tree's additions); returns ``(mags, idx, penalty)``
    as the kernel writes them."""
    L, S, B = a.shape
    kmax, run = next(n for n in (7, 15, 32) if K <= n), (16 if S >= 16 else 1)
    lanes = 2 if S >= 32 and kmax <= 15 else 1
    lgS = S.bit_length() - 1
    vals = a.permute(0, 2, 1).reshape(L * B, S)

    def insert(keys, key):  # the compare-exchange pass, from the top of the list
        key = key[:, None]
        below = torch.cat([torch.full((L * B, 1), -1, dtype=torch.int64), keys[:, :-1]], 1)
        return torch.where(key < below, below, torch.minimum(key, keys))

    lists, sums = [], []
    runs = S // run // lanes
    for half in range(lanes):
        keys = torch.full((L * B, kmax), 2 ** 63 - 1, dtype=torch.int64)  # above every key
        level, carry = [None] * 13, None
        for r in range(runs):
            pos = [int(format((half * runs + r) * run + u, f"0{lgS}b")[::-1], 2) if lgS else 0
                   for u in range(run)]
            x = vals[:, pos]
            for u in range(run):
                keys = insert(keys, ((x[:, u].abs().view(torch.int32).to(torch.int64)
                                      & 0xFFFFFFFF) << 32) | pos[u])
            x = torch.log1p(torch.exp(-x.abs()))
            while x.shape[1] > 1:  # the run's subtree, pairwise
                x = x[:, 0::2] + x[:, 1::2]
            carry = x[:, 0]
            merges = (~r & (r + 1)).bit_length() - 1  # the trailing ones of r
            for k in range(merges):
                carry = level[k] + carry
            level[merges] = carry
        lists.append(keys)
        sums.append(carry)
    keys, total = lists[0], sums[0]
    if lanes == 2:
        for k in range(K):
            keys = insert(keys, lists[1][:, k])
        total = total + sums[1]
    mags = (keys[:, :K] >> 32).to(torch.int32).view(torch.float32)
    idx = (keys[:, :K] & 0xFFFFFFFF).to(torch.int32)
    return (mags.reshape(L, B, K).permute(0, 2, 1), idx.reshape(L, B, K).permute(0, 2, 1),
            total.reshape(L, 1, B))


@pytest.mark.parametrize("L", [1, 8, 32])
@pytest.mark.parametrize("S", [1, 2, 64, 128])
@pytest.mark.parametrize("case", ["normal", "integer ties"])
def test_fastnode_stream_walk_equals_plain(L, S, case):
    """K7's walk (``fastnode_stream_walk``) against ``fastnode_select_plain``
    by bit pattern at K = 1, L − 1 and S (ties to the lower position, in any
    order of visit); a K above ``STREAM_MAX_K`` (the register list) is
    refused."""
    from polarcode_and_ldpc_tpu_torch.ops.fastnode_cuda import STREAM_MAX_K, fastnode_select_cuda
    B = 5
    rng = np.random.default_rng(L * S + len(case))
    a = torch.from_numpy((rng.integers(-2, 3, (L, S, B)) if case == "integer ties"
                          else 2 * rng.standard_normal((L, S, B))).astype(np.float32))
    for K in sorted({1, min(max(L - 1, 1), S), S}):
        if K > STREAM_MAX_K:
            with pytest.raises(ValueError, match="STREAM_MAX_K"):
                fastnode_select_cuda(a, K)
            continue
        want = fastnode_select_plain(a, K)
        got = fastnode_stream_walk(a, K)
        for g, w in zip(got, want):
            assert g.dtype == w.dtype and g.shape == w.shape, K
            assert torch.equal(g.contiguous().view(torch.int32), w.view(torch.int32)), K
