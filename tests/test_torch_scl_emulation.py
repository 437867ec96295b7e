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
"""

import zlib

import numpy as np
import pytest
import torch

import polarcode_and_ldpc_tpu_torch as tfec
from polarcode_and_ldpc_tpu_torch.models.polar.construction import (
    bit_reverse_permutation, frozen_mask_from_positions)
from polarcode_and_ldpc_tpu_torch.models.polar.scanscl import (_d0_d1, build_scl_schedule,
                                                               make_scl_decoder_scan)
from polarcode_and_ldpc_tpu_torch.models.polar.trellis import f_minsum
from polarcode_and_ldpc_tpu_torch.ops import scl_cuda
from polarcode_and_ldpc_tpu_torch.ops.scl_cuda import (FLAG_RL, FLAG_RR, OP_COMBINE, OP_F, OP_G,
                                                       OP_LEAF, OP_RATE0, OP_REP, SCLBodyProgram,
                                                       SCLState, build_scl_body_program,
                                                       make_step_specs, unpack_paths)


class Ctx:
    """One warp's shared memory, for every frame at once."""

    def __init__(self, B, L, S):
        self.L, self.S, self.lgS = L, S, int(np.log2(S))
        self.alpha = torch.zeros((B, 2 * S * L), dtype=torch.float32)
        self.beta = torch.zeros((B, S), dtype=torch.int64)  # packed words
        self.pm = torch.zeros((B, L), dtype=torch.float32)
        self.R = torch.zeros((B, L), dtype=torch.int64)
        self.Rstack = torch.zeros((B, self.lgS + 1, L), dtype=torch.int64)

    def depth_base(self, d):
        return self.L * (2 * self.S - ((2 * self.S) >> d))


def perm_word(w, r, L):
    """bit l of the result is bit r[l] of w; ``w [B, n]``, ``r [B, L]``."""
    out = torch.zeros_like(w)
    for l in range(L):
        out |= ((w >> r[:, l:l + 1]) & 1) << l
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


def info_leaf(c, leaf_a):
    L = c.L
    d0, d1 = _d0_d1(leaf_a)
    cand = torch.cat([c.pm + d0, c.pm + d1], dim=1)
    B = cand.shape[0]
    rank = torch.zeros((B, 2 * L), dtype=torch.int64)
    for i in range(2 * L):
        for j in range(2 * L):
            cj, ci = cand[:, j], cand[:, i]
            rank[:, i] += ((cj > ci) | ((cj == ci) & (j < i))).to(torch.int64)
    word = torch.zeros((B,), dtype=torch.int64)
    rows = torch.arange(B)
    for i in range(2 * L):
        keep = rank[:, i] < L
        slot = rank[keep, i]
        c.pm[rows[keep], slot] = cand[keep, i]
        c.R[rows[keep], slot] = i if i < L else i - L
        if i >= L:
            word[keep] |= 1 << slot
    return word


def chunk_body(c, ops, has_r):
    L = c.L
    for op, d, sz, off in ops.tolist():
        kind = op & 0xFF
        base, nxt = c.depth_base(d), c.depth_base(d + 1)
        if kind == OP_F:
            idx = np.arange(L * sz)
            l, i = idx // sz, idx % sz
            c.alpha[:, nxt + idx] = f_minsum(c.alpha[:, base + l * 2 * sz + i],
                                             c.alpha[:, base + l * 2 * sz + sz + i])
        elif kind == OP_G:
            if op & FLAG_RL:
                c.Rstack[:, d] = c.R
            idx = np.arange(L * sz)
            l, i = torch.as_tensor(idx // sz), torch.as_tensor(idx % sz)
            r = c.Rstack[:, d][:, l] if op & FLAG_RL else l[None, :].expand(c.pm.shape[0], -1)
            bit = (c.beta[:, off + i] >> l[None, :]) & 1
            sgn = 1.0 - 2.0 * bit.to(torch.float32)
            src = c.alpha[:, base:]
            second = torch.gather(src, 1, r * 2 * sz + sz + i[None, :])
            first = torch.gather(src, 1, r * 2 * sz + i[None, :])
            c.alpha[:, nxt + idx] = second + sgn * first
        elif kind == OP_COMBINE:
            w = c.beta[:, off:off + sz]
            if op & FLAG_RR:
                w = perm_word(w, c.R, L)
            c.beta[:, off:off + sz] = w ^ c.beta[:, off + sz:off + 2 * sz]
            if op & FLAG_RL:
                saved = c.Rstack[:, d]
                c.R = torch.gather(saved, 1, c.R) if op & FLAG_RR else saved.clone()
        elif kind == OP_RATE0:
            z = c.alpha[:, base:base + L * sz]  # a view: in place
            zero_dec_inplace(z, L * sz, sz)
            z[:] = _d0_d1(z)[0]
            s = 1
            while s < sz:
                p = np.arange((L * sz) // (2 * s)) * 2 * s
                z[:, p] = z[:, p] + z[:, p + s]
                s *= 2
            c.pm = c.pm + z[:, np.arange(L) * sz]
            c.beta[:, off:off + sz] = 0
        elif kind == OP_LEAF:
            word = info_leaf(c, c.alpha[:, base:base + L].clone())
            c.beta[:, off] = word
        elif kind == OP_REP:
            z = c.alpha[:, base:base + L * sz]
            lgM = int(np.log2(sz))
            zero_dec_inplace(z, L * sz, sz)
            leaf_a = z[:, np.arange(L) * sz + sz - 1].clone()
            z[:] = _d0_d1(z)[0]
            k = 0
            while (sz >> k) > 2:
                pairs = (sz >> (k + 1)) - 1
                q = np.arange(L * pairs)
                l, i = q // pairs, q % pairs
                p = l * sz + (i << (k + 1))
                z[:, p] = z[:, p] + z[:, p + (1 << k)]
                k += 1
            pm = c.pm.clone()
            for j in range(1, lgM + 1):
                pm = pm + z[:, np.arange(L) * sz + sz - (sz >> (j - 1))]
            c.pm = pm
            word = info_leaf(c, leaf_a)
            c.beta[:, off:off + sz] = word[:, None]
        else:
            raise AssertionError(kind)
    if not has_r:
        c.R = torch.arange(L).expand(c.pm.shape[0], L).clone()


def emulate_body(program: SCLBodyProgram, alpha, pm):
    B, L, S = alpha.shape
    c = Ctx(B, L, S)
    c.alpha[:, :L * S] = alpha.reshape(B, L * S)
    c.pm = pm.clone()
    chunk_body(c, program.ops, program.has_r)
    beta = ((c.beta[:, None, :] >> torch.arange(L)[None, :, None]) & 1).to(torch.int8)
    return beta, c.pm, c.R


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


def descend_g(st, x, lo, inv):
    N, L = st.N, st.L
    M = N >> lo
    idx = np.arange(L * M)
    l, i = torch.as_tensor(idx // M), torch.as_tensor(idx % M)
    B = x.shape[0]
    bl = st.Bt[:, st.b_off(lo):st.b_off(lo) + M]
    pb = st.PB[:, lo - 1].to(torch.int64)
    if lo == 1:
        first, second = x[:, i], x[:, M + i]
    else:
        parent = st.A[:, st.a_off(lo - 1):]
        row = (torch.zeros((B, L * M), dtype=torch.int64) if inv
               else st.PA[:, lo - 2].to(torch.int64)[:, l])
        first = torch.gather(parent, 1, row * 2 * M + i[None, :])
        second = torch.gather(parent, 1, row * 2 * M + M + i[None, :])
    bit = (bl[:, i] >> pb[:, l]) & 1
    return second + (1.0 - 2.0 * bit.to(torch.float32)) * first


def emulate_step(state: SCLState, spec):
    st = Stacks(state)
    N, S, L, t = st.N, st.S, st.L, st.t
    B = state.pm.shape[0]
    x = state.llr
    eye = torch.arange(L, dtype=torch.int32)
    if spec.k == t:
        for l in range(1, t + 1):
            M = N >> l
            src = x if l == 1 else st.A[:, st.a_off(l - 1):]
            v = f_minsum(src[:, :M], src[:, M:2 * M])
            st.A[:, st.a_off(l):st.a_off(l) + L * M] = v.repeat(1, L)
            st.PA[:, l - 1] = eye
    else:
        lo = t - spec.k
        M = N >> lo
        st.A[:, st.a_off(lo):st.a_off(lo) + L * M] = descend_g(st, x, lo, spec.inv)
        st.PA[:, lo - 1] = eye
        for l in range(lo + 1, t + 1):
            M = N >> l
            idx = np.arange(L * M)
            r, i = idx // M, idx % M
            src = st.A[:, st.a_off(l - 1):]
            st.A[:, st.a_off(l) + idx] = f_minsum(src[:, r * 2 * M + i], src[:, r * 2 * M + M + i])
            st.PA[:, l - 1] = eye
    c = Ctx(B, L, S)
    c.alpha[:, :L * S] = st.A[:, st.a_off(t):st.a_off(t) + L * S]
    c.pm = state.pm.clone()
    chunk_body(c, spec.program.ops, spec.program.has_r)
    state.pm = c.pm
    for l in range(1, t + 1):
        if (spec.mask_a >> (l - 1)) & 1:
            st.PA[:, l - 1] = torch.gather(st.PA[:, l - 1].to(torch.int64), 1, c.R).to(torch.int32)
        if (spec.mask_b >> (l - 1)) & 1:
            st.PB[:, l - 1] = torch.gather(st.PB[:, l - 1].to(torch.int64), 1, c.R).to(torch.int32)
    j = spec.j
    D = S << j
    d0 = st.b_off(t - j)
    st.Bt[:, d0 + D - S:d0 + D] = c.beta
    for s in range(j):
        lev, size = t - s, S << s
        left = st.Bt[:, st.b_off(lev):st.b_off(lev) + size]
        w = perm_word(left, st.PB[:, lev - 1].to(torch.int64), L)
        st.Bt[:, d0 + D - 2 * size:d0 + D - size] = w ^ st.Bt[:, d0 + D - size:d0 + D]
    st.PB[:, t - j - 1] = eye
    state.beta = torch.where(st.Bt >= 2 ** 31, st.Bt - 2 ** 32, st.Bt).to(torch.int32)


def emulate_last(state: SCLState, spec):
    st = Stacks(state)
    N, S, L, t = st.N, st.S, st.L, st.t
    B = state.pm.shape[0]
    c = Ctx(B, L, S)
    c.alpha[:, :L * S] = descend_g(st, state.llr, t, False)
    c.pm = state.pm.clone()
    chunk_body(c, spec.program.ops, spec.program.has_r)
    root = torch.zeros((B, N), dtype=torch.int64)
    root[:, N - S:] = c.beta
    for lev in range(t, 0, -1):
        size = N >> lev
        eff = torch.gather(st.PB[:, lev - 1].to(torch.int64), 1, c.R)
        left = st.Bt[:, st.b_off(lev):st.b_off(lev) + size]
        root[:, N - 2 * size:N - size] = perm_word(left, eff, L) ^ root[:, N - size:]
    s = 1
    while s < N:
        idx = np.arange(N // 2)
        p = (idx // s) * 2 * s + idx % s
        root[:, p] ^= root[:, p + s]
        s *= 2
    rev = torch.as_tensor(np.asarray(bit_reverse_permutation(N)), dtype=torch.int64)
    u = ((root[:, rev][:, None, :] >> torch.arange(L)[None, :, None]) & 1).to(torch.int8)
    return u, c.pm


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
