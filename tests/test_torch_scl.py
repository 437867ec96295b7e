"""The port's chunked SCL decoder against the JAX package, on the CPU.

Inputs are made from a numpy seed and go through the JAX function and its
counterpart (``device="cpu"``).  The JAX package is batch-last (``[L, M, B]``),
the port frame-major (``[B, L, M]``); the helpers below transpose.

Tolerances: integers (bits, rank vectors, schedules) are equal.  Path metrics
agree to ``rtol=1e-6`` in float32 and ``1e-12`` in float64: the two runtimes'
``exp`` / ``log1p`` may differ in the last bit, every other float operation
(f, g, the additions in their fixed order) is the same.  A frame whose L-th
and (L+1)-th candidates lie within that tolerance could legitimately prune
otherwise; none of the seeded cases here does.

The JAX decoders are built once per module (fixtures) to pay each compile once.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import polarcode_and_ldpc_tpu as jfec
import polarcode_and_ldpc_tpu_torch as tfec
from polarcode_and_ldpc_tpu.models.polar import scanscl as jscan
from polarcode_and_ldpc_tpu.models.polar import scl as jscl
from polarcode_and_ldpc_tpu.models.polar.construction import (bit_reverse_permutation,
                                                              frozen_mask_from_positions)
from polarcode_and_ldpc_tpu.ops.scl_body_pallas import make_chunk_body_pallas
from polarcode_and_ldpc_tpu_torch.models.polar import scanscl as tscan
from polarcode_and_ldpc_tpu_torch.models.polar import scl as tscl
from polarcode_and_ldpc_tpu_torch.models.polar.crc import CRCCodec
from polarcode_and_ldpc_tpu_torch.sim import make_polar_pipeline


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


RTOL = {np.float32: 1e-6, np.float64: 1e-12}
JDT = {np.float32: jnp.float32, np.float64: jnp.float64}


def to_t(x):
    """JAX batch-last ``[..., B]`` numpy → frame-major torch tensor."""
    return torch.from_numpy(np.ascontiguousarray(np.moveaxis(np.asarray(x), -1, 0)))


def to_j(t):
    """frame-major torch tensor → batch-last numpy."""
    return np.moveaxis(t.numpy(), 0, -1)


def close(got, want, dtype):
    want = np.asarray(want)
    assert got.dtype == want.dtype
    np.testing.assert_allclose(got, want, rtol=RTOL[dtype], atol=0)


def mask_of(N, K):
    return frozen_mask_from_positions(N, jfec.construct_polar_code(N, K, "bhattacharyya", 2.0)[0])


def noisy_llrs(rng, B, N, mean=1.5, dtype=np.float32):
    """LLRs of the all-zero codeword over a noisy channel."""
    return (mean + np.sqrt(2 * mean) * rng.standard_normal((B, N))).astype(dtype)


# -- list-algebra primitives ---------------------------------------------------------

@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_d0_d1_equal(dtype):
    a = np.concatenate([np.random.default_rng(0).standard_normal(200) * 6,
                        [0.0, -0.0, 40.0, -40.0, 1e-8, 200.0, -200.0]]).astype(dtype)
    j0, j1 = jscan._d0_d1(jnp.asarray(a))
    t0, t1 = tscan._d0_d1(torch.from_numpy(a))
    close(t0.numpy(), j0, dtype)
    close(t1.numpy(), j1, dtype)


@pytest.mark.parametrize("L,M,dtype", [(1, 1, np.float32), (4, 2, np.float64), (2, 16, np.float32),
                                       (2, 16, np.float64), (8, 64, np.float64),
                                       (2, 128, np.float32)])
def test_zero_decision_leaves_and_rate0_metric_equal(L, M, dtype):
    """``M = 128`` is wider than the JAX package's 64-wide flat pass, which
    then splits once through f / g first: the same addition tree."""
    rng = np.random.default_rng(L * M)
    alpha = (2 * rng.standard_normal((L, M, 5))).astype(dtype)
    y_j, m_j = jax.jit(lambda a: (jscan._leaf_llrs_zero_dec(a),
                                  jscan._rate0_metric_levelpar(a)))(jnp.asarray(alpha))
    y_t = tscan._leaf_llrs_zero_dec(to_t(alpha))
    assert np.array_equal(to_j(y_t), np.asarray(y_j).reshape(L, M, 5))  # f, g: exact in both
    close(to_j(tscan._rate0_metric_levelpar(to_t(alpha))), m_j, dtype)


def test_rank_algebra_equal():
    rng = np.random.default_rng(3)
    L, J, M, B = 6, 4, 5, 9
    r = rng.integers(0, J, (L, B)).astype(np.int32)  # a selection: rows repeat
    x = rng.standard_normal((J, M, B)).astype(np.float32)
    x[1, 2, :] = -np.inf
    bits = rng.integers(0, 2, (J, M, B)).astype(np.int8)
    rt = to_t(r).long()
    assert np.array_equal(to_j(tscan._apply_perm_rank(rt, to_t(x))),
                          np.asarray(jscan._apply_perm_rank(jnp.asarray(r), jnp.asarray(x))))
    got = tscan._apply_perm_rank_bits_packed(rt, to_t(bits))
    assert got.dtype == torch.int8
    assert np.array_equal(to_j(got), np.asarray(
        jscan._apply_perm_rank_bits_packed(jnp.asarray(r), jnp.asarray(bits))))
    b = rng.integers(0, J, (J, B)).astype(np.int32)  # rank entries index a list of J
    assert np.array_equal(to_j(tscan._compose_rank(rt, to_t(b).long())),
                          np.asarray(jscan._compose_rank(jnp.asarray(r), jnp.asarray(b))))
    assert np.array_equal(to_j(tscan._identity_r_rank(5, 3, "cpu")),
                          np.asarray(jscan._identity_r_rank(5, 3, jnp.float32)))
    one = torch.ones(2, 1, 4)
    assert tscan._broadcast_rows(one, 3).shape == (2, 3, 4)
    assert tscan._broadcast_rows(one.expand(2, 3, 4), 3).shape == (2, 3, 4)


LEAF_CASES = ["random", "ties", "phantoms", "all tied", "narrow", "narrow grows"]


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("case", LEAF_CASES)
def test_info_leaf_rank_equal(case, dtype):
    rng = np.random.default_rng(len(case))
    Lsz, B = 8, 64
    lv = {"narrow": 4, "narrow grows": 2}.get(case, Lsz)
    a = (3 * rng.standard_normal((lv, B))).astype(dtype)
    pm = -np.abs(rng.standard_normal((lv, B))).astype(dtype)
    if case == "ties":
        a = rng.integers(-1, 2, (lv, B)).astype(dtype)
        pm = -rng.integers(0, 2, (lv, B)).astype(dtype)
    if case == "all tied":
        a[:], pm[:] = 0.0, -1.0
    if case == "phantoms":
        pm[3:] = -np.inf
    jb, jp, jr = jscan._info_leaf_rank(jnp.asarray(a), jnp.asarray(pm), Lsz)
    tb, tp, tr = tscan._info_leaf_rank(to_t(a), to_t(pm), Lsz)
    assert tb.dtype == torch.int8 and tb.shape == (B, min(2 * lv, Lsz), 1)
    assert np.array_equal(to_j(tb), np.asarray(jb))
    assert np.array_equal(to_j(tr), np.asarray(jr))
    close(to_j(tp), jp, dtype)
    if case == "all tied":  # the lower candidate index wins: bit-0 paths in order
        assert not tb.any() and tr[0].tolist() == list(range(Lsz))
    if case == "phantoms":  # phantoms tie with each other by index and take bit 0
        assert torch.isinf(tp[:, 6:]).all() and not tb[:, 6:].any()
        assert tr[0, 6:].tolist() == [3, 4]


def test_info_leaf_never_uses_an_unstable_order():
    """2L equal candidates, many frames: every frame gives slots 0..L-1 in
    order (a top-k without a stability promise would be free to differ)."""
    a = torch.zeros(4096, 8)
    pm = torch.zeros(4096, 8)
    bits, pm2, r = tscan._info_leaf_rank(a, pm, 8)
    assert not bits.any() and (r == torch.arange(8)).all() and (pm2 == pm2[0, 0]).all()


# -- chunk bodies ------------------------------------------------------------------

def pattern(kind, S, seed=0):
    f = np.ones(S, bool)
    if kind == "rep":
        f[-1] = False
    elif kind == "dense":
        f[:] = False
    elif kind == "mixed":
        f = np.random.default_rng(seed).random(S) < 0.5
    elif kind == "code":
        f = mask_of(4 * S, 2 * S)[np.asarray(bit_reverse_permutation(4 * S))].reshape(4, S)[2]
    return f


def body_inputs(rng, L, S, B, dtype, phantoms):
    alpha = (2 * rng.standard_normal((L, S, B))).astype(dtype)
    pm = -np.abs(rng.standard_normal((L, B))).astype(dtype)
    if phantoms:
        pm[max(1, L // 2):] = -np.inf
    return alpha, pm


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("kind,S,L,phantoms", [
    ("frozen", 32, 4, False), ("rep", 32, 4, True), ("rep", 128, 2, False),
    ("dense", 16, 8, True), ("dense", 8, 1, False), ("mixed", 64, 4, False),
    ("mixed", 32, 8, True), ("code", 32, 4, False)])
def test_chunk_body_equals_jax_body(kind, S, L, phantoms, dtype):
    flags = pattern(kind, S, seed=S + L)
    alpha, pm = body_inputs(np.random.default_rng(S * L), L, S, 16, dtype, phantoms)
    jbody = jax.jit(jscan._make_chunk_body(flags, L, JDT[dtype], algebra=jscan._RANK_ALGEBRA))
    jb, jp, jr = jbody(jnp.asarray(alpha), jnp.asarray(pm))
    tb, tp, tr = tscan._make_chunk_body(flags, L)(to_t(alpha), to_t(pm))
    assert tb.dtype == torch.int8
    assert np.array_equal(to_j(tb), np.asarray(jb))
    assert np.array_equal(to_j(tr), np.asarray(jr))
    close(to_j(tp), jp, dtype)


@pytest.mark.parametrize("kind,S,L,perm", [
    pytest.param("dense", 32, 2, "rank", id="dense-32-2"),
    pytest.param("rep", 64, 4, "rank", id="rep-64-4"),
    pytest.param("code", 32, 4, "rank", id="code-32-4"),
    pytest.param("code", 32, 4, "onehot", id="code-32-4-onehot")])
def test_chunk_body_equals_pallas_body_interpreted(kind, S, L, perm):
    """Against the TPU kernel itself, run in interpret mode on the CPU as the
    JAX package's own tests run it; ``onehot``: the R plane the one-hot body
    hands back (the layout K5-onehot stores), bit for bit."""
    flags = pattern(kind, S, seed=7)
    alpha, pm = body_inputs(np.random.default_rng(S + L), L, S, 128, np.float32, True)
    kb, kp, kr = jax.jit(make_chunk_body_pallas(
        flags, L, jnp.float32, interpret=True, perm_impl=perm))(
            jnp.asarray(alpha), jnp.asarray(pm))
    tb, tp, tr = tscan._make_chunk_body(flags, L, perm_impl=perm)(to_t(alpha), to_t(pm))
    assert np.array_equal(to_j(tb), np.asarray(kb))
    if perm == "onehot":
        assert tr.shape == (128, L, L) and tr.dtype == torch.float32
        assert np.array_equal(to_j(tr).view(np.int32), np.asarray(kr).view(np.int32))
    else:
        assert np.array_equal(to_j(tr), np.asarray(kr))
    close(to_j(tp), kp, np.float32)


@pytest.mark.parametrize("S", [2, 8, 64])
def test_rep_node_equals_the_generic_recursion(S, monkeypatch):
    """``_rep_exact`` is by construction what the leaf-by-leaf recursion with
    rate-0 collapse gives: bit for bit, metrics included."""
    flags = pattern("rep", S)
    alpha, pm = body_inputs(np.random.default_rng(S), 4, S, 32, np.float32, True)
    fast = tscan._make_chunk_body(flags, 4)(to_t(alpha), to_t(pm))
    monkeypatch.setattr(tscan, "_LEVELPAR_MAX", 0)  # no REP node: recurse to the leaves
    slow = tscan._make_chunk_body(flags, 4)(to_t(alpha), to_t(pm))
    for a, b in zip(fast, slow):
        assert torch.equal(a, b)


def test_chunk_body_live_width_equals_full_width_with_phantoms():
    flags = pattern("mixed", 32, seed=1)
    flags[:3] = False  # at least three info leaves: the list fills to 8
    rng = np.random.default_rng(5)
    llr = torch.from_numpy((2 * rng.standard_normal((16, 1, 32))).astype(np.float32))
    body = tscan._make_chunk_body(flags, 8)
    narrow = body(llr, torch.zeros(16, 1))
    full = body(llr.expand(-1, 8, -1), tscan.init_metrics(16, 8, 8, torch.float32, "cpu"))
    assert narrow[0].shape == (16, 8, 32)
    assert torch.equal(narrow[0], full[0]) and torch.equal(narrow[1], full[1])


# -- the static schedule ----------------------------------------------------------------

@pytest.mark.parametrize("N,K,S", [(128, 64, 32), (256, 100, 16), (64, 32, 32), (1024, 512, 128)])
def test_schedule_equals_jax_as_data(N, K, S):
    mask = mask_of(N, K)
    sched = tscan.build_scl_schedule(N, mask, 4, S)
    C, t = N // S, int(np.log2(N // S))
    assert (sched.C, sched.t, sched.sizes) == (C, t, tuple(N >> l for l in range(t + 1)))
    want_k = [t if c == 0 else (t + 1 + jscan._ctz(c) if c == (1 << jscan._ctz(c))
                                and jscan._ctz(c) <= t - 2 else jscan._ctz(c)) for c in range(C)]
    assert sched.desc_k.tolist() == want_k
    assert sched.asc_j.tolist() == [jscan._ctz(c + 1) for c in range(C)]
    rev = np.asarray(bit_reverse_permutation(N))
    assert np.array_equal(sched.chunk_flags, mask[rev].reshape(C, S))
    for sel in range(2 * t + 1):
        assert tscan.decode_selector(sel, t) == jscan.decode_selector(sel, t)
    if C == 1:
        return
    ja, jb = jscan.pend_liveness(sched.desc_k, sched.asc_j, t, C)
    ta, tb = tscan.pend_liveness(sched.desc_k, sched.asc_j, t, C)
    assert ta == ja and tb == jb
    for c in range(C - 1):
        frozen = sched.chunk_flags[c].all()
        assert sched.comp_a[c] == (frozenset() if frozen else ja[c])
        assert sched.comp_b[c] == (frozenset() if frozen else jb[c])
        for masks in ((None, None), (sched.comp_a[c], sched.comp_b[c])):
            assert (tscan.super_touch_sets(int(sched.desc_k[c]), int(sched.asc_j[c]), t, *masks)
                    == jscan.super_touch_sets(int(sched.desc_k[c]), int(sched.asc_j[c]), t, *masks))
    # live path counts: double per info leaf, capped at the list size
    info = (~sched.chunk_flags).sum(axis=1)
    assert sched.lv_in[0] == 1
    assert list(sched.lv_out) == [min(4, 1 << min(int(n), 30)) for n in np.cumsum(info)]
    assert sched.lv_in[1:] == sched.lv_out[:-1]


# -- the whole decode -----------------------------------------------------------------

N_DEC, K_DEC, S_DEC, B_DEC = 128, 64, 32, 48  # C = 4, t = 2


@pytest.fixture(scope="module")
def jax_decoders():
    mask = mask_of(N_DEC, K_DEC)
    return mask, {L: jax.jit(jscl.make_scl_decoder(
        N_DEC, mask, L, impl="scan-chunked", chunk=S_DEC, control_impl="unroll-fused"))
        for L in (1, 2, 4, 8)}


def decode_inputs(seed=0):
    rng = np.random.default_rng(seed)
    llr = noisy_llrs(rng, B_DEC, N_DEC)
    llr[0] = rng.integers(-2, 3, N_DEC)  # a tie-heavy frame
    return llr


@pytest.mark.parametrize("L", [1, 2, 4, 8])
@pytest.mark.parametrize("control,live", [("unroll-fused", False), ("unroll-fused", True),
                                          ("unroll-kernel", False), ("unroll-kernel", True)])
def test_decoder_equals_jax_chunked_decoder(jax_decoders, L, control, live):
    mask, jdecs = jax_decoders
    llr = decode_inputs(L)
    ju, jm = jdecs[L](jnp.asarray(llr))
    dec = tscl.make_scl_decoder(N_DEC, mask, L, chunk=S_DEC, control_impl=control,
                                live_width=live, device="cpu")
    assert dec.live_width == live and dec.control_impl == control
    tu, tm = dec(torch.from_numpy(llr))
    assert tu.dtype == torch.int8 and tu.shape == (B_DEC, L, N_DEC)
    assert np.array_equal(tu.numpy(), np.asarray(ju))
    close(tm.numpy(), jm, np.float32)


def test_decoder_equals_jax_kernel_control_interpreted():
    """Against the TPU per-chunk kernels (K3 / K4 in interpret mode): N = 128,
    chunk 32, so C = 4, t = 2: plain and invariant-parent descends, ascends
    with and without a combine."""
    N, K, L, S = 128, 64, 2, 32
    mask = mask_of(N, K)
    llr = noisy_llrs(np.random.default_rng(11), 128, N)
    ju, jm = jax.jit(jscl.make_scl_decoder(
        N, mask, L, impl="scan-chunked", chunk=S,
        control_impl="unroll-kernel-interpret"))(jnp.asarray(llr))
    for control in ("unroll-fused", "unroll-kernel"):
        tu, tm = tscl.make_scl_decoder(N, mask, L, chunk=S, control_impl=control,
                                       device="cpu")(torch.from_numpy(llr))
        assert np.array_equal(tu.numpy(), np.asarray(ju))
        close(tm.numpy(), jm, np.float32)


def test_decoder_float64_equals_jax():
    mask = mask_of(64, 32)
    llr = noisy_llrs(np.random.default_rng(2), 32, 64, dtype=np.float64)
    ju, jm = jax.jit(jscl.make_scl_decoder(64, mask, 4, jnp.float64, impl="scan-chunked",
                                           chunk=16, control_impl="unroll-fused"))(jnp.asarray(llr))
    tu, tm = tscl.make_scl_decoder(64, mask, 4, torch.float64, chunk=16,
                                   device="cpu")(torch.from_numpy(llr))
    assert tm.dtype == torch.float64 and np.array_equal(tu.numpy(), np.asarray(ju))
    close(tm.numpy(), jm, np.float64)


@pytest.mark.parametrize("chunk", [128, 32, 8])
def test_list_of_one_equals_the_sc_decoder(chunk):
    mask = mask_of(N_DEC, K_DEC)
    # no tied or zero LLRs: the SC decoder's rate-1 / SPC shortcuts are exact
    # only away from ties
    llr = torch.from_numpy(noisy_llrs(np.random.default_rng(9), B_DEC, N_DEC))
    u, m = tscl.make_scl_decoder(N_DEC, mask, 1, chunk=chunk, device="cpu")(llr)
    frozen = np.nonzero(mask)[0]
    sc = tfec.SCDecoder(N_DEC, K_DEC, frozen_bits=frozen, device="cpu")
    assert torch.equal(u[:, 0], sc.decode_full(llr))


@pytest.mark.parametrize("N,K,L,chunk", [(128, 64, 8, 32), (128, 64, 4, 128), (64, 2, 8, 16),
                                         (256, 200, 8, 32)])
def test_live_width_on_equals_off(N, K, L, chunk):
    """``(64, 2, 8)``: fewer than log2 L info bits, the output is padded with
    the phantom rows' exact values."""
    mask = mask_of(N, K)
    llr = torch.from_numpy(noisy_llrs(np.random.default_rng(N + L), 24, N))
    on = tscl.make_scl_decoder(N, mask, L, chunk=chunk, live_width=True, device="cpu")
    off = tscl.make_scl_decoder(N, mask, L, chunk=chunk, live_width=False, device="cpu")
    auto = tscl.make_scl_decoder(N, mask, L, chunk=chunk, device="cpu")
    assert on.live_width and auto.live_width and not off.live_width
    (u1, m1), (u0, m0) = on(llr), off(llr)
    assert torch.equal(u1, u0) and torch.equal(m1, m0)
    if K == 2:
        assert torch.isinf(m0[:, 4:]).all() and not u0[:, 4:].any()


def test_chunk_sizes_give_one_result():
    mask = mask_of(N_DEC, K_DEC)
    llr = torch.from_numpy(decode_inputs(4))
    ref = tscl.make_scl_decoder(N_DEC, mask, 4, chunk=128, device="cpu")(llr)
    for chunk in (64, 16, 4):
        for control in ("unroll-fused", "unroll-kernel"):
            u, m = tscl.make_scl_decoder(N_DEC, mask, 4, chunk=chunk, control_impl=control,
                                         device="cpu")(llr)
            assert torch.equal(u, ref[0]), (chunk, control)
            # another chunking adds the rate-0 sums in another tree: metrics to tolerance
            np.testing.assert_allclose(m.numpy(), ref[1].numpy(), rtol=1e-5)


# -- classes, selection, options ----------------------------------------------------------

@pytest.fixture(scope="module")
def jax_classes():
    frozen = jfec.construct_polar_code(64, 32, "bhattacharyya", 2.0)[0]
    return frozen, {
        "scl": jfec.SCLDecoder(64, 32, list_size=4, frozen_bits=frozen),
        "cascl": jfec.CASCLDecoder(64, 32, list_size=4, frozen_bits=frozen),
    }


@pytest.mark.parametrize("which", ["scl", "cascl"])
def test_decoder_classes_equal_jax_default(jax_classes, which):
    """At N < 512 the JAX classes take their ``"unrolled"`` decoder; the port
    answers with the chunked decoder, and the outputs are the same."""
    frozen, jdecs = jax_classes
    tdec = {"scl": lambda: tfec.SCLDecoder(64, 32, list_size=4, frozen_bits=frozen, device="cpu"),
            "cascl": lambda: tfec.CASCLDecoder(64, 32, list_size=4, frozen_bits=frozen,
                                               device="cpu")}[which]()
    jdec = jdecs[which]
    assert repr(tdec) == repr(jdec) and tdec.use_crc == jdec.use_crc
    assert np.array_equal(tdec.info_bits, jdec.info_bits)
    # CRC-carrying codewords through a noisy channel, so the selection has work
    crc_poly = jdec.crc_polynomial if jdec.use_crc else None
    enc = tfec.PolarEncoder(64, 32, frozen_bits=frozen, use_crc=crc_poly is not None,
                            crc_polynomial=crc_poly or "CRC-8", device="cpu")
    rng = np.random.default_rng(12)
    cw = enc.encode(rng.integers(0, 2, (96, enc.K_data))).numpy()
    llr = ((1 - 2.0 * cw) * 1.6 + 1.8 * rng.standard_normal(cw.shape)).astype(np.float32)
    want = np.asarray(jdec.decode(llr))
    got = tdec.decode(llr)
    assert got.dtype == torch.int8 and np.array_equal(got.numpy(), want)
    ju, jm = jdec.decode_paths(llr)
    tu, tm = tdec.decode_paths(llr)
    assert np.array_equal(tu.numpy(), np.asarray(ju))
    close(tm.numpy(), jm, np.float32)
    assert np.array_equal(tdec.decode(llr[0]).numpy(), np.asarray(jdec.decode(llr[0])))
    assert (got.numpy() != np.asarray(want)).sum() == 0 and (want != 0).any()


def test_select_best_path_ties_and_no_crc_pass():
    crc = CRCCodec(8, "CRC-8", device="cpu")
    jcrc = jscl.CRCCodec(8, "CRC-8")
    rng = np.random.default_rng(1)
    good = crc.encode(rng.integers(0, 2, (4, 8))).numpy()          # [4, 16] pass
    bad = good.copy()
    bad[:, 0] ^= 1                                                   # fail
    paths = np.stack([
        np.stack([bad[0], good[0], good[1], bad[1]]),    # two pass, tied metrics: first wins
        np.stack([bad[0], bad[1], bad[2], bad[3]]),      # none passes: metric argmax
        np.stack([good[0], bad[1], good[2], good[3]]),   # the best metric fails its CRC
        np.stack([bad[0], bad[1], bad[2], good[3]]),     # all metrics tied, one passes
    ]).astype(np.int8)
    metrics = np.array([[-1.0, -2.0, -2.0, -0.5],
                        [-3.0, -1.0, -1.0, -2.0],
                        [-5.0, -0.1, -4.0, -3.0],
                        [-1.0, -1.0, -1.0, -1.0]], np.float32)
    for codec, jcodec in ((crc, jcrc), (None, None)):
        want = np.asarray(jscl.select_best_path(jnp.asarray(paths), jnp.asarray(metrics), jcodec))
        got = tscl.select_best_path(torch.from_numpy(paths), torch.from_numpy(metrics), codec)
        assert np.array_equal(got.numpy(), want)
    got = tscl.select_best_path(torch.from_numpy(paths), torch.from_numpy(metrics), crc).numpy()
    assert np.array_equal(got, np.stack([good[0], bad[1], good[3], good[3]]))
    # argmax returns the FIRST maximum, on every frame of a large tied batch
    assert (torch.argmax(torch.zeros(4096, 8), dim=-1) == 0).all()
    tied = torch.argmax(torch.tensor([[-1.0, 0.0, 0.0, -1.0]]).expand(4096, 4), dim=-1)
    assert (tied == 1).all()


def test_unported_options_raise_with_their_name():
    mask = mask_of(32, 16)
    frozen = np.nonzero(mask)[0]
    # ported now: the one-hot algebra, the sort prune, the unrolled decoder, the
    # united masks and JAX's scan controls give the default decoder's outputs
    llr = torch.from_numpy(np.random.default_rng(11).normal(1.0, 1.5, (16, 32)).astype(
        np.float32))
    want = tscl.make_scl_decoder(32, mask, 2, chunk=8, device="cpu")(llr)
    for kw in [dict(perm_impl="onehot"), dict(leaf_impl="sort"), dict(impl="unrolled"),
               dict(mask_dedup="union")] + [dict(control_impl=c)
                                            for c in ("split", "fused", "kernel")]:
        got = tscl.make_scl_decoder(32, mask, 2, chunk=8, device="cpu", **kw)(llr)
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1]), kw
    # the trellis twin is in the package now: the same paths, the metrics
    # within the float32 tolerance of the list decoders (rtol=1e-6)
    got = tscl.make_scl_decoder(32, mask, 2, impl="scan", device="cpu")(llr)
    assert torch.equal(got[0], want[0])
    torch.testing.assert_close(got[1], want[1], rtol=1e-6, atol=0)
    # what this package leaves out says so, by name
    for kw, word in [(dict(control_impl=c), f"control_impl={c!r}")
                     for c in ("kernel-interpret", "mega-interpret",
                               "unroll-kernel-interpret")]:
        with pytest.raises(NotImplementedError, match=word.replace("'", ".")):
            tscl.make_scl_decoder(32, mask, 2, device="cpu", **kw)
    for kw in (dict(perm_impl="x"), dict(node_mode="x"), dict(leaf_impl="x"), dict(impl="x"),
               dict(control_impl="x"), dict(body_impl="pallas"), dict(mask_dedup="x")):
        with pytest.raises(ValueError):
            tscl.make_scl_decoder(32, mask, 2, device="cpu", **kw)
    with pytest.raises(NotImplementedError, match="mega-interpret"):
        make_polar_pipeline(32, 16, frozen, 3.0, decoder="scl",
                            scl_control_impl="mega-interpret", device="cpu")
    # the one-launch control is in the package: on the CPU it is the plain chunk program
    assert tscl.make_scl_decoder(32, mask, 2, control_impl="mega",
                                 device="cpu").control_impl == "mega"
    # the fast list nodes are in the package: not on the one-launch control,
    # not with live width, and with a warning above a list of 16
    assert tfec.SCLDecoder(32, 16, frozen_bits=frozen, node_mode="fast",
                           device="cpu").node_mode == "fast"
    with pytest.raises(ValueError, match="mega"):
        tscl.make_scl_decoder(32, mask, 2, control_impl="mega", node_mode="fast", device="cpu")
    with pytest.raises(ValueError, match="live_width"):
        tscl.make_scl_decoder(32, mask, 2, node_mode="fast", live_width=True, device="cpu")
    assert not tscl.make_scl_decoder(32, mask, 4, node_mode="fast", device="cpu").live_width
    with pytest.warns(UserWarning, match="small-list serving mode"):
        tscl.make_scl_decoder(32, mask, 32, node_mode="fast", device="cpu")
    # the kernels are float32 and hold lists up to 32; a single-chunk code is
    # one chunk-body launch, at full width
    with pytest.raises(TypeError, match="float32"):
        tscl.make_scl_decoder(32, mask, 2, torch.float64, control_impl="unroll-kernel",
                              device="cpu")
    with pytest.raises(ValueError, match="live_width"):
        tscl.make_scl_decoder(32, mask, 2, control_impl="unroll-kernel", live_width=True,
                              device="cpu")
    assert tscl.make_scl_decoder(32, mask, 2, chunk=8, control_impl="unroll-kernel",
                                 device="cpu").live_width
    with pytest.raises(ValueError, match="list sizes"):
        tscl.make_scl_decoder(32, mask, 64, control_impl="unroll-kernel", device="cpu")


def test_defaults_follow_the_device():
    mask = mask_of(32, 16)
    dec = tscl.make_scl_decoder(32, mask, 2, device="cpu")
    assert dec.control_impl == "unroll-fused" and dec.live_width
    if not torch.cuda.is_available():
        for build in (lambda: tscl.make_scl_decoder(32, mask, 2),
                      lambda: tfec.SCLDecoder(32, 16), lambda: tfec.CASCLDecoder(32, 16),
                      lambda: CRCCodec(8), lambda: tfec.PolarEncoder(32, 16, use_crc=True)):
            with pytest.raises(RuntimeError, match="no CUDA device"):
                build()


def test_first_exp_of_a_process_is_settled_on_import():
    """The first multi-threaded ``torch.exp`` of a process can be off by 1e-4
    on one thread's share of the tensor (a library initialisation race, seen
    in one process in four); importing the decoder module settles it, so the
    very first metrics of a process are as accurate as every later one."""
    import subprocess
    import sys
    from pathlib import Path

    code = """
import torch
from polarcode_and_ldpc_tpu_torch.models.polar.scanscl import _d0_d1
a = 2 * torch.randn(512, 8, 64, generator=torch.Generator().manual_seed(0))
d0, d1 = _d0_d1(a)
r0, r1 = _d0_d1(a.double())
err = max(((d0.double() - r0).abs() / r0.abs()).max().item(),
          ((d1.double() - r1).abs() / r1.abs()).max().item())
assert err < 2e-6, err
print("ok", err)
"""
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=300, cwd=Path(__file__).resolve().parents[1])
    assert out.returncode == 0 and "ok" in out.stdout, out.stderr[-2000:]
