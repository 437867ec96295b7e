"""Port SC decoder against the JAX package (unrolled XLA path and the Pallas
whole-decode kernel in interpret mode), and the CUDA kernel's host-side node
program against the plain version and JAX through a numpy emulation of the
kernel (its register nodes lane by lane)."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import polarcode_and_ldpc_tpu as jfec
import polarcode_and_ldpc_tpu_torch as tfec
from polarcode_and_ldpc_tpu.models.polar.fastsc import make_sc_decoder_unrolled as jax_unrolled
from polarcode_and_ldpc_tpu.models.polar.sc import make_sc_decoder as jax_make_sc_decoder
from polarcode_and_ldpc_tpu.models.polar.trellis import f_minsum as jax_f_minsum
from polarcode_and_ldpc_tpu.models.polar.trellis import g_update as jax_g_update
from polarcode_and_ldpc_tpu.ops.sc_mega_pallas import make_sc_decoder_mega as jax_mega
from polarcode_and_ldpc_tpu_torch.models.polar.construction import (
    bit_reverse_permutation, construct_polar_code, frozen_mask_from_positions)
from polarcode_and_ldpc_tpu_torch.models.polar.fastsc import make_sc_decoder_unrolled
from polarcode_and_ldpc_tpu_torch.models.polar.sc import make_sc_decoder
from polarcode_and_ldpc_tpu_torch.models.polar.trellis import f_minsum, g_update
from polarcode_and_ldpc_tpu_torch.ops import sc_mega_cuda as scm

TDT = {"f32": torch.float32, "f64": torch.float64}
JDT = {"f32": jnp.float32, "f64": jnp.float64}
NDT = {"f32": np.float32, "f64": np.float64}


def _mask(N, K, snr=2.0):
    frozen, _ = construct_polar_code(N, K, "bhattacharyya", snr)
    return frozen_mask_from_positions(N, frozen)


@functools.cache
def _jax_unrolled(N, K, dt, fast):
    """The jitted JAX unrolled decoder of the test code (N, K), compiled once
    per process for every test that compares against it."""
    return jax.jit(jax_unrolled(N, _mask(N, K), JDT[dt], fast_nodes=fast))


def _llrs(B, N, seed, dt, snr_db=1.0):
    """All-zero codeword over AWGN, seeded numpy."""
    std = np.sqrt(1.0 / (2.0 * 10 ** (snr_db / 10.0)))
    z = np.random.default_rng(seed).standard_normal((B, N))
    return (2.0 * (1.0 + std * z) / std ** 2).astype(NDT[dt])


# -- f / g ----------------------------------------------------------------------

@pytest.mark.parametrize("dt", ["f32", "f64"])
def test_f_g_bit_patterns(dt):
    """Same bits as the JAX functions, signed zeros and infinities included
    (subnormals are left out: XLA on the CPU flushes them to zero, the port
    keeps them)."""
    r = np.random.default_rng(0)
    special = np.array([0.0, -0.0, 1e-30, -1.5, 2.5, np.inf, -np.inf])
    a = np.concatenate([special.repeat(len(special)), r.standard_normal(64)]).astype(NDT[dt])
    b = np.concatenate([np.tile(special, len(special)), r.standard_normal(64)]).astype(NDT[dt])
    want = np.asarray(jax_f_minsum(jnp.asarray(a), jnp.asarray(b)))
    got = f_minsum(torch.from_numpy(a), torch.from_numpy(b)).numpy()
    ibits = np.int32 if dt == "f32" else np.int64
    assert np.array_equal(want.view(ibits), got.view(ibits))
    bit = r.integers(0, 2, a.shape).astype(np.int8)
    fin = np.isfinite(a) & np.isfinite(b)
    wg = np.asarray(jax_g_update(jnp.asarray(a[fin]), jnp.asarray(b[fin]), jnp.asarray(bit[fin])))
    gg = g_update(torch.from_numpy(a[fin]), torch.from_numpy(b[fin]), torch.from_numpy(bit[fin])).numpy()
    assert np.array_equal(wg.view(ibits), gg.view(ibits))


# -- plain decoder against JAX -----------------------------------------------------

@pytest.mark.parametrize("fast", [True, False])
@pytest.mark.parametrize("dt", ["f32", "f64"])
@pytest.mark.parametrize("N,K", [(32, 16), (256, 128), (256, 77)])
def test_plain_sc_equals_jax_unrolled(N, K, dt, fast):
    mask = _mask(N, K)
    llr = _llrs(48, N, N + K, dt)
    want = np.asarray(_jax_unrolled(N, K, dt, fast)(llr))
    got = make_sc_decoder_unrolled(N, mask, TDT[dt], fast_nodes=fast)(torch.from_numpy(llr))
    assert got.dtype == torch.int8 and np.array_equal(want, got.numpy())
    assert not got.numpy()[:, mask].any()  # frozen positions decode to 0


@pytest.mark.parametrize("fast", [True, False])
@pytest.mark.parametrize("N,K", [(64, 32), (256, 128)])
def test_plain_sc_equals_jax_pallas_interpret(N, K, fast):
    """The TPU whole-decode kernel, run as the JAX tests run it on the CPU."""
    mask = _mask(N, K)
    llr = _llrs(128, N, 5 * N, "f32")  # one full lane tile → the kernel path
    want = np.asarray(jax_mega(N, mask, jnp.float32, fast_nodes=fast, batch_tile=128,
                               interpret=True)(llr))
    got = make_sc_decoder_unrolled(N, mask, torch.float32, fast_nodes=fast)(torch.from_numpy(llr))
    assert np.array_equal(want, got.numpy())


def test_make_sc_decoder_default_matches_jax_default():
    N, K = 128, 64
    mask = _mask(N, K)
    llr = _llrs(32, N, 9, "f64", snr_db=0.0)
    want = np.asarray(jax.jit(jax_make_sc_decoder(N, mask, jnp.float64))(llr))
    dec = make_sc_decoder(N, mask, torch.float64, device="cpu")
    assert dec.impl == "unrolled"
    assert np.array_equal(want, dec(llr).numpy())
    # leading batch axes are kept
    assert dec(llr.reshape(4, 8, N)).shape == (4, 8, N)


def test_sc_decoder_class_equals_jax():
    N, K = 256, 128
    frozen, _ = construct_polar_code(N, K, "bhattacharyya", 2.0)
    jd = jfec.SCDecoder(N, K, frozen_bits=frozen, dtype=jnp.float64)
    td = tfec.SCDecoder(N, K, frozen_bits=frozen, dtype=torch.float64, device="cpu")
    llr = _llrs(40, N, 3, "f64", snr_db=0.5)
    assert np.array_equal(np.asarray(jd.decode(llr)), td.decode(llr).numpy())
    assert np.array_equal(np.asarray(jd.decode_full(llr[0])), td.decode_full(llr[0]).numpy())
    jd0, td0 = jfec.SCDecoder(64, 20), tfec.SCDecoder(64, 20, device="cpu")  # default frozen set
    assert np.array_equal(jd0.frozen_bits, td0.frozen_bits) and repr(jd0) == repr(td0)


def test_encode_decode_roundtrip_noiseless():
    N, K = 128, 64
    frozen, _ = construct_polar_code(N, K, "bhattacharyya", 2.0)
    enc = tfec.PolarEncoder(N, K, frozen_bits=frozen, device="cpu")
    dec = tfec.SCDecoder(N, K, frozen_bits=frozen, device="cpu")
    msgs = np.random.default_rng(1).integers(0, 2, (20, K))
    llr = 4.0 * (1.0 - 2.0 * enc.encode(msgs).to(torch.float32))
    assert np.array_equal(dec.decode(llr).numpy(), msgs)


# -- implementation choice ----------------------------------------------------------

def test_impl_selection_and_errors():
    mask = _mask(32, 16)
    assert make_sc_decoder(32, mask, device="cpu", impl="mega").impl == "mega"
    with pytest.raises(TypeError, match="float32 only"):
        make_sc_decoder(32, mask, torch.float64, impl="mega", device="cpu")
    with pytest.raises(NotImplementedError):
        make_sc_decoder(32, mask, impl="scan", device="cpu")
    with pytest.raises(ValueError):
        make_sc_decoder(32, mask, impl="nope", device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make_sc_decoder(32, mask)


def test_wrapper_uses_plain_only_for_cpu_tensors_and_checks_inputs():
    mask = _mask(64, 32)
    program = scm.SCProgram(64, mask)
    llr = torch.from_numpy(_llrs(8, 64, 2, "f32"))
    out = scm.sc_decode(llr, program)
    assert torch.equal(out, program.plain(llr))
    mega = make_sc_decoder(64, mask, impl="mega", device="cpu")
    assert torch.equal(mega(llr), out)
    from polarcode_and_ldpc_tpu_torch import ops
    assert ops.launch_counts()["sc_decode"] == 0  # no launch was counted on the CPU
    with pytest.raises(ValueError, match="CUDA tensor"):
        scm.sc_decode_cuda(llr, program)
    with pytest.raises(TypeError, match="float32 only"):
        mega(llr.double())


# -- the kernel's node program, emulated ------------------------------------------------

_LANES = np.arange(32)


def _shfl_down(v, s):
    """``__shfl_down_sync``: lane i reads lane i + s (its own value past 31)."""
    src = _LANES + s
    return np.where(src < 32, v[np.minimum(src, 31)], v)


def _shfl_up(v, s):
    """``__shfl_up_sync``: lane i reads lane i − s (its own value below 0)."""
    src = _LANES - s
    return np.where(src >= 0, v[np.maximum(src, 0)], v)


@functools.cache
def _natural_positions(K):
    """Per lane, ``__brev(lane) >> (32 − log2 K)``: a lane's natural-order
    position inside a node of K positions."""
    lg = K.bit_length() - 1
    return np.array([int(f"{lane:032b}"[::-1], 2) >> (32 - lg) for lane in _LANES], np.uint64)


def _f(a, b):
    m = np.minimum(np.abs(a), np.abs(b))
    s = (a.view(np.int32) ^ b.view(np.int32)) & np.int32(-2 ** 31)
    return (m.view(np.int32) | s).view(np.float32)


def _reg_node(a, fz, K, fast):
    """``reg_node<K>`` of ``csrc/sc_decode.cu``, lane by lane: ``a`` is the
    warp's 32 float32 lanes (lane i < K: the node's alpha_i), ``fz`` the
    node's frozen pattern; returns the 32 lanes' beta (lanes < K are the
    node's).  The same shuffle partners, REP's halving adds in their order,
    SPC's first minimum by the (|a| bits, natural position) key."""
    frozen = bin(fz).count("1")
    if frozen == K:
        return np.zeros(32, np.int64)
    bit = (a < 0).astype(np.int64)
    if K == 1:
        return bit
    if frozen == K - 1 and not (fz >> (K - 1)) & 1:  # REP
        v = a.copy()
        s = K // 2
        while s >= 1:
            v = _shfl_down(v, s) + v
            s //= 2
        return np.full(32, int(v[0] < 0), np.int64)
    if fast and frozen == 0:
        return bit
    if fast and frozen == 1 and fz & 1:  # SPC
        if not bit[:K].sum() & 1:
            return bit
        nat = _natural_positions(K)
        mag = np.abs(a).view(np.uint32).astype(np.uint64)
        cand = (_LANES < K) & ~np.isnan(a)
        key = np.where(cand, (mag << np.uint64(32)) | nat, np.uint64(0x7f800000 << 32 | K))
        s = K // 2
        while s >= 1:
            key = np.minimum(key, key[_LANES ^ s])
            s //= 2
        return bit ^ ((_LANES < K) & ((key & np.uint64(0xffffffff)) == nat))
    H = K // 2
    hi = _shfl_down(a, H)
    bl = _reg_node(_f(a, hi), fz & ((1 << H) - 1), H, fast)
    sgn = (1.0 - 2.0 * bl).astype(np.float32)
    br = _reg_node(hi + sgn * a, fz >> H, H, fast)
    return np.where(_LANES < H, bl ^ br, _shfl_up(br, H))


def _emulate_kernel(ops_table, llr, N, subtree=False):
    """What ``csrc/sc_decode.cu`` does for one frame, in numpy float32:
    bit-reversed storage, the level stack, one program row after another
    (a size-32 node row by ``_reg_node``), the storage-order butterfly,
    natural order on the way out.  In subtree mode (``sc_decode_sub``) the
    input and the output are storage order: no bit reversal, no butterfly.
    Where the level stack lives (shared or device memory) does not change
    what is computed."""
    rev = bit_reverse_permutation(N)
    base = lambda d: 2 * N - ((2 * N) >> d)
    alpha = np.zeros(2 * N, np.float32)
    beta = np.zeros(N, np.int8)
    if subtree:
        alpha[:N] = llr
    else:
        alpha[rev] = llr  # alpha[rev(i)] = llr[i]
    for op, d, sz, off in ops_table:
        if op in (scm.OP_NODE, scm.OP_NODE_FAST):
            dn = int(np.log2(N)) - 5
            with np.errstate(all="ignore"):  # lanes past a child's size hold junk
                node = _reg_node(alpha[base(dn):base(dn) + 32].copy(), int(d) & 0xffffffff,
                                 32, op == scm.OP_NODE_FAST)
            beta[off:off + 32] = node
            continue
        src = alpha[base(d):base(d) + (N >> d)]
        if op == scm.OP_F:
            alpha[base(d + 1):base(d + 1) + sz] = _f(src[:sz].copy(), src[sz:2 * sz].copy())
        elif op == scm.OP_G:
            sgn = (1.0 - 2.0 * beta[off:off + sz]).astype(np.float32)
            alpha[base(d + 1):base(d + 1) + sz] = src[sz:2 * sz] + sgn * src[:sz]
        elif op == scm.OP_COMBINE:
            beta[off:off + sz] ^= beta[off + sz:off + 2 * sz]
        elif op == scm.OP_RATE0:
            beta[off:off + sz] = 0
        elif op == scm.OP_HARD:
            beta[off:off + sz] = src[:sz] < 0
        elif op == scm.OP_REP:
            v = src[:sz].copy()
            while v.size > 1:
                h = v.size // 2
                v = v[h:] + v[:h]
            beta[off:off + sz] = v[0] < 0
        elif op == scm.OP_SPC:
            a = src[:sz]
            bits = (a < 0).astype(np.int8)
            lg = int(np.log2(sz))
            nat = bit_reverse_permutation(sz) if lg else np.zeros(1, np.int64)
            order = np.lexsort((nat, np.abs(a)))  # magnitude, then natural position
            if bits.sum() & 1:
                bits[order[0]] ^= 1
            beta[off:off + sz] = bits
        else:
            raise AssertionError(op)
    if subtree:
        return beta
    s = 1
    while s < N:
        x = beta.reshape(N // (2 * s), 2, s)
        x[:, 0, :] ^= x[:, 1, :]
        s *= 2
    return beta[rev]  # out[i] = beta[rev(i)]


@pytest.mark.parametrize("fast", [True, False])
@pytest.mark.parametrize("N,K", [(16, 8), (64, 32), (128, 90), (256, 128)])
def test_kernel_program_emulation_equals_plain(N, K, fast):
    """The node program, size-32 nodes in registers included, walked as the
    kernel walks it, equals the plain decoder and the JAX unrolled decoder
    bit for bit: Gaussian LLRs, integer ties with zeros, ±0.0 and
    all-negative rows."""
    mask = _mask(N, K)
    program = scm.SCProgram(N, mask, fast_nodes=fast)
    ops_table = program.ops
    assert ops_table.dtype == np.int32 and ops_table.shape[1] == 4
    kinds = set(ops_table[:, 0].tolist())
    assert scm.OP_F in kinds and scm.OP_G in kinds and scm.OP_COMBINE in kinds
    node_op, other = ((scm.OP_NODE_FAST, scm.OP_NODE) if fast
                      else (scm.OP_NODE, scm.OP_NODE_FAST))
    assert (node_op in kinds) == (N > scm.NODE_SIZE) and other not in kinds
    if not fast:
        assert scm.OP_SPC not in kinds
        assert all(sz == 1 for op, _, sz, _ in ops_table if op == scm.OP_HARD)
    llr = _llrs(12, N, 7 * N + K, "f32", snr_db=0.0)
    # plus tie-heavy integer LLRs with zeros: the SPC first-minimum rule and
    # the hard decision of ±0 must agree too; signed zeros, all-negative rows
    r = np.random.default_rng(N)
    ties = r.integers(-2, 3, (12, N)).astype(np.float32)
    zeros = np.where(r.integers(0, 2, (4, N)) == 1, np.float32(0.0), np.float32(-0.0))
    negative = -np.abs(np.concatenate([llr[:2], ties[:2] + np.float32(0.5)]))
    jax_dec = _jax_unrolled(N, K, "f32", fast)
    for batch in (llr, ties, zeros, negative):
        want = program.plain(torch.from_numpy(batch)).numpy()
        got = np.stack([_emulate_kernel(ops_table, row, N) for row in batch])
        assert np.array_equal(want, got)
        assert np.array_equal(np.asarray(jax_dec(batch)), got)


def test_kernel_program_covers_every_position_once():
    """Leaves and register nodes tile the storage range exactly, and every
    F/G pair is followed by its COMBINE: the structure the kernel relies
    on."""
    N = 256
    ops_table = scm.build_sc_program(N, _mask(N, 100), fast_nodes=True)
    leaf = np.isin(ops_table[:, 0], [scm.OP_RATE0, scm.OP_HARD, scm.OP_REP, scm.OP_SPC])
    node = ops_table[:, 0] == scm.OP_NODE_FAST
    assert node.any() and not (ops_table[:, 0] == scm.OP_NODE).any()
    covered = np.zeros(N, int)
    for _, d, sz, off in ops_table[leaf]:
        assert sz == N >> d
        covered[off:off + sz] += 1
    frozen_rev = _mask(N, 100)[bit_reverse_permutation(N)]
    for _, word, sz, off in ops_table[node]:
        assert sz == scm.NODE_SIZE and off % sz == 0
        assert word == scm.frozen_word(frozen_rev[off:off + sz])
        covered[off:off + sz] += 1
    assert (covered == 1).all()
    count = lambda op: int((ops_table[:, 0] == op).sum())
    assert count(scm.OP_F) == count(scm.OP_G) == count(scm.OP_COMBINE)


@pytest.mark.cuda
def test_kernel_equals_plain_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode); run chip_smoke.py on the card")
    mask = _mask(256, 128)
    program = scm.SCProgram(256, mask)
    llr = torch.from_numpy(_llrs(333, 256, 1, "f32")).cuda()
    assert torch.equal(scm.sc_decode_cuda(llr, program), program.plain(llr))
