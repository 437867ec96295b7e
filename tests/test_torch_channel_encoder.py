"""Port channel, constructions and encoders against the JAX package on the
same numpy inputs (port on ``device="cpu"``)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import polarcode_and_ldpc_tpu as jfec
import polarcode_and_ldpc_tpu_torch as tfec
from polarcode_and_ldpc_tpu.channels import awgn as jawgn
from polarcode_and_ldpc_tpu.models.ldpc import matrix as jmatrix
from polarcode_and_ldpc_tpu.models.ldpc.encoder import gf2_solve as jax_gf2_solve
from polarcode_and_ldpc_tpu.models.polar import construction as jcons
from polarcode_and_ldpc_tpu.models.polar.encoder import polar_transform as jax_polar_transform
from polarcode_and_ldpc_tpu_torch.channels import awgn as tawgn
from polarcode_and_ldpc_tpu_torch.models.ldpc import matrix as tmatrix
from polarcode_and_ldpc_tpu_torch.models.ldpc.encoder import gf2_solve
from polarcode_and_ldpc_tpu_torch.models.polar import construction as tcons
from polarcode_and_ldpc_tpu_torch.models.polar.encoder import polar_transform


# -- AWGN ----------------------------------------------------------------------

@pytest.mark.parametrize("snr_db", [-1.0, 0.0, 3.0, 6.5])
def test_awgn_llr_injected_noise_f64(snr_db):
    r = np.random.default_rng(int(10 * snr_db) + 50)
    bits = r.integers(0, 2, (16, 128))
    noise = r.standard_normal((16, 128))
    want = np.asarray(jawgn.awgn_transmit(None, bits, snr_db, dtype=jnp.float64, noise=noise))
    got = tawgn.awgn_transmit(None, torch.from_numpy(bits), snr_db, dtype=torch.float64,
                              noise=torch.from_numpy(noise)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-12, atol=0)
    hard_w = np.asarray(jawgn.awgn_transmit(None, bits, snr_db, False, jnp.float64, noise))
    hard_g = tawgn.awgn_transmit(None, torch.from_numpy(bits), snr_db, False, torch.float64,
                                 torch.from_numpy(noise)).numpy()
    assert hard_g.dtype == np.int8 and np.array_equal(hard_w, hard_g)


def test_awgn_llr_injected_noise_f32():
    """float32: one rounding per operation on both sides; XLA may fuse
    ``2·y/σ²`` differently, hence rtol=1e-6."""
    r = np.random.default_rng(3)
    bits = r.integers(0, 2, (8, 64))
    noise = r.standard_normal((8, 64)).astype(np.float32)
    want = np.asarray(jawgn.awgn_transmit(None, bits, 2.0, dtype=jnp.float32, noise=noise))
    got = tawgn.awgn_transmit(None, torch.from_numpy(bits), 2.0, noise=torch.from_numpy(noise)).numpy()
    assert got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)


def test_awgn_scalars_and_runtime_snr():
    for snr in (-2.0, 0.0, 3.0):
        assert tawgn.awgn_noise_std(snr) == jawgn.awgn_noise_std(snr)
        assert tawgn.awgn_capacity(snr) == jawgn.awgn_capacity(snr)
    # a tensor-valued SNR is computed on the device, to float precision
    std = tawgn.awgn_noise_std(torch.tensor(3.0, dtype=torch.float64))
    assert abs(float(std) - jawgn.awgn_noise_std(3.0)) < 1e-15
    r = np.random.default_rng(4)
    bits = torch.from_numpy(r.integers(0, 2, (4, 32)))
    noise = torch.from_numpy(r.standard_normal((4, 32)))
    a = tawgn.awgn_transmit(None, bits, 3.0, dtype=torch.float64, noise=noise)
    b = tawgn.awgn_transmit(None, bits, torch.tensor(3.0, dtype=torch.float64),
                            dtype=torch.float64, noise=noise)
    np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-12)


def test_bpsk_helpers():
    bits = np.array([0, 1, 1, 0])
    sym = tawgn.bpsk_modulate(torch.from_numpy(bits))
    assert np.array_equal(sym.numpy(), np.asarray(jawgn.bpsk_modulate(bits)))
    y = np.array([0.5, -0.1, 0.0, 2.0])
    assert np.array_equal(tawgn.bpsk_demodulate_hard(torch.from_numpy(y)).numpy(),
                          np.asarray(jawgn.bpsk_demodulate_hard(y)))
    np.testing.assert_allclose(tawgn.symbols_to_llr(torch.from_numpy(y), 0.7).numpy(),
                               np.asarray(jawgn.symbols_to_llr(y, 0.7)), rtol=1e-15)


def test_awgn_channel_class_same_seed_same_noise():
    """The class splits its key and draws one shaped normal per transmit, as
    the JAX class does: same seed → LLRs equal up to the float32 erf_inv
    difference (1e-6 on the noise → 2e-5 on LLR = 2y/σ² at 3 dB)."""
    bits = np.random.default_rng(8).integers(0, 2, (5, 96))
    jc = jfec.AWGNChannel(snr_db=3.0, seed=42)
    tc = tfec.AWGNChannel(snr_db=3.0, seed=42, device="cpu")
    for _ in range(2):  # the key advances between calls
        want = np.asarray(jc.transmit(bits))
        got = tc.transmit(bits).numpy()
        np.testing.assert_allclose(got, want, rtol=0, atol=2e-5)
    assert tc.get_capacity() == jc.get_capacity()
    assert repr(tc) == repr(jc)


# -- polar construction and encoder -----------------------------------------------

@pytest.mark.parametrize("method", ["bhattacharyya", "gaussian_approximation", "dega", "default"])
@pytest.mark.parametrize("N,K", [(64, 32), (256, 100)])
def test_polar_construction_equal(method, N, K):
    wf, wi = jcons.construct_polar_code(N, K, method, 2.0)
    gf, gi = tcons.construct_polar_code(N, K, method, 2.0)
    assert np.array_equal(wf, gf) and np.array_equal(wi, gi)


def test_polar_reliabilities_equal():
    for fn in ("bhattacharyya_bounds", "gaussian_approximation", "dega_llr_means"):
        assert np.array_equal(getattr(jcons, fn)(128, 1.5), getattr(tcons, fn)(128, 1.5)), fn
    assert np.array_equal(jcons.bit_reverse_permutation(64), tcons.bit_reverse_permutation(64))
    pe = np.random.default_rng(0).random(64)
    for a, b in zip(jcons.generate_frozen_bits(64, 20, pe), tcons.generate_frozen_bits(64, 20, pe)):
        assert np.array_equal(a, b)


@pytest.mark.parametrize("N", [2, 8, 256])
def test_polar_transform_equal(N):
    u = np.random.default_rng(N).integers(0, 2, (3, 7, N)).astype(np.int8)
    want = np.asarray(jax_polar_transform(u))
    got = polar_transform(torch.from_numpy(u))
    assert got.dtype == torch.int8 and np.array_equal(want, got.numpy())
    # an involution, and the input is left untouched
    assert np.array_equal(polar_transform(got).numpy(), u)


def test_polar_transform_non_contiguous_input():
    u = np.random.default_rng(1).integers(0, 2, (16, 5)).astype(np.int8)
    want = np.asarray(jax_polar_transform(u.T))
    assert np.array_equal(polar_transform(torch.from_numpy(u).T).numpy(), want)


@pytest.mark.parametrize("frozen_given", [True, False])
def test_polar_encoder_equal(frozen_given):
    N, K = 128, 64
    frozen = jcons.construct_polar_code(N, K, "bhattacharyya", 2.0)[0] if frozen_given else None
    je = jfec.PolarEncoder(N, K, frozen_bits=frozen)
    te = tfec.PolarEncoder(N, K, frozen_bits=frozen, device="cpu")
    assert np.array_equal(je.frozen_bits, te.frozen_bits)
    assert np.array_equal(je.info_bits, te.get_info_bits_positions())
    msgs = np.random.default_rng(2).integers(0, 2, (9, K))
    assert np.array_equal(np.asarray(je.encode(msgs)), te.encode(msgs).numpy())
    assert np.array_equal(np.asarray(je.encode(msgs[0])), te.encode(msgs[0]).numpy())
    assert te.get_code_rate() == je.get_code_rate()
    # the CRC codec is in the package now: K − 8 message bits, the JAX codeword
    jc = jfec.PolarEncoder(N, K, frozen_bits=frozen, use_crc=True)
    tc = tfec.PolarEncoder(N, K, frozen_bits=frozen, use_crc=True, device="cpu")
    assert tc.K_data == jc.K_data == K - 8 and tc.crc_len == 8
    assert np.array_equal(np.asarray(jc.encode(msgs[:, :K - 8])),
                          tc.encode(msgs[:, :K - 8]).numpy())


# -- LDPC matrices and encoder ----------------------------------------------------

@pytest.mark.parametrize("method,n,k,seed", [("regular", 96, 48, 42), ("regular", 504, 252, 42),
                                             ("mackay", 96, 48, 7), ("random", 24, 12, 3)])
def test_ldpc_matrix_equal(method, n, k, seed):
    want = jmatrix.generate_ldpc_matrix(n, k, method=method, dv=3, dc=6, seed=seed)
    got = tmatrix.generate_ldpc_matrix(n, k, method=method, dv=3, dc=6, seed=seed)
    assert np.array_equal(want, got)


def test_gf2_helpers_equal():
    H = jmatrix.regular_construction(48, 24, 3, 6, seed=5)
    assert jmatrix.gf2_rank(H) == tmatrix.gf2_rank(H) == tmatrix.check_matrix_rank(H)
    for a, b in zip(jmatrix.encodable_form(H, 24), tmatrix.encodable_form(H, 24)):
        assert np.array_equal(a, b)
    ja, jb = jmatrix.create_systematic_generator(H)
    ta, tb = tmatrix.create_systematic_generator(H)
    assert (ja is None) == (ta is None)
    if ja is not None:
        assert np.array_equal(ja, ta) and np.array_equal(jb, tb)
    r = np.random.default_rng(6)
    A, b = r.integers(0, 2, (10, 14)), r.integers(0, 2, 10)
    assert np.array_equal(jax_gf2_solve(A, b), gf2_solve(A, b))


@pytest.mark.parametrize("n,k,seed,method", [(96, 48, 42, "regular"), (504, 252, 42, "regular"),
                                             (96, 48, 3, "mackay")])
def test_ldpc_encoder_equal(n, k, seed, method):
    je = jfec.LDPCEncoder(n, k, dv=3, dc=6, seed=seed, method=method)
    te = tfec.LDPCEncoder(n, k, dv=3, dc=6, seed=seed, method=method, device="cpu")
    assert np.array_equal(je.H, te.H) and np.array_equal(je.G, te.G)
    assert np.array_equal(je.info_positions, te.info_positions)
    assert je.use_direct_solving == te.use_direct_solving
    msgs = np.random.default_rng(seed).integers(0, 2, (12, k))
    want = np.asarray(je.encode(msgs))
    got = te.encode(msgs)
    assert got.dtype == torch.int8 and np.array_equal(want, got.numpy())
    assert np.all(te.verify_codeword(got)) and te.verify_codeword(got[0]) is True
    assert np.array_equal(te.extract_message(got).numpy(), msgs)
    assert np.array_equal(np.asarray(je.extract_message(want)), msgs)


def test_ldpc_encoder_given_generator():
    je = jfec.LDPCEncoder(48, 24, dv=3, dc=6, seed=1)
    for G in (je.G, je.G.T):  # (k, n) and (n, k) are both accepted
        te = tfec.LDPCEncoder(48, 24, H=je.H, G=G, device="cpu")
        msgs = np.random.default_rng(0).integers(0, 2, (4, 24))
        assert np.array_equal(np.asarray(je.encode(msgs)), te.encode(msgs).numpy())
