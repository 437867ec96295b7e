"""CRC codec and CRC-concatenated polar encoder of the port against the JAX
package: equal as data (integers only, no tolerance)."""

import numpy as np
import pytest
import torch

import polarcode_and_ldpc_tpu as jfec
import polarcode_and_ldpc_tpu_torch as tfec
from polarcode_and_ldpc_tpu.models.polar import crc as jcrc
from polarcode_and_ldpc_tpu_torch import convert
from polarcode_and_ldpc_tpu_torch.models.polar import crc as tcrc


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


POLYS = ["CRC-8", "CRC-16", "CRC-24"]


def test_polynomial_table_and_lengths_equal():
    assert tcrc.CRC_POLYNOMIALS == jcrc.CRC_POLYNOMIALS
    for p in POLYS:
        assert tcrc.crc_length(p) == jcrc.crc_length(p)


@pytest.mark.parametrize("poly", POLYS)
def test_scalar_remainder_and_matrices_equal(poly):
    rng = np.random.default_rng(1)
    for n in (1, 7, 40):
        bits = rng.integers(0, 2, n)
        assert tcrc.crc_remainder_scalar(bits, poly) == jcrc.crc_remainder_scalar(bits, poly)
    for n in (5, 56):
        assert np.array_equal(tcrc._crc_matrix(n, poly), jcrc._crc_matrix(n, poly))


@pytest.mark.parametrize("poly", POLYS)
@pytest.mark.parametrize("data_len", [12, 504])
def test_codec_encode_check_equal(poly, data_len):
    rng = np.random.default_rng(data_len)
    jc = jcrc.CRCCodec(data_len, poly)
    tc = tcrc.CRCCodec(data_len, poly, device="cpu")
    assert np.array_equal(np.asarray(jc._enc_matrix), tc.enc_matrix)
    assert np.array_equal(np.asarray(jc._chk_matrix), tc.chk_matrix)
    data = rng.integers(0, 2, (33, data_len)).astype(np.int8)
    want = np.asarray(jc.encode(data))
    got = tc.encode(data)
    assert got.dtype == torch.int8 and np.array_equal(want, got.numpy())
    # corrupt some words, leave others intact; batched [B, L, ·] input too
    noisy = want.copy()
    flips = rng.integers(0, noisy.shape[1], 20)
    noisy[np.arange(20), flips] ^= 1
    assert np.array_equal(np.asarray(jc.check(noisy)), tc.check(noisy).numpy())
    assert tc.check(noisy).numpy()[20:].all() and not tc.check(noisy).numpy()[:20].any()
    stacked = np.stack([noisy, want], axis=1)
    assert np.array_equal(np.asarray(jc.check(stacked)), tc.check(stacked).numpy())
    # the codeword of the bit-serial definition
    r = tcrc.crc_remainder_scalar(data[0], poly)
    n = tc.crc_len
    assert [(r >> (n - 1 - b)) & 1 for b in range(n)] == got[0, data_len:].tolist()


@pytest.mark.parametrize("poly", POLYS + ["CRC-unknown-8"])
def test_functional_forms_equal(poly):
    rng = np.random.default_rng(4)
    data = rng.integers(0, 2, (6, 30)).astype(np.int8)
    want = np.asarray(jcrc.crc_encode(data, poly))
    got = tcrc.crc_encode(data, poly, device="cpu")
    assert np.array_equal(want, got.numpy())
    assert bool(tcrc.crc_check(want[0], poly, device="cpu")) is True
    bad = want.copy()
    bad[:3, 2] ^= 1
    assert np.array_equal(np.asarray(jcrc.crc_check(bad, poly)),
                          tcrc.crc_check(bad, poly, device="cpu").numpy())
    assert jcrc.crc_check(bad[0], poly) is tcrc.crc_check(bad[0], poly, device="cpu") is False


def test_codec_from_numpy_carries_the_jax_matrices():
    jc = jcrc.CRCCodec(24, "CRC-16")
    tc = convert.crc_codec_from_numpy(np.asarray(jc._enc_matrix), np.asarray(jc._chk_matrix),
                                      "CRC-16", device="cpu")
    assert (tc.data_len, tc.crc_len, tc.polynomial) == (24, 16, "CRC-16")
    data = np.random.default_rng(2).integers(0, 2, (9, 24))
    assert np.array_equal(np.asarray(jc.encode(data)), tc.encode(data).numpy())
    # the matrices are carried, not derived: a codec given other matrices uses them
    zero = convert.crc_codec_from_numpy(np.zeros((24, 16), np.int8), np.asarray(jc._chk_matrix),
                                        "CRC-16", device="cpu")
    assert not zero.encode(data).numpy()[:, 24:].any()
    with pytest.raises(ValueError):
        convert.crc_codec_from_numpy(np.zeros((24, 8)), np.zeros((40, 16)), "CRC-16", device="cpu")
    with pytest.raises(ValueError):
        convert.crc_codec_from_numpy(np.zeros(24), np.zeros((40, 16)), "CRC-16", device="cpu")


@pytest.mark.parametrize("poly", ["CRC-8", "CRC-16"])
def test_polar_encoder_with_crc_equal(poly):
    N, K = 128, 64
    frozen = jfec.construct_polar_code(N, K, "bhattacharyya", 2.0)[0]
    je = jfec.PolarEncoder(N, K, frozen_bits=frozen, use_crc=True, crc_polynomial=poly)
    te = tfec.PolarEncoder(N, K, frozen_bits=frozen, use_crc=True, crc_polynomial=poly,
                           device="cpu")
    assert (te.K_data, te.crc_len, te.use_crc) == (je.K_data, je.crc_len, True)
    msgs = np.random.default_rng(8).integers(0, 2, (11, te.K_data))
    assert np.array_equal(np.asarray(je.encode(msgs)), te.encode(msgs).numpy())
    assert np.array_equal(np.asarray(je.encode(msgs[0])), te.encode(msgs[0]).numpy())
    with pytest.raises(AssertionError):
        te.encode(np.zeros((2, K), np.int8))  # K bits is the length WITHOUT a CRC


def test_gf2_product_is_exact_at_the_flagship_length():
    """Row sums reach the message length; float32 holds them exactly."""
    tc = tcrc.CRCCodec(504, "CRC-8", device="cpu")
    ones = np.ones((2, 504), np.int8)
    want = tcrc._crc_matrix(504, "CRC-8").astype(np.int64).sum(axis=0) % 2
    assert np.array_equal(tc.encode(ones).numpy()[0, 504:], want)
