"""The port's float64 NumPy twins (``parity/``) and ``trace_sc_trellis``
against the JAX package's, and the port's decoders against its twins.

The twins are copies: every function is held ``np.array_equal`` to JAX's
on the same inputs (``trace_sc_trellis``: L / B with ``equal_nan``).  Once
held, they are the oracle of the wider sweeps below, which need no JAX
compile: the trellis twins (SC and SCL), the exact SC recursion, the chunked
list decoder (paths equal, metrics within 1e-9) and the plain LDPC decoders
(bits and iteration counts equal), all in float64 on the CPU.
"""

import numpy as np
import pytest
import torch

from polarcode_and_ldpc_tpu.parity import channel_np as jchan
from polarcode_and_ldpc_tpu.parity import ldpc_np as jldpc
from polarcode_and_ldpc_tpu.parity import polar_np as jpolar
from polarcode_and_ldpc_tpu.utils.tracing import trace_sc_trellis as jtrace
import polarcode_and_ldpc_tpu_torch as tfec
from polarcode_and_ldpc_tpu_torch.models.polar.construction import (construct_polar_code,
                                                                    frozen_mask_from_positions)
from polarcode_and_ldpc_tpu_torch.models.polar.fastsc import make_sc_decoder_unrolled
from polarcode_and_ldpc_tpu_torch.models.polar.sc import make_sc_decoder
from polarcode_and_ldpc_tpu_torch.models.polar.scl import make_scl_decoder
from polarcode_and_ldpc_tpu_torch.parity import channel_np as tchan
from polarcode_and_ldpc_tpu_torch.parity import ldpc_np as tldpc
from polarcode_and_ldpc_tpu_torch.parity import polar_np as tpolar
from polarcode_and_ldpc_tpu_torch.utils.tracing import trace_sc_trellis as ttrace


@pytest.fixture(autouse=True)
def one_torch_thread():
    """One intra-op thread for the port's side: these tests run thousands of
    small ops, which on one thread cost a fraction of what waking torch's
    thread pool costs on a busy host, and they leave the cores of the other
    test workers alone."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def mask_of(N, K):
    frozen, _ = construct_polar_code(N, K, "bhattacharyya", 2.0)
    return frozen_mask_from_positions(N, frozen)


def same(a, b):
    """Equal values and types, element by element through tuples."""
    if isinstance(a, tuple):
        return isinstance(b, tuple) and len(a) == len(b) and all(map(same, a, b))
    return type(a) is type(b) and np.array_equal(a, b)


@pytest.fixture(scope="module")
def ldpc_code():
    enc = tfec.LDPCEncoder(96, 48, dv=3, dc=6, seed=42, method="mackay", device="cpu")
    rng = np.random.default_rng(3)
    cw = enc.encode(rng.integers(0, 2, (6, enc.k))).numpy()
    llr = tchan.awgn_llr_np(cw, 1.0, rng.standard_normal(cw.shape))
    llr[0, :4] = 0.0  # sign(0) = 0 paths
    return enc, llr


# -- every twin function equal to JAX's -------------------------------------------------

def test_channel_twins_equal_jax():
    rng = np.random.default_rng(1)
    bits = rng.integers(0, 2, (4, 32))
    noise, h = rng.standard_normal((4, 32)), np.abs(rng.standard_normal((4, 32)))
    flips = rng.integers(0, 2, (4, 32))
    for snr in (-2.0, 0.0, 3.5):
        assert tchan.noise_std(snr) == jchan.noise_std(snr)
        for name in ("awgn_llr_np", "awgn_hard_np"):
            assert same(getattr(tchan, name)(bits, snr, noise),
                        getattr(jchan, name)(bits, snr, noise)), name
        assert same(tchan.fading_llr_np(bits, snr, h, noise),
                    jchan.fading_llr_np(bits, snr, h, noise))
    assert same(tchan.bpsk_modulate_np(bits), jchan.bpsk_modulate_np(bits))
    assert same(tchan.bsc_np(bits, flips), jchan.bsc_np(bits, flips))


@pytest.mark.parametrize("poly", ["CRC-8", "CRC-16", "CRC-4"])
def test_polar_encoding_twins_equal_jax(poly):
    rng = np.random.default_rng(2)
    N, K = 64, 40
    _, info = construct_polar_code(N, K, "bhattacharyya", 2.0)
    for _ in range(3):
        u = rng.integers(0, 2, N)
        assert same(tpolar.polar_transform_np(u), jpolar.polar_transform_np(u))
        data = rng.integers(0, 2, 24)
        enc = tpolar.crc_encode_np(data, poly)
        assert same(enc, jpolar.crc_encode_np(data, poly))
        for word in (enc, enc ^ (np.arange(enc.size) == 3)):
            assert same(tpolar.crc_check_np(word, poly), jpolar.crc_check_np(word, poly))
        clen = int(poly.split("-")[1]) if poly in tfec.models.polar.CRC_POLYNOMIALS else 8
        for use_crc in (False, True):
            msg = rng.integers(0, 2, K - (clen if use_crc else 0))
            assert same(tpolar.polar_encode_np(msg, N, info, use_crc, poly),
                        jpolar.polar_encode_np(msg, N, info, use_crc, poly))


@pytest.mark.parametrize("N,K", [(32, 16), (64, 20)])
def test_polar_decoding_twins_equal_jax(N, K):
    """SC, SCL (L = 1, 4) and the fast-node SCL twin, Gaussian and integer
    LLRs (ties and zeros), every output equal."""
    mask = mask_of(N, K)
    rng = np.random.default_rng(N + K)
    llr = rng.normal(0.8, 2.0, (6, N))
    llr[:2] = np.round(llr[:2])
    for x in llr:
        assert same(tpolar.sc_decode_np(x, mask), jpolar.sc_decode_np(x, mask))
        for L in (1, 4):
            assert same(tpolar.scl_decode_np(x, mask, L), jpolar.scl_decode_np(x, mask, L))
        for chunk in (8, N):
            assert same(tpolar.scl_decode_fast_np(x, mask, 4, chunk),
                        jpolar.scl_decode_fast_np(x, mask, 4, chunk))


def test_ldpc_twins_equal_jax(ldpc_code):
    enc, llr = ldpc_code
    H = enc.H
    for x in llr[:3]:
        assert same(tldpc.bp_decode_np(H, x, 8), jldpc.bp_decode_np(H, x, 8))
        assert same(tldpc.bp_decode_np(H, x, 3, early_stop=False),
                    jldpc.bp_decode_np(H, x, 3, early_stop=False))
        for norm, off in ((1.0, 0.0), (0.75, 0.0), (1.0, 0.5)):
            assert same(tldpc.ms_decode_np(H, x, 8, norm, off),
                        jldpc.ms_decode_np(H, x, 8, norm, off))
        for layers in (1, 4):
            assert same(tldpc.layered_ms_decode_np(H, x, 8, 0.75, 0.0, True, layers),
                        jldpc.layered_ms_decode_np(H, x, 8, 0.75, 0.0, True, layers))
    msg = np.random.default_rng(4).integers(0, 2, enc.k)
    G = np.asarray(enc.G)
    assert same(tldpc.ldpc_encode_np(G, msg), jldpc.ldpc_encode_np(G, msg))


def test_trace_sc_trellis_equal_jax():
    N = 32
    mask = mask_of(N, 16)
    llr = np.random.default_rng(6).normal(0.5, 2.0, N)
    llr[::5] = 0.0
    got, want = ttrace(llr, mask), jtrace(llr, mask)
    assert np.array_equal(got["u"], want["u"]) and len(got["steps"]) == N
    for g, w in zip(got["steps"], want["steps"]):
        assert {k: g[k] for k in ("step", "leaf", "frozen", "bit")} == \
            {k: w[k] for k in ("step", "leaf", "frozen", "bit")}
        assert g["decision_llr"] == w["decision_llr"]
        assert np.array_equal(g["L"], w["L"], equal_nan=True)
        assert np.array_equal(g["B"], w["B"], equal_nan=True)
    assert np.array_equal(got["u"], tpolar.sc_decode_np(llr, mask))


# -- the port's decoders against its twins (no JAX compile) ------------------------------

@pytest.mark.parametrize("N,K", [(16, 8), (64, 27), (256, 128)])
def test_sc_decoders_equal_the_twin(N, K):
    """The SC trellis twin and the exact recursion, float64, bit for bit to
    ``sc_decode_np`` on Gaussian and integer-tie LLRs."""
    mask = mask_of(N, K)
    x = np.random.default_rng(K).normal(1.0, 2.0, (24, N))
    x[:8] = np.round(x[:8])
    want = np.stack([tpolar.sc_decode_np(r, mask) for r in x])
    t = torch.from_numpy(x)
    assert np.array_equal(make_sc_decoder(N, mask, torch.float64, impl="scan",
                                          device="cpu")(t).numpy(), want)
    assert np.array_equal(make_sc_decoder_unrolled(N, mask, torch.float64,
                                                   fast_nodes=False)(t).numpy(), want)


@pytest.mark.parametrize("N,K,L", [(16, 8, 2), (64, 32, 8), (128, 64, 4)])
def test_scl_decoders_equal_the_twin(N, K, L):
    """The SCL trellis twin and the chunked decoder, float64: the twin's
    survivor paths in its slot order, metrics within 1e-9."""
    mask = mask_of(N, K)
    x = np.random.default_rng(N + L).normal(0.5, 1.5, (8, N))
    x[0, :3] = 0.0
    x[1] = np.round(x[1])
    ref = [tpolar.scl_decode_np(r, mask, L) for r in x]
    t = torch.from_numpy(x)
    for kw in (dict(impl="scan"), dict(chunk=min(16, N))):
        u, pm = make_scl_decoder(N, mask, L, torch.float64, device="cpu", **kw)(t)
        for i, (_, ref_m, ref_paths) in enumerate(ref):
            assert np.array_equal(u[i].numpy(), ref_paths), (kw, i)
            np.testing.assert_allclose(pm[i].numpy(), ref_m, atol=1e-9)


def test_ldpc_decoders_equal_the_twins(ldpc_code):
    """The plain flooding BP / NMS / OMS and layered NMS decoders, float64:
    bits and iteration counts equal to the twins."""
    enc, llr = ldpc_code
    H = enc.H
    cases = [(tfec.BPDecoder(H, 10, dtype=torch.float64, device="cpu"),
              lambda x: tldpc.bp_decode_np(H, x, 10)),
             (tfec.NMSDecoder(H, 10, 0.75, dtype=torch.float64, device="cpu"),
              lambda x: tldpc.ms_decode_np(H, x, 10, 0.75)),
             (tfec.OMSDecoder(H, 10, 0.5, dtype=torch.float64, device="cpu"),
              lambda x: tldpc.ms_decode_np(H, x, 10, 1.0, 0.5)),
             (tfec.LayeredMSDecoder(H, 10, 0.75, dtype=torch.float64, num_layers=4,
                                    device="cpu"),
              lambda x: tldpc.layered_ms_decode_np(H, x, 10, 0.75, 0.0, True, 4))]
    for dec, twin in cases:
        bits, iters = dec.decode(torch.from_numpy(llr), return_iterations=True)
        for i, x in enumerate(llr):
            rb, ri = twin(x)
            assert np.array_equal(bits[i].numpy(), rb) and int(iters[i]) == ri, (dec, i)
