"""Code construction in the port against the JAX package (CPU; JAX in x64 as
``conftest.py`` sets it): the Monte-Carlo (genie-aided SC) polar
construction, the bit-reversal helpers, the channel capacities, the PEG and
banded Gallager LDPC constructions, the girth, the LDPC utilities, the NumPy
construction oracle and ``split_key``.

Tolerances: everything here is equal — integer draws and NumPy float64 code
are the same operations, and the genie LLRs are the same float expressions.
The normals of the Monte-Carlo construction are the accepted exception
(``torch.erfinv`` / the float32 ``erf_inv`` polynomial against XLA's, last
bits): where one flips a leaf's sign the test names the frame and the leaf.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import polarcode_and_ldpc_tpu as jfec
import polarcode_and_ldpc_tpu_torch as tfec
from polarcode_and_ldpc_tpu.channels.awgn import awgn_noise_std
from polarcode_and_ldpc_tpu.core import rng as jrng
from polarcode_and_ldpc_tpu.models.ldpc import matrix as jmatrix
from polarcode_and_ldpc_tpu.models.ldpc import utils as jutils
from polarcode_and_ldpc_tpu.models.polar import construction as jcons
from polarcode_and_ldpc_tpu.oracle import constructions_np as joracle
from polarcode_and_ldpc_tpu.utils.tracing import trace_sc_trellis as jtrace
from polarcode_and_ldpc_tpu_torch.core import rng as trng
from polarcode_and_ldpc_tpu_torch.models.ldpc import matrix as tmatrix
from polarcode_and_ldpc_tpu_torch.models.ldpc import utils as tutils
from polarcode_and_ldpc_tpu_torch.models.polar import construction as tcons
from polarcode_and_ldpc_tpu_torch.oracle import constructions_np as toracle
from polarcode_and_ldpc_tpu_torch.sim import experiments as texp


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


# -- polar: bit reversal, capacities, genie-aided SC -----------------------------------

@pytest.mark.parametrize("num_bits", [3, 10])
def test_bit_reverse_and_array_equal_jax(num_bits):
    vals = np.random.default_rng(num_bits).normal(size=(1 << num_bits, 3))
    for x in range(min(1 << num_bits, 64)):
        assert tcons.bit_reverse(x, num_bits) == jcons.bit_reverse(x, num_bits)
    assert np.array_equal(tcons.bit_reverse_array(vals, num_bits),
                          jcons.bit_reverse_array(vals, num_bits))


@pytest.mark.parametrize("N,snr", [(16, -2.0), (1024, 2.0), (4096, 5.0)])
def test_channel_capacities_equal_jax(N, snr):
    assert np.array_equal(tcons.calculate_channel_capacities(N, snr),
                          jcons.calculate_channel_capacities(N, snr))


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_genie_leaf_llrs_equal_jax(dtype):
    """Equal to JAX's at N=64 (every leaf, every frame), integer ties and
    ±0.0 included."""
    x = np.random.default_rng(7).normal(1.0, 2.0, (16, 64))
    x[:4] = np.round(x[:4])
    x[4, ::3] = -0.0
    x = x.astype(dtype)
    want = np.asarray(jax.jit(jcons.genie_leaf_llrs)(x))
    got = tcons.genie_leaf_llrs(torch.from_numpy(x)).numpy()
    assert got.dtype == want.dtype
    assert np.array_equal(got, want)


def test_genie_leaf_llrs_match_the_trellis():
    """With an all-frozen mask every SC decision bit is 0, so the trellis'
    decision LLRs are the genie LLRs (JAX's own check, against JAX's and the
    port's trellis dumps); equal in float64."""
    llr = np.random.default_rng(42).standard_normal(16) * 2
    got = tcons.genie_leaf_llrs(torch.from_numpy(llr)).numpy()
    for trace in (jtrace, tfec.utils.trace_sc_trellis):
        tr = trace(llr, np.ones(16, bool))
        ref = np.array([s["decision_llr"] for s in sorted(tr["steps"], key=lambda s: s["leaf"])])
        assert np.array_equal(got, ref)


def test_monte_carlo_reliabilities_equal_jax_x64():
    """``monte_carlo_reliabilities(64, 2.0)`` with JAX's defaults (10 chunks
    of 1024 frames): JAX draws float64 normals under x64, the port's
    ``rng_x64=True`` draws the same uniforms through ``torch.erfinv``; the
    error probabilities are equal."""
    want = jcons.monte_carlo_reliabilities(64, 2.0)
    got = tcons.monte_carlo_reliabilities(64, 2.0, device="cpu", rng_x64=True)
    assert np.array_equal(got, want)
    assert got[63] == 0 and got[0] > 0.1


def test_monte_carlo_float32_draws_against_jax():
    """The card's float32 path (JAX's default dtype) against JAX's chunk
    program with float32 normals, chunk by chunk at N=64: the leaves agree to
    float32 rounding of the noise (≤ 4.8e-7 per normal), and a leaf may flip
    sign only where its magnitude is within that rounding of 0 — each such
    (frame, leaf) is named; so far none."""
    N, batch, std = 64, 1024, awgn_noise_std(2.0)
    flips, total = [], np.zeros(N, np.int64)
    genie = jax.jit(jcons.genie_leaf_llrs)
    for i in range(3):
        noise = jax.random.normal(jax.random.fold_in(jax.random.PRNGKey(0), i), (batch, N),
                                  jnp.float32)
        want = np.asarray(genie(2.0 * (1.0 + std * noise) / (std * std)))
        tnoise = trng.draw(lambda k, n: trng.normal(k, n, torch.float32),
                           trng.fold_in(trng.prng_key(0), i), (batch, N))
        got = tcons.genie_leaf_llrs(2.0 * (1.0 + std * tnoise) / (std * std)).numpy()
        assert got.dtype == np.float32
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)
        frame, leaf = np.nonzero((got < 0) != (want < 0))
        flips += [(i * batch + int(f), int(l)) for f, l in zip(frame, leaf)]
        assert all(abs(float(want[f, l])) < 1e-4 for f, l in zip(frame, leaf)), flips
        total += (got < 0).sum(axis=0)
    assert flips == []
    pe = tcons.monte_carlo_reliabilities(N, 2.0, num_frames=3 * batch, device="cpu")
    assert np.array_equal(pe * 3 * batch, total)


def test_monte_carlo_construction_equal_jax():
    """The ``"monte_carlo"`` frozen set equals JAX's (the port's float32
    draws against JAX's float64 ones under x64: the error counts order the
    positions alike); the construction runs on the device asked for and
    raises without a card by default."""
    want = jfec.construct_polar_code(64, 32, "monte_carlo", 2.0)
    got = tfec.construct_polar_code(64, 32, "monte_carlo", 2.0, device="cpu")
    assert all(np.array_equal(g, w) for g, w in zip(got, want))
    assert 63 in got[1] and 0 in got[0]
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tfec.construct_polar_code(64, 32, "monte_carlo", 2.0)
    # the other methods stay on the host and take no device
    assert np.array_equal(tfec.construct_polar_code(64, 32, "dega", 2.0)[0],
                          jfec.construct_polar_code(64, 32, "dega", 2.0)[0])


def test_monte_carlo_construction_from_a_config():
    """A ``PolarCodeConfig(construction="monte_carlo")`` builds its code on
    the experiments' device (``sim/experiments.py``)."""
    cfg = tfec.core.PolarCodeConfig(N=64, K=32, construction="monte_carlo", algorithm="sc")
    sim = tfec.core.SimulationConfig(snr_start=2.0, snr_stop=2.0, snr_step=1.0, num_frames=64,
                                     batch_size=64)
    out = texp.simulate_polar(cfg, sim, device="cpu")
    frozen, _ = tcons.construct_polar_code(64, 32, "monte_carlo", 2.0, device="cpu")
    assert out["config"]["construction"] == "monte_carlo"
    ref = texp.simulate_polar(cfg, sim, frozen=frozen, device="cpu")
    assert out["ber"] == ref["ber"] and out["frames_tested"] == ref["frames_tested"]


def test_polar_public_names():
    for name in ("calculate_channel_capacities", "monte_carlo_reliabilities",
                 "genie_leaf_llrs", "bit_reverse", "bit_reverse_array", "CRC_POLYNOMIALS"):
        assert hasattr(tfec.models.polar, name), name
    assert tfec.models.polar.CRC_POLYNOMIALS == jfec.models.polar.CRC_POLYNOMIALS
    for name in ("calculate_girth", "peg_construction", "calculate_channel_capacities"):
        assert name in tfec.__all__ and hasattr(tfec, name), name


def test_split_key_equal_jax():
    """``core.split_key`` gives JAX's keys, each ``fold_in(key, i)``."""
    for seed, num in ((0, 2), (42, 5), (2 ** 40 + 3, 17)):
        want = np.asarray(jax.random.key_data(jrng.split_key(jax.random.PRNGKey(seed), num)))
        key = trng.prng_key(seed)
        got = tfec.core.split_key(key, num)
        assert np.array_equal(trng.key_words(got), want.astype(np.uint32))
        assert torch.equal(got, trng.fold_in(key, torch.arange(num)))


# -- LDPC: PEG, Gallager, girth, utilities, the construction oracle ---------------------

@pytest.mark.parametrize("n,k,dv", [(24, 12, 3), (96, 48, 3), (504, 252, 3), (130, 65, 4),
                                    (20, 16, 6)])
def test_peg_equal_jax(n, k, dv):
    want = jmatrix.peg_construction(n, k, dv)
    assert np.array_equal(tmatrix.peg_construction(n, k, dv), want)
    assert np.array_equal(tfec.generate_ldpc_matrix(n, k, method="peg", dv=dv), want)


@pytest.mark.parametrize("n,k,dv,dc,seed", [(504, 252, 3, 6, 42), (96, 48, 3, 6, 1),
                                            (120, 60, 4, 8, 7), (96, 48, 3, 6, 0),
                                            (100, 50, 3, 7, 3)])
def test_gallager_equal_jax(n, k, dv, dc, seed, capsys):
    """The banded Gallager H is equal, not merely equivalent: the same
    ``RandomState(seed).permutation`` of ``block.T`` per band; an
    infeasible (n, k, dv, dc) falls back to MacKay as JAX's does."""
    want = jmatrix.generate_ldpc_matrix(n, k, "gallager", dv, dc, seed)
    got = tmatrix.generate_ldpc_matrix(n, k, "gallager", dv, dc, seed)
    assert np.array_equal(got, want)
    out = capsys.readouterr().out
    feasible = (dv * n) % dc == 0 and (n * dv // dc) == n - k
    assert ("using mackay" in out) == (not feasible)
    if feasible:
        assert (got.sum(axis=0) == dv).all() and (got.sum(axis=1) == dc).all()
        # a RandomState passes through as the bands' generator
        assert np.array_equal(
            tmatrix.generate_ldpc_matrix(n, k, "gallager", dv, dc, np.random.RandomState(seed)),
            want)


@pytest.mark.parametrize("method", ["peg", "gallager", "mackay", "regular", "qc"])
def test_girth_equal_jax(method):
    H = jmatrix.generate_ldpc_matrix(96, 48, method, 3, 6, seed=2, z=8)
    assert tmatrix.calculate_girth(H) == jmatrix.calculate_girth(H)
    assert tfec.calculate_girth(H, max_girth=6) == jmatrix.calculate_girth(H, max_girth=6)


def test_girth_of_known_graphs():
    cycle6 = np.array([[1, 1, 0], [0, 1, 1], [1, 0, 1]])  # a 6-cycle
    tree = np.array([[1, 1, 0, 0], [0, 0, 1, 1]])
    for H in (cycle6, tree, np.ones((2, 2), np.int64)):
        assert tmatrix.calculate_girth(H) == jmatrix.calculate_girth(H)
    assert tmatrix.calculate_girth(cycle6) == 6 and tmatrix.calculate_girth(tree) == 64


def test_ldpc_utils_equal_jax():
    H = jmatrix.generate_ldpc_matrix(48, 24, "regular", 3, 6, seed=3)
    rng = np.random.default_rng(4)
    words = rng.integers(0, 2, (5, 48))
    assert tutils.create_tanner_graph(H) == jutils.create_tanner_graph(H)
    assert np.array_equal(tutils.calculate_syndrome(H, words),
                          jutils.calculate_syndrome(H, words))
    enc = tfec.LDPCEncoder(48, 24, H=H, device="cpu")
    cw = enc.encode(rng.integers(0, 2, (3, enc.k))).numpy()
    for word in (cw[0], words[0]):
        assert tutils.check_syndrome(H, word) == jutils.check_syndrome(H, word)
    assert tutils.check_syndrome(H, cw[1])
    a, b = words[1], words[2]
    assert tutils.count_errors(a, b) == jutils.count_errors(a, b)
    assert tutils.hamming_distance(a, b) == jutils.hamming_distance(a, b) == int((a != b).sum())
    assert tfec.models.ldpc.check_syndrome is tutils.check_syndrome


def test_construction_oracle_equal_jax():
    """``oracle/constructions_np.py`` is a copy: every function equal."""
    rng = np.random.default_rng(8)
    assert np.array_equal(toracle.polar_z_log_np(64, 32, 1.0), joracle.polar_z_log_np(64, 32, 1.0))
    for got, want in zip(toracle.polar_construct_np(128, 40, 2.0),
                         joracle.polar_construct_np(128, 40, 2.0)):
        assert np.array_equal(got, want)
    x = rng.integers(0, 2, (6, 10))
    assert np.array_equal(toracle.gaussjordan_np(x), joracle.gaussjordan_np(x))
    for got, want in zip(toracle.gaussjordan_np(x, change=True),
                         joracle.gaussjordan_np(x, change=True)):
        assert np.array_equal(got, want)
    assert np.array_equal(toracle.parity_check_matrix_np(60, 3, 6, seed=9),
                          joracle.parity_check_matrix_np(60, 3, 6, seed=9))
    for got, want in zip(toracle.make_ldpc_np(60, 3, 6, seed=9),
                         joracle.make_ldpc_np(60, 3, 6, seed=9)):
        assert np.array_equal(got, want)
    assert np.array_equal(toracle.logdomain_diff(np.array([1.0, 2.0]), np.array([0.5, 2.0])),
                          joracle.logdomain_diff(np.array([1.0, 2.0]), np.array([0.5, 2.0])))


def test_ldpc_config_and_encoder_take_the_new_methods():
    """An encoder on a PEG or Gallager code encodes valid codewords and its H
    equals JAX's."""
    for method in ("peg", "gallager"):
        enc = tfec.LDPCEncoder(96, 48, dv=3, dc=6, seed=42, method=method, device="cpu")
        assert np.array_equal(enc.H, jmatrix.generate_ldpc_matrix(96, 48, method, 3, 6, seed=42))
        cw = enc.encode(np.random.default_rng(1).integers(0, 2, (4, enc.k))).numpy()
        assert not (cw @ enc.H.T % 2).any()
