"""The BSC and fading channels of the port against the JAX package, on the CPU:
``core.rng.split`` on per-frame keys and ``core.rng.bernoulli``, ``bsc_transmit``
/ ``bsc_llr`` / ``BSCChannel``, ``fading_apply`` / ``rayleigh_transmit`` /
``rician_transmit`` and their classes, ``make_channel_fn`` of every kind, and
the BSC channel in front of the list decoders.

Tolerances:
* integer randomness (keys, Bernoulli flips, BSC outputs and LLRs) is equal
  bit for bit, with ``jax_enable_x64`` off (float32 uniforms) and on (float64
  uniforms, the port's ``x64=`` / ``rng_x64=``; the classes draw float32);
* the float32 normals differ from JAX's by at most 1e-6 (``erf_inv``, see
  ``test_torch_rng.py``).  Through |h| = sqrt(h_r² + h_i²) (an error of at most
  1e-6) and y = |h|·s + σ·n (at most (1 + σ)·1e-6), the fading LLR 2·y·|h|/σ²
  is held to ``1e-6 · 2/σ² · (|h|·(1 + σ) + |y|)``, with JAX's |h| and y;
* on injected |h| and noise, float64 agrees to 1e-12 relative; float32 to a
  few roundings of the LLR's terms (XLA may contract |h|·s + σ·n under
  ``jit``): 2^-22 · 2|h|/σ² · (|h| + σ|n| + |y|);
* frames decoded from BSC LLRs (all ±c, every sum a tie candidate): the list
  decoder's in float64 every frame equals JAX's; in float32 at most 1 frame
  in 256 may differ (``same_curve``'s bound), because XLA's and torch's
  ``exp`` / ``log1p`` may break an exact path-metric tie otherwise; SC's in
  both at most 1 in 256 (see ``test_bsc_into_decoders_equals_jax``).
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import polarcode_and_ldpc_tpu as jfec
import polarcode_and_ldpc_tpu_torch as tfec
from polarcode_and_ldpc_tpu.channels import bsc as jbsc
from polarcode_and_ldpc_tpu.channels import fading as jfading
from polarcode_and_ldpc_tpu.core.rng import frame_keys as jax_frame_keys
from polarcode_and_ldpc_tpu.sim import pipelines as jpipes
from polarcode_and_ldpc_tpu_torch.channels import bsc as tbsc
from polarcode_and_ldpc_tpu_torch.channels import fading as tfading
from polarcode_and_ldpc_tpu_torch.core import rng
from polarcode_and_ldpc_tpu_torch.sim import pipelines as tpipes


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


B, n = 64, 96


def keys(seed: int, frames: int = B):
    """The same per-frame keys in both packages."""
    return (jax_frame_keys(jax.random.PRNGKey(seed), jnp.arange(frames)),
            rng.frame_keys(rng.prng_key(seed, "cpu"), torch.arange(frames)))


def codewords(seed: int, shape=(B, n)) -> np.ndarray:
    return np.random.default_rng(seed).integers(0, 2, shape).astype(np.int8)


def jax_fading_state(jk, kind: str, k_factor: float = 1.0, dtype=jnp.float32, shape=(n,)):
    """JAX's |h| and standard-normal noise, drawn eagerly with its own key
    tree: per frame for keys ``[B, 2]``, one shaped draw for one key."""
    def draw(k):
        k_h, k_n = jax.random.split(k)
        if kind == "rayleigh":
            h = jfading._rayleigh_mag(k_h, shape, dtype)
        else:
            kr, ki = jax.random.split(k_h)
            scale = math.sqrt(1.0 / (2.0 * (k_factor + 1.0)))
            h_r = (math.sqrt(k_factor / (k_factor + 1.0))
                   + jax.random.normal(kr, shape, dtype) * scale)
            h_i = jax.random.normal(ki, shape, dtype) * scale
            h = jnp.sqrt(h_r * h_r + h_i * h_i)
        return h, jax.random.normal(k_n, shape, dtype)

    h, noise = draw(jk) if jk.ndim == 1 else jax.vmap(draw)(jk)
    return np.asarray(h, np.float64), np.asarray(noise, np.float64)


def assert_fading_llrs(got, want, cw, h, noise, snr_db, delta=1e-6):
    """The fading LLR bound of the module docstring (``delta``: the normals'
    stated tolerance)."""
    std = math.sqrt(1.0 / (2.0 * 10.0 ** (snr_db / 10.0)))
    y = h * (1.0 - 2.0 * cw) + noise * std
    bound = delta * 2.0 / std ** 2 * (h * (1.0 + std) + np.abs(y))
    err = np.abs(np.asarray(got, np.float64) - np.asarray(want, np.float64))
    assert (err <= bound).all(), float((err / bound).max())


# -- keys and Bernoulli draws ------------------------------------------------------

def test_split_of_per_frame_keys_equals_jax():
    jk, tk = keys(1)
    for num in (2, 3):
        want = np.asarray(jax.vmap(lambda k: jax.random.split(k, num))(jk))
        got = rng.key_words(rng.split(tk, num))
        assert got.shape == (B, num, 2) and np.array_equal(got, want)
    # one key [2] → [num, 2], as before
    assert np.array_equal(rng.key_words(rng.split(rng.prng_key(9, "cpu"), 4)),
                          np.asarray(jax.random.split(jax.random.PRNGKey(9), 4)))


@pytest.mark.parametrize("x64", [False, True])
def test_bernoulli_equals_jax(x64):
    jk, tk = keys(2)
    with jax.enable_x64(x64):
        for p in (0.0, 1e-3, 0.1, 0.5, 0.9, 1.0):
            want = np.asarray(jax.vmap(lambda k: jax.random.bernoulli(k, p, (n,)))(jk))
            got = rng.bernoulli(tk, p, n, x64=x64)
            assert got.dtype == torch.bool and np.array_equal(got.numpy(), want), p
    assert torch.equal(rng.bernoulli_half(tk, n, x64=x64),
                       rng.bernoulli(tk, 0.5, n, x64=x64).to(torch.int8))


# -- BSC -------------------------------------------------------------------------

@pytest.mark.parametrize("x64", [False, True])
def test_bsc_transmit_equals_jax(x64):
    """Per-frame keys (the pipelines' ``vmap``) and one key over a batch (a
    shaped draw), bit for bit."""
    jk, tk = keys(3)
    cw = codewords(3)
    with jax.enable_x64(x64):
        for p in (0.05, 0.11, 0.5):
            want = np.asarray(jax.vmap(lambda k, c: jbsc.bsc_transmit(k, c, p))(jk, cw))
            got = tbsc.bsc_transmit(tk, torch.from_numpy(cw), p, x64)
            assert got.dtype == torch.int8 and np.array_equal(got.numpy(), want), p
            want = np.asarray(jbsc.bsc_transmit(jax.random.PRNGKey(5), cw, p))
            got = tbsc.bsc_transmit(rng.prng_key(5, "cpu"), torch.from_numpy(cw), p, x64)
            assert np.array_equal(got.numpy(), want), p
            assert 0 < (got.numpy() != cw).mean() < 2 * p + 0.05


@pytest.mark.parametrize("p", [0.0, 0.1, 0.5, 1.0])
def test_bsc_llr_equals_jax(p):
    """Bit patterns equal, the sign of zero included (p = 0.5 gives ±0.0);
    p ∈ {0, 1} saturates at ±20."""
    bits = codewords(4, (4, 32))
    for jdt, tdt in ((jnp.float32, torch.float32), (jnp.float64, torch.float64)):
        want = np.asarray(jbsc.bsc_llr(bits, p, jdt))
        got = tbsc.bsc_llr(torch.from_numpy(bits), p, tdt).numpy()
        assert got.dtype == want.dtype
        assert np.array_equal(got.view(np.uint8), want.view(np.uint8))
        assert np.isfinite(got).all() and np.abs(got).max() <= 20.0
    if p == 0.5:
        assert (np.signbit(got) == (bits == 1)).all() and not got.any()


def test_channel_classes_equal_jax():
    """The same seed gives the same outputs, call after call: each call
    consumes a split of the channel's key and draws the batch as one flat
    stream (BSC bit for bit; fading LLRs to the bound of the module
    docstring, hard decisions equal).  JAX runs with ``jax_enable_x64`` off,
    so its uniforms and normals are float32 like the classes' own."""
    bits = codewords(5, (6, 40))
    with jax.enable_x64(False):
        jb, tb = jfec.BSCChannel(0.2, seed=7), tfec.BSCChannel(0.2, seed=7, device="cpu")
        fading = [("rayleigh", jfec.RayleighFadingChannel(2.0, seed=7),
                   tfec.RayleighFadingChannel(2.0, seed=7, device="cpu")),
                  ("rician", jfec.RicianFadingChannel(2.0, k_factor=3.0, seed=7),
                   tfec.RicianFadingChannel(2.0, k_factor=3.0, seed=7, device="cpu"))]
        for _ in range(2):
            assert np.array_equal(tb.transmit(bits).numpy(), np.asarray(jb.transmit(bits)))
            assert np.array_equal(tb.transmit(bits, return_llr=True).numpy(),
                                  np.asarray(jb.transmit(bits, return_llr=True)))
            for kind, j, t in fading:
                key = j._key
                want = np.asarray(j.transmit(bits))
                h, noise = jax_fading_state(jax.random.split(key)[1], kind, 3.0, shape=bits.shape)
                assert_fading_llrs(t.transmit(bits).numpy(), want, bits, h, noise, 2.0)
                hard = t.transmit(bits, return_llr=False).numpy()
                assert hard.dtype == np.int8
                assert np.array_equal(hard, np.asarray(j.transmit(bits, return_llr=False)))
                assert np.array_equal(rng.key_words(t._key), np.asarray(j._key))
    assert (repr(tb),) + tuple(repr(t) for _, _, t in fading) == \
        (repr(jb),) + tuple(repr(j) for _, j, _ in fading)
    with pytest.raises(AssertionError):
        tfec.BSCChannel(1.5, device="cpu")


# -- fading ----------------------------------------------------------------------

@pytest.mark.parametrize("snr_db", [-2.0, 3.0])
def test_fading_apply_injected_state(snr_db):
    g = np.random.default_rng(6)
    bits = codewords(6, (16, 64))
    h = np.abs(g.standard_normal((16, 64)))
    noise = g.standard_normal((16, 64))
    want = np.asarray(jfading.fading_apply(bits, snr_db, h, noise, dtype=jnp.float64))
    got = tfading.fading_apply(torch.from_numpy(bits), snr_db, torch.from_numpy(h),
                               torch.from_numpy(noise), dtype=torch.float64).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-12, atol=0)
    # a runtime SNR (a tensor) and the hard decision
    got = tfading.fading_apply(torch.from_numpy(bits), torch.tensor(snr_db, dtype=torch.float64),
                               torch.from_numpy(h), torch.from_numpy(noise),
                               dtype=torch.float64).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-12, atol=0)
    hard = tfading.fading_apply(torch.from_numpy(bits), snr_db, torch.from_numpy(h),
                                torch.from_numpy(noise), False, torch.float64).numpy()
    assert np.array_equal(hard, np.asarray(jfading.fading_apply(bits, snr_db, h, noise, False,
                                                                jnp.float64)))
    # float32, against the chain as XLA compiles it: XLA may contract
    # |h|·s + σ·n into one rounding, so each LLR may differ by a few roundings
    # of its terms, 2^-22 · 2|h|/σ² · (|h| + σ|n| + |y|)
    h32, n32 = h.astype(np.float32), noise.astype(np.float32)
    want = np.asarray(jax.jit(lambda b, x, z: jfading.fading_apply(b, snr_db, x, z))(bits, h32, n32))
    got = tfading.fading_apply(torch.from_numpy(bits), snr_db, torch.from_numpy(h32),
                               torch.from_numpy(n32)).numpy()
    assert got.dtype == np.float32
    std = tfading.awgn_noise_std(snr_db)
    h64, n64 = h32.astype(np.float64), n32.astype(np.float64)
    y = h64 * (1 - 2.0 * bits) + std * n64
    bound = 2.0 ** -22 * 2 * h64 / std ** 2 * (h64 + std * np.abs(n64) + np.abs(y))
    assert (np.abs(got.astype(np.float64) - want) <= bound).all()


@pytest.mark.parametrize("kind", ["rayleigh", "rician"])
@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_fading_transmit_per_frame_keys(kind, dtype):
    """Per-frame keys through the JAX package's key tree; the LLR bound of
    the module docstring (float64: the normals differ by at most 1.2e-12)."""
    jk, tk = keys(7)
    cw = codewords(7)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    snr, kf = 2.0, 3.0
    if kind == "rayleigh":
        want = jax.vmap(lambda k, c: jfading.rayleigh_transmit(k, c, snr, dtype=jdt))(jk, cw)
        got = tfading.rayleigh_transmit(tk, torch.from_numpy(cw), snr, dtype=tdt)
    else:
        want = jax.vmap(lambda k, c: jfading.rician_transmit(k, c, snr, kf, dtype=jdt))(jk, cw)
        got = tfading.rician_transmit(tk, torch.from_numpy(cw), snr, kf, dtype=tdt)
    assert got.dtype == tdt and got.shape == (B, n)
    h, noise = jax_fading_state(jk, kind, kf, jdt)
    assert_fading_llrs(got.numpy(), want, cw, h, noise, snr,
                       1e-6 if dtype == "float32" else 1e-11)


def test_rician_at_k0_is_rayleigh():
    """K = 0: no line of sight, and sqrt(1/2) and 1/sqrt(2) round to the same
    float32 scale, so the LLRs are the port's Rayleigh LLRs bit for bit."""
    _, tk = keys(8)
    cw = torch.from_numpy(codewords(8))
    for snr in (0.0, torch.tensor(4.0)):
        a = tfading.rician_transmit(tk, cw, snr, k_factor=0.0)
        b = tfading.rayleigh_transmit(tk, cw, snr)
        assert torch.equal(a.view(torch.int32), b.view(torch.int32))


# -- the channel functions of the pipelines -----------------------------------------

@pytest.mark.parametrize("kind", ["awgn", "bsc", "rayleigh", "rician"])
def test_make_channel_fn_equals_jax(kind):
    """The JAX channel function under ``jit`` (x64 on, as these tests run
    JAX): at a fixed SNR, and at a runtime SNR passed to the step."""
    jk, tk = keys(9)
    cw = codewords(9)
    kw = dict(crossover_prob=0.07, k_factor=2.0)
    for snr in (1.5, None):
        jf = jpipes.make_channel_fn(kind, snr_db=snr, **kw)
        tf = tpipes.make_channel_fn(kind, snr_db=snr, rng_x64=True, **kw)
        assert tf.runtime_snr == jf.runtime_snr == (snr is None and kind != "bsc")
        extra = (0.5,) if tf.runtime_snr else ()
        want = np.asarray(jax.jit(jf)(jk, jnp.asarray(cw), *map(jnp.float32, extra)))
        got = tf(tk, torch.from_numpy(cw), *extra).numpy()
        assert got.dtype == np.float32 and got.shape == (B, n)
        snr_db = extra[0] if extra else snr
        if kind == "bsc":
            assert np.array_equal(got, want)
        elif kind == "awgn":  # 2/σ² times the normals' 1e-6
            np.testing.assert_allclose(got, want, rtol=0,
                                       atol=4e-6 * 10.0 ** (snr_db / 10.0) + 1e-5)
        else:
            h, noise = jax_fading_state(jk, kind, kw["k_factor"])
            assert_fading_llrs(got, want, cw, h, noise, snr_db)
    with pytest.raises(ValueError, match="unknown channel kind"):
        tpipes.make_channel_fn("erasure")


# -- BSC LLRs into the list decoders --------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_bsc_into_decoders_equals_jax(dtype):
    """CA-SCL-2 (N=64, CRC-8) and SC over BSC p = 0.11 and p = 0.5 (all LLRs
    ±0.0): each frame's bit errors against JAX's, 256 frames a case.  The list
    decoder is held on every frame in float64 and to ``same_curve``'s bound in
    float32 (no frame differed when this was written).  SC's fast nodes sum
    ±c in their own order, and a sum that should be 0 rounds to ±1 ulp in
    float64 in one order and not in another: JAX's own jitted and eager runs
    differ from each other on this input (frame 57 against frames 65, 81 and
    186); the port differs from the jitted run on frame 57 of p = 0.11, so SC
    is held to at most 1 frame in 256."""
    N, K = 64, 32
    frozen, _ = tfec.construct_polar_code(N, K, "bhattacharyya", 2.0)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    ids = np.arange(256)
    for p in (0.11, 0.5):
        for dec in ("ca-scl", "sc"):
            kw = dict(decoder=dec, list_size=2)
            jstep = jpipes.make_polar_pipeline(
                N, K, frozen, None, dtype=jdt, scl_chunk=16,
                channel_fn=jpipes.make_channel_fn("bsc", crossover_prob=p, dtype=jdt), **kw)
            tstep = tpipes.make_polar_pipeline(
                N, K, frozen, None, dtype=tdt, scl_chunk=16, device="cpu", rng_x64=True,
                channel_fn=tpipes.make_channel_fn("bsc", crossover_prob=p, dtype=tdt,
                                                  rng_x64=True), **kw)
            want = jax.jit(jstep)(jax.random.PRNGKey(11), jnp.asarray(ids))
            got = tstep(rng.prng_key(11, "cpu"), torch.from_numpy(ids))
            bad = np.asarray(want["bit_errors"]) != got["bit_errors"].numpy()
            assert int(np.asarray(want["frame_error"]).sum()) > 0, (p, dec)
            limit = 0 if (dec, dtype) == ("ca-scl", "float64") else 1
            assert bad.sum() <= limit, (p, dec, np.nonzero(bad))
