"""Port RNG (threefry2x32 in torch integer ops) against ``jax.random``.

JAX runs as the repo's own tests run it (CPU, x64 — ``conftest.py``), so the
message bits are the 64-bit-uniform draw (``x64=True`` in the port).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from polarcode_and_ldpc_tpu.core.rng import frame_keys as jax_frame_keys
from polarcode_and_ldpc_tpu_torch.core import rng


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


def _jax_key_words(key):
    return np.asarray(key, np.uint32)


def test_threefry_known_answer():
    # Random123 test vector for threefry2x32, 20 rounds
    as_i32 = lambda v: torch.tensor(v, dtype=torch.int64).to(torch.int32)
    y0, y1 = rng.threefry2x32(as_i32(0x13198a2e), as_i32(0x03707344),
                              as_i32(0x243f6a88), as_i32(0x85a308d3))
    assert (int(y0) & 0xFFFFFFFF, int(y1) & 0xFFFFFFFF) == (0xc4923a9c, 0x483df7a0)


@pytest.mark.parametrize("seed", [0, 7, 42, 2**31 + 5, 2**40 + 3])
def test_prng_key_equals_jax(seed):
    assert np.array_equal(_jax_key_words(jax.random.PRNGKey(seed)),
                          rng.key_words(rng.prng_key(seed)))


@pytest.mark.parametrize("seed,start", [(0, 0), (7, 5), (123, 2**31 - 10), (9, 2**32 - 40)])
def test_frame_keys_equal_jax(seed, start):
    ids = (np.arange(start, start + 64, dtype=np.int64) % (1 << 32)).astype(np.uint32)
    want = _jax_key_words(jax_frame_keys(jax.random.PRNGKey(seed), ids))
    got = rng.key_words(rng.frame_keys(rng.prng_key(seed), torch.from_numpy(ids.astype(np.int64))))
    assert np.array_equal(want, got)


def test_fold_in_chain_and_split_equal_jax():
    key = jax.random.PRNGKey(3)
    tkey = rng.prng_key(3)
    for data in (0, 1, 17, 2**31, 2**32 - 1):
        want = _jax_key_words(jax.random.fold_in(jax.random.fold_in(key, data), 1))
        got = rng.key_words(rng.fold_in(rng.fold_in(tkey, data), 1))
        assert np.array_equal(want, got), data
    assert np.array_equal(_jax_key_words(jax.random.split(key, 7)),
                          rng.key_words(rng.split(tkey, 7)))


@pytest.mark.parametrize("n", [1, 33, 512])
def test_raw_bits_equal_jax(n):
    keys = jax_frame_keys(jax.random.PRNGKey(11), np.arange(16, dtype=np.uint32))
    want = np.asarray(jax.vmap(lambda k: jax.random.bits(k, (n,), jnp.uint32))(keys))
    tkeys = rng.frame_keys(rng.prng_key(11), torch.arange(16))
    got = rng.random_bits32(tkeys, n).numpy().view(np.uint32)
    assert np.array_equal(want, got)


@pytest.mark.parametrize("k", [64, 252])
def test_message_bits_equal_jax(k):
    """The message draw of ``sim.pipelines``: fold_in(frame key, 0) →
    bernoulli(0.5)."""
    assert jax.config.jax_enable_x64  # the mode the port's x64=True mirrors
    fkeys = jax_frame_keys(jax.random.PRNGKey(5), np.arange(100, 164, dtype=np.uint32))
    mkeys = jax.vmap(lambda kk: jax.random.fold_in(kk, 0))(fkeys)
    want = np.asarray(jax.vmap(
        lambda kk: jax.random.bernoulli(kk, 0.5, (k,)).astype(jnp.int8))(mkeys))
    tkeys = rng.fold_in(rng.frame_keys(rng.prng_key(5), torch.arange(100, 164)), 0)
    got = rng.bernoulli_half(tkeys, k, x64=True).numpy()
    assert got.dtype == np.int8 and np.array_equal(want, got)
    # the 32-bit draw is another stream (what JAX gives without x64)
    assert not np.array_equal(want, rng.bernoulli_half(tkeys, k, x64=False).numpy())


def test_bernoulli_32bit_matches_uniform_rule():
    """Without x64 JAX compares a 32-bit uniform with 0.5: reproduce that
    rule from the raw bits (top bit of the word clear ⇔ uniform < 0.5)."""
    tkeys = rng.frame_keys(rng.prng_key(1), torch.arange(8))
    bits = rng.random_bits32(tkeys, 200).numpy().view(np.uint32)
    mant = (bits >> 9) | np.uint32(0x3F800000)
    uniform = mant.view(np.float32) - np.float32(1.0)
    want = (uniform < 0.5).astype(np.int8)
    assert np.array_equal(want, rng.bernoulli_half(tkeys, 200, x64=False).numpy())


def test_normal_f32_close_to_jax():
    """uniform(−1,1) → erf_inv polynomial × √2.  The polynomial is XLA's;
    log1p/sqrt and multiply-add fusion differ in the last bits between the
    two runtimes, hence atol=1e-6 (about two float32 ulps at |x| ≈ 4)."""
    fkeys = jax_frame_keys(jax.random.PRNGKey(2), np.arange(64, dtype=np.uint32))
    nkeys = jax.vmap(lambda kk: jax.random.fold_in(kk, 1))(fkeys)
    want = np.asarray(jax.vmap(lambda kk: jax.random.normal(kk, (2048,), jnp.float32))(nkeys))
    tkeys = rng.fold_in(rng.frame_keys(rng.prng_key(2), torch.arange(64)), 1)
    got = rng.normal(tkeys, 2048).numpy()
    assert got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    assert np.mean(got == want) > 0.9  # most values agree to the bit
    assert abs(got.mean()) < 0.01 and abs(got.std() - 1.0) < 0.01


def test_normal_f64_close_to_jax():
    """float64 goes through ``torch.erfinv`` on a 52-bit uniform: the same
    uniforms, another erf_inv approximation, hence atol=1e-10."""
    nkeys = jax_frame_keys(jax.random.PRNGKey(4), np.arange(16, dtype=np.uint32))
    want = np.asarray(jax.vmap(lambda kk: jax.random.normal(kk, (512,), jnp.float64))(nkeys))
    got = rng.normal(rng.frame_keys(rng.prng_key(4), torch.arange(16)), 512, torch.float64).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-10)


def test_frame_keys_do_not_depend_on_batching():
    key = rng.prng_key(9)
    whole = rng.frame_keys(key, torch.arange(0, 96))
    parts = torch.cat([rng.frame_keys(key, torch.arange(s, s + 32)) for s in (0, 32, 64)])
    assert torch.equal(whole, parts)
