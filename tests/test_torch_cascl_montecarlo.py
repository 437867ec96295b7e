"""The CA-SCL slice as a whole: the JAX Monte-Carlo step against the port's on
the same key and frame ids (N=128, K=64, CRC-8, L=4, 256 frames).

JAX runs as the repo's tests run it (CPU, x64), so the port draws its message
bits with ``rng_x64=True``.  The message length is ``K − 8 = 56``: the CRC is
appended by the encoder and errors are counted over the message bits.  Integer
randomness is equal bit for bit; the float32 noise agrees to 1e-6 and the path
metrics to 1e-6 relative, so a frame on a decision boundary may decode
otherwise: at most 1 frame in 256 may differ (none is expected), and the test
prints which.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import polarcode_and_ldpc_tpu_torch as tfec
from polarcode_and_ldpc_tpu.sim import montecarlo as jmc
from polarcode_and_ldpc_tpu.sim import pipelines as jpipes
from polarcode_and_ldpc_tpu_torch.core import rng
from polarcode_and_ldpc_tpu_torch.sim import montecarlo as tmc
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


N, K, L, CRC_LEN = 128, 64, 4, 8
K_MSG = K - CRC_LEN
SNR = -2.0  # FER ≈ 0.2 at this size: errors to count in 256 frames
FRAMES = 256


@pytest.fixture(scope="module")
def steps():
    frozen, _ = tfec.construct_polar_code(N, K, "bhattacharyya", 2.0)
    out = {}
    for dec in ("ca-scl", "scl"):
        jstep = jax.jit(jpipes.make_polar_pipeline(N, K, frozen, SNR, decoder=dec, list_size=L))
        tstep = tpipes.make_polar_pipeline(N, K, frozen, SNR, decoder=dec, list_size=L,
                                           device="cpu", rng_x64=True)
        out[dec] = (jstep, tstep)
    return frozen, out


def _compare(jstep, tstep, seed, start):
    ids = np.arange(start, start + FRAMES)
    want = jstep(jax.random.PRNGKey(seed), jnp.asarray(ids, jnp.uint32))
    got = tstep(rng.prng_key(seed), torch.from_numpy(ids))
    wb, gb = np.asarray(want["bit_errors"]), got["bit_errors"].numpy()
    differ = np.nonzero(wb != gb)[0]
    print(f"frames that differ: {differ.tolist()} of {FRAMES}")
    assert differ.size <= 1, differ
    same = np.setdiff1d(np.arange(FRAMES), differ)
    assert np.array_equal(np.asarray(want["frame_error"])[same], got["frame_error"].numpy()[same])
    assert wb.sum() > 0  # the comparison saw errors, not two silent decoders
    return int(np.asarray(want["frame_error"]).sum())


@pytest.mark.parametrize("seed,start", [(0, 0), (5, 7000)])
def test_cascl_step_equals_jax(steps, seed, start):
    _, both = steps
    errors = _compare(*both["ca-scl"], seed, start)
    assert 0 < errors < FRAMES


def test_scl_step_without_crc_equals_jax(steps):
    _, both = steps
    _compare(*both["scl"], 1, 256)


def test_crc_step_draws_the_shorter_message(steps):
    """With the CRC the keyed randomness draws K − 8 bits per frame, and the
    step counts errors over those; the draw equals the JAX one."""
    seen = {}

    def spy(tag, fn):
        def wrapped(*args):
            out = fn(*args)
            seen[tag] = np.asarray(out)
            return out
        return wrapped

    jstep = jpipes.make_montecarlo_step(
        K_MSG, spy("jmsg", lambda m: m), lambda k, cw, *e: cw.astype(jnp.float32),
        lambda llr: (jnp.zeros((llr.shape[0], K_MSG), jnp.int8), {}), compare_len=K_MSG)
    tstep = tpipes.make_montecarlo_step(
        K_MSG, spy("tmsg", lambda m: m), lambda k, cw, *e: cw.to(torch.float32),
        lambda llr: (torch.zeros((llr.shape[0], K_MSG), dtype=torch.int8), {}),
        compare_len=K_MSG, rng_x64=True)
    ids = np.arange(40, 40 + 64)
    want = jstep(jax.random.PRNGKey(2), jnp.asarray(ids, jnp.uint32))
    got = tstep(rng.prng_key(2), torch.from_numpy(ids))
    assert seen["tmsg"].shape == (64, K_MSG) and np.array_equal(seen["jmsg"], seen["tmsg"])
    assert np.array_equal(np.asarray(want["bit_errors"]), got["bit_errors"].numpy())


@pytest.mark.parametrize("control,body", [("unroll-kernel", None), ("unroll-fused", "cuda")])
def test_kernel_controls_give_the_plain_step_on_the_cpu(steps, control, body):
    """On CPU tensors the kernel wrappers take their plain versions: the step
    through the device-state layout equals the plain step exactly."""
    frozen, both = steps
    other = tpipes.make_polar_pipeline(N, K, frozen, SNR, decoder="ca-scl", list_size=L,
                                       scl_control_impl=control, scl_body_impl=body,
                                       device="cpu", rng_x64=True)
    ids = torch.arange(100, 100 + 128)
    a = both["ca-scl"][1](rng.prng_key(3), ids)
    b = other(rng.prng_key(3), ids)
    assert torch.equal(a["bit_errors"], b["bit_errors"])
    assert torch.equal(a["frame_error"], b["frame_error"])


def _counters(res):
    return (res.frames, res.bit_errors, res.frame_errors, res.total_iterations)


def test_engine_counters_equal_jax_and_invariant(steps):
    frozen, both = steps
    jstep = jpipes.make_polar_pipeline(N, K, frozen, SNR, decoder="ca-scl", list_size=L)
    tstep = both["ca-scl"][1]
    want = jmc.MonteCarloSimulator(jstep, K_MSG, chunk_frames=64).run(FRAMES, max_errors=20, seed=0)
    got = tmc.MonteCarloSimulator(tstep, K_MSG, chunk_frames=64).run(FRAMES, max_errors=20, seed=0)
    assert got.frame_errors == 20 and got.frames < FRAMES
    assert _counters(got) == _counters(want)
    assert got.ber == want.ber and got.fer == want.fer
    for kw in (dict(chunk_frames=50), dict(chunk_frames=32, chunks_per_dispatch=3),
               dict(chunk_frames=64, reduction="scalar")):
        ref = tmc.MonteCarloSimulator(tstep, K_MSG, chunk_frames=200).run(200, seed=7)
        res = tmc.MonteCarloSimulator(tstep, K_MSG, **kw).run(200, seed=7)
        assert _counters(res) == _counters(ref) and ref.frame_errors > 0, kw


def test_cascl_beats_scl_beats_sc_on_the_same_frames(steps):
    """Sanity of the slice: on the same noise the CRC-aided list decoder makes
    fewer frame errors than SC, and the plain list decoder no more than SC."""
    frozen, both = steps
    sc = tpipes.make_polar_pipeline(N, K, frozen, SNR, decoder="sc", device="cpu", rng_x64=True)
    ids = torch.arange(FRAMES)
    fe = {name: int(step(rng.prng_key(0), ids)["frame_error"].sum())
          for name, step in (("sc", sc), ("scl", both["scl"][1]), ("ca-scl", both["ca-scl"][1]))}
    print(fe)
    assert fe["ca-scl"] < fe["sc"] and fe["scl"] <= fe["sc"]
