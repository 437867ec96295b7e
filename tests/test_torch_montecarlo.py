"""The ported path as a whole: the JAX Monte-Carlo step and engine against the
port's on the same key and frame ids (N=128 polar SC, n=96 LDPC).

JAX runs as the repo's tests run it (CPU, x64), so the port draws its message
bits with ``rng_x64=True``.  Integer randomness is equal bit for bit; the
float32 noise agrees to 1e-6 (``erf_inv``, see ``test_torch_rng.py``), so a
frame whose LLRs sit on a decision boundary may decode otherwise: at most 1
frame in 256 may differ, and the test prints which.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import polarcode_and_ldpc_tpu as jfec
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


N, K = 128, 64
POLAR_SNR = -1.0   # FER ≈ 0.3 at this size: errors to count in 256 frames
LDPC_SNR = -1.0
FRAMES = 256


@pytest.fixture(scope="module")
def polar():
    frozen, _ = tfec.construct_polar_code(N, K, "bhattacharyya", 2.0)
    jstep = jax.jit(jpipes.make_polar_pipeline(N, K, frozen, POLAR_SNR, decoder="sc"))
    tstep = tpipes.make_polar_pipeline(N, K, frozen, POLAR_SNR, decoder="sc",
                                       device="cpu", rng_x64=True)
    return frozen, jstep, tstep


@pytest.fixture(scope="module")
def ldpc():
    enc = tfec.LDPCEncoder(96, 48, dv=3, dc=6, seed=42, device="cpu")
    out = {}
    for name, kw in (("bp", {}), ("nms", {"normalization": 0.75})):
        jstep = jax.jit(jpipes.make_ldpc_pipeline(
            enc.H, enc.G, LDPC_SNR, decoder=name, max_iter=10,
            message_idx=enc.info_positions, **kw))
        tstep = tpipes.make_ldpc_pipeline(
            enc.H, enc.G, LDPC_SNR, decoder=name, max_iter=10,
            message_idx=enc.info_positions, device="cpu", rng_x64=True, **kw)
        out[name] = (jstep, tstep)
    return enc, out


def _compare_steps(jstep, tstep, seed, start, with_iters):
    ids = np.arange(start, start + FRAMES)
    want = jstep(jax.random.PRNGKey(seed), jnp.asarray(ids, jnp.uint32))
    got = tstep(rng.prng_key(seed), torch.from_numpy(ids))
    wb, gb = np.asarray(want["bit_errors"]), got["bit_errors"].numpy()
    assert gb.dtype == np.int32 and got["frame_error"].dtype == torch.bool
    differ = np.nonzero(wb != gb)[0]
    if with_iters:
        differ = np.union1d(differ, np.nonzero(
            np.asarray(want["iterations"]) != got["iterations"].numpy())[0])
    print(f"frames that differ: {differ.tolist()} of {FRAMES}")
    assert differ.size <= 1, differ
    same = np.setdiff1d(np.arange(FRAMES), differ)
    assert np.array_equal(np.asarray(want["frame_error"])[same], got["frame_error"].numpy()[same])
    assert wb.sum() > 0  # the comparison saw errors, not two silent decoders
    return differ


def test_step_messages_and_llrs_equal_jax(polar):
    """The message bits of a chunk are equal; the LLRs agree to the float32
    noise tolerance (1e-6 on the noise → 2e-5·σ⁻¹ on LLR = 2y/σ²)."""
    frozen, _, _ = polar
    seen = {}

    def spy(tag, fn):
        def wrapped(*args):
            out = fn(*args)
            seen[tag] = np.asarray(out)
            return out
        return wrapped

    jchan = jpipes._awgn_channel_fn(POLAR_SNR)
    jstep = jpipes.make_montecarlo_step(
        K, spy("jmsg", lambda m: m), spy("jllr", jchan),
        lambda llr: (jnp.zeros((llr.shape[0], K), jnp.int8), {}))
    tchan = tpipes.make_channel_fn("awgn", POLAR_SNR)
    tstep = tpipes.make_montecarlo_step(
        K, spy("tmsg", lambda m: m), spy("tllr", tchan),
        lambda llr: (torch.zeros((llr.shape[0], K), dtype=torch.int8), {}), rng_x64=True)
    ids = np.arange(1000, 1000 + FRAMES)
    # the channel sees [B, K] "codewords" here (identity encoder)
    want = jstep(jax.random.PRNGKey(3), jnp.asarray(ids, jnp.uint32))
    got = tstep(rng.prng_key(3), torch.from_numpy(ids))
    assert seen["tmsg"].dtype == np.int8 and np.array_equal(seen["jmsg"], seen["tmsg"])
    np.testing.assert_allclose(seen["tllr"], seen["jllr"], rtol=0, atol=1e-5)
    # with an all-zero "decoder" the error count is the message weight: equal
    assert np.array_equal(np.asarray(want["bit_errors"]), got["bit_errors"].numpy())


@pytest.mark.parametrize("seed,start", [(0, 0), (5, 7000)])
def test_polar_step_equals_jax(polar, seed, start):
    _, jstep, tstep = polar
    _compare_steps(jstep, tstep, seed, start, with_iters=False)


@pytest.mark.parametrize("name", ["bp", "nms"])
def test_ldpc_step_equals_jax(ldpc, name):
    _, steps = ldpc
    _compare_steps(*steps[name], seed=1, start=512, with_iters=True)


def test_runtime_snr_step_equals_fixed_snr(polar):
    frozen, _, tstep = polar
    rt = tpipes.make_polar_pipeline(N, K, frozen, None, decoder="sc", device="cpu", rng_x64=True)
    assert rt.runtime_snr and not tstep.runtime_snr
    ids = torch.arange(64)
    a = tstep(rng.prng_key(2), ids)
    b = rt(rng.prng_key(2), ids, POLAR_SNR)
    assert (a["bit_errors"] != b["bit_errors"]).sum() <= 1  # σ computed in f32 on the device


def _counters(res):
    return (res.frames, res.bit_errors, res.frame_errors, res.total_iterations,
            res.iteration_frames)


def test_engine_early_stop_equals_jax(polar):
    """Exact crossing: frames counted in order, the crossing frame included."""
    frozen, _, tstep = polar
    jstep = jpipes.make_polar_pipeline(N, K, frozen, POLAR_SNR, decoder="sc")
    want = jmc.MonteCarloSimulator(jstep, K, chunk_frames=64).run(FRAMES, max_errors=20, seed=0)
    got = tmc.MonteCarloSimulator(tstep, K, chunk_frames=64).run(FRAMES, max_errors=20, seed=0)
    assert got.frame_errors == 20 and got.frames < FRAMES
    assert _counters(got) == _counters(want)
    assert got.ber == want.ber and got.fer == want.fer
    assert set(got.to_dict()) == set(want.to_dict())
    assert got.ber_confidence() == want.ber_confidence()


def test_engine_ldpc_iterations_equal_jax(ldpc):
    enc, steps = ldpc
    jstep = jpipes.make_ldpc_pipeline(enc.H, enc.G, LDPC_SNR, decoder="nms", max_iter=10,
                                      normalization=0.75, message_idx=enc.info_positions)
    want = jmc.MonteCarloSimulator(jstep, 48, chunk_frames=64).run(200, seed=4)
    got = tmc.MonteCarloSimulator(steps["nms"][1], 48, chunk_frames=64).run(200, seed=4)
    assert got.frames == 200  # a partial last chunk is masked on the host
    assert _counters(got) == _counters(want)
    assert got.avg_iterations == want.avg_iterations > 1.0


@pytest.mark.parametrize("max_errors", [None, 15])
@pytest.mark.parametrize("which", ["polar", "ldpc"])
def test_engine_invariants(polar, ldpc, which, max_errors):
    """Counters do not depend on chunking, dispatch batching or reduction
    mode (the global-frame-id invariant of ``core/rng.py``)."""
    step, k = (polar[2], K) if which == "polar" else (ldpc[1]["nms"][1], 48)
    ref = tmc.MonteCarloSimulator(step, k, chunk_frames=200).run(200, max_errors, seed=7)
    variants = {
        "4x50": dict(chunk_frames=50),
        "3x64 + partial": dict(chunk_frames=64),
        "chunks_per_dispatch=3": dict(chunk_frames=32, chunks_per_dispatch=3),
        "scalar": dict(chunk_frames=64, reduction="scalar"),
        "scalar, chunks_per_dispatch=2": dict(chunk_frames=32, reduction="scalar",
                                              chunks_per_dispatch=2),
    }
    for label, kw in variants.items():
        res = tmc.MonteCarloSimulator(step, k, **kw).run(200, max_errors, seed=7)
        assert _counters(res) == _counters(ref), label
    if max_errors is not None:
        assert ref.frame_errors == max_errors and ref.frames < 200
    assert ref.frame_errors > 0


@pytest.mark.parametrize("reduction", ["per_frame", "scalar"])
def test_checkpoint_resume(polar, tmp_path, reduction):
    step = polar[2]
    straight = tmc.MonteCarloSimulator(step, K, chunk_frames=32, reduction=reduction).run(
        FRAMES, max_errors=40, seed=9)
    ck = tmp_path / "nested" / "mc.json"
    sim = tmc.MonteCarloSimulator(step, K, chunk_frames=32, reduction=reduction)
    part = sim.run(96, seed=9, checkpoint_path=ck, checkpoint_every_chunks=1)
    assert part.frames == 96 and ck.exists()
    resumed = sim.run(FRAMES, max_errors=40, seed=9, checkpoint_path=ck)
    assert _counters(resumed) == _counters(straight)
    # a finished checkpoint that already crossed the threshold returns as it is
    again = sim.run(FRAMES, max_errors=40, seed=9, checkpoint_path=ck)
    assert _counters(again) == _counters(straight)
    # another seed ignores the file
    other = sim.run(64, seed=10, checkpoint_path=tmp_path / "nested" / "mc.json")
    assert other.frames == 64


def test_checkpoint_file_is_readable_by_the_jax_engine(polar, tmp_path):
    """Same JSON schema on both sides: a run checkpointed by the port resumes
    under the JAX engine to the JAX engine's own straight result."""
    frozen, _, tstep = polar
    jstep = jpipes.make_polar_pipeline(N, K, frozen, POLAR_SNR, decoder="sc")
    ck = tmp_path / "mc.json"
    tmc.MonteCarloSimulator(tstep, K, chunk_frames=64).run(128, seed=0, checkpoint_path=ck)
    jsim = jmc.MonteCarloSimulator(jstep, K, chunk_frames=64)
    resumed = jsim.run(FRAMES, seed=0, checkpoint_path=ck)
    straight = jmc.MonteCarloSimulator(jstep, K, chunk_frames=64).run(FRAMES, seed=0)
    assert _counters(resumed) == _counters(straight)


def test_simulator_device_defaults():
    frozen, _ = tfec.construct_polar_code(32, 16, "bhattacharyya", 2.0)
    step = tpipes.make_polar_pipeline(32, 16, frozen, 3.0, device="cpu")
    assert tmc.MonteCarloSimulator(step, 16).device.type == "cpu"  # follows the step
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tmc.MonteCarloSimulator(lambda k, i: {}, 16)  # no step device → "cuda"
    res = tmc.MonteCarloSimulator(step, 16, chunk_frames=8).run(0)
    assert res.frames == 0 and res.ber == 0.0 and res.throughput_mbps == 0.0
