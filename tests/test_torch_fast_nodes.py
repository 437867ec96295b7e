"""The port's SSCL fast list nodes (``node_mode="fast"``) against the JAX
package, on the CPU.

Oracles: the JAX package's XLA fast path (``scanscl._rate1_fast_rank`` /
``_rep_fast_rank`` and ``make_scl_decoder_scan(node_mode="fast",
control_impl="unroll-fused", perm_impl="rank")``) and its float64 twin
``parity/polar_np.scl_decode_fast_np``.  Inputs come from numpy seeds and
include tie-heavy integer frames and zero LLRs.

Tolerances, as in ``test_torch_scl.py``: paths and rank vectors equal; path
metrics within ``1e-12`` in float64 and ``rtol=1e-6`` in float32 (the two
runtimes' ``exp`` / ``log1p`` may differ in the last bit; every other float
operation, the halving-tree sums included, is the same).

The selection kernel's plain version (K7) is held against the probe's own
ground truth at the probe's shape [8, 64, 128].  JAX compiles are the cost
here, so each JAX decoder is built once and the wide sweep of codes goes
against the float64 twin.
"""

import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import polarcode_and_ldpc_tpu as jfec
import polarcode_and_ldpc_tpu_torch as tfec
from polarcode_and_ldpc_tpu.models.polar import scanscl as jscan
from polarcode_and_ldpc_tpu.models.polar.construction import frozen_mask_from_positions
from polarcode_and_ldpc_tpu.parity.polar_np import scl_decode_fast_np
from polarcode_and_ldpc_tpu.sim import pipelines as jpipes
from polarcode_and_ldpc_tpu_torch.core import rng
from polarcode_and_ldpc_tpu_torch.models.polar import scanscl as tscan
from polarcode_and_ldpc_tpu_torch.ops.fastnode_cuda import fastnode_select, fastnode_select_plain
from polarcode_and_ldpc_tpu_torch.ops.scl_cuda import (SCLBodyProgram, SCLMegaPlan,
                                                       build_mega_tables)
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


RTOL = {np.float32: 1e-6, np.float64: 1e-12}
TDT = {np.float32: torch.float32, np.float64: torch.float64}
JDT = {np.float32: jnp.float32, np.float64: jnp.float64}


def mask_of(N, K):
    return frozen_mask_from_positions(N, jfec.construct_polar_code(N, K, "bhattacharyya", 2.0)[0])


def frames(rng_, B, N, dtype):
    """Noisy frames, one with zero LLRs on its first eighth, one of small
    integers (ties everywhere)."""
    llr = (1.0 + 2.0 * rng_.standard_normal((B, N))).astype(dtype)
    llr[0, :N // 8] = 0.0
    llr[1] = rng_.integers(-2, 3, N)
    return llr


def close(got, want, dtype):
    want = np.asarray(want)
    finite = np.isfinite(want)
    assert np.array_equal(np.isfinite(got), finite)
    assert np.array_equal(got[~finite], want[~finite])
    np.testing.assert_allclose(got[finite], want[finite], rtol=RTOL[dtype], atol=0)


# -- the two nodes ------------------------------------------------------------------

@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("node,L,M,case", [
    ("rate1", 8, 16, "random"), ("rate1", 4, 2, "ties"), ("rate1", 8, 4, "phantoms"),
    ("rate1", 1, 8, "random"), ("rep", 8, 32, "random"), ("rep", 4, 8, "ties"),
    ("rep", 2, 2, "phantoms")])
def test_fast_nodes_equal_jax(node, L, M, case, dtype):
    """``_rate1_fast`` / ``_rep_fast`` of the port (frame-major) against the
    JAX rank-algebra nodes (batch-last) on the same numpy inputs."""
    g = np.random.default_rng(L * M + len(case))
    B = 24
    if case == "ties":
        alpha = g.integers(-2, 3, (B, L, M)).astype(dtype)
        pm = -g.integers(0, 3, (B, L)).astype(dtype)
    else:
        alpha = (2 * g.standard_normal((B, L, M))).astype(dtype)
        pm = -np.abs(g.standard_normal((B, L))).astype(dtype)
    if case == "phantoms":
        pm[:, 1:] = -np.inf
    jfn = {"rate1": jscan._rate1_fast_rank, "rep": jscan._rep_fast_rank}[node]
    tfn = {"rate1": tscan._rate1_fast, "rep": tscan._rep_fast}[node]
    jb, jp, jr = jax.jit(lambda a, p: jfn(a, p, L))(jnp.asarray(np.moveaxis(alpha, 0, -1)),
                                                     jnp.asarray(pm.T))
    tb, tp, tr = tfn(torch.from_numpy(alpha), torch.from_numpy(pm), L)
    assert tb.dtype == torch.int8
    assert np.array_equal(tb.numpy(), np.moveaxis(np.asarray(jb), -1, 0))
    close(tp.numpy(), np.asarray(jp).T, dtype)
    if jr is None:
        assert tr is None and L == 1
    else:
        assert np.array_equal(tr.numpy(), np.asarray(jr).T)


def test_tree_sum_is_the_halving_order():
    """The fast nodes add ``x[:h] + x[h:]``, not adjacent pairs: in float32
    the two orders round differently on these values."""
    x = np.array([1e8, 1.0, -1e8, 1.0, 3.0, 1e-3, -3.0, 7.0], np.float32)
    got = tscan._tree_sum(torch.from_numpy(x)).item()
    assert got == np.float32(np.asarray(jscan._tree_sum(jnp.asarray(x[None, :]), axis=1))[0])
    pairs = x.copy()
    while pairs.size > 1:
        pairs = pairs[0::2] + pairs[1::2]
    assert got != pairs[0]


# -- whole decodes ----------------------------------------------------------------

TWIN_CASES = [(64, 32, 16, 1), (64, 40, 16, 8), (64, 30, 64, 2), (128, 70, 32, 4),
              (128, 64, 16, 2), (256, 130, 64, 8), (256, 200, 32, 4)]


@pytest.mark.parametrize("N,K,S,L", TWIN_CASES)
def test_fast_decode_equals_float64_twin(N, K, S, L):
    """Every (N, chunk, L) of the sweep against ``scl_decode_fast_np``: paths
    equal, metrics to 1e-12; the per-chunk kernel control (its plain version
    on the CPU) gives the same result bit for bit."""
    mask = mask_of(N, K)
    llr = frames(np.random.default_rng(N + S + L), 6, N, np.float64)
    dec = tscan.make_scl_decoder_scan(N, mask, L, chunk=S, dtype=torch.float64,
                                      node_mode="fast", device="cpu")
    assert dec.control_impl == "unroll-fused" and not dec.live_width
    u, pm = dec(torch.from_numpy(llr))
    for b in range(llr.shape[0]):
        _, m, up = scl_decode_fast_np(llr[b], mask, L, chunk=S)
        assert np.array_equal(u[b].numpy(), up), b
        close(pm[b].numpy(), m, np.float64)
    f32 = torch.from_numpy(llr.astype(np.float32))
    want = tscan.make_scl_decoder_scan(N, mask, L, chunk=S, node_mode="fast", device="cpu")(f32)
    got = tscan.make_scl_decoder_scan(N, mask, L, chunk=S, node_mode="fast",
                                      control_impl="unroll-kernel", device="cpu")(f32)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


@pytest.mark.parametrize("N,K,S,L,dtype", [(64, 32, 16, 4, np.float64),
                                           (128, 70, 32, 8, np.float32)])
def test_fast_decode_equals_jax_xla_fast_path(N, K, S, L, dtype):
    mask = mask_of(N, K)
    llr = frames(np.random.default_rng(7 * N + L), 16, N, dtype)
    jdec = jax.jit(jscan.make_scl_decoder_scan(N, mask, L, chunk=S, dtype=JDT[dtype],
                                               control_impl="unroll-fused", perm_impl="rank",
                                               node_mode="fast"))
    ju, jm = map(np.asarray, jdec(jnp.asarray(llr)))
    tu, tm = tscan.make_scl_decoder_scan(N, mask, L, chunk=S, dtype=TDT[dtype],
                                         node_mode="fast", device="cpu")(torch.from_numpy(llr))
    assert np.array_equal(tu.numpy(), ju)
    close(tm.numpy(), jm, dtype)


def test_fast_error_rate_matches_exact_statistically():
    """Fast CA-SCL-8 does not degrade error correction measurably: frame
    errors at a waterfall SNR agree with exact CA-SCL within binomial
    noise (N=256, 384 frames at Es/N0 = −1.5 dB)."""
    N, K, L, frames_ = 256, 136, 8, 384
    frozen, _ = tfec.construct_polar_code(N, K, "bhattacharyya", 2.0)
    enc = tfec.PolarEncoder(N, K, frozen_bits=frozen, use_crc=True, device="cpu")
    g = np.random.default_rng(11)
    msgs = g.integers(0, 2, (frames_, enc.K_data))
    std = np.sqrt(1.0 / (2.0 * 10 ** (-1.5 / 10.0)))  # Es/N0 = -1.5 dB
    y = 1.0 - 2.0 * enc.encode(msgs).numpy() + std * g.standard_normal((frames_, N))
    llr = torch.from_numpy((2.0 * y / std ** 2).astype(np.float32))
    fe = {}
    for mode in ("exact", "fast"):
        dec = tfec.SCLDecoder(N, K, L, frozen_bits=frozen, use_crc=True, chunk=64,
                              node_mode=mode, device="cpu")
        fe[mode] = int((dec.decode(llr)[:, :enc.K_data].numpy() != msgs).any(axis=1).sum())
    assert 0 < fe["exact"] < frames_ // 2, fe
    assert fe["exact"] * 0.5 - 8 <= fe["fast"] <= fe["exact"] * 1.5 + 8, fe


# -- the Monte-Carlo step and the serving decoder ------------------------------------

def test_fast_montecarlo_step_equals_jax():
    """The CA-SCL step with fast nodes on 256 frames: per-frame bit errors
    equal JAX's (at most 1 frame in 256 may decode otherwise: the float32
    noise, see ``test_torch_montecarlo.py``)."""
    N, K, L, S, snr = 64, 32, 4, 16, -1.0
    frozen, _ = tfec.construct_polar_code(N, K, "bhattacharyya", 2.0)
    kw = dict(decoder="ca-scl", list_size=L, scl_chunk=S, scl_node_mode="fast")
    jstep = jax.jit(jpipes.make_polar_pipeline(N, K, frozen, snr, **kw))
    tstep = tpipes.make_polar_pipeline(N, K, frozen, snr, device="cpu", rng_x64=True, **kw)
    ids = np.arange(256)
    want = jstep(jax.random.PRNGKey(3), jnp.asarray(ids, jnp.uint32))
    got = tstep(rng.prng_key(3), torch.from_numpy(ids))
    wb, gb = np.asarray(want["bit_errors"]), got["bit_errors"].numpy()
    differ = np.nonzero(wb != gb)[0]
    print(f"frames that differ: {differ.tolist()} of 256")
    assert differ.size <= 1 and wb.sum() > 0


def test_fast_adaptive_decoder_equals_jax():
    """``AdaptiveCASCLDecoder(scl_node_mode="fast")`` on 256 frames where SC
    fails often: outputs and stats equal JAX's."""
    N, K, L = 128, 64, 4
    frozen, _ = tfec.construct_polar_code(N, K, "bhattacharyya", 2.0)
    enc = tfec.PolarEncoder(N, K, frozen_bits=frozen, use_crc=True, device="cpu")
    g = np.random.default_rng(21)
    msgs = g.integers(0, 2, (256, enc.K_data))
    std = np.sqrt(1.0 / (2.0 * 10 ** (-1.0 / 10.0)))
    y = 1.0 - 2.0 * enc.encode(msgs).numpy() + std * g.standard_normal((256, N))
    llr = (2.0 * y / std ** 2).astype(np.float32)
    jdec = jfec.AdaptiveCASCLDecoder(N, K, list_size=L, frozen_bits=frozen, fallback_batch=32,
                                     scl_node_mode="fast")
    tdec = tfec.AdaptiveCASCLDecoder(N, K, list_size=L, frozen_bits=frozen, fallback_batch=32,
                                     scl_node_mode="fast", device="cpu")
    want, wstats = jdec.decode(jnp.asarray(llr), return_stats=True)
    got, stats = tdec.decode(torch.from_numpy(llr), return_stats=True)
    assert stats == {k: (float(v) if k == "sc_pass_rate" else int(v)) for k, v in wstats.items()}
    assert stats["scl_fallbacks"] > 0
    assert np.array_equal(got.numpy(), np.asarray(want))


# -- the path's constraints ----------------------------------------------------------

def test_fast_mode_constraints():
    mask = mask_of(64, 32)
    with pytest.raises(ValueError, match="mega"):  # the one-launch decode has no fast nodes
        tscan.make_scl_decoder_scan(64, mask, 4, chunk=16, node_mode="fast",
                                    control_impl="mega", device="cpu")
    sched = tscan.build_scl_schedule(64, mask, 4, 16)
    with pytest.raises(ValueError, match="fast"):
        SCLMegaPlan(sched, "fast")
    with pytest.raises(ValueError, match="fast"):
        build_mega_tables(sched, [SCLBodyProgram(f, 4, "fast") for f in sched.unique_flags])
    with pytest.raises(ValueError, match="live_width"):
        tscan.make_scl_decoder_scan(64, mask, 4, chunk=16, node_mode="fast", live_width=True,
                                    device="cpu")
    with pytest.raises(ValueError, match="node_mode"):
        tscan.make_scl_decoder_scan(64, mask, 4, chunk=16, node_mode="fastest", device="cpu")
    mask256 = mask_of(256, 128)
    with pytest.warns(UserWarning, match="small-list serving mode"):
        tscan.make_scl_decoder_scan(256, mask256, 32, chunk=64, node_mode="fast", device="cpu")
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        tscan.make_scl_decoder_scan(256, mask256, 16, chunk=64, node_mode="fast", device="cpu")
        tscan.make_scl_decoder_scan(256, mask256, 32, chunk=64, device="cpu")


# -- K7, the rate-1 node's selection ---------------------------------------------------

def test_fastnode_select_plain_equals_probe_ground_truth():
    """At the probe's shape and input (``tools/mosaic_fastnode_probe.py``:
    L, S, B = 8, 64, 128, K = 7): indices and magnitudes are a numpy stable
    argsort's, the penalty is the probe's tree sum of ``logaddexp(0, −|a|)``
    (JAX, float32) to ``rtol=1e-6``.  A CPU tensor takes the plain version."""
    L, S, B, K = 8, 64, 128, 7
    a = (np.random.default_rng(0).standard_normal((L, S, B)) * 2).astype(np.float32)
    mags, idx, pen = fastnode_select(torch.from_numpy(a), K)
    assert (mags.shape, idx.shape, pen.shape) == ((L, K, B), (L, K, B), (L, 1, B))
    assert idx.dtype == torch.int32
    order = np.argsort(np.abs(a), axis=1, kind="stable")[:, :K]
    assert np.array_equal(idx.numpy(), order)
    assert np.array_equal(mags.numpy(), np.take_along_axis(np.abs(a), order, axis=1))
    want = jax.jit(lambda x: jscan._tree_sum(
        jnp.logaddexp(jnp.zeros_like(x), -jnp.abs(x)), axis=1))(jnp.asarray(a))
    np.testing.assert_allclose(pen.numpy()[:, 0, :], np.asarray(want), rtol=1e-6, atol=0)
    # tie-heavy integers: ties go to the lower position, as the stable sort's
    q = np.random.default_rng(1).integers(-2, 3, (L, S, B)).astype(np.float32)
    _, qidx, _ = fastnode_select_plain(torch.from_numpy(q), K)
    assert np.array_equal(qidx.numpy(), np.argsort(np.abs(q), axis=1, kind="stable")[:, :K])
