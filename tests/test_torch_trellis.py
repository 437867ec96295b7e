"""The trellis twins (``impl="scan"``) of the SC and SCL decoders and their
primitives (``schedule.py``, ``trellis.py``) against the JAX package (CPU;
JAX in x64 as ``conftest.py`` sets it).

Tolerances: schedules and trellis planes equal; SC bits equal in float32 and
float64; SCL paths equal, metrics within ``rtol=1e-6`` in float32 and
``1e-12`` in float64 (the two runtimes' ``exp`` / ``log1p``), −inf phantoms
at the same slots.  The twins are also held to the port's own decoders: the
exact recursive SC program and the chunked list decoder give the same bits
and paths.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from polarcode_and_ldpc_tpu.models.polar import schedule as jschedule
from polarcode_and_ldpc_tpu.models.polar import trellis as jtrellis
from polarcode_and_ldpc_tpu.models.polar.sc import make_sc_decoder as jax_sc
from polarcode_and_ldpc_tpu.models.polar.scl import make_scl_decoder as jax_scl
from polarcode_and_ldpc_tpu_torch.cli import throughput as tthroughput_cli
from polarcode_and_ldpc_tpu_torch.models.polar import schedule as tschedule
from polarcode_and_ldpc_tpu_torch.models.polar import trellis as ttrellis
from polarcode_and_ldpc_tpu_torch.models.polar.construction import (construct_polar_code,
                                                                    frozen_mask_from_positions)
from polarcode_and_ldpc_tpu_torch.models.polar.fastsc import make_sc_decoder_unrolled
from polarcode_and_ldpc_tpu_torch.models.polar.sc import SCDecoder, make_sc_decoder
from polarcode_and_ldpc_tpu_torch.models.polar.scl import (CASCLDecoder, SCLDecoder,
                                                           make_scl_decoder)

TORCH = {jnp.float32: torch.float32, jnp.float64: torch.float64}
RTOL = {jnp.float32: 1e-6, jnp.float64: 1e-12}


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


def llrs(B, N, seed, ties=0):
    """Gaussian LLRs around a mean of 1; the first ``ties`` rows are rounded
    to integers (ties and zeros)."""
    x = np.random.default_rng(seed).normal(1.0, 2.0, (B, N))
    x[:ties] = np.round(x[:ties])
    return x


# -- schedule and trellis primitives -----------------------------------------------------

@pytest.mark.parametrize("N", [2, 16, 128, 1024])
def test_build_schedule_equal_jax(N):
    mask = np.random.default_rng(N).random(N) < 0.5
    want = jschedule.build_schedule(N, mask)
    got = tschedule.build_schedule(N, mask)
    assert (got.N, got.n) == (want.N, want.n)
    for name in ("leaf", "frozen", "llr_active", "bit_active"):
        a, b = getattr(got, name), getattr(want, name)
        assert a.dtype == b.dtype and np.array_equal(a, b), name


@pytest.mark.parametrize("dtype", [jnp.float32, jnp.float64])
def test_trellis_steps_equal_jax(dtype):
    """Every primitive on random ``[2, 3, n+1, N]`` planes at every leaf of
    an N=32 schedule: the LLR stages, the leaf read, the leaf write and the
    partial-sum propagation, step after step."""
    N, n = 32, 5
    rng = np.random.default_rng(1)
    L0 = rng.normal(0.0, 2.0, (2, 3, n + 1, N)).astype(dtype)
    L0[0, 0, 0, ::4] = -0.0
    B0 = rng.integers(0, 2, (2, 3, n + 1, N)).astype(np.int8)
    sched = tschedule.build_schedule(N, np.zeros(N, bool))
    jL, jB = jnp.asarray(L0), jnp.asarray(B0)
    j_update, j_read, j_write, j_propagate = (jax.jit(f) for f in (
        jtrellis.update_llr_columns, jtrellis.leaf_llr, jtrellis.set_leaf_bit,
        jtrellis.propagate_bits))
    tL, tB = torch.from_numpy(L0.copy()), torch.from_numpy(B0.copy())
    for s in range(n):
        x = rng.normal(size=(3, N)).astype(dtype)
        assert np.array_equal(ttrellis.xor_shuffle(torch.from_numpy(x), 1 << s).numpy(),
                              np.asarray(jtrellis.xor_shuffle(jnp.asarray(x), 1 << s)))
    for i in range(N):
        l = int(sched.leaf[i])
        jL = j_update(jL, jB, jnp.int32(l), jnp.asarray(sched.llr_active[i]))
        ttrellis.update_llr_columns(tL, tB, l, sched.llr_active[i])
        assert np.array_equal(tL.numpy(), np.asarray(jL)), i
        assert np.array_equal(ttrellis.leaf_llr(tL, l).numpy(),
                              np.asarray(j_read(jL, jnp.int32(l))))
        bit = (rng.random((2, 3)) < 0.5).astype(np.int8)
        jB = j_write(jB, jnp.int32(l), jnp.asarray(bit))
        ttrellis.set_leaf_bit(tB, l, torch.from_numpy(bit))
        jB = j_propagate(jB, jnp.int32(l), jnp.asarray(sched.bit_active[i]))
        ttrellis.propagate_bits(tB, l, sched.bit_active[i])
        assert np.array_equal(tB.numpy(), np.asarray(jB)), i


# -- SC: impl="scan" ---------------------------------------------------------------------

@pytest.mark.parametrize("N", [32, 64])
@pytest.mark.parametrize("dtype", [jnp.float32, jnp.float64])
def test_sc_scan_equal_jax(N, dtype):
    """Bit for bit against JAX's ``impl="scan"``, integer ties included."""
    mask = mask_of(N, N // 2)
    x = llrs(64, N, seed=N, ties=16)
    want = np.asarray(jax.jit(jax_sc(N, mask, dtype, impl="scan"))(x))
    got = make_sc_decoder(N, mask, TORCH[dtype], impl="scan", device="cpu")(torch.from_numpy(x))
    assert got.dtype == torch.int8 and np.array_equal(got.numpy(), want)


@pytest.mark.parametrize("N,K", [(16, 5), (128, 64), (256, 100)])
def test_sc_scan_equal_exact_recursion(N, K):
    """The twin against the port's recursive decoder with its exact node
    program (the program the SC kernel runs with ``fast_nodes=False``), on
    Gaussian and integer-tie LLRs in float32 and float64: equal bits."""
    mask = mask_of(N, K)
    x = llrs(64, N, seed=K, ties=32)
    for dtype in (torch.float32, torch.float64):
        t = torch.from_numpy(x).to(dtype)
        got = make_sc_decoder(N, mask, dtype, impl="scan", device="cpu")(t)
        assert torch.equal(got, make_sc_decoder_unrolled(N, mask, dtype, fast_nodes=False)(t))


def test_sc_decoder_class_takes_scan():
    N, K = 64, 32
    frozen, _ = construct_polar_code(N, K, "bhattacharyya", 2.0)
    x = torch.from_numpy(llrs(8, N, seed=3)).to(torch.float32)
    dec = SCDecoder(N, K, frozen_bits=frozen, impl="scan", device="cpu")
    assert dec.impl == "scan"
    want = SCDecoder(N, K, frozen_bits=frozen, device="cpu")
    assert torch.equal(dec.decode(x), want.decode(x))
    assert torch.equal(dec.decode(x[0]), want.decode(x[0]))  # one frame [N]
    assert dec.decode_full(x).shape == (8, N)


# -- SCL: impl="scan" --------------------------------------------------------------------

def check_paths_and_metrics(got, want, dtype):
    u, pm = got
    wu, wpm = (np.asarray(a) for a in want)
    assert u.dtype == torch.int8 and np.array_equal(u.numpy(), wu)
    pm = pm.numpy()
    assert np.array_equal(np.isneginf(pm), np.isneginf(wpm))
    fin = np.isfinite(wpm)
    np.testing.assert_allclose(pm[fin], wpm[fin], rtol=RTOL[dtype], atol=0)


@pytest.mark.parametrize("N", [32, 64])
@pytest.mark.parametrize("dtype", [jnp.float32, jnp.float64])
def test_scl_scan_equal_jax(N, dtype):
    """L=4: paths equal to JAX's ``impl="scan"``; metrics within rtol."""
    mask = mask_of(N, N // 2)
    x = llrs(32, N, seed=N + 1, ties=8)
    want = jax.jit(jax_scl(N, mask, 4, dtype, impl="scan"))(x)
    got = make_scl_decoder(N, mask, 4, TORCH[dtype], impl="scan", device="cpu")(
        torch.from_numpy(x))
    check_paths_and_metrics(got, want, dtype)


def test_scl_scan_ties_and_phantoms_equal_jax():
    """L=8 on N=16 with 5 info bits: at the first two prunes −inf phantom
    slots survive and tie among themselves; integer LLRs (all 0 or all 1
    in two frames) tie real candidates.  The stable descending sort keeps
    JAX's order."""
    N = 16
    mask = np.ones(N, bool)
    mask[[7, 11, 13, 14, 15]] = False
    x = np.round(np.random.default_rng(9).normal(0.5, 1.5, (24, N)))
    x[0] = 0.0
    x[1] = 1.0
    want = jax.jit(jax_scl(N, mask, 8, jnp.float64, impl="scan"))(x)
    got = make_scl_decoder(N, mask, 8, torch.float64, impl="scan", device="cpu")(
        torch.from_numpy(x))
    check_paths_and_metrics(got, want, jnp.float64)
    # with only 2 info bits every decode keeps 4 real paths and 4 phantoms
    mask[[13, 14, 15]] = True
    want = jax.jit(jax_scl(N, mask, 8, jnp.float64, impl="scan"))(x)
    got = make_scl_decoder(N, mask, 8, torch.float64, impl="scan", device="cpu")(
        torch.from_numpy(x))
    check_paths_and_metrics(got, want, jnp.float64)
    assert (np.isneginf(got[1].numpy()).sum(axis=1) == 4).all()


@pytest.mark.parametrize("N,K,L", [(64, 32, 4), (128, 60, 8), (256, 128, 2)])
def test_scl_scan_equal_chunked(N, K, L):
    """Paths equal to the port's chunked decoder on the same input (float32
    and float64), metrics within rtol."""
    mask = mask_of(N, K)
    x = llrs(32, N, seed=K, ties=8)
    for dtype, rtol in ((torch.float32, 1e-6), (torch.float64, 1e-12)):
        t = torch.from_numpy(x).to(dtype)
        u, pm = make_scl_decoder(N, mask, L, dtype, impl="scan", device="cpu")(t)
        wu, wpm = make_scl_decoder(N, mask, L, dtype, chunk=16, device="cpu")(t)
        assert torch.equal(u, wu)
        torch.testing.assert_close(pm, wpm, rtol=rtol, atol=0)


def test_scl_decoder_classes_take_scan():
    N, K = 64, 32
    frozen, _ = construct_polar_code(N, K, "bhattacharyya", 2.0)
    x = torch.from_numpy(llrs(16, N, seed=5)).to(torch.float32)
    for cls, kw in ((SCLDecoder, {}), (SCLDecoder, {"use_crc": True}), (CASCLDecoder, {})):
        got = cls(N, K, list_size=4, frozen_bits=frozen, impl="scan", device="cpu", **kw)
        want = cls(N, K, list_size=4, frozen_bits=frozen, device="cpu", **kw)
        assert got.control_impl is None
        assert torch.equal(got.decode(x), want.decode(x))
        assert torch.equal(got.decode_paths(x)[0], want.decode_paths(x)[0])
    with pytest.raises(ValueError, match="fast"):
        make_scl_decoder(N, mask_of(N, K), 4, impl="scan", node_mode="fast", device="cpu")


def test_throughput_cli_runs_the_sc_twin(tmp_path):
    """``throughput --sc-impl scan`` runs the trellis twin."""
    res = tthroughput_cli.main(["--device", "cpu", "--polar-n", "32", "--polar-k", "16",
                                "--batch", "4", "--sc-impl", "scan", "--skip-ldpc",
                                "--output-dir", str(tmp_path)])
    assert res["polar"]["decoding_throughput"] > 0
    assert (tmp_path / "data" / "throughput_results.json").exists()
