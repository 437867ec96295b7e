"""Port row-layered min-sum against the JAX package: the XLA decoder, the fused
Pallas kernel's layered mode in interpret mode and the float64 NumPy twin;
the layered CUDA kernel's tables and two-pass layer walk through a numpy
emulation; and a Monte-Carlo step of the layered pipeline in both packages.

Min-sum is exact arithmetic (compares, sign products, one multiply by α, one
subtract of β, adds in a fixed order), so every comparison here is on equal
bits and equal iteration counts, in float32 and float64 alike.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import polarcode_and_ldpc_tpu as jfec
import polarcode_and_ldpc_tpu_torch as tfec
from polarcode_and_ldpc_tpu.models.ldpc import layered as jlay
from polarcode_and_ldpc_tpu.models.ldpc.graph import TannerGraph as JaxTannerGraph
from polarcode_and_ldpc_tpu.ops.bp_pallas import make_bp_decoder_pallas
from polarcode_and_ldpc_tpu.parity.ldpc_np import layered_ms_decode_np
from polarcode_and_ldpc_tpu.sim import pipelines as jpipes
from polarcode_and_ldpc_tpu_torch import ops
from polarcode_and_ldpc_tpu_torch.core import rng
from polarcode_and_ldpc_tpu_torch.models.ldpc import layered as tlay
from polarcode_and_ldpc_tpu_torch.models.ldpc.graph import TannerGraph
from polarcode_and_ldpc_tpu_torch.models.ldpc.matrix import (mackay_construction,
                                                             regular_construction)
from polarcode_and_ldpc_tpu_torch.ops import bp_cuda
from polarcode_and_ldpc_tpu_torch.sim import pipelines as tpipes

RULES = {"ms": (1.0, 0.0), "nms": (0.75, 0.0), "oms": (1.0, 0.5)}


def _H(kind="regular", n=96):
    if kind == "regular":
        return regular_construction(n, n // 2, 3, 6, seed=42)
    return mackay_construction(n, n // 2, 3, 6, seed=7)  # irregular rows → padded slots


def _llrs(B, n, seed, snr_db, dtype=np.float64):
    """All-zero codeword over AWGN, seeded numpy; the first frame carries
    exact zeros (the ``sign(0) = 0`` path)."""
    std = np.sqrt(1.0 / (2.0 * 10 ** (snr_db / 10.0)))
    z = np.random.default_rng(seed).standard_normal((B, n))
    llr = (2.0 * (1.0 + std * z) / std ** 2).astype(dtype)
    llr[0, :4] = 0.0
    return llr


@pytest.mark.parametrize("m,nl", [(252, 4), (252, 6), (97, 4), (5, 8), (48, 1)])
def test_layer_bounds_equal_jax(m, nl):
    assert tlay.layer_bounds(m, nl) == jlay.layer_bounds(m, nl)


@pytest.mark.parametrize("early", [True, False])
@pytest.mark.parametrize("rule,nl", [("nms", 4), ("ms", 3), ("oms", 2), ("nms", 1)])
@pytest.mark.parametrize("kind", ["regular", "mackay"])
def test_layered_equals_jax_and_twin_f64(kind, rule, nl, early):
    alpha, beta = RULES[rule]
    H = _H(kind)
    jg, tg = JaxTannerGraph.from_H(H), TannerGraph.from_H(H, device="cpu")
    llr = np.concatenate([_llrs(6, 96, 3, -1.0), _llrs(6, 96, 4, 2.0)])
    wb, wi = jax.jit(jlay.make_layered_ms_decoder(jg, 12, alpha, beta, early, jnp.float64, nl))(llr)
    gb, gi = tlay.make_layered_ms_decoder(tg, 12, alpha, beta, early, torch.float64, nl)(
        torch.from_numpy(llr))
    assert gb.dtype == torch.int8 and gi.dtype == torch.int32
    assert np.array_equal(np.asarray(wb), gb.numpy())
    assert np.array_equal(np.asarray(wi), gi.numpy())
    for f in (0, 5, 6, 11):  # the float64 twin, one frame at a time
        rb, ri = layered_ms_decode_np(H, llr[f], 12, alpha, beta, early, nl)
        assert np.array_equal(rb, gb[f].numpy()) and ri == int(gi[f])
    if early:
        assert len(set(gi.tolist())) > 1


@pytest.mark.parametrize("nl", [1, 4])
def test_layered_equals_jax_pallas_interpret(nl):
    """The TPU fused kernel's layered mode, run as the JAX tests run it on
    the CPU (n=96, batch 128), and the XLA decoder, in float32."""
    H = _H("mackay")
    jg, tg = JaxTannerGraph.from_H(H), TannerGraph.from_H(H, device="cpu")
    llr = np.concatenate([_llrs(64, 96, 7, -1.0, np.float32), _llrs(64, 96, 8, 2.0, np.float32)])
    ker = make_bp_decoder_pallas(jg, 12, True, 128, interpret=True, check_rule="ms",
                                 normalization=0.75, schedule="layered", num_layers=nl)
    kb, ki = ker(jnp.asarray(llr))
    xb, xi = jax.jit(jlay.make_layered_ms_decoder(jg, 12, 0.75, 0.0, True, jnp.float32, nl))(llr)
    gb, gi = tlay.make_layered_ms_decoder(tg, 12, 0.75, 0.0, True, torch.float32, nl)(
        torch.from_numpy(llr))
    assert np.array_equal(np.asarray(kb), gb.numpy()) and np.array_equal(np.asarray(xb), gb.numpy())
    assert np.array_equal(np.asarray(ki).reshape(-1), gi.numpy())
    assert np.array_equal(np.asarray(xi), gi.numpy())


def test_layered_class_equals_jax_and_needs_fewer_iterations():
    H = _H("regular")
    jd = jfec.LayeredMSDecoder(H, max_iter=15, normalization=0.75, dtype=jnp.float64, num_layers=4)
    td = tfec.LayeredMSDecoder(H, max_iter=15, normalization=0.75, dtype=torch.float64,
                               num_layers=4, device="cpu")
    assert td.impl == "torch" and repr(td) == repr(jd)
    llr = _llrs(48, 96, 9, 1.0)
    wb, wi = jd.decode(llr, return_iterations=True)
    gb, gi = td.decode(llr, return_iterations=True)
    assert np.array_equal(np.asarray(wb), gb.numpy()) and np.array_equal(np.asarray(wi), gi.numpy())
    one = td.decode(llr[1])
    assert one.shape == (96,) and np.array_equal(one.numpy(), np.asarray(wb)[1])
    flood = tfec.NMSDecoder(H, max_iter=15, dtype=torch.float64, device="cpu")
    _, fi = flood.decode(llr, return_iterations=True)
    assert float(gi.float().mean()) < float(fi.float().mean())


# -- the wrapper and the implementation policy -----------------------------------------

def test_layered_impl_selection_and_errors():
    H = _H("regular", 48)
    assert tfec.LayeredMSDecoder(H, device="cpu", impl="cuda").impl == "cuda"
    g = TannerGraph.from_H(H, device="cpu")
    plan = bp_cuda.BPKernelPlan(g, 8, True, "ms", 0.75, 0.0, "layered", 4)
    assert plan.layered and plan.layer_checks == 6
    assert plan.tables["layer_starts"].tolist() == [0, 6, 12, 18, 24]
    llr = torch.from_numpy(_llrs(6, 48, 1, 0.0, np.float32))
    before = ops.launch_counts()["bp_decode_layered"]
    bits, iters = bp_cuda.bp_decode(llr, plan)
    pb, pi = tlay.make_layered_ms_decoder(g, 8, 0.75, 0.0, True, torch.float32, 4)(llr)
    assert torch.equal(bits, pb) and torch.equal(iters, pi)
    assert ops.launch_counts()["bp_decode_layered"] == before  # a CPU tensor launches nothing
    with pytest.raises(ValueError, match="CUDA tensor"):
        bp_cuda.bp_decode_cuda(llr, plan)
    with pytest.raises(ValueError, match="min-sum only"):
        bp_cuda.BPKernelPlan(g, 8, True, "bp", schedule="layered")
    with pytest.raises(ValueError, match="unknown schedule"):
        bp_cuda.BPKernelPlan(g, 8, True, "ms", schedule="serial")
    enc = tfec.LDPCEncoder(24, 12, dv=3, dc=6, seed=1, device="cpu")
    with pytest.raises(ValueError, match="min-sum only"):
        tpipes.make_ldpc_pipeline(enc.H, enc.G, 3.0, decoder="bp", schedule="layered",
                                  device="cpu")
    with pytest.raises(TypeError, match="float32 only"):
        tfec.LayeredMSDecoder(H, dtype=torch.float64, impl="cuda", device="cpu")


def test_layered_kernel_shared_memory_plan():
    """The layered kernel keeps Q, R and two layer-sized scratch planes: the
    (504, 252) code fits with room to spare, the expanded n=8192 code fits
    with 4 layers and more, and a single layer of it names the limit."""
    g = TannerGraph.from_H(_H("regular", 504), device="cpu")
    assert bp_cuda.smem_bytes(g, 63) == (504 + 6 * 252 + 2 * 6 * 63) * 4 + 504

    class Big:
        n, m, dv_max, dc_max = 8192, 4096, 3, 6
    assert bp_cuda.smem_bytes(Big, 1024) <= bp_cuda.SMEM_LIMIT_BYTES
    assert bp_cuda.smem_bytes(Big, 4096) > bp_cuda.SMEM_LIMIT_BYTES
    # a single layer of that code no longer fits: the plan keeps the planes in
    # device memory instead of raising
    big = TannerGraph.from_H(_H("regular", 8192), device="cpu")
    plan = bp_cuda.BPKernelPlan(big, 8, True, "ms", schedule="layered", num_layers=1)
    assert plan.device_memory and plan.smem_bytes == bp_cuda.smem_bytes(Big, 4096)
    assert not bp_cuda.BPKernelPlan(big, 8, True, "ms", schedule="layered",
                                    num_layers=4).device_memory


# -- the kernel's tables and two-pass layer walk, emulated ---------------------------------

def _emulate_layered_kernel(tables, starts, n, m, dv, dc, layer_checks, llr, max_iter, early,
                            alpha, beta):
    """What ``bp_layered_decode_kernel`` does for one frame, in numpy float32
    over the slot-major tables: R[s*m+c], the layer's T / D planes indexed
    [s*layer_checks + (c - c0)], −1 = padded slot."""
    f32 = np.float32
    vc, cvar = tables["vc_idx"].reshape(-1), tables["chk_var"].reshape(-1)
    Q = llr.astype(f32).copy()
    R = np.zeros(dc * m, f32)
    T = np.zeros(dc * layer_checks, f32)
    D = np.zeros(dc * layer_checks, f32)
    hard = (Q <= 0).astype(np.int8)
    iters = max_iter

    def sg_mg(e):
        if cvar[e] < 0:
            return f32(1), f32(np.inf)
        x = f32(Q[cvar[e]] - R[e])
        return f32(np.sign(x)), f32(abs(x))

    with np.errstate(invalid="ignore", over="ignore"):
        for it in range(max_iter):
            for g in range(len(starts) - 1):
                c0, c1 = int(starts[g]), int(starts[g + 1])
                for c in range(c0, c1):  # pass 1: every check reads the Q the layer found
                    run_s, run_m = f32(1), f32(np.inf)
                    for s in range(dc):
                        sg, mg = sg_mg(s * m + c)
                        k = s * layer_checks + (c - c0)
                        T[k], D[k] = run_s, run_m
                        run_s, run_m = f32(run_s * sg), min(run_m, mg)
                    run_s, run_m = f32(1), f32(np.inf)
                    for s in range(dc - 1, -1, -1):
                        e, k = s * m + c, s * layer_checks + (c - c0)
                        r_old = R[e]
                        sg, mg = sg_mg(e)
                        mag = min(D[k], run_m)
                        if beta != 0.0:
                            mag = max(f32(mag - f32(beta)), f32(0))
                        out = f32(f32(f32(T[k] * run_s) * mag) * f32(alpha))
                        r_new = out if (cvar[e] >= 0 and np.isfinite(out)) else f32(0)
                        D[k] = f32(r_new - r_old) if cvar[e] >= 0 else f32(0)
                        R[e] = r_new
                        run_s, run_m = f32(run_s * sg), min(run_m, mg)
                for v in range(n):  # pass 2: deltas land in variable-slot order
                    q = Q[v]
                    for sp in range(dv):
                        idx = vc[sp * n + v]
                        if idx < 0:
                            continue
                        s, c = divmod(int(idx), m)
                        if c0 <= c < c1:
                            q = f32(q + D[s * layer_checks + (c - c0)])
                    Q[v] = q
            hard = (Q <= 0).astype(np.int8)
            if early:
                bad = 0
                for c in range(m):
                    par = 0
                    for s in range(dc):
                        if cvar[s * m + c] >= 0:
                            par ^= int(hard[cvar[s * m + c]])
                    bad |= par
                if not bad:
                    iters = it + 1
                    break
    return hard, iters


def _has_layer_with_two_edges_of_one_variable(H, nl):
    for c0, c1 in tlay.layer_bounds(H.shape[0], nl):
        if (H[c0:c1].sum(axis=0) >= 2).any():
            return True
    return False


@pytest.mark.parametrize("rule", ["ms", "nms", "oms"])
@pytest.mark.parametrize("kind,nl", [("regular", 4), ("mackay", 3), ("regular", 1), ("mackay", 6)])
def test_layered_kernel_emulation_equals_plain(kind, nl, rule):
    """The walk the kernel makes over ``kernel_tables`` and ``layer_starts``
    gives the plain version's bits and iteration counts, on graphs where a
    layer holds two edges of one variable (contiguous layers are not the
    bands of the construction) and on a graph with padded slots."""
    alpha, beta = RULES[rule]
    H = _H(kind, 48)
    assert _has_layer_with_two_edges_of_one_variable(H, nl)
    g = TannerGraph.from_H(H, device="cpu")
    plan = bp_cuda.BPKernelPlan(g, 6, True, "ms", alpha, beta, "layered", nl)
    tables = bp_cuda.kernel_tables(g)
    starts = plan.tables["layer_starts"].numpy()
    assert starts[0] == 0 and starts[-1] == g.m and (np.diff(starts) <= plan.layer_checks).all()
    llr = np.concatenate([_llrs(3, 48, 11, -1.0, np.float32), _llrs(3, 48, 12, 2.0, np.float32)])
    pb, pi = plan.plain(torch.from_numpy(llr))
    for f in range(llr.shape[0]):
        bits, iters = _emulate_layered_kernel(
            tables, starts, g.n, g.m, g.dv_max, g.dc_max, plan.layer_checks, llr[f], 6, True,
            alpha, beta)
        assert np.array_equal(bits, pb[f].numpy()) and iters == int(pi[f])


@pytest.mark.cuda
def test_layered_kernel_equals_plain_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode); run chip_smoke.py on the card")
    g = TannerGraph.from_H(_H("mackay", 96), device="cuda")
    plan = bp_cuda.BPKernelPlan(g, 12, True, "ms", 0.75, 0.0, "layered", 4)
    llr = torch.from_numpy(_llrs(333, 96, 1, 0.0, np.float32)).cuda()
    (b, i), (pb, pi) = bp_cuda.bp_decode_cuda(llr, plan), plan.plain(llr)
    assert torch.equal(b, pb) and torch.equal(i, pi)


# -- the slice as a whole: one Monte-Carlo step in both packages ------------------------------

def test_layered_ldpc_step_equals_jax():
    """256 frames of ``make_ldpc_pipeline(schedule="layered")`` on the same key
    and frame ids.  Integer randomness is equal bit for bit; the float32 noise
    agrees to 1e-6, so a frame whose LLRs sit on a decision boundary may
    decode otherwise: at most 1 frame in 256 may differ."""
    enc = tfec.LDPCEncoder(96, 48, dv=3, dc=6, seed=42, device="cpu")
    kw = dict(decoder="nms", max_iter=10, normalization=0.75, schedule="layered",
              num_layers=4, message_idx=enc.info_positions)
    jstep = jax.jit(jpipes.make_ldpc_pipeline(enc.H, enc.G, -1.0, **kw))
    tstep = tpipes.make_ldpc_pipeline(enc.H, enc.G, -1.0, device="cpu", rng_x64=True, **kw)
    ids = np.arange(512, 512 + 256)
    want = jstep(jax.random.PRNGKey(1), jnp.asarray(ids, jnp.uint32))
    got = tstep(rng.prng_key(1), torch.from_numpy(ids))
    differ = np.nonzero((np.asarray(want["bit_errors"]) != got["bit_errors"].numpy())
                        | (np.asarray(want["iterations"]) != got["iterations"].numpy()))[0]
    print(f"frames that differ: {differ.tolist()} of 256")
    assert differ.size <= 1, differ
    assert int(got["bit_errors"].sum()) > 0  # the comparison saw errors
