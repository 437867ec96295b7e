"""Port LDPC decoders (flooding BP / min-sum) against the JAX package: the
XLA decoders in float64 and float32 and the fused Pallas kernel in interpret
mode; and the CUDA kernel's index tables against the plain version through a
numpy emulation of the kernel."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import polarcode_and_ldpc_tpu as jfec
import polarcode_and_ldpc_tpu_torch as tfec
from polarcode_and_ldpc_tpu.models.ldpc import bp as jbp
from polarcode_and_ldpc_tpu.models.ldpc import minsum as jms
from polarcode_and_ldpc_tpu.models.ldpc.graph import TannerGraph as JaxTannerGraph
from polarcode_and_ldpc_tpu.ops.bp_pallas import make_bp_decoder_pallas
from polarcode_and_ldpc_tpu_torch.models.ldpc import bp as tbp
from polarcode_and_ldpc_tpu_torch.models.ldpc import minsum as tms
from polarcode_and_ldpc_tpu_torch.models.ldpc.graph import TABLE_NAMES, TannerGraph
from polarcode_and_ldpc_tpu_torch.models.ldpc.matrix import (mackay_construction,
                                                             regular_construction)
from polarcode_and_ldpc_tpu_torch.ops import bp_cuda

RULES = {"bp": (1.0, 0.0), "ms": (1.0, 0.0), "nms": (0.75, 0.0), "oms": (1.0, 0.5)}
TDT = {"f32": torch.float32, "f64": torch.float64}
JDT = {"f32": jnp.float32, "f64": jnp.float64}


def _H(kind="regular", n=96):
    if kind == "regular":
        return regular_construction(n, n // 2, 3, 6, seed=42)
    return mackay_construction(n, n // 2, 3, 6, seed=7)  # irregular rows → padded slots


def _llrs(B, n, seed, snr_db, dtype=np.float64):
    """All-zero codeword over AWGN, seeded numpy."""
    std = np.sqrt(1.0 / (2.0 * 10 ** (snr_db / 10.0)))
    z = np.random.default_rng(seed).standard_normal((B, n))
    return (2.0 * (1.0 + std * z) / std ** 2).astype(dtype)


def _jax_decoder(graph, rule, max_iter, early, dt):
    alpha, beta = RULES[rule]
    if rule == "bp":
        return jax.jit(jbp.make_bp_decoder(graph, max_iter, early, JDT[dt]))
    return jax.jit(jms.make_ms_decoder(graph, max_iter, alpha, beta, early, JDT[dt]))


def _torch_decoder(graph, rule, max_iter, early, dt):
    alpha, beta = RULES[rule]
    if rule == "bp":
        return tbp.make_bp_decoder(graph, max_iter, early, TDT[dt])
    return tms.make_ms_decoder(graph, max_iter, alpha, beta, early, TDT[dt])


# -- graph -------------------------------------------------------------------------

@pytest.mark.parametrize("kind", ["regular", "mackay"])
def test_tanner_tables_equal_jax(kind):
    H = _H(kind)
    jg, tg = JaxTannerGraph.from_H(H), TannerGraph.from_H(H, device="cpu")
    assert (jg.m, jg.n, jg.num_edges, jg.dc_max, jg.dv_max) == (
        tg.m, tg.n, tg.num_edges, tg.dc_max, tg.dv_max)
    for name in TABLE_NAMES:
        assert np.array_equal(np.asarray(getattr(jg, name)), getattr(tg, name).numpy()), name
    r = np.random.default_rng(0)
    mv = r.standard_normal((3, tg.n, tg.dv_max))
    mc = r.standard_normal((3, tg.m, tg.dc_max))
    assert np.array_equal(np.asarray(jg.gather_var_to_check(jnp.asarray(mv))),
                          tg.gather_var_to_check(torch.from_numpy(mv)).numpy())
    assert np.array_equal(np.asarray(jg.gather_check_to_var(jnp.asarray(mc))),
                          tg.gather_check_to_var(torch.from_numpy(mc)).numpy())
    bits = r.integers(0, 2, (5, tg.n)).astype(np.int8)
    assert np.array_equal(np.asarray(jg.syndrome(jnp.asarray(bits))),
                          tg.syndrome(torch.from_numpy(bits)).numpy())
    assert np.array_equal(tg.syndrome(torch.from_numpy(bits)).numpy(), bits.astype(int) @ H.T % 2)


# -- check updates (LLR-level quantities) -----------------------------------------------

@pytest.mark.parametrize("dt,rtol", [("f64", 1e-12), ("f32", 1e-5)])
def test_bp_check_update_close(dt, rtol):
    """tanh / log1p come from two runtimes and ``jnp.cumprod`` may associate
    otherwise than the slot-by-slot sweep, so messages are compared to a
    tolerance (float32: rtol=1e-5, a few ulps through tanh → product → atanh).
    atanh amplifies one ulp of its argument by 2·cosh²(out/2), which passes
    1e-5 relative near the ±0.999999 clip (|out| ≳ 7), so the messages here
    stay moderate; saturated messages are covered by the whole-decode tests,
    which compare bits and iteration counts."""
    g = TannerGraph.from_H(_H("mackay"), device="cpu")
    msgs = (np.random.default_rng(1).standard_normal((6, g.m, g.dc_max)) * 1.5).astype(
        np.float32 if dt == "f32" else np.float64)
    mask = g.check_mask.numpy()
    want = np.asarray(jbp.bp_check_update(jnp.asarray(msgs), jnp.asarray(mask), JDT[dt]))
    got = tbp.bp_check_update(torch.from_numpy(msgs), g.check_mask, TDT[dt]).numpy()
    np.testing.assert_allclose(got[:, mask], want[:, mask], rtol=rtol, atol=1e-6 if dt == "f32" else 1e-14)


@pytest.mark.parametrize("rule", ["ms", "nms", "oms"])
@pytest.mark.parametrize("dt", ["f32", "f64"])
def test_ms_check_update_equal(rule, dt):
    """Sign products and minima are association-free: equal to the bit,
    zero messages (sign 0) and padded slots included."""
    alpha, beta = RULES[rule]
    g = TannerGraph.from_H(_H("mackay"), device="cpu")
    r = np.random.default_rng(2)
    msgs = (r.standard_normal((6, g.m, g.dc_max)) * 3).astype(np.float32 if dt == "f32" else np.float64)
    msgs[r.random(msgs.shape) < 0.05] = 0.0
    mask = g.check_mask.numpy()
    want = np.asarray(jms.ms_check_update(jnp.asarray(msgs), jnp.asarray(mask), alpha, beta, JDT[dt]))
    got = tms.ms_check_update(torch.from_numpy(msgs), g.check_mask, alpha, beta, TDT[dt]).numpy()
    assert np.array_equal(got[:, mask], want[:, mask])
    # degree-1 check: the leave-one-out of its only edge is empty → 0
    one = torch.tensor([[[2.0, 0.0, 0.0]]], dtype=TDT[dt])
    m1 = torch.tensor([[True, False, False]])
    assert float(tms.ms_check_update(one, m1, alpha, beta, TDT[dt])[0, 0, 0]) == 0.0


# -- whole decoders against the XLA decoders ------------------------------------------------

@pytest.mark.parametrize("early", [True, False])
@pytest.mark.parametrize("rule", ["bp", "ms", "nms", "oms"])
@pytest.mark.parametrize("kind", ["regular", "mackay"])
def test_decoders_equal_jax_f64(kind, rule, early):
    H = _H(kind)
    jg, tg = JaxTannerGraph.from_H(H), TannerGraph.from_H(H, device="cpu")
    llr = np.concatenate([_llrs(24, 96, 3, -1.0), _llrs(24, 96, 4, 2.0)])
    wb, wi = _jax_decoder(jg, rule, 12, early, "f64")(llr)
    gb, gi = _torch_decoder(tg, rule, 12, early, "f64")(torch.from_numpy(llr))
    assert gb.dtype == torch.int8 and gi.dtype == torch.int32
    assert np.array_equal(np.asarray(wb), gb.numpy())
    assert np.array_equal(np.asarray(wi), gi.numpy())
    if early:
        assert 1 <= int(gi.min()) and int(gi.max()) == 12 and len(set(gi.tolist())) > 2


@pytest.mark.parametrize("rule", ["bp", "ms", "nms", "oms"])
def test_decoders_equal_jax_f32(rule):
    """float32: min-sum is exact; sum-product bits and iteration counts agree
    on these seeded inputs (messages differ in the last bits)."""
    H = _H("regular")
    jg, tg = JaxTannerGraph.from_H(H), TannerGraph.from_H(H, device="cpu")
    llr = np.concatenate([_llrs(32, 96, 5, -1.0, np.float32), _llrs(32, 96, 6, 2.0, np.float32)])
    wb, wi = _jax_decoder(jg, rule, 12, True, "f32")(llr)
    gb, gi = _torch_decoder(tg, rule, 12, True, "f32")(torch.from_numpy(llr))
    assert np.array_equal(np.asarray(wb), gb.numpy())
    assert np.array_equal(np.asarray(wi), gi.numpy())


@pytest.mark.parametrize("rule", ["bp", "ms", "nms", "oms"])
@pytest.mark.parametrize("early", [True, False])
def test_decoders_equal_jax_pallas_interpret(rule, early):
    """The TPU fused kernel, run as the JAX tests run it on the CPU."""
    alpha, beta = RULES[rule]
    H = _H("regular")
    jg, tg = JaxTannerGraph.from_H(H), TannerGraph.from_H(H, device="cpu")
    llr = np.concatenate([_llrs(16, 96, 7, -1.0, np.float32), _llrs(16, 96, 8, 2.0, np.float32)])
    ker = make_bp_decoder_pallas(jg, max_iter=12, early_stop=early, batch_tile=32,
                                 interpret=True, check_rule="bp" if rule == "bp" else "ms",
                                 normalization=alpha, offset=beta)
    wb, wi = ker(jnp.asarray(llr))
    gb, gi = _torch_decoder(tg, rule, 12, early, "f32")(torch.from_numpy(llr))
    assert np.array_equal(np.asarray(wb), gb.numpy())
    assert np.array_equal(np.asarray(wi), gi.numpy())


# -- class API ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", ["BPDecoder", "MSDecoder", "NMSDecoder", "OMSDecoder"])
def test_decoder_classes_equal_jax(name):
    H = _H("regular")
    jd = getattr(jfec, name)(H, max_iter=10, dtype=jnp.float64)
    td = getattr(tfec, name)(H, max_iter=10, dtype=torch.float64, device="cpu")
    assert td.impl == "torch"
    assert (td.normalization, td.offset) == (jd.normalization, jd.offset)
    llr = _llrs(20, 96, 9, 0.0)
    wb, wi = jd.decode(llr, return_iterations=True)
    gb, gi = td.decode(llr, return_iterations=True)
    assert np.array_equal(np.asarray(wb), gb.numpy()) and np.array_equal(np.asarray(wi), gi.numpy())
    one = td.decode(llr[0])
    assert one.shape == (96,) and np.array_equal(one.numpy(), np.asarray(jd.decode(llr[0])))
    assert repr(td) == repr(jd)


def test_impl_selection_and_errors():
    H = _H("regular", 48)
    assert tfec.BPDecoder(H, device="cpu", impl="cuda").impl == "cuda"
    with pytest.raises(TypeError, match="float32 only"):
        tfec.BPDecoder(H, dtype=torch.float64, impl="cuda", device="cpu")
    with pytest.raises(ValueError, match="unknown impl"):
        tfec.BPDecoder(H, impl="auto", device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tfec.NMSDecoder(H)


def test_wrapper_uses_plain_only_for_cpu_tensors_and_checks_inputs():
    from polarcode_and_ldpc_tpu_torch import ops

    g = TannerGraph.from_H(_H("regular", 48), device="cpu")
    plan = bp_cuda.BPKernelPlan(g, 8, True, "ms", 0.75, 0.0)
    llr = torch.from_numpy(_llrs(6, 48, 1, 0.0, np.float32))
    bits, iters = bp_cuda.bp_decode(llr, plan)
    pb, pi = plan.plain(llr)
    assert torch.equal(bits, pb) and torch.equal(iters, pi)
    counts = ops.launch_counts()
    assert counts["bp_decode_bp"] == 0 and counts["bp_decode_ms"] == 0
    with pytest.raises(ValueError, match="CUDA tensor"):
        bp_cuda.bp_decode_cuda(llr, plan)
    with pytest.raises(ValueError, match="unknown check_rule"):
        bp_cuda.BPKernelPlan(g, 8, True, "layered")


def test_kernel_names_its_shared_memory_limit():
    """A graph whose messages exceed one block's shared memory (faked at
    n=8192, dv=dc=8; a real (4096, 2048) code with dv=5, dc=10) is planned in
    device memory instead of raising; the (504, 252) code stays in shared
    memory."""
    class Big:
        n, m, dv_max, dc_max = 8192, 4096, 8, 8
    assert bp_cuda.smem_bytes(Big) > bp_cuda.SMEM_LIMIT_BYTES
    big = TannerGraph.from_H(regular_construction(4096, 2048, 5, 10, seed=1), device="cpu")
    plan = bp_cuda.BPKernelPlan(big, 8)
    assert plan.device_memory and plan.smem_bytes == bp_cuda.smem_bytes(big) == (
        (5 * 4096 + 2 * 10 * 2048 + 4096) * 4 + 4096)
    assert plan.smem_bytes > bp_cuda.SMEM_LIMIT_BYTES
    assert plan.scratch_bytes_per_frame % 16 == 0 and plan.scratch_bytes_per_frame >= plan.smem_bytes
    g = TannerGraph.from_H(_H("regular", 504), device="cpu")
    assert bp_cuda.smem_bytes(g) == (3 * 504 + 2 * 6 * 252 + 504) * 4 + 504
    assert not bp_cuda.BPKernelPlan(g, 8).device_memory


# -- the kernel's tables and algorithm, emulated -------------------------------------------

def _emulate_kernel(tables, n, m, dv, dc, llr, max_iter, early, rule, alpha, beta):
    """What ``csrc/bp_decode.cu`` does for one frame, in numpy float32 over
    the slot-major tables: V[sp*n+v], C[s*m+c], −1 = padded slot."""
    f32 = np.float32
    clip = f32(0.999999)
    cv, vc, cvar = (tables[k].reshape(-1) for k in ("cv_idx", "vc_idx", "chk_var"))
    L = llr.astype(f32)
    V = np.tile(L, dv)
    C = np.zeros(dc * m, f32)
    T = np.zeros(dc * m, f32)
    hard = (L <= 0).astype(np.int8)
    iters = max_iter
    with np.errstate(invalid="ignore", over="ignore"):
        for it in range(max_iter):
            for c in range(m):
                if rule == "bp":
                    run = f32(1)
                    for s in range(dc):
                        e = s * m + c
                        t = np.clip(np.tanh(V[cv[e]] * f32(0.5)), -clip, clip) if cv[e] >= 0 else f32(1)
                        T[e], C[e] = t, run
                        run = f32(run * t)
                    run = f32(1)
                    for s in range(dc - 1, -1, -1):
                        e = s * m + c
                        prod = np.clip(f32(C[e] * run), -clip, clip)
                        C[e] = f32(np.log1p(prod) - np.log1p(-prod))
                        run = f32(run * T[e])
                else:
                    def sg_mg(e):
                        if cv[e] < 0:
                            return f32(1), f32(np.inf)
                        x = V[cv[e]]
                        return f32(np.sign(x)), f32(abs(x))
                    run_s, run_m = f32(1), f32(np.inf)
                    for s in range(dc):
                        e = s * m + c
                        sg, mg = sg_mg(e)
                        T[e], C[e] = run_s, run_m
                        run_s, run_m = f32(run_s * sg), min(run_m, mg)
                    run_s, run_m = f32(1), f32(np.inf)
                    for s in range(dc - 1, -1, -1):
                        e = s * m + c
                        sg, mg = sg_mg(e)
                        mag = min(C[e], run_m)
                        if beta != 0.0:
                            mag = max(f32(mag - f32(beta)), f32(0))
                        out = f32(f32(f32(T[e] * run_s) * mag) * f32(alpha))
                        C[e] = out if np.isfinite(out) else f32(0)
                        run_s, run_m = f32(run_s * sg), min(run_m, mg)
            for v in range(n):
                c2v = [C[vc[sp * n + v]] if vc[sp * n + v] >= 0 else f32(0) for sp in range(dv)]
                acc = c2v[0]
                for x in c2v[1:]:
                    acc = f32(acc + x)
                total = f32(L[v] + acc)
                for sp in range(dv):
                    V[sp * n + v] = f32(total - c2v[sp])
                hard[v] = total <= 0
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
    return hard.copy(), iters


@pytest.mark.parametrize("kind", ["regular", "mackay"])
@pytest.mark.parametrize("rule", ["ms", "nms", "oms"])
def test_kernel_tables_emulation_equals_plain_minsum(kind, rule):
    alpha, beta = RULES[rule]
    g = TannerGraph.from_H(_H(kind, 48), device="cpu")
    plan = bp_cuda.BPKernelPlan(g, 6, True, "ms", alpha, beta)
    tables = bp_cuda.kernel_tables(g)
    assert all(t.dtype == np.int32 for t in tables.values())
    assert int((tables["cv_idx"] >= 0).sum()) == int((tables["vc_idx"] >= 0).sum()) == g.num_edges
    llr = np.concatenate([_llrs(3, 48, 11, -1.0, np.float32), _llrs(3, 48, 12, 2.0, np.float32)])
    pb, pi = plan.plain(torch.from_numpy(llr))
    for f in range(llr.shape[0]):
        bits, iters = _emulate_kernel(tables, g.n, g.m, g.dv_max, g.dc_max, llr[f], 6, True,
                                      "ms", alpha, beta)
        assert np.array_equal(bits, pb[f].numpy()) and iters == int(pi[f])


@pytest.mark.parametrize("early", [True, False])
def test_kernel_tables_emulation_equals_plain_sum_product(early):
    """numpy's tanh/log1p may differ from torch's in the last bit, so the
    hard outputs are compared (they agree on these seeded inputs)."""
    g = TannerGraph.from_H(_H("mackay", 48), device="cpu")
    plan = bp_cuda.BPKernelPlan(g, 6, early, "bp")
    tables = bp_cuda.kernel_tables(g)
    llr = np.concatenate([_llrs(3, 48, 13, -1.0, np.float32), _llrs(3, 48, 14, 2.0, np.float32)])
    pb, pi = plan.plain(torch.from_numpy(llr))
    for f in range(llr.shape[0]):
        bits, iters = _emulate_kernel(tables, g.n, g.m, g.dv_max, g.dc_max, llr[f], 6, early,
                                      "bp", 1.0, 0.0)
        assert np.array_equal(bits, pb[f].numpy()) and iters == int(pi[f])


@pytest.mark.cuda
def test_kernel_equals_plain_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode); run chip_smoke.py on the card")
    g = TannerGraph.from_H(_H("mackay", 96), device="cuda")
    plan = bp_cuda.BPKernelPlan(g, 12, True, "ms", 0.75, 0.0)
    llr = torch.from_numpy(_llrs(333, 96, 1, 0.0, np.float32)).cuda()
    (b, i), (pb, pi) = bp_cuda.bp_decode_cuda(llr, plan), plan.plain(llr)
    assert torch.equal(b, pb) and torch.equal(i, pi)
