"""Port row-layered min-sum against the JAX package: the XLA decoder, the fused
Pallas kernel's layered mode in interpret mode and the float64 NumPy twin;
the layered CUDA kernel's compact tables and its two-pass layer walk, frames
vectorised in torch, against the plain version and the XLA decoder; and a
Monte-Carlo step of the layered pipeline in both packages.

Min-sum is exact arithmetic (compares, sign products, one multiply by α, one
subtract of β, adds in a fixed order), so every comparison here is on equal
bits and equal iteration counts, in float32 and float64 alike.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import test_torch_ldpc as ldpc_tests
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
    assert plan.layered and plan.layer_edges == 6 * 6
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
    """The layered kernel keeps Q [n], R [E] and D over the widest layer's
    edges: the (504, 252) code fits with room to spare, the padded MacKay
    (8192, 4096) code fits with 4 layers, and a (4096, 2048) code with dv=7,
    dc=14 fits with 4 layers, not with one."""
    g = TannerGraph.from_H(_H("regular", 504), device="cpu")
    plan = bp_cuda.BPKernelPlan(g, 8, True, "ms", schedule="layered", num_layers=4)
    assert plan.layer_edges == 63 * 6 and plan.smem_bytes == (504 + 1512 + 378) * 4
    assert bp_cuda.smem_bytes(g, "ms", 378) == plan.smem_bytes and plan.threads == 256

    class Big:
        n, num_edges = 8192, 24576
    assert bp_cuda.smem_bytes(Big, "ms", 6249) == 156068 <= bp_cuda.SMEM_LIMIT_BYTES
    assert bp_cuda.smem_bytes(Big, "ms", 24576) <= bp_cuda.SMEM_LIMIT_BYTES
    # a single layer of a code with 28,672 edges no longer fits: the plan keeps
    # the planes in device memory instead of raising
    big = TannerGraph.from_H(regular_construction(4096, 2048, 7, 14, seed=1), device="cpu")
    plan = bp_cuda.BPKernelPlan(big, 8, True, "ms", schedule="layered", num_layers=1)
    assert plan.device_memory and plan.smem_bytes == bp_cuda.smem_bytes(big, "ms", 28672)
    assert not bp_cuda.BPKernelPlan(big, 8, True, "ms", schedule="layered",
                                    num_layers=4).device_memory


def test_layered_tables_sort_checks_only_inside_layers():
    """The degree order may not move a check across a layer boundary: the
    check positions of layer g are its own checks, by falling degree."""
    g = TannerGraph.from_H(mackay_construction(256, 128, 3, 6, seed=42), device="cpu")
    deg = g.numpy_tables()["check_mask"].sum(axis=1)
    for nl in (1, 3, 4):
        plan = bp_cuda.BPKernelPlan(g, 8, True, "ms", schedule="layered", num_layers=nl)
        order = plan.tables["check_order"].numpy()
        starts = plan.tables["layer_starts"].numpy()
        first = plan.tables["row_first"].numpy()
        for (c0, c1), p0, p1 in zip(tlay.layer_bounds(g.m, nl), starts[:-1], starts[1:]):
            assert (p0, p1) == (c0, c1)
            assert sorted(order[p0:p1].tolist()) == list(range(c0, c1))
            assert (np.diff(deg[order[p0:p1]]) <= 0).all()
        # a layer's edges are one contiguous range
        deg_p = plan.tables["row_degree"].numpy()
        assert all(first[p1] - first[p0] == deg_p[p0:p1].sum()
                   for p0, p1 in zip(starts[:-1], starts[1:]))
        assert plan.layer_edges == int(np.diff(first[starts]).max())
    flood = bp_cuda.BPKernelPlan(g, 8, True, "ms").tables["check_order"].numpy()
    assert (np.diff(deg[flood]) <= 0).all()


# -- the kernel's tables and two-pass layer walk ------------------------------------------

def _walk_layered_kernel(tables, n, dv, llr, max_iter, early, alpha, beta, record=None):
    """What ``bp_layered_decode_kernel`` computes, in its order, frames
    vectorised in torch float32: per layer, pass 1 reads ``x = Q[v] − R[e]``
    for the layer's edges (kept in D), forms the min-sum messages of
    ``MinSumRow`` and leaves ``R_new − R_old`` in D; pass 2 adds, for slot
    sp = 0..dv−1 in order, the delta of that slot's edge where the edge lies
    in the layer's edge range.  ``record`` gets the layer's R after each
    layer."""
    ev = torch.from_numpy(tables["edge_var"]).long()
    vc = torch.from_numpy(tables["vc_edge"]).long().reshape(dv, n)
    first, starts = tables["row_first"], tables["layer_starts"]
    Q = torch.as_tensor(llr, dtype=torch.float32).clone()
    B = Q.shape[0]
    R = torch.zeros(B, len(ev))
    bits = (Q <= 0).to(torch.int8)
    done = torch.zeros(B, dtype=torch.bool)
    latched, iters = bits, torch.full((B,), max_iter, dtype=torch.int32)
    for it in range(max_iter):
        if early and bool(done.all()):
            break
        for p0, p1 in zip(starts[:-1], starts[1:]):
            eb, ee = int(first[p0]), int(first[p1])
            D = Q[:, ev[eb:ee]] - R[:, eb:ee]  # pass 1
            slots = [(act, e - eb)
                     for act, e in ldpc_tests._row_slots(tables, p0, p1)]
            r_new = ldpc_tests._minsum_messages(D, slots, int(p1 - p0), alpha, beta)
            D = r_new - R[:, eb:ee]
            R[:, eb:ee] = r_new
            if record is not None:
                record.append(r_new.clone())
            for sp in range(dv):  # pass 2
                inside = (vc[sp] >= eb) & (vc[sp] < ee)
                Q = torch.where(inside, Q + D[:, (vc[sp] - eb).clamp(0, ee - eb - 1)], Q)
        bits = (Q <= 0).to(torch.int8)
        if early:
            ok = ldpc_tests._syndrome_ok(bits, tables)
            newly = ok & ~done
            latched = torch.where(newly[:, None], bits, latched)
            iters = torch.where(newly, it + 1, iters).to(torch.int32)
            done = done | ok
    if early:
        bits = torch.where(done[:, None], latched, bits)
    return bits, iters


def _layered_walk_equals_plain(monkeypatch, g, nl, rule, llr, max_iter):
    """The kernel's walk against the plain layered decoder: bits, iteration
    counts and every layer's new messages R, bit for bit (the sign of a zero
    included)."""
    alpha, beta = RULES[rule]
    plan = bp_cuda.BPKernelPlan(g, max_iter, True, "ms", alpha, beta, "layered", nl)
    plain_r = []
    update = tlay.ms_check_update

    def recording(msgs, mask, *args):
        out = update(msgs, mask, *args)
        plain_r.append(out)
        return out
    monkeypatch.setattr(tlay, "ms_check_update", recording)
    pb, pi = plan.plain(torch.from_numpy(llr))
    starts = plan.tables["layer_starts"].numpy()
    bounds = list(zip(starts[:-1].tolist(), starts[1:].tolist()))
    tables = {**bp_cuda.kernel_tables(g, bounds), "layer_starts": starts}
    walk_r = []
    wb, wi = _walk_layered_kernel(tables, g.n, g.dv_max, llr, max_iter, True, alpha, beta,
                                  walk_r)
    assert torch.equal(wb, pb) and torch.equal(wi, pi)
    assert len(walk_r) == len(plain_r)
    for k, (w, p) in enumerate(zip(walk_r, plain_r)):
        p0, p1 = bounds[k % len(bounds)]
        idx = ldpc_tests._check_major(tables, g.dc_max, p0, p1, p0)
        got = p.reshape(p.shape[0], -1)[:, idx].contiguous()
        assert torch.equal(w.view(torch.int32), got.view(torch.int32))
    return wb, wi


def _has_layer_with_two_edges_of_one_variable(H, nl):
    for c0, c1 in tlay.layer_bounds(H.shape[0], nl):
        if (H[c0:c1].sum(axis=0) >= 2).any():
            return True
    return False


@pytest.mark.parametrize("rule", ["ms", "nms", "oms"])
@pytest.mark.parametrize("kind,nl", [("regular", 4), ("mackay", 3), ("regular", 1), ("mackay", 6)])
def test_layered_kernel_emulation_equals_plain(monkeypatch, kind, nl, rule):
    """The walk the kernel makes over its compact tables and ``layer_starts``
    gives the plain version's bits, iteration counts and messages, on graphs
    where a layer holds two edges of one variable (contiguous layers are not
    the bands of the construction) and on a graph with padded slots."""
    H = _H(kind, 48)
    assert _has_layer_with_two_edges_of_one_variable(H, nl)
    g = TannerGraph.from_H(H, device="cpu")
    llr = np.concatenate([_llrs(3, 48, 11, -1.0, np.float32), _llrs(3, 48, 12, 2.0, np.float32),
                          ldpc_tests._ties(4, 48, 13)])
    _layered_walk_equals_plain(monkeypatch, g, nl, rule, llr, 6)


@pytest.mark.parametrize("rule,nl", [("nms", 4), ("oms", 3)])
def test_layered_compact_walk_equals_plain_and_jax_on_padded_mackay(monkeypatch, rule, nl):
    """MacKay (256, 128) (rows of degree 1 to 13): Gaussian LLRs near the
    threshold and integer ties with +-0.0; the walk equals the plain decoder
    (messages bit for bit after every layer) and the JAX XLA decoder."""
    alpha, beta = RULES[rule]
    H = mackay_construction(256, 128, 3, 6, seed=42)
    g = TannerGraph.from_H(H, device="cpu")
    # 16 frames, as in test_torch_ldpc.py: under torch's grain for intra-op threads
    llr = np.concatenate([_llrs(8, 256, 15, 0.0, np.float32), ldpc_tests._ties(8, 256, 16)])
    wb, wi = _layered_walk_equals_plain(monkeypatch, g, nl, rule, llr, 10)
    jb, ji = jax.jit(jlay.make_layered_ms_decoder(JaxTannerGraph.from_H(H), 10, alpha, beta,
                                                  True, jnp.float32, nl))(llr)
    assert np.array_equal(np.asarray(jb), wb.numpy()) and np.array_equal(np.asarray(ji), wi.numpy())
    assert len(set(wi.tolist())) > 2


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
