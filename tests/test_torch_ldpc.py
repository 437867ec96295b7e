"""Port LDPC decoders (flooding BP / min-sum) against the JAX package: the
XLA decoders in float64 and float32 and the fused Pallas kernel in interpret
mode; and the CUDA kernel's compact edge tables against the graph's tables,
and its order of work against the plain version and the XLA decoders through
a walk of the kernel, frames vectorised in torch."""

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
    """A frame's planes, every edge once: sum-product total [n], C [E] and
    T [E], min-sum total and C.  A graph whose planes exceed one block's
    shared memory (a (4096, 2048) code with dv=7, dc=14) is planned in device
    memory instead of raising; the (504, 252) code and the padded MacKay
    (8192, 4096) sizes stay in shared memory."""
    class Big:
        n, num_edges = 8192, 24576
    assert bp_cuda.smem_bytes(Big) == 229376 <= bp_cuda.SMEM_LIMIT_BYTES
    assert bp_cuda.smem_bytes(Big, "ms") == 131072
    big = TannerGraph.from_H(regular_construction(4096, 2048, 7, 14, seed=1), device="cpu")
    plan = bp_cuda.BPKernelPlan(big, 8)
    assert plan.device_memory and plan.smem_bytes == bp_cuda.smem_bytes(big) == (
        (4096 + 2 * 28672) * 4)
    assert plan.smem_bytes > bp_cuda.SMEM_LIMIT_BYTES
    assert plan.scratch_bytes_per_frame % 16 == 0 and plan.scratch_bytes_per_frame >= plan.smem_bytes
    g = TannerGraph.from_H(_H("regular", 504), device="cpu")
    assert bp_cuda.smem_bytes(g) == (504 + 2 * 1512) * 4 == 14112
    plan = bp_cuda.BPKernelPlan(g, 8)
    assert not plan.device_memory and plan.threads == 256 and plan.blocks_per_sm == 8


# -- the kernel's tables and order of work, walked -----------------------------------------

def _row_slots(tables, p0=0, p1=None):
    """The kernel's walk of check positions [p0, p1): per slot j, the
    positions that have one and their j-th edges.  A position's edges are
    consecutive from ``row_first`` (CSR rows)."""
    first = torch.from_numpy(tables["row_first"].astype(np.int64))
    deg = torch.from_numpy(tables["row_degree"].astype(np.int64))
    p1 = len(deg) if p1 is None else p1
    deg, e = deg[p0:p1], first[p0:p1]
    return [(deg > j, e[deg > j] + j) for j in range(int(deg.max()) if len(deg) else 0)]


@pytest.mark.parametrize("columns", ["regular", "irregular"])
def test_kernel_tables_follow_the_graph_tables(columns):
    """Every edge once, in its check's slot order and its variable's slot;
    the checks by falling degree; each row's edges consecutive (CSR); a
    padded slot of an irregular column is -1 in ``vc_edge``."""
    H = mackay_construction(256, 128, 3, 6, seed=42)
    if columns == "irregular":  # every fifth column loses its last one
        H = H.copy()
        for v in range(0, 256, 5):
            H[np.nonzero(H[:, v])[0][-1], v] = 0
    g = TannerGraph.from_H(H, device="cpu")
    t, gt = bp_cuda.kernel_tables(g), g.numpy_tables()
    assert all(a.dtype == np.int32 for a in t.values())
    order, deg = t["check_order"], gt["check_mask"].sum(axis=1)
    assert sorted(order.tolist()) == list(range(g.m)) and (np.diff(deg[order]) <= 0).all()
    assert np.array_equal(t["row_degree"], deg[order]) and len(set(deg)) > 5
    assert t["row_first"][-1] == g.num_edges and t["row_first"][0] == 0
    assert np.array_equal(np.diff(t["row_first"]), t["row_degree"])
    edges = np.full((g.m, g.dc_max), -1)
    for j, (act, e) in enumerate(_row_slots(t)):
        edges[np.nonzero(act.numpy())[0], j] = e.numpy()
    assert sorted(edges[edges >= 0].tolist()) == list(range(g.num_edges))
    for p, c in enumerate(order):
        e = edges[p, :deg[c]]
        assert np.array_equal(t["edge_var"][e], gt["check_vars"][c, :deg[c]])
        assert np.array_equal(t["edge_var"][e] * g.dv_max + t["edge_slot"][e],
                              gt["cv_gather"][c, :deg[c]])
    vc = t["vc_edge"].reshape(g.dv_max, g.n)
    assert np.array_equal(vc >= 0, gt["var_mask"].T) and (vc < 0).any() == (columns == "irregular")
    for sp in range(g.dv_max):
        v = np.nonzero(vc[sp] >= 0)[0]
        assert (t["edge_var"][vc[sp, v]] == v).all() and (t["edge_slot"][vc[sp, v]] == sp).all()
    assert sorted(vc[vc >= 0].tolist()) == list(range(g.num_edges))


def _minsum_messages(x, slots, rows, alpha, beta):
    """``MinSumRow`` of the kernel on inputs ``x [B, edges]`` of ``rows``
    checks, slot j of every row at a time: the smallest magnitude with its
    first edge, the second smallest and the parity of the negative inputs
    (another zero input makes the exclusive minimum 0, so sign(0) = 0 needs
    no count); then offset, sign, α and non-finite → 0 per edge."""
    B = x.shape[0]
    min1, min2 = torch.full((B, rows), float("inf")), torch.full((B, rows), float("inf"))
    amin = torch.full((B, rows), -1)
    neg = torch.zeros(B, rows, dtype=torch.bool)
    for act, e in slots:
        a, m1 = x[:, e].abs(), min1[:, act]
        lt = a < m1
        min2[:, act] = torch.where(lt, m1, torch.minimum(min2[:, act], a))
        min1[:, act] = torch.where(lt, a, m1)
        amin[:, act] = torch.where(lt, e, amin[:, act])
        neg[:, act] ^= x[:, e] < 0
    out = torch.empty_like(x)
    for act, e in slots:
        mag = torch.where(amin[:, act] == e, min2[:, act], min1[:, act])
        if beta:
            mag = torch.clamp_min(mag - beta, 0.0)
        o = (torch.where(neg[:, act] ^ (x[:, e] < 0), -1.0, 1.0) * mag) * alpha
        out[:, e] = torch.where(torch.isfinite(o), o, torch.zeros_like(o))
    return out


def _syndrome_ok(bits, tables):
    """Zero syndrome of each frame, summed over the walk's rows."""
    par = torch.zeros(bits.shape[0], len(tables["row_degree"]), dtype=torch.int64)
    ev = torch.from_numpy(tables["edge_var"]).long()
    for act, e in _row_slots(tables):
        par[:, act] += bits[:, ev[e]].long()
    return (par % 2 == 0).all(dim=1)


def _walk_kernel(tables, n, m, dv, llr, max_iter, early, rule, alpha, beta, record=None):
    """What ``csrc/bp_decode.cu``'s flooding kernel computes, in its order,
    frames vectorised in torch float32: the messages by edge (C [E]), the
    input of edge e into its check ``total[v] - C[e]``, a check's edges in
    slot order (slot j of every check position at a time); sum-product by
    exclusive prefix / suffix products, min-sum by ``_minsum_messages``; the
    variable's slot sum in slot order.  Returns ``(bits, iters)`` with the
    plain version's latching; ``record`` gets C after each check update."""
    clip = 0.999999
    ev = torch.from_numpy(tables["edge_var"]).long()
    vc = torch.from_numpy(tables["vc_edge"]).long().reshape(dv, n)
    slots = _row_slots(tables)
    L = torch.as_tensor(llr, dtype=torch.float32)
    B = L.shape[0]
    total, C = L.clone(), torch.zeros(B, len(ev))
    bits = (L <= 0).to(torch.int8)
    done = torch.zeros(B, dtype=torch.bool)
    latched, iters = bits, torch.full((B,), max_iter, dtype=torch.int32)
    for it in range(max_iter):
        if early and bool(done.all()):
            break
        x = total[:, ev] - C
        if rule == "bp":
            T = torch.clamp(torch.tanh(x * 0.5), -clip, clip)
            run = torch.ones(B, m)
            for act, e in slots:
                C[:, e] = run[:, act]
                run[:, act] = run[:, act] * T[:, e]
            run = torch.ones(B, m)
            for act, e in reversed(slots):
                prod = torch.clamp(C[:, e] * run[:, act], -clip, clip)
                C[:, e] = torch.log1p(prod) - torch.log1p(-prod)
                run[:, act] = run[:, act] * T[:, e]
        else:
            C = _minsum_messages(x, slots, m, alpha, beta)
        if record is not None:
            record.append(C.clone())
        acc = None
        for sp in range(dv):
            c2v = torch.where(vc[sp] >= 0, C[:, vc[sp].clamp(min=0)], 0.0)
            acc = c2v if sp == 0 else acc + c2v
        total = L + acc
        bits = (total <= 0).to(torch.int8)
        if early:
            ok = _syndrome_ok(bits, tables)
            newly = ok & ~done
            latched = torch.where(newly[:, None], bits, latched)
            iters = torch.where(newly, it + 1, iters).to(torch.int32)
            done = done | ok
    if early:
        bits = torch.where(done[:, None], latched, bits)
    return bits, iters


def _recording_plain(g, rule, max_iter, early, record):
    """The plain flooding decoder, its check update's output [B, m, dc]
    appended to ``record`` each iteration."""
    alpha, beta = RULES[rule]

    def check(msgs, mask):
        out = (tbp.bp_check_update(msgs, mask, torch.float32) if rule == "bp" else
               tms.ms_check_update(msgs, mask, alpha, beta, torch.float32))
        record.append(out)
        return out
    return tbp.make_bp_decoder(g, max_iter, early, torch.float32, check_update=check)


def _check_major(tables, dc, p0=0, p1=None, c0=0):
    """Index of each edge of positions [p0, p1) (edges counted from the
    first) in the plain version's flat check-major layout of checks c0.."""
    order = torch.from_numpy(tables["check_order"].astype(np.int64))
    p1 = len(order) if p1 is None else p1
    idx = torch.empty(int(tables["row_first"][p1] - tables["row_first"][p0]), dtype=torch.int64)
    for j, (act, e) in enumerate(_row_slots(tables, p0, p1)):
        idx[e - int(tables["row_first"][p0])] = (order[p0:p1][act] - c0) * dc + j
    return idx


def _ties(B, n, seed):
    """Integer-valued LLRs in [-3, 3] (ties of magnitudes, zeros), a quarter
    of the zeros negative."""
    x = np.random.default_rng(seed).integers(-3, 4, (B, n)).astype(np.float32)
    x[:, ::4] = np.where(x[:, ::4] == 0, np.float32(-0.0), x[:, ::4])
    return x


def _walk_equals_plain(g, rule, llr, max_iter, early, messages):
    """The kernel's walk against the plain decoder: bits and iteration
    counts, and with ``messages`` the check messages after every iteration
    bit for bit, the sign of a zero included."""
    alpha, beta = RULES[rule]
    plain_c, walk_c = [], []
    pb, pi = _recording_plain(g, rule, max_iter, early, plain_c)(torch.from_numpy(llr))
    tables = bp_cuda.kernel_tables(g)
    wb, wi = _walk_kernel(tables, g.n, g.m, g.dv_max, llr, max_iter, early,
                          "bp" if rule == "bp" else "ms", alpha, beta, walk_c)
    assert torch.equal(wb, pb) and torch.equal(wi, pi)
    if messages:
        idx = _check_major(tables, g.dc_max)
        assert len(walk_c) == len(plain_c) and (len(walk_c) == max_iter or early)
        for w, p in zip(walk_c, plain_c):
            assert torch.equal(w.view(torch.int32),
                               p.reshape(p.shape[0], -1)[:, idx].contiguous().view(torch.int32))
    return wb, wi


@pytest.mark.parametrize("kind", ["regular", "mackay"])
@pytest.mark.parametrize("rule", ["ms", "nms", "oms"])
def test_kernel_tables_emulation_equals_plain_minsum(kind, rule):
    """The kernel's walk over its compact tables gives the plain version's
    bits, iteration counts and messages after every iteration, bit for bit."""
    g = TannerGraph.from_H(_H(kind, 48), device="cpu")
    llr = np.concatenate([_llrs(3, 48, 11, -1.0, np.float32), _llrs(3, 48, 12, 2.0, np.float32),
                          _ties(4, 48, 13)])
    _walk_equals_plain(g, rule, llr, 6, True, messages=True)


@pytest.mark.parametrize("early", [True, False])
def test_kernel_tables_emulation_equals_plain_sum_product(early):
    g = TannerGraph.from_H(_H("mackay", 48), device="cpu")
    llr = np.concatenate([_llrs(3, 48, 13, -1.0, np.float32), _llrs(3, 48, 14, 2.0, np.float32)])
    _walk_equals_plain(g, "bp", llr, 6, early, messages=False)


@pytest.mark.parametrize("rule", ["bp", "ms", "nms", "oms"])
def test_compact_walk_equals_plain_and_jax_on_padded_mackay(rule):
    """MacKay (256, 128): rows of degree 1 to 13 (mean 6), so the padded
    layout had 54 % padding.  Gaussian LLRs near the threshold and integer
    ties with +-0.0: the walk equals the plain decoder (min-sum: messages
    bit for bit after every iteration) and the JAX XLA decoder."""
    H = mackay_construction(256, 128, 3, 6, seed=42)
    g = TannerGraph.from_H(H, device="cpu")
    assert g.dc_max > 2 * g.num_edges / g.m
    # 16 frames: the plain decoder's [B, m, dc] planes stay under torch's
    # grain for intra-op threads, which would contend with the other workers
    llr = np.concatenate([_llrs(8, 256, 15, 0.0, np.float32), _ties(8, 256, 16)])
    llr[0, :8] = np.float32(-0.0)
    wb, wi = _walk_equals_plain(g, rule, llr, 10, True, messages=rule != "bp")
    jb, ji = _jax_decoder(JaxTannerGraph.from_H(H), rule, 10, True, "f32")(llr)
    assert np.array_equal(np.asarray(jb), wb.numpy()) and np.array_equal(np.asarray(ji), wi.numpy())
    assert len(set(wi.tolist())) > 2


@pytest.mark.cuda
def test_kernel_equals_plain_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode); run chip_smoke.py on the card")
    g = TannerGraph.from_H(_H("mackay", 96), device="cuda")
    plan = bp_cuda.BPKernelPlan(g, 12, True, "ms", 0.75, 0.0)
    llr = torch.from_numpy(_llrs(333, 96, 1, 0.0, np.float32)).cuda()
    (b, i), (pb, pi) = bp_cuda.bp_decode_cuda(llr, plan), plan.plain(llr)
    assert torch.equal(b, pb) and torch.equal(i, pi)
