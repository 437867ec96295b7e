"""The port's one-hot list algebra and the SCL formulations built on it, on
the CPU, against the JAX package.

* the one-hot primitives (``perm_impl="onehot"``) against JAX's on seeded
  inputs, −0.0 and tied candidates included;
* ``make_scl_decoder`` against JAX's for every combination JAX allows of
  ``perm_impl`` × ``control_impl`` ∈ {split, fused, kernel, unroll-fused,
  unroll-kernel} × ``leaf_impl`` × ``mask_dedup`` × ``node_mode`` (on the CPU
  the kernel controls run the plain chunk steps through their wrappers);
* the ``ValueError`` of each combination JAX refuses with an assertion;
* ``impl="unrolled"`` (one-hot and rank selections) against JAX's
  ``fastscl.py``;
* wider sweeps port against port: one-hot against rank, in float64.

Layouts: the JAX package is batch-last (``[L, J, B]``), the port frame-major
(``[B, L, J]``).  Tolerances as in ``test_torch_scl.py``: integers (bits,
paths, selections) equal; metrics ``rtol=1e-6`` in float32 and ``1e-12`` in
float64 against JAX (the runtimes' ``exp`` / ``log1p`` may differ in the last
bit), and exactly equal port against port.  A one-hot apply is a sum, so a
selected −0.0 may come out +0.0: values compare by ``==``, where −0.0 equals
+0.0; the kernels' bit patterns are held in ``test_torch_scl_emulation.py``.
The JAX decoders are built once per module (N=64, chunk 16, L=4).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import polarcode_and_ldpc_tpu as jfec
from polarcode_and_ldpc_tpu.core.config import PolarCodeConfig as JPolarCodeConfig
from polarcode_and_ldpc_tpu.models.polar import fastscl as jfast
from polarcode_and_ldpc_tpu.models.polar import scanscl as jscan
from polarcode_and_ldpc_tpu.models.polar.construction import frozen_mask_from_positions
from polarcode_and_ldpc_tpu_torch.cli.snr_curves import build_parser
from polarcode_and_ldpc_tpu_torch.convert import config_from_jax
from polarcode_and_ldpc_tpu_torch.models.polar import fastscl as tfast
from polarcode_and_ldpc_tpu_torch.models.polar import scanscl as tscan
from polarcode_and_ldpc_tpu_torch.models.polar import scl as tscl
from polarcode_and_ldpc_tpu_torch.ops import scl_cuda


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
JDT = {np.float32: jnp.float32, np.float64: jnp.float64}
TDT = {np.float32: torch.float32, np.float64: torch.float64}
N, K, S, L = 64, 32, 16, 4


def to_t(x):
    """JAX batch-last ``[..., B]`` → frame-major torch tensor."""
    return torch.from_numpy(np.moveaxis(np.asarray(x), -1, 0).copy())


def bl(x):
    """Frame-major numpy → JAX batch-last array."""
    return jnp.asarray(np.moveaxis(np.asarray(x), 0, -1))


def close(got, want, dtype):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=RTOL[dtype], atol=0)


def mask_of(n, k):
    return frozen_mask_from_positions(n, jfec.construct_polar_code(n, k, "bhattacharyya", 2.0)[0])


def llrs(n, B, seed, dtype=np.float32, integer_rows=4):
    """Noisy LLRs of the all-zero codeword; the first ``integer_rows`` rows
    integer-valued (exact zeros in f and g, tied candidates)."""
    g = np.random.default_rng(seed)
    x = (1.2 + 1.6 * g.standard_normal((B, n))).astype(dtype)
    x[:integer_rows] = g.integers(-2, 3, (integer_rows, n)).astype(dtype)
    return x


def onehot_np(r, J, dtype=np.float32):
    """Rank vectors ``[B, Lo]`` → one-hot planes ``[B, Lo, J]``."""
    return (r[..., None] == np.arange(J)).astype(dtype)


# -- the one-hot primitives --------------------------------------------------------

def test_apply_and_compose_equal_jax():
    """``_apply_perm`` / ``_apply_perm_bits`` / ``_compose`` on selections
    (rows repeat), −0.0 and exact zeros in the payload; compose gives exact
    +0.0 / 1.0 planes; float32 and float64."""
    for dtype in (np.float32, np.float64):
        _apply_and_compose_case(dtype)


def _apply_and_compose_case(dtype):
    g = np.random.default_rng(1)
    B, Lo, J, M = 7, 5, 4, 6
    P = onehot_np(g.integers(0, J, (B, Lo)), J, dtype)
    x = g.integers(-2, 3, (B, J, M)).astype(dtype)
    x[:, 1, :3] = -0.0
    x[0] = -0.0  # a frame whose whole column is −0.0
    bits = g.integers(0, 2, (B, J, M)).astype(np.int8)
    Q = onehot_np(g.integers(0, 3, (B, J)), 3, dtype)
    got = tscan._apply_perm(torch.from_numpy(P), torch.from_numpy(x))
    assert np.array_equal(got.numpy(), to_t(jscan._apply_perm(bl(P), bl(x))).numpy())
    # the literal sum: −0.0 only where every term is −0.0
    assert (torch.signbit(got[0]) & (got[0] == 0)).all()
    assert not torch.signbit(got[1:][got[1:] == 0]).any() or (x[1:] <= 0).all()
    gb = tscan._apply_perm_bits(torch.from_numpy(P), torch.from_numpy(bits))
    assert gb.dtype == torch.int8
    assert np.array_equal(gb.numpy(), to_t(jscan._apply_perm_bits(bl(P), bl(bits))).numpy())
    C = tscan._compose(torch.from_numpy(P), torch.from_numpy(Q))
    assert np.array_equal(C.numpy(), to_t(jscan._compose(bl(P), bl(Q))).numpy())
    assert not torch.signbit(C).any() and set(C.unique().tolist()) <= {0.0, 1.0}
    eye = tscan._identity_r(4, 3, "cpu", TDT[dtype])
    assert np.array_equal(eye.numpy(), to_t(jscan._identity_r(4, 3, JDT[dtype])).numpy())
    one = torch.from_numpy(x[:, :1])
    assert tscan._broadcast_rows(one, 4).shape == (B, 4, M)


@pytest.mark.parametrize("case", ["random", "ties", "phantoms"])
def test_prune_and_info_leaf_equal_jax(case):
    """``_cand_ranks`` / ``_stable_topk_onehot`` / ``_sel_metrics`` /
    ``_prune_onehot`` / ``_info_leaf`` (``_prune_2l`` and ``_info_leaf`` of
    JAX), all-pairs and sort prunes: tied candidates and −inf phantoms rank
    by index."""
    for leaf_impl in ("onehot", "sort"):
        _prune_case(case, leaf_impl)


def _prune_case(case, leaf_impl):
    g = np.random.default_rng(len(case) + len(leaf_impl))
    B, lv = 40, 4
    if case == "ties":
        cand = -g.integers(0, 3, (B, 2 * lv)).astype(np.float32)
        a = g.integers(-2, 3, (B, lv)).astype(np.float32)
        pm = -g.integers(0, 2, (B, lv)).astype(np.float32)
    else:
        cand = g.standard_normal((B, 2 * lv)).astype(np.float32)
        a = (2 * g.standard_normal((B, lv))).astype(np.float32)
        pm = -np.abs(g.standard_normal((B, lv))).astype(np.float32)
    if case == "phantoms":
        cand[:, [1, 2, 5, 6]] = -np.inf
        pm[:, 1:] = -np.inf
    tc = torch.from_numpy(cand)
    assert np.array_equal(tscan._cand_ranks(tc).numpy(),
                          to_t(jscan._cand_ranks(bl(cand))).numpy())
    S2 = tscan._stable_topk_onehot(tc, lv)
    assert np.array_equal(S2.numpy(), to_t(jscan._stable_topk_onehot(bl(cand), lv)).numpy())
    assert np.array_equal(tscan._sel_metrics(S2, tc).numpy(),
                          to_t(jscan._sel_metrics(bl(S2.numpy()), bl(cand))).numpy())
    second, pm2, R = tscan._prune_onehot(tc, lv, leaf_impl)
    jpm, jsecond, jR = jscan._prune_2l(bl(cand), lv, leaf_impl)
    assert np.array_equal(second.numpy(), to_t(jsecond).numpy())
    assert np.array_equal(pm2.numpy(), to_t(jpm).numpy())
    assert np.array_equal(R.numpy(), to_t(jR).numpy())
    for w in (1, lv):  # width-generic leaf: lv' = min(2 w, L)
        bits, pmo, Ro = tscan._info_leaf(torch.from_numpy(a[:, :w]),
                                         torch.from_numpy(pm[:, :w]), lv, leaf_impl)
        jb, jp, jr = jscan._info_leaf(bl(a[:, :w]), bl(pm[:, :w]), lv, leaf_impl)
        assert np.array_equal(bits.numpy(), to_t(jb).numpy())
        close(pmo.numpy(), to_t(jp).numpy(), np.float32)
        assert np.array_equal(Ro.numpy(), to_t(jr).numpy())


FAST_CASES = {"rate1": [(4, 8, "random"), (4, 4, "ties"), (1, 8, "random")],
              "rep": [(4, 8, "ties"), (2, 4, "phantoms")]}


@pytest.mark.parametrize("node", ["rate1", "rep"])
def test_fast_nodes_onehot_equal_jax(node):
    """The one-hot fast nodes (``_rate1_fast`` / ``_rep_fast`` of JAX),
    both prunes, tied and phantom cases."""
    for Ln, M, case in FAST_CASES[node]:
        _fast_case(node, Ln, M, case)


def _fast_case(node, Ln, M, case):
    g = np.random.default_rng(Ln * M + len(case))
    B = 24
    if case == "ties":
        alpha = g.integers(-2, 3, (B, Ln, M)).astype(np.float32)
        pm = -g.integers(0, 3, (B, Ln)).astype(np.float32)
    else:
        alpha = (2 * g.standard_normal((B, Ln, M))).astype(np.float32)
        pm = -np.abs(g.standard_normal((B, Ln))).astype(np.float32)
    if case == "phantoms":
        pm[:, 1:] = -np.inf
    tfn = {"rate1": tscan._rate1_fast_onehot, "rep": tscan._rep_fast_onehot}[node]
    jfn = {"rate1": jscan._rate1_fast, "rep": jscan._rep_fast}[node]
    for leaf_impl in ("onehot", "sort"):
        tb, tp, tr = tfn(torch.from_numpy(alpha), torch.from_numpy(pm), Ln, leaf_impl)
        jb, jp, jr = jfn(bl(alpha), bl(pm), Ln, leaf_impl)
        assert np.array_equal(tb.numpy(), to_t(jb).numpy())
        close(tp.numpy(), to_t(jp).numpy(), np.float32)
        if jr is None:
            assert tr is None and Ln == 1
        else:
            assert np.array_equal(tr.numpy(), to_t(jr).numpy())


# -- whole decoders against JAX ------------------------------------------------------

TIE_RTOL = 8 * 2.0 ** -24  # a few float32 ulps: the runtimes' exp / log1p


def fast_tied_rows(mask, x):
    """Frames of ``x`` at which a fast node's prune has its ``L``-th and
    ``(L+1)``-th best candidate sums finite and within ``TIE_RTOL`` (the port's
    float32 plain decoder, recorded at every rate-1 and repetition prune).
    There XLA's and torch's last bit decides which candidate survives."""
    tied, inside = set(), [False]

    def prune(cand, out, leaf_impl="onehot"):
        if inside[0] and out < cand.shape[1]:
            c = torch.sort(cand, dim=1, descending=True).values
            a, b = c[:, out - 1], c[:, out]
            near = torch.isfinite(b) & ((a - b).abs() <= TIE_RTOL * torch.maximum(a.abs(), b.abs()))
            tied.update(torch.nonzero(near).flatten().tolist())
        return plain_prune(cand, out, leaf_impl)

    def flagged(fn):
        def node(*args):
            inside[0] = True
            try:
                return fn(*args)
            finally:
                inside[0] = False
        return node

    plain_prune = tscan._prune_rank
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tscan, "_prune_rank", prune)
        for key in ("rate1_fast", "rep_fast"):
            mp.setitem(tscan._RANK_ALGEBRA, key, flagged(tscan._RANK_ALGEBRA[key]))
        tscl.make_scl_decoder(N, mask, L, chunk=S, control_impl="unroll-fused",
                              node_mode="fast", device="cpu")(torch.from_numpy(x))
    return np.isin(np.arange(x.shape[0]), sorted(tied))


@pytest.fixture(scope="module")
def jax_decodes():
    """JAX's scan decoders at N=64, chunk 16, L=4 on one seeded input, exact
    and fast (one-hot, the scan control ``"split"``), in float32 and float64.
    JAX's controls, algebras and prunes give equal outputs (its own tests
    enforce), so these stand for every combination.  Each entry holds the
    frames held to JAX's paths: all of them, except, for the float32 fast
    nodes, the frames with a near-tied fast prune (``fast_tied_rows``: the
    accepted difference of the fast nodes, rank and one-hot alike; the
    integer-valued rows only, 3 of the 40 frames, and held to JAX in
    float64)."""
    mask = mask_of(N, K)
    out = {}
    for name, dtype, node in (("exact", np.float32, "exact"), ("fast", np.float32, "fast"),
                              ("exact64", np.float64, "exact"), ("fast64", np.float64, "fast")):
        x = llrs(N, 40, 5, dtype)
        dec = jscan.make_scl_decoder_scan(N, mask, L, chunk=S, dtype=JDT[dtype],
                                          node_mode=node, perm_impl="onehot",
                                          control_impl="split")
        u, m = jax.jit(dec)(jnp.asarray(x))
        held = ~fast_tied_rows(mask, x) if name == "fast" else np.ones(len(x), bool)
        out[name] = (x, np.asarray(u), np.asarray(m), held)
    tied = np.nonzero(~out["fast"][3])[0]
    assert 0 < len(tied) and tied.max() < 4, tied  # integer-valued rows only
    return mask, out


PERMS_CONTROLS = [(p, c) for p in ("rank", "onehot")
                  for c in ("split", "fused", "kernel", "unroll-fused", "unroll-kernel")]


@pytest.mark.parametrize("perm_impl,control_impl", PERMS_CONTROLS)
def test_decoder_combinations_equal_jax(jax_decodes, perm_impl, control_impl):
    """Every ``leaf_impl`` × ``mask_dedup`` × ``node_mode`` that JAX allows
    with this algebra and control: the paths of JAX's decoder, its metrics
    within ``rtol``; float64 on the plain controls (the kernels are float32
    only)."""
    mask, ref = jax_decodes
    for node in ("exact", "fast"):
        if node == "fast" and perm_impl == "onehot" and control_impl.endswith("kernel"):
            continue  # JAX asserts: test_jax_assertions_raise_value_error
        x, u, m, held = ref[node]
        for leaf_impl in ("onehot", "sort"):
            for mask_dedup in ("exact", "union"):
                dec = tscl.make_scl_decoder(N, mask, L, chunk=S, control_impl=control_impl,
                                            perm_impl=perm_impl, leaf_impl=leaf_impl,
                                            mask_dedup=mask_dedup, node_mode=node,
                                            device="cpu")
                assert dec.control_impl == control_impl
                tu, tm = dec(torch.from_numpy(x))
                assert np.array_equal(tu.numpy()[held], u[held]), (node, leaf_impl, mask_dedup)
                close(tm.numpy()[held], m[held], np.float32)
    if not control_impl.endswith("kernel"):
        for node in ("exact", "fast"):
            x, u, m, _ = ref[node + "64"]
            tu, tm = tscl.make_scl_decoder(N, mask, L, torch.float64, chunk=S,
                                           control_impl=control_impl, perm_impl=perm_impl,
                                           node_mode=node, device="cpu")(torch.from_numpy(x))
            assert np.array_equal(tu.numpy(), u), node
            close(tm.numpy(), m, np.float64)


@pytest.mark.parametrize("use_onehot", [True, False])
def test_unrolled_equals_jax_fastscl(use_onehot):
    """``impl="unrolled"`` (``fastscl.make_scl_decoder_unrolled``) against
    JAX's, float32 and float64, and against the port's chunked decoder."""
    n, k, Ln = 32, 16, 4
    mask = mask_of(n, k)
    for dtype in (np.float32, np.float64):
        x = llrs(n, 24, 6, dtype)
        ju, jm = jax.jit(jfast.make_scl_decoder_unrolled(n, mask, Ln, JDT[dtype],
                                                         use_onehot=use_onehot))(jnp.asarray(x))
        tu, tm = tfast.make_scl_decoder_unrolled(n, mask, Ln, TDT[dtype], use_onehot=use_onehot,
                                                 device="cpu")(torch.from_numpy(x))
        assert np.array_equal(tu.numpy(), np.asarray(ju))
        close(tm.numpy(), jm, dtype)
        cu, cm = tscl.make_scl_decoder(n, mask, Ln, TDT[dtype], chunk=8,
                                       device="cpu")(torch.from_numpy(x))
        assert torch.equal(tu, cu)
        close(tm.numpy(), cm.numpy(), dtype)
    dec = tscl.SCLDecoder(n, k, Ln, frozen_bits=np.nonzero(mask)[0], impl="unrolled",
                          device="cpu")
    assert dec.control_impl is None and dec.decode(torch.from_numpy(x[:2])).shape == (2, k)


JAX_ASSERTS = [
    dict(node_mode="fast", perm_impl="onehot", control_impl="unroll-kernel"),
    dict(node_mode="fast", perm_impl="onehot", control_impl="kernel"),
    dict(node_mode="fast", perm_impl="onehot", control_impl="unroll-fused", body_impl="cuda"),
    dict(node_mode="fast", control_impl="mega"),
    dict(perm_impl="onehot", live_width=True, control_impl="unroll-fused"),
    dict(live_width=True, control_impl="fused"),
    dict(impl="unrolled", node_mode="fast"),
]
JAX_BODY = {"cuda": "pallas"}


@pytest.mark.parametrize("kw", JAX_ASSERTS, ids=lambda kw: "-".join(map(str, kw.values())))
def test_jax_assertions_raise_value_error(kw):
    """Where JAX's ``make_scl_decoder`` asserts, the port raises
    ``ValueError`` (JAX's assertion fires before any compile)."""
    mask = mask_of(N, K)
    jkw = {k: JAX_BODY.get(v, v) if k == "body_impl" else v for k, v in kw.items()}
    jkw.setdefault("impl", "scan-chunked")
    with pytest.raises(AssertionError):
        jfec.models.polar.scl.make_scl_decoder(N, mask, L, chunk=S, **jkw)
    with pytest.raises(ValueError):
        tscl.make_scl_decoder(N, mask, L, chunk=S, device="cpu", **kw)


# -- port against port ---------------------------------------------------------------

@pytest.mark.parametrize("n,k,s,ln", [(128, 64, 16, 8), (128, 100, 8, 2), (64, 20, 16, 3),
                                      (128, 64, 128, 4)])
def test_onehot_equals_rank_float64(n, k, s, ln):
    """One-hot against rank in float64 on the plain controls, both prunes,
    exact and fast nodes (a single-chunk code among them): paths and metrics
    exactly equal; the kernel controls (float32) equal too."""
    mask = mask_of(n, k)
    x = torch.from_numpy(llrs(n, 32, n + ln, np.float64))
    for node in ("exact", "fast"):
        want = tscl.make_scl_decoder(n, mask, ln, torch.float64, chunk=s, node_mode=node,
                                     live_width=False, device="cpu")(x)
        for control in ("split", "fused", "unroll-fused"):
            for leaf_impl in ("onehot", "sort"):
                got = tscl.make_scl_decoder(n, mask, ln, torch.float64, chunk=s, node_mode=node,
                                            control_impl=control, perm_impl="onehot",
                                            leaf_impl=leaf_impl, device="cpu")(x)
                assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    x32 = x.to(torch.float32)
    want = tscl.make_scl_decoder(n, mask, ln, chunk=s, live_width=False, device="cpu")(x32)
    for control in ("kernel", "unroll-kernel", "mega"):
        got = tscl.make_scl_decoder(n, mask, ln, chunk=s, control_impl=control,
                                    perm_impl="onehot", device="cpu")(x32)
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


def test_onehot_context_counts_the_pendings(monkeypatch):
    """``context_in_device_memory`` counts the rank vectors the one-hot kernels
    stage (2 t L words): at a limit the rank context fits, the one-hot one
    does not; the one-hot K5 wrapper hands back the plain plane on the CPU and
    the CUDA wrappers refuse CPU tensors."""
    assert scl_cuda.smem_per_frame(32, 64, 0, 6) - scl_cuda.smem_per_frame(32, 64) == 8 * 6 * 32
    monkeypatch.setattr(scl_cuda, "SMEM_LIMIT_BYTES", scl_cuda.smem_per_frame(32, 64))
    assert not scl_cuda.context_in_device_memory(32, 64)
    assert scl_cuda.context_in_device_memory(32, 64, 0, 6)
    program = scl_cuda.SCLBodyProgram(np.array([1, 1, 0, 0, 1, 0, 0, 0], bool), 4,
                                      perm_impl="onehot")
    g = np.random.default_rng(2)
    alpha = torch.from_numpy(g.standard_normal((3, 4, 8)).astype(np.float32))
    pm = torch.tensor([[0.0, -np.inf, -np.inf, -np.inf]] * 3)
    beta, pm2, R = scl_cuda.scl_chunk_body(alpha, pm, program)
    assert R.shape == (3, 4, 4) and torch.equal(R.sum(-1), torch.ones(3, 4))
    with pytest.raises(ValueError, match="CUDA tensor"):
        scl_cuda.scl_chunk_body_cuda(alpha, pm, program)
    sched = tscan.build_scl_schedule(64, mask_of(64, 32), 4, 16)
    state = scl_cuda.SCLState(sched, torch.zeros(2, 64), "onehot")
    steps, last = scl_cuda.make_step_specs(
        sched, [scl_cuda.SCLBodyProgram(f, 4, perm_impl="onehot") for f in sched.unique_flags])
    with pytest.raises(ValueError, match="CUDA tensor"):
        scl_cuda.scl_chunk_step_cuda(state, steps[0])


def test_config_and_cli_keep_the_controls():
    """``config_from_jax`` keeps JAX's list controls as they are and maps the
    names this package lacks to None; the CLI takes the controls; the
    interpret twins, the trellis twin and unknown names still refuse."""
    mask = mask_of(N, K)
    for control in ("kernel-interpret", "unroll-kernel-interpret", "mega-interpret"):
        with pytest.raises(NotImplementedError, match=control):
            tscl.make_scl_decoder(N, mask, L, control_impl=control, device="cpu")
    # the trellis twin is in the package now: the default decoder's paths
    llr = torch.from_numpy(np.random.default_rng(3).normal(1.0, 2.0, (4, N)))
    assert torch.equal(tscl.make_scl_decoder(N, mask, L, torch.float64, impl="scan",
                                             device="cpu")(llr)[0],
                       tscl.make_scl_decoder(N, mask, L, torch.float64, device="cpu")(llr)[0])
    with pytest.raises(ValueError):
        tscl.make_scl_decoder(N, mask, L, mask_dedup="both", device="cpu")
    for control in ("split", "fused", "kernel", "unroll-kernel", "mega"):
        cfg = config_from_jax(JPolarCodeConfig(scl_control_impl=control, scl_body_impl="pallas"))
        assert cfg.scl_control_impl == control and cfg.scl_body_impl is None
    assert config_from_jax(JPolarCodeConfig()).scl_control_impl == "split"  # JAX's default
    assert config_from_jax(JPolarCodeConfig(scl_control_impl="kernel-interpret")
                           ).scl_control_impl is None
    for control in ("split", "fused", "kernel"):
        assert build_parser().parse_args(["--scl-control", control]).scl_control == control


@pytest.mark.cuda
def test_onehot_kernels_equal_plain_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode); run chip_smoke.py "
                    "--phases device,build,onehot_kernels on the card")
    mask = mask_of(256, 128)
    x = torch.from_numpy(llrs(256, 333, 3)).cuda()
    want = tscl.make_scl_decoder(256, mask, 8, chunk=32, control_impl="unroll-fused",
                                 live_width=False, device="cuda")(x)
    for kw in (dict(control_impl="kernel"), dict(control_impl="unroll-kernel"),
               dict(control_impl="split", body_impl="cuda")):
        got = tscl.make_scl_decoder(256, mask, 8, chunk=32, perm_impl="onehot", device="cuda",
                                    **kw)(x)
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
