"""The one-launch list decode (``control_impl="mega"``).

On the CPU the port's ``"mega"`` control runs its plain version, the
``"unroll-fused"`` chunk program; it is held here against the JAX package's
``"mega-interpret"`` (the Pallas whole-decode kernel in interpret mode) on the
same LLRs: decoded paths equal, metrics within ``rtol=1e-6`` (the two runtimes'
``exp`` / ``log1p`` differ in the last bit).  The CUDA kernel itself cannot run
here; what it READS, the concatenated node programs and the per-chunk step
table, is walked by the emulation of ``test_torch_scl_emulation.py``, driven
from that one table instead of one call per chunk, on level stacks that
start as garbage (the kernel's scratch is uninitialised), and must give the
plain decoder's outputs bit for bit.
"""

from types import SimpleNamespace

import jax
import numpy as np
import pytest
import test_torch_scl_emulation as emu
import torch

import polarcode_and_ldpc_tpu_torch as tfec
from polarcode_and_ldpc_tpu.models.polar.scanscl import make_scl_decoder_scan as jax_scan
from polarcode_and_ldpc_tpu_torch import ops
from polarcode_and_ldpc_tpu_torch.core import rng
from polarcode_and_ldpc_tpu_torch.models.polar.construction import (
    bit_reverse_permutation, frozen_mask_from_positions)
from polarcode_and_ldpc_tpu_torch.models.polar.scanscl import (build_scl_schedule,
                                                               make_scl_decoder_scan,
                                                               mega_reaches)
from polarcode_and_ldpc_tpu_torch.ops import scl_cuda
from polarcode_and_ldpc_tpu_torch.ops.scl_cuda import (MEGA_PARAM_ROWS, SMEM_LIMIT_BYTES,
                                                       STEP_TABLE_COLUMNS, SCLBodyProgram,
                                                       SCLMegaPlan, SCLState, build_mega_tables,
                                                       make_step_specs, smem_per_frame)
from polarcode_and_ldpc_tpu_torch.sim import make_polar_pipeline


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


def _code(N, K):
    frozen, _ = tfec.construct_polar_code(N, K, "bhattacharyya", 2.0)
    return frozen, frozen_mask_from_positions(N, frozen)


def test_mega_equals_jax_mega_interpret():
    """The size of the JAX package's own test of its whole-decode kernel:
    N=128, K=64, L=4, S=32, batch 128, zero-LLR ties."""
    N, K, L, S = 128, 64, 4, 32
    _, fm = _code(N, K)
    llr = (np.random.default_rng(42).standard_normal((128, N)) * 1.5).astype(np.float32)
    llr[0, :3] = 0.0
    u_j, m_j = jax.jit(jax_scan(N, fm, L, chunk=S, control_impl="mega-interpret"))(llr)
    dec = make_scl_decoder_scan(N, fm, L, chunk=S, control_impl="mega", device="cpu")
    assert dec.control_impl == "mega"
    u_t, m_t = dec(torch.from_numpy(llr))
    assert np.array_equal(np.asarray(u_j), u_t.numpy())
    np.testing.assert_allclose(m_t.numpy(), np.asarray(m_j), rtol=1e-6, atol=0)


@pytest.mark.parametrize("N,K,S,L", [(128, 64, 32, 4), (64, 20, 16, 3), (64, 32, 64, 2)])
def test_mega_on_the_cpu_is_the_plain_chunk_program(N, K, S, L):
    _, fm = _code(N, K)
    llr = torch.from_numpy((1.0 + 1.5 * np.random.default_rng(N + L).standard_normal(
        (33, N))).astype(np.float32))
    before = ops.launch_counts()["scl_decode_mega"]
    u0, m0 = make_scl_decoder_scan(N, fm, L, chunk=S, control_impl="unroll-fused", device="cpu")(llr)
    u1, m1 = make_scl_decoder_scan(N, fm, L, chunk=S, control_impl="mega", device="cpu")(llr)
    assert torch.equal(u0, u1) and torch.equal(m0, m1)
    assert ops.launch_counts()["scl_decode_mega"] == before  # a CPU tensor launches nothing


def test_mega_passes_through_the_entry_points():
    N, K, L = 128, 64, 4
    frozen, fm = _code(N, K)
    enc = tfec.PolarEncoder(N, K, frozen_bits=frozen, use_crc=True, device="cpu")
    msgs = np.random.default_rng(1).integers(0, 2, (40, enc.K_data))
    llr = tfec.AWGNChannel(snr_db=0.0, seed=4, device="cpu").transmit(enc.encode(msgs))
    want = tfec.CASCLDecoder(N, K, L, frozen_bits=frozen, device="cpu").decode(llr)
    for dec in (tfec.CASCLDecoder(N, K, L, frozen_bits=frozen, control_impl="mega", device="cpu"),
                tfec.SCLDecoder(N, K, L, frozen_bits=frozen, use_crc=True, control_impl="mega",
                                device="cpu")):
        assert dec.control_impl == "mega" and torch.equal(dec.decode(llr), want)
    ada = tfec.AdaptiveCASCLDecoder(N, K, L, frozen_bits=frozen, scl_control_impl="mega",
                                    device="cpu")
    assert ada.scl_control_impl == "mega"
    kw = dict(decoder="ca-scl", list_size=L, device="cpu")
    ids = torch.arange(64)
    a = make_polar_pipeline(N, K, frozen, -1.0, scl_control_impl="mega", **kw)(rng.prng_key(0), ids)
    b = make_polar_pipeline(N, K, frozen, -1.0, **kw)(rng.prng_key(0), ids)
    assert torch.equal(a["bit_errors"], b["bit_errors"])


def test_mega_options_that_raise():
    _, fm = _code(64, 32)
    with pytest.raises(NotImplementedError, match="mega-interpret"):
        make_scl_decoder_scan(64, fm, 2, chunk=16, control_impl="mega-interpret", device="cpu")
    # body_impl="cuda" under "mega" builds, as the JAX package takes
    # body_impl="pallas" there: the one launch runs the bodies (on the CPU the
    # plain chunk program, through the chunk-body wrapper)
    llr = torch.from_numpy(np.random.default_rng(3).normal(1.0, 1.5, (20, 64)).astype(np.float32))
    with_body = make_scl_decoder_scan(64, fm, 2, chunk=16, control_impl="mega", body_impl="cuda",
                                      device="cpu")
    plain = make_scl_decoder_scan(64, fm, 2, chunk=16, control_impl="mega", device="cpu")
    assert with_body.control_impl == plain.control_impl == "mega"
    got, want = with_body(llr), plain(llr)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    plan = SCLMegaPlan(build_scl_schedule(64, fm, 2, 16))
    with pytest.raises(ValueError, match="CUDA tensor"):
        scl_cuda.scl_decode_mega_cuda(torch.zeros(3, 64), plan)
    # the plan itself refuses a configuration one thread block cannot hold and
    # names its sizes; the factory runs "unroll-kernel" there instead
    # (test_mega_past_its_reach_runs_the_per_chunk_kernels)
    _, big = _code(4096, 2048)
    with pytest.raises(ValueError, match=r"N=4096, chunk S=2048, list L=32.*232448"):
        SCLMegaPlan(build_scl_schedule(4096, big, 32, 2048))
    with pytest.raises(ValueError, match="list sizes"):
        SCLMegaPlan(build_scl_schedule(64, fm, 64, 16))


@pytest.mark.parametrize("N,K,S,L,control", [(1024, 512, 128, 8, "mega"),
                                             (128, 64, 32, 64, "unroll-kernel"),
                                             (4096, 2048, 2048, 32, "unroll-kernel")])
def test_mega_past_its_reach_runs_the_per_chunk_kernels(N, K, S, L, control):
    """The control "mega" on a code the one launch cannot take (a list above
    32, or a frame's context beyond one thread block) runs "unroll-kernel",
    chosen on the host from sizes (``mega_reaches``), at full width, as the
    JAX package's mega control degrades past its VMEM budget; the flagship
    stays on the one launch.  The decoder's ``control_impl`` says which runs;
    the outputs are those of the per-chunk control."""
    frozen, fm = _code(N, K)
    dec = make_scl_decoder_scan(N, fm, L, chunk=S, control_impl="mega", device="cpu")
    assert dec.control_impl == control and not dec.live_width
    assert mega_reaches(L, S) == (control == "mega")
    if control == "mega" or N > 128:
        return
    llr = torch.from_numpy((1.0 + 1.5 * np.random.default_rng(N + L).standard_normal(
        (24, N))).astype(np.float32))
    want = make_scl_decoder_scan(N, fm, L, chunk=S, control_impl="unroll-kernel",
                                 live_width=False, device="cpu")(llr)
    got = dec(llr)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    # and through the entry points
    assert tfec.CASCLDecoder(N, K, L, frozen_bits=frozen, control_impl="mega",
                             device="cpu").control_impl == control
    ada = tfec.AdaptiveCASCLDecoder(N, K, L, frozen_bits=frozen, scl_control_impl="mega",
                                    device="cpu")
    ids = torch.arange(16)
    kw = dict(decoder="ca-scl", list_size=L, device="cpu")
    a = make_polar_pipeline(N, K, frozen, -1.0, scl_control_impl="mega", **kw)(rng.prng_key(0), ids)
    b = make_polar_pipeline(N, K, frozen, -1.0, **kw)(rng.prng_key(0), ids)
    assert torch.equal(a["bit_errors"], b["bit_errors"]) and ada.scl_control_impl == control


def test_mega_tables_hold_the_launch_arguments_of_every_chunk():
    _, fm = _code(256, 128)
    sched = build_scl_schedule(256, fm, 4, 32)  # C = 8, t = 3
    prog, table = build_mega_tables(sched)
    steps, last = make_step_specs(sched)
    assert prog.dtype == np.int32 and table.dtype == np.int32
    assert table.shape == (sched.C, len(STEP_TABLE_COLUMNS))
    col = {name: i for i, name in enumerate(STEP_TABLE_COLUMNS)}
    for c, spec in enumerate(steps + [last]):
        row = table[c]
        if spec is not last:
            assert (row[col["k"]], bool(row[col["inv"]]), row[col["j"]], row[col["mask_a"]],
                    row[col["mask_b"]]) == (spec.k, spec.inv, spec.j, spec.mask_a, spec.mask_b)
        off, n = row[col["prog_off"]], row[col["n_ops"]]
        assert np.array_equal(prog[off:off + n], spec.program.ops)
        assert bool(row[col["has_R"]]) == spec.program.has_r
    assert table[-1, col["j"]] == sched.t
    # distinct patterns are stored once
    assert prog.shape[0] == sum(len(SCLBodyProgram(f, 4).ops) for f in sched.unique_flags)


def _walk_table(sched, llr):
    """What ``scl_decode_mega_kernel`` does, frame batch leading: bit-reverse
    the LLRs, seed metrics and pendings, walk the step table row by row
    through the emulated chunk step, then the emulated last chunk.  The level
    stacks start as garbage (NaN alpha, words of alternating bits), as the
    kernel's scratch is uninitialised: no row may read what no earlier row
    wrote."""
    prog, table = build_mega_tables(sched)
    rev = torch.as_tensor(np.asarray(bit_reverse_permutation(sched.N)), dtype=torch.int64)
    x = llr[:, rev].contiguous()

    def spec_of(row):
        k, inv, j, mask_a, mask_b, off, n, has_r = (int(v) for v in row)
        # every chunk at full width, as the kernel builds its step arguments
        return SimpleNamespace(k=k, inv=bool(inv), j=j, mask_a=mask_a, mask_b=mask_b,
                               lv_in=sched.L, lv_out=sched.L, one_a=0, one_b=0,
                               program=SimpleNamespace(ops=prog[off:off + n], has_r=bool(has_r)))

    if sched.t == 0:  # a single chunk: the body on the LLRs, then the butterfly
        last = spec_of(table[0])
        B, L, N = x.shape[0], sched.L, sched.N
        pm = torch.full((B, L), -torch.inf)
        pm[:, 0] = 0.0
        beta, pm, _ = emu.emulate_body(last.program, x[:, None, :].expand(B, L, N).contiguous(), pm)
        return tfec.polar_transform(beta[..., rev]), pm
    state = SCLState(sched, x)  # metrics 0 / -inf, pendings the identity
    state.alpha.fill_(float("nan"))
    state.beta.fill_(0x55555555)
    for row in table[:-1]:
        emu.emulate_step(state, spec_of(row))
    return emu.emulate_last(state, spec_of(table[-1]))


@pytest.mark.parametrize("N,K,S,L", [(128, 64, 16, 4), (256, 128, 32, 8), (128, 100, 8, 2),
                                     (64, 40, 64, 2), (64, 20, 16, 3), (64, 3, 8, 8)])
def test_mega_step_table_walk_equals_plain_decoder(N, K, S, L):
    """The table walk against the full-width plain decoder, on codes whose
    list fills in the first chunks and on one whose list fills only in the
    last chunk (K = 3 = log2 L)."""
    _, fm = _code(N, K)
    sched = build_scl_schedule(N, fm, L, S)
    g = np.random.default_rng(N + S + L)
    llr = torch.from_numpy((1.5 + 2 * g.standard_normal((7, N))).astype(np.float32))
    llr[0] = torch.from_numpy(g.integers(-2, 3, N).astype(np.float32))  # tie-heavy frame
    u0, m0 = _walk_table(sched, llr)
    u1, m1 = make_scl_decoder_scan(N, fm, L, chunk=S, control_impl="mega", live_width=False,
                                   device="cpu")(llr)
    assert torch.equal(u0, u1) and torch.equal(m0, m1)


@pytest.mark.parametrize("N,K,S,L,per_frame", [(1024, 512, 128, 8, 4928), (1024, 512, 8, 2, 144),
                                               (4096, 2048, 2048, 32, None)])
def test_mega_plan_takes_the_chunk_step_context(N, K, S, L, per_frame):
    """The one-launch decode's shared memory per frame is the chunk step's
    context (no top plane, no root plane of its own): 4,928 B at the flagship,
    the size of K3's; its step table goes into the launch's parameters up to
    ``MEGA_PARAM_ROWS`` chunks (128 chunks of 8 do not); a code whose
    chunk-step context one block cannot hold raises with its sizes."""
    _, fm = _code(N, K)
    sched = build_scl_schedule(N, fm, L, S)
    step_context = smem_per_frame(L, S, depth0=False)
    if per_frame is None:
        assert step_context > SMEM_LIMIT_BYTES
        with pytest.raises(ValueError, match=f"N={N}, chunk S={S}, list L={L} needs "
                                             f"{step_context} bytes.*{SMEM_LIMIT_BYTES}"):
            SCLMegaPlan(sched)
        return
    plan = SCLMegaPlan(sched)
    assert plan.smem_per_frame == step_context == per_frame
    assert smem_per_frame(L, S, root_words=N) == per_frame + 4 * L * S + 4 * N  # before
    assert plan.table_in_params == (sched.C <= MEGA_PARAM_ROWS) == (S == 128)
    assert plan.warps == 32  # the kernel plans its warps per block within this bound
    assert plan.steps.shape == (sched.C, len(STEP_TABLE_COLUMNS))
    assert plan.steps.dtype == np.int32 and plan.steps.flags["C_CONTIGUOUS"]


@pytest.mark.cuda
def test_mega_kernel_equals_the_other_controls_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode); run chip_smoke.py on the card")
    N, K, S, L = 256, 128, 32, 8
    _, fm = _code(N, K)
    llr = torch.from_numpy((1.5 + 2 * np.random.default_rng(0).standard_normal((333, N))).astype(
        np.float32)).cuda()
    got = make_scl_decoder_scan(N, fm, L, chunk=S, control_impl="mega", device="cuda")(llr)
    for kw in (dict(control_impl="unroll-kernel"),
               dict(control_impl="unroll-fused", live_width=False)):
        want = make_scl_decoder_scan(N, fm, L, chunk=S, device="cuda", **kw)(llr)
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
