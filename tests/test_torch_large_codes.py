"""Large codes on the port (the JAX package's large-code configuration: polar
SC beyond one block, N=4096 SCL-32, the default MacKay LDPC code at n=4096 and
up), on the CPU: the plain hybrid SC decoder (the SC kernel's subtree mode)
against the JAX SC decoder, and the SC kernel's launch plan (levels of a
frame's stack in device memory, frames per SM, waves); the LDPC kernel plans
on MacKay codes (shared memory for the default construction, device memory
at column weight 16), and the plain decoders of that code against JAX; the list kernels' device-memory context plans; and the live width of the
kernel control at list 32."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import test_torch_sc as sc_tests
import torch

from polarcode_and_ldpc_tpu.models.ldpc import bp as jbp
from polarcode_and_ldpc_tpu.models.ldpc import minsum as jms
from polarcode_and_ldpc_tpu.models.ldpc.graph import TannerGraph as JaxTannerGraph
from polarcode_and_ldpc_tpu.models.polar.sc import make_sc_decoder as jax_make_sc_decoder
from polarcode_and_ldpc_tpu_torch.models.ldpc import bp as tbp
from polarcode_and_ldpc_tpu_torch.models.ldpc import minsum as tms
from polarcode_and_ldpc_tpu_torch.models.ldpc.graph import TannerGraph
from polarcode_and_ldpc_tpu_torch.models.ldpc.matrix import mackay_construction
from polarcode_and_ldpc_tpu_torch.models.polar import scl as tscl
from polarcode_and_ldpc_tpu_torch.models.polar.construction import (
    bit_reverse_permutation, construct_polar_code, frozen_mask_from_positions)
from polarcode_and_ldpc_tpu_torch.models.polar.fastsc import (make_sc_decoder_hybrid,
                                                              make_sc_decoder_unrolled)
from polarcode_and_ldpc_tpu_torch.models.polar.sc import make_sc_decoder
from polarcode_and_ldpc_tpu_torch.models.polar.scanscl import build_scl_schedule
from polarcode_and_ldpc_tpu_torch.ops import bp_cuda, scl_cuda
from polarcode_and_ldpc_tpu_torch.ops import sc_mega_cuda as scm


def _mask(N, K):
    frozen, _ = construct_polar_code(N, K, "bhattacharyya", 2.0)
    return frozen_mask_from_positions(N, frozen)


def _llrs(B, n, seed, snr_db, dtype=np.float32):
    """All-zero codeword over AWGN (Es/N0), seeded numpy; frame 0 is small
    integers with zeros and ties."""
    std = np.sqrt(1.0 / (2.0 * 10 ** (snr_db / 10.0)))
    rng = np.random.default_rng(seed)
    llr = 2.0 * (1.0 + std * rng.standard_normal((B, n))) / std ** 2
    llr[0] = rng.integers(-2, 3, n)
    return llr.astype(dtype)


# -- K1 hybrid: the plain hybrid SC against the JAX SC decoder ------------------------

# (N, K, sub_n): subtree 0 all frozen, and a short code with no all-frozen subtree
SC_CODES = ((1024, 128, 256), (256, 128, 64))


@pytest.fixture(scope="module")
def jax_sc():
    return {(N, K): jax.jit(jax_make_sc_decoder(N, _mask(N, K))) for N, K, _ in SC_CODES}


@pytest.mark.parametrize("N,K,sub_n", SC_CODES)
def test_plain_hybrid_sc_equals_jax(jax_sc, monkeypatch, N, K, sub_n):
    mask = _mask(N, K)
    frozen_rev = mask[bit_reverse_permutation(N)]
    all_frozen = [off for off in range(0, N, sub_n) if frozen_rev[off:off + sub_n].all()]
    assert all_frozen == ([0] if N == 1024 else [])
    llr = _llrs(24, N, N + K, 0.5)
    want = np.asarray(jax_sc[(N, K)](jnp.asarray(llr)))
    got = make_sc_decoder_hybrid(N, mask, sub_n)(torch.from_numpy(llr))
    assert got.dtype == torch.int8 and np.array_equal(got.numpy(), want)
    # the kernel decoder's hybrid mode on CPU tensors (a block shrunk to one
    # size-sub_n frame): the same subtree programs, each run through the
    # wrapper's plain version
    monkeypatch.setattr(scm, "SMEM_LIMIT_BYTES", scm.smem_per_frame(sub_n))
    mega = scm.make_sc_decoder_mega(N, mask)
    assert mega.sub_n == sub_n and sorted(mega.programs) == [
        off for off in range(0, N, sub_n) if off not in all_frozen]
    assert all(p.subtree and p.N == sub_n for p in mega.programs.values())
    assert np.array_equal(mega(torch.from_numpy(llr)).numpy(), want)


@pytest.mark.parametrize("fast", [True, False])
def test_plain_hybrid_decodes_leaves_above_the_cut(fast):
    """Nodes decoded whole above the cut (storage [0:64] rate-1, [64:128]
    SPC, [128:256] REP at N=256, cut 32) decode as the unrolled decoder
    decodes them, and as the JAX SC decoder does under fast nodes."""
    N, sub_n = 256, 32
    frozen_rev = np.zeros(N, bool)
    frozen_rev[64] = True
    frozen_rev[128:255] = True
    mask = np.empty(N, bool)
    mask[bit_reverse_permutation(N)] = frozen_rev
    llr = _llrs(16, N, 7, 1.0)
    want = make_sc_decoder_unrolled(N, mask, fast_nodes=fast)(torch.from_numpy(llr))
    got = make_sc_decoder_hybrid(N, mask, sub_n, fast_nodes=fast)(torch.from_numpy(llr))
    assert np.array_equal(got.numpy(), want.numpy())
    if fast:
        jax_u = jax.jit(jax_make_sc_decoder(N, mask))(jnp.asarray(llr))
        assert np.array_equal(got.numpy(), np.asarray(jax_u))


def test_hybrid_mode_is_chosen_by_size():
    """A frame of 9·N bytes fits one block up to N = 16384; from N = 32768
    the decoder cuts at 16384 (decided on the host, before any launch)."""
    assert scm.smem_per_frame(16384) <= scm.SMEM_LIMIT_BYTES < scm.smem_per_frame(32768)
    assert [scm.hybrid_sub_n(n) for n in (1024, 16384, 32768, 65536)] == [
        1024, 16384, 16384, 16384]
    mask = np.zeros(32768, bool)
    mask[:16384] = True  # storage: evens frozen; neither half all frozen
    dec = make_sc_decoder(32768, mask, impl="mega", device="cpu")
    assert dec.impl == "mega"
    mega = scm.make_sc_decoder_mega(32768, mask)
    assert mega.sub_n == 16384 and sorted(mega.programs) == [0, 16384]
    assert scm.make_sc_decoder_mega(1024, _mask(1024, 512)).sub_n == 1024


@pytest.mark.parametrize("n", [1024, 16384])
def test_sc_launch_plan(n):
    """The SC kernel's launch plan is a pure function of the frame size, the
    batch and the SM's shared memory: the fewest waves, then the fewest
    levels in device memory.  A subtree of 16384 (the hybrid cut at
    N=32768) keeps its top four levels in device memory: 24,576 bytes of
    shared memory per frame, nine frames per SM, 1024 frames in one wave on
    132 SMs, where the whole stack (147,456 bytes) took 7.8 waves."""
    plans = {(B, sub, smem): scm.plan_sc_launch(n, B, sub, 132, smem)
             for B in (1, 1024, 16384) for sub in (True, False)
             for smem in (scm.SMEM_PER_SM_BYTES, 100 * 1024)
             if sub or scm.smem_per_frame(n) + 1024 <= smem}
    for (B, sub, smem), p in plans.items():
        assert p.smem_per_frame == scm.smem_per_frame(n, p.dev_levels)
        f = p.frames_per_block
        assert f * p.smem_per_frame <= scm.SMEM_LIMIT_BYTES and p.warps_per_frame == 1
        assert p.frames_per_sm % f == 0
        assert (p.frames_per_sm // f) * (f * p.smem_per_frame + 1024) <= smem
        assert p.waves == -(-B // (p.frames_per_sm * 132))
        assert sub or p.dev_levels == 0  # a whole decode reads its LLRs into shared memory
        # no plan of fewer levels takes as few waves
        for c in range(p.dev_levels):
            per = scm.smem_per_frame(n, c)
            fps = max([min(32, 32 // w, smem // (w * per + 1024)) * w for w in range(1, 9)
                       if w * per <= scm.SMEM_LIMIT_BYTES] or [0])
            assert fps == 0 or -(-B // (fps * 132)) > p.waves
    big = scm.SMEM_PER_SM_BYTES
    if n == 16384:
        assert tuple(plans[1024, True, big]) == (4, 1, 24576, 9, 1, 1)
        assert tuple(plans[1024, False, big]) == (0, 1, 147456, 1, 8, 1)
        # two warps a frame: nine frames are 18 warps, within the 32 planned for
        assert tuple(scm.plan_sc_launch(n, 1024, True, warps_per_frame=2)) == (4, 1, 24576, 9, 1, 2)
        # four: eight frames per SM, 1056 on the card, still one wave
        assert tuple(scm.plan_sc_launch(n, 1024, True, warps_per_frame=4)) == (4, 1, 24576, 8, 1, 4)
        assert plans[1, True, big].dev_levels == 0  # one frame: one wave already
        assert tuple(plans[1024, True, 100 * 1024]) == (4, 1, 24576, 4, 2, 1)
        with pytest.raises(ValueError, match="fits"):  # a whole frame needs 147,456 bytes
            scm.plan_sc_launch(n, 1024, False, 132, 100 * 1024)
    else:
        assert tuple(plans[16384, False, big]) == (0, 2, 9216, 24, 6, 1)
        assert tuple(plans[16384, True, big]) == (1, 1, 5120, 32, 4, 1)
    assert scm.smem_per_frame(n) == scm.smem_per_frame(n, 0) == 9 * n


@pytest.mark.parametrize("fast", [True, False])
@pytest.mark.parametrize("N,K,sub_n", [(256, 64, 64), (1024, 512, 256)])
def test_subtree_program_emulation_equals_plain_subtree(monkeypatch, N, K, sub_n, fast):
    """The hybrid mode's subtree programs (built from the storage-order
    slice of the frozen mask, not reversed again), walked as the kernel walks
    them in storage order (the node-program emulation of ``test_torch_sc.py``
    in subtree mode), equal the plain subtree decoders."""
    mask = _mask(N, K)
    monkeypatch.setattr(scm, "SMEM_LIMIT_BYTES", scm.smem_per_frame(sub_n))
    mega = scm.make_sc_decoder_mega(N, mask, fast_nodes=fast)
    assert mega.sub_n == sub_n
    frozen_rev = mask[bit_reverse_permutation(N)]
    assert sorted(mega.programs) == [off for off in range(0, N, sub_n)
                                     if not frozen_rev[off:off + sub_n].all()]
    for off, program in mega.programs.items():
        assert program.subtree and program.N == sub_n
        assert np.array_equal(program.ops, scm.build_sc_program_rev(
            frozen_rev[off:off + sub_n], fast))
        llr = sc_tests._llrs(6, sub_n, N + off, "f32", snr_db=0.0)
        ties = np.random.default_rng(off).integers(-2, 3, (6, sub_n)).astype(np.float32)
        for batch in (llr, ties):
            want = program.plain(torch.from_numpy(batch)).numpy()
            got = np.stack([sc_tests._emulate_kernel(program.ops, row, sub_n, subtree=True)
                            for row in batch])
            assert np.array_equal(want, got)


# -- K2: shared- and device-memory plans on the default (MacKay) construction -------------

@pytest.fixture(scope="module")
def mackay4096():
    H = mackay_construction(4096, 2048, 3, 6, seed=42)
    return H, TannerGraph.from_H(H, device="cpu")


@pytest.fixture(scope="module")
def mackay4096_cw16():
    return TannerGraph.from_H(mackay_construction(4096, 2048, 16, 32, seed=42), device="cpu")


@pytest.mark.parametrize("schedule", ["flooding", "layered"])
def test_mackay_plans_use_device_memory(mackay4096, mackay4096_cw16, schedule):
    """Only where the compact planes exceed a block.  MacKay (4096, 2048)
    pads its checks to dc_max 19, but the kernel stores every edge once:
    114,688 bytes per frame flooding (sum-product), 78,184 layered (4 layers,
    3,162 edges in the widest), so the plan keeps a frame in shared memory,
    two blocks of 512 threads per SM.  With column weight 16 (E = 65,536)
    the planes take 540,672 and 344,332 bytes: device memory, decided from
    the sizes before any launch, with the scratch a block needs."""
    _, g = mackay4096
    assert (g.dv_max, g.dc_max, g.num_edges) == (3, 19, 12288)
    rule = "bp" if schedule == "flooding" else "ms"
    alpha = 0.75 if rule == "ms" else 1.0
    plan = bp_cuda.BPKernelPlan(g, 20, True, rule, alpha, 0.0, schedule, 4)
    need = {"flooding": 114688, "layered": 78184}[schedule]
    assert plan.smem_bytes == need == bp_cuda.smem_bytes(g, rule, plan.layer_edges)
    assert not plan.device_memory and plan.threads == 512 and plan.blocks_per_sm == 2
    g16 = mackay4096_cw16
    assert (g16.dv_max, g16.dc_max, g16.num_edges) == (16, 55, 65536)
    plan = bp_cuda.BPKernelPlan(g16, 20, True, rule, alpha, 0.0, schedule, 4)
    need = {"flooding": 540672, "layered": 344332}[schedule]
    assert plan.smem_bytes == need and plan.device_memory
    assert plan.scratch_bytes_per_frame == -(-need // 16) * 16


@pytest.mark.parametrize("rule", ["bp", "nms"])
def test_mackay_plain_decoders_equal_jax(mackay4096, rule):
    """The plain decoders the device-memory kernel is held against, on 8
    frames of the MacKay (4096, 2048) code near its threshold, 10 iterations
    at most (float64: bits and iteration counts)."""
    H, g = mackay4096
    jg = JaxTannerGraph.from_H(H)
    llr = _llrs(9, 4096, 11, 0.8, np.float64)[1:]  # noisy frames only
    if rule == "bp":
        jdec = jbp.make_bp_decoder(jg, 10, True, jnp.float64)
        tdec = tbp.make_bp_decoder(g, 10, True, torch.float64)
    else:
        jdec = jms.make_ms_decoder(jg, 10, 0.75, 0.0, True, jnp.float64)
        tdec = tms.make_ms_decoder(g, 10, 0.75, 0.0, True, torch.float64)
    jb, ji = jax.jit(jdec)(jnp.asarray(llr))
    tb, ti = tdec(torch.from_numpy(llr))
    assert np.array_equal(tb.numpy(), np.asarray(jb))
    assert np.array_equal(ti.numpy(), np.asarray(ji))
    assert len(set(ti.tolist())) > 1  # the frames do not all stop at once


# -- list kernels: where the chunk context lives --------------------------------------------

@pytest.mark.parametrize("N,S,L,device_memory", [
    (4096, 64, 32, False),   # the large-code main path: every context fits
    (4096, 1024, 32, True),  # a chunk of 1024 at list 32: 268,416 bytes
    (1024, 1024, 32, True),  # a single-chunk code: one chunk-body launch
    (1024, 128, 8, False)])  # the flagship
def test_list_kernel_context_plans(N, S, L, device_memory):
    sched = build_scl_schedule(N, _mask(N, N // 2), L, S)
    steps, last = scl_cuda.make_step_specs(sched)
    assert scl_cuda.context_in_device_memory(L, S) == device_memory
    assert scl_cuda.context_in_device_memory(L, S, root_words=N) == (
        device_memory or scl_cuda.smem_per_frame(L, S, N) > scl_cuda.SMEM_LIMIT_BYTES)
    if S == 1024 and L == 32:
        assert scl_cuda.smem_per_frame(L, S) == 267904
    assert len(steps) == sched.C - 1 and last.j == sched.t


# -- K3 live width on the kernel control at the large code's list size ------------------

def test_kernel_control_live_width_at_list_32():
    """A list of 32 on N=32 with chunk 4: the chunks enter with 1, 1, 1, 2,
    16, 32 … live paths; the kernel control (live width on by default, the
    plain steps on the CPU at the schedule's widths) equals the plain
    live-width control and the full-width one (held against JAX in
    ``test_torch_scl.py``)."""
    N, K, S, L = 32, 16, 4, 32
    mask = _mask(N, K)
    dec = tscl.make_scl_decoder(N, mask, L, chunk=S, control_impl="unroll-kernel", device="cpu")
    assert dec.live_width and dec.control_impl == "unroll-kernel"
    assert list(dec.schedule.lv_in[:6]) == [1, 1, 1, 2, 16, 32]
    llr = torch.from_numpy(_llrs(12, N, 3, 0.0))
    tu, tm = dec(llr)
    for live in (True, False):
        pu, pm = tscl.make_scl_decoder(N, mask, L, chunk=S, control_impl="unroll-fused",
                                       live_width=live, device="cpu")(llr)
        assert torch.equal(tu, pu) and torch.equal(tm, pm)
