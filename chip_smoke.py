#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

Run from the root of a checkout, with no arguments:

    python3 chip_smoke.py

It needs one CUDA device and ``nvcc``.  It builds the package's CUDA kernels
from the sources in the checkout, holds each kernel against its plain PyTorch
version on the card at the shapes the Monte-Carlo main path gives it, drives
the main paths (``MonteCarloSimulator`` over the polar SC, the polar CA-SCL-8
exact and with fast list nodes, the LDPC BP / min-sum, the row-layered
min-sum and the quasi-cyclic n=8192 pipelines, the large codes — polar
N=4096 SCL-32, SC at N=32768, the MacKay LDPC code at n=8192 —, the adaptive
SC-first CA-SCL serving decoder on batches of 8192 frames, exact and fast,
the SNR-curve CLI, and JAX's SCL-8 benchmark shape under every list control and
both permutation algebras; the BSC and fading channels; the reference's
benchmark CLIs and throughput probes; codes built by the Monte-Carlo polar
construction and the PEG and Gallager LDPC constructions) at full code size
through the kernels, holds the kernels against the trellis and float64 parity
twins,
checks the frame-id invariance of the counters and checkpoint/resume, and
prints one JSON line per phase.  Any failure raises, and the exit code is then non-zero.

The second line from the end lists every kernel with its launches on the main
path, its error against the plain version, its time, the plain version's
time and its roofline bound; the last line is
``{"ok": true, "device": {...}}``.

Phases: ``device``, ``build``, ``kernels`` (SC and LDPC kernels, flooding and
layered, and the int8 row roll of the sublane-roll probe, against their plain
versions), ``scl_kernels`` (the list-decode
kernels: the chunk body on every chunk pattern of the code, the chunk step on
the level stacks of every chunk position, the last chunk, the one-launch
decode at the serving batch sizes and past one wave too, whole decodes,
other codes; the one-launch decode's registers, spills and resident warps
per SM), ``scl_profile`` (the chunk step's and the one-launch decode's time
by part from the profiled builds, which ``build`` compiles beside the others
only when this phase runs, and every list-kernel variant's registers, spills
and resident warps per SM), ``sc_profile`` (the SC kernel's time by part
from its profiled build, built likewise only when this phase runs, for the
whole decode at N=1024 and both subtree launches at N=32768),
``fast_kernels`` (the fast-node
selection kernel, and the fast node programs of the chunk body, chunk step
and last chunk in the same way; the one-launch decode must refuse them),
``large_kernels`` (the large-code modes: the SC kernel's hybrid subtree
launch at N=32768, the LDPC kernel flooding and layered on the MacKay n=8192
and n=4096 codes in shared memory and, in device memory, on a MacKay code of
column weight 16 whose frame exceeds a block, the list kernels with the chunk
context in device memory at S=1024, L=32, and the live width's narrow
prefix, each narrow position alone and the whole prefix in one launch,
beside the full-width steps), ``onehot_kernels`` (the one-hot permutation
modes of the chunk body, chunk step and last chunk: every chunk pattern, the
level stacks after every chunk position held by bit pattern, whole decodes
under every control, other codes, integer LLRs, the control ``"kernel"`` with
its context in device memory), ``polar_sc_mc``, ``polar_cascl_mc``,
``polar_fast_mc``, ``polar_scl8_controls``, ``ldpc_mc``, ``ldpc_layered_mc``, ``ldpc_qc_mc``,
``polar_large_mc``, ``polar_sc_large_mc``, ``ldpc_large_mc``, ``serving``,
``serving_fast``, ``snr_curves``, ``channels_mc`` (polar SC over the BSC at
p = 0.05 / 0.11 and Rayleigh at 3 / 6 dB, CA-SCL-8 over Rayleigh, LDPC BP and
NMS over the BSC and Rician fading, each against its plain pipeline on one
chunk and at two chunk sizes), ``throughput`` (the throughput CLI at the main
paths' batches, and one ``profile_trace`` of an SC chunk), ``run_benchmark``
(the reference's main CLI over Rayleigh), ``code_params`` (its default length
and rate sweeps), ``sc_vs_scl`` (quick and full modes), ``construction`` (the
Monte-Carlo polar construction at N=1024 and 4096 on the card against the
CPU, polar SC and CA-SCL-8 on its code, BP and layered NMS on the PEG and
Gallager (504, 252) codes, each against its plain pipeline) (the main paths,
each with the launch counts set to 0 just before and read just after; the CLIs
write under ``chiprun_out/``), ``twins`` (the SC kernel's exact program and the
list decode against the trellis twins ``impl="scan"``, and the SC, list and
LDPC kernels against the float64 parity twins), ``sharded`` (frame-sharded
Monte-Carlo of polar SC, CA-SCL-8 and LDPC BP: a one-rank NCCL group in this
process, then two child ranks sharing the card over gloo — and two cards over
NCCL where there are two — each against the unsharded counts, with the QC
n=8192 decode and the polar transform code-sharded over the two ranks and the
weak scaling of the SC step; the children's launches are counted),
``oracle`` (the oracle-differential CLI at its default codes, SCL-8 N=1024 and
BP n=504 on the self and oracle constructions, each arm's first chunk against
its plain pipeline), ``invariance``, ``stages``.  The kernel holds
include BSC batches (every LLR ±c, and ±0.0 at p = 0.5).  The
``summary`` line (``partial`` when phases were chosen) gives each phase's
seconds.

``--quick`` cuts the frame counts (for a first run after a kernel change);
``--phases a,b`` runs a subset (then no final ``ok`` line is printed).
"""

from __future__ import annotations

import argparse
import ctypes
import functools
import json
import math
import os
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile
from torch.profiler import schedule as profiler_schedule

import polarcode_and_ldpc_tpu_torch as fec
from polarcode_and_ldpc_tpu_torch import ops
from polarcode_and_ldpc_tpu_torch.convert import qc_code_from_numpy
from polarcode_and_ldpc_tpu_torch.channels.awgn import awgn_noise_std, awgn_transmit
from polarcode_and_ldpc_tpu_torch.channels.bsc import bsc_llr, bsc_transmit
from polarcode_and_ldpc_tpu_torch.core import rng
from polarcode_and_ldpc_tpu_torch.models.ldpc.encoder import gf2_matmul
from polarcode_and_ldpc_tpu_torch.models.ldpc.graph import TannerGraph
from polarcode_and_ldpc_tpu_torch.models.polar.construction import (bit_reverse_permutation,
                                                                    frozen_mask_from_positions,
                                                                    monte_carlo_reliabilities)
from polarcode_and_ldpc_tpu_torch.models.polar.crc import CRCCodec
from polarcode_and_ldpc_tpu_torch.models.polar.encoder import polar_transform
from polarcode_and_ldpc_tpu_torch.models.polar.fastsc import make_sc_decoder_unrolled
from polarcode_and_ldpc_tpu_torch.models.polar.sc import make_sc_decoder
from polarcode_and_ldpc_tpu_torch.models.polar.scanscl import (build_scl_schedule,
                                                               super_touch_sets)
from polarcode_and_ldpc_tpu_torch.models.polar.scl import make_scl_decoder, select_best_path
from polarcode_and_ldpc_tpu_torch.models.polar.trellis import f_minsum
from polarcode_and_ldpc_tpu_torch.ops import build, scl_cuda
from polarcode_and_ldpc_tpu_torch.ops.bp_cuda import (BPKernelPlan, bp_decode_cuda,
                                                      resident_blocks_per_sm)
from polarcode_and_ldpc_tpu_torch.ops.sc_mega_cuda import (SCProgram, hybrid_sub_n,
                                                          launch_plan, make_sc_decoder_mega,
                                                          sc_decode_cuda)
from polarcode_and_ldpc_tpu_torch.ops.roll_cuda import (PROBE_SHAPE, PROBE_SHIFT, sublane_roll,
                                                        sublane_roll_cuda, sublane_roll_plain)
from polarcode_and_ldpc_tpu_torch.ops.fastnode_cuda import (STREAM_MAX_K, fastnode_select,
                                                            fastnode_select_cuda,
                                                            fastnode_select_plain)
from polarcode_and_ldpc_tpu_torch.ops.scl_cuda import (OP_COMBINE, OP_F, OP_G, OP_LEAF, OP_RATE1_FAST,
                                                       OP_REP, OP_REP_FAST, OP_SUBTREE,
                                                       PREFIX_PARAM_ROWS, SCLBodyProgram,
                                                       SCLMegaPlan, SCLPrefixSpec, SCLState,
                                                       build_mega_tables,
                                                       context_in_device_memory,
                                                       launch_chunk_body, launch_chunk_step,
                                                       launch_last_chunk, launch_mega,
                                                       make_step_specs, scl_chunk_body_cuda,
                                                       scl_chunk_step_cuda, scl_decode_mega_cuda,
                                                       scl_last_chunk_cuda,
                                                       scl_narrow_prefix_cuda)
from polarcode_and_ldpc_tpu_torch.sim import (MonteCarloSimulator, make_channel_fn,
                                              make_ldpc_pipeline, make_polar_pipeline)

DEV = "cuda"

# published peaks of one H100 SXM (dense, full power limit): device-memory
# rate and float32 rate outside the tensor cores
HBM_BYTES_PER_S = 3.35e12
F32_FLOP_PER_S = 67e12
# float operations per edge and iteration that the LDPC kernel performs
# (check update + variable update), transcendental calls counted as one each
OPS_PER_EDGE_ITER = {"bp": 14, "ms": 12, "layered": 16}

POLAR_N, POLAR_K = 1024, 512
POLAR_CHUNK = 16384
LDPC_N, LDPC_K, LDPC_CHUNK, LDPC_ITERS = 504, 252, 4096, 20
# an SNR (Es/N0) at which both codes make frame errors often enough (about
# one frame in seven) for the early-stop and invariance phases to count some
LOW_SNR_DB = -1.0
# the CA-SCL-8 path: CRC-8, list 8, subtree chunk 128 (8 chunks: 7 chunk-step
# launches and 1 last-chunk launch per decode), 4096 frames per Monte-Carlo
# chunk; the list decoder still makes about one frame error in seven at -2 dB
SCL_L, SCL_S, SCL_CRC, SCL_CHUNK = 8, 128, "CRC-8", 4096
SCL_LOW_SNR_DB = -2.0

# the serving paths: row-layered min-sum on the (504, 252) code; the
# quasi-cyclic n=8192 code (a chunk of 1024 frames is about 100 MB of
# messages); the adaptive SC-first CA-SCL decoder on batches of 8192 frames at
# three operating points: no fallback, some fallback within the budget of 512,
# budget overflow
LDPC_LAYERS = 4
QC_N, QC_K, QC_Z, QC_CHUNK = 8192, 4096, 512, 1024
QC_LOW_SNR_DB = -1.5
SERVE_BATCH = 8192
SERVE_SNRS_DB = {"no_fallback": 3.0, "some_fallback": -0.25, "budget_overflow": -1.0}

# the fast-node slice: CA-SCL-8 with node_mode="fast" on the same code and
# chunks; the SNR-curve CLI at full width on a few points
SNR_CURVE_ARGS = ["--polar-n", "1024", "--ldpc-n", "1008", "--rates", "0.5",
                  "--snr-range=-1:1:1", "--num-frames", "16384", "--max-errors", "200",
                  "--batch-size", "4096", "--polar-algorithm", "ca_scl",
                  "--scl-node-mode", "fast", "--skip-plots", "--seed", "42"]

PHASES = ("device", "build", "kernels", "scl_kernels", "scl_profile", "sc_profile",
          "fast_kernels",
          "large_kernels",
          "onehot_kernels", "polar_sc_mc", "polar_cascl_mc", "polar_fast_mc",
          "polar_scl8_controls", "ldpc_mc", "ldpc_layered_mc",
          "ldpc_qc_mc", "polar_large_mc", "polar_sc_large_mc", "ldpc_large_mc", "serving",
          "serving_fast", "snr_curves", "channels_mc", "throughput", "run_benchmark",
          "code_params", "sc_vs_scl", "construction", "twins", "sharded", "oracle",
          "invariance", "stages")


def emit(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields}), flush=True)


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def time_ms(fn, reps: int, warmup: int = 2) -> float:
    """Mean milliseconds of ``fn()`` by CUDA events, after a warm-up."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def device_ms(fn, reps: int, expect: "int | None" = None, tries: int = 3) -> dict:
    """Device time of ``fn()`` by ``torch.profiler`` (CUPTI times each kernel
    on the card, whatever the host costs): the mean per call of the summed
    kernel durations over ``reps`` calls after a warm-up, and the kernels per
    call.  ``expect`` is the kernels one call launches (by default the
    package's launch counters over the warm-up call).  The profiler can drop
    events (the first launches of a session): each reading follows a step of
    ``reps`` calls whose events it discards, and a reading that saw another
    count is taken again, up to ``tries`` times, and is "not measured" (with
    the count it saw) when none saw exactly ``expect``."""
    before = sum(ops.launch_counts().values())
    fn()
    torch.cuda.synchronize()
    if expect is None:
        expect = sum(ops.launch_counts().values()) - before
    seen = 0.0
    for _ in range(tries):
        with profile(activities=[ProfilerActivity.CUDA],
                     schedule=profiler_schedule(wait=0, warmup=1, active=1, repeat=1)) as prof:
            for _ in range(2):  # the discarded step, then the one read
                for _ in range(reps):
                    fn()
                torch.cuda.synchronize()
                prof.step()
        kernels = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
        seen = sum(e.count for e in kernels) / reps
        if seen == expect:
            return {"ms": sum(e.self_device_time_total for e in kernels) / 1e3 / reps,
                    "kernels_per_call": seen}
    return {"ms": "not measured", "kernels_per_call": seen, "expected": expect}


def seeded_llrs(codewords: torch.Tensor, snr_db: float, seed: int) -> torch.Tensor:
    """Channel LLRs of int8 codewords on the card from seeded numpy noise."""
    std = awgn_noise_std(snr_db)
    noise = np.random.default_rng(seed).standard_normal(tuple(codewords.shape), dtype=np.float32)
    y = (1.0 - 2.0 * codewords.to(torch.float32)) + std * torch.from_numpy(noise).to(DEV)
    return (2.0 * y / (std * std)).contiguous()


# the BSC batches of the kernel holds: every LLR ±log((1 − p)/p), and at
# p = 0.5 every LLR ±0.0 (a received 1 gives −0.0), so every sum is a tie
BSC_HOLD_PROBS = (0.05, 0.5)


def bsc_llrs(codewords: torch.Tensor, p: float, seed: int) -> torch.Tensor:
    """BSC LLRs of int8 codewords on the card, each frame keyed by its row."""
    keys = rng.frame_keys(rng.prng_key(seed, DEV),
                          torch.arange(codewords.shape[0], device=DEV))
    return bsc_llr(bsc_transmit(keys, codewords, p), p).contiguous()


# -- phases --------------------------------------------------------------------

def phase_device() -> dict:
    line = nvidia_smi_line()
    emit("device", nvidia_smi=line, name=torch.cuda.get_device_name(0),
         torch=torch.__version__, cuda=torch.version.cuda,
         python=sys.version.split()[0])
    # known-answer test of the cipher on the card (Random123 test vector)
    k = torch.tensor([0x13198a2e, 0x03707344], dtype=torch.int64, device=DEV).to(torch.int32)
    x = torch.tensor([0x243f6a88, 0x85a308d3 - (1 << 32)], dtype=torch.int64,
                     device=DEV).to(torch.int32)
    y0, y1 = rng.threefry2x32(k[0], k[1], x[0], x[1])
    got = [int(y0) & 0xFFFFFFFF, int(y1) & 0xFFFFFFFF]
    if got != [0xc4923a9c, 0x483df7a0]:
        raise AssertionError(f"threefry2x32 known-answer test failed on the card: {got}")
    return {"nvidia_smi": line}


def phase_build(verbose: bool, variants: tuple = ()) -> None:
    seconds = build.build_all(verbose=verbose, variants=variants)
    for name in (*build.SOURCES, *variants):
        build.load(name)
    emit("build", seconds=round(seconds, 3), sources=[f"{s}.cu" for s in build.SOURCES],
         flags=" ".join(build.NVCC_FLAGS))


def polar_code(N: int = POLAR_N, K: int = POLAR_K):
    frozen, info = fec.construct_polar_code(N, K, "bhattacharyya", 2.0)
    return frozen, info, frozen_mask_from_positions(N, frozen)


def ldpc_code():
    return fec.LDPCEncoder(LDPC_N, LDPC_K, dv=3, dc=6, seed=42, device=DEV)


def check_sc_kernel(results: dict, reps: int) -> None:
    frozen, info, mask = polar_code()
    enc = fec.PolarEncoder(POLAR_N, POLAR_K, frozen_bits=frozen, device=DEV)
    cases = []
    worst = 0
    for fast in (True, False):
        program = SCProgram(POLAR_N, mask, fast_nodes=fast)
        for B in (4096, 1000):
            for snr in (-1.0, 1.0, 3.0):
                msgs = np.random.default_rng(B + int(snr)).integers(0, 2, (B, POLAR_K))
                llr = seeded_llrs(enc.encode(msgs), snr, seed=7 * B + int(10 * snr) + 100)
                got = sc_decode_cuda(llr, program)
                torch.cuda.synchronize()
                want = program.plain(llr)
                diff = int((got != want).sum())
                worst = max(worst, diff)
                cases.append({"B": B, "snr_db": snr, "fast_nodes": fast, "diff_bits": diff})
        # tie-adversarial input: small integer LLRs with many zeros and ties
        q = torch.from_numpy(np.random.default_rng(5).integers(
            -3, 4, (512, POLAR_N)).astype(np.float32)).to(DEV)
        diff = int((sc_decode_cuda(q, program) != program.plain(q)).sum())
        worst = max(worst, diff)
        cases.append({"B": 512, "input": "integer ties", "fast_nodes": fast, "diff_bits": diff})
        cw = enc.encode(np.random.default_rng(6).integers(0, 2, (512, POLAR_K)))
        for p in BSC_HOLD_PROBS:
            q = bsc_llrs(cw, p, seed=13)
            diff = int((sc_decode_cuda(q, program) != program.plain(q)).sum())
            worst = max(worst, diff)
            cases.append({"B": 512, "input": f"bsc p={p}", "fast_nodes": fast, "diff_bits": diff})
    # the main path's shape: one Monte-Carlo chunk
    program = SCProgram(POLAR_N, mask, fast_nodes=True)
    msgs = np.random.default_rng(11).integers(0, 2, (POLAR_CHUNK, POLAR_K))
    llr = seeded_llrs(enc.encode(msgs), 3.0, seed=12)
    got = sc_decode_cuda(llr, program)
    want = program.plain(llr)
    max_abs = int((got.to(torch.int16) - want.to(torch.int16)).abs().max())
    worst = max(worst, int((got != want).sum()))
    ms = time_ms(lambda: sc_decode_cuda(llr, program), reps)
    plain_ms = time_ms(lambda: program.plain(llr), max(1, reps // 5), warmup=1)
    byts = POLAR_CHUNK * POLAR_N * 5
    flops = POLAR_CHUNK * POLAR_N * int(math.log2(POLAR_N))
    t_b, t_o = byts / HBM_BYTES_PER_S * 1e3, flops / F32_FLOP_PER_S * 1e3
    results["sc_decode"] = {
        "name": "sc_decode", "route": "cuda",
        "source": "polarcode_and_ldpc_tpu_torch/ops/csrc/sc_decode.cu",
        "replaces": "polarcode_and_ldpc_tpu/ops/sc_mega_pallas.py:126",
        "launches": 0, "max_abs_err": max_abs, "ms": ms, "plain_ms": plain_ms,
        "bound_ms": max(t_b, t_o), "bound_by": "bytes" if t_b >= t_o else "operations",
        "library_ms": None,
        "shape": [POLAR_CHUNK, POLAR_N], "n_ops": int(program.ops.shape[0]),
        "n_ops_exact_nodes": int(SCProgram(POLAR_N, mask, fast_nodes=False).ops.shape[0]),
        "launch_plan": launch_plan(program, POLAR_CHUNK, 0)._asdict(),
        "tolerance": "bit-identical", "cases": cases,
    }
    if worst:
        raise AssertionError(f"sc_decode disagrees with its plain version: {cases}")


def check_bp_kernel(results: dict, reps: int) -> None:
    enc = ldpc_code()
    graph = TannerGraph.from_H(enc.H, DEV)
    irregular = TannerGraph.from_H(
        fec.mackay_construction(LDPC_N, LDPC_K, 3, 6, seed=1), DEV)
    rules = {"bp": ("bp", 1.0, 0.0), "ms": ("ms", 1.0, 0.0),
             "nms": ("ms", 0.75, 0.0), "oms": ("ms", 1.0, 0.5)}
    cases = []
    sp_frames = sp_differ = 0
    for name, (rule, alpha, beta) in rules.items():
        for early in (True, False):
            plan = BPKernelPlan(graph, LDPC_ITERS, early, rule, alpha, beta)
            for B in (4096, 999):
                for snr in (-1.0, 1.0, 3.0):
                    msgs = np.random.default_rng(B + int(snr)).integers(0, 2, (B, LDPC_K))
                    llr = seeded_llrs(enc.encode(msgs), snr, seed=3 * B + int(10 * snr) + 100)
                    bits, iters = bp_decode_cuda(llr, plan)
                    torch.cuda.synchronize()
                    pbits, piters = plan.plain(llr)
                    differ = int(((bits != pbits).any(dim=1) | (iters != piters)).sum())
                    cases.append({"rule": name, "early_stop": early, "B": B,
                                  "snr_db": snr, "frames_differ": differ})
                    if rule == "bp":
                        sp_frames += B
                        sp_differ += differ
                    elif differ:
                        raise AssertionError(f"bp_decode[{name}] is not bit-identical: {cases[-1]}")
        # BSC batches (all ±c, all ±0.0): bit for bit under every rule
        plan = BPKernelPlan(graph, LDPC_ITERS, True, rule, alpha, beta)
        cw = enc.encode(np.random.default_rng(7).integers(0, 2, (999, LDPC_K)))
        for p in BSC_HOLD_PROBS:
            llr = bsc_llrs(cw, p, seed=17)
            bits, iters = bp_decode_cuda(llr, plan)
            pbits, piters = plan.plain(llr)
            differ = int(((bits != pbits).any(dim=1) | (iters != piters)).sum())
            cases.append({"rule": name, "input": f"bsc p={p}", "B": 999, "frames_differ": differ})
            if differ:
                raise AssertionError(f"bp_decode[{name}] is not bit-identical: {cases[-1]}")
        # padded slots: an irregular (MacKay) graph of the same size, odd batch
        plan = BPKernelPlan(irregular, LDPC_ITERS, True, rule, alpha, beta)
        llr = seeded_llrs(torch.zeros((777, LDPC_N), dtype=torch.int8, device=DEV), 2.0, seed=99)
        bits, iters = bp_decode_cuda(llr, plan)
        pbits, piters = plan.plain(llr)
        differ = int(((bits != pbits).any(dim=1) | (iters != piters)).sum())
        cases.append({"rule": name, "graph": "mackay (padded slots)", "B": 777,
                      "frames_differ": differ})
        if rule == "bp":
            sp_frames += 777
            sp_differ += differ
        elif differ:
            raise AssertionError(f"bp_decode[{name}] is not bit-identical: {cases[-1]}")
    if sp_differ > 1e-3 * sp_frames:
        raise AssertionError(
            f"bp_decode[bp]: {sp_differ} of {sp_frames} frames differ from the plain version")

    # the main path's shape: one Monte-Carlo chunk at 3 dB, bp and nms
    msgs = np.random.default_rng(21).integers(0, 2, (LDPC_CHUNK, LDPC_K))
    llr = seeded_llrs(enc.encode(msgs), 3.0, seed=22)
    for key, (rule, alpha) in {"bp_decode_bp": ("bp", 1.0), "bp_decode_ms": ("ms", 0.75)}.items():
        plan = BPKernelPlan(graph, LDPC_ITERS, True, rule, alpha, 0.0)
        bits, iters = bp_decode_cuda(llr, plan)
        pbits, piters = plan.plain(llr)
        max_abs = max(int((bits.to(torch.int16) - pbits.to(torch.int16)).abs().max()),
                      int((iters - piters).abs().max()))
        ms = time_ms(lambda: bp_decode_cuda(llr, plan), reps)
        plain_ms = time_ms(lambda: plan.plain(llr), max(1, reps // 5), warmup=1)
        byts = LDPC_CHUNK * (5 * LDPC_N + 4)
        flops = graph.num_edges * int(iters.sum()) * OPS_PER_EDGE_ITER[rule]
        t_b, t_o = byts / HBM_BYTES_PER_S * 1e3, flops / F32_FLOP_PER_S * 1e3
        results[key] = {
            "name": key, "route": "cuda",
            "source": "polarcode_and_ldpc_tpu_torch/ops/csrc/bp_decode.cu",
            "replaces": "polarcode_and_ldpc_tpu/ops/bp_pallas.py:140",
            "launches": 0, "max_abs_err": max_abs, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": max(t_b, t_o), "bound_by": "bytes" if t_b >= t_o else "operations",
            "library_ms": None,
            "shape": [LDPC_CHUNK, LDPC_N], "mean_iterations": float(iters.float().mean()),
            "tolerance": ("bit-identical bits and iteration counts" if rule == "ms" else
                          "identical bits and iteration counts on >= 99.9 % of frames"),
            "sum_product_frames_differ": sp_differ if rule == "bp" else None,
            "sum_product_frames": sp_frames if rule == "bp" else None,
            "bytes_per_frame": plan.smem_bytes, "threads": plan.threads, **bp_blocks(plan),
        }
        if rule == "ms" and max_abs:
            raise AssertionError("bp_decode[nms] is not bit-identical at the main path's shape")
    results["bp_decode_bp"]["cases"] = cases


def check_bp_layered_kernel(results: dict, reps: int, quick: bool) -> None:
    """The layered mode of the LDPC kernel against its plain version: bits and
    iteration counts must be equal on every frame (min-sum is exact)."""
    enc = ldpc_code()
    graph = TannerGraph.from_H(enc.H, DEV)
    irregular = TannerGraph.from_H(
        fec.mackay_construction(LDPC_N, LDPC_K, 3, 6, seed=1), DEV)
    rules = {"nms": (0.75, 0.0), "oms": (1.0, 0.5), "ms": (1.0, 0.0)}
    cases = []

    def hold(plan, llr, context):
        bits, iters = bp_decode_cuda(llr, plan)
        torch.cuda.synchronize()
        pbits, piters = plan.plain(llr)
        differ = int(((bits != pbits).any(dim=1) | (iters != piters)).sum())
        cases.append({**context, "frames_differ": differ})
        if differ:
            raise AssertionError(f"bp_decode[layered] is not bit-identical: {cases[-1]}")

    inputs = [(B, snr, seeded_llrs(enc.encode(np.random.default_rng(B + int(snr)).integers(
        0, 2, (B, LDPC_K))), snr, seed=5 * B + int(10 * snr) + 100))
        for B in (4096, 999) for snr in (-1.0, 1.0, 3.0)]
    cw = enc.encode(np.random.default_rng(7).integers(0, 2, (999, LDPC_K)))
    inputs += [(999, f"bsc p={p}", bsc_llrs(cw, p, seed=19)) for p in BSC_HOLD_PROBS]
    padded = seeded_llrs(torch.zeros((777, LDPC_N), dtype=torch.int8, device=DEV), 2.0, seed=98)
    for name, (alpha, beta) in rules.items():
        for layers in (1, 4, 6):
            for early in (True, False):
                if quick and (layers, early) not in ((4, True), (6, False)):
                    continue
                plan = BPKernelPlan(graph, LDPC_ITERS, early, "ms", alpha, beta, "layered", layers)
                for B, snr, llr in inputs:
                    hold(plan, llr, {"rule": name, "num_layers": layers, "early_stop": early,
                                     "B": B, "snr_db": snr})
            plan = BPKernelPlan(irregular, LDPC_ITERS, True, "ms", alpha, beta, "layered", layers)
            hold(plan, padded, {"rule": name, "num_layers": layers,
                                "graph": "mackay (padded slots)", "B": 777})

    # the main path's shape: one Monte-Carlo chunk at 3 dB, NMS 0.75, 4 layers
    msgs = np.random.default_rng(21).integers(0, 2, (LDPC_CHUNK, LDPC_K))
    llr = seeded_llrs(enc.encode(msgs), 3.0, seed=22)
    plan = BPKernelPlan(graph, LDPC_ITERS, True, "ms", 0.75, 0.0, "layered", LDPC_LAYERS)
    bits, iters = bp_decode_cuda(llr, plan)
    pbits, piters = plan.plain(llr)
    max_abs = max(int((bits.to(torch.int16) - pbits.to(torch.int16)).abs().max()),
                  int((iters - piters).abs().max()))
    if max_abs:
        raise AssertionError("bp_decode[layered] is not bit-identical at the main path's shape")
    ms = time_ms(lambda: bp_decode_cuda(llr, plan), reps)
    plain_ms = time_ms(lambda: plan.plain(llr), max(1, reps // 5), warmup=1)
    byts = LDPC_CHUNK * (5 * LDPC_N + 4)
    flops = graph.num_edges * int(iters.sum()) * OPS_PER_EDGE_ITER["layered"]
    t_b, t_o = byts / HBM_BYTES_PER_S * 1e3, flops / F32_FLOP_PER_S * 1e3
    results["bp_decode_layered"] = {
        "name": "bp_decode_layered", "route": "cuda",
        "source": "polarcode_and_ldpc_tpu_torch/ops/csrc/bp_decode.cu",
        "replaces": "polarcode_and_ldpc_tpu/ops/bp_pallas.py:140",
        "launches": 0, "max_abs_err": max_abs, "ms": ms, "plain_ms": plain_ms,
        "bound_ms": max(t_b, t_o), "bound_by": "bytes" if t_b >= t_o else "operations",
        "library_ms": None,
        "shape": [LDPC_CHUNK, LDPC_N], "num_layers": LDPC_LAYERS,
        "mean_iterations": float(iters.float().mean()), "bytes_per_frame": plan.smem_bytes,
        "threads": plan.threads, **bp_blocks(plan),
        "tolerance": "bit-identical bits and iteration counts", "cases": cases,
    }


# -- the SCL kernels -------------------------------------------------------------

def max_err(a: torch.Tensor, b: torch.Tensor) -> float:
    """Largest absolute difference; equal infinities count as 0, an integer
    mismatch as 1, a float that differs only in its bit pattern (-0.0 against
    0.0) as the smallest subnormal."""
    if not a.dtype.is_floating_point:
        return float((a != b).any())
    d = torch.where(a == b, torch.zeros_like(a), (a - b).abs())
    worst = float(torch.nan_to_num(d, nan=math.inf).max())
    if worst == 0.0 and not torch.equal(a.contiguous().view(torch.int32),
                                        b.contiguous().view(torch.int32)):
        return 1.4e-45
    return worst


def first_difference(a: torch.Tensor, b: torch.Tensor) -> dict:
    if a.dtype.is_floating_point:
        bad = a.contiguous().view(torch.int32) != b.contiguous().view(torch.int32)
    else:
        bad = a != b
    where = torch.nonzero(bad)[0].tolist()
    return {"frame": where[0], "index": where[1:], "kernel": a[tuple(where)].item(),
            "plain": b[tuple(where)].item(), "differing_elements": int(bad.sum())}


def hold_equal(what: str, pairs: dict, context: dict) -> float:
    """Every named (kernel, plain) pair must be bit-identical."""
    worst = 0.0
    for name, (got, want) in pairs.items():
        err = max_err(got, want)
        if err:
            raise AssertionError(
                f"{what}: {name} differs from the plain version: "
                f"{json.dumps({**context, **first_difference(got, want)})}")
        worst = max(worst, err)
    return worst


def scl_flagship():
    frozen, info, mask = polar_code()
    sched = build_scl_schedule(POLAR_N, mask, SCL_L, SCL_S)
    steps, last = make_step_specs(sched)
    rev = torch.as_tensor(np.asarray(bit_reverse_permutation(POLAR_N)), dtype=torch.int64,
                          device=DEV)
    return frozen, info, mask, sched, steps, last, rev


def flagship_narrow_steps() -> int:
    """Chunk steps of a flagship decode that run narrow (live width on the
    kernel control): the positions entering with fewer live paths than L."""
    _, _, mask = polar_code()
    return sum(w < SCL_L for w in build_scl_schedule(POLAR_N, mask, SCL_L, SCL_S).lv_in[:-1])


def prefix_launches(n_narrow: int) -> int:
    """``scl_narrow_prefix`` launches of a decode with ``n_narrow`` narrow
    steps: one, or consecutive launches of at most ``PREFIX_PARAM_ROWS``
    rows for a longer prefix (none without a narrow step)."""
    return -(-n_narrow // PREFIX_PARAM_ROWS)


def cascl_llrs(frozen, B: int, snr_db: float, seed: int) -> torch.Tensor:
    enc = fec.PolarEncoder(POLAR_N, POLAR_K, frozen_bits=frozen, use_crc=True,
                           crc_polynomial=SCL_CRC, device=DEV)
    msgs = np.random.default_rng(seed).integers(0, 2, (B, enc.K_data))
    return seeded_llrs(enc.encode(msgs), snr_db, seed=seed + 1000)


def body_flops(program, w=None) -> int:
    """Float and compare operations that one chunk body needs per frame, not
    what the kernel spends: 3 per f or g element; 7 per log-likelihood, so 14
    per path at a leaf for its two candidates; a stable top-L of the 2L
    candidates as a sort's 2L * ceil(log2(2L)) compares (the kernel ranks all
    pairs, (2L)^2); a rate-0 or repetition node as its zero-decision pass
    (sz/2 * log2(sz) butterflies of 4 operations per path), sz
    log-likelihoods and the sz - 1 adds of their sum.  A rate-0 node branches
    nothing; a repetition node ends in one leaf.  Fast nodes: a rate-1 node
    as its penalty (4 per softplus, sz - 1 adds), K = min(L - 1, sz) passes
    of sz compares per path for its least reliable positions, sz hard
    decisions, and K stages of L subtractions and a top-L; a fast repetition
    node as 2 * 7 log-likelihoods and 2 (sz - 1) adds per path, 2L adds and
    one top-L.  From ``w`` live paths (live width) the count follows the
    live paths, doubling at every leaf up to L."""
    L, total = program.L, 0
    w = L if w is None else w
    top = 2 * L * math.ceil(math.log2(2 * L))
    # the work of the nodes, not of the kernel's program: an in-register
    # subtree op counts as the per-node ops it stands for
    node_ops = scl_cuda.build_scl_body_program(program.flags, "fast" if program.fast else "exact",
                                               program.L, subtrees=False)[0]

    def leaf() -> int:
        return 14 * w + 2 * w * max(1, math.ceil(math.log2(2 * w)))

    for op, _, sz, _ in node_ops.tolist():
        kind = op & 0xFF
        if kind in (OP_F, OP_G):
            total += 3 * w * sz
        elif kind == OP_COMBINE:
            total += sz * (1 + w)
        elif kind == OP_LEAF:
            total += leaf()
            w = min(2 * w, L)
        elif kind == OP_RATE1_FAST:
            k = min(L - 1, sz)
            total += L * (4 * sz + sz - 1 + k * sz + sz) + k * (L + top)
        elif kind == OP_REP_FAST:
            total += L * (14 * sz + 2 * (sz - 1)) + 2 * L + top
        else:
            total += w * (2 * sz * int(math.log2(sz)) + 7 * sz + sz - 1)
            if kind == OP_REP:
                total += leaf()
                w = min(2 * w, L)
    return total


def step_cost(sched, c: int, spec) -> tuple[int, int]:
    """(bytes, operations) per frame of chunk step ``c``: every touched level
    read once and written once (``super_touch_sets`` at the spec's compose
    masks), pendings (``L`` words each, ``L²`` for a one-hot plane) and
    metrics, at the step's live width (``spec.lv_in``: L at full width)."""
    t, L, sizes = sched.t, spec.lv_in, sched.sizes
    masks = [frozenset(i for i in range(t) if (m >> i) & 1) for m in (spec.mask_a, spec.mask_b)]
    touch = super_touch_sets(int(sched.desc_k[c]), int(sched.asc_j[c]), t, *masks)
    rows = 1 if spec.inv or spec.k == t else L
    pend = 4 * L * (L if spec.program.onehot else 1)
    byts = (4 * sched.N * touch["needs_llr"]
            + sum(4 * rows * sizes[i + 1] for i in touch["alpha_read"])
            + sum(4 * sizes[i + 1] for i in touch["beta_read"])
            + pend * (len(touch["pend_a_in"]) + len(touch["pend_b_in"])) + 4 * L
            + sum(4 * L * sizes[i + 1] for i in touch["alpha_write"])
            + sum(4 * sizes[i + 1] for i in touch["beta_write"])
            + pend * (len(touch["pend_a_out"]) + len(touch["pend_a_eye"])
                      + len(touch["pend_b_out"]) + len(touch["pend_b_eye"])) + 4 * L)
    flops = (body_flops(spec.program, L)
             + sum(3 * L * sizes[i + 1] for i in touch["alpha_write"])
             + sum((1 + L) * sizes[i + 1] for i in touch["beta_read"]))
    return byts, flops


def last_cost(sched, spec) -> tuple[int, int]:
    """(bytes, operations) per frame of the last chunk: the parent alpha, the
    left betas, the pendings it reads (pend_a above level t, every pend_b;
    ``L²`` words each when one-hot), the metrics, u and the metrics out."""
    t, L, N, S = sched.t, sched.L, sched.N, sched.S
    pend = 4 * L * (L if spec.program.onehot else 1)
    byts = (4 * (N if t == 1 else 2 * S * L) + 4 * (N - S) + pend * (t + (t > 1)) + 4 * L
            + L * N + 4 * L)
    flops = body_flops(spec.program) + 3 * L * S + (1 + L) * (N - S) + N * int(math.log2(N)) // 2
    return byts, flops


def kernel_row(name, source_line, ms, plain_ms, byts, flops, err,
               source="polarcode_and_ldpc_tpu_torch/ops/csrc/scl_decode.cu", **extra) -> dict:
    t_b, t_o = byts / HBM_BYTES_PER_S * 1e3, flops / F32_FLOP_PER_S * 1e3
    return {"name": name, "route": "cuda", "source": source,
            "replaces": source_line, "launches": 0, "max_abs_err": err, "ms": ms,
            "plain_ms": plain_ms, "bound_ms": max(t_b, t_o),
            "bound_by": "bytes" if t_b >= t_o else "operations", "library_ms": None,
            "tolerance": "bit-identical", **extra}


def check_scl_bodies(sched, programs, B: int) -> float:
    """K5 alone against the plain chunk body on every distinct frozen pattern
    of the code's chunks."""
    worst = 0.0
    L, S = sched.L, sched.S
    for pid, program in enumerate(programs):
        for case in ("random", "phantoms", "ties"):
            g = np.random.default_rng(100 * pid + len(case) + B)
            if case == "ties":
                alpha = g.integers(-2, 3, (B, L, S)).astype(np.float32)
                pm = -g.integers(0, 3, (B, L)).astype(np.float32)
            else:
                alpha = (2 * g.standard_normal((B, L, S))).astype(np.float32)
                pm = -np.abs(g.standard_normal((B, L))).astype(np.float32)
            if case == "phantoms":
                pm[:, 2:] = -np.inf
            alpha, pm = torch.from_numpy(alpha).to(DEV), torch.from_numpy(pm).to(DEV)
            keep = alpha.clone()
            got = scl_chunk_body_cuda(alpha, pm, program)
            torch.cuda.synchronize()
            want = program.plain(alpha, pm)
            context = {"pattern": pid, "case": case, "B": B}
            # the kernel reads its input plane where it lies: read only
            hold_equal("scl_chunk_body (its input)", {"alpha": (alpha, keep)}, context)
            worst = max(worst, hold_equal(
                "scl_chunk_body", dict(zip(("beta", "pm", "R"), zip(got, want))), context))
    return worst


def check_scl_steps(sched, steps, last, rev, llr: torch.Tensor, context: dict) -> float:
    """K3 on the level stacks of every chunk position reached by the plain
    version, then K4 on the stacks before the last chunk, which it must
    leave as they were (read only)."""
    worst = 0.0
    llr_rev = llr[:, rev].contiguous()
    state = SCLState(sched, llr_rev, "onehot" if last.program.onehot else "rank")
    fields = ("alpha", "beta", "pend_a", "pend_b", "pm")
    for c, spec in enumerate(steps):
        kern = state.clone()
        scl_chunk_step_cuda(kern, spec)
        torch.cuda.synchronize()
        state.load_plain(*spec.plain(llr_rev, *state.to_plain()))
        worst = max(worst, hold_equal(
            "scl_chunk_step", {f: (getattr(kern, f), getattr(state, f)) for f in fields},
            {**context, "chunk": c}))
    before = state.clone()
    u, pm = scl_last_chunk_cuda(state, last)
    torch.cuda.synchronize()
    hold_equal("scl_last_chunk (the state it read)",
               {f: (getattr(state, f), getattr(before, f)) for f in ("llr",) + fields},
               {**context, "chunk": sched.C - 1})
    u_rev, pm_plain = last.plain(llr_rev, *state.to_plain())
    worst = max(worst, hold_equal(
        "scl_last_chunk", {"u": (u, u_rev[..., rev]), "pm": (pm, pm_plain)},
        {**context, "chunk": sched.C - 1}))
    return worst


def mega_plans(sched) -> dict:
    """The one-launch decode's plans of a code: its default (the step table
    in the launch's parameters up to 80 chunks, else in device memory) and,
    for a code of more than one chunk whose table the parameters hold, the
    table forced into device memory (``scl_decode_mega_long``)."""
    plans = {"default": SCLMegaPlan(sched)}
    if plans["default"].table_in_params and sched.t > 0:
        plans["table in device memory"] = SCLMegaPlan(sched)
        plans["table in device memory"].table_in_params = False
    return plans


def hold_mega_plans(sched, llr, want, context: dict) -> dict:
    """Every plan of ``mega_plans`` on ``llr`` against ``want`` (u, metrics),
    bit for bit; returns the default plan's layout."""
    plans = mega_plans(sched)
    for name, plan in plans.items():
        u, m = scl_decode_mega_cuda(llr, plan)
        torch.cuda.synchronize()
        hold_equal(f"scl_decode_mega [{name}]", {"u": (u, want[0]), "metrics": (m, want[1])},
                   context)
    return {"mega_plans": list(plans),
            "mega_table": "parameters" if plans["default"].table_in_params else "device memory"}


def check_scl_other_codes() -> list:
    """One compiled build serves every code: other lengths, chunk sizes and
    list sizes (a single-chunk code, L = 1, L = 32 with path 31 in a word's
    sign bit) through the kernel controls (one launch per chunk, the chunk
    body inside the plain glue, the whole decode in one launch, under each of
    its plans) against the plain decoder."""
    out = []
    for N, K, S, L in ((256, 128, 32, 4), (128, 64, 128, 2), (128, 100, 8, 1),
                       (2048, 1024, 64, 16), (512, 256, 128, 32), (64, 20, 16, 3)):
        frozen, _ = fec.construct_polar_code(N, K, "bhattacharyya", 2.0)
        mask = frozen_mask_from_positions(N, frozen)
        g = np.random.default_rng(N + L)
        llr = torch.from_numpy((1.0 + 1.6 * g.standard_normal((203, N))).astype(np.float32))
        llr[:3] = torch.from_numpy(g.integers(-2, 3, (3, N)).astype(np.float32))
        llr = llr.to(DEV)
        want = make_scl_decoder(N, mask, L, chunk=S, control_impl="unroll-fused",
                                live_width=False, device=DEV)(llr)
        context = {"N": N, "K": K, "S": S, "L": L}
        for kw in ({}, {"control_impl": "unroll-fused", "body_impl": "cuda"},
                   {"control_impl": "mega"}):
            got = make_scl_decoder(N, mask, L, chunk=S, device=DEV, **kw)(llr)
            torch.cuda.synchronize()
            hold_equal(f"whole decode {kw or 'unroll-kernel'}",
                       {"u": (got[0], want[0]), "metrics": (got[1], want[1])}, context)
        layout = hold_mega_plans(build_scl_schedule(N, mask, L, S), llr, want, context)
        out.append({**context, **layout, "kernels_equal_plain": True})
    return out


# the source that launches each list kernel (the kernels themselves are in
# csrc/scl_kernels.cuh and csrc/scl_device.cuh)
SCL_SOURCE = {k: f"polarcode_and_ldpc_tpu_torch/ops/csrc/{f}.cu" for k, f in
              (("last", "scl_last"), ("body", "scl_body"), ("mega", "scl_mega"))}

# the TPU kernels the per-chunk kernels replace: exact mode, and the fast mode
# the same functions trace with node_mode="fast"
SCL_REPLACES = {
    "scl_chunk_step": "polarcode_and_ldpc_tpu/ops/scl_superchunk_pallas.py:167",
    "scl_last_chunk": "polarcode_and_ldpc_tpu/ops/scl_superchunk_pallas.py:356",
    "scl_chunk_body": "polarcode_and_ldpc_tpu/ops/scl_body_pallas.py:378",
    "scl_chunk_step_fast": "polarcode_and_ldpc_tpu/ops/scl_superchunk_pallas.py:173",
    "scl_last_chunk_fast": "polarcode_and_ldpc_tpu/ops/scl_superchunk_pallas.py:361",
    "scl_chunk_body_fast": "polarcode_and_ldpc_tpu/ops/scl_body_pallas.py:382",
    "scl_chunk_step_onehot": "polarcode_and_ldpc_tpu/ops/scl_superchunk_pallas.py:172",
    "scl_last_chunk_onehot": "polarcode_and_ldpc_tpu/ops/scl_superchunk_pallas.py:360",
    "scl_chunk_body_onehot": "polarcode_and_ldpc_tpu/ops/scl_body_pallas.py:381",
}


def time_scl_kernels(results: dict, sched, steps, last, rev, llr, worst: dict, reps: int,
                     plain_reps: int) -> tuple[int, int]:
    """Time K3 at every chunk position, K4, and K5 on every chunk's pattern,
    each beside its plain version, on the level stacks the decode of ``llr``
    reaches; write their rows (``_fast`` names for a fast node program,
    ``_onehot`` for one-hot permutations).  Returns the operations of the
    chunk steps and of the last chunk."""
    B = llr.shape[0]
    onehot = last.program.onehot
    suffix = "_fast" if last.program.fast else "_onehot" if onehot else ""
    llr_rev = llr[:, rev].contiguous()
    state = SCLState(sched, llr_rev, "onehot" if onehot else "rank")
    step_ms, step_plain_ms, body_ms, body_plain_ms, step_bound_ms = [], [], [], [], []
    step_bytes = step_flops = body_bytes = body_flops_total = 0
    L, S = sched.L, sched.S
    for c, spec in enumerate(steps + [last]):
        plain_ops = state.to_plain()
        alpha_t = plain_ops[0][sched.t - 1].contiguous()
        pm_c = state.pm.clone()
        body_ms.append(time_ms(lambda: scl_chunk_body_cuda(alpha_t, pm_c, spec.program), reps))
        body_plain_ms.append(time_ms(lambda: spec.program.plain(alpha_t, pm_c), plain_reps, warmup=1))
        body_bytes += B * (4 * L * S + 4 * L + L * S + 4 * L + (4 * L * L if onehot else 8 * L))
        body_flops_total += B * body_flops(spec.program)
        if spec is last:
            last_plain_ms = time_ms(lambda: last.plain(llr_rev, *plain_ops), plain_reps, warmup=1)
            last_ms = time_ms(lambda: scl_last_chunk_cuda(state, last), reps)
            continue
        step_plain_ms.append(time_ms(lambda: spec.plain(llr_rev, *plain_ops), plain_reps, warmup=1))
        scratch = state.clone()
        step_ms.append(time_ms(lambda: scl_chunk_step_cuda(scratch, spec), reps))
        byts, flops = step_cost(sched, c, spec)
        step_bytes += B * byts
        step_flops += B * flops
        step_bound_ms.append(max(B * byts / HBM_BYTES_PER_S, B * flops / F32_FLOP_PER_S) * 1e3)
        scl_chunk_step_cuda(state, spec)
    n_steps = len(steps)
    lb, lf = last_cost(sched, last)
    shape = {"frames": B, "N": sched.N, "S": S, "L": L}
    name = "scl_chunk_step" + suffix
    results[name] = kernel_row(
        name, SCL_REPLACES[name], sum(step_ms) / n_steps, sum(step_plain_ms) / n_steps,
        step_bytes / n_steps, step_flops / n_steps, worst["step"], shape=shape,
        note=f"ms, plain_ms and bound_ms are means per launch over the {n_steps} chunk positions",
        ms_per_position=step_ms, plain_ms_per_position=step_plain_ms,
        bound_ms_per_position=step_bound_ms, ms_per_decode=sum(step_ms),
        bound_ms_per_decode=sum(step_bound_ms), launches_per_decode=n_steps)
    name = "scl_last_chunk" + suffix
    results[name] = kernel_row(
        name, SCL_REPLACES[name], last_ms, last_plain_ms, B * lb, B * lf, worst["step"],
        source=SCL_SOURCE["last"], shape=shape, launches_per_decode=1)
    name = "scl_chunk_body" + suffix
    results[name] = kernel_row(
        name, SCL_REPLACES[name], sum(body_ms) / sched.C, sum(body_plain_ms) / sched.C,
        body_bytes / sched.C, body_flops_total / sched.C, worst["body"],
        source=SCL_SOURCE["body"], shape=shape,
        note=f"means per launch over the {sched.C} chunks' frozen patterns",
        ms_per_position=body_ms, plain_ms_per_position=body_plain_ms,
        n_ops_per_position=[int(s.program.ops.shape[0]) for s in steps + [last]])
    return step_flops, lf


def phase_scl_kernels(results: dict, reps: int, quick: bool) -> None:
    frozen, info, mask, sched, steps, last, rev = scl_flagship()
    programs = [s.program for s in steps] + [last.program]
    by_id = {id(p): p for p in programs}
    unique = list(by_id.values())
    info_idx = torch.as_tensor(info, dtype=torch.int64, device=DEV)
    crc = CRCCodec(POLAR_K - 8, SCL_CRC, DEV)
    cases = []
    worst = {"body": 0.0, "step": 0.0}
    for B in (512, 1000):
        worst["body"] = max(worst["body"], check_scl_bodies(sched, unique, B))

    decoders = {
        "plain": make_scl_decoder(POLAR_N, mask, SCL_L, chunk=SCL_S, control_impl="unroll-fused",
                                  live_width=False, device=DEV),
        "plain live width": make_scl_decoder(POLAR_N, mask, SCL_L, chunk=SCL_S,
                                             control_impl="unroll-fused", device=DEV),
        "unroll-kernel": make_scl_decoder(POLAR_N, mask, SCL_L, chunk=SCL_S, device=DEV),
        "body_impl=cuda": make_scl_decoder(POLAR_N, mask, SCL_L, chunk=SCL_S,
                                           control_impl="unroll-fused", body_impl="cuda",
                                           device=DEV),
        "mega": make_scl_decoder(POLAR_N, mask, SCL_L, chunk=SCL_S, control_impl="mega",
                                 device=DEV),
    }
    assert decoders["unroll-kernel"].control_impl == "unroll-kernel"
    assert decoders["mega"].control_impl == "mega"
    worst["mega"] = 0.0
    assert decoders["plain live width"].live_width
    inputs = [(B, snr, cascl_llrs(frozen, B, snr, seed=B + int(10 * snr) + 50))
              for B in (512, 1000) for snr in (-1.0, 1.0, 3.0)]
    ties = torch.from_numpy(np.random.default_rng(6).integers(
        -3, 4, (512, POLAR_N)).astype(np.float32)).to(DEV)
    inputs.append((512, "integer ties", ties))
    crc_enc = fec.PolarEncoder(POLAR_N, POLAR_K, frozen_bits=frozen, use_crc=True,
                               crc_polynomial=SCL_CRC, device=DEV)
    cw = crc_enc.encode(np.random.default_rng(8).integers(0, 2, (512, crc_enc.K_data)))
    inputs += [(512, f"bsc p={p}", bsc_llrs(cw, p, seed=23)) for p in BSC_HOLD_PROBS]
    for B, snr, llr in inputs:
        context = {"B": B, "snr_db": snr}
        worst["step"] = max(worst["step"], check_scl_steps(sched, steps, last, rev, llr, context))
        u0, m0 = decoders["plain"](llr)
        sel0 = select_best_path(u0[..., info_idx], m0, crc)
        for name in ("plain live width", "unroll-kernel", "body_impl=cuda", "mega"):
            u, m = decoders[name](llr)
            torch.cuda.synchronize()
            err = hold_equal(f"whole decode [{name}]", {
                "u": (u, u0), "metrics": (m, m0),
                "selected message": (select_best_path(u[..., info_idx], m, crc), sel0)}, context)
            if name == "mega":
                worst["mega"] = max(worst["mega"], err)
        cases.append({**context, "kernels_equal_plain": True,
                      "crc_pass_frames": int(crc.check(sel0).sum())})

    # the main path's shapes: one Monte-Carlo chunk of 4096 frames at 3 dB
    B = SCL_CHUNK
    llr = cascl_llrs(frozen, B, 3.0, seed=77)
    worst["step"] = max(worst["step"], check_scl_steps(sched, steps, last, rev, llr,
                                                       {"B": B, "snr_db": 3.0}))
    worst["body"] = max(worst["body"], check_scl_bodies(sched, unique, B))
    # the one-launch decode at the main path's shape: against the plain decoder
    # and against the per-chunk kernel control
    u_k, m_k = decoders["unroll-kernel"](llr)
    u_p, m_p = decoders["plain"](llr)
    u_m, m_m = decoders["mega"](llr)
    torch.cuda.synchronize()
    worst["mega"] = max(worst["mega"], hold_equal("scl_decode_mega", {
        "u vs plain": (u_m, u_p), "metrics vs plain": (m_m, m_p),
        "u vs unroll-kernel": (u_m, u_k), "metrics vs unroll-kernel": (m_m, m_k)},
        {"B": B, "snr_db": 3.0}))
    mega_layout = hold_mega_plans(sched, llr, (u_p, m_p), {"B": B, "snr_db": 3.0})
    # the serving list pass's batch (67 frames at -0.25 dB) and a batch one
    # frame past a wave of 32 warps on each of 132 SMs
    mega_batches = []
    for B_x, snr in ((67, -0.25), (132 * 32 + 1, 1.0)):
        x = cascl_llrs(frozen, B_x, snr, seed=B_x + 3)
        want = decoders["plain"](x)
        got, per_chunk = decoders["mega"](x), decoders["unroll-kernel"](x)
        torch.cuda.synchronize()
        context = {"B": B_x, "snr_db": snr}
        worst["mega"] = max(worst["mega"], hold_equal("scl_decode_mega", {
            "u vs plain": (got[0], want[0]), "metrics vs plain": (got[1], want[1]),
            "u vs unroll-kernel": (got[0], per_chunk[0]),
            "metrics vs unroll-kernel": (got[1], per_chunk[1])}, context))
        hold_mega_plans(sched, x, want, context)
        mega_batches.append({**context, "kernels_equal_plain": True})
    plain_reps = 1 if quick else 2
    step_flops, lf = time_scl_kernels(results, sched, steps, last, rev, llr, worst, reps,
                                      plain_reps)
    L = sched.L
    shape = {"frames": B, "N": POLAR_N, "S": sched.S, "L": L}
    decode_ms = {name: time_ms(lambda: dec(llr), reps if "plain" not in name else plain_reps,
                               warmup=1)
                 for name, dec in decoders.items() if name != "plain live width" or not quick}
    # the one-launch decode: LLRs in, u and metrics out; the operations of the
    # seven chunk steps and the last chunk
    results["scl_decode_mega"] = kernel_row(
        "scl_decode_mega", "polarcode_and_ldpc_tpu/ops/scl_mega_pallas.py:73",
        decode_ms["mega"], decode_ms["plain"], B * (4 * POLAR_N + L * POLAR_N + 4 * L),
        step_flops + B * lf, worst["mega"], source=SCL_SOURCE["mega"], shape=shape,
        launches_per_decode=1,
        note="plain_ms is the plain chunk program (control_impl='unroll-fused', full width); "
             "the level stacks are scratch in device memory",
        ms_of_the_per_chunk_launches=decode_ms["unroll-kernel"], **mega_layout,
        other_batches=mega_batches)
    results["scl_decode_mega"]["resources"] = [
        r for r in scl_cuda.kernel_resources(sched.L, sched.S, sched.N, sched.t)
        if r["kernel"].startswith("scl_decode_mega")]
    emit("scl_kernels", kernels=[results[k] for k in ("scl_chunk_body", "scl_chunk_step",
                                                      "scl_last_chunk", "scl_decode_mega")],
         unique_patterns=len(unique), whole_decode_ms=decode_ms, cases=cases,
         other_codes=check_scl_other_codes())
    mega_resources(sched)
    last_resources(sched)
    body_resources(sched)


# the parts of a chunk step in the stage profile (ProfSlot of
# csrc/scl_device.cuh, in its order)
PROFILE_SLOTS = ("descend", "copy_in", "F w*size<32", "F w*size>=32", "G w*size<32",
                 "G w*size>=32", "COMBINE size<32", "COMBINE size>=32", "leaf + prune", "REP",
                 "rate-0", "rate-1 fast", "REP fast", "subtree", "body", "compose", "ascend",
                 "step", "last chunk", "butterfly", "decode", "rate-1 fast L*size<=32",
                 "REP fast L*size<=32", "fast node: sums", "fast node: selection and prunes",
                 "fast node: bits", "outputs", "one-hot load", "one-hot store")


def read_profile(lib, B: int, total: str) -> dict:
    """The profiled build's counters: each part's clock64() cycles per frame,
    ops per frame, and share of the cycles of part ``total``."""
    lib.scl_profile_read.argtypes = [ctypes.c_void_p]
    n = len(PROFILE_SLOTS)
    buf = (ctypes.c_ulonglong * (2 * n))()
    build.check_launch(lib, lib.scl_profile_read(ctypes.addressof(buf)), "scl_profile_read")
    whole = buf[PROFILE_SLOTS.index(total)]
    return {name: {"cycles_per_frame": buf[q] / B, "ops_per_frame": buf[n + q] / B,
                   f"share_of_{total}": buf[q] / whole if whole else None}
            for q, name in enumerate(PROFILE_SLOTS) if buf[n + q]}


def profile_step(state, spec) -> dict:
    """K3 of the profiled build (-DSCL_PROFILE) on a copy of ``state``: held
    against the normal build on the same copy, then each part's clock64()
    cycles per frame, ops per frame, and share of the step's cycles."""
    lib = build.load("scl_decode_profile")
    launch_chunk_step(state.clone(), spec, "scl_decode_profile")  # warm-up
    prof, plain = state.clone(), state.clone()
    torch.cuda.synchronize()
    build.check_launch(lib, lib.scl_profile_reset(), "scl_profile_reset")
    launch_chunk_step(prof, spec, "scl_decode_profile")
    scl_chunk_step_cuda(plain, spec)
    torch.cuda.synchronize()
    hold_equal("profiled scl_chunk_step", {
        f: (getattr(prof, f), getattr(plain, f)) for f in ("alpha", "beta", "pend_a", "pend_b", "pm")},
        {"k": spec.k, "j": spec.j})
    split = read_profile(lib, state.pm.shape[0], "step")
    if spec.program.onehot:  # the staging lies outside the step: shares of the whole frame
        parts = ("step", "one-hot load", "one-hot store")
        frame = sum(split[p]["cycles_per_frame"] for p in parts if p in split)
        for part in split.values():
            part["share_of_frame"] = part["cycles_per_frame"] / frame
        split["frame"] = {"cycles_per_frame": frame}
    return split


def profile_body(alpha: torch.Tensor, pm: torch.Tensor, program) -> dict:
    """K5 of the profiled build (-DSCL_PROFILE) on ``alpha``, ``pm``: held
    against the normal build, then each part's clock64() cycles per frame
    (the copy-in, the body by op kind, the output stores; "step": the whole
    frame), ops per frame and share of the frame's cycles."""
    lib = build.load("scl_body_profile")
    launch_chunk_body(alpha, pm, program, "scl_body_profile")  # warm-up
    torch.cuda.synchronize()
    build.check_launch(lib, lib.scl_profile_reset(), "scl_profile_reset")
    got = launch_chunk_body(alpha, pm, program, "scl_body_profile")
    want = launch_chunk_body(alpha, pm, program, "scl_body")
    torch.cuda.synchronize()
    hold_equal("profiled scl_chunk_body", dict(zip(("beta", "pm", "R"), zip(got, want))),
               {"fast": program.fast, "onehot": program.onehot})
    return read_profile(lib, alpha.shape[0], "step")


def profile_last(state, spec) -> dict:
    """K4 of the profiled build (-DSCL_PROFILE) on ``state`` (read only):
    held against the normal build, then each part's clock64() cycles per
    frame (the descend's g, the body by op kind, the ascend to the root, the
    butterfly, the output stores; "step": the whole frame), ops per frame and
    share of the frame's cycles."""
    lib = build.load("scl_last_profile")
    launch_last_chunk(state, spec, "scl_last_profile")  # warm-up
    torch.cuda.synchronize()
    build.check_launch(lib, lib.scl_profile_reset(), "scl_profile_reset")
    got = launch_last_chunk(state, spec, "scl_last_profile")
    want = launch_last_chunk(state, spec, "scl_last")
    torch.cuda.synchronize()
    hold_equal("profiled scl_last_chunk", {"u": (got[0], want[0]), "pm": (got[1], want[1])},
               {"fast": spec.program.fast})
    return read_profile(lib, state.pm.shape[0], "step")


def profile_mega(llr: torch.Tensor, plan) -> dict:
    """K6 of the profiled build (-DSCL_PROFILE) on ``llr``: held against the
    normal build, then each part's cycles per frame over the whole decode
    (descend and body summed over the chunks, composes and ascend over the
    chunk steps, the last chunk's ascend to the root, the butterfly with the
    outputs), ops per frame and share of the decode's cycles."""
    lib = build.load("scl_mega_profile")
    launch_mega(llr, plan, "scl_mega_profile")  # warm-up
    torch.cuda.synchronize()
    build.check_launch(lib, lib.scl_profile_reset(), "scl_profile_reset")
    got = launch_mega(llr, plan, "scl_mega_profile")
    want = launch_mega(llr, plan, "scl_mega")
    torch.cuda.synchronize()
    hold_equal("profiled scl_decode_mega", {"u": (got[0], want[0]), "pm": (got[1], want[1])},
               {"B": llr.shape[0]})
    return read_profile(lib, llr.shape[0], "decode")


def mega_resources(sched) -> dict:
    """K6's resource report at the flagship's launch plan, which must read
    at most 64 registers, no local memory and 32 resident warps per SM, the
    occupancy of K3 (one wave of 4096 frames on 132 SMs)."""
    rows = {r["kernel"]: r for r in scl_cuda.kernel_resources(sched.L, sched.S, sched.N, sched.t)}
    mega, step = rows["scl_decode_mega"], rows["scl_chunk_step"]
    if not (mega["registers"] <= 64 and mega["local_bytes"] == 0
            and mega["resident_warps_per_sm"] == 32 == step["resident_warps_per_sm"]):
        raise AssertionError(f"scl_decode_mega's resources {mega}, scl_chunk_step's {step}")
    return mega


def last_resources(sched) -> dict:
    """K4's resource report at the flagship's launch plan: the exact, fast
    and one-hot instances must each read at most 64 registers, no local
    memory and 32 resident warps per SM, as K3 and K6 (one wave of 4096
    frames on 132 SMs); the device-memory instances no local memory; returns
    their rows."""
    rows = {r["kernel"]: r for r in scl_cuda.kernel_resources(sched.L, sched.S, sched.N, sched.t)}
    last = {k: r for k, r in rows.items() if k.startswith("scl_last_chunk")}
    bad = {k: r for k, r in last.items() if r["local_bytes"] or (
        "devmem" not in k and (r["registers"] > 64 or r["resident_warps_per_sm"] != 32))}
    if len(last) != 6 or bad:
        raise AssertionError(f"scl_last_chunk's resources {bad or last}")
    return last


def body_resources(sched) -> dict:
    """K5's and K3-onehot's resource report at the flagship's launch plan:
    the shared-memory instances of the chunk body (exact, fast, one-hot) and
    the one-hot chunk step must each read at most 64 registers, no local
    memory and 32 resident warps per SM, as K3, K4 and K6 (one wave of 4096
    frames on 132 SMs); their device-memory instances no local memory;
    returns their rows."""
    rows = {r["kernel"]: r for r in scl_cuda.kernel_resources(sched.L, sched.S, sched.N, sched.t)}
    held = {k: r for k, r in rows.items()
            if k.startswith("scl_chunk_body") or k.startswith("scl_chunk_step_onehot")}
    bad = {k: r for k, r in held.items() if r["local_bytes"] or (
        "devmem" not in k and (r["registers"] > 64 or r["resident_warps_per_sm"] != 32))}
    if len(held) != 8 or bad:
        raise AssertionError(f"scl_chunk_body's / scl_chunk_step_onehot's resources "
                             f"{bad or held}")
    return held


# the exact list-kernel instances' registers and local bytes at the flagship's
# launch plan before the fast node programs had instances of their own (chip
# run of that tree, NVIDIA H100 80GB HBM3, 700.00 W): the exact instances no
# longer compile fast code, so none of them may grow; the instances of a
# later redesign are held by its own report instead: K4's by last_resources,
# K5's and K3-onehot's by body_resources; the narrow prefix, which replaced
# the single narrow step (ceilings 64 / 0 and 110 / 0; 64 and 90 registers in
# the last chip run of that tree), at its own first chip run's (and by
# prefix_resources)
EXACT_RESOURCE_CEILINGS = {
    "scl_chunk_step": (64, 0), "scl_narrow_prefix": (64, 0),
    "scl_chunk_step_devmem": (104, 0), "scl_narrow_prefix_devmem": (95, 0),
    "scl_decode_mega": (64, 0), "scl_decode_mega_single": (64, 0),
    "scl_decode_mega_long": (64, 24)}


def fast_resources(sched) -> dict:
    """The fast chunk step's own instance at the flagship's launch plan must
    read no local memory and K3's resident warps per SM (32: one wave of 4096
    frames), and no exact instance may hold more registers or local bytes
    than ``EXACT_RESOURCE_CEILINGS``; returns the fast instances' rows."""
    rows = {r["kernel"]: r for r in scl_cuda.kernel_resources(sched.L, sched.S, sched.N, sched.t)}
    fast, step = rows["scl_chunk_step_fast"], rows["scl_chunk_step"]
    grown = {k: rows[k] for k, (regs, local) in EXACT_RESOURCE_CEILINGS.items()
             if rows[k]["registers"] > regs or rows[k]["local_bytes"] > local}
    if fast["local_bytes"] or fast["resident_warps_per_sm"] != step["resident_warps_per_sm"] \
            or step["resident_warps_per_sm"] != 32 or grown:
        raise AssertionError(f"scl_chunk_step_fast {fast}, scl_chunk_step {step}, grown {grown}")
    return {k: v for k, v in rows.items() if "_fast" in k}


def phase_scl_profile() -> None:
    """Where K3's time goes (stage profile of the profiled build) at flagship
    positions 3 and 4 (4096 frames, 3 dB, the state the kernel decode
    reaches), and K4's on the state before the last chunk, on the exact and
    on the fast node program, and K6's over the
    whole flagship decode of the same frames; K3 and K4 on the one-hot state
    (their staging of the planes apart); K5 on the last chunk's pattern,
    exact, one-hot and fast; the registers, spills and
    resident warps per SM of every compiled variant of K3 / K4 / K5 / K6 at
    the flagship's launch shapes."""
    frozen, info, mask, sched, steps, last, rev = scl_flagship()
    llr = cascl_llrs(frozen, SCL_CHUNK, 3.0, seed=77)
    split = {}
    fast_steps, fast_last = make_step_specs(sched, node_mode="fast")
    for prefix, specs, last_spec in (("", steps, last), ("fast, ", fast_steps, fast_last)):
        state = SCLState(sched, llr[:, rev].contiguous())
        for c, spec in enumerate(specs):
            if c in (3, 4):
                split[f"{prefix}position {c}"] = profile_step(state, spec)
            scl_chunk_step_cuda(state, spec)
        split[f"{prefix}scl_last_chunk"] = profile_last(state, last_spec)
    split["scl_decode_mega, whole decode"] = profile_mega(llr, SCLMegaPlan(sched))
    # the one-hot modes: K3-onehot at the same positions (its staging of the
    # planes apart), K4-onehot; K5 on the last chunk's pattern, exact, one-hot
    # and fast, on Gaussian LLRs
    *_, osteps, _, olast, _ = onehot_flagship()
    state = SCLState(sched, llr[:, rev].contiguous(), "onehot")
    for c, spec in enumerate(osteps):
        if c in (3, 4):
            split[f"onehot, position {c}"] = profile_step(state, spec)
        scl_chunk_step_cuda(state, spec)
    split["onehot, scl_last_chunk"] = profile_last(state, olast)
    g = np.random.default_rng(12)
    alpha = torch.from_numpy((2 * g.standard_normal((SCL_CHUNK, SCL_L, SCL_S))).astype(
        np.float32)).to(DEV)
    pm = -torch.from_numpy(np.abs(g.standard_normal((SCL_CHUNK, SCL_L))).astype(
        np.float32)).to(DEV)
    for name, program in (("scl_chunk_body", last.program),
                          ("scl_chunk_body_onehot", olast.program),
                          ("scl_chunk_body_fast", fast_last.program)):
        split[f"{name}, last chunk's pattern"] = profile_body(alpha, pm, program)
    emit("scl_profile", frames=SCL_CHUNK, split=split, mega_resources=mega_resources(sched),
         last_resources=last_resources(sched), body_resources=body_resources(sched),
         fast_resources=fast_resources(sched),
         resources=scl_cuda.kernel_resources(sched.L, sched.S, sched.N, sched.t))


# the parts of an SC decode in the stage profile (ProfSlot of csrc/sc_decode.cu,
# in its order)
SC_PROFILE_SLOTS = ("fetch", "F size>=32", "F size<32", "G size>=32", "G size<32",
                    "COMBINE size>=32", "COMBINE size<32", "rate-0", "HARD", "REP", "SPC",
                    "register node", "copy in", "copy out", "frame")


def profile_sc(llr: torch.Tensor, program) -> dict:
    """K1 of the profiled build (-DSC_PROFILE) on ``llr``: held against the
    normal build, then each part's clock64() cycles per frame (a warp's own
    clock), ops per frame, and share of the frame's cycles."""
    lib = build.load("sc_decode_profile")
    lib.sc_profile_read.argtypes = [ctypes.c_void_p]
    n = len(SC_PROFILE_SLOTS)
    buf = (ctypes.c_ulonglong * (2 * n))()
    sc_decode_cuda(llr, program, library="sc_decode_profile")  # warm-up
    torch.cuda.synchronize()
    build.check_launch(lib, lib.sc_profile_reset(), "sc_profile_reset")
    got = sc_decode_cuda(llr, program, library="sc_decode_profile")
    torch.cuda.synchronize()
    build.check_launch(lib, lib.sc_profile_read(ctypes.addressof(buf)), "sc_profile_read")
    hold_equal("profiled sc_decode", {"u": (got, sc_decode_cuda(llr, program))},
               {"N": program.N, "subtree": program.subtree})
    B = llr.shape[0]
    frame = buf[n - 1]
    return {name: {"cycles_per_frame": buf[q] / B, "ops_per_frame": buf[n + q] / B,
                   "share_of_frame": buf[q] / frame if frame else None}
            for q, name in enumerate(SC_PROFILE_SLOTS) if buf[n + q]}


def sc_hybrid_subtree_inputs(N: int, K: int, B: int, snr: float, seed: int):
    """The decoder of SC at N with its hybrid cut and the two subtree
    launches' inputs (left: f of the halves; right: g with the left
    subtree's kernel output) of one Monte-Carlo chunk."""
    frozen, _, mask = polar_code(N, K)
    dec = make_sc_decoder_mega(N, mask)
    sub_n = dec.sub_n
    enc = fec.PolarEncoder(N, K, frozen_bits=frozen, device=DEV)
    llr = seeded_llrs(enc.encode(np.random.default_rng(seed).integers(0, 2, (B, K))), snr,
                      seed=seed + 1)
    a = llr[:, torch.as_tensor(np.asarray(bit_reverse_permutation(N)), device=DEV)]
    first, second = a[:, :sub_n], a[:, sub_n:]
    alpha_l = f_minsum(first, second).contiguous()
    beta_l = sc_decode_cuda(alpha_l, dec.programs[0])
    alpha_r = (second + (1.0 - 2.0 * beta_l.to(torch.float32)) * first).contiguous()
    return dec, alpha_l, alpha_r


def phase_sc_profile() -> None:
    """Where K1's time goes (stage profile of the profiled build): the whole
    decode at N=1024 (one Monte-Carlo chunk, 3 dB, fast nodes) and the two
    subtree launches of the hybrid decode at N=32768 (1024 frames, 3 dB)."""
    frozen, info, mask = polar_code()
    enc = fec.PolarEncoder(POLAR_N, POLAR_K, frozen_bits=frozen, device=DEV)
    msgs = np.random.default_rng(11).integers(0, 2, (POLAR_CHUNK, POLAR_K))
    llr = seeded_llrs(enc.encode(msgs), 3.0, seed=12)
    program = SCProgram(POLAR_N, mask)
    split = {f"K1 N={POLAR_N}": profile_sc(llr, program)}
    dec, alpha_l, alpha_r = sc_hybrid_subtree_inputs(LARGE_SC_N, LARGE_SC_K, LARGE_SC_CHUNK,
                                                     3.0, 40)
    split[f"N={LARGE_SC_N} left subtree"] = profile_sc(alpha_l, dec.programs[0])
    split[f"N={LARGE_SC_N} right subtree"] = profile_sc(alpha_r, dec.programs[dec.sub_n])
    emit("sc_profile", split=split,
         ops_per_program={k: int(p.ops.shape[0]) for k, p in (
             (f"K1 N={POLAR_N}", program), ("left subtree", dec.programs[0]),
             ("right subtree", dec.programs[dec.sub_n]))})


def raises_value_error(fn) -> bool:
    """Whether ``fn()`` refuses with a ``ValueError`` (a refusal is the
    expected outcome; anything else propagates)."""
    try:
        fn()
    except ValueError:
        return True
    return False


# K7's checks: (L, S, B, K) on normal and tie-heavy integer inputs — the probe's
# shape, the flagship's node shape, one path, a full list of 32, one position,
# lists of 15 on two lanes, and K = S
FASTNODE_CASES = ((8, 64, 128, 7), (8, 128, 4096, 7), (1, 128, 999, 1), (32, 128, 1000, 31),
                  (32, 1, 777, 1), (8, 2, 333, 2), (32, 16, 130, 16), (16, 64, 300, 15),
                  (4, 32, 515, 8))


def check_fastnode_kernel(results: dict, reps: int) -> list:
    """K7 against its plain version on ``FASTNODE_CASES``, normal and
    tie-heavy integer inputs; a K above ``STREAM_MAX_K`` refused; then the
    probe's own path (its input, the kernel, its ground truth: a numpy
    stable argsort and the softplus tree sum), with the launch counts set to
    0 just before; then times at [8, 128, 4096], K = 7, by CUDA events and by
    profiler device time."""
    cases, worst = [], 0.0
    for L, S, B, K in FASTNODE_CASES:
        for kind in ("normal", "integer ties"):
            g = np.random.default_rng(L * S + B + K + len(kind))
            a = (g.integers(-3, 4, (L, S, B)) if kind == "integer ties"
                 else 2 * g.standard_normal((L, S, B))).astype(np.float32)
            a = torch.from_numpy(a).to(DEV)
            before = ops.launch_counts()["fastnode_select"]
            got = fastnode_select_cuda(a, K)
            torch.cuda.synchronize()
            if ops.launch_counts()["fastnode_select"] != before + 1:
                raise AssertionError(f"fastnode_select [{L}, {S}, {B}] K={K} did not launch")
            want = fastnode_select_plain(a, K)
            context = {"shape": [L, S, B], "K": K, "input": kind}
            worst = max(worst, hold_equal("fastnode_select", dict(
                zip(("mags", "idx", "penalty"), zip(got, want))), context))
            cases.append({**context, "equal_plain": True})
    big_k = torch.zeros((8, 128, 64), device=DEV)
    if not raises_value_error(lambda: fastnode_select_cuda(big_k, STREAM_MAX_K + 1)):
        raise AssertionError(f"fastnode_select took K = {STREAM_MAX_K + 1}")
    # the probe's path (tools/mosaic_fastnode_probe.py: L, S, B = 8, 64, 128, K = 7)
    L, S, B, K = 8, 64, 128, 7
    a_np = (np.random.default_rng(0).standard_normal((L, S, B)) * 2).astype(np.float32)
    a = torch.from_numpy(a_np).to(DEV)
    ops.reset_launch_counts()
    mags, idx, pen = fastnode_select(a, K)
    torch.cuda.synchronize()
    counts = record_launches({}, ["fastnode_select"])
    order = np.argsort(np.abs(a_np), axis=1, kind="stable")[:, :K]
    probe_ok = (np.array_equal(idx.cpu().numpy(), order)
                and np.array_equal(mags.cpu().numpy(), np.take_along_axis(np.abs(a_np), order, 1))
                and torch.equal(pen, fastnode_select_plain(a, K)[2]))
    if not probe_ok:
        raise AssertionError("fastnode_select disagrees with the probe's ground truth")
    L, S, B, K = 8, 128, 4096, 7
    a = (2 * torch.randn((L, S, B), generator=torch.Generator().manual_seed(5))).to(DEV)
    ms = time_ms(lambda: fastnode_select_cuda(a, K), reps)
    dev = device_ms(lambda: fastnode_select_cuda(a, K), reps, expect=1)
    plain_ms = time_ms(lambda: fastnode_select_plain(a, K), max(1, reps // 5), warmup=1)
    byts = B * L * (4 * S + 8 * K + 4)
    flops = B * L * (4 * S + S - 1 + K * S)
    results["fastnode_select"] = kernel_row(
        "fastnode_select", "tools/mosaic_fastnode_probe.py:79", ms, plain_ms, byts, flops, worst,
        source="polarcode_and_ldpc_tpu_torch/ops/csrc/fastnode.cu", shape=[L, S, B], K=K,
        device_ms=dev, cases=cases,
        note="launches: the probe's path (its input through fastnode_select); the same "
             "selection runs inside every K3 / K4 / K5 launch of a fast node program, at "
             "each rate-1 node")
    results["fastnode_select"]["launches"] = counts["fastnode_select"]
    return [{"probe_shape_equals_numpy_ground_truth": True, "launches": counts["fastnode_select"],
             "refuses_k_above": STREAM_MAX_K}]


FAST_OTHER_CODES = ((64, 20, 16, 1), (128, 64, 32, 2), (256, 130, 64, 4), (256, 128, 256, 8),
                    (512, 256, 128, 8), (2048, 1024, 64, 16))


def check_fast_other_codes() -> list:
    """One build serves every fast code: other lengths, chunk sizes and list
    sizes (a single-chunk code, L = 1 without flip stages, L = 16 with 15)
    through the per-chunk kernels and the chunk body inside the plain glue,
    against the plain fast decoder."""
    out = []
    for N, K, S, L in FAST_OTHER_CODES:
        frozen, _ = fec.construct_polar_code(N, K, "bhattacharyya", 2.0)
        mask = frozen_mask_from_positions(N, frozen)
        g = np.random.default_rng(N + L + 1)
        llr = torch.from_numpy((1.0 + 1.6 * g.standard_normal((203, N))).astype(np.float32))
        llr[:3] = torch.from_numpy(g.integers(-2, 3, (3, N)).astype(np.float32))
        llr = llr.to(DEV)
        want = make_scl_decoder(N, mask, L, chunk=S, control_impl="unroll-fused",
                                node_mode="fast", device=DEV)(llr)
        context = {"N": N, "K": K, "S": S, "L": L}
        for kw in ({}, {"control_impl": "unroll-fused", "body_impl": "cuda"}):
            got = make_scl_decoder(N, mask, L, chunk=S, node_mode="fast", device=DEV, **kw)(llr)
            torch.cuda.synchronize()
            hold_equal(f"whole fast decode {kw or 'unroll-kernel'}",
                       {"u": (got[0], want[0]), "metrics": (got[1], want[1])}, context)
        out.append({**context, "kernels_equal_plain": True})
    return out


def phase_fast_kernels(results: dict, reps: int, quick: bool) -> None:
    """K7, and the fast node programs of K5 / K3 / K4 (node_mode="fast"):
    K5 on every chunk pattern of the flagship code, K3 on the level stacks of
    every chunk position and K4 after them, the whole fast decode through
    both kernel routes, other codes; K6 must refuse a fast program."""
    probe = check_fastnode_kernel(results, reps)
    frozen, info, mask = polar_code()
    sched = build_scl_schedule(POLAR_N, mask, SCL_L, SCL_S)
    steps, last = make_step_specs(sched, node_mode="fast")
    rev = torch.as_tensor(np.asarray(bit_reverse_permutation(POLAR_N)), dtype=torch.int64,
                          device=DEV)
    unique = list({id(p): p for p in [s.program for s in steps] + [last.program]}.values())
    # the fast nodes of a decode (per node, as the plain body walks them) and
    # the register subtrees that hold the small ones
    counts = {"rate1": 0, "rep": 0, "subtree": 0}
    for s in steps + [last]:
        kinds = [op & 0xFF for op in scl_cuda.build_scl_body_program(
            s.program.flags, "fast", SCL_L, subtrees=False)[0][:, 0].tolist()]
        counts["rate1"] += kinds.count(OP_RATE1_FAST)
        counts["rep"] += kinds.count(OP_REP_FAST)
        counts["subtree"] += [op & 0xFF for op in s.program.ops[:, 0].tolist()].count(OP_SUBTREE)
    worst = {"body": 0.0, "step": 0.0}
    for B in ((512,) if quick else (512, 1000)):
        worst["body"] = max(worst["body"], check_scl_bodies(sched, unique, B))
    decoders = {
        "plain": make_scl_decoder(POLAR_N, mask, SCL_L, chunk=SCL_S, control_impl="unroll-fused",
                                  node_mode="fast", device=DEV),
        "unroll-kernel": make_scl_decoder(POLAR_N, mask, SCL_L, chunk=SCL_S, node_mode="fast",
                                          device=DEV),
        "body_impl=cuda": make_scl_decoder(POLAR_N, mask, SCL_L, chunk=SCL_S, node_mode="fast",
                                           control_impl="unroll-fused", body_impl="cuda",
                                           device=DEV),
        "exact unroll-kernel": make_scl_decoder(POLAR_N, mask, SCL_L, chunk=SCL_S, device=DEV),
    }
    assert not decoders["plain"].live_width
    info_idx = torch.as_tensor(info, dtype=torch.int64, device=DEV)
    crc = CRCCodec(POLAR_K - 8, SCL_CRC, DEV)
    inputs = [(1000, snr, cascl_llrs(frozen, 1000, snr, seed=int(10 * snr) + 150))
              for snr in (-2.0, 3.0)]
    inputs.append((512, "integer ties", torch.from_numpy(np.random.default_rng(8).integers(
        -3, 4, (512, POLAR_N)).astype(np.float32)).to(DEV)))
    # LLRs of magnitude 1 or 2: the fast nodes' |a| tie everywhere (selection
    # by position, equal flip costs and candidates in the prunes)
    inputs.append((512, "integer ties, |llr| 1 or 2", torch.from_numpy(
        np.random.default_rng(9).choice(np.array([-2, -1, 1, 2], np.float32),
                                        (512, POLAR_N))).to(DEV)))
    cases = []
    for B, snr, llr in inputs:
        context = {"B": B, "snr_db": snr}
        worst["step"] = max(worst["step"], check_scl_steps(sched, steps, last, rev, llr, context))
        u0, m0 = decoders["plain"](llr)
        sel0 = select_best_path(u0[..., info_idx], m0, crc)
        for name in ("unroll-kernel", "body_impl=cuda"):
            u, m = decoders[name](llr)
            torch.cuda.synchronize()
            hold_equal(f"whole fast decode [{name}]", {
                "u": (u, u0), "metrics": (m, m0),
                "selected message": (select_best_path(u[..., info_idx], m, crc), sel0)}, context)
        cases.append({**context, "kernels_equal_plain": True,
                      "crc_pass_frames": int(crc.check(sel0).sum())})
    # the main path's shapes: one Monte-Carlo chunk of 4096 frames at 3 dB
    B = SCL_CHUNK
    llr = cascl_llrs(frozen, B, 3.0, seed=78)
    worst["step"] = max(worst["step"], check_scl_steps(sched, steps, last, rev, llr,
                                                       {"B": B, "snr_db": 3.0}))
    worst["body"] = max(worst["body"], check_scl_bodies(sched, unique, B))
    time_scl_kernels(results, sched, steps, last, rev, llr, worst, reps, 1)
    decode_ms = {name: time_ms(lambda: dec(llr), reps if name != "plain" else 1, warmup=1)
                 for name, dec in decoders.items()}
    # K6 has no fast nodes: the decoder factory, the plan and the tables refuse
    refused = [raises_value_error(lambda: make_scl_decoder(
                   POLAR_N, mask, SCL_L, chunk=SCL_S, control_impl="mega", node_mode="fast",
                   device=DEV)),
               raises_value_error(lambda: SCLMegaPlan(sched, "fast")),
               raises_value_error(lambda: build_mega_tables(sched, unique))]
    if not all(refused):
        raise AssertionError(f"the one-launch decode took a fast program: {refused}")
    emit("fast_kernels",
         kernels=[{k: v for k, v in results[k].items() if k != "cases"}
                  for k in ("fastnode_select", "scl_chunk_body_fast",
                            "scl_chunk_step_fast", "scl_last_chunk_fast")],
         fastnode_cases=results["fastnode_select"]["cases"], probe=probe,
         fast_nodes_per_decode=counts, unique_patterns=len(unique), whole_decode_ms=decode_ms,
         cases=cases, other_codes=check_fast_other_codes(), mega_refuses_fast=True,
         resources=fast_resources(sched))


# -- large codes: K1's hybrid mode, the device-memory modes, K3's live width -------

# the reference's large-code configuration (BASELINE.json configs[4],
# tools/large_code_runs.py): N=4096 SCL-32 with subtree chunk 64; SC beyond one
# block (N=32768, the hybrid mode's cut at 16384); the default (MacKay)
# construction at n=8192
LARGE_SCL_N, LARGE_SCL_K, LARGE_SCL_L, LARGE_SCL_S, LARGE_SCL_CHUNK = 4096, 2048, 32, 64, 1024
LARGE_SC_N, LARGE_SC_K, LARGE_SC_CHUNK = 32768, 16384, 1024
LARGE_LDPC_N, LARGE_LDPC_K, LARGE_LDPC_CHUNK = 8192, 4096, 1024
LARGE_LDPC_LOW_SNR_DB = -1.0
# a chunk whose context one block cannot hold: S=1024 at L=32; single-chunk
# codes (N, K, L, node mode) whose one chunk-body launch cannot either
DEVMEM_SCL_S = 1024
DEVMEM_SINGLE_CHUNK_CODES = ((1024, 512, 32, "exact"), (2048, 1024, 16, "fast"))
_LARGE_LDPC: dict = {}


def large_ldpc_code():
    """The default-construction (MacKay) (8192, 4096) code and its encoder;
    built once per run (the encoder's GF(2) elimination is host set-up)."""
    if not _LARGE_LDPC:
        t0 = time.perf_counter()
        H = fec.mackay_construction(LARGE_LDPC_N, LARGE_LDPC_K, 3, 6, seed=42)
        enc = fec.LDPCEncoder(LARGE_LDPC_N, LARGE_LDPC_K, H=H, device=DEV)
        _LARGE_LDPC.update(enc=enc, graph=TannerGraph.from_H(enc.H, DEV),
                           setup_s=time.perf_counter() - t0)
    return _LARGE_LDPC


def check_sc_hybrid(results: dict, reps: int) -> dict:
    """K1's subtree mode at N=32768: one launch per size-16384 subtree on its
    storage slice, against the plain subtree decoder; the whole hybrid decode
    against the unrolled decoder, bit for bit."""
    N, K, B = LARGE_SC_N, LARGE_SC_K, LARGE_SC_CHUNK
    frozen, _, mask = polar_code(N, K)
    dec = make_sc_decoder_mega(N, mask)
    sub_n = dec.sub_n
    if sub_n != hybrid_sub_n(N) or sorted(dec.programs) != [0, N // 2]:
        raise AssertionError(f"hybrid SC at N={N}: cut {sub_n}, subtrees {sorted(dec.programs)}")
    plain = make_sc_decoder_unrolled(N, mask)
    enc = fec.PolarEncoder(N, K, frozen_bits=frozen, device=DEV)
    rev = torch.as_tensor(np.asarray(bit_reverse_permutation(N)), device=DEV)
    cases, sub_ms, sub_plain_ms = [], [], []
    inputs = [(snr, seeded_llrs(enc.encode(np.random.default_rng(40 + int(snr)).integers(
        0, 2, (B, K))), snr, seed=41 + int(10 * snr))) for snr in (3.0, -1.0)]
    inputs.append(("integer ties", torch.from_numpy(np.random.default_rng(42).integers(
        -3, 4, (256, N)).astype(np.float32)).to(DEV)))
    for snr, llr in inputs:
        a = llr[:, rev]
        first, second = a[:, :sub_n], a[:, sub_n:]
        alpha_l = f_minsum(first, second).contiguous()
        got_l = sc_decode_cuda(alpha_l, dec.programs[0])
        alpha_r = (second + (1.0 - 2.0 * got_l.to(torch.float32)) * first).contiguous()
        got_r = sc_decode_cuda(alpha_r, dec.programs[sub_n])
        torch.cuda.synchronize()
        hold_equal("sc_decode_sub", {
            "left subtree": (got_l, dec.programs[0].plain(alpha_l)),
            "right subtree": (got_r, dec.programs[sub_n].plain(alpha_r)),
            "whole decode vs unrolled": (dec(llr), plain(llr))}, {"snr_db": snr, "N": N})
        cases.append({"snr_db": snr, "B": llr.shape[0], "subtrees_equal_plain": True,
                      "whole_decode_equals_unrolled": True})
        if snr == 3.0:  # the main path's shape
            for off, alpha in ((0, alpha_l), (sub_n, alpha_r)):
                prog = dec.programs[off]
                sub_ms.append(time_ms(lambda: sc_decode_cuda(alpha, prog), reps))
                sub_plain_ms.append(time_ms(lambda: prog.plain(alpha), 1, warmup=1))
            whole_ms = time_ms(lambda: dec(llr), reps)
            whole_plain_ms = time_ms(lambda: plain(llr), 1, warmup=1)
    byts = B * sub_n * 5
    flops = B * sub_n * int(math.log2(sub_n))
    plan = launch_plan(dec.programs[0], B, 0)
    results["sc_decode_sub"] = kernel_row(
        "sc_decode_sub", "polarcode_and_ldpc_tpu/ops/sc_mega_pallas.py:168",
        sum(sub_ms) / 2, sum(sub_plain_ms) / 2, byts, flops, 0,
        source="polarcode_and_ldpc_tpu_torch/ops/csrc/sc_decode.cu",
        shape=[B, sub_n], code=[N, K], ms_per_subtree=sub_ms,
        whole_decode_ms=whole_ms, whole_decode_plain_ms=whole_plain_ms,
        launches_per_decode=len(dec.programs),
        smem_per_frame=plan.smem_per_frame, levels_in_device_memory=plan.dev_levels,
        frames_per_sm=plan.frames_per_sm, waves=plan.waves,
        frames_per_block=plan.frames_per_block, warps_per_frame=plan.warps_per_frame,
        ops_per_subtree_program=[int(dec.programs[off].ops.shape[0]) for off in sorted(dec.programs)],
        note="ms, plain_ms, bound_ms per subtree launch; plain_ms is the unrolled recursion "
             "on the subtree's storage slice", cases=cases)
    return {"N": N, "sub_n": sub_n, "cases": cases}


# K2's shared-memory rows of the large codes and its device-memory rows: key ->
# (check rule, alpha, schedule); the device-memory mode on a MacKay (4096, 2048)
# code of column weight 16 (E = 65,536, dc_max 55), whose compact planes still
# exceed one block
LARGE_BP_ROWS = {"bp_decode_bp_large": ("bp", 1.0, "flooding"),
                 "bp_decode_ms_large": ("ms", 0.75, "flooding"),
                 "bp_decode_layered_large": ("ms", 0.75, "layered")}
DEVMEM_BP_ROWS = {"bp_decode_bp_devmem": ("bp", 1.0, "flooding"),
                  "bp_decode_ms_devmem": ("ms", 0.75, "flooding"),
                  "bp_decode_layered_devmem": ("ms", 0.75, "layered")}
DEVMEM_LDPC_CODE, DEVMEM_LDPC_FRAMES = (4096, 2048, 16, 32), 256


def bp_blocks(plan) -> dict:
    """Blocks per SM of a plan: the plan's count (shared memory and threads;
    None in device memory, whose grid the occupancy calculator sets) and the
    occupancy calculator's, which must agree in shared-memory mode."""
    resident = resident_blocks_per_sm(plan)
    if not plan.device_memory and plan.blocks_per_sm != resident:
        raise AssertionError(f"the plan counts {plan.blocks_per_sm} blocks per SM, "
                             f"the occupancy calculator {resident}")
    return {"blocks_per_sm": plan.blocks_per_sm, "resident_blocks_per_sm": resident}


def bp_counter(plan) -> str:
    """The launch counter of a plan's kernel mode."""
    name = "bp_decode_layered" if plan.layered else f"bp_decode_{plan.check_rule}"
    return name + ("_devmem" if plan.device_memory else "")


def hold_bp(key: str, plan, inputs: dict, codewords: dict) -> list:
    """The kernel against its plain version on each input: min-sum bit-identical
    in bits and iteration counts on every frame, sum-product on >= 99.9 %."""
    cases = []
    for snr, llr in inputs.items():
        bits, iters = bp_decode_cuda(llr, plan)
        torch.cuda.synchronize()
        pbits, piters = plan.plain(llr)
        differ = int(((bits != pbits).any(dim=1) | (iters != piters)).sum())
        cases.append({"snr_db": snr, "B": llr.shape[0], "frames_differ": differ,
                      "mean_iterations": float(iters.float().mean()),
                      "frame_errors": int((bits != codewords[snr]).any(dim=1).sum())})
        if differ > (llr.shape[0] // 1000 if plan.check_rule == "bp" else 0):
            raise AssertionError(f"{key} differs from its plain version: {cases[-1]}")
    return cases


def bp_kernel_row(key: str, plan, llr: torch.Tensor, reps: int, cases: list) -> dict:
    """Time a plan at one input beside its plain version; the row of the
    kernel line, with the plan's mode."""
    rule, schedule, (B, n) = plan.check_rule, "layered" if plan.layered else "flooding", llr.shape
    bits, iters = bp_decode_cuda(llr, plan)
    pbits, piters = plan.plain(llr)
    max_abs = max(int((bits.to(torch.int16) - pbits.to(torch.int16)).abs().max()),
                  int((iters - piters).abs().max()))
    ms = time_ms(lambda: bp_decode_cuda(llr, plan), reps)
    plain_ms = time_ms(lambda: plan.plain(llr), max(1, reps // 5), warmup=1)
    flops = plan.graph.num_edges * int(iters.sum()) * OPS_PER_EDGE_ITER[
        "layered" if plan.layered else rule]
    return kernel_row(
        key, "polarcode_and_ldpc_tpu/ops/bp_pallas.py:140", ms, plain_ms, B * (5 * n + 4),
        flops, max_abs, source="polarcode_and_ldpc_tpu_torch/ops/csrc/bp_decode.cu",
        shape=[B, n], schedule=schedule, rule=f"{rule} {plan.normalization}",
        edges=plan.graph.num_edges, dc_max=plan.graph.dc_max,
        mean_iterations=float(iters.float().mean()), device_memory=plan.device_memory,
        bytes_per_frame=plan.smem_bytes, threads=plan.threads, **bp_blocks(plan),
        tolerance=("bit-identical bits and iteration counts" if rule == "ms" else
                   "identical bits and iteration counts on >= 99.9 % of frames"),
        cases=cases)


def check_bp_large(results: dict, reps: int) -> dict:
    """K2 flooding (sum-product, NMS) and layered (NMS) on the
    default-construction (MacKay) codes at n=8192 and n=4096, every frame in
    one block's shared memory; the device-memory mode of both kernels on a
    code whose frame still exceeds a block.  The launch counts of this check
    by mode."""
    code = large_ldpc_code()
    enc, graph = code["enc"], code["graph"]
    B = LARGE_LDPC_CHUNK
    codewords = {snr: enc.encode(np.random.default_rng(60 + int(snr)).integers(
        0, 2, (B, LARGE_LDPC_K))) for snr in (3.0, LARGE_LDPC_LOW_SNR_DB)}
    inputs = {snr: seeded_llrs(cw, snr, seed=61 + int(10 * snr)) for snr, cw in codewords.items()}
    out = {"dv_max": graph.dv_max, "dc_max": graph.dc_max, "edges": graph.num_edges,
           "setup_s": code["setup_s"]}
    ops.reset_launch_counts()
    counters = []  # the launch counter of every row's mode
    for key, (rule, alpha, schedule) in LARGE_BP_ROWS.items():
        plan = BPKernelPlan(graph, LDPC_ITERS, True, rule, alpha, 0.0, schedule, LDPC_LAYERS)
        counters.append(bp_counter(plan))
        if plan.device_memory:
            raise AssertionError(f"{key}: {plan.smem_bytes} bytes per frame do not fit a block")
        cases = hold_bp(key, plan, inputs, codewords)
        results[key] = bp_kernel_row(key, plan, inputs[3.0], reps, cases)
        out[key] = cases
    # the default construction at n=4096, flooding NMS and layered NMS
    small = TannerGraph.from_H(fec.mackay_construction(4096, 2048, 3, 6, seed=42), DEV)
    zeros = torch.zeros((256, 4096), dtype=torch.int8, device=DEV)
    x = {0.0: seeded_llrs(zeros, 0.0, seed=62)}
    for schedule in ("flooding", "layered"):
        plan = BPKernelPlan(small, LDPC_ITERS, True, "ms", 0.75, 0.0, schedule, LDPC_LAYERS)
        if plan.device_memory:
            raise AssertionError(f"MacKay n=4096 {schedule}: planned in device memory")
        out[f"mackay4096_{schedule}"] = {
            "cases": hold_bp(f"MacKay n=4096 {schedule}", plan, x, {0.0: zeros}),
            "bytes_per_frame": plan.smem_bytes, "threads": plan.threads, **bp_blocks(plan)}
    # the device-memory mode: a frame of the column-weight-16 code exceeds a block
    n, k, dv, dc = DEVMEM_LDPC_CODE
    dense = TannerGraph.from_H(fec.mackay_construction(n, k, dv, dc, seed=42), DEV)
    zeros = torch.zeros((DEVMEM_LDPC_FRAMES, n), dtype=torch.int8, device=DEV)
    x = {snr: seeded_llrs(zeros, snr, seed=63 + int(snr)) for snr in (0.0, 3.0)}
    for key, (rule, alpha, schedule) in DEVMEM_BP_ROWS.items():
        plan = BPKernelPlan(dense, LDPC_ITERS, True, rule, alpha, 0.0, schedule, LDPC_LAYERS)
        counters.append(bp_counter(plan))
        if not plan.device_memory:
            raise AssertionError(f"{key}: {plan.smem_bytes} bytes per frame fit one block")
        cases = hold_bp(key, plan, x, {0.0: zeros, 3.0: zeros})
        results[key] = bp_kernel_row(key, plan, x[3.0], reps, cases)
        out[key] = cases
    counts = ops.launch_counts()
    out["launches"] = {k: v for k, v in counts.items() if k.startswith("bp_decode") and v}
    if not all(counts[c] for c in counters):
        raise AssertionError(f"a K2 mode was launched no time: {out['launches']}")
    return out


def check_scl_devmem(results: dict, reps: int) -> dict:
    """K3 / K4 / K5 with the chunk context in device memory: N=4096, S=1024,
    L=32 (3 chunk steps and the last chunk), a single-chunk N=1024 code at
    L=32 (one K5 launch), and a fast single-chunk N=2048 code at L=16, each
    against its plain version."""
    N, K, S, L = LARGE_SCL_N, LARGE_SCL_K, DEVMEM_SCL_S, LARGE_SCL_L
    if not context_in_device_memory(L, S):
        raise AssertionError(f"S={S} at L={L} fits one block")
    frozen, _, mask = polar_code(N, K)
    sched = build_scl_schedule(N, mask, L, S)
    steps, last = make_step_specs(sched)
    rev = torch.as_tensor(np.asarray(bit_reverse_permutation(N)), dtype=torch.int64, device=DEV)
    enc = fec.PolarEncoder(N, K, frozen_bits=frozen, device=DEV)
    B = 256
    llr = seeded_llrs(enc.encode(np.random.default_rng(70).integers(0, 2, (B, K))), 1.0, seed=71)
    worst = check_scl_steps(sched, steps, last, rev, llr, {"N": N, "S": S, "L": L, "B": B})
    # time K3 per position, K4, K5 on the last chunk's pattern, beside their plain versions
    llr_rev = llr[:, rev].contiguous()
    state = SCLState(sched, llr_rev)
    step_ms, step_plain_ms, step_bytes, step_flops = [], [], 0, 0
    for c, spec in enumerate(steps):
        ops_in = state.to_plain()
        step_plain_ms.append(time_ms(lambda: spec.plain(llr_rev, *ops_in), 1, warmup=0))
        scratch = state.clone()
        step_ms.append(time_ms(lambda: scl_chunk_step_cuda(scratch, spec), reps, warmup=1))
        byts, flops = step_cost(sched, c, spec)
        step_bytes += B * byts
        step_flops += B * flops
        scl_chunk_step_cuda(state, spec)
    ops_in = state.to_plain()
    last_plain_ms = time_ms(lambda: last.plain(llr_rev, *ops_in), 1, warmup=0)
    last_ms = time_ms(lambda: scl_last_chunk_cuda(state, last), reps, warmup=1)
    alpha_t = ops_in[0][sched.t - 1].contiguous()
    pm_c = state.pm.clone()
    body_ms = time_ms(lambda: scl_chunk_body_cuda(alpha_t, pm_c, last.program), reps, warmup=1)
    body_plain_ms = time_ms(lambda: last.program.plain(alpha_t, pm_c), 1, warmup=0)
    worst = max(worst, hold_equal("scl_chunk_body [device memory]", dict(zip(
        ("beta", "pm", "R"), zip(scl_chunk_body_cuda(alpha_t, pm_c, last.program),
                                 last.program.plain(alpha_t, pm_c)))), {"S": S, "L": L}))
    # single-chunk codes: the whole decode is one chunk-body launch
    singles = []
    for n1, k1, l1, mode in DEVMEM_SINGLE_CHUNK_CODES:
        fr1, _, m1 = polar_code(n1, k1)
        if not context_in_device_memory(l1, n1):
            raise AssertionError(f"a single chunk of {n1} at L={l1} fits one block")
        g = np.random.default_rng(n1)
        x = torch.from_numpy((1.0 + 1.6 * g.standard_normal((128, n1))).astype(np.float32))
        x[:2] = torch.from_numpy(g.integers(-2, 3, (2, n1)).astype(np.float32))
        x = x.to(DEV)
        kw = dict(chunk=n1, node_mode=mode, device=DEV)
        want = make_scl_decoder(n1, m1, l1, control_impl="unroll-fused", live_width=False, **kw)(x)
        got = make_scl_decoder(n1, m1, l1, **kw)(x)
        torch.cuda.synchronize()
        hold_equal(f"single-chunk decode [{mode}, device memory]",
                   {"u": (got[0], want[0]), "metrics": (got[1], want[1])}, {"N": n1, "L": l1})
        singles.append({"N": n1, "K": k1, "L": l1, "node_mode": mode, "B": 128,
                        "kernels_equal_plain": True})
    # the whole decode through the default kernel control: live width on, so the
    # first chunk steps are narrow, in one prefix launch that keeps its context
    # in device memory
    dec = make_scl_decoder(N, mask, L, chunk=S, device=DEV)
    want = make_scl_decoder(N, mask, L, chunk=S, control_impl="unroll-fused", device=DEV)(llr[:64])
    ops.reset_launch_counts()
    got = dec(llr[:64])
    torch.cuda.synchronize()
    counts = ops.launch_counts()
    hold_equal("whole decode [live width, device memory]",
               {"u": (got[0], want[0]), "metrics": (got[1], want[1])}, {"N": N, "S": S, "L": L})
    if not (dec.live_width and counts["scl_narrow_prefix_devmem"] == 1
            and counts["scl_narrow_prefix"] == 0 and counts["scl_last_chunk_devmem"] == 1):
        raise AssertionError(f"N={N}, S={S}, L={L}: launched {counts}")
    singles.append({"N": N, "S": S, "L": L, "B": 64, "control": "unroll-kernel, live width",
                    "narrow_prefix_devmem_launches": counts["scl_narrow_prefix_devmem"],
                    "devmem_launches": counts["scl_chunk_step_devmem"],
                    "kernels_equal_plain": True})
    shape = {"frames": B, "N": N, "S": S, "L": L}
    n_steps = len(steps)
    lb, lf = last_cost(sched, last)
    src = "polarcode_and_ldpc_tpu/ops/scl_superchunk_pallas.py"
    results["scl_chunk_step_devmem"] = kernel_row(
        "scl_chunk_step_devmem", f"{src}:167", sum(step_ms) / n_steps,
        sum(step_plain_ms) / n_steps, step_bytes / n_steps, step_flops / n_steps, worst,
        shape=shape, ms_per_position=step_ms, note="means per launch over the chunk positions")
    results["scl_last_chunk_devmem"] = kernel_row(
        "scl_last_chunk_devmem", f"{src}:356", last_ms, last_plain_ms, B * lb, B * lf, worst,
        source=SCL_SOURCE["last"], shape=shape)
    results["scl_chunk_body_devmem"] = kernel_row(
        "scl_chunk_body_devmem", "polarcode_and_ldpc_tpu/ops/scl_body_pallas.py:378", body_ms,
        body_plain_ms, B * (4 * L * S + 4 * L + L * S + 4 * L + 8 * L),
        B * body_flops(last.program), worst, source=SCL_SOURCE["body"], shape=shape,
        single_chunk_codes=singles)
    return {"shape": shape, "single_chunk_codes": singles}


# a code whose narrow prefix is longer than one launch's table (124 narrow
# positions: two scl_narrow_prefix launches a decode)
LONG_PREFIX_CODE = (1024, 128, 16, 4)
# resident warps per SM of the single narrow chunk step (scl_chunk_step_narrow)
# that the prefix replaced, at the launch plans (L, S, N, t) of the flagship and
# of the large code (chip run of that tree, NVIDIA H100 80GB HBM3, 700.00 W):
# the prefix's shared-memory instance may hold no fewer
NARROW_STEP_WARPS_PER_SM = {(8, 128, 1024, 3): 32, (32, 64, 4096, 6): 24}


def prefix_resources() -> dict:
    """The narrow prefix's resource report at the flagship's and the large
    code's launch plans: its shared-memory instance at most 64 registers, no
    local memory and no fewer resident warps per SM than the narrow chunk
    step it replaced; its device-memory instance no local memory and at
    most ``EXACT_RESOURCE_CEILINGS``'s registers."""
    out = {}
    for shape, warps in NARROW_STEP_WARPS_PER_SM.items():
        rows = {r["kernel"]: r for r in scl_cuda.kernel_resources(*shape)}
        smem, dev = rows["scl_narrow_prefix"], rows["scl_narrow_prefix_devmem"]
        if not (smem["registers"] <= 64 and smem["local_bytes"] == 0
                and smem["resident_warps_per_sm"] >= warps and dev["local_bytes"] == 0
                and dev["registers"] <= EXACT_RESOURCE_CEILINGS["scl_narrow_prefix_devmem"][0]):
            raise AssertionError(f"scl_narrow_prefix's resources at {shape}: {smem}, {dev}")
        out[str(shape)] = {"scl_narrow_prefix": smem, "scl_narrow_prefix_devmem": dev}
    return out


def hold_narrow_prefix(N: int, K: int, L: int, S: int, llr: torch.Tensor, reps: int,
                       crc: bool = False) -> dict:
    """The live width's narrow prefix of one code on the card (``llr`` [B,
    N] natural order): each narrow position as a one-row prefix on the state
    the plain live steps reach, then the whole prefix from the decode's
    start, each against the plain narrow steps in order, bit for bit on the
    whole state; with ``reps``, the prefix per decode by events and device
    time beside its positions as single-row launches back to back (the
    launches before the prefix), their full-width launches and the plain
    steps.  Returns the code's figures; the bytes and operations of the
    prefix per decode under ``bytes`` / ``flops``."""
    B = llr.shape[0]
    frozen, _, mask = polar_code(N, K)
    sched = build_scl_schedule(N, mask, L, S)
    programs = [SCLBodyProgram(f, L) for f in sched.unique_flags]
    (prefix, *rest), _ = make_step_specs(sched, programs, live=True)
    full_steps, _ = make_step_specs(sched, programs)
    narrow = prefix.steps
    rev = torch.as_tensor(np.asarray(bit_reverse_permutation(N)), dtype=torch.int64, device=DEV)
    llr_rev = llr[:, rev].contiguous()
    fields = ("alpha", "beta", "pend_a", "pend_b", "pm")
    start = SCLState(sched, llr_rev)
    live, full = start.clone(), start.clone()
    context = {"N": N, "K": K, "L": L, "S": S, "B": B}
    rows, byts, flops = [], 0, 0
    for c, spec in enumerate(narrow):
        one = SCLPrefixSpec([spec])
        kern = live.clone()
        scl_narrow_prefix_cuda(kern, one)
        torch.cuda.synchronize()
        ops_in = live.to_plain(spec.widths)
        row = {"chunk": c, "lv_in": spec.lv_in, "lv_out": spec.lv_out}
        if reps:
            row["plain_ms"] = time_ms(lambda: spec.plain(llr_rev, *ops_in), 2, warmup=1)
        live.load_plain(*spec.plain(llr_rev, *ops_in))
        hold_equal("scl_narrow_prefix [one row]", {f: (getattr(kern, f), getattr(live, f))
                                                   for f in fields}, {**context, "chunk": c})
        if reps:
            scratch, scratch_full = kern, full.clone()
            row["one_row_ms"] = time_ms(lambda: scl_narrow_prefix_cuda(scratch, one), reps)
            row["full_width_ms"] = time_ms(
                lambda: scl_chunk_step_cuda(scratch_full, full_steps[c]), reps)
            scl_chunk_step_cuda(full, full_steps[c])
        b, f = step_cost(sched, c, spec)
        byts, flops = byts + B * b, flops + B * f
        row["bound_ms"] = max(B * b / HBM_BYTES_PER_S, B * f / F32_FLOP_PER_S) * 1e3
        rows.append(row)
    # the whole prefix from the decode's start: one launch (or one per
    # PREFIX_PARAM_ROWS rows), every row on the same state
    kern = start.clone()
    before = ops.launch_counts()
    scl_narrow_prefix_cuda(kern, prefix)
    torch.cuda.synchronize()
    launched = ops.launch_counts()["scl_narrow_prefix"] - before["scl_narrow_prefix"]
    if launched != prefix_launches(len(narrow)):
        raise AssertionError(f"the prefix of {len(narrow)} steps took {launched} launches")
    hold_equal("scl_narrow_prefix [whole prefix]", {f: (getattr(kern, f), getattr(live, f))
                                                    for f in fields},
               {**context, "positions": len(narrow)})
    out = {**context, "crc": crc, "narrow_positions": len(narrow),
           "launches_per_decode": launched, "full_width_steps": len(rest),
           "lv_in": list(sched.lv_in[:len(narrow) + 1]), "positions": rows,
           "bytes": byts, "flops": flops, "bound_ms_per_decode": sum(r["bound_ms"] for r in rows)}
    if reps:
        singles = [SCLPrefixSpec([spec]) for spec in narrow]

        def single_rows():
            for one in singles:
                scl_narrow_prefix_cuda(kern, one)

        def whole():
            scl_narrow_prefix_cuda(kern, prefix)

        out.update(
            prefix_ms=time_ms(whole, reps), single_row_launches_ms=time_ms(single_rows, reps),
            prefix_device=device_ms(whole, reps),
            single_row_launches_device=device_ms(single_rows, reps),
            full_width_ms=sum(r["full_width_ms"] for r in rows),
            plain_ms=sum(r["plain_ms"] for r in rows))
    return out


def check_scl_narrow(results: dict, reps: int) -> dict:
    """K3's live width: the narrow prefix at the large code (N=4096, L=32,
    S=64: eight narrow positions, 1024 frames), at the flagship (two, 4096
    frames) and on a code whose prefix takes two launches, each position and
    the whole prefix against the plain live-width steps on the card, bit for
    bit on the whole state (``hold_narrow_prefix``), timed; the prefix's
    resources; whole decodes, live against full width and the plain
    decoder."""
    lib = build.load("scl_decode")
    lib.scl_narrow_prefix_rows.restype = ctypes.c_int
    if lib.scl_narrow_prefix_rows() != PREFIX_PARAM_ROWS:
        raise AssertionError(f"the prefix kernel takes {lib.scl_narrow_prefix_rows()} rows a "
                             f"launch, the host plans {PREFIX_PARAM_ROWS}")
    N, K, S, L, B = LARGE_SCL_N, LARGE_SCL_K, LARGE_SCL_S, LARGE_SCL_L, LARGE_SCL_CHUNK
    frozen, _, mask = polar_code(N, K)
    enc = fec.PolarEncoder(N, K, frozen_bits=frozen, device=DEV)
    llr = seeded_llrs(enc.encode(np.random.default_rng(80).integers(0, 2, (B, K))), 3.0, seed=81)
    large = hold_narrow_prefix(N, K, L, S, llr, reps)
    ffrozen, _, _ = polar_code()
    flagship = hold_narrow_prefix(POLAR_N, POLAR_K, SCL_L, SCL_S,
                                  cascl_llrs(ffrozen, SCL_CHUNK, 3.0, seed=82), reps, crc=True)
    n1, k1, l1, s1 = LONG_PREFIX_CODE
    g = np.random.default_rng(n1 + l1)
    x1 = torch.from_numpy((1.0 + 1.6 * g.standard_normal((256, n1))).astype(np.float32))
    x1[:3] = torch.from_numpy(g.integers(-2, 3, (3, n1)).astype(np.float32))
    longer = hold_narrow_prefix(n1, k1, l1, s1, x1.to(DEV), 0)
    if (large["narrow_positions"], large["launches_per_decode"], flagship["narrow_positions"],
            flagship["launches_per_decode"], longer["launches_per_decode"]) != (8, 1, 2, 1, 2):
        raise AssertionError(f"narrow prefixes: {large}, {flagship}, {longer}")
    # whole decodes on 256 frames: live kernel control = full-width kernel
    # control = plain live-width control
    x = llr[:256]
    kw = dict(chunk=S, device=DEV)
    dec_live = make_scl_decoder(N, mask, L, **kw)
    if not dec_live.live_width:
        raise AssertionError("live width is off on the kernel control")
    got = dec_live(x)
    full_dec = make_scl_decoder(N, mask, L, live_width=False, **kw)
    plain_dec = make_scl_decoder(N, mask, L, control_impl="unroll-fused", **kw)
    want_full, want_plain = full_dec(x), plain_dec(x)
    hold_equal("whole decode [live width]", {
        "u vs full width": (got[0], want_full[0]), "metrics vs full width": (got[1], want_full[1]),
        "u vs plain live": (got[0], want_plain[0]),
        "metrics vs plain live": (got[1], want_plain[1])}, {"N": N, "L": L, "B": 256})
    decode_ms = {"live": time_ms(lambda: dec_live(llr), max(2, reps // 4), warmup=1),
                 "full width": time_ms(lambda: full_dec(llr), max(2, reps // 4), warmup=1)}
    resources = prefix_resources()
    results["scl_narrow_prefix"] = kernel_row(
        "scl_narrow_prefix", "polarcode_and_ldpc_tpu/ops/scl_superchunk_pallas.py:175",
        large["prefix_ms"], large["plain_ms"], large["bytes"], large["flops"], 0.0,
        shape={"frames": B, "N": N, "S": S, "L": L}, device_ms=large["prefix_device"],
        single_row_launches_ms=large["single_row_launches_ms"],
        single_row_launches_device=large["single_row_launches_device"],
        full_width_ms=large["full_width_ms"], positions=large["positions"],
        narrow_steps_per_decode=large["narrow_positions"],
        launches_per_decode=large["launches_per_decode"], flagship={
            k: v for k, v in flagship.items() if k not in ("bytes", "flops")},
        whole_decode_ms=decode_ms, resources=resources,
        note="ms, plain_ms and bound_ms per decode: the whole narrow prefix (one launch) at "
             "the large code; single_row_launches_ms: its positions as one-row launches "
             "back to back; full_width_ms: the full-width launches at the same positions")
    return {"large_code": {k: v for k, v in large.items() if k != "positions"},
            "flagship": {k: v for k, v in flagship.items() if k != "positions"},
            "long_prefix": {k: v for k, v in longer.items() if k != "positions"},
            "whole_decode_ms": decode_ms, "resources": resources}


def phase_large_kernels(results: dict, reps: int) -> None:
    sc = check_sc_hybrid(results, reps)
    bp = check_bp_large(results, reps)
    scl = check_scl_devmem(results, reps)
    live = check_scl_narrow(results, reps)
    keys = ("sc_decode_sub", *LARGE_BP_ROWS, *DEVMEM_BP_ROWS, "scl_chunk_step_devmem",
            "scl_last_chunk_devmem", "scl_chunk_body_devmem", "scl_narrow_prefix")
    emit("large_kernels", kernels=[{k: v for k, v in results[k].items() if k != "cases"}
                                   for k in keys],
         sc_hybrid=sc, ldpc=bp, scl_device_memory=scl, live_width=live)


# -- the one-hot permutation modes of K5 / K3 / K4 -----------------------------------

# the list controls that launch kernels, with rank and one-hot permutations:
# the per-chunk kernels (per-position and united masks), the chunk body inside
# JAX's scan controls, the one-launch decode (rank inside, equal outputs)
LIST_CONTROLS = {
    "unroll-kernel rank": dict(control_impl="unroll-kernel"),
    "unroll-kernel onehot": dict(control_impl="unroll-kernel", perm_impl="onehot"),
    "kernel rank": dict(control_impl="kernel"),
    "kernel onehot": dict(control_impl="kernel", perm_impl="onehot"),
    "split body_impl=cuda onehot": dict(control_impl="split", body_impl="cuda",
                                        perm_impl="onehot"),
    "fused body_impl=cuda rank": dict(control_impl="fused", body_impl="cuda"),
    "mega onehot": dict(control_impl="mega", perm_impl="onehot"),
}


def onehot_flagship():
    """The flagship schedule with one-hot programs and step specs: the
    per-position masks of ``"unroll-kernel"`` and the united masks of
    ``"kernel"``."""
    frozen, info, mask = polar_code()
    sched = build_scl_schedule(POLAR_N, mask, SCL_L, SCL_S)
    unique = [SCLBodyProgram(f, SCL_L, perm_impl="onehot") for f in sched.unique_flags]
    steps, last = make_step_specs(sched, unique)
    union_steps, _ = make_step_specs(sched, unique, union=True)
    return frozen, info, mask, sched, steps, union_steps, last, unique


def zero_sign_differences(sched, steps, rank_steps, rev, llr) -> int:
    """Elements of the alpha stacks, summed over the chunk positions, whose
    bit patterns differ between the plain one-hot and the plain rank steps
    (the one-hot apply's +0.0 where the rank gather keeps a selected -0.0)."""
    llr_rev = llr[:, rev].contiguous()
    one, rank = SCLState(sched, llr_rev, "onehot"), SCLState(sched, llr_rev)
    total = 0
    for spec, rspec in zip(steps, rank_steps):
        one.load_plain(*spec.plain(llr_rev, *one.to_plain()))
        rank.load_plain(*rspec.plain(llr_rev, *rank.to_plain()))
        if not torch.equal(one.alpha, rank.alpha):
            raise AssertionError("one-hot and rank alpha stacks differ in a value")
        total += int((one.alpha.view(torch.int32) != rank.alpha.view(torch.int32)).sum())
    return total


def check_onehot_decodes(N, mask, L, S, llr, context: dict) -> None:
    """Whole decodes under every list control with rank and one-hot
    permutations (``LIST_CONTROLS``) and the plain one-hot control equal the
    plain rank decoder: paths and metrics."""
    want = make_scl_decoder(N, mask, L, chunk=S, control_impl="unroll-fused",
                            live_width=False, device=DEV)(llr)
    for name, kw in list(LIST_CONTROLS.items()) + [
            ("unroll-fused onehot", dict(control_impl="unroll-fused", perm_impl="onehot"))]:
        got = make_scl_decoder(N, mask, L, chunk=S, device=DEV, **kw)(llr)
        torch.cuda.synchronize()
        hold_equal(f"whole decode [{name}]", {"u": (got[0], want[0]),
                                              "metrics": (got[1], want[1])}, context)


def check_onehot_other_codes() -> list:
    """The one-hot modes on the codes of ``check_scl_other_codes``: K5 on
    every chunk pattern, K3 on the state after every chunk position (per
    position and united masks), K4, and whole decodes under every control."""
    out = []
    # the six codes of check_scl_other_codes, then the flagship at chunk 64
    # (the SCL-8 main path's second chunk size)
    for N, K, S, L in ((256, 128, 32, 4), (128, 64, 128, 2), (128, 100, 8, 1),
                       (2048, 1024, 64, 16), (512, 256, 128, 32), (64, 20, 16, 3),
                       (POLAR_N, POLAR_K, 64, SCL_L)):
        frozen, _ = fec.construct_polar_code(N, K, "bhattacharyya", 2.0)
        mask = frozen_mask_from_positions(N, frozen)
        g = np.random.default_rng(N + L + 7)
        llr = torch.from_numpy((1.0 + 1.6 * g.standard_normal((203, N))).astype(np.float32))
        llr[:3] = torch.from_numpy(g.integers(-2, 3, (3, N)).astype(np.float32))
        llr = llr.to(DEV)
        context = {"N": N, "K": K, "S": S, "L": L}
        sched = build_scl_schedule(N, mask, L, S)
        programs = [SCLBodyProgram(f, L, perm_impl="onehot") for f in sched.unique_flags]
        check_scl_bodies(sched, programs, 203)
        if sched.C > 1:
            rev = torch.as_tensor(np.asarray(bit_reverse_permutation(N)), dtype=torch.int64,
                                  device=DEV)
            for union in (False, True):
                steps, last = make_step_specs(sched, programs, union=union)
                check_scl_steps(sched, steps, last, rev, llr, {**context, "union": union})
        check_onehot_decodes(N, mask, L, S, llr, context)
        out.append({**context, "kernels_equal_plain": True})
    return out


def check_onehot_devmem() -> dict:
    """The control ``"kernel"`` with one-hot permutations on N=4096, L=32,
    S=64, with the shared-memory limit lowered to the rank context: the
    one-hot chunk steps, whose staged rank vectors no longer fit, and the
    last chunk run with their context in device memory; the decode equals
    the plain one."""
    N, K, S, L, B = LARGE_SCL_N, LARGE_SCL_K, LARGE_SCL_S, LARGE_SCL_L, 128
    frozen, _, mask = polar_code(N, K)
    sched = build_scl_schedule(N, mask, L, S)
    enc = fec.PolarEncoder(N, K, frozen_bits=frozen, device=DEV)
    llr = seeded_llrs(enc.encode(np.random.default_rng(90).integers(0, 2, (B, K))), 1.0, seed=91)
    want = make_scl_decoder(N, mask, L, chunk=S, control_impl="unroll-fused", device=DEV)(llr)
    saved = scl_cuda.SMEM_LIMIT_BYTES
    scl_cuda.SMEM_LIMIT_BYTES = scl_cuda.smem_per_frame(L, S)
    try:
        if not (context_in_device_memory(L, S, 0, sched.t)
                and not context_in_device_memory(L, S)):
            raise AssertionError("the lowered limit does not split rank and one-hot contexts")
        dec = make_scl_decoder(N, mask, L, chunk=S, control_impl="kernel", perm_impl="onehot",
                               device=DEV)
        ops.reset_launch_counts()
        got = dec(llr)
        torch.cuda.synchronize()
        counts = ops.launch_counts()
        ms = time_ms(lambda: dec(llr), 2, warmup=1)
    finally:
        scl_cuda.SMEM_LIMIT_BYTES = saved
    hold_equal("whole decode [kernel onehot, device memory]",
               {"u": (got[0], want[0]), "metrics": (got[1], want[1])}, {"N": N, "S": S, "L": L})
    if (counts["scl_chunk_step_onehot_devmem"], counts["scl_last_chunk_onehot_devmem"],
            counts["scl_chunk_step_onehot"]) != (sched.C - 1, 1, 0):
        raise AssertionError(f"kernel onehot, device memory: launched {counts}")
    return {"N": N, "K": K, "S": S, "L": L, "B": B, "smem_limit_bytes": scl_cuda.smem_per_frame(L, S),
            "onehot_context_bytes": scl_cuda.smem_per_frame(L, S, 0, sched.t),
            "step_devmem_launches": counts["scl_chunk_step_onehot_devmem"],
            "last_devmem_launches": counts["scl_last_chunk_onehot_devmem"],
            "decode_ms": ms, "kernels_equal_plain": True}


def phase_onehot_kernels(results: dict, reps: int, quick: bool) -> None:
    """K5 / K3 / K4 in their one-hot modes against the plain one-hot chunk
    body, step and last chunk at the flagship (N=1024, K=512, L=8, S=128):
    every chunk pattern; the whole state after every chunk position, by bit
    pattern, at the per-position and at the united masks; whole decodes under
    every control; integer LLRs (exact zeros: the sign rule of the one-hot
    apply); the main path's 4096 frames, timed; other codes; the control
    ``"kernel"`` with the context in device memory."""
    frozen, info, mask, sched, steps, union_steps, last, unique = onehot_flagship()
    rank_steps, _ = make_step_specs(sched)
    rev = torch.as_tensor(np.asarray(bit_reverse_permutation(POLAR_N)), dtype=torch.int64,
                          device=DEV)
    worst = {"body": 0.0, "step": 0.0}
    for B in ((512,) if quick else (512, 1000)):
        worst["body"] = max(worst["body"], check_scl_bodies(sched, unique, B))
    inputs = [(1000, snr, cascl_llrs(frozen, 1000, snr, seed=int(10 * snr) + 250))
              for snr in (-2.0, 3.0)]
    inputs.append((512, "integer LLRs", torch.from_numpy(np.random.default_rng(9).integers(
        -3, 4, (512, POLAR_N)).astype(np.float32)).to(DEV)))
    cases = []
    for B, snr, llr in inputs:
        context = {"B": B, "snr_db": snr}
        for name, specs in (("per-position masks", steps), ("united masks", union_steps)):
            worst["step"] = max(worst["step"], check_scl_steps(
                sched, specs, last, rev, llr, {**context, "masks": name}))
        check_onehot_decodes(POLAR_N, mask, SCL_L, SCL_S, llr, context)
        cases.append({**context, "kernels_equal_plain": True, "zero_sign_differences":
                      zero_sign_differences(sched, steps, rank_steps, rev, llr)})
    # the main path's shapes: 4096 frames at 3 dB
    B = SCL_CHUNK
    llr = cascl_llrs(frozen, B, 3.0, seed=79)
    worst["step"] = max(worst["step"], check_scl_steps(sched, union_steps, last, rev, llr,
                                                       {"B": B, "snr_db": 3.0}))
    worst["body"] = max(worst["body"], check_scl_bodies(sched, unique, B))
    time_scl_kernels(results, sched, union_steps, last, rev, llr, worst, reps, 1)
    refused = [raises_value_error(lambda: make_scl_decoder(
                   POLAR_N, mask, SCL_L, chunk=SCL_S, perm_impl="onehot", node_mode="fast",
                   control_impl=c, device=DEV)) for c in ("unroll-kernel", "kernel")]
    refused.append(raises_value_error(lambda: make_scl_decoder(
        POLAR_N, mask, SCL_L, chunk=SCL_S, perm_impl="onehot", node_mode="fast",
        control_impl="unroll-fused", body_impl="cuda", device=DEV)))
    refused.append(raises_value_error(lambda: make_scl_decoder(
        POLAR_N, mask, SCL_L, chunk=SCL_S, perm_impl="onehot", live_width=True, device=DEV)))
    if not all(refused):
        raise AssertionError(f"a one-hot kernel took fast nodes or live width: {refused}")
    emit("onehot_kernels",
         kernels=[{k: v for k, v in results[k].items() if k != "cases"}
                  for k in ("scl_chunk_body_onehot", "scl_chunk_step_onehot",
                            "scl_last_chunk_onehot")],
         unique_patterns=len(unique), cases=cases,
         other_codes=check_onehot_other_codes(), device_memory=check_onehot_devmem(),
         refuses_fast_and_live_width=True)


# JAX's SCL-8 benchmark (bench.py, bench_polar_scl8): N=1024, K=512
# (Bhattacharyya at 2 dB, no CRC), list 8, 8192 frames at 3 dB, chunks 128 and
# 64, under every control and both permutation algebras (LIST_CONTROLS)
SCL8_BATCH, SCL8_SNR_DB = 8192, 3.0
ONEHOT_KEYS = ("scl_chunk_step_onehot", "scl_last_chunk_onehot", "scl_chunk_body_onehot")


def phase_polar_scl8_controls(results: dict, mbps: dict, reps: int, quick: bool) -> None:
    """JAX's SCL-8 benchmark shape through ``make_scl_decoder`` under every
    control and algebra (``LIST_CONTROLS``) at chunks 128 and 64: one decode
    each with the launch counts set to 0 just before and read just after (the
    one-hot kernels must launch), the paths and metrics of each equal to
    the plain decoder's at its chunk size (and the two plain decodes equal),
    bit errors of the best-metric path; then ms per decode and info Mbit/s.
    Then a CA-SCL Monte-Carlo through ``make_polar_pipeline`` with
    ``scl_control_impl="kernel"``."""
    frozen, info, mask = polar_code()
    enc = fec.PolarEncoder(POLAR_N, POLAR_K, frozen_bits=frozen, device=DEV)
    msgs = np.random.default_rng(0).integers(0, 2, (SCL8_BATCH, POLAR_K))
    llr = seeded_llrs(enc.encode(msgs), SCL8_SNR_DB, seed=42)
    msgs_t = torch.from_numpy(msgs).to(DEV)
    info_idx = torch.as_tensor(info, dtype=torch.int64, device=DEV)
    decoders = {(S, name): make_scl_decoder(POLAR_N, mask, SCL_L, chunk=S, device=DEV, **kw)
                for S in (128, 64) for name, kw in LIST_CONTROLS.items()}
    # the plain decoder at each chunk size (torch ops only, no kernel): every
    # control is held against it, and the two chunk sizes against each other
    want = {S: make_scl_decoder(POLAR_N, mask, SCL_L, chunk=S, control_impl="unroll-fused",
                                live_width=False, device=DEV)(llr) for S in (128, 64)}
    hold_equal("SCL-8 plain decode [chunk 64 vs chunk 128]",
               {"u": (want[64][0], want[128][0]), "metrics": (want[64][1], want[128][1])}, {})
    launches, bit_errors = {}, {}
    ops.reset_launch_counts()
    for (S, name), dec in decoders.items():
        before = ops.launch_counts()
        u, m = dec(llr)
        torch.cuda.synchronize()
        after = ops.launch_counts()
        launches[f"{name}, chunk {S}"] = {k: after[k] - before[k] for k in after
                                          if after[k] != before[k]}
        hold_equal(f"SCL-8 decode [{name}, chunk {S}] vs plain",
                   {"u": (u, want[S][0]), "metrics": (m, want[S][1])}, {"chunk": S})
        best = select_best_path(u[..., info_idx], m)
        bit_errors[f"{name}, chunk {S}"] = int((best != msgs_t).sum())
    counts = record_launches(results, ONEHOT_KEYS)
    decode_ms, rates = {}, {}
    for (S, name), dec in decoders.items():
        key = f"{name}, chunk {S}"
        decode_ms[key] = time_ms(lambda: dec(llr), 2 if quick else max(3, reps // 4), warmup=1)
        rates[key] = SCL8_BATCH * POLAR_K / decode_ms[key] / 1e3
    mbps.update({f"scl8 {k}": v for k, v in rates.items()})

    # CA-SCL Monte-Carlo through the control "kernel" (rank permutations, the
    # pipeline's default; united compose masks, full width)
    kw = dict(decoder="ca-scl", list_size=SCL_L, crc_polynomial=SCL_CRC, scl_chunk=SCL_S)
    step = make_polar_pipeline(POLAR_N, POLAR_K, frozen, 3.0, device=DEV,
                               scl_control_impl="kernel", **kw)
    sim = MonteCarloSimulator(step, POLAR_K - 8, chunk_frames=SCL_CHUNK)
    sim.run(SCL_CHUNK, seed=1)
    ops.reset_launch_counts()
    frames = (1 if quick else 4) * SCL_CHUNK
    res = sim.run(frames, max_errors=None, seed=0)
    mc_counts = record_launches(results, ["scl_chunk_step", "scl_last_chunk"])
    mc_chunks = frames // SCL_CHUNK
    if (mc_counts["scl_chunk_step"], mc_counts["scl_narrow_prefix"],
            mc_counts["scl_last_chunk"]) != ((POLAR_N // SCL_S - 1) * mc_chunks, 0, mc_chunks):
        raise AssertionError(f"CA-SCL kernel control launched {mc_counts}")
    if res.frames != frames or not (0.0 <= res.fer < 0.01):
        raise AssertionError(f"CA-SCL kernel control at 3 dB: unexpected result {res.to_dict()}")
    emit("polar_scl8_controls", frames=SCL8_BATCH, N=POLAR_N, K=POLAR_K, L=SCL_L,
         snr_db=SCL8_SNR_DB, chunks=[128, 64], paths_equal_across_controls=True,
         held_against="the plain decode (unroll-fused, torch ops) at each chunk size",
         onehot_launches={k: counts[k] for k in ONEHOT_KEYS}, launches=launches,
         bit_errors=bit_errors, decode_ms=decode_ms, info_mbps=rates,
         cascl_kernel_control={**result_fields(res), "launches": {
             k: mc_counts[k] for k in ("scl_chunk_step", "scl_last_chunk",
                                       "scl_narrow_prefix")}})
    mbps["polar_cascl_kernel_control"] = res.throughput_mbps


def check_roll_kernel(results: dict, reps: int) -> dict:
    """K8 against its plain version and np.roll at the probe's tile and on
    other shapes (rows not a power of two, rows of 40 bytes: the byte path,
    shifts past the row count and negative, a tile at an odd byte offset of
    its storage: the byte path); then the probe's own path (its
    seeded 0/1 tile through ``sublane_roll``, held against np.roll), with the
    launch counts set to 0 just before; then times beside ``torch.roll``."""
    cases = []
    for (rows, cols), shift in ((PROBE_SHAPE, PROBE_SHIFT), ((32, 128), -7), ((24, 64), 53),
                                ((7, 40), 3), ((4096, 128), PROBE_SHIFT)):
        x_np = np.random.default_rng(rows + cols).integers(-128, 128, (rows, cols)).astype(np.int8)
        x = torch.from_numpy(x_np).to(DEV)
        got = sublane_roll_cuda(x, shift)
        torch.cuda.synchronize()
        context = {"shape": [rows, cols], "shift": shift}
        hold_equal("sublane_roll", {"plain": (got, sublane_roll_plain(x, shift)),
                                    "np.roll": (got.cpu(), torch.from_numpy(np.roll(x_np, shift, 0)))},
                   context)
        cases.append({**context, "equal_plain_and_np_roll": True})
    # a contiguous view that starts one byte into its storage
    x_np = np.random.default_rng(1).integers(-128, 128, (32, 128)).astype(np.int8)
    flat = torch.zeros(32 * 128 + 1, dtype=torch.int8, device=DEV)
    flat[1:].copy_(torch.from_numpy(x_np.reshape(-1)))
    x = flat[1:].view(32, 128)
    got = sublane_roll_cuda(x, PROBE_SHIFT)
    torch.cuda.synchronize()
    context = {"shape": [32, 128], "shift": PROBE_SHIFT, "storage_offset": 1}
    hold_equal("sublane_roll", {"plain": (got, sublane_roll_plain(x, PROBE_SHIFT)),
                                "np.roll": (got.cpu(), torch.from_numpy(np.roll(x_np, PROBE_SHIFT, 0)))},
               context)
    cases.append({**context, "equal_plain_and_np_roll": True})
    # the probe's path (tools/r4_tpu_queue7.sh:6-19)
    x_np = np.random.default_rng(0).integers(0, 2, PROBE_SHAPE).astype(np.int8)
    x = torch.from_numpy(x_np).to(DEV)
    ops.reset_launch_counts()
    out = sublane_roll(x, PROBE_SHIFT)
    torch.cuda.synchronize()
    counts = record_launches({}, ["sublane_roll"])
    if not np.array_equal(out.cpu().numpy(), np.roll(x_np, PROBE_SHIFT, 0)):
        raise AssertionError("sublane_roll disagrees with the probe's np.roll")
    # CUDA events around back-to-back calls (the host's issue included) and the
    # profiler's device time of the kernel alone, K8 and torch.roll alike
    # (in turns, three times each: the host's pace drifts)
    ms, library_ms = [], []
    for _ in range(3):
        ms.append(time_ms(lambda: sublane_roll_cuda(x, PROBE_SHIFT), 10 * reps))
        library_ms.append(time_ms(lambda: torch.roll(x, PROBE_SHIFT, 0), 10 * reps))
    ms, library_ms = sum(ms) / 3, sum(library_ms) / 3
    plain_ms = time_ms(lambda: sublane_roll_plain(x, PROBE_SHIFT), reps)
    row = kernel_row("sublane_roll", "tools/r4_tpu_queue7.sh:14", ms, plain_ms,
                     2 * x.numel(), 0, 0.0, source="polarcode_and_ldpc_tpu_torch/ops/csrc/sublane_roll.cu",
                     shape=list(PROBE_SHAPE), shift=PROBE_SHIFT,
                     device_ms=device_ms(lambda: sublane_roll_cuda(x, PROBE_SHIFT), 10 * reps),
                     library_device_ms=device_ms(lambda: torch.roll(x, PROBE_SHIFT, 0), 10 * reps,
                                                expect=1),
                     note="on no path: a probe; launches: the probe's path; ms and library_ms "
                          "by CUDA events around back-to-back calls, device_ms and "
                          "library_device_ms by torch.profiler", cases=cases)
    row["library_ms"] = library_ms
    row["launches"] = counts["sublane_roll"]
    results["sublane_roll"] = row
    return {k: v for k, v in row.items() if k != "cases"}


def phase_kernels(results: dict, reps: int, quick: bool) -> None:
    check_roll_kernel(results, reps)
    check_sc_kernel(results, reps)
    check_bp_kernel(results, reps)
    check_bp_layered_kernel(results, reps, quick)
    layered = results["bp_decode_layered"]["cases"]
    emit("kernels", kernels=[
        {k: v for k, v in r.items() if k != "cases"} for r in results.values()],
        roll_cases=results["sublane_roll"]["cases"],
        sc_cases=results["sc_decode"]["cases"], bp_cases=results["bp_decode_bp"]["cases"],
        layered_cases={"cases": len(layered), "frames": sum(c["B"] for c in layered),
                       "frames_differ": sum(c["frames_differ"] for c in layered),
                       "rules": ["nms 0.75", "oms 0.5", "ms"], "num_layers": [1, 4, 6],
                       "early_stop": [True, False], "B": [4096, 999, "777 (padded slots)"],
                       "snr_db": [-1.0, 1.0, 3.0],
                       "bsc_cases": sum("bsc" in str(c["snr_db"]) for c in layered
                                        if "snr_db" in c)})


def record_launches(results: dict, keys) -> dict:
    counts = ops.launch_counts()
    for key in keys:
        if counts[key] < 1:
            raise AssertionError(f"the main path launched the {key} kernel no time: {counts}")
        if key in results:
            results[key]["launches"] += counts[key]
    return counts


def result_fields(res) -> dict:
    return {"frames": res.frames, "bit_errors": res.bit_errors,
            "frame_errors": res.frame_errors, "ber": res.ber, "fer": res.fer,
            "seconds": res.elapsed_seconds, "info_mbps": res.throughput_mbps}


def phase_polar_sc_mc(results: dict, mbps: dict, frames: int) -> None:
    frozen, info, mask = polar_code()
    step = make_polar_pipeline(POLAR_N, POLAR_K, frozen, 3.0, decoder="sc", device=DEV)
    sim = MonteCarloSimulator(step, POLAR_K, chunk_frames=POLAR_CHUNK)
    sim.run(POLAR_CHUNK, seed=1)  # warm-up: first use of every op on the card
    ops.reset_launch_counts()
    res = sim.run(frames, max_errors=None, seed=0)
    counts = record_launches(results, ["sc_decode"])
    if res.frames != frames or not (0.0 <= res.fer < 0.05):
        raise AssertionError(f"polar SC at 3 dB: unexpected result {res.to_dict()}")

    # early stop: stop at 100 frame errors, the crossing frame included.  At
    # 1 dB this code makes no error in 10^5 frames, so the run is at LOW_SNR_DB
    step1 = make_polar_pipeline(POLAR_N, POLAR_K, frozen, LOW_SNR_DB, decoder="sc", device=DEV)
    res1 = MonteCarloSimulator(step1, POLAR_K, chunk_frames=POLAR_CHUNK).run(
        8 * POLAR_CHUNK, max_errors=100, seed=0)
    if res1.frame_errors != 100 or not (100 <= res1.frames < 8 * POLAR_CHUNK):
        raise AssertionError(f"early stop did not cross at 100 errors: {res1.to_dict()}")

    # the kernel path against the plain pipeline on the same frame ids and seed
    plain = make_polar_pipeline(POLAR_N, POLAR_K, frozen, 3.0, decoder="sc",
                                sc_impl="unrolled", device=DEV)
    key = rng.prng_key(0, DEV)
    ids = torch.arange(POLAR_CHUNK, device=DEV)
    a, b = step(key, ids), plain(key, ids)
    if not (torch.equal(a["bit_errors"], b["bit_errors"])
            and torch.equal(a["frame_error"], b["frame_error"])):
        raise AssertionError("kernel pipeline and plain pipeline disagree on the first chunk")

    # a small input against the CPU pipeline: integer randomness is equal bit
    # for bit; the float noise may differ in its last bits between the CPU's
    # and the card's log1p/sqrt, so at most 1 frame in 256 may decode otherwise
    cpu = make_polar_pipeline(POLAR_N, POLAR_K, frozen, LOW_SNR_DB, decoder="sc", device="cpu")
    ids256 = torch.arange(256)
    c = cpu(rng.prng_key(0, "cpu"), ids256)
    g = step1(key, ids256.to(DEV))
    differ = int((c["bit_errors"] != g["bit_errors"].cpu()).sum())
    if differ > 1:
        raise AssertionError(f"card and CPU pipelines differ on {differ} of 256 frames")
    emit("polar_sc_mc", **result_fields(res), chunk_frames=POLAR_CHUNK, launches=counts,
         early_stop={"snr_db": LOW_SNR_DB, "max_errors": 100, **result_fields(res1)}, first_chunk_equals_plain=True,
         cpu_reference_frames_differ=differ)
    mbps["polar_sc"] = res.throughput_mbps


def phase_polar_cascl_mc(results: dict, mbps: dict, frames: int, body_frames: int) -> None:
    """This slice's path at full width: CA-SCL-8, N=1024, K=512, CRC-8."""
    frozen, info, mask = polar_code()
    k_msg = POLAR_K - 8
    kw = dict(decoder="ca-scl", list_size=SCL_L, crc_polynomial=SCL_CRC, scl_chunk=SCL_S)
    n_chunks = POLAR_N // SCL_S
    n_narrow = flagship_narrow_steps()
    step = make_polar_pipeline(POLAR_N, POLAR_K, frozen, 3.0, device=DEV, **kw)
    sim = MonteCarloSimulator(step, k_msg, chunk_frames=SCL_CHUNK)
    sim.run(SCL_CHUNK, seed=1)  # warm-up
    ops.reset_launch_counts()
    res = sim.run(frames, max_errors=None, seed=0)
    counts = record_launches(results, ["scl_narrow_prefix", "scl_chunk_step",
                                       "scl_last_chunk"])
    mc_chunks = frames // SCL_CHUNK
    # the narrow positions (2) in one prefix launch a decode
    if (counts["scl_narrow_prefix"], counts["scl_chunk_step"], counts["scl_last_chunk"],
            counts["scl_chunk_body"]) != (prefix_launches(n_narrow) * mc_chunks,
                                          (n_chunks - 1 - n_narrow) * mc_chunks, mc_chunks, 0):
        raise AssertionError(f"CA-SCL: {mc_chunks} Monte-Carlo chunks launched {counts}")
    if res.frames != frames or not (0.0 <= res.fer < 0.01):
        raise AssertionError(f"polar CA-SCL at 3 dB: unexpected result {res.to_dict()}")

    # early stop at an SNR where the list decoder still errs
    step_low = make_polar_pipeline(POLAR_N, POLAR_K, frozen, SCL_LOW_SNR_DB, device=DEV, **kw)
    res1 = MonteCarloSimulator(step_low, k_msg, chunk_frames=SCL_CHUNK).run(
        8 * SCL_CHUNK, max_errors=100, seed=0)
    if res1.frame_errors != 100 or not (0.01 <= res1.fer <= 0.5):
        raise AssertionError(f"CA-SCL early stop did not cross at 100 errors: {res1.to_dict()}")

    # a shorter run through the chunk-body kernel inside the plain chunk program
    step_body = make_polar_pipeline(POLAR_N, POLAR_K, frozen, 3.0, device=DEV,
                                    scl_control_impl="unroll-fused", scl_body_impl="cuda", **kw)
    sim_body = MonteCarloSimulator(step_body, k_msg, chunk_frames=SCL_CHUNK)
    sim_body.run(SCL_CHUNK, seed=1)
    ops.reset_launch_counts()
    res_body = sim_body.run(body_frames, max_errors=None, seed=0)
    counts_body = record_launches(results, ["scl_chunk_body"])
    if (counts_body["scl_chunk_body"], counts_body["scl_chunk_step"]) != (
            n_chunks * (body_frames // SCL_CHUNK), 0):
        raise AssertionError(f"CA-SCL body_impl=cuda launched {counts_body}")

    # the same run through the one-launch list decode: one launch per chunk,
    # none of the per-chunk kernels, the same counters
    step_mega = make_polar_pipeline(POLAR_N, POLAR_K, frozen, 3.0, device=DEV,
                                    scl_control_impl="mega", **kw)
    sim_mega = MonteCarloSimulator(step_mega, k_msg, chunk_frames=SCL_CHUNK)
    sim_mega.run(SCL_CHUNK, seed=1)
    ops.reset_launch_counts()
    res_mega = sim_mega.run(frames, max_errors=None, seed=0)
    counts_mega = record_launches(results, ["scl_decode_mega"])
    if (counts_mega["scl_decode_mega"], counts_mega["scl_chunk_step"],
            counts_mega["scl_narrow_prefix"], counts_mega["scl_last_chunk"]) != (
            mc_chunks, 0, 0, 0):
        raise AssertionError(f"CA-SCL mega: {mc_chunks} Monte-Carlo chunks launched {counts_mega}")
    if (res_mega.frames, res_mega.bit_errors, res_mega.frame_errors) != (
            res.frames, res.bit_errors, res.frame_errors):
        raise AssertionError(f"CA-SCL mega counts {res_mega.to_dict()}, unroll-kernel {res.to_dict()}")
    mega_low = make_polar_pipeline(POLAR_N, POLAR_K, frozen, SCL_LOW_SNR_DB, device=DEV,
                                   scl_control_impl="mega", **kw)

    # the kernel paths against the plain pipeline on the same frame ids and seed
    plain = make_polar_pipeline(POLAR_N, POLAR_K, frozen, SCL_LOW_SNR_DB, device=DEV,
                                scl_control_impl="unroll-fused", **kw)
    body_low = make_polar_pipeline(POLAR_N, POLAR_K, frozen, SCL_LOW_SNR_DB, device=DEV,
                                   scl_control_impl="unroll-fused", scl_body_impl="cuda", **kw)
    key = rng.prng_key(0, DEV)
    ids = torch.arange(SCL_CHUNK, device=DEV)
    want = plain(key, ids)
    for name, other in (("unroll-kernel", step_low), ("body_impl=cuda", body_low),
                        ("mega", mega_low)):
        got = other(key, ids)
        if not (torch.equal(got["bit_errors"], want["bit_errors"])
                and torch.equal(got["frame_error"], want["frame_error"])):
            raise AssertionError(f"CA-SCL: {name} and the plain pipeline disagree on the first chunk")

    # a small input against the CPU pipeline (at most 1 frame in 256 may decode
    # otherwise: the float noise and the metrics' exp/log1p may differ in their
    # last bits between the CPU and the card)
    cpu = make_polar_pipeline(POLAR_N, POLAR_K, frozen, SCL_LOW_SNR_DB, device="cpu", **kw)
    ids256 = torch.arange(256)
    c = cpu(rng.prng_key(0, "cpu"), ids256)
    g = step_low(key, ids256.to(DEV))
    differ = int((c["bit_errors"] != g["bit_errors"].cpu()).sum())
    if differ > 1:
        raise AssertionError(f"CA-SCL: card and CPU pipelines differ on {differ} of 256 frames")
    emit("polar_cascl_mc", **result_fields(res), chunk_frames=SCL_CHUNK, list_size=SCL_L,
         crc=SCL_CRC, scl_chunk=SCL_S, launches=counts,
         early_stop={"snr_db": SCL_LOW_SNR_DB, "max_errors": 100, **result_fields(res1)},
         body_impl_cuda={**result_fields(res_body), "launches": counts_body},
         mega={**result_fields(res_mega), "launches": counts_mega},
         first_chunk_equals_plain=True, frame_errors_first_chunk=int(want["frame_error"].sum()),
         cpu_reference_frames_differ=differ)
    mbps["polar_cascl"] = res.throughput_mbps
    mbps["polar_cascl_body_impl_cuda"] = res_body.throughput_mbps
    mbps["polar_cascl_mega"] = res_mega.throughput_mbps


def phase_polar_fast_mc(results: dict, mbps: dict, frames: int, body_frames: int) -> None:
    """This slice's path at full width: CA-SCL-8 with the fast list nodes
    (``scl_node_mode="fast"``) on the flagship code through the per-chunk
    kernels, beside the exact mode on the same seeds: 3 dB, and -2 dB with
    early stop and on a fixed frame count, where the fast FER must lie within
    3 binomial sigma of the exact one."""
    frozen, info, mask = polar_code()
    k_msg = POLAR_K - 8
    kw = dict(decoder="ca-scl", list_size=SCL_L, crc_polynomial=SCL_CRC, scl_chunk=SCL_S,
              device=DEV)
    n_chunks = POLAR_N // SCL_S
    mc_chunks = frames // SCL_CHUNK
    out = {}
    for mode in ("exact", "fast"):
        step = make_polar_pipeline(POLAR_N, POLAR_K, frozen, 3.0, scl_node_mode=mode, **kw)
        sim = MonteCarloSimulator(step, k_msg, chunk_frames=SCL_CHUNK)
        sim.run(SCL_CHUNK, seed=1)  # warm-up
        ops.reset_launch_counts()
        res = sim.run(frames, max_errors=None, seed=0)
        if mode == "fast":
            counts = record_launches(results, ["scl_chunk_step_fast", "scl_last_chunk_fast"])
            want = {"scl_chunk_step_fast": (n_chunks - 1) * mc_chunks,
                    "scl_last_chunk_fast": mc_chunks, "scl_chunk_step": 0, "scl_last_chunk": 0}
        else:
            counts = ops.launch_counts()
            n_narrow = flagship_narrow_steps()
            want = {"scl_chunk_step": (n_chunks - 1 - n_narrow) * mc_chunks,
                    "scl_narrow_prefix": prefix_launches(n_narrow) * mc_chunks,
                    "scl_last_chunk": mc_chunks, "scl_chunk_step_fast": 0,
                    "scl_last_chunk_fast": 0}
        if any(counts[k] != v for k, v in want.items()):
            raise AssertionError(f"CA-SCL {mode}: {mc_chunks} Monte-Carlo chunks launched {counts}")
        if res.frames != frames or not (0.0 <= res.fer < 0.01):
            raise AssertionError(f"polar CA-SCL {mode} at 3 dB: unexpected result {res.to_dict()}")
        low = make_polar_pipeline(POLAR_N, POLAR_K, frozen, SCL_LOW_SNR_DB, scl_node_mode=mode,
                                  **kw)
        early = MonteCarloSimulator(low, k_msg, chunk_frames=SCL_CHUNK).run(
            8 * SCL_CHUNK, max_errors=100, seed=0)
        if early.frame_errors != 100 or not (0.01 <= early.fer <= 0.5):
            raise AssertionError(f"CA-SCL {mode} early stop did not cross at 100 errors: "
                                 f"{early.to_dict()}")
        fixed = MonteCarloSimulator(low, k_msg, chunk_frames=SCL_CHUNK).run(
            2 * SCL_CHUNK, max_errors=None, seed=2)
        out[mode] = {**result_fields(res), "launches": {k: v for k, v in counts.items() if v},
                     "early_stop": {"snr_db": SCL_LOW_SNR_DB, "max_errors": 100,
                                    **result_fields(early)},
                     "fixed_frames_low_snr": {"snr_db": SCL_LOW_SNR_DB, **result_fields(fixed)}}
        mbps[f"polar_cascl_{mode}" if mode == "fast" else "polar_cascl_exact_beside_fast"] = \
            res.throughput_mbps
    fe, ff = out["exact"]["fixed_frames_low_snr"], out["fast"]["fixed_frames_low_snr"]
    sigma = math.sqrt(fe["fer"] * (1.0 - fe["fer"]) / ff["frames"])
    if abs(ff["fer"] - fe["fer"]) > 3 * sigma:
        raise AssertionError(f"fast FER {ff['fer']} is not within 3 sigma ({sigma}) of exact "
                             f"FER {fe['fer']} at {SCL_LOW_SNR_DB} dB")

    # a shorter run through the chunk-body kernel inside the plain chunk program
    step_body = make_polar_pipeline(POLAR_N, POLAR_K, frozen, 3.0, scl_node_mode="fast",
                                    scl_control_impl="unroll-fused", scl_body_impl="cuda", **kw)
    sim_body = MonteCarloSimulator(step_body, k_msg, chunk_frames=SCL_CHUNK)
    sim_body.run(SCL_CHUNK, seed=1)
    ops.reset_launch_counts()
    res_body = sim_body.run(body_frames, max_errors=None, seed=0)
    counts_body = record_launches(results, ["scl_chunk_body_fast"])
    if (counts_body["scl_chunk_body_fast"], counts_body["scl_chunk_step_fast"]) != (
            n_chunks * (body_frames // SCL_CHUNK), 0):
        raise AssertionError(f"CA-SCL fast body_impl=cuda launched {counts_body}")
    if not raises_value_error(lambda: make_polar_pipeline(
            POLAR_N, POLAR_K, frozen, 3.0, scl_node_mode="fast", scl_control_impl="mega", **kw)):
        raise AssertionError("the one-launch control took node_mode='fast'")

    # the kernel paths against the plain fast pipeline on the same frame ids and seed
    key = rng.prng_key(0, DEV)
    ids = torch.arange(SCL_CHUNK, device=DEV)
    plain = make_polar_pipeline(POLAR_N, POLAR_K, frozen, SCL_LOW_SNR_DB, scl_node_mode="fast",
                                scl_control_impl="unroll-fused", **kw)
    want = plain(key, ids)
    for name, ctl in (("unroll-kernel", {}),
                      ("body_impl=cuda", {"scl_control_impl": "unroll-fused",
                                          "scl_body_impl": "cuda"})):
        got = make_polar_pipeline(POLAR_N, POLAR_K, frozen, SCL_LOW_SNR_DB, scl_node_mode="fast",
                                  **ctl, **kw)(key, ids)
        if not (torch.equal(got["bit_errors"], want["bit_errors"])
                and torch.equal(got["frame_error"], want["frame_error"])):
            raise AssertionError(f"CA-SCL fast: {name} and the plain pipeline disagree")
    # a small input against the CPU pipeline (at most 1 frame in 256 may differ)
    cpu = make_polar_pipeline(POLAR_N, POLAR_K, frozen, SCL_LOW_SNR_DB, scl_node_mode="fast",
                              **{**kw, "device": "cpu"})
    ids256 = torch.arange(256)
    c = cpu(rng.prng_key(0, "cpu"), ids256)
    g = make_polar_pipeline(POLAR_N, POLAR_K, frozen, SCL_LOW_SNR_DB, scl_node_mode="fast",
                            **kw)(key, ids256.to(DEV))
    differ = int((c["bit_errors"] != g["bit_errors"].cpu()).sum())
    if differ > 1:
        raise AssertionError(f"CA-SCL fast: card and CPU pipelines differ on {differ} of 256")
    emit("polar_fast_mc", chunk_frames=SCL_CHUNK, list_size=SCL_L, crc=SCL_CRC, scl_chunk=SCL_S,
         **out, fast_fer_within_3_sigma_of_exact={"sigma": sigma, "fast": ff["fer"],
                                                  "exact": fe["fer"]},
         body_impl_cuda={**result_fields(res_body), "launches": counts_body},
         first_chunk_equals_plain=True, frame_errors_first_chunk=int(want["frame_error"].sum()),
         cpu_reference_frames_differ=differ)
    mbps["polar_cascl_fast_body_impl_cuda"] = res_body.throughput_mbps


def phase_snr_curves(results: dict) -> None:
    """The SNR-curve CLI of the port at full width on the card: polar N=1024
    CA-SCL-8 with fast nodes and LDPC n=1008 BP at rate 0.5, three SNR
    points; outputs under the git-ignored ``chiprun_out/``."""
    from polarcode_and_ldpc_tpu_torch.cli import snr_curves

    out_dir = Path("chiprun_out") / "snr_curves"
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    res = snr_curves.main(SNR_CURVE_ARGS + ["--output-dir", str(out_dir)])
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    counts = record_launches({}, ["scl_chunk_step_fast", "scl_last_chunk_fast", "bp_decode_bp"])
    files = {name: json.loads((out_dir / name).read_text())
             for name in ("polar_results.json", "ldpc_results.json", "snr_analysis.json")}
    curves = {"polar": files["polar_results.json"]["self"]["0.50"],
              "ldpc": files["ldpc_results.json"]["self"]["0.50"]}
    for family, curve in curves.items():
        if curve != json.loads(json.dumps(res[family]["self"]["0.50"])):
            raise AssertionError(f"snr_curves: {family}_results.json differs from main()'s result")
        bers = curve["ber"]
        if (curve["snr_db"] != [-1.0, 0.0, 1.0] or not all(0.0 <= b < 0.5 for b in bers)
                or any(n != 16384 and e != 200
                       for n, e in zip(curve["frames_tested"], curve["frame_errors"]))
                or any(b2 > b1 for b1, b2 in zip(bers, bers[1:]))):
            raise AssertionError(f"snr_curves: unexpected {family} curve {curve}")
    # the polar curve's first point against the plain fast pipeline, chunk by chunk
    frozen, _ = fec.construct_polar_code(POLAR_N, POLAR_K, "dega", 2.0)
    plain = make_polar_pipeline(POLAR_N, POLAR_K, frozen, None, decoder="ca-scl",
                                list_size=SCL_L, scl_node_mode="fast",
                                scl_control_impl="unroll-fused", device=DEV)
    ref = MonteCarloSimulator(plain, POLAR_K - 8, chunk_frames=4096).run(
        16384, max_errors=200, seed=42, extra_args=(-1.0,))
    first = curves["polar"]
    if (ref.frames, ref.bit_errors, ref.frame_errors) != (
            first["frames_tested"][0], first["bit_errors"][0], first["frame_errors"][0]):
        raise AssertionError(f"snr_curves: the -1 dB point {first} differs from the plain "
                             f"fast pipeline's {ref.to_dict()}")
    emit("snr_curves", argv=SNR_CURVE_ARGS, seconds=seconds, output_dir=str(out_dir),
         launches={k: v for k, v in counts.items() if v},
         polar={k: curves["polar"][k] for k in ("snr_db", "ber", "fer", "frames_tested",
                                                 "throughput_mbps")},
         ldpc={k: curves["ldpc"][k] for k in ("snr_db", "ber", "fer", "frames_tested",
                                               "avg_iterations", "throughput_mbps")},
         analysis=files["snr_analysis.json"], first_point_equals_plain_pipeline=True)


# -- the channels and the benchmark front end (BSC, fading; the reference's CLIs) --------

# the Monte-Carlo paths over the other channels: (name, kind, channel keywords,
# the runtime SNR in dB or None for the BSC)
SC_CHANNELS = (("bsc_p0.05", "bsc", {"crossover_prob": 0.05}, None),
               ("bsc_p0.11", "bsc", {"crossover_prob": 0.11}, None),
               ("rayleigh_3db", "rayleigh", {}, 3.0),
               ("rayleigh_6db", "rayleigh", {}, 6.0))
LDPC_CHANNELS = (("bsc_p0.05", "bsc", {"crossover_prob": 0.05}, None),
                 ("rician_k3_3db", "rician", {"k_factor": 3.0}, 3.0))
CHANNEL_SCL_SNR_DB = 3.0
CHANNEL_SCL_FRAMES = 4096


def channel_step(make, kind: str, chan_kw: dict, **kw):
    """A pipeline over one channel (a runtime-SNR step for the fading kinds)."""
    return make(channel_fn=make_channel_fn(kind, snr_db=None, **chan_kw), **kw)


def hold_channel_path(what: str, results: dict, keys, step, plain, snr, chunk: int,
                      frames: int, k: int, allowed: int = 0) -> dict:
    """One Monte-Carlo path over a channel: the kernel pipeline's launches
    counted over its run, its counters equal at half the chunk size, and its
    first chunk held frame for frame against the same pipeline on the plain
    versions (``allowed`` frames may differ)."""
    extra = () if snr is None else (snr,)
    sim = MonteCarloSimulator(step, k, chunk_frames=chunk)
    sim.run(chunk, seed=1, extra_args=extra)  # warm-up
    ops.reset_launch_counts()
    res = sim.run(frames, max_errors=None, seed=0, extra_args=extra)
    torch.cuda.synchronize()
    counts = record_launches(results, keys)
    half = MonteCarloSimulator(step, k, chunk_frames=chunk // 2).run(
        frames, max_errors=None, seed=0, extra_args=extra)
    if (half.frames, half.bit_errors, half.frame_errors, half.total_iterations) != (
            res.frames, res.bit_errors, res.frame_errors, res.total_iterations):
        raise AssertionError(f"{what}: the counters differ between chunks of {chunk} and "
                             f"{chunk // 2}: {res.to_dict()} {half.to_dict()}")
    key = rng.prng_key(0, DEV)
    ids = torch.arange(chunk, device=DEV)
    a, b = step(key, ids, *extra), plain(key, ids, *extra)
    bad = (a["bit_errors"] != b["bit_errors"]) | (a["frame_error"] != b["frame_error"])
    if "iterations" in a:
        bad |= a["iterations"] != b["iterations"]
    differ = int(bad.sum())
    if differ > allowed:
        raise AssertionError(f"{what}: the kernel and plain pipelines differ on {differ} "
                             "frames of the first chunk")
    if res.frames != frames or not 0.0 <= res.ber < 0.5:
        raise AssertionError(f"{what}: unexpected result {res.to_dict()}")
    return {**result_fields(res), "mean_iterations": res.avg_iterations,
            "launches": {name: v for name, v in counts.items() if v},
            "first_chunk_frames_differ_from_plain": differ,
            "chunk_sizes_equal": [chunk, chunk // 2]}


def phase_channels_mc(results: dict, mbps: dict, quick: bool) -> None:
    """The Monte-Carlo main paths over the BSC and the fading channels at full
    width: polar SC N=1024 (K1), CA-SCL-8 N=1024 CRC-8 (narrow prefix, K3,
    K4) and LDPC (504, 252) BP / NMS 0.75 (K2)."""
    frozen, info, mask = polar_code()
    out = {}
    for name, kind, kw, snr in SC_CHANNELS:
        polar = functools.partial(make_polar_pipeline, POLAR_N, POLAR_K, frozen, None,
                                  decoder="sc", device=DEV)
        out[f"polar_sc_{name}"] = hold_channel_path(
            f"polar SC over {name}", results, ["sc_decode"], channel_step(polar, kind, kw),
            channel_step(polar, kind, kw, sc_impl="unrolled"), snr, POLAR_CHUNK,
            (2 if quick else 4) * POLAR_CHUNK, POLAR_K)
    cascl = functools.partial(make_polar_pipeline, POLAR_N, POLAR_K, frozen, None,
                              decoder="ca-scl", list_size=SCL_L, crc_polynomial=SCL_CRC,
                              scl_chunk=SCL_S, device=DEV)
    out["polar_cascl_rayleigh_3db"] = hold_channel_path(
        "CA-SCL-8 over rayleigh", results,
        ["scl_narrow_prefix", "scl_chunk_step", "scl_last_chunk"],
        channel_step(cascl, "rayleigh", {}),
        channel_step(cascl, "rayleigh", {}, scl_control_impl="unroll-fused"),
        CHANNEL_SCL_SNR_DB, SCL_CHUNK, CHANNEL_SCL_FRAMES, POLAR_K - 8)
    enc = ldpc_code()
    for decoder, key, kw_dec in (("bp", "bp_decode_bp", {}),
                                 ("nms", "bp_decode_ms", {"normalization": 0.75})):
        for name, kind, kw, snr in LDPC_CHANNELS:
            ldpc = functools.partial(make_ldpc_pipeline, enc.H, enc.G, None, decoder=decoder,
                                     max_iter=LDPC_ITERS, message_idx=enc.info_positions,
                                     device=DEV, **kw_dec)
            out[f"ldpc_{decoder}_{name}"] = hold_channel_path(
                f"LDPC {decoder} over {name}", results, [key], channel_step(ldpc, kind, kw),
                channel_step(ldpc, kind, kw, bp_impl="torch"), snr, LDPC_CHUNK,
                (2 if quick else 8) * LDPC_CHUNK, LDPC_K,
                allowed=LDPC_CHUNK // 1000 if decoder == "bp" else 0)
    mbps.update({name: r["info_mbps"] for name, r in out.items()})
    emit("channels_mc", **out)


# the throughput CLI at the main paths' batches: (name, flags, its kernels)
THROUGHPUT_RUNS = (
    ("polar_sc", ["--batch", "16384", "--skip-ldpc"], ["sc_decode"]),
    ("polar_scl8", ["--polar-decoder", "scl", "--list-size", "8", "--batch", "4096",
                    "--skip-ldpc"], ["scl_narrow_prefix", "scl_chunk_step", "scl_last_chunk"]),
    ("ldpc_bp", ["--batch", "4096", "--skip-polar"], ["bp_decode_bp"]))
RATE_KEYS = ("encoding_throughput", "decoding_throughput", "end_to_end_throughput")


def check_rates(what: str, r: dict) -> None:
    bad = {k: r[k] for k in RATE_KEYS if not (math.isfinite(r[k]) and r[k] > 0)}
    if bad:
        raise AssertionError(f"{what}: rates not positive: {bad}")


def phase_throughput(results: dict, mbps: dict) -> None:
    """``cli.throughput`` at SC batch 16384, SCL-8 batch 4096 and LDPC BP batch
    4096 (the first call of each probe, outside its clock, may build), and one
    ``profile_trace`` of a polar SC chunk, whose trace must hold the SC
    kernel's device events."""
    from polarcode_and_ldpc_tpu_torch.cli import throughput
    from polarcode_and_ldpc_tpu_torch.utils import profile_trace

    out = {}
    for name, argv, keys in THROUGHPUT_RUNS:
        ops.reset_launch_counts()
        (r,) = throughput.main(argv + ["--output-dir", f"chiprun_out/throughput/{name}"]).values()
        torch.cuda.synchronize()
        counts = record_launches(results, keys)
        check_rates(f"throughput {name}", r)
        out[name] = {**r, "launches": {k: v for k, v in counts.items() if v}}
        mbps.update({f"throughput_{name}_{k.split('_')[0]}": r[k] for k in RATE_KEYS})
    frozen, info, mask = polar_code()
    step = make_polar_pipeline(POLAR_N, POLAR_K, frozen, 3.0, decoder="sc", device=DEV)
    key, ids = rng.prng_key(0, DEV), torch.arange(POLAR_CHUNK, device=DEV)
    step(key, ids)
    with tempfile.TemporaryDirectory() as tmp:
        with profile_trace(tmp) as logdir:
            step(key, ids)
        (trace,) = list(logdir.glob("trace_*.json"))
        events = json.loads(trace.read_text())["traceEvents"]
    sc = [e for e in events if e.get("cat") == "kernel" and "sc_decode" in e.get("name", "")]
    if len(sc) != 1:
        raise AssertionError(f"profile_trace of one SC chunk holds {len(sc)} sc_decode kernel "
                             "events, not 1")
    device_events = [e for e in events if e.get("cat") == "kernel"]
    emit("throughput", **out, trace={"events": len(events), "kernel_events": len(device_events),
                                     "sc_decode_events": len(sc),
                                     "sc_decode_us": sc[0].get("dur")})


RUN_BENCHMARK_ARGS = ["--channel", "rayleigh", "--snr-range", "0:6:2", "--batch-size", "4096",
                      "--num-frames", "16384", "--skip-plots"]


def check_curve(what: str, curve: dict, snrs: list) -> None:
    fers = curve["fer"]
    if (curve["snr_db"] != snrs or not all(0.0 <= b < 0.5 for b in curve["ber"])
            or not all(f2 <= f1 for f1, f2 in zip(fers, fers[1:]))):
        raise AssertionError(f"{what}: unexpected curve {curve}")


def phase_run_benchmark(results: dict, mbps: dict) -> None:
    """``cli.run_benchmark`` with the default codes (polar SC N=1024, LDPC
    (504, 252) BP) over Rayleigh at 0, 2, 4, 6 dB, batch 4096, with its
    throughput probes and complexity counts."""
    from polarcode_and_ldpc_tpu_torch.cli import run_benchmark

    out_dir = Path("chiprun_out") / "run_benchmark"
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    res = run_benchmark.main(RUN_BENCHMARK_ARGS + ["--output-dir", str(out_dir)])
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    counts = record_launches(results, ["sc_decode", "bp_decode_bp"])
    for name in ("benchmark_results.json", "data/ber_simulation_results.json",
                 "data/throughput_results.json", "data/complexity_results.json"):
        json.loads((out_dir / name).read_text())
    curves = {f: res["ber_simulation"][f]["self"] for f in ("polar", "ldpc")}
    for family, curve in curves.items():
        check_curve(f"run_benchmark {family}", curve, [0.0, 2.0, 4.0, 6.0])
        check_rates(f"run_benchmark {family} throughput", res["throughput"][family])
        mbps.update({f"run_benchmark_{family}_{k.split('_')[0]}": res["throughput"][family][k]
                     for k in RATE_KEYS})
    emit("run_benchmark", argv=RUN_BENCHMARK_ARGS, seconds=seconds, output_dir=str(out_dir),
         launches={k: v for k, v in counts.items() if v},
         curves={f: {k: c[k] for k in ("snr_db", "ber", "fer", "frames_tested",
                                       "avg_iterations", "throughput_mbps")}
                 for f, c in curves.items()},
         throughput={f: {k: res["throughput"][f][k] for k in RATE_KEYS} for f in curves},
         complexity=res["complexity"])


CODE_PARAMS_ARGS = ["--num-frames", "4096", "--batch-size", "4096"]


def phase_code_params(results: dict, mbps: dict) -> None:
    """``cli.code_params`` at its default lengths and rates (polar SC at N=128
    … 4096, LDPC BP at n=126 … 4032, rates 0.25 … 0.875 at length 1024),
    4096 frames an entry: no entry may record an error unless its code,
    built alone, raises."""
    from polarcode_and_ldpc_tpu_torch.cli import code_params
    from polarcode_and_ldpc_tpu_torch.sim.experiments import build_code

    out_dir = Path("chiprun_out") / "code_params"
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    res = code_params.main(CODE_PARAMS_ARGS + ["--output-dir", str(out_dir)])
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    counts = record_launches(results, ["sc_decode", "bp_decode_bp"])
    entries = {}
    for sweep, fams in res.items():
        for fam, rows in fams.items():
            for e in rows:
                K = int(e["length"] * e["rate"])
                dc = 6 if sweep == "length_tests" else max(
                    4, int(round(3 * e["length"] / (e["length"] - K))))
                try:
                    build_code(fam, e["length"], K, dc=dc, device=DEV)
                    raises = None
                except (ValueError, AssertionError) as x:
                    raises = str(x)
                if ("error" in e) != (raises is not None):
                    raise AssertionError(f"code_params {sweep} {fam}: {e} (built alone: "
                                         f"{raises})")
                if "error" not in e:
                    rate = e.get("decoding_throughput", e.get("throughput_mbps"))
                    if not (0.0 <= e["ber"] < 0.5 and rate > 0):
                        raise AssertionError(f"code_params {sweep} {fam}: unexpected {e}")
                entries[f"{sweep}/{fam}/{e['length']}/{e['rate']}"] = {
                    k: e.get(k) for k in ("ber", "fer", "decoding_throughput",
                                          "throughput_mbps", "decode_ms_per_frame", "error")
                    if k in e}
    emit("code_params", argv=CODE_PARAMS_ARGS, seconds=seconds, output_dir=str(out_dir),
         launches={k: v for k, v in counts.items() if v}, entries=entries)


SC_VS_SCL_QUICK_ARGS: list = []  # the CLI's defaults
SC_VS_SCL_FULL_ARGS = ["--mode", "full", "--N", "1024", "--K", "512", "--use-crc",
                       "--list-sizes", "1,2,4,8", "--snr-range=-2:0:1", "--num-frames",
                       "4096", "--batch-size", "4096", "--skip-plots"]


def phase_sc_vs_scl(results: dict, mbps: dict) -> None:
    """``cli.sc_vs_scl``: quick mode at its defaults (N=128, K=64, L = 1 … 16,
    one list chunk, which the chunk-body kernel decodes), and full mode at
    N=1024, K=512 with CRC-8, L = 1, 2, 4, 8, at −2, −1 and 0 dB (where the
    list sizes differ), with its latency probes."""
    from polarcode_and_ldpc_tpu_torch.cli import sc_vs_scl

    out = {}
    for mode, argv, keys in (
            ("quick", SC_VS_SCL_QUICK_ARGS, ["sc_decode", "scl_chunk_body"]),
            ("full", SC_VS_SCL_FULL_ARGS,
             ["sc_decode", "scl_narrow_prefix", "scl_chunk_step", "scl_last_chunk"])):
        out_dir = Path("chiprun_out") / "sc_vs_scl" / mode
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        res = sc_vs_scl.main(argv + ["--output-dir", str(out_dir)])
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        counts = record_launches(results, keys)
        if mode == "quick":
            fers = {k: v["fer"] for k, v in res.items() if isinstance(v, dict)}
            if set(fers) != {"sc", "scl_1", "scl_2", "scl_4", "scl_8", "scl_16"} or not all(
                    0.0 <= f < 0.5 for f in fers.values()):
                raise AssertionError(f"sc_vs_scl quick: unexpected {res}")
            out[mode] = {"seconds": seconds, "fer": fers,
                         "launches": {k: v for k, v in counts.items() if v}}
            continue
        for name, curve in res["curves"].items():
            check_curve(f"sc_vs_scl {name}", curve, [-2.0, -1.0, 0.0])
        sc_fer, l8_fer = res["curves"]["sc"]["fer"], res["curves"]["scl_8"]["fer"]
        if any(b > a for a, b in zip(sc_fer, l8_fer)) or not all(
                v > 0 for v in res["latency_ms_per_frame"].values()):
            raise AssertionError(f"sc_vs_scl full: unexpected {res['curves']} "
                                 f"{res['latency_ms_per_frame']}")
        out[mode] = {"argv": argv, "seconds": seconds,
                     "fer": {k: v["fer"] for k, v in res["curves"].items()},
                     "latency_ms_per_frame": res["latency_ms_per_frame"],
                     "launches": {k: v for k, v in counts.items() if v}}
    emit("sc_vs_scl", **out)


# -- construction and the twins ---------------------------------------------------------

# the Monte-Carlo construction at JAX's defaults: 10,000 frames in chunks of
# 1024 (10 chunks, 10,240 frames) at a design SNR of 2 dB
MC_DESIGN_SNR_DB = 2.0
MC_FRAMES = 10 * 1024
# card and CPU draw the same uniforms; their float32 log1p / sqrt may differ in
# the last bits, which flips a genie leaf only where it lies within rounding
# of 0: at most one decision in 10^5 may count otherwise
MC_COUNT_SLACK = 1e-5
CONSTRUCTION_SNR_DB = 2.0
CONSTRUCTION_LDPC = ("peg", "gallager")


def mc_construction(N: int, K: int, device) -> dict:
    """The ``"monte_carlo"`` construction through ``construct_polar_code``
    on ``device``, timed (host clock ending in a synchronise), and its error
    counts per u-position from ``monte_carlo_reliabilities``."""
    t0 = time.perf_counter()
    frozen, info = fec.construct_polar_code(N, K, "monte_carlo", MC_DESIGN_SNR_DB,
                                            device=device)
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    pe = monte_carlo_reliabilities(N, MC_DESIGN_SNR_DB, device=device)
    return {"frozen": frozen, "info": info, "seconds": seconds,
            "errors": np.rint(pe * MC_FRAMES).astype(np.int64)}


def phase_construction(results: dict, mbps: dict, quick: bool) -> None:
    """The Monte-Carlo polar construction on the card (N=1024, K=512 and
    N=4096, K=2048 at 2 dB, JAX's defaults) held against the same call on the
    CPU; the polar SC (K1) and CA-SCL-8 (narrow prefix, K3, K4) Monte-Carlo
    paths on the constructed code; the PEG and banded Gallager (504, 252)
    dv=3 codes with their girth, under flooding BP and layered NMS (K2) —
    each path against its plain pipeline on its first chunk and at two chunk
    sizes."""
    mc = mc_construction(POLAR_N, POLAR_K, DEV)
    repeat = mc_construction(POLAR_N, POLAR_K, DEV)["seconds"]
    cpu = mc_construction(POLAR_N, POLAR_K, "cpu")
    diff = np.abs(mc["errors"] - cpu["errors"])
    slack = int(MC_COUNT_SLACK * MC_FRAMES * POLAR_N)
    if not np.array_equal(mc["frozen"], cpu["frozen"]) or int(diff.sum()) > slack:
        raise AssertionError(
            f"Monte-Carlo construction: card and CPU differ (frozen sets equal: "
            f"{np.array_equal(mc['frozen'], cpu['frozen'])}; counts differ at "
            f"{np.nonzero(diff)[0].tolist()} by {int(diff.sum())}, allowed {slack})")
    large = mc_construction(4 * POLAR_N, 2 * POLAR_K, DEV)
    frozen = mc["frozen"]
    mask = frozen_mask_from_positions(POLAR_N, frozen)
    out = {"monte_carlo": {
        "N": POLAR_N, "K": POLAR_K, "design_snr_db": MC_DESIGN_SNR_DB, "frames": MC_FRAMES,
        "seconds_first": mc["seconds"], "seconds_repeat": repeat,
        "seconds_cpu": cpu["seconds"], "seconds_n4096": large["seconds"],
        "frozen_equal_cpu": True, "count_positions_differ_cpu": int((diff > 0).sum()),
        "count_abs_diff_cpu": int(diff.sum()),
        "frozen_differs_from_bhattacharyya": int(np.setxor1d(frozen, polar_code()[0]).size // 2),
        "worst_info_errors": int(mc["errors"][mc["info"]].max())}}

    polar = functools.partial(make_polar_pipeline, POLAR_N, POLAR_K, frozen,
                              CONSTRUCTION_SNR_DB, device=DEV)
    out["polar_sc"] = hold_channel_path(
        "polar SC on the Monte-Carlo code", results, ["sc_decode"], polar(decoder="sc"),
        polar(decoder="sc", sc_impl="unrolled"), None, POLAR_CHUNK,
        (2 if quick else 4) * POLAR_CHUNK, POLAR_K)
    n_narrow = sum(w < SCL_L for w in build_scl_schedule(POLAR_N, mask, SCL_L, SCL_S).lv_in[:-1])
    cascl = functools.partial(polar, decoder="ca-scl", list_size=SCL_L,
                              crc_polynomial=SCL_CRC, scl_chunk=SCL_S)
    out["polar_cascl"] = hold_channel_path(
        "CA-SCL-8 on the Monte-Carlo code", results,
        ["scl_chunk_step", "scl_last_chunk"] + (["scl_narrow_prefix"] if n_narrow else []),
        cascl(), cascl(scl_control_impl="unroll-fused"), None, SCL_CHUNK,
        (2 if quick else 4) * SCL_CHUNK, POLAR_K - 8)
    out["polar_cascl"]["narrow_steps_per_decode"] = n_narrow

    for method in CONSTRUCTION_LDPC:
        t0 = time.perf_counter()
        enc = fec.LDPCEncoder(LDPC_N, LDPC_K, dv=3, dc=6, seed=42, method=method, device=DEV)
        girth = fec.calculate_girth(enc.H)
        code = {"setup_s": time.perf_counter() - t0, "girth": girth, "k": enc.k,
                "row_degrees": sorted({int(d) for d in enc.H.sum(axis=1)})}
        for name, key, kw in (("bp", "bp_decode_bp", dict(decoder="bp")),
                              ("layered_nms", "bp_decode_layered",
                               dict(decoder="nms", normalization=0.75, schedule="layered",
                                    num_layers=LDPC_LAYERS))):
            ldpc = functools.partial(make_ldpc_pipeline, enc.H, enc.G, 3.0, max_iter=LDPC_ITERS,
                                     message_idx=enc.info_positions, device=DEV, **kw)
            code[name] = hold_channel_path(
                f"LDPC {name} on the {method} code", results, [key], ldpc(),
                ldpc(bp_impl="torch"), None, LDPC_CHUNK, (2 if quick else 4) * LDPC_CHUNK,
                enc.k, allowed=LDPC_CHUNK // 1000 if name == "bp" else 0)
            mbps[f"ldpc_{method}_{name}"] = code[name]["info_mbps"]
        out[f"ldpc_{method}"] = code
    mbps["polar_sc_monte_carlo_code"] = out["polar_sc"]["info_mbps"]
    mbps["polar_cascl_monte_carlo_code"] = out["polar_cascl"]["info_mbps"]
    emit("construction", **out)


# the twins: K1 against the SC trellis twin on 4096 frames at 2 dB and on
# integer ties; the default list decode (CA-SCL-8) against the SCL trellis
# twin on 1024 frames; K1, the list kernels and K2 against the float64
# parity twins on 16 frames
TWIN_SNR_DB = 2.0
TWIN_SC_FRAMES, TWIN_SCL_FRAMES, PARITY_FRAMES = 4096, 1024, 16
# float32 metrics of N=1024 summed in other orders (the chunk body's
# adjacent-pair trees against the trellis' leaf-by-leaf sums)
SCL_TWIN_RTOL = 1e-5
PARITY_LDPC_SNR_DB = 1.0


def frames_differ(a: torch.Tensor, b) -> int:
    b = torch.as_tensor(b, device=a.device).to(a.dtype)
    return int((a != b).reshape(a.shape[0], -1).any(dim=1).sum())


def phase_twins(quick: bool) -> None:
    """The kernels against the independent formulations: K1 with its exact
    node program against ``make_sc_decoder(impl="scan")`` (bit for bit;
    the fast program's differing frames are counted), the default list
    decode against ``make_scl_decoder(impl="scan")`` (paths equal, metrics
    within ``SCL_TWIN_RTOL``), and K1, the list kernels and K2 against the
    float64 parity twins on integer LLRs (0 frames may differ; on Gaussian
    LLRs the differing frames are counted)."""
    from polarcode_and_ldpc_tpu_torch.parity import ldpc_np, polar_np

    frozen, info, mask = polar_code()
    enc = fec.PolarEncoder(POLAR_N, POLAR_K, frozen_bits=frozen, device=DEV)
    exact, fast = SCProgram(POLAR_N, mask, fast_nodes=False), SCProgram(POLAR_N, mask)
    ops.reset_launch_counts()
    t0 = time.perf_counter()

    # K1 against the SC trellis twin
    twin_sc = make_sc_decoder(POLAR_N, mask, impl="scan", device=DEV)
    msgs = np.random.default_rng(21).integers(0, 2, (TWIN_SC_FRAMES, POLAR_K))
    ties = torch.from_numpy(np.random.default_rng(22).integers(
        -3, 4, (TWIN_SC_FRAMES, POLAR_N)).astype(np.float32)).to(DEV)
    sc = {}
    for name, llr in ((f"gaussian_{TWIN_SNR_DB:g}db",
                       seeded_llrs(enc.encode(msgs), TWIN_SNR_DB, seed=23)),
                      ("integer_ties", ties)):
        t = time.perf_counter()
        want = twin_sc(llr)
        torch.cuda.synchronize()
        twin_s = time.perf_counter() - t
        sc[name] = {"frames": llr.shape[0], "twin_seconds": twin_s,
                    "twin_info_mbps": llr.shape[0] * POLAR_K / twin_s / 1e6,
                    "exact_frames_differ": frames_differ(sc_decode_cuda(llr, exact), want),
                    "fast_frames_differ": frames_differ(sc_decode_cuda(llr, fast), want)}
        if sc[name]["exact_frames_differ"]:
            raise AssertionError(f"K1 (exact program) differs from the SC trellis twin on "
                                 f"{name}: {sc[name]}")

    # the default list decode against the SCL trellis twin
    scl = make_scl_decoder(POLAR_N, mask, SCL_L, chunk=SCL_S, device=DEV)
    twin_scl = make_scl_decoder(POLAR_N, mask, SCL_L, impl="scan", device=DEV)
    llr = cascl_llrs(frozen, TWIN_SCL_FRAMES, TWIN_SNR_DB, seed=24)
    u, pm = scl(llr)
    t = time.perf_counter()
    wu, wpm = twin_scl(llr)
    torch.cuda.synchronize()
    twin_s = time.perf_counter() - t
    fin = torch.isfinite(wpm)
    rel = float(((pm - wpm).abs() / wpm.abs().clamp_min(1.0))[fin].max())
    scl_case = {"frames": TWIN_SCL_FRAMES, "list_size": SCL_L, "twin_seconds": twin_s,
                "twin_info_mbps": TWIN_SCL_FRAMES * POLAR_K / twin_s / 1e6,
                "paths_frames_differ": frames_differ(u, wu), "metric_max_rel_diff": rel,
                "metric_rtol": SCL_TWIN_RTOL,
                "phantoms_equal": bool(torch.equal(fin, torch.isfinite(pm)))}
    if scl_case["paths_frames_differ"] or not scl_case["phantoms_equal"] or rel > SCL_TWIN_RTOL:
        raise AssertionError(f"the list decode differs from the SCL trellis twin: {scl_case}")

    # K1, the list kernels and K2 against the float64 parity twins
    parity = {}
    pmsgs = np.random.default_rng(25).integers(0, 2, (PARITY_FRAMES, POLAR_K))
    gauss = seeded_llrs(enc.encode(pmsgs), TWIN_SNR_DB, seed=26)
    for name, llr in (("integer", torch.round(gauss)), ("gaussian", gauss)):
        x = llr.double().cpu().numpy()
        sc_want = np.stack([polar_np.sc_decode_np(r, mask) for r in x])
        scl_want = np.stack([polar_np.scl_decode_np(r, mask, SCL_L)[2] for r in x])
        parity[name] = {"frames": PARITY_FRAMES,
                        "k1_exact": frames_differ(sc_decode_cuda(llr, exact), sc_want),
                        "k1_fast": frames_differ(sc_decode_cuda(llr, fast), sc_want),
                        "list_paths": frames_differ(scl(llr)[0], scl_want)}
    genc = fec.LDPCEncoder(LDPC_N, LDPC_K, dv=3, dc=6, seed=42, method="gallager", device=DEV)
    cw = genc.encode(np.random.default_rng(27).integers(0, 2, (PARITY_FRAMES, genc.k)))
    gauss = seeded_llrs(cw, PARITY_LDPC_SNR_DB, seed=28)
    H = genc.H
    # min-sum without scaling, with offset 0.5 and layered are exact on integer
    # LLRs in float32; sum-product (tanh) and NMS 0.75 are counted only
    rules = {"ms": (fec.MSDecoder(H, LDPC_ITERS, device=DEV),
                    lambda r: ldpc_np.ms_decode_np(H, r, LDPC_ITERS)),
             "oms_0.5": (fec.OMSDecoder(H, LDPC_ITERS, offset=0.5, device=DEV),
                         lambda r: ldpc_np.ms_decode_np(H, r, LDPC_ITERS, 1.0, 0.5)),
             "layered_ms": (fec.LayeredMSDecoder(H, LDPC_ITERS, num_layers=LDPC_LAYERS,
                                                 device=DEV),
                            lambda r: ldpc_np.layered_ms_decode_np(H, r, LDPC_ITERS, 1.0, 0.0,
                                                                   True, LDPC_LAYERS)),
             "bp": (fec.BPDecoder(H, LDPC_ITERS, device=DEV),
                    lambda r: ldpc_np.bp_decode_np(H, r, LDPC_ITERS)),
             "nms_0.75": (fec.NMSDecoder(H, LDPC_ITERS, 0.75, device=DEV),
                          lambda r: ldpc_np.ms_decode_np(H, r, LDPC_ITERS, 0.75))}
    for name, llr in (("integer", torch.round(gauss)), ("gaussian", gauss)):
        x = llr.double().cpu().numpy()
        for rule, (dec, twin) in rules.items():
            bits, iters = dec.decode(llr, return_iterations=True)
            want = [twin(r) for r in x]
            bad = [i for i, (b, it) in enumerate(want)
                   if not (np.array_equal(bits[i].cpu().numpy(), b) and int(iters[i]) == it)]
            parity[name][f"k2_{rule}"] = len(bad)
    exact_rules = ("k1_exact", "list_paths", "k2_ms", "k2_oms_0.5", "k2_layered_ms")
    if any(parity["integer"][k] for k in exact_rules):
        raise AssertionError(f"kernels differ from the float64 parity twins on integer "
                             f"LLRs: {parity}")
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    counts = record_launches({}, ["sc_decode", "scl_chunk_step", "scl_last_chunk",
                                  "bp_decode_ms", "bp_decode_layered", "bp_decode_bp"])
    emit("twins", seconds=seconds, launches={k: v for k, v in counts.items() if v},
         sc_trellis=sc, scl_trellis=scl_case,
         parity={"frames_differ": parity, "held_to_zero_on_integer": list(exact_rules),
                 "ldpc_code": "gallager (504, 252) seed 42", "ldpc_snr_db": PARITY_LDPC_SNR_DB,
                 "polar_snr_db": TWIN_SNR_DB})


def phase_ldpc_mc(results: dict, mbps: dict, frames: int) -> None:
    enc = ldpc_code()
    summary = {}
    for name, key, kw in (("bp", "bp_decode_bp", {}),
                          ("nms", "bp_decode_ms", {"normalization": 0.75})):
        step = make_ldpc_pipeline(enc.H, enc.G, 3.0, decoder=name, max_iter=LDPC_ITERS,
                                  message_idx=enc.info_positions, device=DEV, **kw)
        sim = MonteCarloSimulator(step, LDPC_K, chunk_frames=LDPC_CHUNK)
        sim.run(LDPC_CHUNK, seed=1)  # warm-up
        ops.reset_launch_counts()
        res = sim.run(frames, max_errors=None, seed=0)
        counts = record_launches(results, [key])
        if res.frames != frames or not (res.ber < 1e-3) or not (1.0 <= res.avg_iterations <= LDPC_ITERS):
            raise AssertionError(f"LDPC {name} at 3 dB: unexpected result {res.to_dict()}")
        plain = make_ldpc_pipeline(enc.H, enc.G, 3.0, decoder=name, max_iter=LDPC_ITERS,
                                   message_idx=enc.info_positions, bp_impl="torch",
                                   device=DEV, **kw)
        rk = rng.prng_key(0, DEV)
        ids = torch.arange(LDPC_CHUNK, device=DEV)
        a, b = step(rk, ids), plain(rk, ids)
        differ = int(((a["bit_errors"] != b["bit_errors"]) | (a["iterations"] != b["iterations"])).sum())
        allowed = 0 if name == "nms" else LDPC_CHUNK // 1000
        if differ > allowed:
            raise AssertionError(f"LDPC {name}: kernel and plain pipelines differ on {differ} frames")
        summary[name] = {**result_fields(res), "mean_iterations": res.avg_iterations,
                         "launches": counts, "first_chunk_frames_differ_from_plain": differ}
        mbps[f"ldpc_{name}"] = res.throughput_mbps
    emit("ldpc_mc", chunk_frames=LDPC_CHUNK, max_iter=LDPC_ITERS, **summary)


def phase_ldpc_layered_mc(results: dict, mbps: dict, frames: int) -> None:
    """The row-layered min-sum path at full width, with flooding NMS beside it."""
    enc = ldpc_code()
    kw = dict(decoder="nms", normalization=0.75, max_iter=LDPC_ITERS,
              message_idx=enc.info_positions, device=DEV)
    step = make_ldpc_pipeline(enc.H, enc.G, 3.0, schedule="layered", num_layers=LDPC_LAYERS, **kw)
    sim = MonteCarloSimulator(step, LDPC_K, chunk_frames=LDPC_CHUNK)
    sim.run(LDPC_CHUNK, seed=1)  # warm-up
    ops.reset_launch_counts()
    res = sim.run(frames, max_errors=None, seed=0)
    counts = record_launches(results, ["bp_decode_layered"])
    if counts["bp_decode_layered"] != frames // LDPC_CHUNK or counts["bp_decode_ms"]:
        raise AssertionError(f"layered LDPC: {frames // LDPC_CHUNK} chunks launched {counts}")
    flood_sim = MonteCarloSimulator(make_ldpc_pipeline(enc.H, enc.G, 3.0, **kw), LDPC_K,
                                    chunk_frames=LDPC_CHUNK)
    flood_sim.run(LDPC_CHUNK, seed=1)
    flood = flood_sim.run(frames, max_errors=None, seed=0)
    if res.frames != frames or not (res.ber < 1e-3):
        raise AssertionError(f"layered LDPC at 3 dB: unexpected result {res.to_dict()}")
    if not (1.0 <= res.avg_iterations < 0.9 * flood.avg_iterations):
        raise AssertionError(f"layered min-sum ran {res.avg_iterations} iterations on average, "
                             f"flooding {flood.avg_iterations}: expected clearly fewer")
    plain = make_ldpc_pipeline(enc.H, enc.G, 3.0, schedule="layered", num_layers=LDPC_LAYERS,
                               bp_impl="torch", **kw)
    rk = rng.prng_key(0, DEV)
    ids = torch.arange(LDPC_CHUNK, device=DEV)
    a, b = step(rk, ids), plain(rk, ids)
    differ = int(((a["bit_errors"] != b["bit_errors"]) | (a["iterations"] != b["iterations"])).sum())
    if differ:
        raise AssertionError(f"layered LDPC: kernel and plain pipelines differ on {differ} frames")
    emit("ldpc_layered_mc", chunk_frames=LDPC_CHUNK, max_iter=LDPC_ITERS, num_layers=LDPC_LAYERS,
         layered={**result_fields(res), "mean_iterations": res.avg_iterations, "launches": counts,
                  "first_chunk_frames_differ_from_plain": differ},
         flooding={**result_fields(flood), "mean_iterations": flood.avg_iterations})
    mbps["ldpc_layered_nms"] = res.throughput_mbps


def pipelines_agree_where_frames_fail(what: str, make, plain_options: dict,
                                      snr_db: float = -3.0, frames: int = 256) -> dict:
    """The kernel pipeline ``make(snr)`` against the plain one
    ``make(snr, **plain_options)`` on the same frame ids and seed, at an SNR
    where frames fail (Es/N0 -3 dB lies below the rate-1/2 capacity, -2.8
    dB): each frame's bit errors must agree, and some frame must fail (at 3
    dB both decode error-free and agree trivially)."""
    key = rng.prng_key(0, DEV)
    ids = torch.arange(frames, device=DEV)
    a = make(snr_db)(key, ids)
    b = make(snr_db, **plain_options)(key, ids)
    failed = int(a["frame_error"].sum())
    if not (torch.equal(a["bit_errors"], b["bit_errors"])
            and torch.equal(a["frame_error"], b["frame_error"])) or failed == 0:
        raise AssertionError(f"{what} at {snr_db} dB: kernel and plain pipelines disagree "
                             f"or no frame failed ({failed} of {frames})")
    return {"snr_db": snr_db, "frames": frames, "failed_frames": failed,
            "bit_errors": int(a["bit_errors"].sum())}


def phase_polar_large_mc(results: dict, mbps: dict, frames: int) -> None:
    """The large-code list path at full width: N=4096, K=2048, SCL-32, chunk
    64 (63 chunk steps per decode: the first eight narrow at the live path
    count, in one narrow-prefix launch, then 55 chunk-step launches; and one
    last-chunk launch), 3 dB: it must decode error-free."""
    N, K, S, L, B = LARGE_SCL_N, LARGE_SCL_K, LARGE_SCL_S, LARGE_SCL_L, LARGE_SCL_CHUNK
    frozen, _, mask = polar_code(N, K)
    sched = build_scl_schedule(N, mask, L, S)
    n_narrow = sum(w < L for w in sched.lv_in[:-1])
    kw = dict(decoder="scl", list_size=L, scl_chunk=S, device=DEV)
    step = make_polar_pipeline(N, K, frozen, 3.0, **kw)
    sim = MonteCarloSimulator(step, K, chunk_frames=B)
    sim.run(B, seed=1)  # warm-up
    ops.reset_launch_counts()
    res = sim.run(frames, max_errors=None, seed=0)
    counts = record_launches(results, ["scl_narrow_prefix", "scl_chunk_step",
                                       "scl_last_chunk"])
    mc_chunks = frames // B
    want = {"scl_narrow_prefix": prefix_launches(n_narrow) * mc_chunks,
            "scl_chunk_step": (sched.C - 1 - n_narrow) * mc_chunks,
            "scl_last_chunk": mc_chunks, "scl_chunk_step_devmem": 0, "scl_chunk_body": 0}
    if any(counts[k] != v for k, v in want.items()):
        raise AssertionError(f"N=4096 SCL-32: {mc_chunks} Monte-Carlo chunks launched {counts}")
    if res.frames != frames or res.frame_errors != 0:
        raise AssertionError(f"N=4096 SCL-32 at 3 dB is not error-free: {res.to_dict()}")
    # the kernel path against the plain pipeline (plain live-width control) on
    # the same frame ids and seed, where frames fail
    failing = pipelines_agree_where_frames_fail(
        f"N={N} SCL-{L}", lambda snr, **o: make_polar_pipeline(N, K, frozen, snr, **kw, **o),
        dict(scl_control_impl="unroll-fused"))
    emit("polar_large_mc", **result_fields(res), code=[N, K], list_size=L, scl_chunk=S,
         chunk_frames=B, launches={k: counts[k] for k in want},
         narrow_steps_per_decode=n_narrow, narrow_launches_per_decode=prefix_launches(n_narrow),
         equal_plain_at_failing_snr=failing)
    mbps["polar_scl32_n4096"] = res.throughput_mbps


def phase_polar_sc_large_mc(results: dict, mbps: dict, frames: int) -> None:
    """SC at N=32768, K=16384 through the hybrid mode: two subtree launches
    per chunk, the top level in plain torch; 3 dB: error-free."""
    N, K, B = LARGE_SC_N, LARGE_SC_K, LARGE_SC_CHUNK
    frozen, _, _ = polar_code(N, K)
    step = make_polar_pipeline(N, K, frozen, 3.0, decoder="sc", device=DEV)
    sim = MonteCarloSimulator(step, K, chunk_frames=B)
    sim.run(B, seed=1)  # warm-up
    ops.reset_launch_counts()
    res = sim.run(frames, max_errors=None, seed=0)
    counts = record_launches(results, ["sc_decode_sub"])
    mc_chunks = frames // B
    if (counts["sc_decode_sub"], counts["sc_decode"]) != (2 * mc_chunks, 0):
        raise AssertionError(f"SC N={N}: {mc_chunks} Monte-Carlo chunks launched {counts}")
    if res.frames != frames or res.frame_errors != 0:
        raise AssertionError(f"SC N={N} at 3 dB is not error-free: {res.to_dict()}")
    failing = pipelines_agree_where_frames_fail(
        f"SC N={N}", lambda snr, **o: make_polar_pipeline(N, K, frozen, snr, decoder="sc",
                                                          device=DEV, **o),
        dict(sc_impl="unrolled"))
    emit("polar_sc_large_mc", **result_fields(res), code=[N, K], chunk_frames=B,
         launches={k: counts[k] for k in ("sc_decode_sub", "sc_decode")},
         equal_plain_at_failing_snr=failing)
    mbps["polar_sc_n32768"] = res.throughput_mbps


def phase_ldpc_large_mc(results: dict, mbps: dict, frames: int) -> None:
    """The default-construction (MacKay) (8192, 4096) code: flooding BP and
    NMS and layered NMS, every frame in one block's shared memory; the
    encoder's GF(2) set-up is host set-up, outside the rate."""
    code = large_ldpc_code()
    enc = code["enc"]
    B = LARGE_LDPC_CHUNK
    summary = {"setup_s": code["setup_s"], "dc_max": code["graph"].dc_max}
    for name, key, kw in (("bp", "bp_decode_bp_large", {}),
                          ("nms", "bp_decode_ms_large", {"normalization": 0.75}),
                          ("layered_nms", "bp_decode_layered_large",
                           {"normalization": 0.75, "schedule": "layered",
                            "num_layers": LDPC_LAYERS})):
        kw = dict(decoder="bp" if name == "bp" else "nms", max_iter=LDPC_ITERS,
                  message_idx=enc.info_positions, device=DEV, **kw)
        step = make_ldpc_pipeline(enc.H, enc.G, 3.0, **kw)
        sim = MonteCarloSimulator(step, LARGE_LDPC_K, chunk_frames=B)
        sim.run(B, seed=1)  # warm-up
        rule, alpha, schedule = LARGE_BP_ROWS[key]
        plan = BPKernelPlan(code["graph"], LDPC_ITERS, True, rule, alpha, 0.0, schedule,
                            LDPC_LAYERS)
        counter = bp_counter(plan)
        ops.reset_launch_counts()
        res = sim.run(frames, max_errors=None, seed=0)
        counts = ops.launch_counts()
        if counts[counter] != frames // B or plan.device_memory or any(
                v for k, v in counts.items() if k.startswith("bp_") and k != counter):
            raise AssertionError(f"MacKay n=8192 {name}: launched {counts}")
        if key in results:
            results[key]["launches"] += counts[counter]
        if res.frames != frames or res.frame_errors != 0:
            raise AssertionError(f"MacKay n=8192 {name} at 3 dB: {res.to_dict()}")
        plain = make_ldpc_pipeline(enc.H, enc.G, 3.0, bp_impl="torch", **kw)
        rk = rng.prng_key(0, DEV)
        ids = torch.arange(B, device=DEV)
        a, b = step(rk, ids), plain(rk, ids)
        differ = int(((a["bit_errors"] != b["bit_errors"])
                      | (a["iterations"] != b["iterations"])).sum())
        if differ > (B // 1000 if name == "bp" else 0):
            raise AssertionError(f"MacKay n=8192 {name}: kernel and plain differ on {differ}")
        summary[name] = {**result_fields(res), "mean_iterations": res.avg_iterations,
                         "launches": {counter: counts[counter]},
                         "first_chunk_frames_differ_from_plain": differ}
        mbps[f"ldpc_mackay8192_{name}"] = res.throughput_mbps
    emit("ldpc_large_mc", code=[LARGE_LDPC_N, LARGE_LDPC_K], construction="mackay seed 42",
         chunk_frames=B, max_iter=LDPC_ITERS, **summary)


@functools.cache
def qc_code():
    """The quasi-cyclic n=8192 code: shift matrix, expanded H and an encoder;
    built once per run (host set-up)."""
    base = fec.qc_base_matrix(QC_N, QC_K, QC_Z, dv=3, dc=6, seed=42)
    return qc_code_from_numpy(base, QC_Z, device=DEV)


QC_DECODERS = {"bp": dict(decoder="bp"),
               "layered_nms": dict(decoder="nms", normalization=0.75, schedule="layered")}


def qc_pipeline(code: dict, snr_db: float, name: str):
    enc = code["encoder"]
    return make_ldpc_pipeline(code["H"], enc.G, snr_db, max_iter=LDPC_ITERS,
                              message_idx=enc.info_positions, qc_base=code["qc_base"],
                              z=code["z"], device=DEV, **QC_DECODERS[name])


def phase_ldpc_qc_mc(results: dict, mbps: dict, chunks: int) -> None:
    """The quasi-cyclic path at n=8192: flooding BP and layered NMS through the
    roll-based decoder (plain PyTorch on the card, as its JAX counterpart is
    plain XLA), and the roll path against the generic decoders on the
    expanded H (the layered one through the fused kernel)."""
    t0 = time.perf_counter()
    code = qc_code()
    enc = code["encoder"]
    build_s = time.perf_counter() - t0
    summary = {}
    for name in QC_DECODERS:
        sim = MonteCarloSimulator(qc_pipeline(code, 3.0, name), QC_K, chunk_frames=QC_CHUNK)
        sim.run(QC_CHUNK, seed=1)  # warm-up
        res = sim.run(chunks * QC_CHUNK, max_errors=None, seed=0)
        if res.frames != chunks * QC_CHUNK or res.frame_errors or not (
                1.0 <= res.avg_iterations <= LDPC_ITERS):
            raise AssertionError(f"QC {name} at 3 dB: unexpected result {res.to_dict()}")
        low = MonteCarloSimulator(qc_pipeline(code, QC_LOW_SNR_DB, name), QC_K,
                                  chunk_frames=QC_CHUNK).run(QC_CHUNK, max_errors=None, seed=0)
        if low.frame_errors == 0:
            raise AssertionError(f"QC {name} at {QC_LOW_SNR_DB} dB saw no error: {low.to_dict()}")
        summary[name] = {**result_fields(res), "mean_iterations": res.avg_iterations,
                         "low_snr": {"snr_db": QC_LOW_SNR_DB, **result_fields(low),
                                     "mean_iterations": low.avg_iterations}}
        mbps[f"ldpc_qc_{name}"] = res.throughput_mbps

    # the roll path against the generic decoders on the expanded H, 256 frames
    # (half at 3 dB, half where the code errs): bits and iteration counts equal
    msgs = np.random.default_rng(31).integers(0, 2, (256, QC_K))
    cw = enc.encode(msgs)
    llr = torch.cat([seeded_llrs(cw[:128], 3.0, seed=32),
                     seeded_llrs(cw[128:], QC_LOW_SNR_DB, seed=33)])
    ops.reset_launch_counts()
    generic = {
        "bp": fec.BPDecoder(code["H"], LDPC_ITERS, impl="torch", device=DEV),
        "layered_nms": fec.LayeredMSDecoder(code["H"], LDPC_ITERS, normalization=0.75,
                                            num_layers=code["qc_base"].shape[0], device=DEV),
    }
    if generic["layered_nms"].impl != "cuda":
        raise AssertionError("the generic layered decoder did not take the kernel")
    layered_plan = generic["layered_nms"]._run_fn.plan
    against = {}
    for name, dec in generic.items():
        qc = fec.QCBPDecoder(code["qc_base"], QC_Z, LDPC_ITERS,
                             variant="bp" if name == "bp" else "nms", normalization=0.75,
                             schedule="layered" if name == "layered_nms" else "flooding",
                             device=DEV)
        qb, qi = qc.decode(llr, return_iterations=True)
        gb, gi = dec.decode(llr, return_iterations=True)
        torch.cuda.synchronize()
        differ = int(((qb != gb).any(dim=1) | (qi != gi)).sum())
        # sum-product goes through tanh / log1p in both: the same float program,
        # so equal as well; min-sum is exact
        if differ:
            raise AssertionError(f"QC {name}: roll path and generic decoder differ on {differ} "
                                 "of 256 frames")
        against[name] = {"frames": 256, "frames_differ": differ,
                         "mean_iterations": float(qi.float().mean()),
                         "message_frames_right": int((qb[:, enc._info_idx] == torch.as_tensor(
                             msgs, device=DEV)).all(dim=1).sum())}
    counts = ops.launch_counts()
    if counts["bp_decode_layered"] != 1:
        raise AssertionError(f"the generic layered decoder at n=8192 launched {counts}")
    emit("ldpc_qc_mc", n=QC_N, k=QC_K, z=QC_Z, chunk_frames=QC_CHUNK, max_iter=LDPC_ITERS,
         code_build_seconds=round(build_s, 2), **summary, roll_path_against_generic=against,
         generic_layered_kernel_smem_bytes=layered_plan.smem_bytes)


def phase_serving(results: dict, mbps: dict, reps: int, node_mode: str = "exact") -> None:
    """The serving decoder at full width: ``AdaptiveCASCLDecoder`` on batches of
    8192 frames at three operating points, once with the default list control
    and once with the one-launch control (``node_mode="exact"``; the fast list
    nodes run on the default control alone).  The output must equal, frame for
    frame, the SC result where its CRC passes and the CA-SCL result elsewhere,
    and the stats must equal those counts.  The reference is built from the
    plain versions, and the kernels are first held against them at the shapes
    this path gives them: the SC kernel on the whole batch, the list kernels on
    each slice of failing rows."""
    fast = node_mode == "fast"
    suffix = "_fast" if fast else ""
    frozen, info, mask = polar_code()
    k_msg = POLAR_K - 8
    enc = fec.PolarEncoder(POLAR_N, POLAR_K, frozen_bits=frozen, use_crc=True,
                           crc_polynomial=SCL_CRC, device=DEV)
    info_idx = torch.as_tensor(info, dtype=torch.int64, device=DEV)
    sc = {"kernel": make_sc_decoder(POLAR_N, mask, device=DEV),
          "plain": make_sc_decoder(POLAR_N, mask, impl="unrolled", device=DEV)}
    lists = {"plain": make_scl_decoder(POLAR_N, mask, SCL_L, control_impl="unroll-fused",
                                       live_width=False, node_mode=node_mode, device=DEV),
             "unroll-kernel": make_scl_decoder(POLAR_N, mask, SCL_L, node_mode=node_mode,
                                               device=DEV)}
    if not fast:
        lists["mega"] = make_scl_decoder(POLAR_N, mask, SCL_L, control_impl="mega", device=DEV)
    if (sc["kernel"].impl, lists["unroll-kernel"].control_impl) != ("mega", "unroll-kernel"):
        raise AssertionError("serving: the default decoders on the card are not the kernels")
    crc = CRCCodec(k_msg, SCL_CRC, DEV)
    decoders = {"unroll-kernel": fec.AdaptiveCASCLDecoder(
                    POLAR_N, POLAR_K, SCL_L, frozen_bits=frozen, crc_polynomial=SCL_CRC,
                    scl_node_mode=node_mode, device=DEV)}
    if not fast:
        decoders["mega"] = fec.AdaptiveCASCLDecoder(
            POLAR_N, POLAR_K, SCL_L, frozen_bits=frozen, crc_polynomial=SCL_CRC,
            scl_control_impl="mega", device=DEV)
    for name, dec in decoders.items():
        if (dec.sc_impl, dec.scl_control_impl) != ("mega", name):
            raise AssertionError(f"serving decoder took {dec.sc_impl}, {dec.scl_control_impl}")
    budget = decoders["unroll-kernel"]._budget(SERVE_BATCH)
    out = {}
    for point, snr in SERVE_SNRS_DB.items():
        msgs = np.random.default_rng(int(10 * snr) + 40).integers(0, 2, (SERVE_BATCH, k_msg))
        llr = fec.AWGNChannel(snr, seed=int(10 * snr) + 41, device=DEV).transmit(
            enc.encode(msgs)).contiguous()
        u_sc = sc["plain"](llr)
        hold_equal("serving sc_decode", {"u": (sc["kernel"](llr), u_sc)},
                   {"B": SERVE_BATCH, "snr_db": snr})
        sc_info = u_sc[:, info_idx]
        ok = crc.check(sc_info)
        want = sc_info.clone()
        fail = torch.nonzero(~ok)[:, 0]
        # the slices of failing rows as the decoder cuts them: the budget first,
        # then the residue in fallback_batch pieces
        fb = decoders["unroll-kernel"].fallback_batch
        cuts = [0, min(len(fail), budget)] + list(range(budget + fb, len(fail), fb)) + [len(fail)]
        slice_frames = []
        for lo, hi in zip(cuts, cuts[1:]):
            if hi <= lo:
                continue
            rows = fail[lo:hi]
            u0, m0 = lists["plain"](llr[rows])
            for name in decoders:
                u, m = lists[name](llr[rows])
                hold_equal(f"serving list decode [{name}]", {"u": (u, u0), "metrics": (m, m0)},
                           {"frames": hi - lo, "snr_db": snr})
            want[rows] = select_best_path(u0[..., info_idx], m0, crc)
            slice_frames.append(hi - lo)
        n_fail = int((~ok).sum())
        right = {"no_fallback": n_fail == 0, "some_fallback": 0 < n_fail <= budget,
                 "budget_overflow": n_fail > budget}[point]
        if not right:
            raise AssertionError(f"serving point {point} at {snr} dB: {n_fail} SC failures in "
                                 f"{SERVE_BATCH} frames, budget {budget}")
        row = {"snr_db": snr, "sc_failures": n_fail, "budget": budget,
               "list_decode_frames": slice_frames, "kernels_equal_plain": True,
               "sc_decode_ms": time_ms(lambda: sc["kernel"](llr), reps)}
        for name, dec in decoders.items():
            ops.reset_launch_counts()
            got, stats = dec.decode(llr, return_stats=True)
            torch.cuda.synchronize()
            keys = ["sc_decode"]
            if n_fail:
                keys += (["scl_decode_mega"] if name == "mega" else
                         ["scl_chunk_step" + suffix, "scl_last_chunk" + suffix])
            counts = record_launches(results, keys)
            list_decodes = 0 if n_fail == 0 else 1 + -(-max(n_fail - budget, 0) // dec.fallback_batch)
            launched = (counts["scl_decode_mega"] if name == "mega"
                        else counts["scl_last_chunk" + suffix])
            if counts["sc_decode"] != 1 or launched != list_decodes:
                raise AssertionError(f"serving [{name}] at {snr} dB launched {counts}, expected "
                                     f"1 SC decode and {list_decodes} list decodes")
            if not torch.equal(got, want):
                bad = int((got != want).any(dim=1).sum())
                raise AssertionError(f"serving [{name}] at {snr} dB: {bad} frames differ from "
                                     "SC-where-CRC-passes-else-CA-SCL")
            expect = {"frames": SERVE_BATCH, "sc_passed": SERVE_BATCH - n_fail,
                      "scl_fallbacks": n_fail, "budget_overflow": max(n_fail - budget, 0),
                      "sc_pass_rate": 1.0 - n_fail / SERVE_BATCH}
            if stats != expect:
                raise AssertionError(f"serving [{name}] stats {stats}, expected {expect}")
            # CUDA events around decode; the one host read of a batch is inside
            ms = time_ms(lambda: dec.decode(llr), reps)
            row[name] = {"ms_per_batch": ms, "info_mbps": SERVE_BATCH * k_msg / ms / 1e3,
                         "launches": {k: v for k, v in counts.items() if v},
                         "message_frame_errors": int((got[:, :k_msg] != torch.as_tensor(
                             msgs, device=DEV)).any(dim=1).sum())}
            mbps[f"serving{suffix}_{point}_{name}"] = row[name]["info_mbps"]
        row.update(sc_pass_rate=1.0 - n_fail / SERVE_BATCH, scl_fallbacks=n_fail,
                   budget_overflow=max(n_fail - budget, 0), equals_sc_else_cascl=True)
        out[point] = row
    emit("serving" + suffix, batch_frames=SERVE_BATCH, N=POLAR_N, K=POLAR_K, list_size=SCL_L,
         crc=SCL_CRC, node_mode=node_mode, fallback_batch=decoders["unroll-kernel"].fallback_batch,
         **out)


# the sharded Monte-Carlo paths: polar SC (K1), CA-SCL-8 at the flagship
# (narrow prefix, K3, K4) and LDPC BP at n=504 (K2), each at a low SNR with a
# max_errors that the run crosses in its second chunk; the QC n=8192 decode
# and the polar transform with the code axis sharded; weak scaling of the SC
# step at one chunk a device
SHARDED_RANKS = 2
SHARDED_KEYS = ["sc_decode", "scl_narrow_prefix", "scl_chunk_step", "scl_last_chunk",
                "bp_decode_bp"]
SHARDED_QC_FRAMES, SHARDED_TRANSFORM_FRAMES = 1024, 4096
SHARDED_TIMEOUT_S = 300
# the settings a child rank takes from its parent
SHARDED_SETTINGS = ("DEV", "POLAR_CHUNK", "SCL_CHUNK", "LDPC_CHUNK", "SHARDED_QC_FRAMES",
                    "SHARDED_TRANSFORM_FRAMES")


def sharded_paths(dev) -> dict:
    """name → (step, message bits, chunk frames, run keywords): four chunks,
    and an early stop that crosses (the errors a chunk makes at these SNRs:
    FER ≈ 0.15, 0.31, 0.15)."""
    frozen, info, mask = polar_code()
    enc = fec.LDPCEncoder(LDPC_N, LDPC_K, dv=3, dc=6, seed=42, device=dev)
    return {
        "polar_sc": (make_polar_pipeline(POLAR_N, POLAR_K, frozen, LOW_SNR_DB, decoder="sc",
                                         device=dev), POLAR_K, POLAR_CHUNK,
                     dict(num_frames=4 * POLAR_CHUNK, max_errors=POLAR_CHUNK // 5, seed=0)),
        "polar_cascl": (make_polar_pipeline(POLAR_N, POLAR_K, frozen, SCL_LOW_SNR_DB,
                                            decoder="ca-scl", list_size=SCL_L,
                                            crc_polynomial=SCL_CRC, scl_chunk=SCL_S,
                                            device=dev), POLAR_K - 8, SCL_CHUNK,
                        dict(num_frames=4 * SCL_CHUNK, max_errors=SCL_CHUNK * 9 // 20,
                             seed=0)),
        "ldpc_bp": (make_ldpc_pipeline(enc.H, enc.G, LOW_SNR_DB, decoder="bp",
                                       max_iter=LDPC_ITERS, message_idx=enc.info_positions,
                                       device=dev), LDPC_K, LDPC_CHUNK,
                    dict(num_frames=4 * LDPC_CHUNK, max_errors=LDPC_CHUNK // 5, seed=0)),
    }


def run_sharded_paths(paths: dict, mesh) -> dict:
    """Counters of each path, per frame and scalar (both with the early stop)."""
    out = {}
    for name, (step, k, chunk, run_kw) in paths.items():
        for reduction in ("per_frame", "scalar"):
            res = MonteCarloSimulator(step, k, chunk_frames=chunk, mesh=mesh,
                                      reduction=reduction).run(**run_kw)
            out[f"{name}/{reduction}"] = [res.frames, res.bit_errors, res.frame_errors,
                                          res.total_iterations, res.elapsed_seconds]
    return out


def qc_sharding_inputs(dev):
    """The QC n=8192 shift matrix and all-zero codeword LLRs at QC_LOW_SNR_DB."""
    base = fec.qc_base_matrix(QC_N, QC_K, QC_Z, dv=3, dc=6, seed=42)
    sigma = awgn_noise_std(QC_LOW_SNR_DB)
    noise = np.random.default_rng(31).standard_normal((SHARDED_QC_FRAMES, QC_N))
    llr = torch.from_numpy((2.0 * (1.0 + sigma * noise) / sigma ** 2).astype(np.float32))
    return base, llr.to(dev)


def sharded_child(out_path: str, settings: dict) -> None:
    """One rank of a local group (the environment torchrun gives), with the
    parent's ``settings``: joins the group as the CLIs do (gloo where the
    ranks share a card), runs the sharded paths, the code-sharded QC decode
    and polar transform, and the weak scaling, and writes its results and
    kernel launches as JSON."""
    import argparse as _argparse

    import torch.distributed as dist

    from polarcode_and_ldpc_tpu_torch.cli._common import join_group
    from polarcode_and_ldpc_tpu_torch.models.ldpc.qc import make_qc_bp_decoder
    from polarcode_and_ldpc_tpu_torch.parallel import (code_sharded_decode,
                                                       code_sharded_polar_transform,
                                                       default_mesh, mesh_2d)
    from polarcode_and_ldpc_tpu_torch.sim import measure_scaling

    globals().update(settings)
    args = _argparse.Namespace(device=DEV, mesh=False)
    join_group(args)
    dev = torch.device(args.device)
    out = {"device": str(dev), "backend": dist.get_backend(),
           "device_name": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"}
    paths = sharded_paths(dev)
    mesh = default_mesh(device=dev)
    run_sharded_paths(paths, mesh)  # warm-up: first use of every op on the card
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    out["mc"] = run_sharded_paths(paths, mesh)
    sync(dev)
    out["mc_seconds"] = time.perf_counter() - t0
    out["launches"] = ops.launch_counts()

    base, llr = qc_sharding_inputs(dev)
    dec = make_qc_bp_decoder(base, QC_Z, max_iter=LDPC_ITERS, device=dev)
    want_bits, want_iters = dec(llr)
    out["qc"] = {}
    for shape in ((1, SHARDED_RANKS), (SHARDED_RANKS, 1)):
        m2 = mesh_2d(*shape, device=dev)
        bits, iters = code_sharded_decode(dec, m2)(llr)
        f, c = m2.get_coordinate()
        rows = slice(f * llr.shape[0] // shape[0], (f + 1) * llr.shape[0] // shape[0])
        cols = slice(c * QC_N // shape[1], (c + 1) * QC_N // shape[1])
        out["qc"][f"{shape[0]}x{shape[1]}"] = {
            "bits_equal": bool(torch.equal(bits, want_bits[rows, cols])),
            "iters_equal": bool(torch.equal(iters, want_iters[rows])),
            "block": list(bits.shape), "mean_iterations": float(iters.float().mean())}
    u = torch.from_numpy(np.random.default_rng(32).integers(
        0, 2, (SHARDED_TRANSFORM_FRAMES, POLAR_N)).astype(np.int8)).to(dev)
    m2 = mesh_2d(1, SHARDED_RANKS, device=dev)
    c = m2.get_coordinate()[1]
    x = code_sharded_polar_transform(m2)(u)
    width = POLAR_N // SHARDED_RANKS
    out["transform_equal"] = bool(torch.equal(x, polar_transform(u)[:, c * width:(c + 1) * width]))
    out["scaling"] = measure_scaling(paths["polar_sc"][0], frames_per_device=POLAR_CHUNK)
    Path(out_path).write_text(json.dumps(out))
    dist.destroy_process_group()


def run_sharded_children(ranks: int, tag: str, **env_extra) -> list:
    """Start ``ranks`` local ranks of ``sharded_child`` and return their
    results; a rank that fails or outlives the timeout raises.  With fewer
    visible cards than ranks, the ranks share a card over gloo."""
    from polarcode_and_ldpc_tpu_torch.cli._common import free_port

    out_dir = Path("chiprun_out") / "sharded" / tag
    out_dir.mkdir(parents=True, exist_ok=True)
    env = dict(os.environ, MASTER_ADDR="localhost", MASTER_PORT=str(free_port()),
               WORLD_SIZE=str(ranks), LOCAL_WORLD_SIZE=str(ranks), **env_extra)
    settings = {name: globals()[name] for name in SHARDED_SETTINGS}
    procs = []
    for r in range(ranks):
        log = open(out_dir / f"rank{r}.log", "w")
        procs.append((log, subprocess.Popen(
            [sys.executable, "-c", f"import chip_smoke; chip_smoke.sharded_child("
                                   f"{str(out_dir / f'rank{r}.json')!r}, {settings!r})"],
            stdout=log, stderr=subprocess.STDOUT, env=dict(env, RANK=str(r), LOCAL_RANK=str(r)))))
    try:
        for r, (log, p) in enumerate(procs):
            code = p.wait(timeout=SHARDED_TIMEOUT_S)
            if code != 0:
                raise AssertionError(f"sharded rank {r} ({tag}) exited with {code}: "
                                     + (out_dir / f"rank{r}.log").read_text()[-3000:])
    finally:
        for log, p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
            log.close()
    return [json.loads((out_dir / f"rank{r}.json").read_text()) for r in range(ranks)]


def require_launches(counts: dict, keys, what: str) -> None:
    missing = [k for k in keys if counts.get(k, 0) < 1]
    if missing:
        raise AssertionError(f"{what} launched {missing} no time: {counts}")


def sync(dev) -> None:
    if torch.device(dev).type == "cuda":
        torch.cuda.synchronize(dev)


def check_children(children: list, want: dict, results: dict, tag: str) -> dict:
    """Every child rank's counters equal the unsharded run's, the code-sharded
    results are bit-identical, and every kernel of the paths was launched;
    the children's launches join the kernel table."""
    counters = lambda mc: {k: v[:4] for k, v in mc.items()}  # noqa: E731
    for r, child in enumerate(children):
        if counters(child["mc"]) != counters(want):
            raise AssertionError(f"{tag}: rank {r} counts {counters(child['mc'])}, "
                                 f"unsharded {counters(want)}")
        bad = [k for k, v in child["qc"].items() if not (v["bits_equal"] and v["iters_equal"])]
        if bad or not child["transform_equal"]:
            raise AssertionError(f"{tag}: rank {r}: code-sharded QC {bad} / polar transform "
                                 f"equal {child['transform_equal']}")
        require_launches(child["launches"], SHARDED_KEYS, f"{tag}: rank {r}")
        for key in SHARDED_KEYS:
            if key in results:
                results[key]["launches"] += child["launches"][key]
    return {"ranks": len(children), "backend": children[0]["backend"],
            "devices": [c["device"] for c in children],
            "counts_equal_unsharded": True, "code_sharded_bit_identical": True,
            "mc_seconds": [c["mc_seconds"] for c in children],
            "mc_run_seconds": {k: [c["mc"][k][4] for c in children] for k in want},
            "launches": [{k: c["launches"][k] for k in SHARDED_KEYS} for c in children],
            "qc": children[0]["qc"],
            "scaling": children[0]["scaling"]}


def check_launch_device() -> dict:
    """Kernels launch on their tensors' card whatever device is current: K1
    and a list decode on cuda:1 while cuda:0 is current, against cuda:0."""
    frozen, info, mask = polar_code()
    enc = fec.PolarEncoder(POLAR_N, POLAR_K, frozen_bits=frozen, device="cuda:0")
    msgs = np.random.default_rng(33).integers(0, 2, (1024, POLAR_K))
    llr0 = seeded_llrs(enc.encode(msgs), LOW_SNR_DB, seed=34)
    llr1 = llr0.to("cuda:1")
    out = {}
    for name, mk in (("sc", lambda d: make_sc_decoder(POLAR_N, mask, device=d)),
                     ("scl", lambda d: make_scl_decoder(POLAR_N, mask, SCL_L, chunk=SCL_S,
                                                        device=d))):
        want = mk("cuda:0")(llr0)
        with torch.cuda.device(0):
            got = mk("cuda:1")(llr1)
        torch.cuda.synchronize(1)
        want, got = (want[0], got[0]) if isinstance(want, tuple) else (want, got)
        if not torch.equal(got.cpu(), want.cpu()):
            raise AssertionError(f"{name}: the decode of cuda:1 tensors with cuda:0 current "
                                 "differs from cuda:0's")
        out[name] = "equal"
    return out


def phase_sharded(results: dict) -> None:
    """Frame-sharded Monte-Carlo (``MonteCarloSimulator(mesh=)``): (a) a one-rank
    NCCL group in this process; (b) two local ranks sharing the card over gloo,
    (c) with the QC n=8192 decode and the polar transform code-sharded over
    them, and (d) the weak scaling of the SC step.  Counts must equal the
    unsharded runs', the code-sharded results must be bit-identical; the
    children's launches are counted.  With two cards or more, two ranks on
    two cards over NCCL too, and the launches' device check."""
    import torch.distributed as dist

    from polarcode_and_ldpc_tpu_torch.parallel import default_mesh

    paths = sharded_paths(DEV)
    run_sharded_paths(paths, None)  # warm-up: first use of every op on the card
    t0 = time.perf_counter()
    want = run_sharded_paths(paths, None)
    unsharded_s = time.perf_counter() - t0
    counters = lambda mc: {k: v[:4] for k, v in mc.items()}  # noqa: E731
    for name, (_, _, chunk, run_kw) in paths.items():
        frames, _, errors, _, _ = want[f"{name}/per_frame"]
        if errors != run_kw["max_errors"] or frames >= run_kw["num_frames"]:
            raise AssertionError(f"{name}: the early stop did not cross: "
                                 f"{want[f'{name}/per_frame']}")
    mesh = default_mesh(device=DEV)  # no group yet: a one-rank NCCL group over this card
    backend = "nccl" if torch.device(DEV).type == "cuda" else "gloo"
    if (dist.get_backend(), dist.get_world_size()) != (backend, 1):
        raise AssertionError(f"one-rank group: {dist.get_backend()}, {dist.get_world_size()}")
    run_sharded_paths(paths, mesh)  # warm-up: the communicator's first collectives
    ops.reset_launch_counts()
    one = run_sharded_paths(paths, mesh)
    sync(DEV)
    counts = record_launches(results, SHARDED_KEYS)
    dist.destroy_process_group()
    if counters(one) != counters(want):
        raise AssertionError(f"one-rank NCCL mesh counts {counters(one)}, unsharded "
                             f"{counters(want)}")
    out = {"unsharded": want, "unsharded_seconds": unsharded_s,
           "one_rank_nccl": {"counts_equal_unsharded": True,
                             "launches": {k: counts[k] for k in SHARDED_KEYS},
                             "run_seconds": {k: v[4] for k, v in one.items()}}}
    # one visible card for both ranks, whatever the machine has
    first = os.environ.get("CUDA_VISIBLE_DEVICES", "0").split(",")[0]
    out["two_ranks_shared_card_gloo"] = check_children(
        run_sharded_children(SHARDED_RANKS, "gloo", CUDA_VISIBLE_DEVICES=first),
        want, results, "two ranks on one card (gloo)")
    if torch.cuda.device_count() >= 2:
        out["two_ranks_two_cards_nccl"] = check_children(
            run_sharded_children(SHARDED_RANKS, "nccl"), want, results,
            "two ranks on two cards (NCCL)")
        out["launch_device"] = check_launch_device()
    else:
        out["two_ranks_two_cards_nccl"] = "not run: this step needs a second card"
        out["launch_device"] = "not run: this check needs a second card"
        print("sharded: two ranks on two cards over NCCL need a second card; "
              f"this machine has {torch.cuda.device_count()}", flush=True)
    out["nvidia_smi"] = nvidia_smi_line()
    emit("sharded", **out)


# the oracle differential at its default codes (SCL-8 at N=1024, K=512 on the
# self and oracle frozen sets; BP at n=504 on the self and oracle (H, G)),
# 8192 frames a point at −1, 0, 1 dB
ORACLE_ARGS = ["--num-frames", "8192", "--max-errors", "500", "--batch-size", "4096",
               "--snr-range=-1:1:1", "--skip-plots"]
ORACLE_HOLD_SNR_DB, ORACLE_HOLD_FRAMES = -1.0, 4096


def phase_oracle(results: dict, mbps: dict) -> None:
    """``cli.oracle_differential`` at its default codes with fewer frames,
    each arm's first chunk held against its plain pipeline."""
    from polarcode_and_ldpc_tpu_torch.cli import oracle_differential
    from polarcode_and_ldpc_tpu_torch.core.config import LDPCCodeConfig, PolarCodeConfig
    from polarcode_and_ldpc_tpu_torch.oracle import (oracle_ldpc_matrices,
                                                     oracle_polar_frozen_set)

    defaults = oracle_differential.build_parser().parse_args([])
    N, K, L, S = defaults.polar_n, defaults.polar_k, defaults.list_size, PolarCodeConfig().scl_chunk
    frozen_self, _ = fec.construct_polar_code(N, K, "bhattacharyya", defaults.design_snr_db)
    frozen_orc, _ = oracle_polar_frozen_set(N, K, defaults.design_snr_db)
    narrow = any(sum(w < L for w in build_scl_schedule(
        N, frozen_mask_from_positions(N, f), L, S).lv_in[:-1]) for f in (frozen_self,
                                                                            frozen_orc))
    keys = ["scl_chunk_step", "scl_last_chunk", "bp_decode_bp"] + (
        ["scl_narrow_prefix"] if narrow else [])
    out_dir = Path("chiprun_out") / "oracle_differential"
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    if oracle_differential.main(ORACLE_ARGS + ["--device", DEV, "--output-dir", str(out_dir)]) != 0:
        raise AssertionError("oracle_differential did not return 0")
    sync(DEV)
    seconds = time.perf_counter() - t0
    counts = record_launches(results, keys)
    res = json.loads((out_dir / "oracle_differential.json").read_text())
    for fam in ("polar", "ldpc"):
        for arm in ("self", "oracle"):
            c = res[fam][arm]
            if (c["snr_db"] != [-1.0, 0.0, 1.0] or min(c["frames_tested"]) < 1
                    or not all(0.0 <= b < 0.5 for b in c["ber"])):
                raise AssertionError(f"oracle_differential {fam}/{arm}: {c}")

    # each arm's first chunk against its plain pipeline
    H_o, G_o, _ = oracle_ldpc_matrices(defaults.ldpc_n, defaults.dv, defaults.dc,
                                       defaults.ldpc_seed)
    enc = fec.LDPCEncoder(defaults.ldpc_n, defaults.ldpc_k, dv=defaults.dv, dc=defaults.dc,
                          seed=defaults.ldpc_seed, device=DEV)
    polar = lambda f, **kw: make_polar_pipeline(  # noqa: E731
        N, K, f, ORACLE_HOLD_SNR_DB, decoder="scl", list_size=L, scl_chunk=S, device=DEV,
        **kw)
    ldpc = lambda H, G, idx, **kw: make_ldpc_pipeline(  # noqa: E731
        H, G, ORACLE_HOLD_SNR_DB, decoder="bp", max_iter=LDPCCodeConfig().max_iterations,
        message_idx=idx, device=DEV, **kw)
    arms = {
        "polar_self": (polar(frozen_self), polar(frozen_self, scl_control_impl="unroll-fused"), 0),
        "polar_oracle": (polar(frozen_orc), polar(frozen_orc, scl_control_impl="unroll-fused"),
                         0),
        "ldpc_self": (ldpc(enc.H, enc.G, enc.info_positions),
                      ldpc(enc.H, enc.G, enc.info_positions, bp_impl="torch"),
                      LDPC_CHUNK // 1000),
        "ldpc_oracle": (ldpc(H_o, G_o.T % 2, np.arange(G_o.shape[1])),
                        ldpc(H_o, G_o.T % 2, np.arange(G_o.shape[1]), bp_impl="torch"),
                        LDPC_CHUNK // 1000),
    }
    key = rng.prng_key(0, DEV)
    ids = torch.arange(ORACLE_HOLD_FRAMES, device=DEV)
    held = {}
    for name, (step, plain, allowed) in arms.items():
        a, b = step(key, ids), plain(key, ids)
        bad = (a["bit_errors"] != b["bit_errors"]) | (a["frame_error"] != b["frame_error"])
        if "iterations" in a:
            bad |= a["iterations"] != b["iterations"]
        held[name] = int(bad.sum())
        if held[name] > allowed:
            raise AssertionError(f"oracle_differential {name}: kernel and plain pipelines "
                                 f"differ on {held[name]} frames of the first chunk")
    for fam in ("polar", "ldpc"):
        for arm in ("self", "oracle"):
            mbps[f"oracle_{fam}_{arm}"] = max(res[fam][arm]["throughput_mbps"])
    emit("oracle", argv=ORACLE_ARGS, seconds=seconds, output_dir=str(out_dir),
         launches={k: v for k, v in counts.items() if v},
         first_chunk_frames_differ_from_plain=held,
         backends={f: res[f]["oracle_backend"] for f in ("polar", "ldpc")},
         frozen_overlap=res["polar"]["frozen_overlap"], k_actual=res["ldpc"]["k_actual"],
         gaps={f: res[f]["gap"]["max_abs_log10_ber_gap"] for f in ("polar", "ldpc")},
         curves={f: {a: {k: res[f][a][k] for k in ("snr_db", "ber", "fer", "frames_tested",
                                                   "throughput_mbps")}
                     for a in ("self", "oracle")} for f in ("polar", "ldpc")},
         nvidia_smi=nvidia_smi_line())


def phase_invariance(frames: int = 8192) -> None:
    frozen, info, mask = polar_code()
    enc = ldpc_code()
    qc = qc_code()
    cascl = dict(decoder="ca-scl", list_size=SCL_L, crc_polynomial=SCL_CRC, scl_chunk=SCL_S,
                 device=DEV)
    nms = dict(decoder="nms", normalization=0.75, max_iter=LDPC_ITERS,
               message_idx=enc.info_positions, device=DEV)
    # (step, message bits, frames): the n=8192 steps run a quarter of the frames
    steps = {
        "polar_sc": (make_polar_pipeline(POLAR_N, POLAR_K, frozen, LOW_SNR_DB, decoder="sc",
                                         device=DEV), POLAR_K, frames),
        "polar_cascl": (make_polar_pipeline(POLAR_N, POLAR_K, frozen, SCL_LOW_SNR_DB, **cascl),
                        POLAR_K - 8, frames),
        "polar_cascl_mega": (make_polar_pipeline(POLAR_N, POLAR_K, frozen, SCL_LOW_SNR_DB,
                                                 scl_control_impl="mega", **cascl),
                             POLAR_K - 8, frames),
        "polar_cascl_fast": (make_polar_pipeline(POLAR_N, POLAR_K, frozen, SCL_LOW_SNR_DB,
                                                 scl_node_mode="fast", **cascl),
                             POLAR_K - 8, frames),
        "ldpc_nms": (make_ldpc_pipeline(enc.H, enc.G, LOW_SNR_DB, **nms), LDPC_K, frames),
        "ldpc_layered_nms": (make_ldpc_pipeline(enc.H, enc.G, LOW_SNR_DB, schedule="layered",
                                                num_layers=LDPC_LAYERS, **nms), LDPC_K, frames),
        "ldpc_qc_bp": (qc_pipeline(qc, QC_LOW_SNR_DB, "bp"), QC_K, frames // 4),
        "ldpc_qc_layered_nms": (qc_pipeline(qc, QC_LOW_SNR_DB, "layered_nms"), QC_K, frames // 4),
    }
    out = {}
    for name, (step, k, frames) in steps.items():
        small = frames // 8
        def counters(res):
            return (res.frames, res.bit_errors, res.frame_errors, res.total_iterations)

        one = MonteCarloSimulator(step, k, chunk_frames=frames).run(frames, seed=3)
        eight = MonteCarloSimulator(step, k, chunk_frames=small).run(frames, seed=3)
        multi = MonteCarloSimulator(step, k, chunk_frames=small, chunks_per_dispatch=4).run(frames, seed=3)
        scalar = MonteCarloSimulator(step, k, chunk_frames=small, reduction="scalar").run(frames, seed=3)
        with tempfile.TemporaryDirectory() as tmp:
            ck = Path(tmp) / "mc.json"
            sim = MonteCarloSimulator(step, k, chunk_frames=small)
            sim.run(3 * small, seed=3, checkpoint_path=ck, checkpoint_every_chunks=1)
            resumed = sim.run(frames, seed=3, checkpoint_path=ck)
        ref = counters(one)
        for label, res in (("8 chunks", eight), ("chunks_per_dispatch=4", multi),
                           ("scalar", scalar), ("resumed", resumed)):
            if counters(res) != ref:
                raise AssertionError(
                    f"{name}: {label} gives {counters(res)}, one chunk gives {ref}")
        if one.frame_errors == 0:
            raise AssertionError(f"{name}: the invariance run saw no error to count")
        out[name] = {"frames": ref[0], "bit_errors": ref[1], "frame_errors": ref[2],
                     "total_iterations": ref[3]}
    if (out["polar_cascl_mega"] != out["polar_cascl"]):
        raise AssertionError(f"the one-launch list decode counts {out['polar_cascl_mega']}, "
                             f"the per-chunk kernels {out['polar_cascl']}")
    emit("invariance", identical=["1 chunk", "8 chunks", "chunks_per_dispatch=4", "scalar",
                                  "checkpoint+resume"], **out)


def cascl_decode_split(llr, info_idx, crc, scl_decode, reps: int) -> dict:
    """The CA-SCL decode of one Monte-Carlo chunk, launch by launch: the state
    set-up, each chunk-step launch at its own position, the last chunk, and
    the path selection with its CRC check."""
    frozen, info, mask, sched, steps, last, rev = scl_flagship()
    llr_rev = llr[:, rev].contiguous()
    state = SCLState(sched, llr_rev)
    step_ms = []
    for spec in steps:
        scratch = state.clone()
        step_ms.append(time_ms(lambda: scl_chunk_step_cuda(scratch, spec), reps))
        scl_chunk_step_cuda(state, spec)
    u, metrics = scl_last_chunk_cuda(state, last)
    return {
        "decode_permute_and_state_ms": time_ms(
            lambda: SCLState(sched, llr[:, rev].contiguous()), reps),
        "decode_chunk_step_ms": step_ms,
        "decode_last_chunk_ms": time_ms(lambda: scl_last_chunk_cuda(state, last), reps),
        "select_path_crc_ms": time_ms(
            lambda: select_best_path(u[..., info_idx], metrics, crc), reps),
    }


def busy_share(step, k: int, chunk: int) -> dict:
    """Busy share of the card: kernel time from the profiler (CUPTI times each
    kernel on the device, whatever the tracing costs the host) over the
    host-clock time of the same run without the profiler."""
    sim = MonteCarloSimulator(step, k, chunk_frames=chunk)
    sim.run(2 * chunk, seed=1)
    wall_ms = min(sim.run(8 * chunk, seed=2).elapsed_seconds for _ in range(3)) * 1e3
    # device activity only: the host ops' events would cost key_averages()
    # seconds per run and are not read
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        sim.run(8 * chunk, seed=2)
        torch.cuda.synchronize()
    kernels = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    device_ms = sum(e.self_device_time_total for e in kernels) / 1e3
    seen = device_ms > 0
    return {"run_wall_ms_8_chunks": wall_ms,
            "device_kernel_ms_8_chunks": device_ms if seen else "not measured",
            "device_busy_share": device_ms / wall_ms if seen else "not measured",
            "device_launches_per_chunk": (sum(e.count for e in kernels) / 8 if seen
                                          else "not measured")}


def phase_stages(reps: int, only=None) -> None:
    """Where a chunk's time goes: each stage of the Monte-Carlo step timed
    alone by CUDA events at the main path's shapes, then the whole step, and
    the card's busy share over a short run from the profiler.  The CA-SCL
    decode is also split into its 7 chunk-step launches and its last-chunk
    launch; the one-launch list decode, the fast list nodes, the layered
    LDPC chunk and the MacKay n=8192 BP chunk have a column each."""
    frozen, info, mask = polar_code()
    enc = ldpc_code()
    large = large_ldpc_code()
    key = rng.prng_key(0, DEV)
    out = {}
    configs = {
        "polar_sc": (POLAR_CHUNK, POLAR_K, POLAR_N,
                     make_polar_pipeline(POLAR_N, POLAR_K, frozen, 3.0, decoder="sc", device=DEV)),
        "polar_cascl": (SCL_CHUNK, POLAR_K - 8, POLAR_N,
                        make_polar_pipeline(POLAR_N, POLAR_K, frozen, 3.0, decoder="ca-scl",
                                            list_size=SCL_L, crc_polynomial=SCL_CRC,
                                            scl_chunk=SCL_S, device=DEV)),
        "polar_cascl_mega": (SCL_CHUNK, POLAR_K - 8, POLAR_N,
                             make_polar_pipeline(POLAR_N, POLAR_K, frozen, 3.0, decoder="ca-scl",
                                                 list_size=SCL_L, crc_polynomial=SCL_CRC,
                                                 scl_chunk=SCL_S, scl_control_impl="mega",
                                                 device=DEV)),
        "polar_cascl_fast": (SCL_CHUNK, POLAR_K - 8, POLAR_N,
                             make_polar_pipeline(POLAR_N, POLAR_K, frozen, 3.0, decoder="ca-scl",
                                                 list_size=SCL_L, crc_polynomial=SCL_CRC,
                                                 scl_chunk=SCL_S, scl_node_mode="fast",
                                                 device=DEV)),
        "ldpc_bp": (LDPC_CHUNK, LDPC_K, LDPC_N,
                    make_ldpc_pipeline(enc.H, enc.G, 3.0, decoder="bp", max_iter=LDPC_ITERS,
                                       message_idx=enc.info_positions, device=DEV)),
        "ldpc_layered_nms": (LDPC_CHUNK, LDPC_K, LDPC_N,
                             make_ldpc_pipeline(enc.H, enc.G, 3.0, decoder="nms",
                                                normalization=0.75, max_iter=LDPC_ITERS,
                                                schedule="layered", num_layers=LDPC_LAYERS,
                                                message_idx=enc.info_positions, device=DEV)),
        "ldpc_mackay8192_bp": (LARGE_LDPC_CHUNK, LARGE_LDPC_K, LARGE_LDPC_N,
                               make_ldpc_pipeline(large["enc"].H, large["enc"].G, 3.0,
                                                  decoder="bp", max_iter=LDPC_ITERS,
                                                  message_idx=large["enc"].info_positions,
                                                  device=DEV)),
    }
    info_idx = torch.as_tensor(info, device=DEV)
    G = {name: torch.as_tensor(e.G.astype(np.float32), device=DEV)
         for name, e in (("ldpc", enc), ("ldpc_mackay8192", large["enc"]))}
    sc_program = SCProgram(POLAR_N, mask)
    graph = TannerGraph.from_H(enc.H, DEV)
    bp_plan = BPKernelPlan(graph, LDPC_ITERS, True, "bp")
    large_plan = BPKernelPlan(large["graph"], LDPC_ITERS, True, "bp")
    layered_plan = BPKernelPlan(graph, LDPC_ITERS, True, "ms", 0.75, 0.0, "layered", LDPC_LAYERS)
    crc = CRCCodec(POLAR_K - 8, SCL_CRC, DEV)
    scl_decode = make_scl_decoder(POLAR_N, mask, SCL_L, chunk=SCL_S, device=DEV)
    mega_decode = make_scl_decoder(POLAR_N, mask, SCL_L, chunk=SCL_S, control_impl="mega",
                                   device=DEV)
    fast_decode = make_scl_decoder(POLAR_N, mask, SCL_L, chunk=SCL_S, node_mode="fast",
                                   device=DEV)
    for name, (chunk, k, n, step) in configs.items():
        if only is not None and name not in only:
            continue
        ids = torch.arange(chunk, device=DEV)
        fkeys = rng.frame_keys(key, ids)
        mkeys, nkeys = rng.fold_in(fkeys, 0), rng.fold_in(fkeys, 1)
        msgs = rng.bernoulli_half(mkeys, k)
        if name.startswith("polar"):
            def encode():
                u = torch.zeros((chunk, n), dtype=torch.int8, device=DEV)
                u[:, info_idx] = crc.encode(msgs) if name.startswith("polar_cascl") else msgs
                return polar_transform(u)
        else:
            def encode():
                return gf2_matmul(msgs, G["ldpc_mackay8192" if "mackay" in name else "ldpc"])
        cw = encode()
        noise = rng.normal(nkeys, n)
        llr = awgn_transmit(None, cw, 3.0, noise=noise).contiguous()
        decode = {"polar_sc": lambda: sc_decode_cuda(llr, sc_program),
                  "polar_cascl": lambda: scl_decode(llr),
                  "polar_cascl_mega": lambda: mega_decode(llr),
                  "polar_cascl_fast": lambda: fast_decode(llr),
                  "ldpc_bp": lambda: bp_decode_cuda(llr, bp_plan),
                  "ldpc_layered_nms": lambda: bp_decode_cuda(llr, layered_plan),
                  "ldpc_mackay8192_bp": lambda: bp_decode_cuda(llr, large_plan)}[name]
        stages = {
            "frame_keys_ms": lambda: [rng.fold_in(fk, j) for fk in [rng.frame_keys(key, ids)]
                                      for j in (0, 1)],
            "message_bits_ms": lambda: rng.bernoulli_half(mkeys, k),
            "encode_ms": encode,
            "noise_normal_ms": lambda: rng.normal(nkeys, n),
            "channel_arith_ms": lambda: awgn_transmit(None, cw, 3.0, noise=noise),
            "decode_kernel_ms": decode,
            "whole_step_ms": lambda: step(key, ids),
        }
        out[name] = {label: time_ms(fn, reps) for label, fn in stages.items()}
        out[name]["chunk_frames"] = chunk
        if name == "polar_cascl":
            out[name].update(cascl_decode_split(llr, info_idx, crc, scl_decode, reps))
        out[name].update(busy_share(step, k, chunk))
    emit("stages", **out)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--quick", action="store_true", help="cut frame counts and repetitions")
    ap.add_argument("--phases", default=",".join(PHASES))
    ap.add_argument("--verbose-build", action="store_true", help="print ptxas resource usage")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke.py needs a CUDA device: torch.cuda.is_available() is false")
    phases = [p for p in args.phases.split(",") if p]
    unknown = set(phases) - set(PHASES)
    if unknown:
        raise SystemExit(f"unknown phases: {sorted(unknown)}")
    t0 = time.perf_counter()
    results: dict = {}  # kernel name → its line of the final kernel table
    mbps: dict = {}
    reps = 3 if args.quick else 20
    dev_info: dict = {}
    q = args.quick
    # the profiled K3, K5, K4, K6 and K1 are built beside the other sources only
    # when their phases run
    variants = tuple(v for p, v in (("scl_profile", "scl_decode_profile"),
                                    ("scl_profile", "scl_body_profile"),
                                    ("scl_profile", "scl_last_profile"),
                                    ("scl_profile", "scl_mega_profile"),
                                    ("sc_profile", "sc_decode_profile")) if p in phases)
    run = {
        "device": lambda: dev_info.update(phase_device()),
        "build": lambda: phase_build(args.verbose_build, variants),
        "kernels": lambda: phase_kernels(results, reps, q),
        "scl_kernels": lambda: phase_scl_kernels(results, reps, q),
        "scl_profile": phase_scl_profile,
        "sc_profile": phase_sc_profile,
        "fast_kernels": lambda: phase_fast_kernels(results, reps, q),
        "large_kernels": lambda: phase_large_kernels(results, reps),
        "onehot_kernels": lambda: phase_onehot_kernels(results, reps, q),
        "polar_sc_mc": lambda: phase_polar_sc_mc(
            results, mbps, 4 * POLAR_CHUNK if q else 16 * POLAR_CHUNK),
        "polar_cascl_mc": lambda: phase_polar_cascl_mc(
            results, mbps, (2 if q else 16) * SCL_CHUNK, 2 * SCL_CHUNK),
        "polar_fast_mc": lambda: phase_polar_fast_mc(
            results, mbps, (2 if q else 16) * SCL_CHUNK, 2 * SCL_CHUNK),
        "polar_scl8_controls": lambda: phase_polar_scl8_controls(results, mbps, reps, q),
        "ldpc_mc": lambda: phase_ldpc_mc(results, mbps, 4 * LDPC_CHUNK if q else 32 * LDPC_CHUNK),
        "ldpc_layered_mc": lambda: phase_ldpc_layered_mc(
            results, mbps, 4 * LDPC_CHUNK if q else 32 * LDPC_CHUNK),
        "ldpc_qc_mc": lambda: phase_ldpc_qc_mc(results, mbps, 2 if q else 4),
        "polar_large_mc": lambda: phase_polar_large_mc(
            results, mbps, (2 if q else 8) * LARGE_SCL_CHUNK),
        "polar_sc_large_mc": lambda: phase_polar_sc_large_mc(
            results, mbps, (2 if q else 8) * LARGE_SC_CHUNK),
        "ldpc_large_mc": lambda: phase_ldpc_large_mc(
            results, mbps, (2 if q else 8) * LARGE_LDPC_CHUNK),
        "serving": lambda: phase_serving(results, mbps, reps),
        "serving_fast": lambda: phase_serving(results, mbps, reps, node_mode="fast"),
        "snr_curves": lambda: phase_snr_curves(results),
        "channels_mc": lambda: phase_channels_mc(results, mbps, q),
        "throughput": lambda: phase_throughput(results, mbps),
        "run_benchmark": lambda: phase_run_benchmark(results, mbps),
        "code_params": lambda: phase_code_params(results, mbps),
        "sc_vs_scl": lambda: phase_sc_vs_scl(results, mbps),
        "construction": lambda: phase_construction(results, mbps, q),
        "twins": lambda: phase_twins(q),
        "sharded": lambda: phase_sharded(results),
        "oracle": lambda: phase_oracle(results, mbps),
        "invariance": phase_invariance,
        "stages": lambda: phase_stages(reps),
    }
    assert tuple(run) == PHASES
    phase_s = {}  # host seconds of each phase, its build included
    for name in PHASES:
        if name in phases:
            t = time.perf_counter()
            run[name]()
            torch.cuda.synchronize()
            phase_s[name] = round(time.perf_counter() - t, 1)
    torch.cuda.synchronize()
    if set(phases) != set(PHASES):
        emit("partial", phases=phases, seconds=round(time.perf_counter() - t0, 1),
             phase_seconds=phase_s)
        return 0
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err", "ms",
            "plain_ms", "bound_ms", "bound_by", "library_ms")
    emit("summary", seconds=round(time.perf_counter() - t0, 1), phase_seconds=phase_s,
         info_mbps=mbps)
    print(json.dumps({"kernels": [{k: r[k] for k in keys} for r in results.values()]}), flush=True)
    print(dev_info.get("nvidia_smi") or nvidia_smi_line(), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
