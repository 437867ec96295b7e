#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

Run from the root of a checkout, with no arguments:

    python3 chip_smoke.py

It needs one CUDA device and ``nvcc``.  It builds the package's CUDA kernels
from the sources in the checkout, holds each kernel against its plain PyTorch
version on the card at the shapes the Monte-Carlo main path gives it, drives
the main paths (``MonteCarloSimulator`` over the polar SC, the polar CA-SCL-8
exact and with fast list nodes, the LDPC BP / min-sum, the row-layered
min-sum and the quasi-cyclic n=8192 pipelines, the adaptive SC-first CA-SCL
serving decoder on batches of 8192 frames, exact and fast, and the SNR-curve
CLI) at full code size through the kernels, checks the frame-id invariance of
the counters and checkpoint/resume, and prints one JSON line per phase.  Any
failure raises, and the exit code is then non-zero.

The second line from the end lists every kernel with its launches on the main
path, its error against the plain version, its time, the plain version's
time and its roofline bound; the last line is
``{"ok": true, "device": {...}}``.

Phases: ``device``, ``build``, ``kernels`` (SC and LDPC kernels, flooding and
layered, against their plain versions), ``scl_kernels`` (the list-decode
kernels: the chunk body on every chunk pattern of the code, the chunk step on
the level stacks of every chunk position, the last chunk, the one-launch
decode, whole decodes, other codes), ``fast_kernels`` (the fast-node
selection kernel, and the fast node programs of the chunk body, chunk step
and last chunk in the same way; the one-launch decode must refuse them),
``polar_sc_mc``, ``polar_cascl_mc``, ``polar_fast_mc``, ``ldpc_mc``,
``ldpc_layered_mc``, ``ldpc_qc_mc``, ``serving``, ``serving_fast``,
``snr_curves`` (the main paths, each with the launch counts set to 0 just
before and read just after), ``invariance``, ``stages``.

``--quick`` cuts the frame counts (for a first run after a kernel change);
``--phases a,b`` runs a subset (then no final ``ok`` line is printed).
"""

from __future__ import annotations

import argparse
import json
import math
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

import polarcode_and_ldpc_tpu_torch as fec
from polarcode_and_ldpc_tpu_torch import ops
from polarcode_and_ldpc_tpu_torch.convert import qc_code_from_numpy
from polarcode_and_ldpc_tpu_torch.channels.awgn import awgn_noise_std, awgn_transmit
from polarcode_and_ldpc_tpu_torch.core import rng
from polarcode_and_ldpc_tpu_torch.models.ldpc.encoder import gf2_matmul
from polarcode_and_ldpc_tpu_torch.models.ldpc.graph import TannerGraph
from polarcode_and_ldpc_tpu_torch.models.polar.construction import (bit_reverse_permutation,
                                                                    frozen_mask_from_positions)
from polarcode_and_ldpc_tpu_torch.models.polar.crc import CRCCodec
from polarcode_and_ldpc_tpu_torch.models.polar.encoder import polar_transform
from polarcode_and_ldpc_tpu_torch.models.polar.sc import make_sc_decoder
from polarcode_and_ldpc_tpu_torch.models.polar.scanscl import (build_scl_schedule,
                                                               super_touch_sets)
from polarcode_and_ldpc_tpu_torch.models.polar.scl import make_scl_decoder, select_best_path
from polarcode_and_ldpc_tpu_torch.ops import build
from polarcode_and_ldpc_tpu_torch.ops.bp_cuda import BPKernelPlan, bp_decode_cuda, smem_bytes
from polarcode_and_ldpc_tpu_torch.ops.sc_mega_cuda import SCProgram, sc_decode_cuda
from polarcode_and_ldpc_tpu_torch.ops.fastnode_cuda import (fastnode_select,
                                                            fastnode_select_cuda,
                                                            fastnode_select_plain)
from polarcode_and_ldpc_tpu_torch.ops.scl_cuda import (OP_COMBINE, OP_F, OP_G, OP_LEAF, OP_RATE1_FAST,
                                                       OP_REP, OP_REP_FAST, SCLMegaPlan, SCLState,
                                                       build_mega_tables, make_step_specs,
                                                       scl_chunk_body_cuda, scl_chunk_step_cuda,
                                                       scl_last_chunk_cuda)
from polarcode_and_ldpc_tpu_torch.sim import (MonteCarloSimulator, make_ldpc_pipeline,
                                              make_polar_pipeline)

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

PHASES = ("device", "build", "kernels", "scl_kernels", "fast_kernels", "polar_sc_mc",
          "polar_cascl_mc", "polar_fast_mc", "ldpc_mc", "ldpc_layered_mc", "ldpc_qc_mc",
          "serving", "serving_fast", "snr_curves", "invariance", "stages")


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


def seeded_llrs(codewords: torch.Tensor, snr_db: float, seed: int) -> torch.Tensor:
    """Channel LLRs of int8 codewords on the card from seeded numpy noise."""
    std = awgn_noise_std(snr_db)
    noise = np.random.default_rng(seed).standard_normal(tuple(codewords.shape), dtype=np.float32)
    y = (1.0 - 2.0 * codewords.to(torch.float32)) + std * torch.from_numpy(noise).to(DEV)
    return (2.0 * y / (std * std)).contiguous()


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


def phase_build(verbose: bool) -> None:
    seconds = build.build_all(verbose=verbose)
    for name in build.SOURCES:
        build.load(name)
    emit("build", seconds=round(seconds, 3), sources=[f"{s}.cu" for s in build.SOURCES],
         flags=" ".join(build.NVCC_FLAGS))


def polar_code():
    frozen, info = fec.construct_polar_code(POLAR_N, POLAR_K, "bhattacharyya", 2.0)
    return frozen, info, frozen_mask_from_positions(POLAR_N, frozen)


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
        "mean_iterations": float(iters.float().mean()),
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


def cascl_llrs(frozen, B: int, snr_db: float, seed: int) -> torch.Tensor:
    enc = fec.PolarEncoder(POLAR_N, POLAR_K, frozen_bits=frozen, use_crc=True,
                           crc_polynomial=SCL_CRC, device=DEV)
    msgs = np.random.default_rng(seed).integers(0, 2, (B, enc.K_data))
    return seeded_llrs(enc.encode(msgs), snr_db, seed=seed + 1000)


def body_flops(program) -> int:
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
    one top-L."""
    L, total = program.L, 0
    top = 2 * L * math.ceil(math.log2(2 * L))
    leaf = 14 * L + top
    for op, _, sz, _ in program.ops.tolist():
        kind = op & 0xFF
        if kind in (OP_F, OP_G):
            total += 3 * L * sz
        elif kind == OP_COMBINE:
            total += sz * (1 + L)
        elif kind == OP_LEAF:
            total += leaf
        elif kind == OP_RATE1_FAST:
            k = min(L - 1, sz)
            total += L * (4 * sz + sz - 1 + k * sz + sz) + k * (L + top)
        elif kind == OP_REP_FAST:
            total += L * (14 * sz + 2 * (sz - 1)) + 2 * L + top
        else:
            total += L * (2 * sz * int(math.log2(sz)) + 7 * sz + sz - 1)
            total += leaf if kind == OP_REP else 0
    return total


def step_cost(sched, c: int, spec) -> tuple[int, int]:
    """(bytes, operations) per frame of chunk step ``c``: every touched level
    read once and written once (``super_touch_sets``), pendings and metrics."""
    t, L, sizes = sched.t, sched.L, sched.sizes
    touch = super_touch_sets(int(sched.desc_k[c]), int(sched.asc_j[c]), t,
                             sched.comp_a[c], sched.comp_b[c])
    rows = 1 if spec.inv or spec.k == t else L
    byts = (4 * sched.N * touch["needs_llr"]
            + sum(4 * rows * sizes[i + 1] for i in touch["alpha_read"])
            + sum(4 * sizes[i + 1] for i in touch["beta_read"])
            + 4 * L * (len(touch["pend_a_in"]) + len(touch["pend_b_in"]) + 1)
            + sum(4 * L * sizes[i + 1] for i in touch["alpha_write"])
            + sum(4 * sizes[i + 1] for i in touch["beta_write"])
            + 4 * L * (len(touch["pend_a_out"]) + len(touch["pend_a_eye"])
                       + len(touch["pend_b_out"]) + len(touch["pend_b_eye"]) + 1))
    flops = (body_flops(spec.program) + sum(3 * L * sizes[i + 1] for i in touch["alpha_write"])
             + sum((1 + L) * sizes[i + 1] for i in touch["beta_read"]))
    return byts, flops


def last_cost(sched, spec) -> tuple[int, int]:
    t, L, N, S = sched.t, sched.L, sched.N, sched.S
    byts = (4 * (N if t == 1 else 2 * S * L) + 4 * (N - S) + 4 * L * (t + 2)
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
            got = scl_chunk_body_cuda(alpha, pm, program)
            torch.cuda.synchronize()
            want = program.plain(alpha, pm)
            worst = max(worst, hold_equal(
                "scl_chunk_body", dict(zip(("beta", "pm", "R"), zip(got, want))),
                {"pattern": pid, "case": case, "B": B}))
    return worst


def check_scl_steps(sched, steps, last, rev, llr: torch.Tensor, context: dict) -> float:
    """K3 on the level stacks of every chunk position reached by the plain
    version, then K4 on the stacks before the last chunk."""
    worst = 0.0
    llr_rev = llr[:, rev].contiguous()
    state = SCLState(sched, llr_rev)
    fields = ("alpha", "beta", "pend_a", "pend_b", "pm")
    for c, spec in enumerate(steps):
        kern = state.clone()
        scl_chunk_step_cuda(kern, spec)
        torch.cuda.synchronize()
        state.load_plain(*spec.plain(llr_rev, *state.to_plain()))
        worst = max(worst, hold_equal(
            "scl_chunk_step", {f: (getattr(kern, f), getattr(state, f)) for f in fields},
            {**context, "chunk": c}))
    u, pm = scl_last_chunk_cuda(state, last)
    torch.cuda.synchronize()
    u_rev, pm_plain = last.plain(llr_rev, *state.to_plain())
    worst = max(worst, hold_equal(
        "scl_last_chunk", {"u": (u, u_rev[..., rev]), "pm": (pm, pm_plain)},
        {**context, "chunk": sched.C - 1}))
    return worst


def check_scl_other_codes() -> list:
    """One compiled build serves every code: other lengths, chunk sizes and
    list sizes (a single-chunk code, L = 1, L = 32 with path 31 in a word's
    sign bit) through the kernel controls (one launch per chunk, the chunk
    body inside the plain glue, the whole decode in one launch) against the
    plain decoder."""
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
        out.append({**context, "kernels_equal_plain": True})
    return out


# the TPU kernels the per-chunk kernels replace: exact mode, and the fast mode
# the same functions trace with node_mode="fast"
SCL_REPLACES = {
    "scl_chunk_step": "polarcode_and_ldpc_tpu/ops/scl_superchunk_pallas.py:167",
    "scl_last_chunk": "polarcode_and_ldpc_tpu/ops/scl_superchunk_pallas.py:356",
    "scl_chunk_body": "polarcode_and_ldpc_tpu/ops/scl_body_pallas.py:378",
    "scl_chunk_step_fast": "polarcode_and_ldpc_tpu/ops/scl_superchunk_pallas.py:173",
    "scl_last_chunk_fast": "polarcode_and_ldpc_tpu/ops/scl_superchunk_pallas.py:361",
    "scl_chunk_body_fast": "polarcode_and_ldpc_tpu/ops/scl_body_pallas.py:382",
}


def time_scl_kernels(results: dict, sched, steps, last, rev, llr, worst: dict, reps: int,
                     plain_reps: int) -> tuple[int, int]:
    """Time K3 at every chunk position, K4, and K5 on every chunk's pattern,
    each beside its plain version, on the level stacks the decode of ``llr``
    reaches; write their rows (``_fast`` names for a fast node program).
    Returns the operations of the chunk steps and of the last chunk."""
    B = llr.shape[0]
    suffix = "_fast" if last.program.fast else ""
    llr_rev = llr[:, rev].contiguous()
    state = SCLState(sched, llr_rev)
    step_ms, step_plain_ms, body_ms, body_plain_ms, step_bound_ms = [], [], [], [], []
    step_bytes = step_flops = body_bytes = body_flops_total = 0
    L, S = sched.L, sched.S
    for c, spec in enumerate(steps + [last]):
        plain_ops = state.to_plain()
        alpha_t = plain_ops[0][sched.t - 1].contiguous()
        pm_c = state.pm.clone()
        body_ms.append(time_ms(lambda: scl_chunk_body_cuda(alpha_t, pm_c, spec.program), reps))
        body_plain_ms.append(time_ms(lambda: spec.program.plain(alpha_t, pm_c), plain_reps, warmup=1))
        body_bytes += B * (4 * L * S + 4 * L + L * S + 4 * L + 8 * L)
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
        shape=shape, launches_per_decode=1)
    name = "scl_chunk_body" + suffix
    results[name] = kernel_row(
        name, SCL_REPLACES[name], sum(body_ms) / sched.C, sum(body_plain_ms) / sched.C,
        body_bytes / sched.C, body_flops_total / sched.C, worst["body"], shape=shape,
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
        step_flops + B * lf, worst["mega"], shape=shape, launches_per_decode=1,
        note="plain_ms is the plain chunk program (control_impl='unroll-fused', full width); "
             "the level stacks are scratch in device memory",
        ms_of_the_per_chunk_launches=decode_ms["unroll-kernel"])
    emit("scl_kernels", kernels=[results[k] for k in ("scl_chunk_body", "scl_chunk_step",
                                                      "scl_last_chunk", "scl_decode_mega")],
         unique_patterns=len(unique), whole_decode_ms=decode_ms, cases=cases,
         other_codes=check_scl_other_codes())


def raises_value_error(fn) -> bool:
    """Whether ``fn()`` refuses with a ``ValueError`` (a refusal is the
    expected outcome; anything else propagates)."""
    try:
        fn()
    except ValueError:
        return True
    return False


def check_fastnode_kernel(results: dict, reps: int) -> list:
    """K7 against its plain version at the probe's shape [8, 64, 128] and at
    [8, 128, 4096], on normal and tie-heavy integer inputs; then the probe's
    own path (its input, the kernel, its ground truth: a numpy stable argsort
    and the softplus tree sum), with the launch counts set to 0 just before;
    then times at [8, 128, 4096]."""
    cases = []
    worst = 0.0
    for L, S, B in ((8, 64, 128), (8, 128, 4096)):
        for kind in ("normal", "integer ties"):
            g = np.random.default_rng(L * S + B + len(kind))
            a = (g.integers(-3, 4, (L, S, B)) if kind == "integer ties"
                 else 2 * g.standard_normal((L, S, B))).astype(np.float32)
            a = torch.from_numpy(a).to(DEV)
            got = fastnode_select_cuda(a, L - 1)
            torch.cuda.synchronize()
            want = fastnode_select_plain(a, L - 1)
            context = {"shape": [L, S, B], "K": L - 1, "input": kind}
            worst = max(worst, hold_equal("fastnode_select", dict(
                zip(("mags", "idx", "penalty"), zip(got, want))), context))
            cases.append({**context, "equal_plain": True})
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
    plain_ms = time_ms(lambda: fastnode_select_plain(a, K), max(1, reps // 5), warmup=1)
    byts = B * L * (4 * S + 8 * K + 4)
    flops = B * L * (4 * S + S - 1 + K * S)
    results["fastnode_select"] = kernel_row(
        "fastnode_select", "tools/mosaic_fastnode_probe.py:79", ms, plain_ms, byts, flops, worst,
        source="polarcode_and_ldpc_tpu_torch/ops/csrc/fastnode.cu", shape=[L, S, B], K=K,
        note="launches: the probe's path (its input through fastnode_select); the same device "
             "functions run inside every K3 / K4 / K5 launch of a fast node program, at each "
             "rate-1 node", cases=cases)
    results["fastnode_select"]["launches"] = counts["fastnode_select"]
    return [{"probe_shape_equals_numpy_ground_truth": True, "launches": counts["fastnode_select"]}]


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
    counts = {"rate1": 0, "rep": 0}
    for s in steps + [last]:
        kinds = [op & 0xFF for op in s.program.ops[:, 0].tolist()]
        counts["rate1"] += kinds.count(OP_RATE1_FAST)
        counts["rep"] += kinds.count(OP_REP_FAST)
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
                  for k in ("fastnode_select", "scl_chunk_body_fast", "scl_chunk_step_fast",
                            "scl_last_chunk_fast")],
         fastnode_cases=results["fastnode_select"]["cases"], probe=probe,
         fast_nodes_per_decode=counts, unique_patterns=len(unique), whole_decode_ms=decode_ms,
         cases=cases, other_codes=check_fast_other_codes(), mega_refuses_fast=True)



def phase_kernels(results: dict, reps: int, quick: bool) -> None:
    check_sc_kernel(results, reps)
    check_bp_kernel(results, reps)
    check_bp_layered_kernel(results, reps, quick)
    layered = results["bp_decode_layered"]["cases"]
    emit("kernels", kernels=[
        {k: v for k, v in r.items() if k != "cases"} for r in results.values()],
        sc_cases=results["sc_decode"]["cases"], bp_cases=results["bp_decode_bp"]["cases"],
        layered_cases={"cases": len(layered), "frames": sum(c["B"] for c in layered),
                       "frames_differ": sum(c["frames_differ"] for c in layered),
                       "rules": ["nms 0.75", "oms 0.5", "ms"], "num_layers": [1, 4, 6],
                       "early_stop": [True, False], "B": [4096, 999, "777 (padded slots)"],
                       "snr_db": [-1.0, 1.0, 3.0]})


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
    step = make_polar_pipeline(POLAR_N, POLAR_K, frozen, 3.0, device=DEV, **kw)
    sim = MonteCarloSimulator(step, k_msg, chunk_frames=SCL_CHUNK)
    sim.run(SCL_CHUNK, seed=1)  # warm-up
    ops.reset_launch_counts()
    res = sim.run(frames, max_errors=None, seed=0)
    counts = record_launches(results, ["scl_chunk_step", "scl_last_chunk"])
    mc_chunks = frames // SCL_CHUNK
    if (counts["scl_chunk_step"], counts["scl_last_chunk"], counts["scl_chunk_body"]) != (
            (n_chunks - 1) * mc_chunks, mc_chunks, 0):
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
            counts_mega["scl_last_chunk"]) != (mc_chunks, 0, 0):
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
            want = {"scl_chunk_step": (n_chunks - 1) * mc_chunks, "scl_last_chunk": mc_chunks,
                    "scl_chunk_step_fast": 0, "scl_last_chunk_fast": 0}
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


def qc_code():
    """The quasi-cyclic n=8192 code: shift matrix, expanded H and an encoder."""
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
         generic_layered_kernel_smem_bytes=smem_bytes(layered_plan.graph,
                                                      layered_plan.layer_checks))


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
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
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
    launch; the one-launch list decode, the fast list nodes and the layered
    LDPC chunk have a column each."""
    frozen, info, mask = polar_code()
    enc = ldpc_code()
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
    }
    info_idx = torch.as_tensor(info, device=DEV)
    G = torch.as_tensor(enc.G.astype(np.float32), device=DEV)
    sc_program = SCProgram(POLAR_N, mask)
    graph = TannerGraph.from_H(enc.H, DEV)
    bp_plan = BPKernelPlan(graph, LDPC_ITERS, True, "bp")
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
                return gf2_matmul(msgs, G)
        cw = encode()
        noise = rng.normal(nkeys, n)
        llr = awgn_transmit(None, cw, 3.0, noise=noise).contiguous()
        decode = {"polar_sc": lambda: sc_decode_cuda(llr, sc_program),
                  "polar_cascl": lambda: scl_decode(llr),
                  "polar_cascl_mega": lambda: mega_decode(llr),
                  "polar_cascl_fast": lambda: fast_decode(llr),
                  "ldpc_bp": lambda: bp_decode_cuda(llr, bp_plan),
                  "ldpc_layered_nms": lambda: bp_decode_cuda(llr, layered_plan)}[name]
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
    dev_info = phase_device() if "device" in phases else {"nvidia_smi": nvidia_smi_line()}
    if "build" in phases:
        phase_build(args.verbose_build)
    if "kernels" in phases:
        phase_kernels(results, reps, args.quick)
    if "scl_kernels" in phases:
        phase_scl_kernels(results, reps, args.quick)
    if "fast_kernels" in phases:
        phase_fast_kernels(results, reps, args.quick)
    if "polar_sc_mc" in phases:
        phase_polar_sc_mc(results, mbps, 4 * POLAR_CHUNK if args.quick else 16 * POLAR_CHUNK)
    if "polar_cascl_mc" in phases:
        phase_polar_cascl_mc(results, mbps, (2 if args.quick else 16) * SCL_CHUNK, 2 * SCL_CHUNK)
    if "polar_fast_mc" in phases:
        phase_polar_fast_mc(results, mbps, (2 if args.quick else 16) * SCL_CHUNK, 2 * SCL_CHUNK)
    if "ldpc_mc" in phases:
        phase_ldpc_mc(results, mbps, 4 * LDPC_CHUNK if args.quick else 32 * LDPC_CHUNK)
    if "ldpc_layered_mc" in phases:
        phase_ldpc_layered_mc(results, mbps, 4 * LDPC_CHUNK if args.quick else 32 * LDPC_CHUNK)
    if "ldpc_qc_mc" in phases:
        phase_ldpc_qc_mc(results, mbps, 2 if args.quick else 4)
    if "serving" in phases:
        phase_serving(results, mbps, reps)
    if "serving_fast" in phases:
        phase_serving(results, mbps, reps, node_mode="fast")
    if "snr_curves" in phases:
        phase_snr_curves(results)
    if "invariance" in phases:
        phase_invariance()
    if "stages" in phases:
        phase_stages(reps)
    torch.cuda.synchronize()
    if set(phases) != set(PHASES):
        emit("partial", phases=phases, seconds=round(time.perf_counter() - t0, 1))
        return 0
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err", "ms",
            "plain_ms", "bound_ms", "bound_by", "library_ms")
    emit("summary", seconds=round(time.perf_counter() - t0, 1), info_mbps=mbps)
    print(json.dumps({"kernels": [{k: r[k] for k in keys} for r in results.values()]}), flush=True)
    print(dev_info["nvidia_smi"], flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
