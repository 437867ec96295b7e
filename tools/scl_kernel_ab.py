#!/usr/bin/env python3
"""Parent against change for the port's decode kernels, in one run on one
NVIDIA GPU: the list-decode kernels (part ``scl``), the SC kernel (part ``sc``),
the int8 row roll (part ``roll``) and the LDPC kernels (part ``bp``).

    python3 tools/scl_kernel_ab.py --tree parent=<dir> --tree change=. \\
        --order parent,change,change,parent [--parts scl,sc,roll,bp]

Each ``--tree name=dir`` is a checkout of the repo (``git archive`` of a
commit unpacked into a directory that ``.gitignore`` lists, or the working
tree).  For each name in ``--order`` the script runs itself with
``--child`` in a fresh process that imports ``polarcode_and_ldpc_tpu_torch``
from that tree and builds its kernels into ``<dir>/build/ab`` (the trees do
not share a build; a child builds only the sources of its parts).  A child
prints one JSON line.  Part ``scl`` times, by CUDA events after a warm-up, at
the flagship shape (4096 frames, N=1024, K=512, chunk S=128, list L=8, 3 dB):

* K3 (``scl_chunk_step``) at each of the seven chunk positions on the state
  the kernel decode reaches, full width, and its mean; K3 with fast node
  programs, with one-hot pendings (each position and the mean); K4 in the
  same three modes; K5 on each of the eight chunk patterns and the mean, with
  fast and with one-hot programs too; K6 (the one-launch decode);
* whole decodes of the flagship (``unroll-kernel``, live width, CRC-free
  decoder of ``make_scl_decoder``) and of JAX's SCL-8 benchmark shape (8192
  frames, chunk 128, rank and one-hot);
* K6 beside the same tree's per-chunk decode (``unroll-kernel``) at the
  serving list pass's sizes (67, 128 and 512 frames at -1 dB) and on the
  large code (N=4096, SCL-32, chunk 64, 1024 frames); where the tree has
  that mode, K6 at the flagship with its step table in device memory;
* K3 with the chunk context in device memory (256 frames, N=4096, S=1024,
  L=32, positions 0–2), K5 so on the last chunk's pattern, and the large-code
  decode (1024 frames, N=4096, L=32, chunk 64);
* a digest of every decode's paths and metrics, so that the trees' outputs
  can be compared bit for bit;
* K3 of the large-code decode at each of its 63 chunk positions (N=4096,
  S=64, L=32: every prune 64 candidates wide, no ``OP_SUBTREE``), and its mean;
* the fast program against the exact one in the same run: K3-fast's mean per
  launch over K3's, K4-fast over K4, K5-fast over K5, the whole fast decode
  over the exact one;
* the stage profile of K3 at flagship positions 3 and 4 (exact and fast node
  programs, and one-hot pendings with their staging apart) and at the large-code
  decode's positions 16 and 40 where the tree has the
  profiled build (``ops/build.py`` ``VARIANTS``), of K6 over the whole
  flagship decode where it has ``scl_mega_profile``, of K4 and K4-fast on the
  state before the flagship's last chunk where it has ``scl_last_profile``,
  of K5, K5-fast and K5-onehot on the last chunk's pattern where it has
  ``scl_body_profile``, and the kernels'
  registers, spills and resident warps per SM where it has
  ``scl_cuda.kernel_resources``.

Part ``narrow`` times the narrow (live-width) positions of the live
decodes, the flagship's (two) and the large code's (N=4096, SCL-32, chunk 64,
1024 frames: eight): each position alone and the whole narrow prefix of a
decode, by CUDA events and by ``torch.profiler``'s device time, as one
``scl_narrow_prefix`` launch where the tree has it, else the single narrow
chunk-step launches back to back; and the host's microseconds of a
prefix's launches and of one launch by part (the state's checks, the launch
plan, the node program's device copy).  Part ``fastnode`` times K7
(``fastnode_select``) by events and device time at [8, 128, 4096] with K = 7
and at [32, 128, 4096] with K = 31, each device time with the kernels the
profiler saw per call (a reading that missed a launch is taken again, and is
"not measured" if every try missed one).

Part ``sc`` times K1 on one Monte-Carlo chunk of the polar SC path (16384
frames, N=1024, K=512, 3 dB, with and without fast nodes), the two subtree
launches of the hybrid decode at N=32768, K=16384 (1024 frames, 3 dB) and the
whole hybrid decode; where the tree has ``sc_mega_cuda.launch_plan``, the
plans and the subtree launches at 1, 2 and 4 warps a frame; and the stage
profile of the three launches where it has the profiled build
``sc_decode_profile``.  Part ``roll`` times K8
on the probe's tile ([32, 128] int8, shift 30) beside ``torch.roll``, each by
CUDA events around back-to-back calls and by ``torch.profiler``'s device time
of the kernel alone, and the host's microseconds a call (the wrapper,
``torch.roll``, the output's allocation, the C launcher alone).  Part ``bp``
times K2 flooding (sum-product, NMS 0.75) and layered (NMS 0.75, 4 layers),
20 iterations at most, on all-zero codewords over AWGN: the MacKay (8192,
4096) code (1024 frames, 3 dB), the MacKay (4096, 2048) code (256 frames,
0 dB; NMS and layered NMS), the (504, 252) code (4096 frames, 3 dB; and
NMS on one frame, where the launch's host work sets the time), a MacKay
(4096, 2048) code of column weight 16 whose frame exceeds a block (256
frames, 3 dB), and the n=8192 rows again with the planes forced into device
memory (``SMEM_LIMIT_BYTES`` 0); with each row the plan's mode and, where
the tree has it, the blocks resident per SM.  Every part adds its outputs to
the digest.

The parent prints a table of every timing per run and the change's ratio
to the parent (mean of the parent runs over mean of the change runs), and
fails if two trees' digests differ.  Every run's line and the table also go
to the JSON file ``--out`` (default ``build/scl_kernel_ab.json``).
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import subprocess
import sys
import time
from pathlib import Path

N, K, L, S, B, SNR = 1024, 512, 8, 128, 4096, 3.0


def _device_ms(fn, reps: int, expect: "int | None" = None, tries: int = 3):
    """``(ms, kernels per call)``: the mean device time per call of the
    kernels ``fn()`` launches, by ``torch.profiler``, and the kernels the
    profiler saw per call.  ``expect`` is the kernels one call launches (by
    default the package's launch counters over one call).  The profiler can
    drop events (the first launches of a session): each reading follows a
    step of ``reps`` calls whose events it discards, and a reading that saw
    another count is taken again, up to ``tries`` times, and is "not
    measured" when none saw exactly ``expect``."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, schedule

    from polarcode_and_ldpc_tpu_torch import ops

    before = sum(ops.launch_counts().values())
    fn()
    torch.cuda.synchronize()
    if expect is None:
        expect = sum(ops.launch_counts().values()) - before
    seen = 0.0
    for _ in range(tries):
        with profile(activities=[ProfilerActivity.CUDA],
                     schedule=schedule(wait=0, warmup=1, active=1, repeat=1)) as prof:
            for _ in range(2):  # the discarded step, then the one read
                for _ in range(reps):
                    fn()
                torch.cuda.synchronize()
                prof.step()
        kernels = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
        seen = sum(e.count for e in kernels) / reps
        if seen == expect:
            return sum(e.self_device_time_total for e in kernels) / 1e3 / reps, seen
    return "not measured", seen


def _child(reps: int, parts: tuple) -> dict:
    import numpy as np
    import torch

    import polarcode_and_ldpc_tpu_torch as fec
    from polarcode_and_ldpc_tpu_torch.models.polar.construction import frozen_mask_from_positions
    from polarcode_and_ldpc_tpu_torch.ops import build

    dev = "cuda"
    if "scl" not in parts:  # only the sources this child times
        wanted = {"sc": "sc_decode", "roll": "sublane_roll", "bp": "bp_decode",
                  "narrow": "scl_decode", "fastnode": "fastnode"}
        build.SOURCES = tuple(s for s in build.SOURCES
                              if s in {wanted[p] for p in parts if p in wanted})
    variants = tuple(v for v in getattr(build, "VARIANTS", ())
                     if (v.startswith("scl_") and "scl" in parts)
                     or (v.startswith("sc_decode") and "sc" in parts))
    t0 = time.perf_counter()
    build.build_all(variants=variants)
    build_s = time.perf_counter() - t0

    def time_ms(fn, n=reps, warmup=2):
        for _ in range(warmup):
            fn()
        torch.cuda.synchronize()
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(n):
            fn()
        b.record()
        torch.cuda.synchronize()
        return a.elapsed_time(b) / n

    digest = hashlib.sha256()

    def note(*tensors):
        for x in tensors:
            digest.update(x.detach().contiguous().cpu().numpy().tobytes())

    def llrs(n_code, k_code, frames, snr, seed, crc):
        frozen, _ = fec.construct_polar_code(n_code, k_code, "bhattacharyya", 2.0)
        enc = fec.PolarEncoder(n_code, k_code, frozen_bits=frozen, use_crc=crc,
                               crc_polynomial="CRC-8", device=dev)
        msgs = np.random.default_rng(seed).integers(0, 2, (frames, enc.K_data))
        cw = enc.encode(msgs).to(torch.float32)
        std = float(np.sqrt(1.0 / (2.0 * 10 ** (snr / 10.0))))
        noise = np.random.default_rng(seed + 1000).standard_normal(tuple(cw.shape),
                                                                  dtype=np.float32)
        y = (1.0 - 2.0 * cw) + std * torch.from_numpy(noise).to(dev)
        mask = frozen_mask_from_positions(n_code, frozen)
        return (2.0 * y / (std * std)).contiguous(), mask

    out: dict = {"build_s": build_s, "device": torch.cuda.get_device_name(0)}
    if "sc" in parts:
        _child_sc(out, llrs, time_ms, note, variants)
    if "roll" in parts:
        from polarcode_and_ldpc_tpu_torch.ops.roll_cuda import sublane_roll_cuda
        x = torch.from_numpy(np.random.default_rng(0).integers(0, 2, (32, 128)).astype(
            np.int8)).to(dev)
        calls = {"K8": lambda: sublane_roll_cuda(x, 30), "torch.roll": lambda: torch.roll(x, 30, 0)}
        for name, fn in list(calls.items()) * 2:  # in turns, each twice
            out.setdefault(f"{name} events", []).append(time_ms(fn, 10 * reps))
            ms, seen = _device_ms(fn, 10 * reps, expect=1)
            out.setdefault(f"{name} device", []).append(ms)
            out.setdefault(f"{name} kernels per call", []).append(seen)
        for key in [k for k in out if k.startswith(tuple(calls))]:
            ok = [v for v in out[key] if isinstance(v, float)]
            out[key] = sum(ok) / len(ok) if len(ok) == len(out[key]) else out[key]
        note(sublane_roll_cuda(x, 30))
        # host microseconds a call, no synchronise inside: the wrapper, torch.roll,
        # and the wrapper's two parts (the output's allocation; the C launcher)
        from polarcode_and_ldpc_tpu_torch.ops import roll_cuda
        _, fn = roll_cuda._launcher()
        y = torch.empty_like(x)
        stream = torch.cuda.current_stream().cuda_stream
        host = {**calls, "torch.empty_like": lambda: torch.empty_like(x),
                "K8 launcher alone": lambda: fn(x.data_ptr(), y.data_ptr(), 32, 128, 30, stream)}
        for name, fn_ in host.items():
            fn_()
            torch.cuda.synchronize()
            t = time.perf_counter()
            for _ in range(2000):
                fn_()
            out[f"{name} host us"] = (time.perf_counter() - t) / 2000 * 1e6
            torch.cuda.synchronize()
    if "scl" in parts:
        _child_scl(out, llrs, time_ms, note, reps)
    if "narrow" in parts:
        _child_narrow(out, llrs, time_ms, note, reps)
    if "fastnode" in parts:
        _child_fastnode(out, time_ms, note, reps)
    if "bp" in parts:
        _child_bp(out, time_ms, note)
    out["digest"] = digest.hexdigest()
    return out


def _child_scl(out, llrs, time_ms, note, reps) -> None:
    import numpy as np
    import torch

    from polarcode_and_ldpc_tpu_torch.models.polar.construction import bit_reverse_permutation
    from polarcode_and_ldpc_tpu_torch.models.polar.scanscl import build_scl_schedule
    from polarcode_and_ldpc_tpu_torch.models.polar.scl import make_scl_decoder
    from polarcode_and_ldpc_tpu_torch.ops import build, scl_cuda
    from polarcode_and_ldpc_tpu_torch.ops.scl_cuda import (SCLBodyProgram, SCLState,
                                                           make_step_specs, scl_chunk_body_cuda,
                                                           scl_chunk_step_cuda,
                                                           scl_last_chunk_cuda)

    dev = "cuda"
    llr, mask = llrs(N, K, B, SNR, 77, True)
    sched = build_scl_schedule(N, mask, L, S)
    rev = torch.as_tensor(np.asarray(bit_reverse_permutation(N)), dtype=torch.int64, device=dev)
    llr_rev = llr[:, rev].contiguous()

    def step_times(steps, last, perm="rank", tag=""):
        state = SCLState(sched, llr_rev, perm)
        per = []
        for c, spec in enumerate(steps):
            scratch = state.clone()
            per.append(time_ms(lambda: scl_chunk_step_cuda(scratch, spec)))
            scl_chunk_step_cuda(state, spec)
            note(state.alpha, state.beta, state.pend_a, state.pend_b, state.pm)
        u, pm = scl_last_chunk_cuda(state, last)
        note(u, pm)
        out[f"K3{tag} per position"] = per
        out[f"K3{tag} mean"] = sum(per) / len(per)
        out[f"K4{tag}"] = time_ms(lambda: scl_last_chunk_cuda(state, last))
        out[f"K3{tag} x7 + K4{tag}"] = sum(per) + out[f"K4{tag}"]
        return state

    steps, last = make_step_specs(sched)
    step_times(steps, last)
    fsteps, flast = make_step_specs(sched, node_mode="fast")
    step_times(fsteps, flast, tag="-fast")
    # the fast program against the exact one of the same tree, same run
    out["K3-fast mean / K3 mean"] = out["K3-fast mean"] / out["K3 mean"]
    out["K4-fast / K4"] = out["K4-fast"] / out["K4"]
    oprog = [SCLBodyProgram(f, L, perm_impl="onehot") for f in sched.unique_flags]
    osteps, olast = make_step_specs(sched, oprog)
    step_times(osteps, olast, "onehot", tag="-onehot")
    # K5 on each chunk pattern at the level-t alpha of the state
    body = []
    g = np.random.default_rng(5)
    for prog in {id(p): p for p in [s.program for s in steps] + [last.program]}.values():
        alpha = torch.from_numpy((2 * g.standard_normal((B, L, S))).astype(np.float32)).to(dev)
        pm0 = -torch.from_numpy(np.abs(g.standard_normal((B, L))).astype(np.float32)).to(dev)
        body.append(time_ms(lambda: scl_chunk_body_cuda(alpha, pm0, prog)))
        note(*scl_chunk_body_cuda(alpha, pm0, prog))
    out["K5 per pattern"] = body
    out["K5 mean over patterns"] = sum(body) / len(body)
    for tag, progs in (("-fast", [SCLBodyProgram(f, L, "fast") for f in sched.unique_flags]),
                       ("-onehot", oprog)):
        times = []
        g = np.random.default_rng(7)
        for prog in progs:
            alpha = torch.from_numpy((2 * g.standard_normal((B, L, S))).astype(np.float32)).to(dev)
            pm0 = -torch.from_numpy(np.abs(g.standard_normal((B, L))).astype(np.float32)).to(dev)
            times.append(time_ms(lambda: scl_chunk_body_cuda(alpha, pm0, prog)))
            note(*scl_chunk_body_cuda(alpha, pm0, prog))
        out[f"K5{tag} per pattern"] = times
        out[f"K5{tag} mean over patterns"] = sum(times) / len(times)
    out["K5-fast / K5"] = out["K5-fast mean over patterns"] / out["K5 mean over patterns"]
    # whole decodes
    decs = {"flagship unroll-kernel": make_scl_decoder(N, mask, L, chunk=S, device=dev),
            "flagship fast": make_scl_decoder(N, mask, L, chunk=S, node_mode="fast", device=dev),
            "flagship mega (K6)": make_scl_decoder(N, mask, L, chunk=S, control_impl="mega",
                                                   device=dev)}
    for name, dec in decs.items():
        out[name] = time_ms(lambda: dec(llr))
        note(*dec(llr))
    out["flagship fast / flagship unroll-kernel"] = (out["flagship fast"]
                                                     / out["flagship unroll-kernel"])
    # K6 at the serving list pass's sizes, beside the per-chunk decode
    for frames in (67, 128, 512):
        x, _ = llrs(N, K, frames, -1.0, 80 + frames, True)
        for name, dec in (("K6", decs["flagship mega (K6)"]),
                          ("per-chunk", decs["flagship unroll-kernel"])):
            out[f"{name} {frames} frames -1 dB"] = time_ms(lambda: dec(x))
            note(*dec(x))
    # K6 with its step table in device memory, where the tree has that mode
    # (equal to the default's outputs; not in the digest: the parent has no
    # such row)
    if hasattr(scl_cuda, "MEGA_PARAM_ROWS"):
        plan = scl_cuda.SCLMegaPlan(sched)
        plan.table_in_params = False
        want = decs["flagship mega (K6)"](llr)
        out["flagship mega (K6) table in device memory"] = time_ms(
            lambda: scl_cuda.scl_decode_mega_cuda(llr, plan))
        got = scl_cuda.scl_decode_mega_cuda(llr, plan)
        if not (torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])):
            raise AssertionError("K6 with its table in device memory differs")
    llr8, mask8 = llrs(N, K, 8192, SNR, 90, False)
    for perm in ("rank", "onehot"):
        dec = make_scl_decoder(N, mask8, L, chunk=S, perm_impl=perm, device=dev)
        out[f"SCL-8 8192 frames chunk 128 {perm}"] = time_ms(lambda: dec(llr8), max(2, reps // 4))
        note(*dec(llr8))
    # K3 with the context in device memory
    llr32, mask32 = llrs(4096, 2048, 256, SNR, 91, False)
    sched32 = build_scl_schedule(4096, mask32, 32, 1024)
    rev32 = torch.as_tensor(np.asarray(bit_reverse_permutation(4096)), dtype=torch.int64,
                            device=dev)
    st32 = SCLState(sched32, llr32[:, rev32].contiguous())
    s32, _ = make_step_specs(sched32)
    dm = []
    for spec in s32[:3]:
        scratch = st32.clone()
        dm.append(time_ms(lambda: scl_chunk_step_cuda(scratch, spec), max(2, reps // 4)))
        scl_chunk_step_cuda(st32, spec)
    note(st32.alpha, st32.beta, st32.pm)
    out["K3-devmem positions 0-2"] = dm
    # K5 with its context in device memory on the last chunk's pattern (L=32, S=1024),
    # and the large-code decode (N=4096, SCL-32, chunk 64), where every prune is 64 wide
    body32 = SCLBodyProgram(sched32.unique_flags[int(sched32.pattern_ids[-1])], 32)
    g32 = np.random.default_rng(6)
    a32 = torch.from_numpy((2 * g32.standard_normal((256, 32, 1024))).astype(np.float32)).to(dev)
    p32 = -torch.from_numpy(np.abs(g32.standard_normal((256, 32))).astype(np.float32)).to(dev)
    out["K5-devmem L=32 S=1024"] = time_ms(lambda: scl_chunk_body_cuda(a32, p32, body32),
                                           max(2, reps // 4))
    note(*scl_chunk_body_cuda(a32, p32, body32))
    llr64, mask64 = llrs(4096, 2048, 1024, SNR, 92, False)
    dec64 = make_scl_decoder(4096, mask64, 32, chunk=64, device=dev)
    out["SCL-32 N=4096 chunk 64, 1024 frames"] = time_ms(lambda: dec64(llr64), max(2, reps // 4))
    note(*dec64(llr64))
    mega64 = make_scl_decoder(4096, mask64, 32, chunk=64, control_impl="mega", device=dev)
    out["K6 SCL-32 N=4096 chunk 64, 1024 frames"] = time_ms(lambda: mega64(llr64),
                                                            max(2, reps // 4))
    note(*mega64(llr64))
    sched64 = build_scl_schedule(4096, mask64, 32, 64)
    s64, _ = make_step_specs(sched64)

    def state64():
        return SCLState(sched64, llr64[:, rev32].contiguous())

    st64, per64 = state64(), []
    for spec in s64:
        scratch = st64.clone()
        per64.append(time_ms(lambda: scl_chunk_step_cuda(scratch, spec), max(2, reps // 4)))
        scl_chunk_step_cuda(st64, spec)
    note(st64.alpha, st64.beta, st64.pm)
    out["K3 SCL-32 S=64 per position"] = per64
    out["K3 SCL-32 S=64 mean"] = sum(per64) / len(per64)
    if any("profile" in v for v in getattr(build, "VARIANTS", {})):
        sys.path.insert(0, os.getcwd())
        import chip_smoke
        split = {}
        for tag, specs, perm in (("", steps, "rank"), ("fast ", fsteps, "rank"),
                                 ("onehot ", osteps, "onehot")):
            state = SCLState(sched, llr_rev, perm)
            for c, spec in enumerate(specs):
                if c in (3, 4):
                    split[f"{tag}{c}"] = chip_smoke.profile_step(state, spec)
                scl_chunk_step_cuda(state, spec)
        out["profile"] = split
        st64, split64 = state64(), {}
        for c, spec in enumerate(s64):
            if c in (16, 40):
                split64[c] = chip_smoke.profile_step(st64, spec)
            scl_chunk_step_cuda(st64, spec)
        out["profile SCL-32 S=64"] = split64
        if "scl_mega_profile" in build.VARIANTS:
            out["profile K6"] = chip_smoke.profile_mega(llr, scl_cuda.SCLMegaPlan(sched))
        if "scl_last_profile" in build.VARIANTS:
            for tag, specs, last_spec in (("", steps, last), ("-fast", fsteps, flast)):
                state = SCLState(sched, llr_rev)
                for spec in specs:
                    scl_chunk_step_cuda(state, spec)
                out[f"profile K4{tag}"] = chip_smoke.profile_last(state, last_spec)
        if "scl_body_profile" in build.VARIANTS:
            g = np.random.default_rng(12)
            alpha = torch.from_numpy((2 * g.standard_normal((B, L, S))).astype(np.float32)).to(dev)
            pm0 = -torch.from_numpy(np.abs(g.standard_normal((B, L))).astype(np.float32)).to(dev)
            for tag, spec in (("", last), ("-fast", flast), ("-onehot", olast)):
                out[f"profile K5{tag} last chunk's pattern"] = chip_smoke.profile_body(
                    alpha, pm0, spec.program)
    if hasattr(scl_cuda, "kernel_resources"):
        out["resources"] = scl_cuda.kernel_resources(L, S, N, sched.t)


def _narrow_runner(scl_cuda, specs):
    """``run(state)``: the narrow (live-width) positions ``specs`` of a live
    decode, in order, on the state: one ``scl_narrow_prefix`` launch where
    the tree has it, else the single narrow ``scl_chunk_step`` launches back
    to back."""
    if hasattr(scl_cuda, "scl_narrow_prefix_cuda"):
        prefix = scl_cuda.SCLPrefixSpec(specs)
        return lambda state: scl_cuda.scl_narrow_prefix_cuda(state, prefix)
    return lambda state: [scl_cuda.scl_chunk_step_cuda(state, spec) for spec in specs]


def _host_us(fn, calls: int = 200) -> float:
    """Host microseconds a call of ``fn()``, no synchronise inside."""
    import torch

    fn()
    torch.cuda.synchronize()
    t = time.perf_counter()
    for _ in range(calls):
        fn()
    us = (time.perf_counter() - t) / calls * 1e6
    torch.cuda.synchronize()
    return us


def _child_narrow(out, llrs, time_ms, note, reps) -> None:
    """The narrow prefix of the live decodes: the flagship (4096 frames,
    N=1024, L=8, S=128) and the large code (1024 frames, N=4096, L=32,
    S=64), each narrow position alone (one launch) and the whole prefix of a
    decode, by CUDA events and by profiler device time; the host's
    microseconds a launch, split into its parts where the tree has them."""
    import numpy as np
    import torch

    from polarcode_and_ldpc_tpu_torch.models.polar.construction import bit_reverse_permutation
    from polarcode_and_ldpc_tpu_torch.models.polar.scanscl import build_scl_schedule
    from polarcode_and_ldpc_tpu_torch.ops import scl_cuda
    from polarcode_and_ldpc_tpu_torch.ops.scl_cuda import SCLState, make_step_specs

    for tag, (n, k, lsz, s, frames, seed, crc) in (
            ("flagship", (N, K, L, S, B, 77, True)),
            ("SCL-32 N=4096", (4096, 2048, 32, 64, 1024, 92, False))):
        llr, mask = llrs(n, k, frames, SNR, seed, crc)
        sched = build_scl_schedule(n, mask, lsz, s)
        rev = torch.as_tensor(np.asarray(bit_reverse_permutation(n)), dtype=torch.int64,
                              device=llr.device)
        state = SCLState(sched, llr[:, rev].contiguous())
        specs, _ = make_step_specs(sched, live=True)
        if isinstance(specs[0], getattr(scl_cuda, "SCLPrefixSpec", ())):
            narrow = specs[0].steps  # the tree's live specs begin with their narrow prefix
        else:
            narrow = [spec for spec in specs if spec.narrow]
            assert specs[:len(narrow)] == narrow, "the narrow positions are not a prefix"
        events, device, seen = [], [], []
        for spec in narrow:  # each position alone, on the state it starts from
            one, scratch = _narrow_runner(scl_cuda, [spec]), state.clone()
            events.append(time_ms(lambda: one(scratch)))
            ms, kernels = _device_ms(lambda: one(scratch), reps)
            device.append(ms)
            seen.append(kernels)
            one(state)
            note(state.alpha, state.beta, state.pend_a, state.pend_b, state.pm)
        out[f"narrow {tag} per position events"] = events
        out[f"narrow {tag} per position device"] = device
        out[f"narrow {tag} per position kernels per call"] = seen
        out[f"narrow {tag} positions"] = len(narrow)
        state = SCLState(sched, llr[:, rev].contiguous())
        run = _narrow_runner(scl_cuda, narrow)
        scratch = state.clone()
        out[f"narrow {tag} per decode events"] = time_ms(lambda: run(scratch))
        (out[f"narrow {tag} per decode device"],
         out[f"narrow {tag} per decode kernels per call"]) = _device_ms(lambda: run(scratch), reps)
        run(state)
        note(state.alpha, state.beta, state.pend_a, state.pend_b, state.pm)
        out[f"narrow {tag} per decode host us"] = _host_us(lambda: run(scratch))
        # one launch's host work, and three of its parts: the state's checks,
        # the launch plan, the node program's device copy (the rest is the
        # ctypes call and its arguments)
        first = narrow[0]
        one = _narrow_runner(scl_cuda, [first])
        split = {"whole launch": lambda: one(scratch),
                 "checks": lambda: scl_cuda._check_state(scratch, first.program)}
        split["launch plan"] = lambda: scl_cuda._context_plan(lsz, s, 0, frames, llr.device)
        split["program on the device"] = lambda: first.program.device_ops(llr.device)
        out[f"narrow {tag} host us split"] = {name: _host_us(fn) for name, fn in split.items()}


def _child_fastnode(out, time_ms, note, reps) -> None:
    """K7 (``fastnode_select``) by CUDA events and by profiler device time at
    the flagship's node shape [8, 128, 4096] (K = 7, the probe's K), and at
    [32, 128, 4096] with K = 31 (a list of 32, L − 1)."""
    import torch

    from polarcode_and_ldpc_tpu_torch.ops.fastnode_cuda import fastnode_select_cuda

    for lsz, s, frames, k in ((8, 128, 4096, 7), (32, 128, 4096, 31)):
        a = (2 * torch.randn((lsz, s, frames), generator=torch.Generator().manual_seed(5))).cuda()
        key = f"K7 [{lsz}, {s}, {frames}] K={k}"
        out[f"{key} events"] = time_ms(lambda: fastnode_select_cuda(a, k))
        out[f"{key} device"], out[f"{key} kernels per call"] = _device_ms(
            lambda: fastnode_select_cuda(a, k), reps)
        note(*fastnode_select_cuda(a, k))


def _child_bp(out, time_ms, note) -> None:
    import numpy as np
    import torch

    import polarcode_and_ldpc_tpu_torch as fec
    from polarcode_and_ldpc_tpu_torch.models.ldpc.graph import TannerGraph
    from polarcode_and_ldpc_tpu_torch.ops import bp_cuda

    dev = "cuda"
    rows = {"bp": ("bp", 1.0, "flooding"), "nms": ("ms", 0.75, "flooding"),
            "layered nms": ("ms", 0.75, "layered")}

    def llrs(n, frames, snr, seed):
        std = float(np.sqrt(1.0 / (2.0 * 10 ** (snr / 10.0))))
        z = np.random.default_rng(seed).standard_normal((frames, n), dtype=np.float32)
        return (2.0 * (1.0 + std * torch.from_numpy(z).to(dev)) / (std * std)).contiguous()

    def run(label, graph, x, which, reps=20):
        for name in which:
            rule, alpha, schedule = rows[name]
            plan = bp_cuda.BPKernelPlan(graph, 20, True, rule, alpha, 0.0, schedule, 4)
            key = f"K2 {name} {label}"
            out[key] = time_ms(lambda: bp_cuda.bp_decode_cuda(x, plan), reps)
            bits, iters = bp_cuda.bp_decode_cuda(x, plan)
            note(bits, iters)
            out[f"{key}: plan"] = {
                "device_memory": plan.device_memory, "mean_iterations": float(
                    iters.float().mean()), "threads": getattr(plan, "threads", 256),
                "resident_blocks_per_sm": (bp_cuda.resident_blocks_per_sm(plan) if hasattr(
                    bp_cuda, "resident_blocks_per_sm") else None)}

    mackay = {n: TannerGraph.from_H(fec.mackay_construction(n, n // 2, 3, 6, seed=42), dev)
              for n in (8192, 4096)}
    x8192 = llrs(8192, 1024, 3.0, 70)
    run("n=8192", mackay[8192], x8192, rows)
    run("n=4096", mackay[4096], llrs(4096, 256, 0.0, 71), ("nms", "layered nms"))
    g504 = TannerGraph.from_H(fec.LDPCEncoder(504, 252, dv=3, dc=6, seed=42, device=dev).H, dev)
    run("n=504", g504, llrs(504, 4096, 3.0, 72), rows, reps=100)
    # one frame: the launch's host work, not the decode, sets the time
    run("n=504 B=1", g504, llrs(504, 1, 3.0, 74), ("nms",), reps=500)
    dense = TannerGraph.from_H(fec.mackay_construction(4096, 2048, 16, 32, seed=42), dev)
    run("cw16 (device memory)", dense, llrs(4096, 256, 3.0, 73), rows)
    limit, bp_cuda.SMEM_LIMIT_BYTES = bp_cuda.SMEM_LIMIT_BYTES, 0
    run("n=8192 (device memory forced)", mackay[8192], x8192, rows)
    bp_cuda.SMEM_LIMIT_BYTES = limit


def _child_sc(out, llrs, time_ms, note, variants) -> None:
    import numpy as np
    import torch

    from polarcode_and_ldpc_tpu_torch.models.polar.construction import bit_reverse_permutation
    from polarcode_and_ldpc_tpu_torch.models.polar.trellis import f_minsum
    from polarcode_and_ldpc_tpu_torch.ops import sc_mega_cuda as scm

    llr, mask = llrs(N, K, 16384, SNR, 11, False)
    programs = {"K1 N=1024 16384 frames": scm.SCProgram(N, mask),
                "K1 N=1024 16384 frames, no fast nodes": scm.SCProgram(N, mask, fast_nodes=False)}
    for name, prog in programs.items():
        out[name] = time_ms(lambda: scm.sc_decode_cuda(llr, prog))
        out[f"{name}: ops"] = int(prog.ops.shape[0])
        note(scm.sc_decode_cuda(llr, prog))
    n32, k32, b32 = 32768, 16384, 1024
    llr32, mask32 = llrs(n32, k32, b32, SNR, 40, False)
    dec = scm.make_sc_decoder_mega(n32, mask32)
    sub_n = dec.sub_n
    rev = torch.as_tensor(np.asarray(bit_reverse_permutation(n32)), device=llr32.device)
    a = llr32[:, rev]
    alpha_l = f_minsum(a[:, :sub_n], a[:, sub_n:]).contiguous()
    beta_l = scm.sc_decode_cuda(alpha_l, dec.programs[0])
    alpha_r = (a[:, sub_n:] + (1.0 - 2.0 * beta_l.to(torch.float32)) * a[:, :sub_n]).contiguous()
    subtrees = {"left": (alpha_l, dec.programs[0]), "right": (alpha_r, dec.programs[sub_n])}
    beta = {}
    for side, (alpha, prog) in subtrees.items():
        out[f"K1-hybrid {side} subtree"] = time_ms(lambda: scm.sc_decode_cuda(alpha, prog))
        out[f"K1-hybrid {side} subtree: ops"] = int(prog.ops.shape[0])
        beta[side] = scm.sc_decode_cuda(alpha, prog)
        note(beta[side])
    out["K1-hybrid subtree mean"] = (out["K1-hybrid left subtree"]
                                     + out["K1-hybrid right subtree"]) / 2
    out["K1-hybrid whole decode N=32768"] = time_ms(lambda: dec(llr32))
    note(dec(llr32))
    if hasattr(scm, "launch_plan"):
        out["K1-hybrid plan"] = scm.launch_plan(dec.programs[0], b32, 0)._asdict()
        out["K1 plan"] = scm.launch_plan(programs["K1 N=1024 16384 frames"], 16384, 0)._asdict()
        # a subtree frame on one, two or four warps
        for w in (1, 2, 4):
            scm.SUBTREE_WARPS_PER_FRAME, keep = w, scm.SUBTREE_WARPS_PER_FRAME
            for side, (alpha, prog) in subtrees.items():
                out[f"K1-hybrid {side} subtree, {w} warps per frame"] = time_ms(
                    lambda: scm.sc_decode_cuda(alpha, prog))
                if not torch.equal(scm.sc_decode_cuda(alpha, prog), beta[side]):
                    raise AssertionError(f"{side} subtree on {w} warps per frame differs")
            scm.SUBTREE_WARPS_PER_FRAME = keep
    if "sc_decode_profile" in variants:
        sys.path.insert(0, os.getcwd())
        import chip_smoke
        out["sc profile"] = {
            "K1 N=1024": chip_smoke.profile_sc(llr, programs["K1 N=1024 16384 frames"]),
            **{f"N=32768 {side} subtree": chip_smoke.profile_sc(alpha, prog)
               for side, (alpha, prog) in subtrees.items()}}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--tree", action="append", default=[], help="name=dir")
    ap.add_argument("--order", default="")
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--parts", default="scl,sc,roll",
                    help="of scl, narrow, fastnode, sc, roll, bp")
    ap.add_argument("--child", action="store_true")
    ap.add_argument("--out", default="build/scl_kernel_ab.json")
    args = ap.parse_args()
    if args.child:
        print("AB_RESULT " + json.dumps(_child(args.reps, tuple(args.parts.split(",")))),
              flush=True)
        return 0
    trees = dict(t.split("=", 1) for t in args.tree)
    runs = []
    for name in args.order.split(","):
        root = Path(trees[name]).resolve()
        env = {**os.environ, "PYTHONPATH": str(root),
               "POLAR_LDPC_TORCH_BUILD_DIR": str(root / "build" / "ab")}
        proc = subprocess.run([sys.executable, str(Path(__file__).resolve()), "--child",
                               "--reps", str(args.reps), "--parts", args.parts], cwd=root, env=env,
                              capture_output=True, text=True, timeout=1500)
        if proc.returncode != 0:
            print(proc.stdout[-4000:], proc.stderr[-8000:], file=sys.stderr)
            raise SystemExit(f"the {name} run failed (exit {proc.returncode})")
        line = [x for x in proc.stdout.splitlines() if x.startswith("AB_RESULT ")][-1]
        runs.append((name, json.loads(line[len("AB_RESULT "):])))
        print(json.dumps({"run": name, **runs[-1][1]}), flush=True)
    digests = {r["digest"] for _, r in runs}
    summary = {}
    for key in dict.fromkeys(k for _, r in runs for k, v in r.items() if isinstance(v, float)):
        by = {}
        for name, r in runs:
            if isinstance(r.get(key), float):
                by.setdefault(name, []).append(r[key])
        summary[key] = by
    names = list(dict.fromkeys(n for n, _ in runs))
    if len(names) > 1:
        base = names[0]
        for key, by in summary.items():
            mean = {n: sum(v) / len(v) for n, v in by.items()}
            for n in names[1:]:
                if base in mean and mean.get(n):
                    by[f"{base}/{n}"] = mean[base] / mean[n]
    out = Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps({"runs": runs, "summary": summary}, indent=1))
    print(json.dumps({"summary": summary, "digests_equal": len(digests) == 1}), flush=True)
    if len(digests) != 1:
        raise SystemExit(f"the trees' outputs differ: {digests}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
