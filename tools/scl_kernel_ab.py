#!/usr/bin/env python3
"""Parent against change for the port's list-decode kernels, in one run on one
NVIDIA GPU.

    python3 tools/scl_kernel_ab.py --tree parent=<dir> --tree change=. \\
        --order parent,change,change,parent

Each ``--tree name=dir`` is a checkout of the repo (``git archive`` of a
commit unpacked into a directory that ``.gitignore`` lists, or the working
tree).  For each name in ``--order`` the script runs itself with
``--child`` in a fresh process that imports ``polarcode_and_ldpc_tpu_torch``
from that tree and builds its kernels into ``<dir>/build/ab`` (the trees do
not share a build).  A child times, by CUDA events after a warm-up, at the
flagship shape (4096 frames, N=1024, K=512, chunk S=128, list L=8, 3 dB) and
prints one JSON line:

* K3 (``scl_chunk_step``) at each of the seven chunk positions on the state
  the kernel decode reaches, full width, and its mean; K3 with fast node
  programs, with one-hot pendings, the two narrow (live-width) launches of
  the live decode; K4 in the same three modes; K5 on the eight chunk
  patterns, with fast and with one-hot programs too; K6 (the one-launch decode);
* whole decodes of the flagship (``unroll-kernel``, live width, CRC-free
  decoder of ``make_scl_decoder``) and of JAX's SCL-8 benchmark shape (8192
  frames, chunk 128, rank and one-hot);
* K3 with the chunk context in device memory (256 frames, N=4096, S=1024,
  L=32, positions 0–2), K5 so on the last chunk's pattern, and the large-code
  decode (1024 frames, N=4096, L=32, chunk 64);
* a digest of every decode's paths and metrics, so that the trees' outputs
  can be compared bit for bit;
* K3 of the large-code decode at each of its 63 chunk positions (N=4096,
  S=64, L=32: every prune 64 candidates wide, no ``OP_SUBTREE``), and its mean;
* the stage profile of K3 at flagship positions 3 and 4 and at the large-code
  decode's positions 16 and 40 where the tree has the
  profiled build (``ops/build.py`` ``VARIANTS``), and the kernels'
  registers, spills and resident warps per SM where it has
  ``scl_cuda.kernel_resources``.

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


def _child(reps: int) -> dict:
    import numpy as np
    import torch

    import polarcode_and_ldpc_tpu_torch as fec
    from polarcode_and_ldpc_tpu_torch.models.polar.construction import (
        bit_reverse_permutation, frozen_mask_from_positions)
    from polarcode_and_ldpc_tpu_torch.models.polar.scanscl import build_scl_schedule
    from polarcode_and_ldpc_tpu_torch.models.polar.scl import make_scl_decoder
    from polarcode_and_ldpc_tpu_torch.ops import build, scl_cuda
    from polarcode_and_ldpc_tpu_torch.ops.scl_cuda import (SCLBodyProgram, SCLState,
                                                           make_step_specs, scl_chunk_body_cuda,
                                                           scl_chunk_step_cuda,
                                                           scl_last_chunk_cuda)

    dev = "cuda"
    t0 = time.perf_counter()
    build.build_all(variants=tuple(getattr(build, "VARIANTS", ())))
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
    oprog = [SCLBodyProgram(f, L, perm_impl="onehot") for f in sched.unique_flags]
    osteps, olast = make_step_specs(sched, oprog)
    step_times(osteps, olast, "onehot", tag="-onehot")
    # the narrow launches of the live decode (positions entering below L)
    lsteps, _ = make_step_specs(sched, live=True)
    state = SCLState(sched, llr_rev)
    narrow = []
    for spec in lsteps:
        if spec.narrow:
            scratch = state.clone()
            narrow.append(time_ms(lambda: scl_chunk_step_cuda(scratch, spec)))
        scl_chunk_step_cuda(state, spec)
    note(state.alpha, state.beta, state.pm)
    out["K3-live narrow per launch"] = narrow
    # K5 on each chunk pattern at the level-t alpha of the state
    body = []
    g = np.random.default_rng(5)
    for prog in {id(p): p for p in [s.program for s in steps] + [last.program]}.values():
        alpha = torch.from_numpy((2 * g.standard_normal((B, L, S))).astype(np.float32)).to(dev)
        pm0 = -torch.from_numpy(np.abs(g.standard_normal((B, L))).astype(np.float32)).to(dev)
        body.append(time_ms(lambda: scl_chunk_body_cuda(alpha, pm0, prog)))
        note(*scl_chunk_body_cuda(alpha, pm0, prog))
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
        out[f"K5{tag} mean over patterns"] = sum(times) / len(times)
    # whole decodes
    decs = {"flagship unroll-kernel": make_scl_decoder(N, mask, L, chunk=S, device=dev),
            "flagship fast": make_scl_decoder(N, mask, L, chunk=S, node_mode="fast", device=dev),
            "flagship mega (K6)": make_scl_decoder(N, mask, L, chunk=S, control_impl="mega",
                                                   device=dev)}
    for name, dec in decs.items():
        out[name] = time_ms(lambda: dec(llr))
        note(*dec(llr))
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
    out["digest"] = digest.hexdigest()
    if any("profile" in v for v in getattr(build, "VARIANTS", {})):
        sys.path.insert(0, os.getcwd())
        import chip_smoke
        state = SCLState(sched, llr_rev)
        split = {}
        for c, spec in enumerate(steps):
            if c in (3, 4):
                split[c] = chip_smoke.profile_step(state, spec)
            scl_chunk_step_cuda(state, spec)
        out["profile"] = split
        st64, split64 = state64(), {}
        for c, spec in enumerate(s64):
            if c in (16, 40):
                split64[c] = chip_smoke.profile_step(st64, spec)
            scl_chunk_step_cuda(st64, spec)
        out["profile SCL-32 S=64"] = split64
    if hasattr(scl_cuda, "kernel_resources"):
        out["resources"] = scl_cuda.kernel_resources(L, S, N, sched.t)
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--tree", action="append", default=[], help="name=dir")
    ap.add_argument("--order", default="")
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--child", action="store_true")
    ap.add_argument("--out", default="build/scl_kernel_ab.json")
    args = ap.parse_args()
    if args.child:
        print("AB_RESULT " + json.dumps(_child(args.reps)), flush=True)
        return 0
    trees = dict(t.split("=", 1) for t in args.tree)
    runs = []
    for name in args.order.split(","):
        root = Path(trees[name]).resolve()
        env = {**os.environ, "PYTHONPATH": str(root),
               "POLAR_LDPC_TORCH_BUILD_DIR": str(root / "build" / "ab")}
        proc = subprocess.run([sys.executable, str(Path(__file__).resolve()), "--child",
                               "--reps", str(args.reps)], cwd=root, env=env,
                              capture_output=True, text=True, timeout=1500)
        if proc.returncode != 0:
            print(proc.stdout[-4000:], proc.stderr[-8000:], file=sys.stderr)
            raise SystemExit(f"the {name} run failed (exit {proc.returncode})")
        line = [x for x in proc.stdout.splitlines() if x.startswith("AB_RESULT ")][-1]
        runs.append((name, json.loads(line[len("AB_RESULT "):])))
        print(json.dumps({"run": name, **runs[-1][1]}), flush=True)
    digests = {r["digest"] for _, r in runs}
    summary = {}
    for key, val in runs[0][1].items():
        if isinstance(val, float):
            by = {}
            for name, r in runs:
                by.setdefault(name, []).append(r[key])
            summary[key] = {n: v for n, v in by.items()}
    names = list(dict.fromkeys(n for n, _ in runs))
    if len(names) > 1:
        base = names[0]
        for key, by in summary.items():
            mean = {n: sum(v) / len(v) for n, v in by.items()}
            for n in names[1:]:
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
