"""Shared CLI plumbing: device, mesh, seed and output flags, the local rank
launcher, SNR-range parsing.

PyTorch runs one process per device, so the multi-device flags start or
join a ``torch.distributed`` group: ``--distributed`` joins the group that
``torchrun`` describes in the environment, ``--mesh`` without a group starts
one local rank per visible CUDA device, and ``--host-devices N`` starts N
local CPU ranks over gloo.  Every rank runs the CLI; only rank 0 prints and
writes files.
"""

from __future__ import annotations

import argparse
import contextlib
import os
import socket
import subprocess
import sys
import time
from pathlib import Path

import torch
import torch.distributed as dist


def add_common_args(parser: argparse.ArgumentParser) -> None:
    parser.add_argument("--device", default="cuda",
                        help="torch device to run on (default: cuda; cpu runs the plain "
                             "versions of the kernels)")
    parser.add_argument("--host-devices", type=int, default=0,
                        help="start N local CPU ranks over gloo and shard frames over them")
    parser.add_argument("--mesh", action="store_true",
                        help="shard frames over every rank of the group; without a group, "
                             "start one local rank per visible CUDA device")
    parser.add_argument("--distributed", action="store_true",
                        help="join the process group that torchrun describes in the "
                             "environment (RANK, WORLD_SIZE, MASTER_ADDR, MASTER_PORT, "
                             "LOCAL_RANK); implies --mesh")
    parser.add_argument("--seed", type=int, default=42)
    parser.add_argument("--output-dir", default="results")


def run_cli(name: str, args, argv, body):
    """Run ``body(args, mesh)`` as CLI ``name`` (a module of this package).

    Where the flags ask for local ranks that are not there yet
    (``--host-devices``, or ``--mesh`` with several CUDA devices and no
    group), this process starts them and returns ``None`` when they all
    succeeded.  Otherwise it runs the body; ``args.main_rank`` says whether
    this process prints and writes (rank 0, or no group)."""
    ranks = _ranks_to_launch(args)
    if ranks:
        launch_local_ranks(name, argv, ranks, cpu=bool(args.host_devices))
        return None
    if args.distributed:
        join_group(args)
    mesh = get_mesh(args)
    args.main_rank = not dist.is_initialized() or dist.get_rank() == 0
    if args.main_rank:
        return body(args, mesh)
    with open(os.devnull, "w") as sink, contextlib.redirect_stdout(sink):
        return body(args, mesh)


def _ranks_to_launch(args) -> int:
    if args.distributed or dist.is_initialized():
        return 0
    if args.host_devices:
        return args.host_devices
    if args.mesh and torch.device(args.device).type == "cuda" and torch.cuda.device_count() > 1:
        return torch.cuda.device_count()
    return 0


def join_group(args) -> None:
    """Join the group described by the environment (as ``torchrun`` sets
    it): a CUDA rank takes ``cuda:LOCAL_RANK`` and NCCL, or gloo where the
    node has more local ranks than cards (NCCL refuses two ranks on one
    card); a CPU rank takes gloo."""
    dev = torch.device(args.device)
    backend = "gloo"
    if dev.type == "cuda":
        local, count = int(os.environ.get("LOCAL_RANK", 0)), torch.cuda.device_count()
        dev = torch.device("cuda", local % count)
        torch.cuda.set_device(dev)
        if int(os.environ.get("LOCAL_WORLD_SIZE", 1)) <= count:
            backend = "nccl"
        args.device = str(dev)
    if not dist.is_initialized():
        dist.init_process_group(backend, init_method="env://")
    args.mesh = True


def get_mesh(args):
    if not getattr(args, "mesh", False):
        return None
    from ..parallel import default_mesh

    return default_mesh(device=args.device)


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def launch_local_ranks(name: str, argv, ranks: int, cpu: bool) -> None:
    """Run CLI ``name`` once per local rank, with ``--distributed`` and the
    environment ``torchrun`` would give it (``--device cpu`` for CPU ranks),
    and wait for all of them; a rank that fails stops the others and raises."""
    argv = list(sys.argv[1:] if argv is None else argv)
    child_argv, skip = [], False
    for a in argv:
        if skip:
            skip = False
        elif a == "--host-devices":
            skip = True
        elif a != "--mesh" and not a.startswith("--host-devices="):
            child_argv.append(a)
    child_argv += ["--distributed"] + (["--device", "cpu"] if cpu else [])
    root = str(Path(__file__).resolve().parents[2])
    env = dict(os.environ, MASTER_ADDR="localhost", MASTER_PORT=str(free_port()),
               WORLD_SIZE=str(ranks), LOCAL_WORLD_SIZE=str(ranks),
               PYTHONPATH=os.pathsep.join(filter(None, [root, os.environ.get("PYTHONPATH")])))
    procs = [subprocess.Popen([sys.executable, "-m", f"{__package__}.{name}", *child_argv],
                              env=dict(env, RANK=str(r), LOCAL_RANK=str(r)))
             for r in range(ranks)]
    try:
        while True:
            codes = [p.poll() for p in procs]
            failed = [r for r, c in enumerate(codes) if c not in (None, 0)]
            if failed:
                raise RuntimeError(f"{name}: local rank {failed[0]} exited with code "
                                   f"{codes[failed[0]]}")
            if all(c == 0 for c in codes):
                return
            time.sleep(0.1)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()


def parse_snr_range(spec: str):
    """``start:stop:step`` → ``(start, stop, step)``."""
    start, stop, step = (float(x) for x in spec.split(":"))
    return start, stop, step
