"""Shared CLI plumbing: device, seed and output flags."""

from __future__ import annotations

import argparse


def add_common_args(parser: argparse.ArgumentParser) -> None:
    parser.add_argument("--device", default="cuda",
                        help="torch device to run on (default: cuda; cpu runs the plain "
                             "versions of the kernels)")
    parser.add_argument("--host-devices", type=int, default=0,
                        help="simulated devices: not in this package yet")
    parser.add_argument("--mesh", action="store_true",
                        help="shard frames over all visible devices: not in this package yet")
    parser.add_argument("--distributed", action="store_true",
                        help="multi-host run: not in this package yet")
    parser.add_argument("--seed", type=int, default=42)
    parser.add_argument("--output-dir", default="results")


def check_common_args(args) -> None:
    """Refuse the multi-device flags: frames sharded over devices are not in
    this package yet."""
    for flag, on in (("--host-devices", args.host_devices), ("--mesh", args.mesh),
                     ("--distributed", args.distributed)):
        if on:
            raise NotImplementedError(f"{flag} (frames sharded over devices) is not in this "
                                      "package yet")


def parse_snr_range(spec: str):
    """``start:stop:step`` → ``(start, stop, step)``."""
    start, stop, step = (float(x) for x in spec.split(":"))
    return start, stop, step
