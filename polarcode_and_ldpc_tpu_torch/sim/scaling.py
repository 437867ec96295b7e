"""Frame-throughput scaling study: decoded frames per second at 1, 2, 4, …
devices with the frame count per device held constant (weak scaling, the
regime of Monte-Carlo, where the total frames grow with the fleet).

Every rank of the process group (one process per device) calls
``measure_scaling`` alike; each point runs on the sub-mesh of the first
``devices`` ranks while the others wait, and its time is that of the slowest
rank in it.
"""

from __future__ import annotations

import time
from typing import Callable, Optional, Sequence

import torch
import torch.distributed as dist

from ..core import rng
from ..parallel.mesh import all_reduce, default_mesh, frame_sharding


def measure_scaling(
    step_fn: Callable,
    frames_per_device: int = 256,
    device_counts: Optional[Sequence[int]] = None,
    iters: int = 5,
    warmup: int = 2,
) -> dict:
    """Weak-scaling sweep over sub-meshes of the group's ranks.

    ``step_fn(root_key, frame_ids)`` is a Monte-Carlo step built on this
    rank's device (``sim.pipelines``).  Without a process group this process
    is a group of one.  Returns the JAX package's keys: per size the wall
    time of one step, frames/s, and the speedup and parallel efficiency
    relative to the first size.  The timed window ends after a device
    synchronise and a barrier of the sub-mesh.
    """
    dev = torch.device(getattr(step_fn, "device", "cuda"))
    world = default_mesh(device=dev)  # makes the group of one where there is none
    ranks = world.size()
    if device_counts is None:
        device_counts = [d for d in (1, 2, 4, 8, 16, 32) if d <= ranks]
    key = rng.prng_key(0, dev)
    out: dict = {"frames_per_device": frames_per_device, "points": []}
    base_rate = None
    for nd in device_counts:
        mesh = default_mesh(range(nd), device=dev)
        dt = 0.0
        if mesh.get_coordinate() is not None:
            group = mesh.get_group(0)
            batch = frames_per_device * nd
            ids = frame_sharding(mesh).local(torch.arange(batch, device=dev))
            with torch.no_grad():
                for _ in range(warmup):
                    step_fn(key, ids)
                _sync(dev)
                dist.barrier(group=group)
                t0 = time.perf_counter()
                for _ in range(iters):
                    step_fn(key, ids)
                _sync(dev)
                dist.barrier(group=group)
                dt = (time.perf_counter() - t0) / iters
        # every rank learns the point's time (the slowest rank's) and stays in step
        dt = float(all_reduce(torch.tensor([dt], dtype=torch.float64), world.get_group(0),
                              dist.ReduceOp.MAX))
        batch = frames_per_device * nd
        rate = batch / dt
        if base_rate is None:
            base_rate = rate
        out["points"].append({
            "devices": nd,
            "batch": batch,
            "seconds": dt,
            "frames_per_second": rate,
            "speedup": rate / (base_rate / device_counts[0]),
            "efficiency": rate / (base_rate * nd / device_counts[0]),
        })
    return out


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
