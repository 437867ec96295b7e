"""Tracing and profiling: fenced wall-clock spans, a ``torch.profiler`` trace,
and a decoded-bits-per-second counter.

* ``Timer`` / ``timed_span``: named host-clock spans; a span given a
  ``fence`` tensor waits for that tensor's device before it stops the clock,
  so the device work is counted;
* ``profile_trace``: ``torch.profiler`` over a block (host and, on a CUDA
  device, kernel events), written as a Chrome trace into a directory (open it
  in Perfetto or ``chrome://tracing``);
* ``DecodeRateCounter``: decoded bits per second, and per device;
* ``trace_sc_trellis``: the step-by-step SC trellis dump of one frame, from
  the float64 NumPy twin (``parity.polar_np``).
"""

from __future__ import annotations

import contextlib
import os
import tempfile
import time
from dataclasses import dataclass, field
from pathlib import Path
from typing import Dict, List, Optional

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile


def _fence(fence) -> None:
    """Wait for the devices of the tensors in ``fence`` (a tensor, or a
    tuple / list / dict of them)."""
    if isinstance(fence, dict):
        fence = list(fence.values())
    for t in fence if isinstance(fence, (list, tuple)) else (fence,):
        if isinstance(t, torch.Tensor) and t.is_cuda:
            torch.cuda.synchronize(t.device)


@dataclass
class Timer:
    """Named wall-clock spans with device fencing."""

    spans: Dict[str, List[float]] = field(default_factory=dict)

    @contextlib.contextmanager
    def span(self, name: str, fence=None):
        """Time the block; with ``fence`` (tensors the block wrote), wait for
        their CUDA device before the clock stops."""
        t0 = time.perf_counter()
        try:
            yield
        finally:
            if fence is not None:
                _fence(fence)
            self.spans.setdefault(name, []).append(time.perf_counter() - t0)

    def total(self, name: str) -> float:
        return sum(self.spans.get(name, []))

    def mean(self, name: str) -> float:
        s = self.spans.get(name, [])
        return sum(s) / len(s) if s else 0.0

    def report(self) -> dict:
        return {name: {"total_s": self.total(name), "mean_s": self.mean(name),
                       "count": len(s)} for name, s in self.spans.items()}


@contextlib.contextmanager
def timed_span(name: str = "span", verbose: bool = True):
    """Simple span: ``with timed_span("decode"): ...`` prints its ms."""
    t0 = time.perf_counter()
    yield
    dt = time.perf_counter() - t0
    if verbose:
        print(f"[{name}] {dt * 1e3:.2f} ms")


@contextlib.contextmanager
def profile_trace(logdir: Optional[str] = None):
    """``torch.profiler`` over the block, host events and, where CUDA is
    available, kernel events; on exit the trace is written as a Chrome trace
    ``trace_<pid>_<ns>.json`` into ``logdir`` (by default ``fec_trace`` in
    the temporary directory).  Yields the directory."""
    path = Path(logdir or os.path.join(tempfile.gettempdir(), "fec_trace"))
    path.mkdir(parents=True, exist_ok=True)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        yield path
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    prof.export_chrome_trace(str(path / f"trace_{os.getpid()}_{time.time_ns()}.json"))


@dataclass
class DecodeRateCounter:
    """Decoded bits per second, and per device (``chips``)."""

    bits: int = 0
    seconds: float = 0.0
    chips: int = 1

    def add(self, frames: int, bits_per_frame: int, seconds: float) -> None:
        self.bits += frames * bits_per_frame
        self.seconds += seconds

    @property
    def mbps(self) -> float:
        return self.bits / self.seconds / 1e6 if self.seconds > 0 else 0.0

    @property
    def mbps_per_chip(self) -> float:
        return self.mbps / max(1, self.chips)


decode_rate_counter = DecodeRateCounter  # the JAX package's other name


def trace_sc_trellis(llr: np.ndarray, frozen_mask: np.ndarray) -> dict:
    """Step-by-step SC trellis dump of one frame.

    Runs the NumPy twin one leaf at a time and records the full ``[N, n+1]``
    L / B matrices after each decision (entries not yet written are NaN) —
    the ground-truth trace for debugging any decoder discrepancy.  Returns
    ``{"u": [N] int64, "steps": [{"step", "leaf", "frozen", "decision_llr",
    "bit", "L", "B"}, ...]}``.
    """
    from ..models.polar.construction import bit_reverse
    from ..parity import polar_np

    llr = np.asarray(llr, np.float64)
    N = llr.size
    n = int(np.log2(N))
    L = np.full((N, n + 1), np.nan)
    B = np.full((N, n + 1), np.nan)
    L[:, 0] = llr
    steps = []
    for i in range(N):
        leaf = bit_reverse(i, n)
        polar_np._update_llrs(L, B, leaf, n, N)
        if frozen_mask[leaf]:
            B[leaf, n] = 0
        else:
            B[leaf, n] = 0 if L[leaf, n] >= 0 else 1
        polar_np._update_bits(B, leaf, n)
        steps.append({"step": i, "leaf": leaf,
                      "frozen": bool(frozen_mask[leaf]),
                      "decision_llr": float(L[leaf, n]),
                      "bit": int(B[leaf, n]),
                      "L": L.copy(), "B": B.copy()})
    return {"u": B[:, n].astype(np.int64), "steps": steps}
