"""Chunked Monte-Carlo engine with reference early-stop semantics.

The device processes fixed-size chunks of frames; the host inspects per-frame
results *in frame order* and reproduces the exact accounting of a
frame-at-a-time loop that breaks when ``max_errors`` frame errors accumulate:
``frames_tested`` includes every frame up to and including the one that
crossed ``max_errors``.

Periodic accumulator checkpointing lets long runs resume: the accumulated
counters plus the next global frame id fully determine the rest of the run,
because per-frame randomness derives from global frame ids.
"""

from __future__ import annotations

import json
import time
from dataclasses import dataclass
from pathlib import Path
from typing import Callable, Optional

import numpy as np
import torch

from ..core import rng
from ..core.device import resolve_device
from ..utils.metrics import wilson_confidence_interval


@dataclass
class ChunkStats:
    """Per-chunk device outputs, materialized on host."""

    bit_errors: np.ndarray   # [B] int32
    frame_error: np.ndarray  # [B] bool
    iterations: Optional[np.ndarray] = None  # [B] int32 (LDPC)


@dataclass
class MonteCarloResult:
    """Accumulated simulation result."""

    frames: int
    bit_errors: int
    frame_errors: int
    bits_per_frame: int
    elapsed_seconds: float
    total_iterations: int = 0
    iteration_frames: int = 0

    @property
    def ber(self) -> float:
        total = self.frames * self.bits_per_frame
        return self.bit_errors / total if total else 0.0

    @property
    def fer(self) -> float:
        return self.frame_errors / self.frames if self.frames else 0.0

    @property
    def avg_iterations(self) -> float:
        return (self.total_iterations / self.iteration_frames
                if self.iteration_frames else 0.0)

    @property
    def throughput_mbps(self) -> float:
        if self.elapsed_seconds <= 0:
            return 0.0
        return self.frames * self.bits_per_frame / self.elapsed_seconds / 1e6

    def ber_confidence(self, confidence: float = 0.95):
        return wilson_confidence_interval(
            self.bit_errors, self.frames * self.bits_per_frame, confidence)

    def to_dict(self) -> dict:
        return {
            "frames": self.frames,
            "bit_errors": self.bit_errors,
            "frame_errors": self.frame_errors,
            "bits_per_frame": self.bits_per_frame,
            "ber": self.ber,
            "fer": self.fer,
            "avg_iterations": self.avg_iterations,
            "elapsed_seconds": self.elapsed_seconds,
            "throughput_mbps": self.throughput_mbps,
        }


class _Pending:
    """One dispatch in flight: per-chunk outputs on their way to the host."""

    def __init__(self, outs: list, device: torch.device):
        self.event = None
        if device.type == "cuda":
            # copy into pinned host memory on the compute stream and mark the
            # end with an event: the fetch then waits for THIS dispatch only,
            # not for the next one queued behind it
            self.host = [{k: torch.empty(v.shape, dtype=v.dtype, pin_memory=True)
                          .copy_(v, non_blocking=True) for k, v in o.items()}
                         for o in outs]
            self.event = torch.cuda.Event()
            self.event.record()
        else:
            self.host = outs

    def fetch(self) -> list:
        if self.event is not None:
            self.event.synchronize()
        return [{k: v.numpy() for k, v in o.items()} for o in self.host]


class MonteCarloSimulator:
    """Run a Monte-Carlo step over chunks of frames on one device.

    Args:
        step_fn: ``(root_key, frame_ids [B]) → {"bit_errors": [B],
            "frame_error": [B], ("iterations": [B])}`` — built by
            ``sim.pipelines``.
        bits_per_frame: message bits counted per frame (BER denominator).
        chunk_frames: device batch size per step; the final partial chunk is
            masked on the host.
        reduction: ``"per_frame"`` (default — per-frame results cross to the
            host and the early stop is trimmed there) or ``"scalar"`` (the
            step is wrapped by ``pipelines.reduce_step`` so only scalar
            counters cross; when they cross ``max_errors`` the crossing
            chunk is recomputed once through an on-device frame-order prefix
            trim, so both modes report identical frames / errors).
        chunks_per_dispatch: device chunks executed per host synchronisation
            (a loop of steps queued before one fetch).  Accounting is
            unchanged — results come back per sub-chunk, accumulated in
            frame order — at the cost of up to ``chunks_per_dispatch−1``
            chunks of discarded device work when an early stop crosses
            mid-dispatch.
        device: where the root key and frame ids are made; defaults to the
            step's own device (``step_fn.device``), else ``"cuda"``.
    """

    def __init__(
        self,
        step_fn: Callable,
        bits_per_frame: int,
        chunk_frames: int = 1024,
        reduction: str = "per_frame",
        chunks_per_dispatch: int = 1,
        device=None,
    ):
        if device is None:
            device = getattr(step_fn, "device", "cuda")
        self.device = resolve_device(device)
        self.chunk_frames = chunk_frames
        self.bits_per_frame = bits_per_frame
        assert reduction in ("per_frame", "scalar")
        self.reduction = reduction
        self._trim = None
        if reduction == "scalar":
            from .pipelines import reduce_step

            # exact-crossing trim: when the scalar counters cross
            # max_errors, the crossing chunk is recomputed once with an
            # on-device frame-order prefix scan so the accounting matches
            # per_frame mode exactly
            raw_step = step_fn

            def trim(root_key, frame_ids, remaining, take_frames, *extra):
                out = raw_step(root_key, frame_ids, *extra)
                fe = out["frame_error"].to(torch.int32)
                cum = torch.cumsum(fe, dim=0)
                # frames strictly before the crossing, plus the crossing
                # frame itself — AND within the first ``take_frames`` of the
                # chunk (the final partial chunk of a ``num_frames`` budget
                # that is not a chunk multiple)
                idx = torch.arange(fe.shape[0], device=fe.device)
                mask = ((cum - fe) < remaining) & (idx < take_frames)
                red = {
                    "take": mask.sum(dtype=torch.int64),
                    "bit_errors": (out["bit_errors"] * mask).sum(dtype=torch.int64),
                    "frame_errors": (fe * mask).sum(dtype=torch.int64),
                }
                if "iterations" in out:
                    red["iterations"] = (out["iterations"] * mask).sum(dtype=torch.int64)
                return red

            self._trim = trim
            step_fn = reduce_step(step_fn)
        self._step = step_fn
        assert chunks_per_dispatch >= 1
        self.chunks_per_dispatch = chunks_per_dispatch

    def _frame_ids(self, start: int) -> torch.Tensor:
        return torch.arange(start, start + self.chunk_frames, dtype=torch.int64,
                            device=self.device)

    def _dispatch_chunk(self, root_key, start: int, extra_args: tuple = ()) -> _Pending:
        """Queue one dispatch (1+ chunks) and its copy to the host; returns
        without waiting for the device."""
        with torch.no_grad():
            outs = [self._step(root_key, self._frame_ids(start + j * self.chunk_frames),
                               *extra_args)
                    for j in range(self.chunks_per_dispatch)]
        return _Pending(outs, self.device)

    def _fetch_chunk(self, pending: _Pending):
        """Materialize one dispatch → list of per-chunk stats, frame order."""
        host = pending.fetch()
        if self.reduction == "scalar":
            return [{k: int(v) for k, v in h.items()} for h in host]
        return [ChunkStats(h["bit_errors"], h["frame_error"], h.get("iterations"))
                for h in host]

    def _accumulate_scalar(self, acc: "MonteCarloResult", stats: dict, sign: int = 1) -> None:
        acc.frames += sign * self.chunk_frames
        acc.bit_errors += sign * stats["bit_errors"]
        acc.frame_errors += sign * stats["frame_errors"]
        if "iterations" in stats:
            acc.total_iterations += sign * stats["iterations"]
            acc.iteration_frames += sign * self.chunk_frames

    def _trim_crossing(self, acc: "MonteCarloResult", root_key, start: int,
                       remaining: int, extra_args: tuple,
                       take_frames: Optional[int] = None) -> int:
        """Recompute the crossing/partial chunk with in-order trim; returns
        the number of frames accounted (up to and including the frame that
        crossed ``max_errors``, and never beyond the first ``take_frames``
        of the chunk)."""
        if take_frames is None:
            take_frames = self.chunk_frames
        with torch.no_grad():
            red = self._trim(root_key, self._frame_ids(start), remaining,
                             take_frames, *extra_args)
        out = {k: int(v) for k, v in red.items()}
        take = out["take"]
        acc.frames += take
        acc.bit_errors += out["bit_errors"]
        acc.frame_errors += out["frame_errors"]
        if "iterations" in out:
            acc.total_iterations += out["iterations"]
            acc.iteration_frames += take
        return take

    def run(
        self,
        num_frames: int,
        max_errors: Optional[int] = None,
        seed: int = 0,
        start_frame: int = 0,
        checkpoint_path: Optional[str | Path] = None,
        checkpoint_every_chunks: int = 50,
        extra_args: tuple = (),
    ) -> MonteCarloResult:
        """Simulate up to ``num_frames`` frames, stopping early once
        ``max_errors`` frame errors accumulate.

        ``extra_args`` is forwarded to the step after ``(key, frame_ids)`` —
        runtime channel parameters (e.g. a ``snr_db`` scalar for runtime-SNR
        pipelines)."""
        root_key = rng.prng_key(seed, self.device)
        acc = MonteCarloResult(frames=0, bit_errors=0, frame_errors=0,
                               bits_per_frame=self.bits_per_frame,
                               elapsed_seconds=0.0)
        offset = start_frame
        if checkpoint_path is not None:
            loaded = self._load_checkpoint(checkpoint_path, seed)
            if loaded is not None:
                acc, offset = loaded
        if max_errors is not None and acc.frame_errors >= max_errors:
            return acc  # resumed run already crossed the early-stop threshold
        t0 = time.perf_counter()
        chunk_idx = 0
        # double-buffered dispatch pipeline: dispatch k+1 is queued before
        # dispatch k's results are fetched and accounted, so the device never
        # idles during host-side accounting/transfers.  A dispatch carries
        # ``chunks_per_dispatch`` device chunks; accounting walks them in
        # frame order, so the exact semantics are per chunk regardless.
        dispatch_frames = self.chunk_frames * self.chunks_per_dispatch
        pending = (self._dispatch_chunk(root_key, offset, extra_args)
                   if num_frames else None)
        pending_offset = offset
        while acc.frames < num_frames:
            next_offset = pending_offset + dispatch_frames
            may_continue = acc.frames + dispatch_frames < num_frames
            nxt = (self._dispatch_chunk(root_key, next_offset, extra_args)
                   if may_continue else None)
            stop = False
            for j, stats in enumerate(self._fetch_chunk(pending)):
                sub_start = pending_offset + j * self.chunk_frames
                take = min(self.chunk_frames, num_frames - acc.frames)
                if self.reduction == "scalar":
                    if take < self.chunk_frames:
                        # final partial chunk of a num_frames budget that is
                        # not a chunk multiple: the reduced scalars cover
                        # the whole chunk — recompute with the in-order
                        # count trim so exactly ``take`` frames are
                        # accounted (matching per_frame mode)
                        remaining = (max_errors - acc.frame_errors
                                     if max_errors is not None
                                     else self.chunk_frames + 1)
                        offset = sub_start + self._trim_crossing(
                            acc, root_key, sub_start, remaining,
                            extra_args, take_frames=take)
                    else:
                        self._accumulate_scalar(acc, stats)
                        offset = sub_start + self.chunk_frames
                        if (max_errors is not None
                                and acc.frame_errors >= max_errors):
                            # exact accounting: roll the crossing chunk
                            # back, recompute with the on-device trim
                            self._accumulate_scalar(acc, stats, sign=-1)
                            offset = sub_start + self._trim_crossing(
                                acc, root_key, sub_start,
                                max_errors - acc.frame_errors, extra_args)
                else:
                    taken = self._accumulate(acc, stats, take, max_errors)
                    # next un-accounted frame id — NOT the chunk boundary:
                    # a resumed run must re-simulate frames the
                    # crossing/trim dropped, or it would cover a different
                    # frame set
                    offset = sub_start + taken
                if ((max_errors is not None
                     and acc.frame_errors >= max_errors)
                        or acc.frames >= num_frames):
                    stop = True
                    break
            pending, pending_offset = nxt, next_offset
            chunk_idx += 1
            if stop:  # early-stop crossing or num_frames reached
                break
            if pending is None and acc.frames < num_frames:
                pending = self._dispatch_chunk(root_key, pending_offset,
                                               extra_args)
            if (checkpoint_path is not None
                    and chunk_idx % checkpoint_every_chunks == 0):
                acc.elapsed_seconds += time.perf_counter() - t0
                t0 = time.perf_counter()
                self._save_checkpoint(checkpoint_path, seed, acc, offset)
        if self.device.type == "cuda":
            # a dispatch queued ahead of an early stop may still be running
            torch.cuda.synchronize(self.device)
        acc.elapsed_seconds += time.perf_counter() - t0
        if checkpoint_path is not None:
            self._save_checkpoint(checkpoint_path, seed, acc, offset)
        return acc

    @staticmethod
    def _accumulate(acc: MonteCarloResult, stats: ChunkStats, take: int,
                    max_errors: Optional[int]) -> int:
        """Fold one chunk into ``acc``; returns the number of frames actually
        accounted (≤ ``take`` when the early-stop threshold is crossed
        mid-chunk)."""
        fe = stats.frame_error[:take]
        be = stats.bit_errors[:take]
        if max_errors is not None:
            remaining = max_errors - acc.frame_errors
            cum = np.cumsum(fe)
            crossing = np.nonzero(cum >= remaining)[0]
            if crossing.size:
                take = int(crossing[0]) + 1  # include the crossing frame
                fe, be = fe[:take], be[:take]
        acc.frames += take
        acc.bit_errors += int(be.sum())
        acc.frame_errors += int(fe.sum())
        if stats.iterations is not None:
            acc.total_iterations += int(stats.iterations[:take].sum())
            acc.iteration_frames += take
        return take

    # -- checkpoint/resume -----------------------------------------------------
    @staticmethod
    def _save_checkpoint(path, seed, acc: MonteCarloResult, offset: int) -> None:
        payload = {"seed": seed, "next_frame": offset, **acc.to_dict(),
                   "total_iterations": acc.total_iterations,
                   "iteration_frames": acc.iteration_frames}
        p = Path(path)
        p.parent.mkdir(parents=True, exist_ok=True)
        tmp = p.with_suffix(p.suffix + ".tmp")
        tmp.write_text(json.dumps(payload))
        tmp.replace(p)

    def _load_checkpoint(self, path, seed):
        p = Path(path)
        if not p.exists():
            return None
        d = json.loads(p.read_text())
        if d.get("seed") != seed or d.get("bits_per_frame") != self.bits_per_frame:
            return None
        acc = MonteCarloResult(
            frames=d["frames"], bit_errors=d["bit_errors"],
            frame_errors=d["frame_errors"], bits_per_frame=d["bits_per_frame"],
            elapsed_seconds=d["elapsed_seconds"],
            total_iterations=d.get("total_iterations", 0),
            iteration_frames=d.get("iteration_frames", 0),
        )
        return acc, d["next_frame"]
