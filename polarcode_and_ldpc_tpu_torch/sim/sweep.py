"""SNR sweeps producing the JAX package's result dicts.

A runtime-SNR pipeline (``pipelines.make_*_pipeline(snr_db=None)``) serves
every point of a sweep: the sweep builds ONE simulator and passes each SNR as
a trailing argument of the step.  A builder that needs a concrete SNR gets
one step per point.
"""

from __future__ import annotations

from typing import Callable, Optional, Sequence

from .montecarlo import MonteCarloResult, MonteCarloSimulator


def run_snr_sweep(
    pipeline_builder: Callable[[Optional[float]], Callable],
    bits_per_frame: int,
    snr_points: Sequence[float],
    num_frames: int = 1000,
    max_errors: Optional[int] = 100,
    seed: int = 42,
    chunk_frames: int = 512,
    mesh=None,
    verbose: bool = False,
    chunks_per_dispatch: int = 1,
) -> dict:
    """Run one Monte-Carlo simulation per SNR point.

    Args:
        pipeline_builder: ``snr_db → step_fn`` (see ``sim.pipelines``).  It
            is first called with ``None``; if the returned step advertises
            ``runtime_snr`` (the AWGN channel), one step serves every point.
            Otherwise, or if the builder cannot take ``None`` (``TypeError``
            / ``ValueError``), it builds one step per point.
        mesh: optional ``DeviceMesh``: each point's frames are sharded over
            it (``MonteCarloSimulator(mesh=)``); every rank of the mesh runs
            the sweep and gets the same result.

    Returns ``{"snr_db", "ber", "fer", "frames_tested", "bit_errors",
    "frame_errors", "avg_iterations", "elapsed_seconds", "throughput_mbps"}``,
    one list entry per point.
    """
    shared_sim = None
    try:
        step = pipeline_builder(None)
    except (TypeError, ValueError):
        step = None  # the builder needs a concrete SNR: one step per point
    if getattr(step, "runtime_snr", False):
        shared_sim = MonteCarloSimulator(step, bits_per_frame, chunk_frames=chunk_frames,
                                         mesh=mesh, chunks_per_dispatch=chunks_per_dispatch)

    out = {"snr_db": [], "ber": [], "fer": [], "frames_tested": [],
           "bit_errors": [], "frame_errors": [], "avg_iterations": [],
           "elapsed_seconds": [], "throughput_mbps": []}
    for snr_db in snr_points:
        if shared_sim is not None:
            res: MonteCarloResult = shared_sim.run(
                num_frames, max_errors=max_errors, seed=seed, extra_args=(float(snr_db),))
        else:
            sim = MonteCarloSimulator(pipeline_builder(snr_db), bits_per_frame,
                                      chunk_frames=chunk_frames, mesh=mesh,
                                      chunks_per_dispatch=chunks_per_dispatch)
            res = sim.run(num_frames, max_errors=max_errors, seed=seed)
        out["snr_db"].append(float(snr_db))
        out["ber"].append(res.ber)
        out["fer"].append(res.fer)
        out["frames_tested"].append(res.frames)
        out["bit_errors"].append(res.bit_errors)
        out["frame_errors"].append(res.frame_errors)
        out["avg_iterations"].append(res.avg_iterations)
        out["elapsed_seconds"].append(res.elapsed_seconds)
        out["throughput_mbps"].append(res.throughput_mbps)
        if verbose:
            print(f"  SNR {snr_db:+.2f} dB: BER {res.ber:.3e}  FER {res.fer:.3e}  "
                  f"frames {res.frames}  {res.throughput_mbps:.3f} Mbps")
    return out
