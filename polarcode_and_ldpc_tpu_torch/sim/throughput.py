"""Throughput probes: encode, decode and end-to-end Mbit/s of one batch.

A batch is one pass of the device path (on a CUDA device through the
kernels).  Each probe calls its function a few times before the clock starts
(the first call builds the kernels with ``nvcc``), then times several calls
on the host clock and ends the timed loop with one device synchronise; no
call reads a result back to the host.
"""

from __future__ import annotations

import time
from typing import Optional

import numpy as np
import torch

from ..channels.awgn import AWGNChannel
from ..convert import _PORT_CHOICES
from ..core import rng
from ..core.device import resolve_device
from ..models.ldpc.bp import BPDecoder
from ..models.ldpc.encoder import LDPCEncoder
from ..models.ldpc.minsum import MSDecoder
from ..models.polar.construction import construct_polar_code
from ..models.polar.encoder import PolarEncoder
from ..models.polar.sc import SCDecoder
from ..models.polar.scl import SCLDecoder

# the JAX package's BP implementation names, each the device's choice here
_JAX_BP_IMPLS = ("xla", "pallas", "auto")


def _sync(out) -> None:
    """Wait for the device work behind ``out``, a tensor or a tuple of
    tensors (no host read)."""
    t = out if isinstance(out, torch.Tensor) else out[0]
    if t.is_cuda:
        torch.cuda.synchronize(t.device)


def time_fn(fn, *args, warmup: int = 2, iters: int = 5) -> float:
    """Steady-state seconds per call of ``fn(*args)``: ``warmup`` calls
    outside the clock, then ``iters`` calls ended by one device
    synchronise."""
    for _ in range(warmup):
        _sync(fn(*args))
    t0 = time.perf_counter()
    out = None
    for _ in range(iters):
        out = fn(*args)
    _sync(out)
    return (time.perf_counter() - t0) / iters


def _rates(info_bits: int, batch: int, t_enc: float, t_dec: float, t_e2e: float) -> dict:
    return {
        "encoding_throughput": info_bits / t_enc / 1e6,
        "decoding_throughput": info_bits / t_dec / 1e6,
        "end_to_end_throughput": info_bits / t_e2e / 1e6,
        "encode_seconds": t_enc,
        "decode_seconds": t_dec,
        "decode_ms_per_frame": t_dec / batch * 1e3,
    }


def _probe(encode, chan, decode, msgs, seed: int):
    """Seconds per call of the encode, the decode of the encoded batch's
    channel LLRs, and the whole chain with the channel keyed by ``seed``."""
    key = rng.prng_key(seed, msgs.device)
    t_enc = time_fn(encode, msgs)
    llr = chan.transmit(encode(msgs))
    t_dec = time_fn(decode, llr)
    t_e2e = time_fn(lambda m, k: decode(chan.transmit(encode(m), key=k)), msgs, key)
    return t_enc, t_dec, t_e2e


def measure_polar_throughput(
    N: int = 1024,
    K: int = 512,
    snr_db: float = 3.0,
    batch: int = 256,
    decoder: str = "sc",
    list_size: int = 8,
    seed: int = 42,
    sc_impl: Optional[str] = None,
    device="cuda",
) -> dict:
    """Encode / decode / end-to-end Mbit/s of a polar code (Bhattacharyya
    construction at 2 dB) on a batch of ``batch`` frames.

    ``decoder``: ``"sc"`` or ``"scl"`` (all ``list_size`` paths, no
    selection).  ``sc_impl``: the SC decoder (``None``: the device's choice,
    the whole-decode kernel on a CUDA device; ``"mega"``, ``"unrolled"`` or
    ``"scan"``, the trellis twin)."""
    dev = resolve_device(device)
    frozen, _ = construct_polar_code(N, K, "bhattacharyya", 2.0)
    enc = PolarEncoder(N, K, frozen_bits=frozen, device=dev)
    if decoder == "sc":
        dec = SCDecoder(N, K, frozen_bits=frozen, impl=sc_impl, device=dev)
        decode = dec.decode_full
    else:
        dec = SCLDecoder(N, K, list_size=list_size, frozen_bits=frozen, device=dev)
        decode = dec.decode_paths
    chan = AWGNChannel(snr_db=snr_db, seed=seed, device=dev)
    msgs = torch.as_tensor(np.random.default_rng(seed).integers(0, 2, (batch, K)),
                           dtype=torch.int8, device=dev)
    seconds = _probe(enc.encode, chan, decode, msgs, seed)
    return {
        "config": {"N": N, "K": K, "decoder": decoder, "batch": batch, "snr_db": snr_db,
                   **({"list_size": list_size} if decoder != "sc" else {})},
        **_rates(batch * K, batch, *seconds),
    }


def measure_ldpc_throughput(
    n: int = 504,
    k: int = 252,
    dv: int = 3,
    dc: int = 6,
    snr_db: float = 3.0,
    batch: int = 256,
    decoder: str = "bp",
    max_iter: int = 20,
    normalization: float = 0.75,
    seed: int = 42,
    H: Optional[np.ndarray] = None,
    bp_impl: Optional[str] = None,
    device="cuda",
) -> dict:
    """Encode / decode / end-to-end Mbit/s of a (dv, dc) LDPC code (or
    ``H``) on a batch of ``batch`` frames; ``decoder``: ``"bp"`` or min-sum
    (any other name) with ``normalization``.

    ``bp_impl``: ``None`` (the device's choice: the fused kernel on a CUDA
    device), ``"cuda"`` or ``"torch"``; the JAX package's names (``"xla"``,
    ``"pallas"``, ``"auto"``) mean the device's choice; any other name raises
    ``ValueError``."""
    dev = resolve_device(device)
    if bp_impl in _JAX_BP_IMPLS:
        bp_impl = None
    elif bp_impl is not None and bp_impl not in _PORT_CHOICES["bp_impl"]:
        raise ValueError(f"unknown bp_impl {bp_impl!r}: expected None or one of "
                         f"{_PORT_CHOICES['bp_impl'] + _JAX_BP_IMPLS}")
    enc = LDPCEncoder(n, k, H=H, dv=dv, dc=dc, seed=seed, device=dev)
    dec = (BPDecoder(enc.H, max_iter=max_iter, impl=bp_impl, device=dev) if decoder == "bp"
           else MSDecoder(enc.H, max_iter=max_iter, normalization=normalization,
                          impl=bp_impl, device=dev))
    chan = AWGNChannel(snr_db=snr_db, seed=seed, device=dev)
    msgs = torch.as_tensor(np.random.default_rng(seed).integers(0, 2, (batch, enc.k)),
                           dtype=torch.int8, device=dev)
    seconds = _probe(enc.encode, chan, dec._run_fn, msgs, seed)
    return {
        "config": {"n": n, "k": enc.k, "dv": dv, "dc": dc, "decoder": decoder,
                   "batch": batch, "max_iterations": max_iter, "snr_db": snr_db},
        **_rates(batch * enc.k, batch, *seconds),
    }


def run_throughput_test(polar_params: Optional[dict] = None,
                        ldpc_params: Optional[dict] = None, device="cuda") -> dict:
    """Both probes: ``{"polar": ..., "ldpc": ...}``."""
    return {
        "polar": measure_polar_throughput(**(polar_params or {}), device=device),
        "ldpc": measure_ldpc_throughput(**(ldpc_params or {}), device=device),
    }
