"""End-to-end Monte-Carlo steps: bits → encode → channel → decode → error
counts, batched over a frame axis.

One step processes a whole chunk of frames on one device; message and noise
randomness derive from each frame's *global id* (``core/rng.py``), so results
are invariant to chunk size and dispatch layout.
"""

from __future__ import annotations

import functools
from typing import Callable, Optional

import numpy as np
import torch

from ..channels.awgn import awgn_transmit
from ..channels.bsc import bsc_llr, bsc_transmit
from ..channels.fading import rayleigh_transmit, rician_transmit
from ..core import rng
from ..core.device import resolve_device
from ..models.ldpc.bp import make_bp_decoder
from ..models.ldpc.encoder import gf2_matmul
from ..models.ldpc.graph import TannerGraph
from ..models.ldpc.layered import make_layered_ms_decoder
from ..models.ldpc.minsum import make_ms_decoder
from ..models.ldpc.qc import make_qc_bp_decoder
from ..models.polar.construction import frozen_mask_from_positions
from ..models.polar.crc import CRCCodec
from ..models.polar.encoder import polar_transform
from ..models.polar.sc import make_sc_decoder
from ..models.polar.scl import make_scl_decoder, select_best_path


def make_montecarlo_step(
    k_message: int,
    encode_fn: Callable,
    channel_fn: Callable,
    decode_fn: Callable,
    compare_len: Optional[int] = None,
    rng_x64: bool = False,
):
    """Compose a Monte-Carlo chunk step.

    Args:
        k_message: message bits per frame (decoder input length).
        encode_fn: ``[B, k_message] int8 → [B, n] int8`` codewords.
        channel_fn: ``(keys [B, 2], codewords [B, n]) → [B, n] float`` LLRs.
        decode_fn: ``[B, n] float → ([B, ≥compare_len] int8, aux dict)``;
            ``aux`` may carry per-frame ``iterations``.
        compare_len: how many leading message bits to count errors over
            (defaults to ``k_message``).
        rng_x64: draw the message bits as ``jax.random.bernoulli`` draws them
            under ``jax_enable_x64`` (a 64-bit uniform) instead of the 32-bit
            default; the two give different bits from the same key.

    Returns ``step(root_key, frame_ids [B], *extra) → dict`` of per-frame
    stats (``bit_errors [B]`` int32, ``frame_error [B]`` bool, optional
    ``iterations [B]``).  ``*extra`` carries runtime channel parameters
    (a ``snr_db`` scalar for runtime-SNR channels).
    """
    cmp_len = k_message if compare_len is None else compare_len

    def step(root_key, frame_ids, *extra):
        fkeys = rng.frame_keys(root_key, frame_ids)
        msg_keys = rng.fold_in(fkeys, 0)
        noise_keys = rng.fold_in(fkeys, 1)
        msgs = rng.bernoulli_half(msg_keys, k_message, x64=rng_x64)
        cw = encode_fn(msgs)
        llr = channel_fn(noise_keys, cw, *extra)
        decoded, aux = decode_fn(llr)
        diff = decoded[..., :cmp_len] != msgs[..., :cmp_len]
        out = {
            "bit_errors": diff.sum(dim=-1, dtype=torch.int32),
            "frame_error": diff.any(dim=-1),
        }
        if "iterations" in aux:
            out["iterations"] = aux["iterations"]
        return out

    return step


def reduce_step(step):
    """Wrap a Monte-Carlo step to emit *scalars* instead of per-frame arrays
    (bit_errors, frame_errors, iterations sums), so only three numbers per
    chunk cross to the host.  Early stopping then operates at chunk
    granularity (see ``MonteCarloSimulator(reduction="scalar")``)."""

    def reduced(root_key, frame_ids, *extra):
        out = step(root_key, frame_ids, *extra)
        red = {
            "bit_errors": out["bit_errors"].sum(dtype=torch.int64),
            "frame_errors": out["frame_error"].sum(dtype=torch.int64),
        }
        if "iterations" in out:
            red["iterations"] = out["iterations"].sum(dtype=torch.int64)
        return red

    reduced.runtime_snr = getattr(step, "runtime_snr", False)
    return reduced


def make_channel_fn(kind: str = "awgn", snr_db=3.0, crossover_prob: float = 0.1,
                    k_factor: float = 1.0, dtype=torch.float32, rng_x64: bool = False):
    """Per-frame-keyed channel function for the Monte-Carlo pipelines:
    ``(keys [B, 2], codewords [B, n], *extra) → LLRs [B, n]``.

    ``kind``: ``awgn`` | ``bsc`` | ``rayleigh`` | ``rician``.  BSC gives
    ±log((1 − p)/p) LLRs (``crossover_prob``); Rician takes ``k_factor``.
    ``snr_db=None`` (awgn / rayleigh / rician) builds a runtime-SNR channel:
    the step then takes the SNR as a trailing argument, so one step serves
    every SNR point of a sweep; BSC has no SNR (``runtime_snr`` is False).
    ``rng_x64`` draws the BSC flips as ``jax.random.bernoulli`` does under
    ``jax_enable_x64`` (float64 uniforms): pass the pipeline's ``rng_x64``.
    """
    if kind == "bsc":
        def channel(keys, cw, *extra):
            return bsc_llr(bsc_transmit(keys, cw, crossover_prob, rng_x64), crossover_prob,
                           dtype)

        channel.runtime_snr = False
        return channel
    transmit = {"awgn": awgn_transmit, "rayleigh": rayleigh_transmit,
                "rician": functools.partial(rician_transmit, k_factor=k_factor)}.get(kind)
    if transmit is None:
        raise ValueError(f"unknown channel kind: {kind!r}")

    def channel(keys, cw, *extra):
        snr = snr_db
        if snr is None:  # the step's trailing argument, on the codewords' device
            snr = extra[0] if isinstance(extra[0], torch.Tensor) else torch.as_tensor(
                extra[0], dtype=dtype, device=cw.device)
        return transmit(keys, cw, snr, dtype=dtype)

    channel.runtime_snr = snr_db is None
    return channel


def make_polar_pipeline(
    N: int,
    K: int,
    frozen_bits: np.ndarray,
    snr_db,  # float, or None for a runtime-SNR step
    decoder: str = "sc",
    list_size: int = 8,
    use_crc: bool = False,
    crc_polynomial: str = "CRC-8",
    dtype=torch.float32,
    channel_fn: Optional[Callable] = None,
    sc_impl: Optional[str] = None,
    device="cuda",
    rng_x64: bool = False,
    scl_body_impl: Optional[str] = None,
    scl_chunk: int = 128,
    scl_leaf_impl: str = "onehot",
    scl_control_impl: Optional[str] = None,
    scl_node_mode: str = "exact",
):
    """End-to-end polar Monte-Carlo step.

    ``decoder``: ``"sc"``, ``"scl"`` (metric-argmax selection), or
    ``"ca-scl"`` (CRC-aided selection; implies ``use_crc``).  With
    ``use_crc``, ``K − crc_len`` message bits are drawn per frame, the CRC is
    appended, and errors are counted over the message bits.  ``sc_impl`` is
    forwarded to ``make_sc_decoder`` (``None``: the CUDA kernel on a CUDA
    device, the plain recursion on the CPU); the ``scl_*`` keywords to
    ``make_scl_decoder`` (``scl_control_impl=None``: the kernel control
    ``"unroll-kernel"`` on a CUDA device, the plain ``"unroll-fused"`` on the
    CPU; the JAX package's ``"split"``, ``"fused"`` and ``"kernel"`` too;
    ``scl_leaf_impl="onehot"`` or ``"sort"``; ``scl_node_mode="fast"``: the
    SSCL fast list nodes).

    ``snr_db=None`` (with the default AWGN channel) builds a runtime-SNR
    step: call it as ``step(key, ids, snr_db)``; ``step.runtime_snr`` is True.
    """
    dev = resolve_device(device)
    frozen_bits = np.sort(np.asarray(frozen_bits, np.int64))
    info_bits = np.setdiff1d(np.arange(N), frozen_bits)
    assert len(info_bits) == K
    frozen_mask = frozen_mask_from_positions(N, frozen_bits)
    info_idx = torch.as_tensor(info_bits, dtype=torch.int64, device=dev)
    if decoder == "ca-scl":
        use_crc = True

    crc = None
    k_message = K
    if use_crc:
        crc = CRCCodec(K - int(crc_polynomial.split("-")[1]), crc_polynomial, dev)
        k_message = crc.data_len

    def encode(msgs):
        if crc is not None:
            msgs = crc.encode(msgs)
        u = torch.zeros((*msgs.shape[:-1], N), dtype=torch.int8, device=msgs.device)
        u[..., info_idx] = msgs
        return polar_transform(u)

    if decoder == "sc":
        sc = make_sc_decoder(N, frozen_mask, dtype, sc_impl, dev)

        def decode(llr):
            return sc(llr)[..., info_idx], {}

    elif decoder in ("scl", "ca-scl"):
        scl = make_scl_decoder(N, frozen_mask, list_size, dtype,
                               chunk=min(scl_chunk, N),
                               body_impl=scl_body_impl, leaf_impl=scl_leaf_impl,
                               control_impl=scl_control_impl,
                               node_mode=scl_node_mode, device=dev)

        def decode(llr):
            u_paths, metrics = scl(llr)
            sel = select_best_path(u_paths[..., info_idx], metrics,
                                   crc if decoder == "ca-scl" else None)
            return sel, {}

    else:
        raise ValueError(f"unknown polar decoder: {decoder!r}")

    chan = channel_fn or make_channel_fn("awgn", snr_db, dtype=dtype)
    step = make_montecarlo_step(k_message, encode, chan, decode,
                                compare_len=k_message, rng_x64=rng_x64)
    step.runtime_snr = getattr(chan, "runtime_snr", False)
    step.device = dev
    return step


def make_ldpc_pipeline(
    H: np.ndarray,
    G_kn: np.ndarray,
    snr_db,  # float, or None for a runtime-SNR step
    decoder: str = "bp",
    max_iter: int = 20,
    normalization: float = 1.0,
    offset: float = 0.0,
    early_stop: bool = True,
    message_idx: Optional[np.ndarray] = None,
    dtype=torch.float32,
    channel_fn: Optional[Callable] = None,
    qc_base: Optional[np.ndarray] = None,
    z: Optional[int] = None,
    bp_impl: Optional[str] = None,
    schedule: str = "flooding",
    num_layers: int = 4,
    device="cuda",
    rng_x64: bool = False,
):
    """End-to-end LDPC Monte-Carlo step.

    Args:
        H: ``[m, n]`` parity-check matrix.
        G_kn: ``[k, n]`` generator (systematic or not).
        decoder: ``"bp"`` | ``"ms"`` / ``"min-sum"`` | ``"nms"`` | ``"oms"``;
            the min-sum names share one check rule, tuned by
            ``normalization`` and ``offset``.
        message_idx: positions of the k message bits inside the codeword
            (defaults to ``0..k-1``, the systematic convention).
        bp_impl: ``None`` (the CUDA kernel on a CUDA device, the plain
            decoder on the CPU), ``"cuda"`` or ``"torch"``.
        qc_base, z: shift matrix + lift size of a quasi-cyclic code
            (``matrix.qc_base_matrix``): message passing then runs through
            the roll-based QC decoder (``models/ldpc/qc.py``), the path that
            scales to n=8192.  Equal to the generic decoder on the same H.
        schedule: ``"flooding"`` (the default) or ``"layered"`` (row-layered
            serving schedule, min-sum only; on a CUDA device the layered mode
            of the fused kernel); ``num_layers`` picks the check grouping
            (ignored on the QC path — base rows are the layers there).
    """
    dev = resolve_device(device)
    if schedule not in ("flooding", "layered"):
        raise ValueError(f"unknown schedule {schedule!r}")
    H = np.asarray(H)
    G = torch.as_tensor((np.asarray(G_kn) % 2).astype(np.float32), device=dev)
    k, n = G.shape
    midx = torch.as_tensor(
        np.arange(k) if message_idx is None else np.asarray(message_idx),
        dtype=torch.int64, device=dev)
    from ..ops.bp_cuda import resolve_bp_impl

    if qc_base is not None:
        variant = {"bp": "bp", "ms": "ms", "min-sum": "ms", "nms": "nms",
                   "oms": "oms"}.get(decoder)
        if variant is None:
            raise ValueError(f"unknown LDPC decoder: {decoder!r}")
        dec = make_qc_bp_decoder(qc_base, z, max_iter, early_stop, dtype, variant,
                                 normalization, offset, schedule, dev)
    elif decoder == "bp":
        graph = TannerGraph.from_H(H, dev)
        dec, _ = resolve_bp_impl(
            graph, make_bp_decoder(graph, max_iter, early_stop, dtype),
            max_iter, early_stop, dtype, bp_impl, schedule=schedule)
    elif decoder in ("ms", "min-sum", "nms", "oms"):
        graph = TannerGraph.from_H(H, dev)
        if schedule == "layered":
            plain = make_layered_ms_decoder(graph, max_iter, normalization, offset,
                                            early_stop, dtype, num_layers)
        else:
            plain = make_ms_decoder(graph, max_iter, normalization, offset,
                                    early_stop, dtype)
        dec, _ = resolve_bp_impl(
            graph, plain, max_iter, early_stop, dtype, bp_impl,
            check_rule="ms", normalization=normalization, offset=offset,
            schedule=schedule, num_layers=num_layers)
    else:
        raise ValueError(f"unknown LDPC decoder: {decoder!r}")

    def encode(msgs):
        return gf2_matmul(msgs, G)

    def decode(llr):
        bits, iters = dec(llr)
        return bits[..., midx], {"iterations": iters}

    chan = channel_fn or make_channel_fn("awgn", snr_db, dtype=dtype)
    step = make_montecarlo_step(k, encode, chan, decode, rng_x64=rng_x64)
    step.runtime_snr = getattr(chan, "runtime_snr", False)
    step.device = dev
    return step
