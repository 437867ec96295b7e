"""polarcode_and_ldpc_tpu_torch — the PyTorch/CUDA port of the
``polarcode_and_ldpc_tpu`` channel-coding framework, for one NVIDIA H100.

Ported so far: the Monte-Carlo main path with SC and CRC-aided list polar
decoding (exact, or with the SSCL fast list nodes) and flooding BP / min-sum
LDPC decoding over every channel, the serving paths (adaptive SC-first
CA-SCL, row-layered min-sum, quasi-cyclic LDPC) and the benchmark front end
with its CLIs —

* Polar codes: construction, Kronecker-butterfly encoder with optional CRC,
  SC decoder (the whole decode in one hand-written CUDA kernel), SCL and
  CRC-aided SCL decoders (chunked list decode: one hand-written CUDA kernel
  launch per chunk, or the whole decode in one launch), the adaptive
  SC-first CA-SCL serving decoder.
* LDPC codes: constructions (quasi-cyclic included), GF(2) encoder, BP
  (sum-product) and Min-Sum (normalized + offset) decoders, flooding or
  row-layered (the whole decode in one CUDA kernel), the roll-based
  quasi-cyclic decoder for large codes.
* Channels: AWGN, BSC, Rayleigh and Rician fading, with BPSK modulation and
  LLR demodulation.
* Monte-Carlo BER/FER simulation with per-frame keyed randomness, SNR sweeps,
  rate and code-length studies, throughput probes, complexity counts, tracing
  spans, and the CLIs ``run_benchmark``, ``throughput``, ``code_params``,
  ``sc_vs_scl`` and ``snr_curves`` (``python -m
  polarcode_and_ldpc_tpu_torch.cli.<name>``).

Sub-packages mirror the JAX package so each counterpart is easy to find.
Every factory function and class takes ``device=`` and defaults to ``"cuda"``; the CPU
is used only when the caller asks for it.  Importing the package builds no
kernel and imports neither ``jax`` nor the JAX package.
"""

from .channels import AWGNChannel, BSCChannel, RayleighFadingChannel, RicianFadingChannel
from .models.ldpc import (BPDecoder, LayeredMSDecoder, LDPCEncoder, MSDecoder,
                          NMSDecoder, OMSDecoder, QCBPDecoder, calculate_girth,
                          check_matrix_rank, create_systematic_generator,
                          generate_ldpc_matrix, gf2_rank, mackay_construction,
                          peg_construction, qc_base_matrix, qc_expand,
                          qc_ldpc_construction, regular_construction)
from .models.polar import (AdaptiveCASCLDecoder, CASCLDecoder, CRCCodec,
                           PolarEncoder, SCDecoder,
                           SCLDecoder, bhattacharyya_bounds,
                           calculate_channel_capacities, construct_polar_code,
                           crc_check, crc_encode, gaussian_approximation,
                           generate_frozen_bits, polar_transform)

__version__ = "0.1.0"

__all__ = [
    "PolarEncoder", "SCDecoder", "SCLDecoder", "CASCLDecoder", "CRCCodec",
    "crc_encode", "crc_check", "construct_polar_code",
    "bhattacharyya_bounds", "gaussian_approximation", "generate_frozen_bits",
    "polar_transform", "LDPCEncoder", "BPDecoder", "MSDecoder", "NMSDecoder",
    "OMSDecoder", "generate_ldpc_matrix", "mackay_construction",
    "regular_construction", "create_systematic_generator",
    "check_matrix_rank", "gf2_rank", "AWGNChannel", "BSCChannel", "RayleighFadingChannel",
    "RicianFadingChannel", "AdaptiveCASCLDecoder",
    "LayeredMSDecoder", "QCBPDecoder", "qc_base_matrix", "qc_expand",
    "qc_ldpc_construction", "calculate_channel_capacities", "peg_construction",
    "calculate_girth",
]
