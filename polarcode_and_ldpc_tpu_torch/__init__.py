"""polarcode_and_ldpc_tpu_torch — the PyTorch/CUDA port of the
``polarcode_and_ldpc_tpu`` channel-coding framework, for one NVIDIA H100.

Ported so far: the Monte-Carlo main path with SC and CRC-aided list polar
decoding and flooding BP / min-sum LDPC decoding, and the serving paths
(adaptive SC-first CA-SCL, row-layered min-sum, quasi-cyclic LDPC) —

* Polar codes: construction, Kronecker-butterfly encoder with optional CRC,
  SC decoder (the whole decode in one hand-written CUDA kernel), SCL and
  CRC-aided SCL decoders (chunked list decode: one hand-written CUDA kernel
  launch per chunk, or the whole decode in one launch), the adaptive
  SC-first CA-SCL serving decoder.
* LDPC codes: constructions (quasi-cyclic included), GF(2) encoder, BP
  (sum-product) and Min-Sum (normalized + offset) decoders, flooding or
  row-layered (the whole decode in one CUDA kernel), the roll-based
  quasi-cyclic decoder for large codes.
* AWGN channel with BPSK modulation and LLR demodulation.
* Monte-Carlo BER/FER simulation with per-frame keyed randomness.

Sub-packages mirror the JAX package so each counterpart is easy to find.
Every factory function and class takes ``device=`` and defaults to ``"cuda"``; the CPU
is used only when the caller asks for it.  Importing the package builds no
kernel and imports neither ``jax`` nor the JAX package.
"""

from .channels import AWGNChannel
from .models.ldpc import (BPDecoder, LayeredMSDecoder, LDPCEncoder, MSDecoder,
                          NMSDecoder, OMSDecoder, QCBPDecoder, check_matrix_rank,
                          create_systematic_generator, generate_ldpc_matrix,
                          gf2_rank, mackay_construction, qc_base_matrix,
                          qc_expand, qc_ldpc_construction, regular_construction)
from .models.polar import (AdaptiveCASCLDecoder, CASCLDecoder, CRCCodec,
                           PolarEncoder, SCDecoder,
                           SCLDecoder, bhattacharyya_bounds,
                           construct_polar_code, crc_check, crc_encode,
                           gaussian_approximation, generate_frozen_bits,
                           polar_transform)

__version__ = "0.1.0"

__all__ = [
    "PolarEncoder", "SCDecoder", "SCLDecoder", "CASCLDecoder", "CRCCodec",
    "crc_encode", "crc_check", "construct_polar_code",
    "bhattacharyya_bounds", "gaussian_approximation", "generate_frozen_bits",
    "polar_transform", "LDPCEncoder", "BPDecoder", "MSDecoder", "NMSDecoder",
    "OMSDecoder", "generate_ldpc_matrix", "mackay_construction",
    "regular_construction", "create_systematic_generator",
    "check_matrix_rank", "gf2_rank", "AWGNChannel", "AdaptiveCASCLDecoder",
    "LayeredMSDecoder", "QCBPDecoder", "qc_base_matrix", "qc_expand",
    "qc_ldpc_construction",
]
