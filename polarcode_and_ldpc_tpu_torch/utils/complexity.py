"""Closed-form operation and memory counts of polar and LDPC coding, and a
roofline of an achieved decode rate against one NVIDIA H100."""

from __future__ import annotations

import math
from typing import Optional


def polar_complexity(N: int, K: int, list_size: int = 1) -> dict:
    """Operation / memory counts of polar encode and SC / SCL decode."""
    n = int(math.log2(N))
    return {
        "N": N,
        "K": K,
        "list_size": list_size,
        "encoding": {"xor_operations": N * n, "complexity": "O(N log N)"},
        "sc_decoding": {"operations": N + N * n, "complexity": "O(N log N)"},
        "scl_decoding": {"operations": list_size * N * n, "complexity": "O(L N log N)"},
        "memory": {"llr_values": N * (n + 1), "bit_values": N * (n + 1),
                   "scl_factor": list_size},
    }


def ldpc_complexity(n: int, k: int, dv: int = 3, dc: int = 6,
                    max_iterations: int = 20) -> dict:
    """Operation / memory counts of LDPC encode and BP decode."""
    m = n - k
    edges = n * dv
    return {
        "n": n,
        "k": k,
        "dv": dv,
        "dc": dc,
        "max_iterations": max_iterations,
        "encoding": {"operations": m * k, "complexity": "O(m k)"},
        "bp_decoding": {"operations": max_iterations * (n * 2 * dv + m * 3 * dc),
                        "complexity": "O(iter · edges)"},
        "memory": {"llr_values": n, "messages": 2 * edges},
    }


# Published peaks of one NVIDIA H100 SXM (80 GB HBM3; NVIDIA's data sheet, dense
# rates without sparsity, at the full power limit of 700 W): the bf16 tensor-core
# rate and the device-memory rate.  A card set to a lower power limit runs
# slower; state the card's name and power limit beside a share.  The decoders
# are elementwise and memory-bound, not matmuls, so the share of the bf16 peak
# is a conservative ceiling; the bandwidth share is the realistic bound.
H100_PEAK_FLOPS_BF16 = 989e12
H100_HBM_BYTES_PER_S = 3.35e12


def decode_roofline(algorithmic_ops_per_frame: float,
                    frames_per_second: float,
                    state_bytes_per_frame: Optional[float] = None) -> dict:
    """An achieved decode rate against the H100's peaks.

    ``algorithmic_ops_per_frame`` comes from the closed-form counts above, so
    the figure compares across implementations; ``state_bytes_per_frame``
    (optional) estimates the decoder's device-memory traffic per frame for
    the bandwidth share."""
    ops_per_s = algorithmic_ops_per_frame * frames_per_second
    out = {
        "algorithmic_ops_per_s": ops_per_s,
        "mfu_vs_bf16_peak": ops_per_s / H100_PEAK_FLOPS_BF16,
    }
    if state_bytes_per_frame is not None:
        out["hbm_utilization_estimate"] = (state_bytes_per_frame * frames_per_second
                                           / H100_HBM_BYTES_PER_S)
    return out


def analyze_complexity(polar_params: Optional[dict] = None,
                       ldpc_params: Optional[dict] = None) -> dict:
    """Both families' counts (defaults: polar N=1024, K=512, L=8; LDPC
    (504, 252), dv=3, dc=6, 20 iterations)."""
    polar_params = polar_params or {"N": 1024, "K": 512, "list_size": 8}
    ldpc_params = ldpc_params or {"n": 504, "k": 252, "dv": 3, "dc": 6,
                                  "max_iterations": 20}
    return {
        "polar": polar_complexity(**polar_params),
        "ldpc": ldpc_complexity(**ldpc_params),
    }
