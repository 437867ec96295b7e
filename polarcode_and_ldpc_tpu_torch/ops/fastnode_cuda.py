"""K7: the SSCL fast rate-1 node's selection — wrapper and plain version.

``csrc/fastnode.cu`` holds ``fastnode_select``, which replaces the Pallas
kernel of ``tools/mosaic_fastnode_probe.py`` (its body at :53-75, the
``pallas_call`` at :79): per frame and path, the K least-reliable positions
(the first K of a stable ascending sort of ``|a|``, ties to the lower
position) and the halving-tree sum of ``log1p(exp(−|a|))``: the preamble of
the list decoder's ``OP_RATE1_FAST`` node on its own (``csrc/fastnode_device.cuh``;
the list kernels run its selection rounds over registers).  The probe's layout
is kept: frames last.

Bound: device-memory bytes (each input read once, each output written once);
one warp per frame.  The kernel equals its plain version bit for bit.  A
wrapper uses the plain version only for tensors on the CPU; on a CUDA tensor
it launches the kernel or raises.
"""

from __future__ import annotations

import ctypes

import torch

from ..models.polar.scanscl import _tree_sum
from . import build, count_launch
from .scl_cuda import SMEM_LIMIT_BYTES

_MAX_WARPS = 8


def fastnode_select_plain(a: torch.Tensor, K: int):
    """``a [L, S, B]`` → ``(mags [L, K, B], idx [L, K, B] int32, penalty [L,
    1, B])``: a stable sort of ``|a|`` along the positions, and the
    halving-tree sum of ``log1p(exp(−|a|))`` over them."""
    mags = a.abs()
    smags, sidx = torch.sort(mags, dim=1, stable=True)
    pen = _tree_sum(torch.log1p(torch.exp(-mags)).transpose(1, 2))
    return (smags[:, :K].contiguous(), sidx[:, :K].to(torch.int32).contiguous(),
            pen[:, None, :].contiguous())


def words_per_frame(L: int, S: int, K: int) -> int:
    """32-bit words of shared memory one frame needs (mirrors
    ``fastnode_words_per_frame`` of the source)."""
    return L * S + L * max(S // 2 if S > 1 else 1, K)


def fastnode_select_cuda(a: torch.Tensor, K: int):
    """Launch ``fastnode_select`` on a contiguous float32 CUDA ``a [L, S, B]``.
    Does not synchronise."""
    if a.device.type != "cuda":
        raise ValueError(f"fastnode_select_cuda needs a CUDA tensor, got {a.device}")
    if a.dtype != torch.float32:
        raise TypeError(f"fastnode_select is float32 only, got {a.dtype}")
    if a.dim() != 3 or not a.is_contiguous():
        raise ValueError(f"expected a contiguous [L, S, B] tensor, got {tuple(a.shape)}")
    L, S, B = a.shape
    if not (1 <= L <= 32 and S >= 1 and S & (S - 1) == 0 and 1 <= K <= S and B >= 1):
        raise ValueError(f"fastnode_select takes 1 <= L <= 32, S a power of two and "
                         f"1 <= K <= S; got L={L}, S={S}, K={K}, B={B}")
    per_frame = 4 * words_per_frame(L, S, K)
    if per_frame > SMEM_LIMIT_BYTES:
        raise ValueError(f"fastnode_select needs {per_frame} bytes of shared memory per "
                         f"frame; one thread block has {SMEM_LIMIT_BYTES}")
    warps = max(1, min(_MAX_WARPS, (48 * 1024) // per_frame))
    lib = build.load("fastnode")
    fn = lib.fastnode_select_launch
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
    dev = a.device
    mags = torch.empty((L, K, B), dtype=torch.float32, device=dev)
    idx = torch.empty((L, K, B), dtype=torch.int32, device=dev)
    pen = torch.empty((L, 1, B), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        code = fn(a.data_ptr(), mags.data_ptr(), idx.data_ptr(), pen.data_ptr(), L, S, K, B,
                  warps, torch.cuda.current_stream().cuda_stream)
    build.check_launch(lib, code, "fastnode_select")
    count_launch("fastnode_select")
    return mags, idx, pen


def fastnode_select(a: torch.Tensor, K: int):
    """The rate-1 node's selection: the plain version for a CPU tensor, the
    kernel for a CUDA tensor."""
    if a.device.type == "cpu":
        return fastnode_select_plain(a, K)
    return fastnode_select_cuda(a.contiguous(), K)
