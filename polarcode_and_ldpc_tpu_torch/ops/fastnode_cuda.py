"""K7: the SSCL fast rate-1 node's selection — wrapper and plain version.

``csrc/fastnode.cu`` holds ``fastnode_select``, which replaces the Pallas
kernel of ``tools/mosaic_fastnode_probe.py`` (its body at :53-75, the
``pallas_call`` at :79): per frame and path, the K least-reliable positions
(the first K of a stable ascending sort of ``|a|``, ties to the lower
position) and the halving-tree sum of ``log1p(exp(−|a|))``: the preamble of
the list decoder's ``OP_RATE1_FAST`` node on its own (``csrc/fastnode_device.cuh``;
the list kernels run its selection rounds over registers).  The probe's layout
is kept: frames last.

Bound: device-memory bytes (each input read once, each output written once).
One or two lanes stream each (path, frame), the K least pairs in a sorted
register list, the sum in the halving tree's order.  K is at most
``STREAM_MAX_K`` (a list of up to 32 paths has K = L − 1 ≤ 31; the probe runs
K = 7).  The kernel equals the plain version bit for bit.  A wrapper uses the
plain version only for tensors on the CPU; on a CUDA tensor it launches the
kernel or raises.
"""

from __future__ import annotations

import ctypes

import torch

from ..models.polar.scanscl import _tree_sum
from . import build, count_launch


def fastnode_select_plain(a: torch.Tensor, K: int):
    """``a [L, S, B]`` → ``(mags [L, K, B], idx [L, K, B] int32, penalty [L,
    1, B])``: a stable sort of ``|a|`` along the positions, and the
    halving-tree sum of ``log1p(exp(−|a|))`` over them."""
    mags = a.abs()
    smags, sidx = torch.sort(mags, dim=1, stable=True)
    pen = _tree_sum(torch.log1p(torch.exp(-mags)).transpose(1, 2))
    return (smags[:, :K].contiguous(), sidx[:, :K].to(torch.int32).contiguous(),
            pen[:, None, :].contiguous())


#: the largest K of the kernel's register list (``kStreamMaxK`` of
#: ``csrc/fastnode.cu``)
STREAM_MAX_K = 32
#: the largest S the kernel's stack of partial sums holds
STREAM_MAX_S = 1 << 16


def fastnode_select_cuda(a: torch.Tensor, K: int):
    """Launch K7 on a contiguous float32 CUDA ``a [L, S, B]``.  Does not
    synchronise."""
    L, S, B = a.shape if a.dim() == 3 else (0, 0, 0)
    if not (1 <= L <= 32 and S >= 1 and S & (S - 1) == 0 and 1 <= K <= min(S, STREAM_MAX_K)
            and S <= STREAM_MAX_S and B >= 1 and L * B < 2 ** 31):
        raise ValueError(f"fastnode_select takes a [L, S, B] tensor with 1 <= L <= 32, S a "
                         f"power of two up to {STREAM_MAX_S}, 1 <= K <= min(S, "
                         f"STREAM_MAX_K = {STREAM_MAX_K}) and L * B < 2^31; got shape "
                         f"{tuple(a.shape)}, K={K}")
    if a.device.type != "cuda":
        raise ValueError(f"fastnode_select_cuda needs a CUDA tensor, got {a.device}")
    if a.dtype != torch.float32:
        raise TypeError(f"fastnode_select is float32 only, got {a.dtype}")
    if not a.is_contiguous():
        raise ValueError(f"expected a contiguous [L, S, B] tensor, got {tuple(a.shape)}")
    lib = build.load("fastnode")
    fn = lib.fastnode_select_launch
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
    dev = a.device
    mags = torch.empty((L, K, B), dtype=torch.float32, device=dev)
    idx = torch.empty((L, K, B), dtype=torch.int32, device=dev)
    pen = torch.empty((L, 1, B), dtype=torch.float32, device=dev)
    code = build.launch_on(dev.index, fn, a.data_ptr(), mags.data_ptr(), idx.data_ptr(),
                           pen.data_ptr(), L, S, K, B)
    build.check_launch(lib, code, "fastnode_select")
    count_launch("fastnode_select")
    return mags, idx, pen


def fastnode_select(a: torch.Tensor, K: int):
    """The rate-1 node's selection: the plain version for a CPU tensor, the
    kernel for a CUDA tensor."""
    if a.device.type == "cpu":
        return fastnode_select_plain(a, K)
    return fastnode_select_cuda(a.contiguous(), K)
