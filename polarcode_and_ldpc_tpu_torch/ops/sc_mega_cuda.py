"""Whole-decode SC kernel: wrapper, host-side node program, plain version.

``csrc/sc_decode.cu`` replaces the TPU kernel
``polarcode_and_ldpc_tpu/ops/sc_mega_pallas.py::make_sc_decoder_mega``: the
whole SC recursion of a frame (rate-0/REP always, rate-1/SPC under
``fast_nodes``) and the final butterfly in one launch, one warp per frame,
all decode state in shared memory.  Bound: device-memory bytes (4 in + 1 out
per code bit); see the note at the top of the source for the design.

The plain PyTorch version of the same function is
``models.polar.fastsc.make_sc_decoder_unrolled``; the kernel equals it bit
for bit (same f/g arithmetic, same REP addition order, same first-minimum
SPC rule).  ``sc_decode`` uses the plain version only for a tensor that lies
on the CPU; on a CUDA tensor it launches the kernel or raises.

Hybrid mode (replaces the TPU kernel's ``_make_sub_kernel``,
``sc_mega_pallas.py:168-190``): a frame needs ``9·N`` bytes of shared
memory, so from N = 32768 one thread block cannot hold it.  Decided on the
host by size: the top levels of the recursion then run in plain PyTorch
(``fastsc.make_sc_decoder_hybrid``, as the JAX package runs them in XLA)
and every size-``sub_n`` subtree that is not all frozen is ONE launch of the
same kernel (``sc_decode_sub``) on its contiguous slice of bit-reversed
storage, with that subtree's own node program and no bit reversal or
butterfly inside; ``sub_n`` is the largest power of two whose frame fits
(16384 on Hopper).
"""

from __future__ import annotations

import ctypes
import numpy as np
import torch

from ..models.polar.construction import bit_reverse_permutation
from ..models.polar.fastsc import (make_sc_decoder_hybrid, make_sc_decoder_unrolled,
                                   make_sc_subtree_plain)
from . import build, count_launch

OP_F, OP_G, OP_COMBINE, OP_RATE0, OP_HARD, OP_REP, OP_SPC = range(7)

#: shared memory one thread block may use on Hopper (bytes)
SMEM_LIMIT_BYTES = 232448
_SMEM_TARGET_BYTES = 56 * 1024
_MAX_WARPS = 8


def smem_per_frame(N: int) -> int:
    """Shared memory one frame (one warp) needs: the level stack of alphas
    and the partial sums (mirrors ``sc_decode_smem_per_frame``)."""
    return 2 * N * 4 + N


def hybrid_sub_n(N: int) -> int:
    """The subtree size of the hybrid mode: the largest power of two ``≤ N``
    whose frame fits one thread block."""
    sub = N
    while sub > 1 and smem_per_frame(sub) > SMEM_LIMIT_BYTES:
        sub //= 2
    return sub


def build_sc_program(N: int, frozen_mask: np.ndarray, fast_nodes: bool = True) -> np.ndarray:
    """The static node program of one code: ``int32 [n_ops, 4]`` rows
    ``(op, depth, size, beta_offset)`` over bit-reversed storage, walked
    exactly as the SC recursion walks the frozen mask."""
    frozen_mask = np.asarray(frozen_mask, bool)
    assert frozen_mask.shape == (N,) and N & (N - 1) == 0
    return build_sc_program_rev(frozen_mask[bit_reverse_permutation(N)], fast_nodes)


def build_sc_program_rev(frozen_rev: np.ndarray, fast_nodes: bool = True) -> np.ndarray:
    """The node program of a (sub)tree given its frozen pattern in
    bit-reversed STORAGE order, as a hybrid subtree's slice is: the pattern
    is not reversed again."""
    frozen_rev = np.asarray(frozen_rev, bool)
    N = len(frozen_rev)
    assert N >= 1 and N & (N - 1) == 0
    ops: list[tuple[int, int, int, int]] = []

    def node(depth: int, off: int, size: int) -> None:
        sub = frozen_rev[off:off + size]
        n_frozen = int(sub.sum())
        if n_frozen == size:
            ops.append((OP_RATE0, depth, size, off))
        elif size == 1:
            ops.append((OP_HARD, depth, 1, off))
        elif n_frozen == size - 1 and not sub[-1]:
            ops.append((OP_REP, depth, size, off))
        elif fast_nodes and n_frozen == 0:
            ops.append((OP_HARD, depth, size, off))
        elif fast_nodes and n_frozen == 1 and sub[0]:
            ops.append((OP_SPC, depth, size, off))
        else:
            half = size // 2
            ops.append((OP_F, depth, half, off))
            node(depth + 1, off, half)
            ops.append((OP_G, depth, half, off))
            node(depth + 1, off + half, half)
            ops.append((OP_COMBINE, depth, half, off))

    node(0, 0, N)
    return np.asarray(ops, np.int32).reshape(-1, 4)


class SCProgram:
    """A code's node program plus its plain decoder; device copies of the
    program are cached per device.  With ``subtree=True`` it is the program
    of one hybrid subtree: ``frozen_mask`` is the subtree's slice of
    bit-reversed storage, and the launch reads and writes storage order with
    no butterfly (plain version ``make_sc_subtree_plain``)."""

    def __init__(self, N: int, frozen_mask: np.ndarray, fast_nodes: bool = True,
                 subtree: bool = False):
        self.N = N
        self.log2N = int(np.log2(N))
        self.fast_nodes = fast_nodes
        self.subtree = subtree
        if subtree:
            self.ops = build_sc_program_rev(frozen_mask, fast_nodes)
            self.plain = make_sc_subtree_plain(frozen_mask, torch.float32, fast_nodes)
        else:
            self.ops = build_sc_program(N, frozen_mask, fast_nodes)
            self.plain = make_sc_decoder_unrolled(N, frozen_mask, torch.float32, fast_nodes)
        self._on_device: dict[torch.device, torch.Tensor] = {}

    def device_ops(self, device: torch.device) -> torch.Tensor:
        t = self._on_device.get(device)
        if t is None:
            t = torch.from_numpy(self.ops).to(device).contiguous()
            self._on_device[device] = t
        return t


def sc_decode_cuda(llr: torch.Tensor, program: SCProgram) -> torch.Tensor:
    """Launch the kernel: ``llr [B, N]`` float32 CUDA contiguous →
    ``u [B, N]`` int8 (natural order); for a subtree program ``alpha [B, n]``
    → ``beta [B, n]`` int8, both in storage order.  Does not synchronise."""
    if llr.device.type != "cuda":
        raise ValueError(f"sc_decode_cuda needs a CUDA tensor, got {llr.device}")
    if llr.dtype != torch.float32:
        raise TypeError(
            f"the SC kernel is float32 only, got {llr.dtype}; ask for the "
            "plain implementation (impl='unrolled') for other dtypes")
    if llr.dim() != 2 or llr.shape[1] != program.N or llr.shape[0] < 1:
        raise ValueError(f"expected llr [B>=1, {program.N}], got {tuple(llr.shape)}")
    if not llr.is_contiguous():
        raise ValueError("sc_decode_cuda needs a contiguous tensor")
    lib = build.load("sc_decode")
    per_frame = smem_per_frame(program.N)
    if per_frame > SMEM_LIMIT_BYTES:
        raise ValueError(
            f"N={program.N} needs {per_frame} bytes of shared memory per "
            f"frame; one thread block has {SMEM_LIMIT_BYTES}")
    warps = max(1, min(_MAX_WARPS, _SMEM_TARGET_BYTES // per_frame))
    B = llr.shape[0]
    u = torch.empty((B, program.N), dtype=torch.int8, device=llr.device)
    ops = program.device_ops(llr.device)
    name = "sc_decode_sub" if program.subtree else "sc_decode"
    fn = getattr(lib, f"{name}_launch")
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                   ctypes.c_int, ctypes.c_void_p]
    with torch.cuda.device(llr.device):
        stream = torch.cuda.current_stream().cuda_stream
        code = fn(llr.data_ptr(), u.data_ptr(), ops.data_ptr(), ops.shape[0],
                  B, program.N, program.log2N, warps, stream)
    build.check_launch(lib, code, name)
    count_launch(name)
    return u


def sc_decode(llr: torch.Tensor, program: SCProgram) -> torch.Tensor:
    """``llr [B, N]`` → ``u [B, N]`` int8 (a subtree program: storage-order
    beta): the plain version for a CPU tensor, the kernel for a CUDA
    tensor."""
    if llr.device.type == "cpu":
        return program.plain(llr)
    return sc_decode_cuda(llr, program)


def make_sc_decoder_mega(N: int, frozen_mask: np.ndarray, dtype=torch.float32,
                         fast_nodes: bool = True):
    """Build the fused SC decoder: ``decode(llr [..., N]) -> u [..., N]``
    int8 in natural order, float32 only.

    A code whose frame fits one thread block is one launch per batch;
    otherwise the hybrid mode runs, one launch per size-``hybrid_sub_n(N)``
    subtree that is not all frozen.  ``decode.programs``
    maps each launched subtree's storage offset to its program (``{0:
    program}`` without a cut)."""
    if dtype != torch.float32:
        raise TypeError(
            f"the SC kernel is float32 only, got {dtype}; ask for the plain "
            "implementation (impl='unrolled') for other dtypes")
    frozen_mask = np.asarray(frozen_mask, bool)
    sub_n = hybrid_sub_n(N)
    if sub_n == N:
        program = SCProgram(N, frozen_mask, fast_nodes)
        programs = {0: program}

        def run(flat):
            return sc_decode(flat, program)
    else:
        frozen_rev = frozen_mask[bit_reverse_permutation(N)]
        programs = {off: SCProgram(sub_n, frozen_rev[off:off + sub_n], fast_nodes, subtree=True)
                    for off in range(0, N, sub_n) if not frozen_rev[off:off + sub_n].all()}
        run = make_sc_decoder_hybrid(
            N, frozen_mask, sub_n, torch.float32, fast_nodes,
            sub_decoders={off: (lambda a, p=p: sc_decode(a, p)) for off, p in programs.items()})

    def decode(llr):
        llr = torch.as_tensor(llr)
        if llr.dtype != torch.float32:
            raise TypeError(f"the SC kernel is float32 only, got {llr.dtype}")
        flat = llr.reshape(-1, N).contiguous()
        return run(flat).reshape(*llr.shape[:-1], N)

    decode.programs = programs
    decode.sub_n = sub_n
    return decode
