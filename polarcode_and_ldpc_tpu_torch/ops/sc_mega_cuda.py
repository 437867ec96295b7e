"""Whole-decode SC kernel: wrapper, host-side node program, launch plan,
plain version.

``csrc/sc_decode.cu`` replaces the TPU kernel
``polarcode_and_ldpc_tpu/ops/sc_mega_pallas.py::make_sc_decoder_mega``: the
whole SC recursion of a frame (rate-0/REP always, rate-1/SPC under
``fast_nodes``) and the final butterfly in one launch, one warp per frame,
nodes of 32 positions decoded in registers as one op each.  Bound:
device-memory bytes (4 in + 1 out per code bit); see the note at the top of
the source for the design.  ``plan_sc_launch`` decides, on the host, how
many levels of a frame's stack stay in device memory and how many frames a
block and an SM hold, for the fewest waves.

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
(16384 on Hopper).  A subtree launch keeps the top levels of each frame's
stack in device memory (level 0 is its input, read in place) and runs each
frame on ``SUBTREE_WARPS_PER_FRAME`` warps.
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import NamedTuple

import numpy as np
import torch

from ..models.polar.construction import bit_reverse_permutation
from ..models.polar.fastsc import (make_sc_decoder_hybrid, make_sc_decoder_unrolled,
                                   make_sc_subtree_plain)
from . import build, count_launch

OP_F, OP_G, OP_COMBINE, OP_RATE0, OP_HARD, OP_REP, OP_SPC, OP_NODE, OP_NODE_FAST = range(9)
#: the size of a node the kernel decodes in registers, one lane per position
NODE_SIZE = 32

#: shared memory one thread block may use on Hopper (bytes)
SMEM_LIMIT_BYTES = 232448
#: shared memory of one SM on Hopper, and what the runtime reserves per block
SMEM_PER_SM_BYTES = 233472
_BLOCK_RESERVED_BYTES = 1024
# warps per block (the kernel's launch bounds: 256 threads, at most 64
# registers a thread); resident blocks per SM on Hopper; resident warps per SM
# the launch plans for (4 blocks of 256 threads at 64 registers)
_MAX_WARPS_PER_BLOCK, _MAX_BLOCKS_PER_SM, _MAX_WARPS_PER_SM = 8, 32, 32


def smem_per_frame(N: int, dev_levels: int = 0) -> int:
    """Shared memory one frame (one warp) needs: the levels of its level
    stack below the top ``dev_levels`` (those stay in device memory) and the
    partial sums (mirrors ``sc_decode_smem_per_frame``)."""
    return 4 * ((2 * N) >> dev_levels) + N


#: warps per frame of a hybrid subtree launch (a whole decode runs one)
SUBTREE_WARPS_PER_FRAME = 4


def dev_scratch_floats(N: int, dev_levels: int) -> int:
    """Floats of device memory one frame of a subtree launch needs for the
    levels 1..dev_levels-1 of its level stack (level 0 is the launch's
    input), rounded up to 16 bytes (mirrors the kernel's
    ``dev_scratch_floats``)."""
    return (N - ((2 * N) >> dev_levels) + 3) // 4 * 4 if dev_levels > 1 else 0


class SCLaunchPlan(NamedTuple):
    """How one launch of the SC kernel runs: the top ``dev_levels`` levels
    of each frame's level stack in device memory, ``frames_per_block``
    frames of ``warps_per_frame`` warps each per block, the shared memory of
    a frame, the frames resident on one SM, and the waves the batch takes."""
    dev_levels: int
    frames_per_block: int
    smem_per_frame: int
    frames_per_sm: int
    waves: int
    warps_per_frame: int = 1


def launch_plan(program: "SCProgram", batch: int, device_index: int) -> SCLaunchPlan:
    """The plan by which ``sc_decode_cuda`` launches ``batch`` frames of
    ``program`` on CUDA device ``device_index``."""
    return plan_sc_launch(program.N, batch, program.subtree, _sm_count(device_index),
                          warps_per_frame=SUBTREE_WARPS_PER_FRAME if program.subtree else 1)


@functools.lru_cache(maxsize=256)
def plan_sc_launch(n: int, batch: int, subtree: bool, sms: int = 132,
                   smem_per_sm: int = SMEM_PER_SM_BYTES,
                   warps_per_frame: int = 1) -> SCLaunchPlan:
    """The launch of ``batch`` frames of size ``n``, ``warps_per_frame``
    warps each, that takes the fewest waves over ``sms`` SMs of
    ``smem_per_sm`` bytes each (blocks of at most ``SMEM_LIMIT_BYTES`` and
    8 warps: up to 8 frames of one warp, or one frame of several; 1 KB
    reserved per block; at most 32 blocks and 32 warps per SM); among those
    the fewest levels in device memory, then the most frames per SM, then
    the fewest frames per block.  Only a subtree launch keeps levels in
    device memory (its level 0 is its input, read in place); a whole decode
    reads its LLRs into shared memory in bit-reversed order."""
    log2n = n.bit_length() - 1
    best, best_key = None, None
    for c in range(log2n + 1 if subtree else 1):
        per = smem_per_frame(n, c)
        # a frame of several warps synchronises on its block's barrier: one
        # such frame per block
        for f in range(1, _MAX_WARPS_PER_BLOCK + 1 if warps_per_frame == 1 else 2):
            if f * per > SMEM_LIMIT_BYTES or f * warps_per_frame > _MAX_WARPS_PER_BLOCK:
                break
            blocks = min(_MAX_BLOCKS_PER_SM, _MAX_WARPS_PER_SM // (f * warps_per_frame),
                         smem_per_sm // (f * per + _BLOCK_RESERVED_BYTES))
            if blocks == 0:
                continue
            fps = blocks * f
            waves = math.ceil(batch / (fps * sms))
            key = (waves, c, -fps, f)
            if best_key is None or key < best_key:
                best, best_key = SCLaunchPlan(c, f, per, fps, waves, warps_per_frame), key
    if best is None:
        raise ValueError(f"n={n}: no frame of the SC kernel fits one thread block "
                         f"({smem_per_frame(n)} bytes of shared memory per frame)")
    return best


@functools.cache
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


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
    exactly as the SC recursion walks the frozen mask (``OP_NODE`` rows carry
    the node's frozen pattern in place of the depth)."""
    frozen_mask = np.asarray(frozen_mask, bool)
    assert frozen_mask.shape == (N,) and N & (N - 1) == 0
    return build_sc_program_rev(frozen_mask[bit_reverse_permutation(N)], fast_nodes)


def frozen_word(sub: np.ndarray) -> int:
    """A node's frozen pattern (≤ 32 positions) as an int32: bit ``i`` is
    storage position ``i``."""
    word = int(np.dot(np.asarray(sub, np.int64), 1 << np.arange(len(sub), dtype=np.int64)))
    return word - (1 << 32) if word >= 1 << 31 else word


def build_sc_program_rev(frozen_rev: np.ndarray, fast_nodes: bool = True) -> np.ndarray:
    """The node program of a (sub)tree given its frozen pattern in
    bit-reversed STORAGE order, as a hybrid subtree's slice is: the pattern
    is not reversed again.  A node of ``NODE_SIZE`` positions that is not all
    frozen is one ``OP_NODE`` (``OP_NODE_FAST`` under ``fast_nodes``) row
    ``(op, frozen_word, NODE_SIZE, offset)``, which the kernel decodes in
    registers by the same rules."""
    frozen_rev = np.asarray(frozen_rev, bool)
    N = len(frozen_rev)
    assert N >= 1 and N & (N - 1) == 0
    ops: list[tuple[int, int, int, int]] = []
    node_op = OP_NODE_FAST if fast_nodes else OP_NODE

    def node(depth: int, off: int, size: int) -> None:
        sub = frozen_rev[off:off + size]
        n_frozen = int(sub.sum())
        if n_frozen == size:
            ops.append((OP_RATE0, depth, size, off))
        elif size == NODE_SIZE:
            ops.append((node_op, frozen_word(sub), size, off))
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


@functools.cache
def _launcher(library: str, name: str):
    """The library and its C launcher ``<name>_launch`` with its argument
    types set (once per library and entry point)."""
    lib = build.load(library)
    fn = getattr(lib, f"{name}_launch")
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                   ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                   # a subtree launch: warps per frame, the device-memory levels'
                   # scratch and their count
                   *((ctypes.c_int, ctypes.c_void_p, ctypes.c_int) if name == "sc_decode_sub"
                     else ()),
                   ctypes.c_void_p]
    return lib, fn


def sc_decode_cuda(llr: torch.Tensor, program: SCProgram,
                   library: str = "sc_decode") -> torch.Tensor:
    """Launch the kernel: ``llr [B, N]`` float32 CUDA contiguous →
    ``u [B, N]`` int8 (natural order); for a subtree program ``alpha [B, n]``
    → ``beta [B, n]`` int8, both in storage order.  ``library`` names the
    build (``"sc_decode_profile"``: the stage profile).  Does not
    synchronise."""
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
    if smem_per_frame(program.N) > SMEM_LIMIT_BYTES:
        raise ValueError(
            f"N={program.N} needs {smem_per_frame(program.N)} bytes of shared memory "
            f"per frame; one thread block has {SMEM_LIMIT_BYTES}")
    name = "sc_decode_sub" if program.subtree else "sc_decode"
    lib, fn = _launcher(library, name)
    B, n = llr.shape
    plan = launch_plan(program, B, llr.get_device())
    u = torch.empty((B, n), dtype=torch.int8, device=llr.device)
    ops = program.device_ops(llr.device)
    args = (llr.data_ptr(), u.data_ptr(), ops.data_ptr(), ops.shape[0], B, n, program.log2N,
            plan.frames_per_block)
    if program.subtree:
        scratch = torch.empty(B * dev_scratch_floats(n, plan.dev_levels), dtype=torch.float32,
                              device=llr.device)
        args += (plan.warps_per_frame, scratch.data_ptr(), plan.dev_levels)
    code = build.launch_on(llr.get_device(), fn, *args)
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
