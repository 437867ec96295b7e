"""SCL list-decoder kernels: wrappers, host-side node program, device state.

``csrc/scl_kernels.cuh`` (device functions in ``csrc/scl_device.cuh``) holds
four kernels, each one warp per frame with the chunk's working set in shared
memory, launched from one library each (``scl_body``, ``scl_decode``,
``scl_last``, ``scl_mega``: four ``nvcc`` builds side by side):

* ``scl_chunk_body``: replaces the TPU kernel
  ``polarcode_and_ldpc_tpu/ops/scl_body_pallas.py::make_chunk_body_pallas``;
  plain version ``models.polar.scanscl._make_chunk_body``;
* ``scl_chunk_step``: replaces
  ``ops/scl_superchunk_pallas.py::make_superchunk_pallas``; plain version
  ``models.polar.scanscl._make_super_fn``;
* ``scl_last_chunk``: replaces
  ``ops/scl_superchunk_pallas.py::make_last_superchunk_pallas``; plain version
  ``models.polar.scanscl._make_last_fn`` with ``transform=True``;
* ``scl_decode_mega``: replaces ``ops/scl_mega_pallas.py::make_scl_mega_pallas``,
  the whole chunked decode in one launch (the device functions of the chunk
  step and the last chunk, walked from a step table, on the chunk step's
  context; the level stacks in a scratch buffer that never leaves the
  launch); plain version: the ``"unroll-fused"`` chunk program of
  ``models.polar.scanscl``.

Bound: device-memory bytes (the touched level stacks, read and written once);
in practice latency, see the note at the top of the source.  Each kernel
equals its plain version bit for bit (same float expressions in the same
order, same candidate order), on bits, metrics and rank vectors.

Between launches the decode state lives on the device in ``SCLState``,
frame-major, path bits packed across the list axis into one 32-bit word per
position; the step kernels update it IN PLACE.  A wrapper uses the plain
version only for tensors that lie on the CPU (converting the state to the
plain version's operands and back); on CUDA tensors it launches the kernel
or raises.

A fast node program (``node_mode="fast"``, the SSCL fast list nodes) runs
through the same three per-chunk kernels, each in a compiled instance of its
own (``kFast``; the exact instances carry no fast code): its
``OP_RATE1_FAST`` / ``OP_REP_FAST`` ops and its fast ``OP_SUBTREE`` (the
small fast nodes in registers) are the fast modes of the TPU kernels K3 / K4
/ K5, and their launches are counted apart (``scl_chunk_step_fast`` …).  The one-launch
decode refuses a fast program, as the JAX package's mega control does.

One-hot permutations (``perm_impl="onehot"``, the default mode of the TPU
kernels' factories): the state holds each level's pendings as one-hot
``[L, L]`` float planes and the chunk body hands back its permutation as one;
the three per-chunk kernels read a plane as the column of each row's 1 into a
rank vector in shared memory, run the rank device functions, and write the
planes they change back as exact 0.0 / 1.0 planes.  The one place where the
one-hot algebra computes other floats than the rank algebra is the parent
alpha the descend's g reads through a pending: a one-hot apply is a sum, so a
selected −0.0 stays −0.0 only if the whole column is negative; the kernels
apply that rule, so their level stacks equal the plain one-hot step's bit for
bit.  Launches count apart (``scl_chunk_step_onehot`` …).  Exact nodes only,
as in the JAX package; the one-launch decode keeps rank vectors.

Live width (``make_step_specs(..., live=True)``, the TPU kernel's ``widths=``
mode of ``make_superchunk_pallas``): a chunk step whose live path count
``lv_in`` / ``lv_out`` is below L runs over the live rows only, reading and
writing exactly the rows and lanes the plain live-width step keeps.  Live
path counts only grow, so those narrow steps are the first positions of a
decode, and they run together, as one step table, in one launch
(``SCLPrefixSpec``, ``scl_narrow_prefix``): at a few live paths a step's
device work is tiny, and a launch of its own cost the host's issue of it.
The last chunk stays at full width, as in the JAX package.  Exact nodes
only.

Where the chunk context lives (decided on the host by size): in shared
memory when ``smem_per_frame`` fits one thread block, else in a scratch
buffer in device memory, one slice per resident warp (``_devmem`` launch
counts; a port mode: the JAX package runs such chunks in XLA).  The
one-launch decode keeps its refusal of a code whose chunk-step context one
block cannot hold.

Wide lists (``32 < L <= 64``): the kernels' wide instances hold two paths a
lane (lane l: paths l and l + 32) and a position's path bits as one 64-bit
word, so the state's ``beta`` is int64; the body, chunk step, narrow prefix
and last chunk each have one (launches counted apart, ``scl_chunk_step_wide``
…), shared or device memory alike.  XL lists (``64 < L <= 256``): instances
of their own, built from sources of their own (``scl_body_xl``,
``scl_decode_xl``, ``scl_last_xl``: the same launchers' names and
arguments), at four paths a lane up to 128 and eight up to 256
(``paths_per_lane``), a position's path bits ``kP`` 32-bit words, so the
state's ``beta`` is int32 ``[B, N − S, kP]`` (launches counted apart,
``scl_chunk_step_xl`` …).  Exact node programs on rank vectors only: the
fast nodes, the one-hot modes and the one-launch decode stay at ``L <= 32``
(ROADMAP.md queue B).

Precondition, as for the plain decoder: finite LLRs.
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from ..models.polar.construction import bit_reverse_permutation
from ..models.polar.encoder import polar_transform
from ..models.polar.scanscl import (_LEVELPAR_MAX, SCLSchedule, _make_chunk_body,
                                    _make_last_fn, _make_super_fn, decode_selector,
                                    init_metrics, live_state_widths, pad_paths, step_masks,
                                    variant_table)
from . import build, count_launch

OP_F, OP_G, OP_COMBINE, OP_RATE0, OP_LEAF, OP_REP, OP_RATE1_FAST, OP_REP_FAST, OP_SUBTREE = \
    range(9)
FLAG_RL, FLAG_RR = 1 << 8, 2 << 8
#: an ``OP_SUBTREE`` of a fast program: its nodes take the fast dispatch
FLAG_FAST = 4 << 8
#: the frozen bits of an ``OP_SUBTREE`` start at this bit of its op word
SUBTREE_SHIFT = 16
#: widest node a program decodes in registers (``OP_SUBTREE``), when its list
#: x size fits a warp
SUBTREE_MAX = 4

#: widest repetition subtree the REP op decodes (the plain version's rule)
REP_MAX = _LEVELPAR_MAX
#: widest list the kernels take: up to ``NARROW_LIST_MAX`` one path a lane and
#: a 32-bit word of path bits a position, up to ``WIDE_LIST_MAX`` (a wide list)
#: two paths a lane and a 64-bit word, above it (an XL list) four or eight
#: paths a lane and as many 32-bit words (``paths_per_lane``)
MAX_LIST = 256
NARROW_LIST_MAX = 32
WIDE_LIST_MAX = 64
#: shared memory one thread block may use on Hopper (bytes)
SMEM_LIMIT_BYTES = 232448
#: the most warps of a block (1024 threads); the kernels plan the warps per
#: block up to this from the SM's limits (``plan_warps`` in ``csrc/scl_kernels.cuh``)
_MAX_WARPS = 32
#: launch shape of the device-memory context: warps per block, blocks per SM
_DEVMEM_WARPS = 4
_DEVMEM_BLOCKS_PER_SM = 8


def build_scl_body_program(flags: np.ndarray, node_mode: str = "exact",
                           list_size: Optional[int] = None,
                           subtrees: bool = True) -> tuple[np.ndarray, bool]:
    """The static node program of one chunk pattern (``flags [S]`` bool in
    storage order, True = frozen): ``int32 [n_ops, 4]`` rows ``(op | flags,
    depth, size or half, beta_offset)``, walked exactly as the plain chunk
    body walks the pattern, and whether the chunk prunes at all (has a rank
    vector other than the identity).  ``node_mode="fast"`` emits the fast
    rate-1 and repetition ops; it needs ``list_size`` (a rate-1 node prunes
    only when ``L > 1``).  A program given ``list_size`` decodes every node
    of size 2 … ``SUBTREE_MAX`` with ``list_size · size <= 32`` as one
    ``OP_SUBTREE`` (its frozen bits from bit ``SUBTREE_SHIFT`` of the op
    word; ``FLAG_FAST`` in a fast program, whose subtree takes the fast
    dispatch), in registers, in the same order of operations;
    ``subtrees=False`` keeps the per-node ops (the work a program stands
    for)."""
    flags = np.asarray(flags, bool)
    S = len(flags)
    assert S >= 1 and S & (S - 1) == 0
    fast = node_mode == "fast"
    if fast and list_size is None:
        raise ValueError("a fast node program needs list_size")
    ops: list[tuple[int, int, int, int]] = []

    def node(depth: int, off: int, size: int, ops: list, fold: bool = True) -> bool:
        sub = flags[off:off + size]
        if (fold and list_size is not None and 2 <= size <= SUBTREE_MAX
                and list_size * size <= 32):
            bits = sum(1 << i for i in range(size) if sub[i])
            ops.append((OP_SUBTREE | (FLAG_FAST if fast else 0) | (bits << SUBTREE_SHIFT),
                        depth, size, off))
            return node(depth, off, size, [], fold=False)  # whether its nodes prune
        if sub.all():
            ops.append((OP_RATE0, depth, size, off))
            return False
        if size == 1:
            ops.append((OP_LEAF, depth, 1, off))
            return True
        if fast and not sub.any():
            ops.append((OP_RATE1_FAST, depth, size, off))
            return list_size > 1
        if fast and sub[:-1].all() and not sub[-1]:
            ops.append((OP_REP_FAST, depth, size, off))
            return True
        if not fast and sub[:-1].all() and not sub[-1] and size <= REP_MAX:
            ops.append((OP_REP, depth, size, off))
            return True
        half = size // 2
        ops.append((OP_F, depth, half, off))
        rl = node(depth + 1, off, half, ops, fold)
        ops.append((OP_G | (FLAG_RL if rl else 0), depth, half, off))
        rr = node(depth + 1, off + half, half, ops, fold)
        ops.append((OP_COMBINE | (FLAG_RL if rl else 0) | (FLAG_RR if rr else 0),
                    depth, half, off))
        return rl or rr

    has_r = node(0, 0, S, ops, subtrees)
    return np.asarray(ops, np.int32).reshape(-1, 4), has_r


class SCLBodyProgram:
    """A chunk pattern's node program plus its plain body (at the program's
    permutation algebra: the body hands back a rank vector, or a one-hot plane
    with ``perm_impl="onehot"``); device copies of the program are cached per
    device."""

    def __init__(self, flags: np.ndarray, list_size: int, node_mode: str = "exact",
                 perm_impl: str = "rank"):
        if not 1 <= list_size <= MAX_LIST:
            raise ValueError(
                f"the SCL kernels take list sizes 1..{MAX_LIST}, got {list_size}: a wider list "
                f"runs on the plain controls ('unroll-fused', 'split', 'fused'); the kernels' "
                f"lists above {MAX_LIST} are what is left of ROADMAP.md queue B item B7")
        if node_mode not in ("exact", "fast"):
            raise ValueError(f"unknown node_mode {node_mode!r}")
        if perm_impl not in ("rank", "onehot"):
            raise ValueError(f"unknown perm_impl {perm_impl!r}")
        if list_size > NARROW_LIST_MAX and node_mode == "fast":
            raise ValueError(
                f"the SCL kernels run fast nodes up to L={NARROW_LIST_MAX}, got {list_size}: "
                f"the wide-list fast nodes are ROADMAP.md queue B item B4; use node_mode='exact'")
        if list_size > NARROW_LIST_MAX and perm_impl == "onehot":
            raise ValueError(
                f"the SCL kernels run one-hot permutations up to L={NARROW_LIST_MAX}, got "
                f"{list_size}: the wide-list one-hot modes are ROADMAP.md queue B item B5; use "
                f"perm_impl='rank'")
        if node_mode == "fast" and perm_impl == "onehot":
            raise ValueError("the one-hot kernel modes have no fast nodes: node_mode='fast' "
                             "runs with perm_impl='rank'")
        self.flags = np.asarray(flags, bool)
        self.S = len(self.flags)
        self.lgS = int(np.log2(self.S))
        self.L = list_size
        self.fast = node_mode == "fast"
        self.onehot = perm_impl == "onehot"
        self.ops, self.has_r = build_scl_body_program(self.flags, node_mode, list_size)
        self.plain = _make_chunk_body(self.flags, list_size, node_mode, perm_impl)
        self._on_device: dict[torch.device, torch.Tensor] = {}

    def device_ops(self, device: torch.device) -> torch.Tensor:
        t = self._on_device.get(device)
        if t is None:
            t = torch.from_numpy(self.ops).to(device).contiguous()
            self._on_device[device] = t
        return t


def _round4(x: int) -> int:
    return (x + 3) & ~3


def paths_per_lane(L: int) -> int:
    """Paths a lane of the kernel instances that serve list ``L`` (``kP``):
    1 up to 32, 2 up to 64, 4 up to 128, 8 up to 256."""
    return 1 if L <= NARROW_LIST_MAX else 2 if L <= WIDE_LIST_MAX else 4 if L <= 128 else 8


def smem_per_frame(L: int, S: int, root_words: int = 0, onehot_levels: int = 0,
                   depth0: bool = True) -> int:
    """Bytes of shared memory one frame needs with ``depth0=False`` (mirrors
    ``scl::ctx_words``, ``scl::ctx_words_wide`` for a wide list, ``L >
    NARROW_LIST_MAX``: S 64-bit words of path bits, regions rounded up to four
    words, or ``scl::ctx_words_xl`` for an XL list, ``L > WIDE_LIST_MAX``: S
    positions of ``kP`` words, the saved rank vectors, the prune's 2L words;
    every kernel reads the chunk's top plane where it lies in device memory),
    plus ``root_words`` for the last chunk's root plane and, for a
    one-hot state of ``onehot_levels`` levels, the two pendings' rank vectors
    that the one-hot kernels stage (``2 · levels · L`` words).  The default
    ``depth0=True`` adds a top plane of ``L · S`` words: the size the
    device-memory threshold counts (``context_in_device_memory``)."""
    lgS = int(np.log2(S))
    if L > WIDE_LIST_MAX:
        ctx = _round4(S * L) + paths_per_lane(L) * S + _round4(L * (lgS + 1)) + _round4(2 * L)
    elif L > NARROW_LIST_MAX:
        ctx = _round4(S * L) + 2 * S + _round4(L * (2 + lgS + 1))
    else:
        ctx = S * L + S + L * (2 + lgS + 1)
    return 4 * ((S * L if depth0 else 0) + ctx + root_words + 2 * onehot_levels * L)


def last_root_words(L: int, S: int, N: int) -> int:
    """Words of the last chunk's own root plane (``last_root_words`` of
    ``csrc/scl_kernels.cuh``; ``last_root_words_wide`` for a wide list, whose
    root plane is ``N`` 64-bit words, ``last_root_words_xl`` for an XL list,
    ``N`` positions of ``kP`` words): none when the context's alpha region
    (``L · S`` words, dead once the body has returned) holds it."""
    words = paths_per_lane(L) * N
    return words if words > L * S else 0


def _warps_per_block(per_frame: int, what: str) -> int:
    """The most warps one block may hold at ``per_frame`` bytes each (the
    kernels plan within it); raises if one frame does not fit a block."""
    if per_frame > SMEM_LIMIT_BYTES:
        raise ValueError(
            f"{what} needs {per_frame} bytes of shared memory per frame; "
            f"one thread block has {SMEM_LIMIT_BYTES}")
    return max(1, min(_MAX_WARPS, SMEM_LIMIT_BYTES // per_frame))


def context_in_device_memory(L: int, S: int, root_words: int = 0,
                             onehot_levels: int = 0) -> bool:
    """Whether a per-chunk kernel keeps its chunk context in device memory:
    the context with its top plane (plus ``root_words`` for the last chunk's
    root plane, plus the staged rank vectors of ``onehot_levels`` one-hot
    levels) does not fit one thread block's shared memory; the kernels,
    whose contexts have no top plane, take the same threshold."""
    return smem_per_frame(L, S, root_words, onehot_levels) > SMEM_LIMIT_BYTES


def _context_plan(L: int, S: int, root_words: int, B: int, device, onehot_levels: int = 0):
    """``(warps per block, grid, scratch)`` of a per-chunk launch on the
    chunk step's context (no top plane: ``smem_per_frame(..., depth0=False)``,
    every kernel reads its chunk's top plane in device memory): in shared
    memory (``scratch`` None, the grid covering the batch, the warps per
    block the bound the kernel plans within), or in a device-memory scratch
    of ``grid`` blocks of ``_DEVMEM_WARPS`` warps, one context slice per
    warp, walking the frames.  The mode's threshold is the context with its
    top plane (``context_in_device_memory``): the smaller context would fit
    one block at S=1024, L=32, but at one warp per SM, which runs slower than
    the device-memory mode's 12 warps per SM (NVIDIA H100 80GB HBM3, 700 W,
    ``tools/scl_kernel_ab.py``)."""
    per_frame = smem_per_frame(L, S, root_words, onehot_levels, depth0=False)
    if not context_in_device_memory(L, S, root_words, onehot_levels):
        return _warps_per_block(per_frame, "a chunk context"), 0, None
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    grid = min(-(-B // _DEVMEM_WARPS), sms * _DEVMEM_BLOCKS_PER_SM)
    scratch = torch.empty((grid * _DEVMEM_WARPS * per_frame // 4,), dtype=torch.float32,
                          device=device)
    return _DEVMEM_WARPS, grid, scratch


def _list_suffix(L: int) -> str:
    """The launch counters' suffix of the instances that serve list ``L``."""
    return "_xl" if L > WIDE_LIST_MAX else "_wide" if L > NARROW_LIST_MAX else ""


def _count(base: str, program: "SCLBodyProgram", scratch) -> None:
    """Count one launch under the name of its kernel mode."""
    count_launch(base + ("_fast" if program.fast else "") + ("_onehot" if program.onehot else "")
                 + _list_suffix(program.L) + ("_devmem" if scratch is not None else ""))


def _check_cuda_f32(x: torch.Tensor, what: str, shape: tuple) -> None:
    if x.device.type != "cuda":
        raise ValueError(f"{what} needs a CUDA tensor, got {x.device}")
    if x.dtype != torch.float32:
        raise TypeError(f"the SCL kernels are float32 only, got {x.dtype} for {what}")
    if tuple(x.shape) != shape:
        raise ValueError(f"expected {what} {shape}, got {tuple(x.shape)}")
    if not x.is_contiguous():
        raise ValueError(f"{what} must be contiguous")


_P = ctypes.c_void_p
_I = ctypes.c_int


#: the library that launches each kernel
_LIBRARY = {"scl_chunk_body_launch": "scl_body", "scl_chunk_step_launch": "scl_decode",
            "scl_narrow_prefix_launch": "scl_decode", "scl_last_chunk_launch": "scl_last",
            "scl_decode_mega_launch": "scl_mega"}


def _library(library: str, L: int) -> str:
    """The library whose launchers serve list ``L``: ``library``, or for an
    XL list its XL source's (``scl_decode`` → ``scl_decode_xl``; no other
    variant has XL instances)."""
    if L <= WIDE_LIST_MAX:
        return library
    if library not in ("scl_body", "scl_decode", "scl_last"):
        raise ValueError(f"{library} has no instances for lists above {WIDE_LIST_MAX}, got {L}")
    return library + "_xl"


def _launcher(name: str, argtypes: list, library: Optional[str] = None):
    lib = build.load(library or _LIBRARY[name])
    fn = getattr(lib, name)
    fn.restype = ctypes.c_int
    fn.argtypes = argtypes
    return lib, fn


def kernel_resources(L: int, S: int, N: int, t: int) -> list:
    """Registers, local memory (spills) and resident warps per SM of every
    compiled variant of the four list kernels that serves list ``L`` (the XL
    instances of ``L``'s paths a lane for ``L > WIDE_LIST_MAX``, the wide
    ones for ``L > NARROW_LIST_MAX``, else the others), each at the launch
    plan its launcher makes for a code of length ``N``, chunk ``S``, list
    ``L`` with ``t`` levels (the device-memory variants at theirs).  Needs a
    CUDA device."""
    out = []
    wide = L > NARROW_LIST_MAX
    xl = f"_xl{paths_per_lane(L)}"
    libraries = (("scl_body_xl", "scl_decode_xl", "scl_last_xl") if L > WIDE_LIST_MAX
                 else ("scl_body", "scl_decode", "scl_last", "scl_mega"))
    for library in libraries:
        lib = build.load(library)
        lib.scl_kernel_name.restype = ctypes.c_char_p
        lib.scl_kernel_name.argtypes = [_I]
        lib.scl_kernel_report.restype = ctypes.c_int
        lib.scl_kernel_report.argtypes = [_I] * 7 + [_P]
        for which in range(lib.scl_kernel_count()):
            name = lib.scl_kernel_name(which).decode()
            if not (xl in name if L > WIDE_LIST_MAX else ("_wide" in name) == wide):
                continue
            vals = (ctypes.c_int * 5)()
            code = lib.scl_kernel_report(which, L, S, N, t, _MAX_WARPS, _DEVMEM_WARPS,
                                         ctypes.addressof(vals))
            build.check_launch(lib, code, f"scl_kernel_report({name})")
            out.append({"kernel": name, "registers": vals[0], "local_bytes": vals[1],
                        "warps_per_block": vals[3], "smem_per_block": vals[4],
                        "resident_warps_per_sm": vals[2]})
    return out


# ---------------------------------------------------------------------------
# K5: the chunk body
# ---------------------------------------------------------------------------

def scl_chunk_body_cuda(alpha: torch.Tensor, pm: torch.Tensor, program: SCLBodyProgram):
    """Launch the chunk-body kernel: ``alpha [B, L, S]`` float32, ``pm [B,
    L]`` → ``(beta [B, L, S] int8, pm' [B, L], R)`` with ``R`` a rank vector
    ``[B, L]`` int64, or a one-hot plane ``[B, L, L]`` float32 for a one-hot
    program.  Does not synchronise."""
    beta, pm_out, r_out, ctx = launch_chunk_body(alpha, pm, program, "scl_body")
    _count("scl_chunk_body", program, ctx)
    return beta, pm_out, r_out


def launch_chunk_body(alpha: torch.Tensor, pm: torch.Tensor, program: SCLBodyProgram,
                      library: str):
    """The chunk body's launch through the launcher of ``library``
    (``"scl_body"``, or its profiled variant ``"scl_body_profile"``),
    uncounted: ``(beta, pm', R, device-memory context)`` (the context None:
    in shared memory)."""
    B = alpha.shape[0] if alpha.dim() == 3 else -1
    L, S = program.L, program.S
    if B < 1:
        raise ValueError(f"expected alpha [B>=1, {L}, {S}], got {tuple(alpha.shape)}")
    _check_cuda_f32(alpha, "alpha", (B, L, S))
    _check_cuda_f32(pm, "pm", (B, L))
    dev = alpha.device
    warps, grid, ctx = _context_plan(L, S, 0, B, dev)
    lib, fn = _launcher("scl_chunk_body_launch", [_P] * 6 + [_I] * 9 + [_P, _I, _P],
                        _library(library, L))
    beta = torch.empty((B, L, S), dtype=torch.int8, device=dev)
    pm_out = torch.empty((B, L), dtype=torch.float32, device=dev)
    r_out = (torch.empty((B, L, L), dtype=torch.float32, device=dev) if program.onehot
             else torch.empty((B, L), dtype=torch.int64, device=dev))
    ops = program.device_ops(dev)
    code = build.launch_on(dev.index, fn, alpha.data_ptr(), pm.data_ptr(), beta.data_ptr(),
                           pm_out.data_ptr(), r_out.data_ptr(), ops.data_ptr(), ops.shape[0],
                           int(program.has_r), B, S, L, program.lgS, int(program.onehot),
                           int(program.fast), warps,
                           ctx.data_ptr() if ctx is not None else None, grid)
    build.check_launch(lib, code, "scl_chunk_body")
    return beta, pm_out, r_out, ctx


def scl_chunk_body(alpha: torch.Tensor, pm: torch.Tensor, program: SCLBodyProgram):
    """One chunk's list decode: the plain version for CPU tensors, the kernel
    for CUDA tensors."""
    if alpha.device.type == "cpu":
        return program.plain(alpha, pm)
    return scl_chunk_body_cuda(alpha.contiguous(), pm.contiguous(), program)


def make_chunk_body_cuda(flags: np.ndarray, list_size: int, node_mode: str = "exact",
                         perm_impl: str = "rank"):
    """``body(alpha, pm) → (beta, pm', R)`` through ``scl_chunk_body``, for
    use inside the plain chunk program (``body_impl="cuda"``)."""
    program = SCLBodyProgram(flags, list_size, node_mode, perm_impl)

    def body(alpha, pm):
        return scl_chunk_body(alpha, pm, program)

    return body


# ---------------------------------------------------------------------------
# the decode state between launches
# ---------------------------------------------------------------------------

def path_word_dtype(L: int) -> torch.dtype:
    """The state's word of a position's path bits: int32 up to
    ``NARROW_LIST_MAX`` paths, int64 for a wide list, int32 (``kP`` of them a
    position) for an XL list."""
    return torch.int64 if NARROW_LIST_MAX < L <= WIDE_LIST_MAX else torch.int32


def beta_shape(B: int, M: int, L: int) -> tuple:
    """The shape of ``M`` positions' path bits of ``B`` frames: ``[B, M]``
    words up to ``WIDE_LIST_MAX`` paths, ``[B, M, kP]`` for an XL list."""
    return (B, M, paths_per_lane(L)) if L > WIDE_LIST_MAX else (B, M)


def pack_paths(bits: torch.Tensor, L: Optional[int] = None) -> torch.Tensor:
    """``[B, w, M]`` 0/1 int8 → words of ``beta_shape(B, M, L)``
    (``path_word_dtype(L)``, L the list size, ``w`` by default): bit l =
    path l, or for an XL list bit l mod 32 of word l // 32."""
    B, w, M = bits.shape
    L = L or w
    if L <= WIDE_LIST_MAX:
        sh = torch.arange(w, device=bits.device, dtype=torch.int64)[None, :, None]
        return (bits.to(torch.int64) << sh).sum(dim=1).to(path_word_dtype(L))
    kP = paths_per_lane(L)
    full = torch.zeros((B, 32 * kP, M), dtype=torch.int64, device=bits.device)
    full[:, :w] = bits
    sh = torch.arange(32, device=bits.device, dtype=torch.int64)[None, None, :, None]
    words = (full.view(B, kP, 32, M) << sh).sum(dim=2)  # [B, kP, M], 0 .. 2^32 - 1
    words = torch.where(words >= 2 ** 31, words - 2 ** 32, words)
    return words.transpose(1, 2).to(torch.int32).contiguous()


def unpack_paths(words: torch.Tensor, L: int) -> torch.Tensor:
    """Words ``[B, M]`` (int32 or int64) or ``[B, M, kP]`` (int32, an XL
    list) → ``[B, L, M]`` int8 bit planes of the first ``L`` paths."""
    if words.dim() == 3:
        paths = torch.arange(L, device=words.device)
        sel = words[:, :, paths >> 5]  # [B, M, L]: each path's word
        return ((sel >> (paths & 31).to(words.dtype)) & 1).transpose(1, 2).to(torch.int8)
    sh = torch.arange(L, device=words.device, dtype=words.dtype)[None, :, None]
    return ((words[:, None, :] >> sh) & 1).to(torch.int8)


class SCLState:
    """The level stacks of a batch of frames between chunk launches, in the
    layout the kernels read (see ``csrc/scl_kernels.cuh``): ``llr [B, N]``
    (bit-reversed storage), ``alpha [B, L·(N−S)]``, ``beta [B, N−S]`` packed
    words (int32, int64 for a wide list: ``path_word_dtype``; an XL list's
    ``[B, N−S, kP]`` int32: ``beta_shape``), ``pend_a`` /
    ``pend_b [B, t, L]`` int32 rank vectors (with ``perm_impl="onehot"``:
    ``[B, t, L, L]`` one-hot planes in the LLRs' dtype), ``pm [B, L]``."""

    def __init__(self, sched: SCLSchedule, llr_rev: torch.Tensor, perm_impl: str = "rank"):
        assert sched.C > 1, "a single-chunk code keeps no level stacks"
        self.sched = sched
        self.onehot = perm_impl == "onehot"
        N, S, L, t = sched.N, sched.S, sched.L, sched.t
        B, dev = llr_rev.shape[0], llr_rev.device
        self.llr = llr_rev
        self.alpha = torch.zeros((B, L * (N - S)), dtype=llr_rev.dtype, device=dev)
        self.beta = torch.zeros(beta_shape(B, N - S, L), dtype=path_word_dtype(L), device=dev)
        if self.onehot:
            eye = torch.eye(L, dtype=llr_rev.dtype, device=dev).expand(B, t, L, L)
        else:
            eye = torch.arange(L, dtype=torch.int32, device=dev).expand(B, t, L)
        self.pend_a = eye.contiguous()
        self.pend_b = eye.contiguous()
        self.pm = init_metrics(B, L, L, llr_rev.dtype, dev)

    def clone(self) -> "SCLState":
        other = object.__new__(SCLState)
        other.sched, other.llr, other.onehot = self.sched, self.llr, self.onehot
        for name in ("alpha", "beta", "pend_a", "pend_b", "pm"):
            setattr(other, name, getattr(self, name).clone())
        return other

    def _alpha_off(self, l: int) -> int:
        return self.sched.L * (self.sched.N - (self.sched.N >> (l - 1)))

    def _beta_off(self, l: int) -> int:
        return self.sched.N - (self.sched.N >> (l - 1))

    def to_plain(self, widths=None):
        """``(alpha, pend_a, beta, pend_b, pm)`` as the plain chunk step
        takes them: at full list width, or at the live-width control's
        ``widths = (wa, wb, wpa, wpb, pm width)`` (a step spec's
        ``widths``), the first rows and lanes of each level."""
        s, L = self.sched, self.sched.L
        B = self.pm.shape[0]
        full = (L,) * s.t
        wa, wb, wpa, wpb, wpm = widths or (full, full, full, full, L)
        alpha, beta = [], []
        for l in range(1, s.t + 1):
            M = s.sizes[l]
            a0, b0 = self._alpha_off(l), self._beta_off(l)
            alpha.append(self.alpha[:, a0:a0 + wa[l - 1] * M].reshape(B, wa[l - 1], M))
            beta.append(unpack_paths(self.beta[:, b0:b0 + M], wb[l - 1]))
        if self.onehot:  # full width only: the planes as they are
            pend_a = tuple(self.pend_a[:, i] for i in range(s.t))
            pend_b = tuple(self.pend_b[:, i] for i in range(s.t))
        else:
            pend_a = tuple(self.pend_a[:, i, :wpa[i]].to(torch.int64) for i in range(s.t))
            pend_b = tuple(self.pend_b[:, i, :wpb[i]].to(torch.int64) for i in range(s.t))
        return tuple(alpha), pend_a, tuple(beta), pend_b, self.pm[:, :wpm]

    def load_plain(self, alpha, pend_a, beta, pend_b, pm) -> None:
        """Overwrite the state with the plain chunk step's operands, each
        level's first rows / lanes at the width the plain step hands back
        (the others are untouched: phantom metrics stay −inf)."""
        s = self.sched
        B = pm.shape[0]
        for l in range(1, s.t + 1):
            M = s.sizes[l]
            a0, b0 = self._alpha_off(l), self._beta_off(l)
            w = alpha[l - 1].shape[1]
            self.alpha[:, a0:a0 + w * M] = alpha[l - 1].reshape(B, w * M)
            self.beta[:, b0:b0 + M] = pack_paths(beta[l - 1], s.L)
            self.pend_a[:, l - 1, :pend_a[l - 1].shape[1]] = pend_a[l - 1].to(self.pend_a.dtype)
            self.pend_b[:, l - 1, :pend_b[l - 1].shape[1]] = pend_b[l - 1].to(self.pend_b.dtype)
        self.pm[:, :pm.shape[1]] = pm


@dataclass
class SCLStepSpec:
    """The arguments of one ``scl_chunk_step`` launch: descend ``(k, inv)``,
    ascend count ``j``, the compose masks as bit masks over level indices,
    the chunk's node program, and the plain version of the same step.  Live
    width: the live paths ``lv_in`` / ``lv_out`` (both L at full width), the
    level bit masks ``one_a`` / ``one_b`` of the pendings that the plain
    live-width step keeps at one lane (read by every slot), and ``widths``,
    the plain step's operand widths (``SCLState.to_plain``; None: full)."""
    k: int
    inv: bool
    j: int
    mask_a: int
    mask_b: int
    program: SCLBodyProgram
    plain: object
    lv_in: int
    lv_out: int
    one_a: int = 0
    one_b: int = 0
    widths: Optional[tuple] = None

    @property
    def narrow(self) -> bool:
        return self.lv_in < self.program.L or self.lv_out < self.program.L


def _bitmask(levels) -> int:
    return sum(1 << int(i) for i in levels)


def make_step_specs(sched: SCLSchedule, programs: Optional[list] = None,
                    node_mode: str = "exact", live: bool = False, union: bool = False):
    """``(step specs of chunks 0..C−2, last-chunk spec)`` of a schedule;
    ``live=True``: the chunk steps at the schedule's live path counts (exact
    nodes, rank vectors only), those below L (the first positions: live
    path counts only grow) as ONE spec, an ``SCLPrefixSpec`` in front of the
    full-width steps, and the last chunk at full width on the live-width
    state; ``union=True``: the compose masks united per variant
    (``scanscl.union_masks``: the control ``"kernel"`` and
    ``mask_dedup="union"``), except with ``live`` (``scanscl.step_masks``:
    a united mask's extra levels are dead at that position, and the live
    steps leave them out).  Positions of one variant share one spec (the
    variant table of ``scanscl.variant_table``).  The programs' permutation
    algebra is that of the state the specs run on; the default programs are
    rank programs (``SCLBodyProgram(..., perm_impl="onehot")`` builds one-hot
    ones)."""
    if programs is None:
        programs = [SCLBodyProgram(f, sched.L, node_mode) for f in sched.unique_flags]
    if live and any(p.fast or p.onehot for p in programs):
        raise ValueError("live width runs exact node programs on rank vectors")
    perm = "onehot" if programs[0].onehot else "rank"
    t, sizes, L, C = sched.t, sched.sizes, sched.L, sched.C
    masks = step_masks(sched, union, live)
    widths = live_state_widths(sched, masks) if live else None

    def width_args(c: int) -> dict:
        if not live:
            return {}
        wa, wb, wpa, wpb = widths[c]
        return dict(one_a=_bitmask(i for i in range(t) if wpa[i] == 1),
                    one_b=_bitmask(i for i in range(t) if wpb[i] == 1),
                    widths=(wa, wb, wpa, wpb, sched.lv_in[c]))

    lv_in = sched.lv_in if live else (L,) * C
    lv_out = sched.lv_out if live else (L,) * C
    variants, tid = variant_table(sched, masks, lv_in, lv_out,
                                  extra=widths[:C - 1] if live else None)
    first = {v: tid.index(v) for v in range(len(variants))}
    specs = []
    for v, key in enumerate(variants):
        sel, pid, j, ca, cb, lvi, lvo = key[:7]
        k, inv = decode_selector(sel, t)
        prog = programs[pid]
        specs.append(SCLStepSpec(
            k=k, inv=inv, j=j, mask_a=_bitmask(ca), mask_b=_bitmask(cb), program=prog,
            plain=_make_super_fn(sel, j, t, sizes, L, prog.plain, compose_a=ca, compose_b=cb,
                                 lv_in=lvi, lv_out=lvo, perm_impl=perm),
            lv_in=lvi, lv_out=lvo, **width_args(first[v])))
    steps = [specs[tid[c]] for c in range(C - 1)]
    prog = programs[sched.pattern_ids[C - 1]]
    lv_last = sched.lv_in[C - 1] if live else L
    last = SCLStepSpec(k=0, inv=False, j=t, mask_a=0, mask_b=0, program=prog,
                       plain=_make_last_fn(t, sizes, L, prog.plain, transform=True,
                                           lv_in=lv_last, perm_impl=perm),
                       lv_in=L, lv_out=L, **width_args(C - 1))
    if live:
        p = next((c for c, spec in enumerate(steps) if not spec.narrow), len(steps))
        if any(spec.narrow for spec in steps[p:]):
            raise ValueError("the narrow (live-width) chunk steps are not a prefix of the decode")
        if p:
            steps = [SCLPrefixSpec(steps[:p]), *steps[p:]]
    return steps, last


#: the most narrow steps one ``scl_narrow_prefix`` launch takes in its launch
#: parameters (``kPrefixParamRows`` of ``csrc/scl_kernels.cuh``); a longer
#: prefix runs as consecutive launches of at most that many rows
PREFIX_PARAM_ROWS = 64
#: columns of one row of the narrow prefix's step table (``StepArgs`` of
#: ``csrc/scl_kernels.cuh``)
PREFIX_TABLE_COLUMNS = ("k", "inv", "j", "mask_a", "mask_b", "prog_off", "n_ops", "has_R",
                        "lv_in", "lv_out", "one_a", "one_b")


class SCLPrefixSpec:
    """The narrow prefix of a live decode as one spec: its narrow chunk steps
    ``steps`` (``SCLStepSpec``, positions 0 … P−1 in order, exact node
    programs on rank vectors; their plain versions run it on the CPU), their
    step table ``rows`` (int32 ``[P, 12]``, ``PREFIX_TABLE_COLUMNS``) and
    their node programs back to back, ``prog`` (int32 ``[n, 4]``, each
    distinct program once, at the offset of its rows' ``prog_off``); the
    device copy of ``prog`` is cached per device.  A prefix of one step is
    exactly that narrow step."""

    def __init__(self, steps):
        self.steps = list(steps)
        if not self.steps or not all(s.narrow for s in self.steps):
            raise ValueError("a narrow prefix holds one or more narrow (live-width) chunk steps")
        if any(s.program.fast or s.program.onehot or s.program.L != self.steps[0].program.L
               for s in self.steps):
            raise ValueError("a narrow prefix runs exact node programs of one list size on "
                             "rank vectors")
        offsets, progs, n = {}, [], 0
        for s in self.steps:
            if id(s.program) not in offsets:
                offsets[id(s.program)] = n
                progs.append(s.program)
                n += len(s.program.ops)
        self.programs = progs
        self.prog = np.ascontiguousarray(np.concatenate([p.ops for p in progs]), dtype=np.int32)
        self.rows = np.asarray(
            [[s.k, int(s.inv), s.j, s.mask_a, s.mask_b, offsets[id(s.program)],
              len(s.program.ops), int(s.program.has_r), s.lv_in, s.lv_out, s.one_a, s.one_b]
             for s in self.steps], np.int32).reshape(-1, len(PREFIX_TABLE_COLUMNS))
        self._on_device: dict[torch.device, torch.Tensor] = {}

    def device_prog(self, device: torch.device) -> torch.Tensor:
        t = self._on_device.get(device)
        if t is None:
            t = torch.from_numpy(self.prog).to(device).contiguous()
            self._on_device[device] = t
        return t


def _check_state(state: SCLState, program: SCLBodyProgram) -> None:
    s = state.sched
    B = state.pm.shape[0]
    _check_cuda_f32(state.llr, "llr", (B, s.N))
    _check_cuda_f32(state.alpha, "alpha", (B, s.L * (s.N - s.S)))
    _check_cuda_f32(state.pm, "pm", (B, s.L))
    if state.onehot != program.onehot:
        raise ValueError("the state's permutation algebra is not the program's")
    pend = ((B, s.t, s.L, s.L), torch.float32) if state.onehot else ((B, s.t, s.L), torch.int32)
    for name, (shape, dtype) in (("beta", (beta_shape(B, s.N - s.S, s.L), path_word_dtype(s.L))),
                                 ("pend_a", pend), ("pend_b", pend)):
        x = getattr(state, name)
        if x.dtype != dtype or tuple(x.shape) != shape or not x.is_contiguous() \
                or x.device != state.llr.device:
            raise ValueError(f"state.{name} must be contiguous {dtype} {shape} on "
                             f"{state.llr.device}")


# ---------------------------------------------------------------------------
# K3: one chunk step;  K4: the last chunk
# ---------------------------------------------------------------------------

def scl_chunk_step_cuda(state: SCLState, spec: SCLStepSpec) -> None:
    """Launch the chunk-step kernel on the state, IN PLACE (full width; a
    narrow step runs in ``scl_narrow_prefix_cuda``).  Does not synchronise."""
    ctx = launch_chunk_step(state, spec, "scl_decode")
    _count("scl_chunk_step", spec.program, ctx)


def launch_chunk_step(state: SCLState, spec: SCLStepSpec, library: str):
    """The chunk step's launch through the launcher of ``library``
    (``"scl_decode"``, or a variant of it such as the profiled
    ``"scl_decode_profile"``), uncounted; returns the device-memory context
    (None: in shared memory)."""
    if spec.narrow:
        raise ValueError("a narrow (live-width) chunk step runs in scl_narrow_prefix_cuda "
                         "(a prefix of one step is that step)")
    _check_state(state, spec.program)
    s = state.sched
    B = state.pm.shape[0]
    dev = state.llr.device
    warps, grid, ctx = _context_plan(s.L, s.S, 0, B, dev, s.t if state.onehot else 0)
    lib, fn = _launcher("scl_chunk_step_launch", [_P] * 7 + [_I] * 16 + [_P, _I, _P],
                        _library(library, s.L))
    ops = spec.program.device_ops(dev)
    code = build.launch_on(dev.index, fn, state.llr.data_ptr(), state.alpha.data_ptr(),
                           state.beta.data_ptr(), state.pend_a.data_ptr(),
                           state.pend_b.data_ptr(), state.pm.data_ptr(), ops.data_ptr(),
                           ops.shape[0], int(spec.program.has_r), B, s.N, s.S, s.L, s.t,
                           spec.program.lgS, spec.k, int(spec.inv), spec.j, spec.mask_a,
                           spec.mask_b, int(state.onehot), int(spec.program.fast), warps,
                           ctx.data_ptr() if ctx is not None else None, grid)
    build.check_launch(lib, code, "scl_chunk_step")
    return ctx


def scl_chunk_step(state: SCLState, spec: SCLStepSpec) -> None:
    """One chunk step on the state, in place: the plain version for a state
    on the CPU, the kernel for a state on a CUDA device."""
    if state.llr.device.type == "cpu":
        state.load_plain(*spec.plain(state.llr, *state.to_plain(spec.widths)))
        return
    scl_chunk_step_cuda(state, spec)


def scl_narrow_prefix_cuda(state: SCLState, prefix: SCLPrefixSpec) -> None:
    """Launch the narrow prefix on the state, IN PLACE: one
    ``scl_narrow_prefix`` launch (consecutive launches of at most
    ``PREFIX_PARAM_ROWS`` steps for a longer prefix).  Does not synchronise."""
    launches, ctx = launch_narrow_prefix(state, prefix, "scl_decode")
    for _ in range(launches):
        count_launch("scl_narrow_prefix" + _list_suffix(state.sched.L)
                     + ("_devmem" if ctx is not None else ""))


def launch_narrow_prefix(state: SCLState, prefix: SCLPrefixSpec, library: str):
    """The narrow prefix's launches through the launcher of ``library``
    (``"scl_decode"``, or a variant of it such as the profiled
    ``"scl_decode_profile"``), uncounted: ``(launches, device-memory
    context)`` (the context None: in shared memory)."""
    for program in prefix.programs:
        _check_state(state, program)
    program = prefix.programs[0]
    s = state.sched
    B = state.pm.shape[0]
    dev = state.llr.device
    warps, grid, ctx = _context_plan(s.L, s.S, 0, B, dev)
    lib, fn = _launcher("scl_narrow_prefix_launch", [_P] * 8 + [_I] * 8 + [_P, _I, _P],
                        _library(library, s.L))
    prog = prefix.device_prog(dev)
    launches = 0
    for lo in range(0, len(prefix.rows), PREFIX_PARAM_ROWS):
        rows = prefix.rows[lo:lo + PREFIX_PARAM_ROWS]
        code = build.launch_on(dev.index, fn, state.llr.data_ptr(), state.alpha.data_ptr(),
                               state.beta.data_ptr(), state.pend_a.data_ptr(),
                               state.pend_b.data_ptr(), state.pm.data_ptr(), prog.data_ptr(),
                               rows.ctypes.data, len(rows), B, s.N, s.S, s.L, s.t,
                               program.lgS, warps, ctx.data_ptr() if ctx is not None else None,
                               grid)
        build.check_launch(lib, code, "scl_narrow_prefix")
        launches += 1
    return launches, ctx


def scl_narrow_prefix(state: SCLState, prefix: SCLPrefixSpec) -> None:
    """The narrow prefix on the state, in place: its plain narrow steps in
    order for a state on the CPU, the kernel for a state on a CUDA device."""
    if state.llr.device.type == "cpu":
        for spec in prefix.steps:
            scl_chunk_step(state, spec)
        return
    scl_narrow_prefix_cuda(state, prefix)


def scl_last_chunk_cuda(state: SCLState, spec: SCLStepSpec):
    """Launch the last-chunk kernel (full width): ``(u [B, L, N] int8
    natural order, pm [B, L])``.  The state is read only.  Does not
    synchronise."""
    u, pm_out, ctx = launch_last_chunk(state, spec, "scl_last")
    _count("scl_last_chunk", spec.program, ctx)
    return u, pm_out


def launch_last_chunk(state: SCLState, spec: SCLStepSpec, library: str):
    """The last chunk's launch through the launcher of ``library``
    (``"scl_last"``, or a variant of it such as the profiled
    ``"scl_last_profile"``), uncounted: ``(u, pm, device-memory context)``
    (the context None: in shared memory)."""
    _check_state(state, spec.program)
    s = state.sched
    B = state.pm.shape[0]
    dev = state.llr.device
    warps, grid, ctx = _context_plan(s.L, s.S, last_root_words(s.L, s.S, s.N), B, dev,
                                     s.t if state.onehot else 0)
    lib, fn = _launcher("scl_last_chunk_launch", [_P] * 10 + [_I] * 14 + [_P, _I, _P],
                        _library(library, s.L))
    u = torch.empty((B, s.L, s.N), dtype=torch.int8, device=dev)
    pm_out = torch.empty((B, s.L), dtype=torch.float32, device=dev)
    top = torch.empty((B, s.L * s.S), dtype=torch.float32, device=dev)  # scratch
    ops = spec.program.device_ops(dev)
    code = build.launch_on(dev.index, fn, state.llr.data_ptr(), state.alpha.data_ptr(),
                           state.beta.data_ptr(), state.pend_a.data_ptr(),
                           state.pend_b.data_ptr(), state.pm.data_ptr(), u.data_ptr(),
                           pm_out.data_ptr(), top.data_ptr(), ops.data_ptr(), ops.shape[0],
                           int(spec.program.has_r), B, s.N, s.S, s.L, s.t, spec.program.lgS,
                           int(np.log2(s.N)), spec.one_a, spec.one_b, int(state.onehot),
                           int(spec.program.fast), warps,
                           ctx.data_ptr() if ctx is not None else None, grid)
    build.check_launch(lib, code, "scl_last_chunk")
    return u, pm_out, ctx


def scl_last_chunk(state: SCLState, spec: SCLStepSpec):
    """The last chunk, the ascend to the root and the butterfly: ``(u [B, L,
    N] int8 natural order, pm [B, L])``."""
    if state.llr.device.type == "cpu":
        u_rev, pm = spec.plain(state.llr, *state.to_plain(spec.widths))
        L = state.sched.L
        rev = torch.as_tensor(np.asarray(bit_reverse_permutation(state.sched.N)),
                              dtype=torch.int64)
        return pad_paths(u_rev, L, 0)[..., rev], pad_paths(pm, L, -torch.inf)
    return scl_last_chunk_cuda(state, spec)


# ---------------------------------------------------------------------------
# K6: the whole decode in one launch
# ---------------------------------------------------------------------------

#: columns of one row of the step table of ``scl_decode_mega`` (``MegaRow`` of
#: ``csrc/scl_kernels.cuh``)
STEP_TABLE_COLUMNS = ("k", "inv", "j", "mask_a", "mask_b", "prog_off", "n_ops", "has_R")
#: the most chunks whose step table the one-launch decode takes in its launch
#: parameters (``kMegaParamRows`` of ``csrc/scl_kernels.cuh``); a longer table
#: is read from device memory (``scl_decode_mega_long``)
MEGA_PARAM_ROWS = 80


def build_mega_tables(sched: SCLSchedule, programs: Optional[list] = None):
    """The host-side tables of the one-launch decode: ``(prog int32 [n, 4],
    steps int32 [C, 8])``.  ``prog`` is the node programs of the code's
    distinct chunk patterns back to back; row ``c`` of ``steps`` holds chunk
    ``c``'s launch arguments (``STEP_TABLE_COLUMNS``; the last row is the last
    chunk, which reads only its program columns).  A fast node program
    raises ``ValueError``: the one-launch decode has no fast nodes."""
    if programs is None:
        programs = [SCLBodyProgram(f, sched.L) for f in sched.unique_flags]
    if any(p.fast for p in programs):
        raise ValueError("the one-launch list decode (scl_decode_mega) has no fast nodes: "
                         "node_mode='fast' runs on the per-chunk kernels")
    offsets = np.concatenate([[0], np.cumsum([len(p.ops) for p in programs])])
    prog = np.concatenate([p.ops for p in programs]).astype(np.int32)
    rows = []
    for c in range(sched.C):
        pid = int(sched.pattern_ids[c])
        tail = [int(offsets[pid]), len(programs[pid].ops), int(programs[pid].has_r)]
        if c == sched.C - 1:
            rows.append([0, 0, sched.t, 0, 0] + tail)
            continue
        k, inv = decode_selector(int(sched.desc_k[c]), sched.t)
        rows.append([k, int(inv), int(sched.asc_j[c]), _bitmask(sched.comp_a[c]),
                     _bitmask(sched.comp_b[c])] + tail)
    return prog, np.asarray(rows, np.int32)


class SCLMegaPlan:
    """One code's tables for ``scl_decode_mega`` (device copies cached per
    device) and the launch plan: the chunk step's context in shared memory
    (``smem_per_frame(..., depth0=False)``); the step table in the launch's
    parameters up to ``MEGA_PARAM_ROWS`` chunks (``table_in_params``), else
    in device memory.  Every chunk runs at full width, as JAX's whole-decode
    kernel does."""

    def __init__(self, sched: SCLSchedule, node_mode: str = "exact"):
        if node_mode != "exact":
            raise ValueError("the one-launch list decode (scl_decode_mega) has no fast nodes: "
                             f"node_mode={node_mode!r} runs on the per-chunk kernels")
        if not 1 <= sched.L <= NARROW_LIST_MAX:
            raise ValueError(
                f"the one-launch list decode (scl_decode_mega) takes list sizes "
                f"1..{NARROW_LIST_MAX}, got {sched.L}: a wider list runs on the per-chunk kernels "
                f"(control_impl='unroll-kernel'; the wide one-launch decode is ROADMAP.md queue "
                f"B item B6)")
        self.sched = sched
        self.smem_per_frame = smem_per_frame(sched.L, sched.S, depth0=False)
        if self.smem_per_frame > SMEM_LIMIT_BYTES:
            raise ValueError(
                f"the one-launch list decode of N={sched.N}, chunk S={sched.S}, list "
                f"L={sched.L} needs {self.smem_per_frame} bytes of shared memory per frame; one "
                f"thread block has {SMEM_LIMIT_BYTES}")
        self.warps = _warps_per_block(self.smem_per_frame, "the one-launch list decode")
        self.table_in_params = sched.C <= MEGA_PARAM_ROWS
        self.prog, self.steps = build_mega_tables(sched)
        self._on_device: dict[torch.device, tuple] = {}

    def device_tables(self, device: torch.device):
        t = self._on_device.get(device)
        if t is None:
            t = (torch.from_numpy(self.prog).to(device).contiguous(),
                 torch.from_numpy(self.steps).to(device).contiguous())
            self._on_device[device] = t
        return t


def scl_decode_mega_cuda(llr: torch.Tensor, plan: SCLMegaPlan):
    """Launch the one-launch list decode: ``llr [B, N]`` float32 CUDA
    contiguous, natural order → ``(u [B, L, N] int8 natural order, pm [B,
    L])``.  The level stacks are scratch of this call.  Does not synchronise."""
    out = launch_mega(llr, plan, "scl_mega")
    count_launch("scl_decode_mega" if plan.table_in_params else "scl_decode_mega_long")
    return out


def launch_mega(llr: torch.Tensor, plan: SCLMegaPlan, library: str):
    """The one-launch decode through the launcher of ``library``
    (``"scl_mega"``, or its profiled variant ``"scl_mega_profile"``),
    uncounted."""
    s = plan.sched
    B = llr.shape[0] if llr.dim() == 2 else -1
    if B < 1:
        raise ValueError(f"expected llr [B>=1, {s.N}], got {tuple(llr.shape)}")
    _check_cuda_f32(llr, "llr", (B, s.N))
    lib, fn = _launcher("scl_decode_mega_launch", [_P] * 11 + [_I] * 10 + [_P], library)
    dev = llr.device
    stack = s.N - s.S
    llr_rev = torch.empty((B, s.N), dtype=torch.float32, device=dev)
    # a single-chunk code keeps no stacks; its L x N plane takes their place
    alpha = torch.empty((B, s.L * (stack if s.t else s.S)), dtype=torch.float32, device=dev)
    beta = torch.empty((B, max(stack, 1)), dtype=torch.int32, device=dev)
    pend_a = torch.empty((B, max(s.t, 1), s.L), dtype=torch.int32, device=dev)
    pend_b = torch.empty_like(pend_a)
    u = torch.empty((B, s.L, s.N), dtype=torch.int8, device=dev)
    pm = torch.empty((B, s.L), dtype=torch.float32, device=dev)
    prog, steps = plan.device_tables(dev)
    code = build.launch_on(dev.index, fn, llr.data_ptr(), llr_rev.data_ptr(), alpha.data_ptr(),
                           beta.data_ptr(), pend_a.data_ptr(), pend_b.data_ptr(), u.data_ptr(),
                           pm.data_ptr(), prog.data_ptr(), plan.steps.ctypes.data,
                           steps.data_ptr(), s.C, B, s.N, s.S, s.L, s.t, int(np.log2(s.S)),
                           int(np.log2(s.N)), int(plan.table_in_params), plan.warps)
    build.check_launch(lib, code, "scl_decode_mega")
    return u, pm


def make_scl_kernel_decoder(sched: SCLSchedule, node_mode: str = "exact", live: bool = False,
                            union: bool = False, perm_impl: str = "rank"):
    """The kernel controls of the chunked decoder: ``decode(llr_rev [B, N]) →
    (u [B, L, N] int8 natural order, metrics [B, L])`` with ``llr_rev`` in
    bit-reversed storage.  ``C − 1`` chunk-step launches (at the united
    compose masks with ``union``) and one last-chunk launch, on a rank or
    one-hot state (``perm_impl``); with ``live``, the chunk steps whose live
    path counts are below L run first, in one narrow-prefix launch, and the
    others after it.  A single-chunk code is one chunk-body launch and the
    butterfly."""
    programs = [SCLBodyProgram(f, sched.L, node_mode, perm_impl) for f in sched.unique_flags]
    L = sched.L
    if sched.C == 1:
        rev_np = np.asarray(bit_reverse_permutation(sched.N))

        def decode_single(llr_rev):
            B, dev = llr_rev.shape[0], llr_rev.device
            alpha = llr_rev[:, None, :].expand(B, L, sched.N).contiguous()
            beta, pm, _ = scl_chunk_body(
                alpha, init_metrics(B, L, L, llr_rev.dtype, dev), programs[0])
            rev = torch.as_tensor(rev_np, dtype=torch.int64, device=dev)
            return polar_transform(beta[..., rev]), pm

        return decode_single

    steps, last = make_step_specs(sched, programs, live=live, union=union)

    def decode(llr_rev):
        state = SCLState(sched, llr_rev, perm_impl)
        for spec in steps:
            if isinstance(spec, SCLPrefixSpec):
                scl_narrow_prefix(state, spec)
            else:
                scl_chunk_step(state, spec)
        return scl_last_chunk(state, last)

    return decode
