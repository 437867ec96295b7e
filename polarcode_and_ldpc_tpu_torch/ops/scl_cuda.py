"""SCL list-decoder kernels: wrappers, host-side node program, device state.

``csrc/scl_decode.cu`` (device functions in ``csrc/scl_device.cuh``) holds
four kernels, each one warp per frame with the chunk's working set in shared
memory:

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
  step and the last chunk, walked from a step table; the level stacks in a
  scratch buffer that never leaves the launch); plain version: the
  ``"unroll-fused"`` chunk program of ``models.polar.scanscl``.

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
through the same three per-chunk kernels: its ``OP_RATE1_FAST`` /
``OP_REP_FAST`` ops are the fast modes of the TPU kernels K3 / K4 / K5, and
their launches are counted apart (``scl_chunk_step_fast`` …).  The one-launch
decode refuses a fast program, as the JAX package's mega control does.

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
                                    init_metrics)
from . import build, count_launch

OP_F, OP_G, OP_COMBINE, OP_RATE0, OP_LEAF, OP_REP, OP_RATE1_FAST, OP_REP_FAST = range(8)
FLAG_RL, FLAG_RR = 1 << 8, 2 << 8

#: widest repetition subtree the REP op decodes (the plain version's rule)
REP_MAX = _LEVELPAR_MAX
#: widest list the packed path bits hold
MAX_LIST = 32
#: shared memory one thread block may use on Hopper (bytes)
SMEM_LIMIT_BYTES = 232448
_SMEM_TARGET_BYTES = 48 * 1024
_MAX_WARPS = 8


def build_scl_body_program(flags: np.ndarray, node_mode: str = "exact",
                           list_size: Optional[int] = None) -> tuple[np.ndarray, bool]:
    """The static node program of one chunk pattern (``flags [S]`` bool in
    storage order, True = frozen): ``int32 [n_ops, 4]`` rows ``(op | flags,
    depth, size or half, beta_offset)``, walked exactly as the plain chunk
    body walks the pattern, and whether the chunk prunes at all (has a rank
    vector other than the identity).  ``node_mode="fast"`` emits the fast
    rate-1 and repetition ops; it needs ``list_size`` (a rate-1 node prunes
    only when ``L > 1``)."""
    flags = np.asarray(flags, bool)
    S = len(flags)
    assert S >= 1 and S & (S - 1) == 0
    fast = node_mode == "fast"
    if fast and list_size is None:
        raise ValueError("a fast node program needs list_size")
    ops: list[tuple[int, int, int, int]] = []

    def node(depth: int, off: int, size: int) -> bool:
        sub = flags[off:off + size]
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
        rl = node(depth + 1, off, half)
        ops.append((OP_G | (FLAG_RL if rl else 0), depth, half, off))
        rr = node(depth + 1, off + half, half)
        ops.append((OP_COMBINE | (FLAG_RL if rl else 0) | (FLAG_RR if rr else 0),
                    depth, half, off))
        return rl or rr

    has_r = node(0, 0, S)
    return np.asarray(ops, np.int32).reshape(-1, 4), has_r


class SCLBodyProgram:
    """A chunk pattern's node program plus its plain body; device copies of
    the program are cached per device."""

    def __init__(self, flags: np.ndarray, list_size: int, node_mode: str = "exact"):
        if not 1 <= list_size <= MAX_LIST:
            raise ValueError(f"the SCL kernels take list sizes 1..{MAX_LIST}, got {list_size}")
        if node_mode not in ("exact", "fast"):
            raise ValueError(f"unknown node_mode {node_mode!r}")
        self.flags = np.asarray(flags, bool)
        self.S = len(self.flags)
        self.lgS = int(np.log2(self.S))
        self.L = list_size
        self.fast = node_mode == "fast"
        self.ops, self.has_r = build_scl_body_program(self.flags, node_mode, list_size)
        self.plain = _make_chunk_body(self.flags, list_size, node_mode)
        self._on_device: dict[torch.device, torch.Tensor] = {}

    def device_ops(self, device: torch.device) -> torch.Tensor:
        t = self._on_device.get(device)
        if t is None:
            t = torch.from_numpy(self.ops).to(device).contiguous()
            self._on_device[device] = t
        return t


def smem_per_frame(L: int, S: int, root_words: int = 0) -> int:
    """Bytes of shared memory one frame needs (mirrors ``scl::ctx_words``)."""
    lgS = int(np.log2(S))
    return 4 * (2 * S * L + S + L * (6 + lgS + 1) + root_words)


def _warps_per_block(per_frame: int, what: str) -> int:
    if per_frame > SMEM_LIMIT_BYTES:
        raise ValueError(
            f"{what} needs {per_frame} bytes of shared memory per frame; "
            f"one thread block has {SMEM_LIMIT_BYTES}")
    return max(1, min(_MAX_WARPS, _SMEM_TARGET_BYTES // per_frame))


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


def _launcher(name: str, argtypes: list):
    lib = build.load("scl_decode")
    fn = getattr(lib, name)
    fn.restype = ctypes.c_int
    fn.argtypes = argtypes
    return lib, fn


# ---------------------------------------------------------------------------
# K5: the chunk body
# ---------------------------------------------------------------------------

def scl_chunk_body_cuda(alpha: torch.Tensor, pm: torch.Tensor, program: SCLBodyProgram):
    """Launch the chunk-body kernel: ``alpha [B, L, S]`` float32, ``pm [B,
    L]`` → ``(beta [B, L, S] int8, pm' [B, L], R [B, L] int64)``.  Does not
    synchronise."""
    B = alpha.shape[0] if alpha.dim() == 3 else -1
    L, S = program.L, program.S
    if B < 1:
        raise ValueError(f"expected alpha [B>=1, {L}, {S}], got {tuple(alpha.shape)}")
    _check_cuda_f32(alpha, "alpha", (B, L, S))
    _check_cuda_f32(pm, "pm", (B, L))
    warps = _warps_per_block(smem_per_frame(L, S), f"a chunk of S={S} at L={L}")
    lib, fn = _launcher("scl_chunk_body_launch",
                        [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P])
    dev = alpha.device
    beta = torch.empty((B, L, S), dtype=torch.int8, device=dev)
    pm_out = torch.empty((B, L), dtype=torch.float32, device=dev)
    r_out = torch.empty((B, L), dtype=torch.int64, device=dev)
    ops = program.device_ops(dev)
    with torch.cuda.device(dev):
        code = fn(alpha.data_ptr(), pm.data_ptr(), beta.data_ptr(), pm_out.data_ptr(),
                  r_out.data_ptr(), ops.data_ptr(), ops.shape[0], int(program.has_r),
                  B, S, L, program.lgS, warps, torch.cuda.current_stream().cuda_stream)
    build.check_launch(lib, code, "scl_chunk_body")
    count_launch("scl_chunk_body_fast" if program.fast else "scl_chunk_body")
    return beta, pm_out, r_out


def scl_chunk_body(alpha: torch.Tensor, pm: torch.Tensor, program: SCLBodyProgram):
    """One chunk's list decode: the plain version for CPU tensors, the kernel
    for CUDA tensors."""
    if alpha.device.type == "cpu":
        return program.plain(alpha, pm)
    return scl_chunk_body_cuda(alpha.contiguous(), pm.contiguous(), program)


def make_chunk_body_cuda(flags: np.ndarray, list_size: int, node_mode: str = "exact"):
    """``body(alpha, pm) → (beta, pm', R)`` through ``scl_chunk_body``, for
    use inside the plain chunk program (``body_impl="cuda"``)."""
    program = SCLBodyProgram(flags, list_size, node_mode)

    def body(alpha, pm):
        return scl_chunk_body(alpha, pm, program)

    return body


# ---------------------------------------------------------------------------
# the decode state between launches
# ---------------------------------------------------------------------------

def pack_paths(bits: torch.Tensor) -> torch.Tensor:
    """``[B, L, M]`` 0/1 int8 → ``[B, M]`` int32 words, bit l = path l."""
    L = bits.shape[1]
    sh = torch.arange(L, device=bits.device, dtype=torch.int64)[None, :, None]
    return (bits.to(torch.int64) << sh).sum(dim=1).to(torch.int32)


def unpack_paths(words: torch.Tensor, L: int) -> torch.Tensor:
    """``[B, M]`` int32 words → ``[B, L, M]`` int8 bit planes."""
    sh = torch.arange(L, device=words.device, dtype=torch.int32)[None, :, None]
    return ((words[:, None, :] >> sh) & 1).to(torch.int8)


class SCLState:
    """The level stacks of a batch of frames between chunk launches, in the
    layout the kernels read (see ``csrc/scl_decode.cu``): ``llr [B, N]``
    (bit-reversed storage), ``alpha [B, L·(N−S)]``, ``beta [B, N−S]`` int32
    packed words, ``pend_a`` / ``pend_b [B, t, L]`` int32, ``pm [B, L]``."""

    def __init__(self, sched: SCLSchedule, llr_rev: torch.Tensor):
        assert sched.C > 1, "a single-chunk code keeps no level stacks"
        self.sched = sched
        N, S, L, t = sched.N, sched.S, sched.L, sched.t
        B, dev = llr_rev.shape[0], llr_rev.device
        self.llr = llr_rev
        self.alpha = torch.zeros((B, L * (N - S)), dtype=llr_rev.dtype, device=dev)
        self.beta = torch.zeros((B, N - S), dtype=torch.int32, device=dev)
        eye = torch.arange(L, dtype=torch.int32, device=dev).expand(B, t, L)
        self.pend_a = eye.contiguous()
        self.pend_b = eye.contiguous()
        self.pm = init_metrics(B, L, L, llr_rev.dtype, dev)

    def clone(self) -> "SCLState":
        other = object.__new__(SCLState)
        other.sched, other.llr = self.sched, self.llr
        for name in ("alpha", "beta", "pend_a", "pend_b", "pm"):
            setattr(other, name, getattr(self, name).clone())
        return other

    def _alpha_off(self, l: int) -> int:
        return self.sched.L * (self.sched.N - (self.sched.N >> (l - 1)))

    def _beta_off(self, l: int) -> int:
        return self.sched.N - (self.sched.N >> (l - 1))

    def to_plain(self):
        """``(alpha, pend_a, beta, pend_b, pm)`` as the plain chunk step
        takes them (full list width)."""
        s, L = self.sched, self.sched.L
        B = self.pm.shape[0]
        alpha, beta = [], []
        for l in range(1, s.t + 1):
            M = s.sizes[l]
            a0, b0 = self._alpha_off(l), self._beta_off(l)
            alpha.append(self.alpha[:, a0:a0 + L * M].reshape(B, L, M))
            beta.append(unpack_paths(self.beta[:, b0:b0 + M], L))
        pend_a = tuple(self.pend_a[:, i].to(torch.int64) for i in range(s.t))
        pend_b = tuple(self.pend_b[:, i].to(torch.int64) for i in range(s.t))
        return tuple(alpha), pend_a, tuple(beta), pend_b, self.pm

    def load_plain(self, alpha, pend_a, beta, pend_b, pm) -> None:
        """Overwrite the state with the plain chunk step's (full-width)
        operands."""
        s, L = self.sched, self.sched.L
        B = pm.shape[0]
        for l in range(1, s.t + 1):
            M = s.sizes[l]
            a0, b0 = self._alpha_off(l), self._beta_off(l)
            self.alpha[:, a0:a0 + L * M] = alpha[l - 1].expand(B, L, M).reshape(B, L * M)
            self.beta[:, b0:b0 + M] = pack_paths(beta[l - 1])
            self.pend_a[:, l - 1] = pend_a[l - 1].to(torch.int32)
            self.pend_b[:, l - 1] = pend_b[l - 1].to(torch.int32)
        self.pm = pm.contiguous()


@dataclass
class SCLStepSpec:
    """The arguments of one ``scl_chunk_step`` launch: descend ``(k, inv)``,
    ascend count ``j``, the compose masks as bit masks over level indices,
    the chunk's node program, and the plain version of the same step."""
    k: int
    inv: bool
    j: int
    mask_a: int
    mask_b: int
    program: SCLBodyProgram
    plain: object


def _bitmask(levels) -> int:
    return sum(1 << int(i) for i in levels)


def make_step_specs(sched: SCLSchedule, programs: Optional[list] = None,
                    node_mode: str = "exact"):
    """``(step specs of chunks 0..C−2, last-chunk spec)`` of a schedule."""
    if programs is None:
        programs = [SCLBodyProgram(f, sched.L, node_mode) for f in sched.unique_flags]
    t, sizes, L = sched.t, sched.sizes, sched.L
    steps = []
    for c in range(sched.C - 1):
        sel, j = int(sched.desc_k[c]), int(sched.asc_j[c])
        k, inv = decode_selector(sel, t)
        prog = programs[sched.pattern_ids[c]]
        steps.append(SCLStepSpec(
            k=k, inv=inv, j=j, mask_a=_bitmask(sched.comp_a[c]),
            mask_b=_bitmask(sched.comp_b[c]), program=prog,
            plain=_make_super_fn(sel, j, t, sizes, L, prog.plain,
                                 compose_a=sched.comp_a[c], compose_b=sched.comp_b[c])))
    prog = programs[sched.pattern_ids[sched.C - 1]]
    last = SCLStepSpec(k=0, inv=False, j=t, mask_a=0, mask_b=0, program=prog,
                       plain=_make_last_fn(t, sizes, L, prog.plain, transform=True))
    return steps, last


def _check_state(state: SCLState) -> None:
    s = state.sched
    B = state.pm.shape[0]
    _check_cuda_f32(state.llr, "llr", (B, s.N))
    _check_cuda_f32(state.alpha, "alpha", (B, s.L * (s.N - s.S)))
    _check_cuda_f32(state.pm, "pm", (B, s.L))
    for name, shape in (("beta", (B, s.N - s.S)), ("pend_a", (B, s.t, s.L)),
                        ("pend_b", (B, s.t, s.L))):
        x = getattr(state, name)
        if x.dtype != torch.int32 or tuple(x.shape) != shape or not x.is_contiguous() \
                or x.device != state.llr.device:
            raise ValueError(f"state.{name} must be contiguous int32 {shape} on {state.llr.device}")


# ---------------------------------------------------------------------------
# K3: one chunk step;  K4: the last chunk
# ---------------------------------------------------------------------------

def scl_chunk_step_cuda(state: SCLState, spec: SCLStepSpec) -> None:
    """Launch the chunk-step kernel on the state, IN PLACE.  Does not
    synchronise."""
    _check_state(state)
    s = state.sched
    B = state.pm.shape[0]
    warps = _warps_per_block(smem_per_frame(s.L, s.S), f"a chunk of S={s.S} at L={s.L}")
    lib, fn = _launcher("scl_chunk_step_launch", [_P] * 7 + [_I] * 14 + [_P])
    dev = state.llr.device
    ops = spec.program.device_ops(dev)
    with torch.cuda.device(dev):
        code = fn(state.llr.data_ptr(), state.alpha.data_ptr(), state.beta.data_ptr(),
                  state.pend_a.data_ptr(), state.pend_b.data_ptr(), state.pm.data_ptr(),
                  ops.data_ptr(), ops.shape[0], int(spec.program.has_r), B, s.N, s.S, s.L,
                  s.t, spec.program.lgS, spec.k, int(spec.inv), spec.j, spec.mask_a,
                  spec.mask_b, warps, torch.cuda.current_stream().cuda_stream)
    build.check_launch(lib, code, "scl_chunk_step")
    count_launch("scl_chunk_step_fast" if spec.program.fast else "scl_chunk_step")


def scl_chunk_step(state: SCLState, spec: SCLStepSpec) -> None:
    """One chunk step on the state, in place: the plain version for a state
    on the CPU, the kernel for a state on a CUDA device."""
    if state.llr.device.type == "cpu":
        state.load_plain(*spec.plain(state.llr, *state.to_plain()))
        return
    scl_chunk_step_cuda(state, spec)


def scl_last_chunk_cuda(state: SCLState, spec: SCLStepSpec):
    """Launch the last-chunk kernel: ``(u [B, L, N] int8 natural order, pm
    [B, L])``.  The state is read only.  Does not synchronise."""
    _check_state(state)
    s = state.sched
    B = state.pm.shape[0]
    warps = _warps_per_block(smem_per_frame(s.L, s.S, root_words=s.N),
                             f"the last chunk of N={s.N}, S={s.S} at L={s.L}")
    lib, fn = _launcher("scl_last_chunk_launch", [_P] * 9 + [_I] * 10 + [_P])
    dev = state.llr.device
    u = torch.empty((B, s.L, s.N), dtype=torch.int8, device=dev)
    pm_out = torch.empty((B, s.L), dtype=torch.float32, device=dev)
    ops = spec.program.device_ops(dev)
    with torch.cuda.device(dev):
        code = fn(state.llr.data_ptr(), state.alpha.data_ptr(), state.beta.data_ptr(),
                  state.pend_a.data_ptr(), state.pend_b.data_ptr(), state.pm.data_ptr(),
                  u.data_ptr(), pm_out.data_ptr(), ops.data_ptr(), ops.shape[0],
                  int(spec.program.has_r), B, s.N, s.S, s.L, s.t, spec.program.lgS,
                  int(np.log2(s.N)), warps, torch.cuda.current_stream().cuda_stream)
    build.check_launch(lib, code, "scl_last_chunk")
    count_launch("scl_last_chunk_fast" if spec.program.fast else "scl_last_chunk")
    return u, pm_out


def scl_last_chunk(state: SCLState, spec: SCLStepSpec):
    """The last chunk, the ascend to the root and the butterfly: ``(u [B, L,
    N] int8 natural order, pm [B, L])``."""
    if state.llr.device.type == "cpu":
        u_rev, pm = spec.plain(state.llr, *state.to_plain())
        rev = torch.as_tensor(np.asarray(bit_reverse_permutation(state.sched.N)),
                              dtype=torch.int64)
        return u_rev[..., rev], pm
    return scl_last_chunk_cuda(state, spec)


# ---------------------------------------------------------------------------
# K6: the whole decode in one launch
# ---------------------------------------------------------------------------

#: columns of one row of the step table of ``scl_decode_mega``
STEP_TABLE_COLUMNS = ("k", "inv", "j", "mask_a", "mask_b", "prog_off", "n_ops", "has_R")


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
    device) and the shared-memory plan of the launch."""

    def __init__(self, sched: SCLSchedule, node_mode: str = "exact"):
        if node_mode != "exact":
            raise ValueError("the one-launch list decode (scl_decode_mega) has no fast nodes: "
                             f"node_mode={node_mode!r} runs on the per-chunk kernels")
        if not 1 <= sched.L <= MAX_LIST:
            raise ValueError(f"the SCL kernels take list sizes 1..{MAX_LIST}, got {sched.L}")
        self.sched = sched
        per_frame = smem_per_frame(sched.L, sched.S, root_words=sched.N)
        if per_frame > SMEM_LIMIT_BYTES:
            raise ValueError(
                f"the one-launch list decode of N={sched.N}, chunk S={sched.S}, list "
                f"L={sched.L} needs {per_frame} bytes of shared memory per frame; one "
                f"thread block has {SMEM_LIMIT_BYTES}")
        self.warps = _warps_per_block(per_frame, "the one-launch list decode")
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
    s = plan.sched
    B = llr.shape[0] if llr.dim() == 2 else -1
    if B < 1:
        raise ValueError(f"expected llr [B>=1, {s.N}], got {tuple(llr.shape)}")
    _check_cuda_f32(llr, "llr", (B, s.N))
    lib, fn = _launcher("scl_decode_mega_launch", [_P] * 10 + [_I] * 9 + [_P])
    dev = llr.device
    stack = max(s.N - s.S, 1)
    llr_rev = torch.empty((B, s.N), dtype=torch.float32, device=dev)
    alpha = torch.empty((B, s.L * stack), dtype=torch.float32, device=dev)
    beta = torch.empty((B, stack), dtype=torch.int32, device=dev)
    pend_a = torch.empty((B, max(s.t, 1), s.L), dtype=torch.int32, device=dev)
    pend_b = torch.empty_like(pend_a)
    u = torch.empty((B, s.L, s.N), dtype=torch.int8, device=dev)
    pm = torch.empty((B, s.L), dtype=torch.float32, device=dev)
    prog, steps = plan.device_tables(dev)
    with torch.cuda.device(dev):
        code = fn(llr.data_ptr(), llr_rev.data_ptr(), alpha.data_ptr(), beta.data_ptr(),
                  pend_a.data_ptr(), pend_b.data_ptr(), u.data_ptr(), pm.data_ptr(),
                  prog.data_ptr(), steps.data_ptr(), s.C, B, s.N, s.S, s.L, s.t,
                  int(np.log2(s.S)), int(np.log2(s.N)), plan.warps,
                  torch.cuda.current_stream().cuda_stream)
    build.check_launch(lib, code, "scl_decode_mega")
    count_launch("scl_decode_mega")
    return u, pm


def make_scl_kernel_decoder(sched: SCLSchedule, node_mode: str = "exact"):
    """The kernel control of the chunked decoder: ``decode(llr_rev [B, N]) →
    (u [B, L, N] int8 natural order, metrics [B, L])`` with ``llr_rev`` in
    bit-reversed storage.  ``C − 1`` chunk-step launches and one last-chunk
    launch; a single-chunk code is one chunk-body launch and the butterfly."""
    programs = [SCLBodyProgram(f, sched.L, node_mode) for f in sched.unique_flags]
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

    steps, last = make_step_specs(sched, programs)

    def decode(llr_rev):
        state = SCLState(sched, llr_rev)
        for spec in steps:
            scl_chunk_step(state, spec)
        return scl_last_chunk(state, last)

    return decode
