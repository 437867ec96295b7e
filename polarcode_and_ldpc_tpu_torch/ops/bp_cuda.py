"""Fused LDPC decode kernels (flooding and row-layered schedules): wrapper,
kernel tables, implementation policy.

``csrc/bp_decode.cu`` replaces the TPU kernel
``polarcode_and_ldpc_tpu/ops/bp_pallas.py::make_bp_decoder_pallas``.  Its
flooding form (``bp_decode_kernel``): sum-product or min-sum (NMS α / OMS β)
message passing, syndrome, per-frame iteration count and early exit in one
launch, one thread block per frame, every message in shared memory, the two
message layouts linked by gather index tables.  Its layered form
(``bp_layered_decode_kernel``, ``schedule="layered"``, min-sum only): the
running totals Q and the check messages R in shared memory, each layer two
passes (checks, then variables) with a block barrier between.  Bound:
operations (the iterations each frame actually runs); see the notes in the
source.

Device-memory mode (a port mode: the JAX package runs such codes through
XLA): when a frame's planes exceed one block's shared memory
(``smem_bytes``), decided on the host by size, the same kernels keep them
in a scratch buffer in device memory, ``scratch_bytes_per_frame`` per block
(``smem_bytes`` rounded up to 16), and a grid of ``_DEVMEM_BLOCKS_PER_SM``
blocks per SM walks the frames, so the scratch does not grow with the batch.
Per frame that is ``(dv·n + 2·dc_max·m + n)·4 + n`` bytes for flooding and
``(n + dc_max·m + 2·dc_max·layer)·4 + n`` for the layered schedule: 761,856
and 507,904 bytes for the default MacKay (8192, 4096) code (``dc_max`` 19,
4 layers), at most 0.8 GB of scratch on a 132-SM card.  Arithmetic and order
are those of the shared-memory mode.

The plain PyTorch versions of the same functions are
``models.ldpc.bp.make_bp_decoder`` / ``models.ldpc.minsum.make_ms_decoder`` /
``models.ldpc.layered.make_layered_ms_decoder``.  ``bp_decode`` uses them only
for a tensor that lies on the CPU; on a CUDA tensor it launches the kernel or
raises.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import numpy as np
import torch

from ..models.ldpc.bp import make_bp_decoder
from ..models.ldpc.graph import TannerGraph
from ..models.ldpc.layered import layer_bounds, make_layered_ms_decoder
from ..models.ldpc.minsum import make_ms_decoder
from . import build, count_launch

#: shared memory one thread block may use on Hopper (bytes)
SMEM_LIMIT_BYTES = 232448
_RULES = {"bp": 0, "ms": 1}
_THREADS = 256
#: blocks per SM of the device-memory mode (2048 threads / 256 per block)
_DEVMEM_BLOCKS_PER_SM = 8


def kernel_tables(graph: TannerGraph) -> dict:
    """The kernel's three slot-major int32 tables from a graph's gather
    tables: ``cv_idx [dc*m]`` (slot ``s`` of check ``c`` → index of its edge
    in the var-major message array ``V[sp*n + v]``), ``vc_idx [dv*n]`` (slot
    ``sp`` of variable ``v`` → index in ``C[s*m + c]``) and ``chk_var
    [dc*m]`` (the variable of the slot); −1 marks a padded slot."""
    t = graph.numpy_tables()
    n, m, dv, dc = graph.n, graph.m, graph.dv_max, graph.dc_max
    cv = t["cv_gather"].astype(np.int64)          # [m, dc] flat v*dv + sp
    cv_idx = (cv % dv) * n + cv // dv
    cv_idx = np.where(t["check_mask"], cv_idx, -1).T  # [dc, m]
    vc = t["vc_gather"].astype(np.int64)          # [n, dv] flat c*dc + s
    vc_idx = (vc % dc) * m + vc // dc
    vc_idx = np.where(t["var_mask"], vc_idx, -1).T    # [dv, n]
    chk_var = np.where(t["check_mask"], t["check_vars"], -1).T
    return {k: np.ascontiguousarray(a, np.int32).reshape(-1)
            for k, a in (("cv_idx", cv_idx), ("vc_idx", vc_idx), ("chk_var", chk_var))}


def smem_bytes(graph: TannerGraph, layer_checks: int = 0) -> int:
    """Shared memory the kernel needs for one frame of this graph: the
    flooding kernel by default, the layered kernel when ``layer_checks`` (the
    size of the widest layer) is given."""
    n, m, dv, dc = graph.n, graph.m, graph.dv_max, graph.dc_max
    if layer_checks:
        return (n + dc * m + 2 * dc * layer_checks) * 4 + n
    return (dv * n + 2 * dc * m + n) * 4 + n


class BPKernelPlan:
    """One decoder configuration for the kernel: tables on the graph's device
    plus the plain decoder of the same configuration.  ``device_memory`` says
    whether a frame's planes live in shared memory (False) or in a scratch
    buffer in device memory, ``scratch_bytes_per_frame`` per resident block."""

    def __init__(self, graph: TannerGraph, max_iter: int = 20, early_stop: bool = True,
                 check_rule: str = "bp", normalization: float = 1.0, offset: float = 0.0,
                 schedule: str = "flooding", num_layers: int = 4):
        if check_rule not in _RULES:
            raise ValueError(f"unknown check_rule {check_rule!r}")
        if schedule not in ("flooding", "layered"):
            raise ValueError(f"unknown schedule {schedule!r}")
        self.layered = schedule == "layered"
        if self.layered and check_rule != "ms":
            raise ValueError("the layered schedule is min-sum only")
        bounds = layer_bounds(graph.m, num_layers) if self.layered else []
        self.layer_checks = max((c1 - c0 for c0, c1 in bounds), default=0)
        self.smem_bytes = smem_bytes(graph, self.layer_checks)
        self.device_memory = self.smem_bytes > SMEM_LIMIT_BYTES
        self.scratch_bytes_per_frame = (self.smem_bytes + 15) // 16 * 16
        self.graph = graph
        self.max_iter = int(max_iter)
        self.early_stop = bool(early_stop)
        self.check_rule = check_rule
        self.normalization = float(normalization)
        self.offset = float(offset)
        self.tables = {k: torch.from_numpy(v).to(graph.device)
                       for k, v in kernel_tables(graph).items()}
        if self.layered:
            starts = np.asarray([c0 for c0, _ in bounds] + [graph.m], np.int32)
            self.tables["layer_starts"] = torch.from_numpy(starts).to(graph.device)
            self.plain = make_layered_ms_decoder(graph, max_iter, normalization, offset,
                                                 early_stop, torch.float32, num_layers)
        elif check_rule == "bp":
            self.plain = make_bp_decoder(graph, max_iter, early_stop, torch.float32)
        else:
            self.plain = make_ms_decoder(graph, max_iter, normalization, offset,
                                         early_stop, torch.float32)


def bp_decode_cuda(llr: torch.Tensor, plan: BPKernelPlan):
    """Launch the kernel: ``llr [B, n]`` float32 CUDA contiguous →
    ``(bits [B, n] int8, iters [B] int32)``.  Does not synchronise."""
    g = plan.graph
    if llr.device.type != "cuda":
        raise ValueError(f"bp_decode_cuda needs a CUDA tensor, got {llr.device}")
    if llr.device != g.device:
        raise ValueError(f"llr is on {llr.device}, the graph on {g.device}")
    if llr.dtype != torch.float32:
        raise TypeError(
            f"the LDPC kernel is float32 only, got {llr.dtype}; ask for the "
            "plain implementation (impl='torch') for other dtypes")
    if llr.dim() != 2 or llr.shape[1] != g.n or llr.shape[0] < 1:
        raise ValueError(f"expected llr [B>=1, {g.n}], got {tuple(llr.shape)}")
    if not llr.is_contiguous():
        raise ValueError("bp_decode_cuda needs a contiguous tensor")
    lib = build.load("bp_decode")
    B = llr.shape[0]
    bits = torch.empty((B, g.n), dtype=torch.int8, device=llr.device)
    iters = torch.empty((B,), dtype=torch.int32, device=llr.device)
    t = plan.tables
    scratch, grid = None, 0
    if plan.device_memory:
        sms = torch.cuda.get_device_properties(llr.device).multi_processor_count
        grid = min(B, sms * _DEVMEM_BLOCKS_PER_SM)
        scratch = torch.empty((grid * plan.scratch_bytes_per_frame,), dtype=torch.uint8,
                              device=llr.device)
    tail = [ctypes.c_float, ctypes.c_float, ctypes.c_int, ctypes.c_void_p, ctypes.c_longlong,
            ctypes.c_int, ctypes.c_void_p]
    scratch_args = (scratch.data_ptr() if scratch is not None else None,
                    plan.scratch_bytes_per_frame, grid)
    with torch.cuda.device(llr.device):
        stream = torch.cuda.current_stream().cuda_stream
        if plan.layered:
            fn = lib.bp_layered_decode_launch
            fn.restype = ctypes.c_int
            fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 9 + tail
            code = fn(llr.data_ptr(), bits.data_ptr(), iters.data_ptr(),
                      t["vc_idx"].data_ptr(), t["chk_var"].data_ptr(),
                      t["layer_starts"].data_ptr(), B, g.n, g.m, g.dv_max, g.dc_max,
                      t["layer_starts"].numel() - 1, plan.layer_checks, plan.max_iter,
                      int(plan.early_stop), plan.normalization, plan.offset, _THREADS,
                      *scratch_args, stream)
        else:
            fn = lib.bp_decode_launch
            fn.restype = ctypes.c_int
            fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 8 + tail
            code = fn(llr.data_ptr(), bits.data_ptr(), iters.data_ptr(),
                      t["cv_idx"].data_ptr(), t["vc_idx"].data_ptr(),
                      t["chk_var"].data_ptr(), B, g.n, g.m, g.dv_max, g.dc_max,
                      plan.max_iter, int(plan.early_stop), _RULES[plan.check_rule],
                      plan.normalization, plan.offset, _THREADS, *scratch_args, stream)
    name = "bp_decode_layered" if plan.layered else f"bp_decode_{plan.check_rule}"
    name += "_devmem" if plan.device_memory else ""
    build.check_launch(lib, code, name)
    count_launch(name)
    return bits, iters


def bp_decode(llr: torch.Tensor, plan: BPKernelPlan):
    """``llr [B, n]`` → ``(bits, iters)``: the plain version for a CPU
    tensor, the kernel for a CUDA tensor."""
    if llr.device.type == "cpu":
        return plan.plain(llr)
    return bp_decode_cuda(llr, plan)


def resolve_bp_impl(graph: TannerGraph, plain_decode, max_iter: int,
                    early_stop: bool, dtype, impl: Optional[str] = None,
                    check_rule: str = "bp", normalization: float = 1.0,
                    offset: float = 0.0, schedule: str = "flooding",
                    num_layers: int = 4):
    """The one place that picks the LDPC decoder implementation (used by
    ``BPDecoder`` and ``sim.pipelines.make_ldpc_pipeline``).

    ``impl``: ``"cuda"`` (the fused kernel; float32 only; the default when
    the graph is on a CUDA device) or ``"torch"`` (the given plain decoder;
    the default on the CPU).  Returns ``(decode_fn, impl)`` with
    ``decode_fn(llr [B, n]) -> (bits, iters)``.  ``schedule="layered"``
    (min-sum only, ``num_layers`` contiguous check groups) picks the layered
    kernel; ``plain_decode`` must then be the layered plain decoder.  Nothing
    falls back: a float64 decoder on a CUDA device must ask for
    ``impl="torch"``.
    """
    if schedule not in ("flooding", "layered"):
        raise ValueError(f"unknown schedule {schedule!r}")
    if schedule == "layered" and check_rule != "ms":
        raise ValueError("the layered schedule is min-sum only")
    if impl is None:
        impl = "cuda" if graph.device.type == "cuda" else "torch"
    if impl == "torch":
        return plain_decode, "torch"
    if impl != "cuda":
        raise ValueError(f"unknown impl {impl!r} (expected 'cuda' or 'torch')")
    if dtype != torch.float32:
        raise TypeError(
            f"the LDPC kernel is float32 only, got {dtype}; ask for the "
            "plain implementation (impl='torch') for other dtypes")
    plan = BPKernelPlan(graph, max_iter, early_stop, check_rule, normalization, offset,
                        schedule, num_layers)

    def decode(llr):
        llr = torch.as_tensor(llr, device=graph.device)
        return bp_decode(llr.contiguous(), plan)

    decode.plan = plan
    return decode, "cuda"
