"""Fused LDPC decode kernels (flooding and row-layered schedules): wrapper,
kernel tables, implementation policy.

``csrc/bp_decode.cu`` replaces the TPU kernel
``polarcode_and_ldpc_tpu/ops/bp_pallas.py::make_bp_decoder_pallas``.  Its
flooding form (``bp_decode_kernel``): sum-product or min-sum (NMS α / OMS β)
message passing, syndrome, per-frame iteration count and early exit in one
launch, one thread block per frame.  Its layered form
(``bp_layered_decode_kernel``, ``schedule="layered"``, min-sum only): each
layer two passes (checks, then variables) with a block barrier between.
Bound: operations (the iterations each frame actually runs); see the notes
in the source.

The messages are addressed by edge, with no padded slot (``kernel_tables``):
the checks ordered by degree, each row's edges consecutive (CSR rows), and
the variables' slots as edge indices (``vc_edge``).  A frame keeps
(``smem_bytes``, float32 words): sum-product ``total [n]``, ``C [E]``,
``T [E]``; min-sum ``total [n]``, ``C [E]``; layered ``Q [n]``, ``R [E]``
and ``D`` over the widest layer's edges.  The default MacKay (8192, 4096)
code (E = 24,576, ``dc_max`` 19, 4 layers of at most 6,249 edges) takes
229,376, 131,072 and 156,068 bytes: one frame per block, in shared memory.
Blocks have up to 1,024 threads (about four checks a thread);
``blocks_per_sm`` is what shared memory and threads allow on one SM.

Device-memory mode (a port mode: the JAX package runs such codes through
XLA): when a frame's planes exceed one block's shared memory, decided on the
host by size, the same kernels keep them in a scratch buffer in device
memory, ``scratch_bytes_per_frame`` per block (``smem_bytes`` rounded up to
16), and a grid of as many blocks as the CUDA occupancy calculator fits on
each SM (``resident_blocks_per_sm``) walks the frames, so the scratch does
not grow with the batch.  A MacKay (4096, 2048) code with column weight 16
(E = 65,536) needs it: 540,672 bytes a frame for sum-product.  Tables,
arithmetic and order are those of the shared-memory mode.

The plain PyTorch versions of the same functions are
``models.ldpc.bp.make_bp_decoder`` / ``models.ldpc.minsum.make_ms_decoder`` /
``models.ldpc.layered.make_layered_ms_decoder``.  ``bp_decode`` uses them only
for a tensor that lies on the CPU; on a CUDA tensor it launches the kernel or
raises.
"""

from __future__ import annotations

import ctypes
import functools
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
#: shared memory of one SM, and what each resident block reserves besides its own
SMEM_PER_SM_BYTES = 233472
_SMEM_RESERVED_PER_BLOCK = 1024
_THREADS_PER_SM = 2048
_RULES = {"bp": 0, "ms": 1}
_MIN_THREADS, _MAX_THREADS = 256, 1024
#: threads per block of the device-memory mode
_DEVMEM_THREADS = 256


def kernel_tables(graph: TannerGraph, bounds=None) -> dict:
    """The kernel's int32 tables, every edge once (no padded slot).

    The checks are taken in ``check_order``: within each ``(c0, c1)`` of
    ``bounds`` (default: all checks, one group) by falling degree, ties in
    index order, so that the checks of one warp have equal or near degree.
    Check position ``p`` has ``row_degree[p]`` edges, consecutive from edge
    ``row_first[p]`` on in the check's slot order (CSR rows; ``row_first[m]``
    is E).  ``edge_var [E]`` is each edge's variable, ``edge_slot [E]`` its
    slot in that variable, and ``vc_edge [dv*n]`` gives slot ``sp`` of
    variable ``v`` at ``sp*n + v``: the edge, −1 for a padded slot of an
    irregular column.  Messages are addressed by edge, so the order of every
    per-check and per-variable sum is the plain version's.
    """
    t = graph.numpy_tables()
    m, dv, dc = graph.m, graph.dv_max, graph.dc_max
    mask = t["check_mask"]
    deg = mask.sum(axis=1)
    bounds = bounds or [(0, m)]
    order = np.concatenate([c0 + np.argsort(-deg[c0:c1], kind="stable")
                            for c0, c1 in bounds]).astype(np.int64)
    rows = mask[order]                       # [m, dc]: slot j of position p exists
    numbered = np.full(mask.shape, -1, np.int64)
    numbered[rows] = np.arange(graph.num_edges)  # position-major, slots in order
    edge_of = np.empty_like(numbered)        # (check, check slot) -> edge
    edge_of[order] = numbered
    first = np.concatenate([[0], np.cumsum(deg[order])])
    edge_var = t["check_vars"][order][rows]
    edge_slot = t["cv_gather"][order][rows] % dv
    vc = t["vc_gather"].astype(np.int64)
    vc_edge = np.where(t["var_mask"], edge_of[vc // dc, vc % dc], -1).T
    return {k: np.ascontiguousarray(a, np.int32).reshape(-1) for k, a in (
        ("check_order", order), ("row_first", first), ("row_degree", deg[order]),
        ("edge_var", edge_var), ("edge_slot", edge_slot), ("vc_edge", vc_edge))}


def smem_bytes(graph: TannerGraph, check_rule: str = "bp", layer_edges: int = 0) -> int:
    """Bytes one frame's planes take: the flooding kernel's for ``check_rule``,
    or the layered kernel's when ``layer_edges`` (the widest layer's edge
    count) is given."""
    n, E = graph.n, graph.num_edges
    if layer_edges:
        return (n + E + layer_edges) * 4
    return (n + (2 if check_rule == "bp" else 1) * E) * 4


class BPKernelPlan:
    """One decoder configuration for the kernel: tables on the graph's device
    plus the plain decoder of the same configuration.  ``device_memory`` says
    whether a frame's planes live in shared memory (False; one block per
    frame, ``threads`` per block, ``blocks_per_sm`` on one SM as shared
    memory and threads allow) or in a scratch buffer in device memory,
    ``scratch_bytes_per_frame`` per resident block (``blocks_per_sm`` None:
    the launch asks the occupancy calculator)."""

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
        bounds = layer_bounds(graph.m, num_layers) if self.layered else None
        deg = graph.check_mask.sum(dim=1).cpu().numpy()
        self.layer_edges = max((int(deg[c0:c1].sum()) for c0, c1 in bounds or ()), default=0)
        self.smem_bytes = smem_bytes(graph, check_rule, self.layer_edges)
        self.device_memory = self.smem_bytes > SMEM_LIMIT_BYTES
        self.scratch_bytes_per_frame = (self.smem_bytes + 15) // 16 * 16
        if self.device_memory:
            self.threads, self.blocks_per_sm = _DEVMEM_THREADS, None
        else:
            self.threads = min(_MAX_THREADS, max(_MIN_THREADS, -(-graph.m // 128) * 32))
            self.blocks_per_sm = min(
                SMEM_PER_SM_BYTES // (self.smem_bytes + _SMEM_RESERVED_PER_BLOCK),
                _THREADS_PER_SM // self.threads)
        tables = kernel_tables(graph, bounds)
        if self.layered:
            tables["layer_starts"] = np.asarray([c0 for c0, _ in bounds] + [graph.m], np.int32)
        self.graph = graph
        self.max_iter = int(max_iter)
        self.early_stop = bool(early_stop)
        self.check_rule = check_rule
        self.normalization = float(normalization)
        self.offset = float(offset)
        self.tables = {k: torch.from_numpy(v).to(graph.device) for k, v in tables.items()}
        # the launcher's arguments that the plan fixes: table pointers, the
        # shape without B, the options
        t = self.tables
        self.launch_args = (
            tuple(t[k].data_ptr() for k in ("row_first", "row_degree", "edge_var", "vc_edge")
                  + (("layer_starts",) if self.layered else ())),
            (graph.n, graph.m, graph.num_edges, graph.dv_max)
            + ((len(bounds), self.layer_edges) if self.layered else (_RULES[check_rule],)),
            (self.max_iter, int(self.early_stop), self.normalization, self.offset, self.threads))
        if self.layered:
            self.plain = make_layered_ms_decoder(graph, max_iter, normalization, offset,
                                                 early_stop, torch.float32, num_layers)
        elif check_rule == "bp":
            self.plain = make_bp_decoder(graph, max_iter, early_stop, torch.float32)
        else:
            self.plain = make_ms_decoder(graph, max_iter, normalization, offset,
                                         early_stop, torch.float32)


@functools.cache
def _launcher(layered: bool):
    """The library and its C launcher (flooding or layered) with its argument
    types set (once per entry point)."""
    lib = build.load("bp_decode")
    fn = lib.bp_layered_decode_launch if layered else lib.bp_decode_launch
    fn.restype = ctypes.c_int
    # pointers; B and the shape; the options; bytes, scratch, grid and stream
    fn.argtypes = ([ctypes.c_void_p] * (8 if layered else 7)
                   + [ctypes.c_int] * (9 if layered else 8)
                   + [ctypes.c_float, ctypes.c_float, ctypes.c_int, ctypes.c_longlong,
                      ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p])
    return lib, fn


@functools.cache
def _resident_blocks(layered: bool, dev: bool, threads: int, smem: int, index: int) -> int:
    """The occupancy calculator's blocks per SM of one kernel mode on device
    ``index`` (once per mode, size and device)."""
    lib = build.load("bp_decode")
    fn = lib.bp_decode_blocks_per_sm
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_longlong]
    with torch.cuda.device(index):
        blocks = fn(int(layered), int(dev), threads, smem)
    if blocks < 1:
        build.check_launch(lib, -blocks, "bp_decode occupancy")
        raise RuntimeError(f"bp_decode: no block of {threads} threads fits an SM")
    return blocks


def resident_blocks_per_sm(plan: BPKernelPlan, device=None) -> int:
    """Blocks of the plan's kernel that one SM of the card holds at once, as
    the CUDA occupancy calculator counts them (registers included): the
    device-memory mode's grid per SM."""
    index = torch.device(device if device is not None else plan.graph.device).index
    return _resident_blocks(plan.layered, plan.device_memory, plan.threads,
                            0 if plan.device_memory else plan.smem_bytes,
                            torch.cuda.current_device() if index is None else index)


@functools.cache
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


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
    lib, fn = _launcher(plan.layered)
    B, index = llr.shape[0], llr.device.index
    bits = torch.empty((B, g.n), dtype=torch.int8, device=llr.device)
    iters = torch.empty((B,), dtype=torch.int32, device=llr.device)
    tables, shape, opts = plan.launch_args
    if plan.device_memory:
        grid = min(B, _sm_count(index) * resident_blocks_per_sm(plan, llr.device))
        scratch = torch.empty((grid * plan.scratch_bytes_per_frame,), dtype=torch.uint8,
                              device=llr.device)
        tail = (plan.scratch_bytes_per_frame, scratch.data_ptr(), grid)
    else:
        tail = (plan.smem_bytes, None, B)
    code = build.launch_on(index, fn, llr.data_ptr(), bits.data_ptr(), iters.data_ptr(), *tables,
                           B, *shape, *opts, *tail)
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
