"""K8: the row roll of an int8 tile.

``csrc/sublane_roll.cu`` replaces the TPU probe ``tools/r4_tpu_queue7.sh:14``
(``pltpu.roll`` of one ``[32, 128]`` int8 tile by 30 along the sublane axis,
checked against ``np.roll(x, 30, 0)``).  The probe lies on no path of the
system; the port keeps it so that every function of the repo that reaches
``pallas_call`` has its Hopper counterpart.  ``sublane_roll`` launches the
kernel for a CUDA tensor and runs the plain version for a CPU tensor.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from . import build, count_launch

#: the probe's tile and shift
PROBE_SHAPE, PROBE_SHIFT = (32, 128), 30


def sublane_roll_plain(x: torch.Tensor, shift: int) -> torch.Tensor:
    """``out[i] = x[(i − shift) mod rows]``: ``np.roll(x, shift, 0)``."""
    rows = x.shape[0]
    src = (torch.arange(rows, device=x.device) - shift) % rows
    return x[src]


@functools.cache
def _launcher():
    lib = build.load("sublane_roll")
    fn = lib.sublane_roll_launch
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                   ctypes.c_void_p]
    return lib, fn


def sublane_roll_cuda(x: torch.Tensor, shift: int) -> torch.Tensor:
    """Launch the roll kernel on ``x [rows, cols]`` int8, contiguous, on a
    CUDA device (a tile that does not start on a 16-byte boundary moves byte
    by byte).  Does not synchronise."""
    if x.device.type != "cuda":
        raise ValueError(f"sublane_roll_cuda needs a CUDA tensor, got {x.device}")
    if x.dtype != torch.int8 or x.dim() != 2 or not x.is_contiguous():
        raise ValueError(f"expected a contiguous 2-D int8 tile, got {x.dtype} {tuple(x.shape)}")
    lib, fn = _launcher()
    out = torch.empty_like(x)
    with torch.cuda.device(x.device):
        code = fn(x.data_ptr(), out.data_ptr(), x.shape[0], x.shape[1], int(shift),
                  torch.cuda.current_stream().cuda_stream)
    build.check_launch(lib, code, "sublane_roll")
    count_launch("sublane_roll")
    return out


def sublane_roll(x: torch.Tensor, shift: int) -> torch.Tensor:
    """The row roll: the plain version for a CPU tensor, the kernel for a
    CUDA tensor."""
    if x.device.type == "cpu":
        return sublane_roll_plain(x, shift)
    return sublane_roll_cuda(x.contiguous(), shift)
