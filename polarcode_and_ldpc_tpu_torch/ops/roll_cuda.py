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
    by byte).  Does not synchronise.  Between the checks and the launch
    there is only the output's allocation: the launcher is cached, the
    stream handle is PyTorch's raw current stream, and the device is
    switched only when it is not the current one."""
    if not x.is_cuda:
        raise ValueError(f"sublane_roll_cuda needs a CUDA tensor, got {x.device}")
    if x.dtype != torch.int8 or x.dim() != 2 or not x.is_contiguous():
        raise ValueError(f"expected a contiguous 2-D int8 tile, got {x.dtype} {tuple(x.shape)}")
    rows, cols = x.shape
    if rows * cols >= 2 ** 31:
        raise ValueError(f"the roll kernel indexes in 32 bits; got {rows} x {cols} bytes")
    shift = int(shift) % rows if rows else 0
    lib, fn = _launcher()
    out = torch.empty_like(x)
    index = x.get_device()
    if index == torch._C._cuda_getDevice():
        code = fn(x.data_ptr(), out.data_ptr(), rows, cols, shift,
                  torch._C._cuda_getCurrentRawStream(index))
    else:
        code = build.launch_on(index, fn, x.data_ptr(), out.data_ptr(), rows, cols, shift)
    if code:
        build.check_launch(lib, code, "sublane_roll")
    count_launch("sublane_roll")
    return out


def sublane_roll(x: torch.Tensor, shift: int) -> torch.Tensor:
    """The row roll: the plain version for a CPU tensor, the kernel for a
    CUDA tensor."""
    if x.device.type == "cpu":
        return sublane_roll_plain(x, shift)
    return sublane_roll_cuda(x.contiguous(), shift)
