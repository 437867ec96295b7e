"""Device resolution shared by every factory function and class of the package.

Entry points default to ``device="cuda"`` and never carry on on the CPU when
no card is present: the CPU is used only when the caller passes
``device="cpu"``.
"""

from __future__ import annotations

import torch


def resolve_device(device="cuda") -> torch.device:
    """``torch.device`` of the request; raises if CUDA is asked for and no
    CUDA device is available."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device={str(device)!r} requested but no CUDA device is "
            "available; pass device='cpu' to run on the CPU")
    return dev
