"""NumPy "twins" of the reference implementations.

Fresh, self-contained NumPy implementations that reproduce the reference's
*semantics* (update rules, orderings, tie-breaking) exactly.  They are the
float64 oracle for the decoders and their CUDA kernels: identical noise or
LLRs can be fed to both sides.  Float64 throughout, one frame at a time,
deliberately simple and slow; plain NumPy, no torch.
"""

from . import channel_np, ldpc_np, polar_np

__all__ = ["polar_np", "ldpc_np", "channel_np"]
