"""Successive-cancellation list (SCL) and CRC-aided SCL polar decoders.

Path metrics are the numerically stable log-likelihoods ``−logaddexp(0,
∓llr)``.  Inactive paths are carried as "phantom" slots with metric −inf: a
phantom's candidate metric stays −inf forever, so phantoms rank strictly
after every real candidate and the surviving real paths (and their stable
relative order) are those of a decoder with an explicit active mask.

CRC-aided selection picks the best-metric path among the CRC-passing ones,
falling back to the best metric overall when none passes.

By default every list decoder of this package is the chunked decoder of
``scanscl.py`` (``impl="scan-chunked"``), at every N, with ``chunk = min(chunk,
N)``, so that the card runs the list kernels at every code length; the
unrolled recursive decoder of ``fastscl.py`` (``impl="unrolled"``, the JAX
package's default below N=512) computes the same outputs.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch
from torch import nn

from ...core.device import resolve_device
from .construction import frozen_mask_from_positions, generate_frozen_bits
from .crc import CRCCodec
from .fastscl import make_scl_decoder_unrolled
from .scanscl import make_scl_decoder_scan


def select_best_path(info_paths, metrics, crc: Optional[CRCCodec] = None):
    """Pick one path per frame: best metric, or — with a ``CRCCodec`` — the
    best-metric CRC-passing path, falling back to the metric argmax when none
    passes.  Ties go to the first (lowest) slot.  ``info_paths [B, L, K] →
    [B, K]``."""
    best = torch.argmax(metrics, dim=-1)
    if crc is not None:
        ok = crc.check(info_paths)  # [B, L]
        eff = torch.where(ok, metrics, torch.full_like(metrics, -torch.inf))
        best = torch.where(ok.any(dim=-1), torch.argmax(eff, dim=-1), best)
    idx = best[:, None, None].expand(-1, 1, info_paths.shape[-1])
    return torch.gather(info_paths, 1, idx)[:, 0, :]


def make_scl_decoder(N: int, frozen_mask: np.ndarray, list_size: int,
                     dtype=torch.float32, impl: str = "scan-chunked",
                     chunk: int = 128, body_impl: Optional[str] = None,
                     leaf_impl: str = "onehot",
                     control_impl: Optional[str] = None,
                     node_mode: str = "exact", perm_impl: str = "rank",
                     mask_dedup: str = "exact", live_width="auto", device="cuda"):
    """Build an SCL decoder: ``decode(llr [batch, N]) → (u [batch, L, N]
    int8, metrics [batch, L])`` with paths in selection-slot order (slot 0 is
    not necessarily the best path; use the metrics / CRC to select).

    ``impl``: ``"scan-chunked"`` (the chunked decoder of ``scanscl.py``;
    ``chunk`` sets the subtree size) or ``"unrolled"`` (the recursive decoder
    of ``fastscl.py``, one-hot selections; it takes none of the chunked
    decoder's tuning keywords, and exact nodes only).  ``"scan"`` (the
    trellis twin) is not in this package yet.  The other keywords are those of
    ``scanscl.make_scl_decoder_scan``.
    """
    if impl == "scan":
        raise NotImplementedError(f"impl={impl!r} is not in this package yet")
    if impl not in ("scan-chunked", "unrolled"):
        raise ValueError(f"unknown impl {impl!r}")
    if node_mode != "exact" and impl != "scan-chunked":
        raise ValueError("node_mode='fast' requires impl='scan-chunked'")
    if impl == "unrolled":
        return make_scl_decoder_unrolled(N, frozen_mask, list_size, dtype, device=device)
    return make_scl_decoder_scan(N, frozen_mask, list_size, min(chunk, N), dtype,
                                 leaf_impl=leaf_impl, body_impl=body_impl,
                                 control_impl=control_impl, node_mode=node_mode,
                                 perm_impl=perm_impl, mask_dedup=mask_dedup,
                                 live_width=live_width, device=device)


class SCLDecoder(nn.Module):
    """Batched SCL decoder.  With ``use_crc=True`` it performs CA-SCL path
    selection.

    ``chunk`` / ``body_impl`` / ``control_impl`` tune the chunked decoder: on
    a CUDA device the default is the kernel control (``"unroll-kernel"``), on
    the CPU the plain one (``"unroll-fused"``); ``"mega"`` is the whole decode
    in one kernel launch; ``"split"``, ``"fused"`` and ``"kernel"`` are the JAX
    package's other controls.  ``node_mode="fast"`` takes the SSCL fast list
    nodes (an approximate serving mode, see ``scanscl.make_scl_decoder_scan``).
    ``impl="unrolled"`` takes the recursive decoder of ``fastscl.py`` (the
    default stays ``"scan-chunked"`` at every N).
    """

    def __init__(self, N: int, K: int, list_size: int = 8,
                 frozen_bits: Optional[np.ndarray] = None,
                 use_crc: bool = False, crc_polynomial: str = "CRC-8",
                 dtype=torch.float32, impl: Optional[str] = None,
                 chunk: int = 128, body_impl: Optional[str] = None,
                 leaf_impl: str = "onehot", control_impl: Optional[str] = None,
                 node_mode: str = "exact", perm_impl: str = "rank",
                 mask_dedup: str = "exact", device="cuda"):
        super().__init__()
        assert N > 0 and (N & (N - 1)) == 0, "N must be a power of 2"
        assert 0 < K < N, "K must be in (0, N)"
        assert list_size >= 1
        dev = resolve_device(device)
        self.N = N
        self.K = K
        self.L = list_size
        self.n = int(np.log2(N))
        self.use_crc = use_crc
        self.crc_polynomial = crc_polynomial
        if frozen_bits is None:
            self.frozen_bits, self.info_bits = generate_frozen_bits(N, K)
        else:
            self.frozen_bits = np.sort(np.asarray(frozen_bits, dtype=np.int64))
            self.info_bits = np.setdiff1d(np.arange(N), self.frozen_bits)
        self.frozen_mask = frozen_mask_from_positions(N, self.frozen_bits)
        self.dtype = dtype
        self.register_buffer(
            "_info_idx", torch.as_tensor(self.info_bits, dtype=torch.int64, device=dev))
        crc_len = int(crc_polynomial.split("-")[1]) if use_crc else 0
        self._crc = CRCCodec(K - crc_len, crc_polynomial, dev) if use_crc else None
        self.node_mode = node_mode
        self._decode_paths = make_scl_decoder(
            N, self.frozen_mask, list_size, dtype,
            impl="scan-chunked" if impl is None else impl,
            chunk=chunk, body_impl=body_impl, leaf_impl=leaf_impl,
            control_impl=control_impl, node_mode=node_mode,
            perm_impl=perm_impl, mask_dedup=mask_dedup, device=dev)
        self.control_impl = self._decode_paths.control_impl

    def _as_llr(self, llr):
        return torch.as_tensor(llr, device=self._info_idx.device).to(self.dtype)

    def decode_paths(self, llr):
        """All surviving paths: ``(u [batch, L, N], metrics [batch, L])``."""
        return self._decode_paths(torch.atleast_2d(self._as_llr(llr)))

    def decode(self, llr):
        """Best-path info bits ``[..., K]``."""
        llr = self._as_llr(llr)
        squeeze = llr.dim() == 1
        u_paths, metrics = self._decode_paths(torch.atleast_2d(llr))
        out = select_best_path(u_paths[..., self._info_idx], metrics, self._crc)
        return out[0] if squeeze else out

    forward = decode

    def __repr__(self) -> str:
        return (f"SCLDecoder(N={self.N}, K={self.K}, L={self.L}, "
                f"use_crc={self.use_crc})")


class CASCLDecoder(SCLDecoder):
    """CRC-aided SCL.  Equivalent to ``SCLDecoder(..., use_crc=True)``."""

    def __init__(self, N: int, K: int, list_size: int = 8,
                 frozen_bits: Optional[np.ndarray] = None,
                 crc_polynomial: str = "CRC-8", dtype=torch.float32,
                 control_impl: Optional[str] = None, impl: Optional[str] = None,
                 perm_impl: str = "rank", mask_dedup: str = "exact", device="cuda"):
        super().__init__(N, K, list_size, frozen_bits, True, crc_polynomial,
                         dtype, impl=impl, control_impl=control_impl, perm_impl=perm_impl,
                         mask_dedup=mask_dedup, device=device)
