"""State carried across from the JAX package.

The system has no learned weights; its state is the code definition.  These
functions take the JAX package's objects **as numpy arrays** (the caller does
the ``np.asarray``) and return this package's objects.  Nothing here imports
JAX.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from .core.config import ChannelConfig, LDPCCodeConfig, PolarCodeConfig, SimulationConfig
from .core.device import resolve_device
from .models.ldpc.encoder import LDPCEncoder
from .models.ldpc.graph import TABLE_NAMES, TannerGraph
from .models.ldpc.matrix import qc_expand
from .models.polar.construction import frozen_mask_from_positions
from .models.polar.crc import CRCCodec


def polar_code_from_numpy(N: int, frozen_mask: Optional[np.ndarray] = None,
                          frozen_bits: Optional[np.ndarray] = None) -> dict:
    """A polar code definition from either a boolean frozen mask ``[N]`` or
    sorted frozen positions: ``{"N", "K", "frozen_bits", "info_bits",
    "frozen_mask"}`` as the functions of ``models.polar`` take them."""
    if (frozen_mask is None) == (frozen_bits is None):
        raise ValueError("give exactly one of frozen_mask and frozen_bits")
    if frozen_mask is not None:
        mask = np.asarray(frozen_mask).astype(bool)
        if mask.shape != (N,):
            raise ValueError(f"frozen_mask must have shape ({N},), got {mask.shape}")
    else:
        mask = frozen_mask_from_positions(N, np.asarray(frozen_bits))
    frozen = np.nonzero(mask)[0].astype(np.int64)
    info = np.nonzero(~mask)[0].astype(np.int64)
    return {"N": N, "K": int(info.size), "frozen_bits": frozen,
            "info_bits": info, "frozen_mask": mask}


def crc_codec_from_numpy(enc_matrix: np.ndarray, chk_matrix: np.ndarray,
                         polynomial: str = "CRC-8", device="cuda") -> CRCCodec:
    """A ``CRCCodec`` that carries the given GF(2) matrices (``enc_matrix
    [data_len, crc_len]``, ``chk_matrix [data_len + crc_len, crc_len]``)
    instead of deriving its own."""
    enc = np.asarray(enc_matrix)
    if enc.ndim != 2:
        raise ValueError(f"enc_matrix must be 2-D, got shape {enc.shape}")
    return CRCCodec(enc.shape[0], polynomial, device, enc_matrix=enc,
                    chk_matrix=np.asarray(chk_matrix))


def ldpc_code_from_numpy(H: np.ndarray, G: np.ndarray,
                         info_positions: Optional[np.ndarray] = None,
                         device="cuda") -> LDPCEncoder:
    """An ``LDPCEncoder`` that carries the given ``H [m, n]``, generator
    ``G [k, n]`` and message positions instead of deriving its own."""
    H = np.asarray(H)
    G = np.asarray(G)
    k, n = G.shape
    enc = LDPCEncoder(n, k, H=H, G=G, device=device)
    if info_positions is not None:
        info = np.asarray(info_positions, dtype=np.int64)
        enc.info_positions = info
        enc._info_idx = torch.as_tensor(info, dtype=torch.int64, device=enc._G_dev.device)
        enc.use_direct_solving = not bool((info == np.arange(k)).all())
    return enc


def qc_code_from_numpy(base: np.ndarray, z: int, G: Optional[np.ndarray] = None,
                       info_positions: Optional[np.ndarray] = None,
                       device="cuda") -> dict:
    """A quasi-cyclic code from its shift matrix ``base [mb, nb]`` (−1 = no
    edge) and lift size ``z``: ``{"qc_base", "z", "H", "encoder"}``, the inputs
    of ``QCBPDecoder`` and ``make_ldpc_pipeline(qc_base=, z=)``.  With ``G``
    (and ``info_positions``) the encoder carries the given generator as
    ``ldpc_code_from_numpy`` does; otherwise it derives its own from the
    expanded ``H``."""
    base = np.asarray(base, dtype=np.int64)
    if base.ndim != 2:
        raise ValueError(f"base must be 2-D, got shape {base.shape}")
    H = qc_expand(base, z)
    m, n = H.shape
    if G is None:
        enc = LDPCEncoder(n, n - m, H=H, device=device)
    else:
        enc = ldpc_code_from_numpy(H, G, info_positions, device)
    return {"qc_base": base, "z": int(z), "H": H, "encoder": enc}


def tanner_graph_from_numpy(tables: dict, device="cuda") -> TannerGraph:
    """A ``TannerGraph`` from the six index/mask arrays of the JAX package's
    graph (``check_vars, check_mask, cv_gather, var_checks, var_mask,
    vc_gather``)."""
    missing = [k for k in TABLE_NAMES if k not in tables]
    if missing:
        raise KeyError(f"missing graph tables: {missing}")
    return TannerGraph({k: np.asarray(tables[k]) for k in TABLE_NAMES}, device)


def key_from_numpy(key_data: np.ndarray, device="cuda") -> torch.Tensor:
    """A key of ``core.rng`` from the two ``uint32`` words of a
    ``jax.random.PRNGKey``'s data."""
    words = np.asarray(key_data)
    if words.shape != (2,):
        raise ValueError(f"expected uint32[2] key data, got shape {words.shape}")
    words = words.astype(np.uint32)
    return torch.from_numpy(words.view(np.int32).copy()).to(resolve_device(device))


_CONFIGS = {c.__name__: c for c in (PolarCodeConfig, LDPCCodeConfig, ChannelConfig,
                                     SimulationConfig)}
# implementation names each field of this package's configs takes; any other
# name of the JAX package (a TPU body "xla" / "pallas", an interpret twin of a
# Pallas control such as "kernel-interpret", the LDPC impl "auto" / "pallas",
# ...) becomes None, the device default: every choice computes the same outputs
_PORT_CHOICES = {"scl_body_impl": ("torch", "cuda"),
                 "scl_control_impl": ("split", "fused", "kernel", "unroll-fused",
                                      "unroll-kernel", "mega"),
                 "bp_impl": ("torch", "cuda")}


def config_from_jax(cfg):
    """This package's counterpart of a JAX config dataclass instance
    (``PolarCodeConfig``, ``LDPCCodeConfig``, ``ChannelConfig`` or
    ``SimulationConfig``), field by field through ``dataclasses.asdict``.
    The list controls ``"split"``, ``"fused"``, ``"kernel"``,
    ``"unroll-fused"``, ``"unroll-kernel"`` and ``"mega"`` stay as they are;
    implementation names this package lacks become ``None`` (the device
    default): the chunk bodies ``"xla"`` / ``"pallas"`` of
    ``scl_body_impl``, the interpret twins of the Pallas controls, and any
    ``bp_impl`` but ``"torch"`` / ``"cuda"``."""
    cls = _CONFIGS.get(type(cfg).__name__)
    if cls is None or not dataclasses.is_dataclass(cfg):
        raise TypeError(f"expected a config dataclass instance, got {type(cfg).__name__}")
    fields = dataclasses.asdict(cfg)
    for key, choices in _PORT_CHOICES.items():
        if key in fields and fields[key] not in choices:
            fields[key] = None
    return cls(**fields)
