"""Optional third-party oracles: ``polarcodes`` (polar frozen sets) and
``pyldpc`` (LDPC H and G), the construction service and differential
reference of the laboratory the JAX package reproduces.

Both libraries are optional.  Where they do not import, every entry point
falls back to the pure-NumPy reimplementation of their published
construction algorithms (:mod:`.constructions_np`, which the banded
Gallager LDPC construction of ``models.ldpc.matrix`` also reads).  The
oracles run on the host; their codes are encoded and decoded by this
package's own pipelines.
"""

from __future__ import annotations

from . import constructions_np


def oracle_available(which: str) -> bool:
    """True when the third-party library backing ``which`` (``"polar"`` or
    ``"ldpc"``) imports."""
    try:
        if which == "polar":
            import polarcodes  # noqa: F401
        elif which == "ldpc":
            import pyldpc  # noqa: F401
        else:
            return False
        return True
    except ImportError:
        return False


def oracle_polar_frozen_set(N: int, K: int, design_snr_db: float = 2.0):
    """Frozen positions from the ``polarcodes`` oracle: the library where it
    imports, else the NumPy reimplementation of its construction
    (``constructions_np.polar_construct_np``).

    Returns ``(frozen_positions sorted, backend_str)``."""
    if oracle_available("polar"):
        from .polar_oracle import PolarLibWrapper

        return (PolarLibWrapper(N, K, design_snr_db).get_frozen_positions(),
                "polarcodes")
    return constructions_np.polar_construct_np(N, K, design_snr_db)[0], "numpy-reimpl"


def oracle_ldpc_matrices(n: int, dv: int = 3, dc: int = 6, seed: int = 42):
    """``(H, G, backend)`` from the ``pyldpc`` oracle: the library where it
    imports, else the NumPy reimplementation of its systematic ``make_ldpc``
    (``constructions_np.make_ldpc_np``).  ``G`` is in pyldpc's tall ``(n,
    k_actual)`` orientation, ``k_actual`` possibly below ``n − m``."""
    if oracle_available("ldpc"):
        from .ldpc_oracle import LDPCLibWrapper

        w = LDPCLibWrapper(n, dv, dc, seed)
        return w.H, w.G, "pyldpc"
    H, G = constructions_np.make_ldpc_np(n, dv, dc, seed=seed)
    return H, G, "numpy-reimpl"


__all__ = ["constructions_np", "oracle_available", "oracle_polar_frozen_set",
           "oracle_ldpc_matrices"]
