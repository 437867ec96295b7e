"""Third-party construction oracles.

Only the pure-NumPy reimplementation of the ``polarcodes`` / ``pyldpc``
construction algorithms is in this package so far
(:mod:`.constructions_np`); the banded Gallager LDPC construction of
``models.ldpc.matrix`` reads it.
"""

from . import constructions_np

__all__ = ["constructions_np"]
