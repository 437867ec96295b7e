"""Host-side precomputed SC decode schedule of the trellis decoders.

Leaves decode in bit-reversed order and, per leaf, touch a leaf-dependent
range of trellis stages.  All of this is a pure function of (N, frozen set),
so it is precomputed on the host into dense arrays that the trellis
decoders (``impl="scan"`` of ``sc.py`` / ``scl.py``) walk step by step.

Schedule entries for decode step *i* with leaf ``l = bit_reverse(i)``:

* ``leaf[i]`` — the natural u-index decoded at step i.
* ``frozen[i]`` — whether that leaf is frozen.
* ``llr_active[i, s]`` — whether LLR stage *s* (writing trellis column s+1)
  runs at this step: ``s ≥ n − active_llr_level(l)`` where
  ``active_llr_level = min(1 + clz(l), n)``.
* ``bit_active[i, s-1]`` — whether partial-sum stage *s* (writing column s−1)
  runs: ``s > n − active_bit_level(l)`` and bit ``s−1`` of ``l`` is 1, where
  ``active_bit_level = min(1 + "leading ones"(l), n)``.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from .construction import bit_reverse_permutation


def _active_llr_level(l: int, n: int) -> int:
    """1 + number of leading zeros of ``l`` (n-bit), capped at n."""
    count = 1
    for k in range(n - 1, -1, -1):
        if (l >> k) & 1:
            break
        count += 1
    return min(count, n)


def _active_bit_level(l: int, n: int) -> int:
    """1 + number of leading ones of ``l`` (n-bit), capped at n."""
    count = 1
    for k in range(n - 1, -1, -1):
        if not ((l >> k) & 1):
            break
        count += 1
    return min(count, n)


@dataclass(frozen=True)
class SCSchedule:
    N: int
    n: int
    leaf: np.ndarray        # [N] int32 — bit-reversed decode order
    frozen: np.ndarray      # [N] bool — frozen flag per decode step
    llr_active: np.ndarray  # [N, n] bool
    bit_active: np.ndarray  # [N, n] bool (index s-1 ↔ stage s)


def build_schedule(N: int, frozen_mask: np.ndarray) -> SCSchedule:
    n = int(np.log2(N))
    assert 1 << n == N
    frozen_mask = np.asarray(frozen_mask, bool)
    assert frozen_mask.shape == (N,)

    leaf = bit_reverse_permutation(N).astype(np.int32)
    frozen = frozen_mask[leaf]
    llr_active = np.zeros((N, n), dtype=bool)
    bit_active = np.zeros((N, n), dtype=bool)
    for i in range(N):
        l = int(leaf[i])
        alvl = _active_llr_level(l, n)
        llr_active[i, n - alvl:] = True
        abl = _active_bit_level(l, n)
        for s in range(n, n - abl, -1):
            if (l >> (s - 1)) & 1:
                bit_active[i, s - 1] = True
    return SCSchedule(N=N, n=n, leaf=leaf, frozen=frozen,
                      llr_active=llr_active, bit_active=bit_active)
