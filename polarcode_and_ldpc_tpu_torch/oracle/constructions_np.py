"""Pure-NumPy reimplementations of the third-party **construction**
algorithms of ``polarcodes`` (polar frozen sets) and ``pyldpc`` (LDPC H and
G), which the reference laboratory used as its code-construction service.

Neither library needs to be installed: this module reimplements the two
construction algorithms from their published descriptions, a copy of the
JAX package's module of the same name:

* ``polar_construct_np`` — py-polar-codes' ``Construct`` /
  ``general_pcc``: Bhattacharyya bounds tracked in the **log domain**
  (so good-channel parameters keep resolution instead of underflowing to
  exact-0 ties, which is where it genuinely differs from the linear-domain
  ``models.polar.construction.bhattacharyya_bounds``) with the design SNR
  **rate-normalised** (Es/N0 = (K/N)·Eb/N0), frozen set = the N−K
  largest-Z bit channels;
* ``make_ldpc_np`` — pyldpc's ``make_ldpc(systematic=True)``: a regular
  Gallager parity-check matrix (``parity_check_matrix``: d_v stacked
  bands, the first with consecutive runs of d_c ones, the rest independent
  column permutations of it) plus the systematic generator derived by
  GF(2) Gauss–Jordan elimination with column swaps
  (``coding_matrix_systematic``), including the ``k_actual = n − rank(H)``
  adjustment the reference propagates (``ldpc_wrapper.py:49-60``).

These are *constructions only*: the resulting codes are encoded and
decoded by this package's own paths.  ``models.ldpc.matrix`` builds its
banded Gallager matrices with :func:`parity_check_matrix_np`.
"""

from __future__ import annotations

import numpy as np


# ---------------------------------------------------------------------------
# polar: py-polar-codes' design-SNR Bhattacharyya construction (log domain)
# ---------------------------------------------------------------------------

def logdomain_diff(x: np.ndarray, y: np.ndarray) -> np.ndarray:
    """log(e^x − e^y) for x ≥ y, stable: x + log1p(−e^(y−x))."""
    with np.errstate(divide="ignore"):
        return x + np.log1p(-np.exp(np.minimum(y - x, 0.0)))


def polar_z_log_np(N: int, K: int, design_snr_db: float) -> np.ndarray:
    """Log-domain Bhattacharyya parameters of the N bit channels at the
    rate-normalised design SNR (py-polar-codes ``general_pcc``).

    Base channel: log Z = −Es/N0 with Es/N0 = (K/N)·10^(design/10) — the
    library's ``get_normalised_SNR``.  Recursion per polarisation level:
    worse child log(2Z − Z²) = logdomain_diff(log 2 + z, 2z), better child
    log(Z²) = 2z.  Index convention: split level j lands on bit j−1 of the
    u-index (LSB = first split) — the same convention as this framework's
    natural-order trellis (``models.polar.construction`` fixed the
    reference's own MSB-first mismatch; the library agrees with LSB-first).
    """
    assert N > 0 and (N & (N - 1)) == 0, "N must be a power of 2"
    n = int(np.log2(N))
    es_n0 = (K / N) * 10.0 ** (design_snr_db / 10.0)
    z = np.empty(N, np.float64)
    z[0] = -es_n0
    for j in range(1, n + 1):
        u = 1 << j
        half = z[: u // 2].copy()
        z[: u // 2] = logdomain_diff(np.log(2.0) + half, 2.0 * half)
        z[u // 2: u] = 2.0 * half
    return z


def polar_construct_np(N: int, K: int, design_snr_db: float = 2.0):
    """Frozen/info sets per py-polar-codes' ``Construct``: the N−K bit
    channels with the largest log-Z are frozen (ties broken by lower index
    — stable sort, matching NumPy's mergesort the library sorts with).

    Returns ``(frozen_positions, info_positions)``, both sorted ascending
    (the orientation ``PolarLibWrapper.get_frozen_positions`` emits).
    """
    z = polar_z_log_np(N, K, design_snr_db)
    order = np.argsort(z, kind="stable")          # most reliable first
    info, frozen = order[:K], order[K:]
    return np.sort(frozen), np.sort(info)


# ---------------------------------------------------------------------------
# LDPC: pyldpc's make_ldpc(systematic=True) — Gallager H + systematic G
# ---------------------------------------------------------------------------

def gaussjordan_np(X: np.ndarray, change: bool = False):
    """GF(2) Gauss–Jordan row reduction (pyldpc ``utils.gaussjordan``):
    scan columns left→right, pick the first available pivot row (argmax on
    the 0/1 column below the last pivot), swap it up, and clear the column
    everywhere else with row XORs.  ``change=True`` also returns the
    accumulated row-transform matrix P with P·X = reduced form."""
    A = np.array(X, dtype=np.int64) % 2
    m, n = A.shape
    P = np.eye(m, dtype=np.int64) if change else None
    pivot_old = -1
    for j in range(n):
        below = A[pivot_old + 1:, j]
        if below.size == 0:
            break
        pivot = int(np.argmax(below)) + pivot_old + 1
        if A[pivot, j]:
            pivot_old += 1
            if pivot_old != pivot:
                A[[pivot_old, pivot]] = A[[pivot, pivot_old]]
                if change:
                    P[[pivot_old, pivot]] = P[[pivot, pivot_old]]
            mask = (A[:, j] == 1)
            mask[pivot_old] = False
            A[mask] ^= A[pivot_old]
            if change:
                P[mask] ^= P[pivot_old]
        if pivot_old == m - 1:
            break
    return (A, P) if change else A


def parity_check_matrix_np(n_code: int, d_v: int, d_c: int,
                           seed=None) -> np.ndarray:
    """Regular Gallager parity-check matrix (pyldpc
    ``parity_check_matrix``): m = n·d_v/d_c rows in d_v bands of
    m/d_v rows; band 0 has row i covering columns [i·d_c, (i+1)·d_c);
    bands 1..d_v−1 are independent uniform column permutations of band 0
    (legacy ``np.random.RandomState`` permutation, as the library's
    ``check_random_state`` resolves an int seed)."""
    assert d_v > 1, "d_v must be at least 2"
    assert d_c > d_v, "d_c must be greater than d_v"
    assert (n_code * d_v) % d_c == 0, "d_c must divide n·d_v"
    rng = seed if isinstance(seed, np.random.RandomState) \
        else np.random.RandomState(seed)
    n_equations = (n_code * d_v) // d_c
    assert n_equations % d_v == 0, "d_v must divide the equation count"
    block_size = n_equations // d_v
    block = np.zeros((block_size, n_code), dtype=np.int64)
    for i in range(block_size):
        block[i, i * d_c:(i + 1) * d_c] = 1
    H = np.empty((n_equations, n_code), dtype=np.int64)
    H[:block_size] = block
    for b in range(1, d_v):
        # rng.permutation on a 2-D array permutes its leading axis:
        # permuting block.T's rows = permuting block's columns
        H[b * block_size:(b + 1) * block_size] = rng.permutation(block.T).T
    return H


def coding_matrix_systematic_np(H: np.ndarray):
    """Systematic generator from H (pyldpc ``coding_matrix_systematic``):
    row-reduce H, column-swap it toward ``[I_(n−k) | A]`` (each deficient
    diagonal takes the nearest 1 to its right, the swaps accumulated in a
    column permutation P1), then rotate the identity block to the back
    (P2) so message bits occupy the FIRST k codeword positions.

    Returns ``(H_new, G)`` with ``H_new = H·P1ᵀ·P2ᵀ`` (the column-permuted
    check matrix the codewords of G actually satisfy) and ``G`` in
    pyldpc's tall ``(n, k_actual)`` orientation,
    ``k_actual = n − rank(H)``."""
    H = np.asarray(H, dtype=np.int64) % 2
    n_equations, n_code = H.shape
    P1 = np.eye(n_code, dtype=np.int64)
    Hrow = gaussjordan_np(H)
    n_bits = n_code - int(sum(int(row.any()) for row in Hrow))  # n − rank
    while True:
        zeros = [i for i in range(min(n_equations, n_code))
                 if not Hrow[i, i]]
        if not zeros:
            break
        ia = min(zeros)
        ones = [j for j in range(ia + 1, n_code) if Hrow[ia, j]]
        if not ones:
            break
        ib = min(ones)
        Hrow[:, [ia, ib]] = Hrow[:, [ib, ia]]
        P1[:, [ia, ib]] = P1[:, [ib, ia]]
    # Hrow is now [I_(n−k) | A]; move the message block to the front
    P1 = P1.T
    sigma = list(range(n_code - n_bits, n_code)) + \
        list(range(n_code - n_bits))
    P2 = np.zeros((n_code, n_code), dtype=np.int64)
    P2[np.arange(n_code), sigma] = 1
    H_new = (H @ P1.T % 2 @ P2.T) % 2
    G = np.zeros((n_bits, n_code), dtype=np.int64)
    G[:, :n_bits] = np.eye(n_bits, dtype=np.int64)
    G[:, n_bits:] = Hrow[: n_code - n_bits, n_code - n_bits:].T
    return H_new, G.T


def make_ldpc_np(n_code: int, d_v: int, d_c: int, systematic: bool = True,
                 seed=None):
    """pyldpc's ``make_ldpc`` for the systematic path the reference uses
    (``ldpc_wrapper.py:49-60``): Gallager H, then the column-permuted
    (H_new, G) pair with ``G [n, k_actual]``."""
    H = parity_check_matrix_np(n_code, d_v, d_c, seed=seed)
    assert systematic, "only the reference's systematic path is modelled"
    return coding_matrix_systematic_np(H)
