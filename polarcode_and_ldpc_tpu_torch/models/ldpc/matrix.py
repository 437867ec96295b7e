"""LDPC parity-check matrix construction (host-side NumPy).

Seeded ``np.random`` draws are made in a fixed order, so a seed gives the same
``H`` as the JAX package's constructors.  PEG and banded Gallager
constructions and the girth diagnostic are not in this package yet.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np


def mackay_construction(n: int, k: int, dv: int, dc: int,
                        seed: Optional[int] = None) -> np.ndarray:
    """MacKay-style random regular-column H: each column receives ``dv`` ones
    in distinct random rows; row degrees are not enforced."""
    m = n - k
    if dv * n != dc * m:
        # row degrees are not enforced by this construction, so a non-exact
        # product only changes the *average* row degree
        print(f"Warning: dv*n={dv * n} != dc*m={dc * m}; average row degree "
              f"will be {dv * n / m:.2f}")
    rng = np.random.RandomState(seed) if seed is not None else np.random
    H = np.zeros((m, n), dtype=np.int64)
    for col in range(n):
        rows = rng.choice(m, dv, replace=False)
        H[rows, col] = 1
    return H


def regular_construction(n: int, k: int, dv: int, dc: int,
                         seed: Optional[int] = None,
                         max_repair_rounds: int = 1000) -> np.ndarray:
    """(dv, dc)-regular Gallager-style H via random stub matching: exact
    column degree ``dv`` AND exact row degree ``dc``.  Duplicate row
    assignments within a column are repaired by swapping stubs between
    columns."""
    m = n - k
    if dv * n != dc * m:
        raise ValueError(f"degree constraint not satisfied: dv*n={dv * n} != dc*m={dc * m}")
    rng = np.random.default_rng(seed)
    stubs = np.repeat(np.arange(m), dc)
    rng.shuffle(stubs)
    cols = stubs.reshape(n, dv)
    for _ in range(max_repair_rounds):
        bad = [c for c in range(n) if len(np.unique(cols[c])) < dv]
        if not bad:
            break
        for c in bad:
            vals, counts = np.unique(cols[c], return_counts=True)
            dups = vals[counts > 1]
            if dups.size == 0:  # an earlier swap this round already fixed c
                continue
            dup = dups[0]
            slot = int(np.where(cols[c] == dup)[0][-1])
            c2 = int(rng.integers(n))
            s2 = int(rng.integers(dv))
            # swap keeps both row and column degree counts intact
            cols[c, slot], cols[c2, s2] = cols[c2, s2], cols[c, slot]
    else:
        raise RuntimeError("stub-matching repair did not converge")
    H = np.zeros((m, n), dtype=np.int64)
    for c in range(n):
        H[cols[c], c] = 1
    return H


def qc_base_matrix(n: int, k: int, z: int, dv: int = 3, dc: int = 6,
                   seed: Optional[int] = None) -> np.ndarray:
    """Shift matrix of a quasi-cyclic LDPC code: ``[mb, nb]`` int64 with −1
    for "no edge" and a circulant shift ``s ∈ [0, z)`` per base edge.

    The base graph is (dv, dc)-regular (``regular_construction``); shifts are
    random.  The base form is what the roll-based decoder
    (``models/ldpc/qc.py``) consumes directly: circulant permutations become
    ``torch.roll`` on z-sized blocks, so message passing at n=8192 needs no
    gather tables at all.
    """
    m = n - k
    if n % z or m % z:
        raise ValueError(f"lift size z={z} must divide n={n} and m={m}")
    nb, mb = n // z, m // z
    proto = regular_construction(nb, nb - mb, dv, dc, seed)
    rng = np.random.default_rng(None if seed is None else seed + 1)
    base = np.full((mb, nb), -1, dtype=np.int64)
    for bi in range(mb):
        for bj in range(nb):
            if proto[bi, bj]:
                base[bi, bj] = int(rng.integers(z))
    return base


def qc_expand(base: np.ndarray, z: int) -> np.ndarray:
    """Lift a shift matrix to the dense ``[mb·z, nb·z]`` parity-check H:
    entry s ≥ 0 becomes the circulant ``roll(I_z, s, axis=1)`` (check r of
    the block connects to variable ``(r + s) mod z``)."""
    base = np.asarray(base)
    mb, nb = base.shape
    H = np.zeros((mb * z, nb * z), dtype=np.int64)
    eye = np.eye(z, dtype=np.int64)
    for bi in range(mb):
        for bj in range(nb):
            s = int(base[bi, bj])
            if s >= 0:
                H[bi * z:(bi + 1) * z, bj * z:(bj + 1) * z] = np.roll(
                    eye, s, axis=1)
    return H


def qc_ldpc_construction(n: int, k: int, z: int, dv: int = 3, dc: int = 6,
                         seed: Optional[int] = None) -> np.ndarray:
    """Quasi-cyclic LDPC H: a (dv, dc)-regular base graph lifted by z×z
    circulant permutation blocks with random shifts.  Requires ``z | n`` and
    ``z | (n−k)``.  See :func:`qc_base_matrix` for the shift-matrix form the
    roll-based decoder consumes."""
    return qc_expand(qc_base_matrix(n, k, z, dv, dc, seed), z)


def generate_ldpc_matrix(n: int, k: int, method: str = "mackay", dv: int = 3,
                         dc: int = 6, seed: Optional[int] = None,
                         z: Optional[int] = None) -> np.ndarray:
    """Dispatching constructor: ``mackay``, ``regular``, ``qc`` and
    ``random``.  ``gallager`` and ``peg`` are not in this package yet."""
    m = n - k
    if method in ("qc", "qc_ldpc"):
        return qc_ldpc_construction(n, k, z or max(2, n // 64), dv, dc, seed)
    if method in ("gallager", "peg"):
        raise NotImplementedError(
            f"method={method!r} is not in this package yet")
    if method in ("mackay", "regular"):
        if dv * n != dc * m:
            dc = (dv * n) // m
            if dv * n % m != 0:
                print(f"Warning: adjusted dc to {dc} to satisfy constraints")
        if method == "mackay":
            return mackay_construction(n, k, dv, dc, seed)
        if dv * n % m != 0:
            # exact (dv, dc)-regularity is impossible for these parameters;
            # use the tolerant MacKay construction instead of failing
            print("Warning: exact regular construction impossible "
                  f"(dv·n={dv * n} % m={m} != 0); using mackay")
            return mackay_construction(n, k, dv, dc, seed)
        return regular_construction(n, k, dv, dc, seed)
    if method == "random":
        rng = np.random.RandomState(seed) if seed is not None else np.random
        return rng.randint(0, 2, (m, n)).astype(np.int64)
    raise ValueError(f"unknown method: {method}")


# -- packed GF(2) row operations ---------------------------------------------
# Rows live as uint64 bitset words: elimination slabs move 64× less memory
# than uint8 matrices.

def _gf2_pack(W: np.ndarray) -> np.ndarray:
    m, n = W.shape
    nbytes = ((n + 63) // 64) * 8
    packed = np.packbits(W.astype(np.uint8), axis=1, bitorder="little")
    out = np.zeros((m, nbytes), np.uint8)
    out[:, : packed.shape[1]] = packed
    return out.view(np.uint64)


def _gf2_unpack(Wp: np.ndarray, n: int) -> np.ndarray:
    return np.unpackbits(Wp.view(np.uint8), axis=1, bitorder="little")[:, :n]


def _gf2_col(Wp: np.ndarray, col: int) -> np.ndarray:
    w, b = divmod(col, 64)
    return ((Wp[:, w] >> np.uint64(b)) & np.uint64(1)).astype(bool)


def _gf2_eliminate(Wp: np.ndarray, pivot_row: int, col: int) -> None:
    """XOR the pivot row into every other row with a 1 in ``col``."""
    elim = _gf2_col(Wp, col)
    elim[pivot_row] = False
    Wp[elim] ^= Wp[pivot_row]


def create_systematic_generator(H: np.ndarray) -> Tuple[Optional[np.ndarray], Optional[np.ndarray]]:
    """Row-reduce H to [P | I] and return G = [I | Pᵀ].  Returns (None, None)
    if the last m columns are singular over GF(2)."""
    H = np.asarray(H)
    m, n = H.shape
    k = n - m
    Wp = _gf2_pack(H % 2)
    for i in range(m):
        col = n - m + i
        hits = np.nonzero(_gf2_col(Wp, col)[i:])[0]
        if hits.size == 0:
            return None, None
        pivot = i + int(hits[0])
        if pivot != i:
            Wp[[i, pivot]] = Wp[[pivot, i]]
        _gf2_eliminate(Wp, i, col)
    P = _gf2_unpack(Wp, n)[:, :k].astype(np.int64)
    G = np.hstack([np.eye(k, dtype=np.int64), P.T])
    return G, P


def encodable_form(H: np.ndarray, k: int):
    """General information-set encoder construction.

    Row-reduces H with pivots chosen greedily from the *rightmost* columns so
    the message tends to occupy the leading positions.  Returns
    ``(G_full [k, n], info_positions [k])`` with ``c = m·G_full mod 2``
    satisfying H·cᵀ = 0 and ``c[info_positions] = m``.  Returns (None, None)
    only if fewer than k free columns exist.
    """
    H = (np.asarray(H) % 2).astype(np.uint8)
    m, n = H.shape
    Wp = _gf2_pack(H)
    pivot_cols: list[int] = []
    pivot_row = 0
    for col in range(n - 1, -1, -1):  # prefer right-side pivots → parity on the right
        if pivot_row >= m:
            break
        hit = np.nonzero(_gf2_col(Wp, col)[pivot_row:])[0]
        if hit.size == 0:
            continue
        prow = pivot_row + int(hit[0])
        if prow != pivot_row:
            Wp[[pivot_row, prow]] = Wp[[prow, pivot_row]]
        _gf2_eliminate(Wp, pivot_row, col)
        pivot_cols.append(col)
        pivot_row += 1
    W = _gf2_unpack(Wp, n)
    free_cols = sorted(set(range(n)) - set(pivot_cols))
    if len(free_cols) < k:
        return None, None
    info = np.array(free_cols[:k], dtype=np.int64)
    G = np.zeros((k, n), dtype=np.int64)
    G[np.arange(k), info] = 1
    # each pivot row r reads: x[pivot_cols[r]] = XOR of its free-column
    # entries; surplus free columns are fixed to zero → contribute nothing
    npiv = len(pivot_cols)
    G[:, np.asarray(pivot_cols, dtype=np.int64)] = W[:npiv][:, info].T
    # validity check in f32 BLAS (exact: row sums ≪ 2^24)
    syn = H.astype(np.float32) @ G.T.astype(np.float32)
    assert not np.any(syn % 2), "encodable_form produced invalid generator"
    return G, info


def gf2_rank(H: np.ndarray) -> int:
    """Rank of H over GF(2) by packed XOR Gaussian elimination."""
    Wp = _gf2_pack(np.asarray(H) % 2)
    m, n = np.asarray(H).shape
    rank = 0
    for col in range(n):
        if rank >= m:
            break
        hits = np.nonzero(_gf2_col(Wp, col)[rank:])[0]
        if hits.size == 0:
            continue
        pivot = rank + int(hits[0])
        if pivot != rank:
            Wp[[rank, pivot]] = Wp[[pivot, rank]]
        _gf2_eliminate(Wp, rank, col)
        rank += 1
    return rank


def check_matrix_rank(H: np.ndarray) -> int:
    """GF(2) rank."""
    return gf2_rank(H)
