"""LDPC utility functions (host-side NumPy): Tanner-graph adjacency lists,
syndromes, error counts."""

from __future__ import annotations

from typing import List, Tuple

import numpy as np


def create_tanner_graph(H: np.ndarray) -> Tuple[List[List[int]], List[List[int]]]:
    """Adjacency lists ``(var_neighbors, check_neighbors)``."""
    H = np.asarray(H)
    m, n = H.shape
    var_neighbors: List[List[int]] = [[] for _ in range(n)]
    check_neighbors: List[List[int]] = [[] for _ in range(m)]
    rows, cols = np.nonzero(H)
    for c, v in zip(rows.tolist(), cols.tolist()):
        check_neighbors[c].append(v)
        var_neighbors[v].append(c)
    return var_neighbors, check_neighbors


def calculate_syndrome(H: np.ndarray, received: np.ndarray) -> np.ndarray:
    """H·c mod 2, batched over leading axes."""
    return (np.asarray(received) @ np.asarray(H).T) % 2


def check_syndrome(H: np.ndarray, codeword: np.ndarray) -> bool:
    """True iff the syndrome is zero."""
    return bool(np.all(calculate_syndrome(H, codeword) == 0))


def count_errors(original: np.ndarray, decoded: np.ndarray) -> int:
    """Bit error count."""
    return int(np.sum(np.asarray(original) != np.asarray(decoded)))


def hamming_distance(a: np.ndarray, b: np.ndarray) -> int:
    """Hamming distance."""
    return int(np.sum(np.asarray(a) != np.asarray(b)))
