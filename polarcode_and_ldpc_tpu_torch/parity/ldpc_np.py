"""NumPy twin of the reference LDPC decoders.

Faithfully mirrors ``src/ldpc/decoder.py`` semantics: adjacency-list Tanner
graph (:35-60), sum-product check update with ±0.999999 tanh clipping and
±20 saturation (:62-96), total-minus-self variable update (:98-122), hard
decision ``total ≤ 0 → 1`` (:191), zero-syndrome early stop with actual
iteration counts (:194-202), and the min-sum variant with normalization
(:257-287).  One frame at a time, float64.
"""

from __future__ import annotations

import numpy as np


def _tanner(H):
    H = np.asarray(H)
    m, n = H.shape
    var_neighbors = [np.nonzero(H[:, v])[0] for v in range(n)]
    check_neighbors = [np.nonzero(H[c, :])[0] for c in range(m)]
    return var_neighbors, check_neighbors


def _check_update_bp(msgs: np.ndarray) -> np.ndarray:
    t = np.tanh(np.asarray(msgs) / 2.0)
    t = np.clip(t, -0.999999, 0.999999)
    out = np.zeros_like(t)
    idx = np.arange(t.size)
    for i in range(t.size):
        prod = np.prod(t[idx != i])
        prod = np.clip(prod, -0.999999, 0.999999)
        out[i] = 2.0 * np.arctanh(prod)
    return np.nan_to_num(out, nan=0.0, posinf=20.0, neginf=-20.0)


def _check_update_ms(msgs: np.ndarray, normalization: float, offset: float = 0.0) -> np.ndarray:
    msgs = np.asarray(msgs, np.float64)
    if msgs.size == 1:
        # degree-1 check: leave-one-out set is empty (the reference would
        # crash here, decoder.py:282; the device path emits 0)
        return np.zeros(1)
    signs = np.sign(msgs)
    mags = np.abs(msgs)
    out = np.zeros_like(msgs)
    idx = np.arange(msgs.size)
    for i in range(msgs.size):
        sign_prod = np.prod(signs[idx != i])
        mn = np.min(mags[idx != i])
        if offset:
            mn = max(mn - offset, 0.0)
        out[i] = sign_prod * mn * normalization
    return out


def _decode_iterative(H, llr, max_iter, early_stop, check_update):
    llr = np.asarray(llr, np.float64)
    H = np.asarray(H)
    m, n = H.shape
    var_nb, check_nb = _tanner(H)
    # v2c[v][j]: message from var v to its j-th neighbor check
    v2c = [np.full(len(var_nb[v]), llr[v]) for v in range(n)]
    c2v = [np.zeros(len(check_nb[c])) for c in range(m)]
    var_slot_of_check = [
        {int(c): j for j, c in enumerate(var_nb[v])} for v in range(n)
    ]
    check_slot_of_var = [
        {int(v): j for j, v in enumerate(check_nb[c])} for c in range(m)
    ]
    decoded = (llr <= 0).astype(np.int64)
    actual_iterations = max_iter
    for iteration in range(max_iter):
        for c in range(m):
            incoming = np.array([v2c[v][var_slot_of_check[v][c]] for v in check_nb[c]])
            c2v[c] = check_update(incoming)
        totals = np.zeros(n)
        for v in range(n):
            incoming = np.array([c2v[c][check_slot_of_var[c][v]] for c in var_nb[v]])
            total = llr[v] + incoming.sum()
            totals[v] = total
            v2c[v] = total - incoming
        decoded = (totals <= 0).astype(np.int64)
        if early_stop and np.all((H @ decoded) % 2 == 0):
            actual_iterations = iteration + 1
            break
    return decoded, actual_iterations


def bp_decode_np(H, llr, max_iter: int = 50, early_stop: bool = True):
    """Sum-product decode of one frame → (bits [n], iterations)."""
    return _decode_iterative(H, llr, max_iter, early_stop, _check_update_bp)


def ms_decode_np(H, llr, max_iter: int = 50, normalization: float = 1.0,
                 offset: float = 0.0, early_stop: bool = True):
    """Min-sum decode of one frame → (bits [n], iterations)."""
    return _decode_iterative(
        H, llr, max_iter, early_stop,
        lambda msgs: _check_update_ms(msgs, normalization, offset),
    )


def ldpc_encode_np(G_kn: np.ndarray, message: np.ndarray) -> np.ndarray:
    """Systematic encode c = m·G mod 2 (reference ``encoder.py:88-90``)."""
    return (np.asarray(message) @ np.asarray(G_kn)) % 2


def layered_ms_decode_np(H, llr, max_iter: int = 50,
                         normalization: float = 1.0, offset: float = 0.0,
                         early_stop: bool = True, num_layers: int = 4):
    """Row-layered (block-serial) min-sum decode of one frame → (bits [n],
    iterations).

    Semantics DEFINED here (gap-fill feature, no reference counterpart —
    the reference only floods, ``src/ldpc/decoder.py:150-198``); the
    layered decoders (``models/ldpc/layered.py``, the layered CUDA kernel and
    the QC roll path) mirror this float program exactly:

    * checks are partitioned into ``num_layers`` contiguous groups
      (``np.array_split`` bounds); groups update sequentially within one
      iteration, each from the LATEST variable totals;
    * per layer, all its checks update in parallel from the same totals
      snapshot (block-layered): ``qtemp = Q[v] − R_old`` per edge, min-sum
      leave-one-out (same α/β/sign(0)=0/degree-1→0 rules as flooding);
    * totals update by delta accumulation in VAR-SLOT order: for sp = 0..
      dv_max−1, ``Q += Δ_vm[:, sp]`` (each (v, sp) receives from exactly
      one edge, so the order is fully deterministic and the device
      one-hot-matmul form reproduces it bit-for-bit);
    * hard decision / syndrome early stop / first-converged latching per
      iteration exactly as flooding.
    """
    H = np.asarray(H)
    llr = np.asarray(llr, np.float64)
    m, n = H.shape
    var_nb, check_nb = _tanner(H)
    dv_max = max(1, max(len(x) for x in var_nb))
    slot_in_var = {(int(c), v): sp for v in range(n)
                   for sp, c in enumerate(var_nb[v])}
    layers = [lay for lay in np.array_split(np.arange(m), num_layers)
              if len(lay)]
    R = [np.zeros(len(check_nb[c])) for c in range(m)]
    Q = llr.copy()
    decoded = (llr <= 0).astype(np.int64)
    iters = max_iter
    for it in range(max_iter):
        for layer in layers:
            new_r = {}
            for c in layer:
                qtemp = np.array([Q[v] - R[c][j]
                                  for j, v in enumerate(check_nb[c])])
                new_r[c] = _check_update_ms(qtemp, normalization, offset)
            delta_sp = np.zeros((dv_max, n))
            for c in layer:
                for j, v in enumerate(check_nb[c]):
                    delta_sp[slot_in_var[(int(c), int(v))], v] = (
                        new_r[c][j] - R[c][j])
                R[c] = new_r[c]
            for sp in range(dv_max):
                Q = Q + delta_sp[sp]
        decoded = (Q <= 0).astype(np.int64)
        if early_stop and np.all((H @ decoded) % 2 == 0):
            iters = it + 1
            break
    return decoded, iters
