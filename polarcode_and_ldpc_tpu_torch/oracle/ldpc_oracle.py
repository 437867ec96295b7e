"""``pyldpc`` oracle wrapper: make_ldpc / encode / decode through the
third-party library.

The reference's decode path rebuilds channel symbols from LLRs with an
SNR estimate ``snr_lin ≈ mean|LLR| / 4`` before calling ``pyldpc.decode``;
it is kept here so that a differential test sees the reference's numbers.
"""

from __future__ import annotations

import numpy as np

try:
    import pyldpc

    PYLDPC_AVAILABLE = True
except ImportError:
    PYLDPC_AVAILABLE = False


class LDPCLibWrapper:
    """make_ldpc / encode / decode one frame at a time via ``pyldpc``."""

    def __init__(self, n: int, dv: int = 3, dc: int = 6, seed: int = 42):
        if not PYLDPC_AVAILABLE:
            raise ImportError(
                "pyldpc is not installed; use the built-in constructions "
                "(models.ldpc.matrix)")
        self.n = n
        self.H, self.G = pyldpc.make_ldpc(n, dv, dc, systematic=True, seed=seed)
        # pyldpc may shrink k
        self.k_actual = self.G.shape[1]

    def encode(self, message: np.ndarray, snr_db: float = 20.0) -> np.ndarray:
        """Binary codeword from pyldpc's BPSK output."""
        x = pyldpc.encode(self.G, np.asarray(message, np.int64), snr=snr_db)
        return (x < 0).astype(np.int64)  # pyldpc maps bit b → (−1)^b

    def decode(self, llr: np.ndarray, max_iter: int = 50) -> np.ndarray:
        """Decode LLRs through the reference's symbol reconstruction."""
        llr = np.asarray(llr, np.float64)
        snr_lin = max(float(np.mean(np.abs(llr))) / 4.0, 1e-6)
        snr_db = 10.0 * np.log10(snr_lin)
        sigma2 = 1.0 / (2.0 * snr_lin)
        y = llr * sigma2 / 2.0  # invert LLR = 2y/σ²
        d = pyldpc.decode(self.H, y, snr=snr_db, maxiter=max_iter)
        return np.asarray(pyldpc.get_message(self.G, d), dtype=np.int64)


def simulate_ldpc_oracle(cfg, sim) -> dict:
    """Per-SNR Monte-Carlo through pyldpc: sequential NumPy on the host."""
    from ..parity.channel_np import awgn_llr_np

    lib = LDPCLibWrapper(cfg.n, cfg.dv, cfg.dc, seed=cfg.seed or 42)
    k = lib.k_actual
    rng = np.random.default_rng(sim.seed)
    out = {"snr_db": [], "ber": [], "fer": [], "frames_tested": [], "k": k}
    for snr_db in sim.snr_points():
        bit_errors = frame_errors = frames = 0
        for _ in range(sim.num_frames):
            msg = rng.integers(0, 2, k)
            cw = lib.encode(msg)
            llr = awgn_llr_np(cw, snr_db, rng.standard_normal(cfg.n))
            dec = lib.decode(llr, max_iter=cfg.max_iterations)
            errs = int(np.sum(dec != msg))
            bit_errors += errs
            frame_errors += errs > 0
            frames += 1
            if sim.max_errors and frame_errors >= sim.max_errors:
                break
        out["snr_db"].append(snr_db)
        out["ber"].append(bit_errors / (frames * k))
        out["fer"].append(frame_errors / frames)
        out["frames_tested"].append(frames)
    return out
