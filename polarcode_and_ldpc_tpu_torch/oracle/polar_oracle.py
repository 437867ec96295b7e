"""``polarcodes`` oracle wrapper: encode / decode / frozen-set construction
through the third-party library.  Host-only by nature; it overlays curves
and serves differential tests, never the main path.
"""

from __future__ import annotations

import numpy as np

try:
    from polarcodes import Construct, Decode, Encode, PolarCode

    POLARCODES_AVAILABLE = True
except ImportError:
    POLARCODES_AVAILABLE = False


class PolarLibWrapper:
    """Construct / encode / decode one frame at a time via ``polarcodes``."""

    def __init__(self, N: int, K: int, design_snr_db: float = 2.0):
        if not POLARCODES_AVAILABLE:
            raise ImportError(
                "polarcodes is not installed; install py-polar-codes or use "
                "the built-in construction (models.polar.construction)")
        self.N = N
        self.K = K
        self.design_snr_db = design_snr_db
        self.pc = PolarCode(int(np.log2(N)), K)
        Construct(self.pc, design_snr_db)

    def get_frozen_positions(self) -> np.ndarray:
        """The library's frozen set, sorted."""
        return np.sort(np.asarray(self.pc.frozen, dtype=np.int64))

    def encode(self, message: np.ndarray) -> np.ndarray:
        """Encode one frame."""
        self.pc.set_message(np.asarray(message, dtype=np.int64))
        Encode(self.pc)
        return np.asarray(self.pc.get_codeword(), dtype=np.int64)

    def decode(self, llr: np.ndarray, decoder_name: str = "scd") -> np.ndarray:
        """Decode one frame of LLRs."""
        self.pc.likelihoods = np.asarray(llr, dtype=np.float64)
        Decode(self.pc, decoder_name)
        return np.asarray(self.pc.message_received, dtype=np.int64)


def simulate_polar_oracle(cfg, sim) -> dict:
    """Per-SNR Monte-Carlo through the library: sequential NumPy on the host,
    an oracle and not a benchmark."""
    from ..parity.channel_np import awgn_llr_np

    lib = PolarLibWrapper(cfg.N, cfg.K, cfg.design_snr_db)
    rng = np.random.default_rng(sim.seed)
    out = {"snr_db": [], "ber": [], "fer": [], "frames_tested": []}
    for snr_db in sim.snr_points():
        bit_errors = frame_errors = frames = 0
        for _ in range(sim.num_frames):
            msg = rng.integers(0, 2, cfg.K)
            cw = lib.encode(msg)
            llr = awgn_llr_np(cw, snr_db, rng.standard_normal(cfg.N))
            dec = lib.decode(llr)
            errs = int(np.sum(dec != msg))
            bit_errors += errs
            frame_errors += errs > 0
            frames += 1
            if sim.max_errors and frame_errors >= sim.max_errors:
                break
        out["snr_db"].append(snr_db)
        out["ber"].append(bit_errors / (frames * cfg.K))
        out["fer"].append(frame_errors / frames)
        out["frames_tested"].append(frames)
    return out
