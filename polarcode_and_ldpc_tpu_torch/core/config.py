"""Configuration dataclasses of the Monte-Carlo studies and their CLIs.

The same four dataclasses as the JAX package's ``core/config.py``, with the
same fields and defaults except the implementation choices, which are this
package's own: ``None`` picks the device default (the CUDA kernels on a CUDA
device, the plain PyTorch versions on the CPU), and every choice computes the
same outputs.  ``convert.config_from_jax`` carries a JAX config across.

YAML files give defaults and CLI flags override them; ``load_yaml_config``
needs PyYAML, which it imports only when called.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from pathlib import Path
from typing import Optional


@dataclass
class PolarCodeConfig:
    """Polar code parameters."""

    N: int = 1024
    K: int = 512
    use_crc: bool = False
    crc_polynomial: str = "CRC-8"
    # bhattacharyya | gaussian_approximation | dega | monte_carlo | default
    construction: str = "bhattacharyya"
    design_snr_db: float = 2.0
    # decoding
    algorithm: str = "sc"  # sc | scl | ca_scl
    list_size: int = 8
    # implementation choices of the chunked list decoder (identical outputs):
    # None = the device default; body torch | cuda; control split | fused |
    # kernel | unroll-fused | unroll-kernel | mega
    scl_body_impl: Optional[str] = None
    scl_chunk: int = 128
    scl_control_impl: Optional[str] = None
    # "fast" = the SSCL fast list nodes: APPROXIMATE (error rates match exact
    # SCL statistically, outputs are not those of exact SCL)
    scl_node_mode: str = "exact"  # exact | fast

    def __post_init__(self):
        if not (self.N > 0 and (self.N & (self.N - 1)) == 0):
            raise ValueError(f"N must be a power of 2, got {self.N}")
        if not 0 < self.K < self.N:
            raise ValueError(f"K must be in (0, N), got K={self.K}, N={self.N}")

    @property
    def rate(self) -> float:
        return self.K / self.N


@dataclass
class LDPCCodeConfig:
    """LDPC code parameters."""

    n: int = 504
    k: int = 252
    dv: int = 3
    dc: int = 6
    construction: str = "regular"  # regular | mackay | peg | gallager | random | qc
    seed: Optional[int] = 42
    # decoding
    algorithm: str = "bp"  # bp | min_sum | nms | oms
    max_iterations: int = 20
    early_stop: bool = True
    normalization: float = 0.75
    offset: float = 0.5
    # None = the device default (the fused kernel on a CUDA device); torch | cuda
    bp_impl: Optional[str] = None

    def __post_init__(self):
        if not self.n > self.k > 0:
            raise ValueError(f"need n > k > 0, got n={self.n}, k={self.k}")

    @property
    def rate(self) -> float:
        return self.k / self.n


@dataclass
class ChannelConfig:
    kind: str = "awgn"  # awgn | bsc | rayleigh | rician
    snr_db: float = 3.0
    crossover_prob: float = 0.1  # BSC only
    k_factor: float = 1.0  # Rician only


@dataclass
class SimulationConfig:
    """Monte-Carlo sweep parameters."""

    snr_start: float = -2.0
    snr_stop: float = 6.0
    snr_step: float = 0.5
    num_frames: int = 1000
    max_errors: int = 100
    batch_size: int = 256  # frames per device chunk
    chunks_per_dispatch: int = 1  # device chunks per host synchronisation
    seed: int = 42
    output_dir: str = "results"

    def snr_points(self) -> list[float]:
        pts = []
        snr = self.snr_start
        # inclusive endpoint, matching np.arange(start, stop + step/2, step)
        while snr <= self.snr_stop + 1e-9:
            pts.append(round(snr, 6))
            snr += self.snr_step
        return pts

    @classmethod
    def from_range_string(cls, spec: str, **kw) -> "SimulationConfig":
        """Parse ``start:stop:step``."""
        start, stop, step = (float(x) for x in spec.split(":"))
        return cls(snr_start=start, snr_stop=stop, snr_step=step, **kw)


def _coerce_fields(cls, raw: dict) -> dict:
    names = {f.name for f in dataclasses.fields(cls)}
    return {k: v for k, v in raw.items() if k in names}


def load_yaml_config(path: str | Path, cls=None):
    """Load a YAML file; optionally coerce it into a config dataclass.

    Accepts a flat schema and a nested one (``code_params`` / ``decoding`` /
    ``construction`` sections), with the names ``L`` for ``list_size`` and
    ``method`` for ``construction``."""
    try:
        import yaml
    except ImportError as e:
        raise ImportError("load_yaml_config needs PyYAML (the 'yaml' module), which is not "
                          "installed; build the config dataclasses directly instead") from e

    with open(path) as f:
        raw = yaml.safe_load(f) or {}
    if cls is None:
        return raw
    flat: dict = {}
    for key, val in raw.items():
        if isinstance(val, dict):
            flat.update(val)
        else:
            flat[key] = val
    if "list_size" not in flat and "L" in flat:
        flat["list_size"] = flat["L"]
    if "construction" not in flat and "method" in flat:
        flat["construction"] = flat["method"]
    return cls(**_coerce_fields(cls, flat))
