"""Results persistence and plots.

``save_results`` writes JSON everywhere.  The plots need matplotlib, which is
imported only when a plot is drawn (Agg backend, no display); without it they
raise ``ImportError``.
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Dict, Optional, Sequence

import numpy as np


def _to_native(obj):
    """Recursively convert numpy / torch scalars and arrays for JSON."""
    if isinstance(obj, dict):
        return {str(k): _to_native(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [_to_native(v) for v in obj]
    if isinstance(obj, np.integer):
        return int(obj)
    if isinstance(obj, np.floating):
        return float(obj)
    if hasattr(obj, "tolist") and not isinstance(obj, (str, bytes, int, float, bool)):
        return _to_native(obj.tolist())  # numpy arrays and bools, torch tensors
    return obj


def save_results(results: dict, filepath: str | Path) -> None:
    """Dump results as JSON, creating parent directories."""
    path = Path(filepath)
    path.parent.mkdir(parents=True, exist_ok=True)
    with open(path, "w") as f:
        json.dump(_to_native(results), f, indent=2)


def _get_pyplot():
    try:
        import matplotlib
    except ImportError as e:
        raise ImportError("the plots need matplotlib, which is not installed "
                          "(the CLIs take --skip-plots)") from e
    matplotlib.use("Agg", force=False)
    import matplotlib.pyplot as plt

    return plt


def plot_ber_curves(
    snr_points: Sequence[float],
    curves: Dict[str, Sequence[float]],
    title: str = "BER vs SNR",
    ylabel: str = "BER",
    filepath: Optional[str | Path] = None,
    floor: float = 1e-7,
):
    """Semilogy BER/FER curves; zero values are floored at ``floor`` so they
    show on the log axis."""
    plt = _get_pyplot()
    fig, ax = plt.subplots(figsize=(9, 6))
    markers = "os^dvP*X"
    for i, (label, ys) in enumerate(curves.items()):
        ys = np.maximum(np.asarray(ys, float), floor)
        ax.semilogy(snr_points, ys, marker=markers[i % len(markers)], label=label)
    ax.set_xlabel("SNR (dB)")
    ax.set_ylabel(ylabel)
    ax.set_title(title)
    ax.grid(True, which="both", alpha=0.3)
    ax.legend()
    fig.tight_layout()
    if filepath is not None:
        Path(filepath).parent.mkdir(parents=True, exist_ok=True)
        fig.savefig(filepath, dpi=300)
        plt.close(fig)
        return None
    return fig


def plot_comparison(
    categories: Sequence[str],
    groups: Dict[str, Sequence[float]],
    title: str = "Comparison",
    ylabel: str = "Value",
    filepath: Optional[str | Path] = None,
    log_scale: bool = False,
):
    """Grouped bar chart."""
    plt = _get_pyplot()
    fig, ax = plt.subplots(figsize=(9, 6))
    x = np.arange(len(categories))
    width = 0.8 / max(1, len(groups))
    for i, (label, vals) in enumerate(groups.items()):
        ax.bar(x + i * width, vals, width, label=label)
    ax.set_xticks(x + width * (len(groups) - 1) / 2)
    ax.set_xticklabels(categories)
    ax.set_ylabel(ylabel)
    ax.set_title(title)
    if log_scale:
        ax.set_yscale("log")
    ax.grid(True, axis="y", alpha=0.3)
    ax.legend()
    fig.tight_layout()
    if filepath is not None:
        Path(filepath).parent.mkdir(parents=True, exist_ok=True)
        fig.savefig(filepath, dpi=300)
        plt.close(fig)
        return None
    return fig
