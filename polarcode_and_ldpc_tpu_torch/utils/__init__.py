from .metrics import (calculate_ber, calculate_fer, calculate_throughput,
                      wilson_confidence_interval)
from .visualization import plot_ber_curves, plot_comparison, save_results

__all__ = ["calculate_ber", "calculate_fer", "calculate_throughput",
           "wilson_confidence_interval", "plot_ber_curves", "plot_comparison", "save_results"]
