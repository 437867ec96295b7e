from .complexity import analyze_complexity, decode_roofline, ldpc_complexity, polar_complexity
from .metrics import (ber_fer_counts, calculate_ber, calculate_fer, calculate_throughput,
                      ebn0_to_snr, snr_to_ebn0, wilson_confidence_interval)
from .tracing import DecodeRateCounter, Timer, profile_trace, timed_span, trace_sc_trellis
from .visualization import plot_ber_curves, plot_comparison, save_results

__all__ = ["calculate_ber", "calculate_fer", "calculate_throughput",
           "wilson_confidence_interval", "snr_to_ebn0", "ebn0_to_snr", "ber_fer_counts",
           "polar_complexity", "ldpc_complexity", "analyze_complexity", "decode_roofline",
           "plot_ber_curves", "plot_comparison", "save_results", "Timer", "timed_span",
           "profile_trace", "DecodeRateCounter", "trace_sc_trellis"]
