from .experiments import (analyze_snr_requirements, run_ber_simulation, simulate_ldpc,
                          simulate_polar, test_code_lengths, test_multiple_rates)
from .montecarlo import ChunkStats, MonteCarloResult, MonteCarloSimulator
from .pipelines import (make_channel_fn, make_ldpc_pipeline,
                        make_montecarlo_step, make_polar_pipeline, reduce_step)
from .scaling import measure_scaling
from .sweep import run_snr_sweep
from .throughput import measure_ldpc_throughput, measure_polar_throughput, run_throughput_test

__all__ = ["ChunkStats", "MonteCarloResult", "MonteCarloSimulator",
           "make_channel_fn", "make_ldpc_pipeline", "make_montecarlo_step",
           "make_polar_pipeline", "reduce_step", "run_snr_sweep", "run_ber_simulation",
           "simulate_polar", "simulate_ldpc", "test_multiple_rates", "test_code_lengths",
           "analyze_snr_requirements", "measure_polar_throughput", "measure_ldpc_throughput",
           "run_throughput_test", "measure_scaling"]
