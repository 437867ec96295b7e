from .montecarlo import ChunkStats, MonteCarloResult, MonteCarloSimulator
from .pipelines import (make_channel_fn, make_ldpc_pipeline,
                        make_montecarlo_step, make_polar_pipeline, reduce_step)

__all__ = ["ChunkStats", "MonteCarloResult", "MonteCarloSimulator",
           "make_channel_fn", "make_ldpc_pipeline", "make_montecarlo_step",
           "make_polar_pipeline", "reduce_step"]
