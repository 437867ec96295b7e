from .config import (ChannelConfig, LDPCCodeConfig, PolarCodeConfig, SimulationConfig,
                     load_yaml_config)
from .device import resolve_device
from .rng import (bernoulli, bernoulli_half, fold_in, frame_keys, key_words, normal,
                  prng_key, random_bits32, split, split_key, threefry2x32)

__all__ = ["PolarCodeConfig", "LDPCCodeConfig", "ChannelConfig", "SimulationConfig",
           "load_yaml_config", "resolve_device", "bernoulli", "bernoulli_half", "fold_in",
           "frame_keys", "key_words", "normal", "prng_key", "random_bits32", "split",
           "split_key", "threefry2x32"]
