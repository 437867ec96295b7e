from .device import resolve_device
from .rng import (bernoulli_half, fold_in, frame_keys, key_words, normal,
                  prng_key, random_bits32, split, threefry2x32)

__all__ = ["resolve_device", "bernoulli_half", "fold_in", "frame_keys",
           "key_words", "normal", "prng_key", "random_bits32", "split",
           "threefry2x32"]
