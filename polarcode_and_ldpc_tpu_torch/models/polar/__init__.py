from .construction import (bhattacharyya_bounds, bit_reverse_permutation,
                           construct_polar_code, dega_llr_means,
                           frozen_mask_from_positions, gaussian_approximation,
                           generate_frozen_bits)
from .encoder import PolarEncoder, polar_transform
from .fastsc import make_sc_decoder_unrolled
from .sc import SCDecoder, make_sc_decoder
from .trellis import f_minsum, g_update

__all__ = [
    "bhattacharyya_bounds", "bit_reverse_permutation", "construct_polar_code",
    "dega_llr_means", "frozen_mask_from_positions", "gaussian_approximation",
    "generate_frozen_bits", "PolarEncoder", "polar_transform",
    "make_sc_decoder_unrolled", "SCDecoder", "make_sc_decoder", "f_minsum",
    "g_update",
]
