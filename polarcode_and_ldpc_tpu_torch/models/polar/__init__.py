from .adaptive import AdaptiveCASCLDecoder
from .construction import (bhattacharyya_bounds, bit_reverse, bit_reverse_array,
                           bit_reverse_permutation, calculate_channel_capacities,
                           construct_polar_code, dega_llr_means,
                           frozen_mask_from_positions, gaussian_approximation,
                           generate_frozen_bits, genie_leaf_llrs,
                           monte_carlo_reliabilities)
from .crc import CRC_POLYNOMIALS, CRCCodec, crc_check, crc_encode
from .encoder import PolarEncoder, polar_transform
from .fastsc import make_sc_decoder_unrolled
from .sc import SCDecoder, make_sc_decoder
from .scanscl import make_scl_decoder_scan
from .scl import CASCLDecoder, SCLDecoder, make_scl_decoder, select_best_path
from .trellis import f_minsum, g_update

__all__ = [
    "bhattacharyya_bounds", "bit_reverse_permutation", "construct_polar_code",
    "dega_llr_means", "frozen_mask_from_positions", "gaussian_approximation",
    "generate_frozen_bits", "PolarEncoder", "polar_transform",
    "make_sc_decoder_unrolled", "SCDecoder", "make_sc_decoder", "f_minsum",
    "g_update", "CRCCodec", "crc_check", "crc_encode", "make_scl_decoder_scan",
    "CASCLDecoder", "SCLDecoder", "make_scl_decoder", "select_best_path",
    "AdaptiveCASCLDecoder", "bit_reverse", "bit_reverse_array",
    "calculate_channel_capacities", "genie_leaf_llrs", "monte_carlo_reliabilities",
    "CRC_POLYNOMIALS",
]
