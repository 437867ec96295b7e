from .bp import BPDecoder, bp_check_update, make_bp_decoder
from .encoder import LDPCEncoder, gf2_solve
from .graph import TannerGraph, tanner_tables_from_H
from .matrix import (check_matrix_rank, create_systematic_generator,
                     encodable_form, generate_ldpc_matrix, gf2_rank,
                     mackay_construction, regular_construction)
from .minsum import (MSDecoder, NMSDecoder, OMSDecoder, make_ms_decoder,
                     ms_check_update)

__all__ = [
    "BPDecoder", "bp_check_update", "make_bp_decoder", "LDPCEncoder",
    "gf2_solve", "TannerGraph", "tanner_tables_from_H", "check_matrix_rank",
    "create_systematic_generator", "encodable_form", "generate_ldpc_matrix",
    "gf2_rank", "mackay_construction", "regular_construction", "MSDecoder",
    "NMSDecoder", "OMSDecoder", "make_ms_decoder", "ms_check_update",
]
