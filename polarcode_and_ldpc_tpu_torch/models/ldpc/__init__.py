from .bp import BPDecoder, bp_check_update, make_bp_decoder
from .encoder import LDPCEncoder, gf2_solve
from .graph import TannerGraph, tanner_tables_from_H
from .layered import LayeredMSDecoder, layer_bounds, make_layered_ms_decoder
from .matrix import (calculate_girth, check_matrix_rank, create_systematic_generator,
                     encodable_form, generate_ldpc_matrix, gf2_rank,
                     mackay_construction, peg_construction, qc_base_matrix, qc_expand,
                     qc_ldpc_construction, regular_construction)
from .minsum import (MSDecoder, NMSDecoder, OMSDecoder, make_ms_decoder,
                     ms_check_update)
from .qc import QCBPDecoder, make_qc_bp_decoder
from .utils import (calculate_syndrome, check_syndrome, count_errors, create_tanner_graph,
                    hamming_distance)

__all__ = [
    "BPDecoder", "bp_check_update", "make_bp_decoder", "LDPCEncoder",
    "gf2_solve", "TannerGraph", "tanner_tables_from_H", "check_matrix_rank",
    "create_systematic_generator", "encodable_form", "generate_ldpc_matrix",
    "gf2_rank", "mackay_construction", "regular_construction", "MSDecoder",
    "NMSDecoder", "OMSDecoder", "make_ms_decoder", "ms_check_update",
    "LayeredMSDecoder", "layer_bounds", "make_layered_ms_decoder",
    "qc_base_matrix", "qc_expand", "qc_ldpc_construction", "QCBPDecoder",
    "make_qc_bp_decoder", "peg_construction", "calculate_girth", "create_tanner_graph",
    "check_syndrome", "calculate_syndrome", "count_errors", "hamming_distance",
]
