from .maxsim import MASK_FILL_VALUE, colbert_score, colbert_score_reduce
from .maxsim_cuda import maxsim_scores, maxsim_scores_reference
from .maxsim_int8_cuda import maxsim_scores_int8, maxsim_scores_int8_reference
from .attention_cuda import fused_self_attention, fused_self_attention_reference
from .quant import Int8Linear, int8_dot, quantize_cols, quantize_rows
from .topk import tiled_top_k, top_k_scores

__all__ = [
    "MASK_FILL_VALUE",
    "colbert_score",
    "colbert_score_reduce",
    "maxsim_scores",
    "maxsim_scores_reference",
    "maxsim_scores_int8",
    "maxsim_scores_int8_reference",
    "fused_self_attention",
    "fused_self_attention_reference",
    "Int8Linear",
    "int8_dot",
    "quantize_cols",
    "quantize_rows",
    "tiled_top_k",
    "top_k_scores",
]
