from .maxsim import MASK_FILL_VALUE, colbert_score, colbert_score_reduce
from .maxsim_cuda import maxsim_scores, maxsim_scores_reference
from .attention_cuda import fused_self_attention, fused_self_attention_reference
from .topk import tiled_top_k, top_k_scores

__all__ = [
    "MASK_FILL_VALUE",
    "colbert_score",
    "colbert_score_reduce",
    "maxsim_scores",
    "maxsim_scores_reference",
    "fused_self_attention",
    "fused_self_attention_reference",
    "tiled_top_k",
    "top_k_scores",
]
