from .cross_encoder import CrossEncoder, fusion_attention_adj
from .decoder import (Blip2DecoderHeadRerankModel, Blip2DecoderRerankModel, Blip2RerankConfig,
                      DecoderHeadRerankModel, DecoderRerankConfig, DecoderRerankModel,
                      DecoderRerankOutput, prepare_decoder_rerank_inputs)
from .interaction import (LATE_INTERACTION_EMBEDDING_SIZE, InteractionRerankConfig,
                          InteractionRerankModel, MORESLayer, MORESSym)
from .rerank_model import FullContextRerankModel, RerankConfig, RerankModel, RerankOutput

__all__ = [
    "Blip2DecoderHeadRerankModel",
    "Blip2DecoderRerankModel",
    "Blip2RerankConfig",
    "CrossEncoder",
    "DecoderHeadRerankModel",
    "DecoderRerankConfig",
    "DecoderRerankModel",
    "DecoderRerankOutput",
    "FullContextRerankModel",
    "InteractionRerankConfig",
    "InteractionRerankModel",
    "LATE_INTERACTION_EMBEDDING_SIZE",
    "MORESLayer",
    "MORESSym",
    "RerankConfig",
    "RerankModel",
    "RerankOutput",
    "fusion_attention_adj",
    "prepare_decoder_rerank_inputs",
]
