from .cross_encoder import CrossEncoder
from .decoder import (Blip2DecoderHeadRerankModel, Blip2DecoderRerankModel, Blip2RerankConfig,
                      DecoderHeadRerankModel, DecoderRerankConfig, DecoderRerankModel,
                      DecoderRerankOutput, prepare_decoder_rerank_inputs)
from .rerank_model import FullContextRerankModel, RerankConfig, RerankOutput

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
    "RerankConfig",
    "RerankOutput",
    "prepare_decoder_rerank_inputs",
]
