from .bert import BertConfig, BertEncoder, BertModel
from .flmr import FLMRConfig, FLMRContextOutput, FLMRModelForRetrieval, FLMRQueryOutput
from .vit import CLIPVisionConfig, CLIPVisionModel

__all__ = [
    "BertConfig",
    "BertEncoder",
    "BertModel",
    "CLIPVisionConfig",
    "CLIPVisionModel",
    "FLMRConfig",
    "FLMRContextOutput",
    "FLMRModelForRetrieval",
    "FLMRQueryOutput",
]
