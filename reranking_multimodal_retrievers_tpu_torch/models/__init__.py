from .bert import BertConfig, BertEncoder, BertModel
from .blip2 import (Blip2Config, Blip2ForConditionalGeneration, Blip2QFormerConfig,
                    Blip2VisionConfig)
from .flmr import FLMRConfig, FLMRContextOutput, FLMRModelForRetrieval, FLMRQueryOutput
from .lora import LoRALinear
from .opt import OPTConfig, OPTForCausalLM
from .t5 import T5Config, T5ForConditionalGeneration
from .vit import CLIPVisionConfig, CLIPVisionModel

__all__ = [
    "BertConfig",
    "BertEncoder",
    "BertModel",
    "Blip2Config",
    "Blip2ForConditionalGeneration",
    "Blip2QFormerConfig",
    "Blip2VisionConfig",
    "CLIPVisionConfig",
    "CLIPVisionModel",
    "FLMRConfig",
    "FLMRContextOutput",
    "FLMRModelForRetrieval",
    "FLMRQueryOutput",
    "LoRALinear",
    "OPTConfig",
    "OPTForCausalLM",
    "T5Config",
    "T5ForConditionalGeneration",
]
