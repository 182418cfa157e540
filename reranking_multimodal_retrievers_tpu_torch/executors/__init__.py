from .base import BaseExecutor
from .flmr_executor import FLMRExecutor
from .reranker_executor import RerankerExecutor, fusion_inputs, interaction_inputs

__all__ = ["BaseExecutor", "FLMRExecutor", "RerankerExecutor", "fusion_inputs",
           "interaction_inputs"]
