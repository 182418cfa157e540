from .base import BaseExecutor
from .flmr_executor import FLMRExecutor
from .rag_executor import RagExecutor, greedy_decode_with_nll
from .reranker_executor import RerankerExecutor, fusion_inputs, interaction_inputs

__all__ = ["BaseExecutor", "FLMRExecutor", "RagExecutor", "RerankerExecutor", "fusion_inputs",
           "greedy_decode_with_nll", "interaction_inputs"]
