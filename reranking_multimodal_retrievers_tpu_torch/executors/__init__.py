from .reranker_executor import fusion_inputs, interaction_inputs

__all__ = ["fusion_inputs", "interaction_inputs"]
