from .cross_encoder import CrossEncoder
from .rerank_model import FullContextRerankModel, RerankConfig, RerankOutput

__all__ = ["CrossEncoder", "FullContextRerankModel", "RerankConfig", "RerankOutput"]
