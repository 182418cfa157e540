from .server import MicroBatcher, RerankService, RetrievalService

__all__ = ["MicroBatcher", "RerankService", "RetrievalService"]
