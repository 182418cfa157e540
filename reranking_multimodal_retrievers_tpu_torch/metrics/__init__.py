from .processors import MetricsProcessor
from .eval_recorder import EvalRecorder

__all__ = ["MetricsProcessor", "EvalRecorder"]
