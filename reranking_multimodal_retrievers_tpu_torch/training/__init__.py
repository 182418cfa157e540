from .optimization import label_params, make_optimizer, make_schedule
from .train_state import TrainState, make_rerank_train_step, make_train_step

__all__ = [
    "make_optimizer",
    "make_schedule",
    "label_params",
    "TrainState",
    "make_train_step",
    "make_rerank_train_step",
]
