"""Deterministic seeding (reference `runway_for_ml/utils/seed.py`).

Seeds the host-side randomness (python, numpy) used by samplers and data
ops, and torch's global generators; model weights are drawn from the
explicit ``torch.Generator`` this returns, so that they do not depend on
what else drew from the global one.
"""

import random

import numpy as np
import torch


def set_seed(seed: int) -> torch.Generator:
    """Seed python, numpy and torch with ``seed``; return a CPU
    ``torch.Generator`` seeded with it."""
    random.seed(seed)
    np.random.seed(seed)
    torch.manual_seed(seed)
    return torch.Generator().manual_seed(seed)
