"""Determinism plumbing: seed the host RNGs and hand out a generator."""

from __future__ import annotations

import random

import numpy as np
import torch


def set_seed(seed: int = 42) -> torch.Generator:
    """Seed ``random``, numpy and torch's default generators, and return a
    CPU ``torch.Generator`` seeded the same, for explicit random init."""
    random.seed(seed)
    np.random.seed(seed)
    torch.manual_seed(seed)
    return torch.Generator().manual_seed(seed)
