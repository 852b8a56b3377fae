"""Seeding (counterpart of sparse_videogen_tpu/utils/seed.py): Python's
random, numpy's global generator and torch's (every device). The port's
paths draw from explicit generators; this seeds what is left."""

import random

import numpy as np


def seed_everything(seed: int):
    random.seed(seed)
    np.random.seed(seed)
    import torch

    torch.manual_seed(seed)
    return seed
