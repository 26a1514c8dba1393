"""Reproducible seeding (port of ``speechbrain_tpu/utils/seed.py``):
Python's ``random``, numpy's global generator and torch's generators of
every device.

Example
-------
>>> g = seed_everything(1234)
>>> g.initial_seed()
1234
"""

import logging
import os
import random

import numpy as np
import torch

logger = logging.getLogger(__name__)

max_seed_value = np.iinfo(np.uint32).max
min_seed_value = np.iinfo(np.uint32).min


def seed_everything(seed: int = 0, verbose: bool = True):
    """Seed Python, numpy and torch (the CPU and every CUDA device).
    Out-of-range seeds become 0. Returns torch's default CPU
    ``torch.Generator``.
    """
    if not min_seed_value <= seed <= max_seed_value:
        if verbose:
            logger.info("%d is out of bounds, numpy accepts from %d to %d",
                        seed, min_seed_value, max_seed_value)
        seed = 0
    if verbose:
        logger.info("Setting seed to %d", seed)
    os.environ["SB_GLOBAL_SEED"] = str(seed)
    random.seed(seed)
    np.random.seed(seed)
    return torch.manual_seed(seed)
