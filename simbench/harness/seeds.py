"""Independent random streams derived from one ``--seed``.

Any whole number is a seed (the driver's exceed 32 bits; a negative one
is taken modulo 2**64).  ``stream(seed, k)`` names the k-th stream, so
each use of randomness (inputs, order, samples) draws from its own.
"""
from __future__ import annotations

import numpy as np
import torch

_MASK = (1 << 64) - 1


def rng(seed: int, stream: int) -> np.random.Generator:
    return np.random.default_rng([seed & _MASK, stream])


def torch_generator(seed: int, stream: int, device) -> torch.Generator:
    """A generator on ``device`` seeded from (seed, stream)."""
    state = np.random.SeedSequence([seed & _MASK, stream]).generate_state(
        1, np.uint64)[0]
    return torch.Generator(device=device).manual_seed(int(state) >> 1)
