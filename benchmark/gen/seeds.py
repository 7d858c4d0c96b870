"""One numpy Generator per (seed, purpose, index): the same seed gives the
same inputs, whatever else the run draws."""

import numpy as np

PURPOSES = {"nodes": 1, "pods": 2}


def rng(seed: int, purpose: str, index: int = 0) -> np.random.Generator:
    """Seeds may be any whole number, negative or past 64 bits."""
    return np.random.default_rng(
        [int(seed) % (1 << 64), PURPOSES[purpose], int(index)])
