"""Seeds derived from the run's --seed: any non-negative whole number,
past 2**31 too, gives 63-bit seeds for each purpose."""
from __future__ import annotations

import numpy as np

PURPOSES = ("weights", "data", "jobs", "dropout", "trainer", "rows", "offset", "check")


def derive(seed: int, purpose: str, index: int = 0) -> int:
    if seed < 0:
        raise ValueError(f"--seed must be non-negative, got {seed}")
    index %= 2**64  # the warm-up's negative indices too
    words = [seed & 0xFFFFFFFF, seed >> 32, PURPOSES.index(purpose), index & 0xFFFFFFFF, index >> 32]
    return int(np.random.SeedSequence(words).generate_state(1, dtype=np.uint64)[0]) >> 1


def rng(seed: int, purpose: str, index: int = 0) -> np.random.Generator:
    return np.random.default_rng(derive(seed, purpose, index))
