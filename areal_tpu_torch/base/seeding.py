"""Deterministic seeding (port of areal_tpu/base/seeding.py): seeds the
host libraries (random, numpy, torch) from (base_seed, worker_index)
and hands out a root `torch.Generator` where the JAX package hands out
a root PRNG key."""

import random

import numpy as np
import torch

from areal_tpu_torch.base.device import resolve_device

_base_seed = 0
_worker_index = 0


def set_random_seed(base_seed: int, worker_index: int = 0) -> None:
    global _base_seed, _worker_index
    _base_seed, _worker_index = base_seed, worker_index
    seed = base_seed + worker_index
    random.seed(seed)
    np.random.seed(seed % (2**32))
    torch.manual_seed(seed)


def get_seed() -> int:
    return _base_seed + _worker_index


def root_generator(device=None) -> torch.Generator:
    """A generator on `device` (the CUDA card unless told otherwise)
    seeded from the configured (base_seed, worker_index)."""
    return torch.Generator(device=resolve_device(device)).manual_seed(get_seed())
