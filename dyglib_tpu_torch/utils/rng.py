"""Seeds and generators of a run.

Counterpart of ``dyglib_tpu/utils/rng.py``. The JAX package threads one
root PRNG key per run and folds it per (epoch, batch); the port draws from
``torch.Generator``s seeded from the run's seed (parameters on the CPU,
dropout and neighbour sampling on the trainer's device) and, for each
evaluation sweep, from 12345 + the sweep's salt. The JAX package's
``use_fast_prng`` and ``enable_compilation_cache`` choose a JAX PRNG and a
JAX compile cache: the port has no counterpart of either.
"""
from __future__ import annotations

import random

import numpy as np
import torch

# an evaluation sweep's stochastic draws start from EVAL_SEED + salt
# (val / new-node val / test / new-node test: salt 0 / 1 / 2 / 3)
EVAL_SEED = 12345


def set_random_seed(seed: int = 0) -> torch.Generator:
    """Seed Python's, numpy's and torch's global generators and return the
    run's root generator (on the CPU)."""
    random.seed(seed)
    np.random.seed(seed)
    torch.manual_seed(seed)
    return generator(seed)


def generator(seed: int, device: str | torch.device = "cpu") -> torch.Generator:
    """A ``torch.Generator`` on ``device`` seeded with ``seed``."""
    return torch.Generator(device=device).manual_seed(seed)


def eval_seed(salt: int) -> int:
    """The seed of an evaluation sweep's draws."""
    return EVAL_SEED + salt


def batch_key(root_seed: int, epoch: int, batch: int) -> int:
    """One 63-bit seed per (epoch, batch) of a run, derived from its root
    seed as ``fold_in(fold_in(root, epoch), batch)`` derives a key: distinct
    for distinct (epoch, batch) and the same on every call and process."""
    seq = np.random.SeedSequence([int(root_seed), int(epoch), int(batch)])
    return int(seq.generate_state(1, np.uint64)[0] >> np.uint64(1))
