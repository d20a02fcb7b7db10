"""Utilities of the port that no layer above them owns."""
from .rng import EVAL_SEED, batch_key, eval_seed, generator, set_random_seed
from .tensorboard import SummaryWriter, crc32c, read_scalar_events

__all__ = ["EVAL_SEED", "batch_key", "eval_seed", "generator", "set_random_seed",
           "SummaryWriter", "crc32c", "read_scalar_events"]
