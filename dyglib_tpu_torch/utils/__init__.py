"""Utilities of the port that no layer above them owns."""
from .tensorboard import SummaryWriter, crc32c, read_scalar_events

__all__ = ["SummaryWriter", "crc32c", "read_scalar_events"]
