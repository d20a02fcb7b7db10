"""Device resolution for the port's entry points.

Every entry point runs on the card unless the caller asks for the CPU
(``device="cpu"``, as the tests do). Asking for CUDA on a machine without
a card raises: the port never falls back to the CPU quietly, because a
number measured there would say nothing about the card.
"""
from __future__ import annotations

import torch


def resolve_device(device: str | torch.device | None = None) -> torch.device:
    """``None`` -> ``cuda``; raise if a CUDA device is asked for and absent."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {dev} requested but torch.cuda.is_available() is False; "
            'pass device="cpu" to run on the CPU'
        )
    return dev
