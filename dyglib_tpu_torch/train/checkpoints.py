"""Checkpoint loading.

Counterpart of ``dyglib_tpu/train/checkpoints.py::load_checkpoint`` for
the pickle format: one pickle of ``{"params": ..., "state": ...,
"extra": ...}`` holding numpy arrays. ``transfer.from_jax_params`` turns
its ``"params"`` into the port's state dicts. Unpickling runs code, so
load only checkpoints this project wrote.
"""
from __future__ import annotations

import os
import pickle


def load_checkpoint(path: str) -> dict:
    if os.path.isdir(path):
        raise ValueError(f"{path} is a directory checkpoint; only pickle files load here")
    with open(path, "rb") as f:
        return pickle.load(f)
