"""Checkpoint save and load.

Counterpart of ``dyglib_tpu/train/checkpoints.py`` for the pickle format:
one pickle of ``{"params": ..., "state": ..., "extra": ...}`` holding numpy
arrays, written atomically through ``<path>.tmp``. The port's params are
``{"backbone": {name: array}, "head": {name: array}}`` (its state dicts as
numpy); a JAX checkpoint's ``"params"`` go through
``transfer.from_jax_params``. Unpickling runs code, so load only
checkpoints this project wrote.
"""
from __future__ import annotations

import os
import pickle
from typing import Any

import numpy as np
import torch


def _to_numpy(tree: Any) -> Any:
    if isinstance(tree, dict):
        return {k: _to_numpy(v) for k, v in tree.items()}
    if isinstance(tree, torch.Tensor):
        return tree.detach().cpu().numpy()
    return np.asarray(tree)


def save_checkpoint(path: str, params: Any, state: Any = None, extra: Any = None) -> None:
    payload = {
        "params": _to_numpy(params),
        "state": _to_numpy(state) if state is not None else None,
        "extra": extra,
    }
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        pickle.dump(payload, f)
    os.replace(tmp, path)


def load_checkpoint(path: str) -> dict:
    if os.path.isdir(path):
        raise ValueError(f"{path} is a directory checkpoint; only pickle files load here")
    with open(path, "rb") as f:
        return pickle.load(f)
