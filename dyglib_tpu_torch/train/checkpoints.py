"""Checkpoint save and load.

Counterpart of ``dyglib_tpu/train/checkpoints.py`` for the pickle format:
one pickle of ``{"params": ..., "state": ..., "extra": ...}`` holding numpy
arrays, written atomically through ``<path>.tmp``. The port's params are
``{"backbone": {name: array}, "head": {name: array}}`` (its state dicts as
numpy); a JAX checkpoint's ``"params"`` go through
``transfer.from_jax_params``. A memory model's state is its ``MemoryState``
with numpy fields; ``to_device`` puts it back on a device. Under a mesh a
checkpoint holds the whole state: the trainer gathers the node shards
before saving (``host_state``) and shards the loaded one
(``load_state``). Unpickling runs
code, so load only checkpoints this project wrote.
"""
from __future__ import annotations

import os
import pickle
from typing import Any

import numpy as np
import torch


def _map(fn, tree: Any) -> Any:
    """``fn`` on every leaf of nested dicts and (named) tuples."""
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    if isinstance(tree, tuple):
        items = [_map(fn, v) for v in tree]
        return type(tree)(*items) if hasattr(tree, "_fields") else tuple(items)
    return fn(tree)


def _to_numpy(tree: Any) -> Any:
    return _map(
        lambda x: x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x), tree)


def to_cpu(tree: Any) -> Any:
    """Every tensor of nested dicts, lists and tuples moved to the host (an
    optimizer's ``state_dict`` for a checkpoint's ``extra``)."""
    if isinstance(tree, dict):
        return {k: to_cpu(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(to_cpu(v) for v in tree)
    return tree.detach().cpu() if isinstance(tree, torch.Tensor) else tree


def to_device(tree: Any, device) -> Any:
    """A loaded tree (e.g. a checkpoint's ``"state"``) as tensors on ``device``;
    None stays None."""
    if tree is None:
        return None
    return _map(lambda a: torch.as_tensor(a).to(device), tree)


def checkpoint_payload(params: Any, state: Any = None, extra: Any = None) -> dict:
    """What a checkpoint holds (numpy leaves), as ``load_checkpoint`` returns it."""
    return {
        "params": _to_numpy(params),
        "state": _to_numpy(state) if state is not None else None,
        "extra": extra,
    }


def save_checkpoint(path: str, params: Any, state: Any = None, extra: Any = None) -> None:
    payload = checkpoint_payload(params, state, extra)
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
