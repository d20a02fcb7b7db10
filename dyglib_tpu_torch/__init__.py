"""dyglib_tpu_torch — the PyTorch + CUDA port of dyglib_tpu for NVIDIA Hopper.

The JAX package ``dyglib_tpu`` is the reference; this package mirrors its
layout and names. It imports torch, numpy and the standard library only,
never JAX or anything of ``dyglib_tpu``. Hand-written CUDA kernels live in
``csrc/`` and are compiled with nvcc at first use (``ops/_build.py``).

Ported so far: DyGFormer link-prediction evaluation and training (data,
temporal CSR, recent-window sampling, random negatives, the DyGFormer
network with its time-channel, co-occurrence, patch-projection and
window-fetch kernels, the trainer, AP/AUC) and TGAT link-prediction
evaluation (multi-hop recent sampling, temporal attention with its
temporal, gathered and window attention and Phi projection kernels).
"""
from .device import resolve_device

__all__ = ["resolve_device"]
