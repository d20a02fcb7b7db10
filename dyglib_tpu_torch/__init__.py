"""dyglib_tpu_torch — the PyTorch + CUDA port of dyglib_tpu for NVIDIA Hopper.

The JAX package ``dyglib_tpu`` is the reference; this package mirrors its
layout and names. It imports torch, numpy and the standard library only,
never JAX or anything of ``dyglib_tpu``. Hand-written CUDA kernels live in
``csrc/`` and are compiled with nvcc at first use (``ops/_build.py``).

Ported so far: link-prediction evaluation and training of every model
(DyGFormer with its time-channel, co-occurrence, patch-projection and
window-fetch kernels; TGAT with its temporal, gathered and window
attention and Phi projection kernels; TGN, DyRep and JODIE; GraphMixer,
TCL and CAWN; EdgeBank's evaluation) under random, historical and
inductive negatives, node classification on a frozen backbone, and
DyGLib's four CLI drivers (``python -m dyglib_tpu_torch.cli.<driver>``).
"""
from .device import resolve_device

__all__ = ["resolve_device"]
