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
inductive negatives, node classification on a frozen backbone,
DyGLib's four CLI drivers (``python -m dyglib_tpu_torch.cli.<driver>``),
and the JAX trainers' scan epochs, replayed as CUDA graphs
(``train/step_graph.py``), with the rest of their ``fit``: mid-epoch
resume, TensorBoard scalars (``utils/tensorboard.py``) and the profiler
hook; multi-device training and evaluation over a (data, model) grid of
ranks on ``torch.distributed`` (``parallel/``, the trainer's ``mesh=``);
and the host tier: raw preprocessing and statistics without pandas
(``data/``), the native CSR builder (``native/``) and ``utils/rng.py``.
"""
from .device import resolve_device

__all__ = ["resolve_device"]
