"""Hand-written CUDA kernels of the port, one module each.

Each module holds the kernel's wrapper (which counts its launches in
``<wrapper>.launches``, and the launches a CUDA graph capture records in
``<wrapper>.captured``), its plain PyTorch version, and a header naming the
TPU kernel it replaces and its bound on the card. A kernel with a gradient
is wrapped in a ``torch.autograd.Function`` whose backward calls the
backward kernel's wrapper (on CPU tensors, the plain forward and the
explicit plain backward). Importing needs no nvcc: kernels are built at
their first launch (``_build.py``).
"""
from .cooccurrence import cooccurrence_counts, cooccurrence_counts_plain
from .gathered_attention import (
    gathered_attention,
    gathered_attention_backward,
    gathered_attention_backward_plain,
    gathered_attention_plain,
)
from .patch_projection import BF16_BACKWARD as _PATCH_BF16_BACKWARD
from .patch_projection import BF16_FORWARD as _PATCH_BF16_FORWARD
from .patch_projection import (
    patch_projection,
    patch_projection_backward,
    patch_projection_backward_plain,
    patch_projection_plain,
)
from .phi_projection import (
    phi_projection,
    phi_projection_backward,
    phi_projection_backward_plain,
    phi_projection_plain,
)
from .temporal_attention import (
    temporal_attention,
    temporal_attention_backward,
    temporal_attention_backward_plain,
    temporal_attention_plain,
)
from .time_channel import BF16_BACKWARD as _TIME_BF16_BACKWARD
from .time_channel import BF16_FORWARD as _TIME_BF16_FORWARD
from .time_channel import (
    time_channel_backward,
    time_channel_backward_plain,
    time_channel_projection,
    time_channel_projection_plain,
)
from .window_attention import (
    window_attention,
    window_attention_backward,
    window_attention_backward_plain,
    window_attention_plain,
)
from .window_fetch import fetch_sequence_features, fetch_sequence_features_plain

# kernel name -> its wrapper (the bf16 variants, picked by the wrappers'
# compute_dtype: their launch counters)
KERNELS = {
    "time_channel": time_channel_projection,
    "time_channel_bwd": time_channel_backward,
    "cooccurrence": cooccurrence_counts,
    "patch_projection": patch_projection,
    "patch_projection_bwd": patch_projection_backward,
    "window_fetch": fetch_sequence_features,
    "temporal_attention": temporal_attention,
    "temporal_attention_bwd": temporal_attention_backward,
    "gathered_attention": gathered_attention,
    "gathered_attention_bwd": gathered_attention_backward,
    "window_attention": window_attention,
    "window_attention_bwd": window_attention_backward,
    "phi_projection": phi_projection,
    "phi_projection_bwd": phi_projection_backward,
    "time_channel_bf16": _TIME_BF16_FORWARD,
    "time_channel_bf16_bwd": _TIME_BF16_BACKWARD,
    "patch_projection_bf16": _PATCH_BF16_FORWARD,
    "patch_projection_bf16_bwd": _PATCH_BF16_BACKWARD,
}


def launch_counts() -> dict[str, int]:
    return {name: fn.launches for name, fn in KERNELS.items()}


def captured_counts() -> dict[str, int]:
    """Launches recorded by CUDA graph captures (each runs at every replay)."""
    return {name: fn.captured for name, fn in KERNELS.items()}


def reset_launch_counts() -> None:
    for fn in KERNELS.values():
        fn.launches = fn.captured = 0


__all__ = [
    "KERNELS",
    "captured_counts",
    "launch_counts",
    "reset_launch_counts",
    "cooccurrence_counts",
    "cooccurrence_counts_plain",
    "fetch_sequence_features",
    "fetch_sequence_features_plain",
    "gathered_attention",
    "gathered_attention_backward",
    "gathered_attention_backward_plain",
    "gathered_attention_plain",
    "patch_projection",
    "patch_projection_backward",
    "patch_projection_backward_plain",
    "patch_projection_plain",
    "phi_projection",
    "phi_projection_backward",
    "phi_projection_backward_plain",
    "phi_projection_plain",
    "temporal_attention",
    "temporal_attention_backward",
    "temporal_attention_backward_plain",
    "temporal_attention_plain",
    "time_channel_backward",
    "time_channel_backward_plain",
    "time_channel_projection",
    "time_channel_projection_plain",
    "window_attention",
    "window_attention_backward",
    "window_attention_backward_plain",
    "window_attention_plain",
]
