"""Fused Phi(dt) @ W projection for TGAT (CUDA, ``csrc/phi_projection.cu``).

    out = cos(dt[:, None] * tw + tb) @ w     (R, Dt) @ (Dt, Dq) -> (R, Dq)

Replaces ``dyglib_tpu/ops/pallas/phi_projection.py::phi_projection``, its
forward ``_fwd_kernel``. A kv row is [feat || Phi(dt)], so key = feat @
Wk[:Df] + Phi(dt) @ Wk[Df:]: TGAT's ``use_phi_fusion`` computes the second
term here, for key and for val, and the (R, Dt) time features never reach
device memory. It is the time channel of ``csrc/time_channel.cu`` at patch
1 with no mask and no bias, and shares its A loader (``csrc/phi.cuh``): the
same rounding of the argument and the accurate cosine. No mask: pad rows
are handled by the attention's logits, not here.

No backward kernel yet: on CUDA tensors the wrapper raises in grad mode;
on CPU tensors it runs the plain version, which autograd differentiates.

Bound on one H100 at the TGAT evaluation batch (layer 1, hop 1: R =
240,000, Dt = 100, Dq = 272), f32 on CUDA cores: 13.1 G operations ->
0.195 ms at 67 T/s; 262 MB written -> 0.078 ms. Bound by operations.

What the simple design leaves on the table: the (R, Dq) product is written
to device memory and read back by the add of the feature term (fusing both
terms into one kernel is what ``ops/gathered_attention.py`` does); f32 on
CUDA cores.
"""
from __future__ import annotations

import torch

from . import _attention, _build

_NAME = "phi_projection"
_ARGTYPES = [_build.P] * 4 + [_build.I] * 2 + [_build.P] + [_build.I] * 3 + [_build.P]


def phi_projection_plain(dt, tw, tb, w, compute_dtype: torch.dtype = torch.float32):
    """Plain PyTorch version, with the JAX signature: dt (R,) or (R, 1);
    tw, tb (Dt,); w (Dt, Dq) -> (R, Dq) f32.

    ``compute_dtype=torch.bfloat16`` rounds Phi and w to bf16 and
    accumulates in f32, the math of the JAX oracle
    ``phi_projection_reference``.
    """
    phi = torch.cos(dt.reshape(-1, 1) * tw + tb)
    phi, w = _attention.rounded(compute_dtype, phi, w)
    return phi @ w


def phi_projection(dt, tw, tb, w):
    """As ``phi_projection_plain`` (f32). ``w`` may be any (Dt, Dq) view
    with one unit stride, such as rows of nn.Linear's weight transposed
    (``weight.t()[Df:]``). CPU tensors take the plain version; CUDA tensors
    launch the kernel."""
    if dt.device.type == "cpu":
        return phi_projection_plain(dt, tw, tb, w)
    if dt.device.type != "cuda":
        raise ValueError(f"phi_projection: unsupported device {dt.device}")
    _attention.refuse_grad(_NAME, dt, tw, tb, w)
    dt = dt.reshape(-1)
    rows, dt_dim, dq = dt.shape[0], tw.shape[-1], w.shape[-1]
    f32, dev = torch.float32, dt.device
    for t, name, shape in ((dt, "dt", (rows,)), (tw, "tw", (dt_dim,)), (tb, "tb", (dt_dim,))):
        _build.require(t, name, f32, shape, dev)
    _require_strided(w, (dt_dim, dq), dev)
    if rows * dq >= 2**31:
        raise ValueError(f"{rows} x {dq} outputs; the kernel indexes with int32")
    out = torch.empty((rows, dq), dtype=f32, device=dev)
    lib = _build.load(_NAME, "phi_projection_forward", _ARGTYPES)
    rc = lib.phi_projection_forward(
        dt.data_ptr(), tw.data_ptr(), tb.data_ptr(), w.data_ptr(), w.stride(0), w.stride(1),
        out.data_ptr(), rows, dt_dim, dq, torch.cuda.current_stream(dev).cuda_stream,
    )
    _build.check(lib, rc, _NAME)
    phi_projection.launches += 1
    return out


def _require_strided(w, shape, device) -> None:
    """Raise unless ``w`` is an f32 ``shape`` view on ``device`` with one
    unit stride (the kernel reads w[k, c] at k * stride(0) + c * stride(1))."""
    if w.device != device or w.dtype != torch.float32 or tuple(w.shape) != tuple(shape):
        raise ValueError(
            f"w must be float32 {tuple(shape)} on {device}; got {w.dtype} "
            f"{tuple(w.shape)} on {w.device}"
        )
    if 1 not in w.stride():
        raise ValueError(f"w has strides {w.stride()}; the kernel needs one unit stride")


phi_projection.launches = 0
