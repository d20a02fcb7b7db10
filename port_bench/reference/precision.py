"""Products in float32 or from TF32 operands.

Every matrix product of the reference goes through ``Precision``: in
"float32" it is the plain product (``torch.backends.cuda.matmul.allow_tf32``
is turned off by ``strict_float32``); in "tf32" both operands, and in the
backward the cotangent, are first rounded to TF32 (10 mantissa bits,
round to nearest even), the arithmetic of the tensor cores' single TF32
pass, with f32 sums. The
rounding is done in the reference itself, so the control computes the
same on the card and on the CPU.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F


def strict_float32() -> None:
    """Float32 products on the card: no TF32 in cuBLAS or cuDNN."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def round_tf32(x: torch.Tensor) -> torch.Tensor:
    """x rounded to TF32 (8 exponent, 10 mantissa bits), kept as float32."""
    bits = x.contiguous().view(torch.int32)
    bits = (bits + 0xFFF + ((bits >> 13) & 1)) & ~0x1FFF
    return bits.view(torch.float32)


class _Rounded(torch.autograd.Function):
    """``fn(a, b, *rest)`` of TF32 operands, and its backward's products of
    TF32 operands too (the cotangent rounded), as one TF32 pass computes
    a product and its gradients."""

    @staticmethod
    def forward(ctx, fn, a, b, *rest):
        ar, br = round_tf32(a), round_tf32(b)
        ctx.fn = fn
        ctx.save_for_backward(ar, br, *rest)
        return fn(ar, br, *rest)

    @staticmethod
    def backward(ctx, dy):
        saved = ctx.saved_tensors
        leaves = [None if t is None else t.detach().requires_grad_(need)
                  for t, need in zip(saved, ctx.needs_input_grad[1:])]
        with torch.enable_grad():
            y = ctx.fn(*leaves)
            wanted = [t for t in leaves if t is not None and t.requires_grad]
            got = iter(torch.autograd.grad(y, wanted, round_tf32(dy)))
        return (None, *[next(got) if t is not None and t.requires_grad else None
                        for t in leaves])


class Precision:
    def __init__(self, name: str = "float32"):
        if name not in ("float32", "tf32"):
            raise ValueError(f"precision {name!r} is not float32 or tf32")
        self.name = name

    def linear(self, x, weight, bias=None):
        """x @ weight.T + bias."""
        if self.name == "tf32":
            return _Rounded.apply(F.linear, x, weight, bias)
        return F.linear(x, weight, bias)

    def einsum(self, eq: str, a, b):
        if self.name == "tf32":
            return _Rounded.apply(lambda x, y: torch.einsum(eq, x, y), a, b)
        return torch.einsum(eq, a, b)
