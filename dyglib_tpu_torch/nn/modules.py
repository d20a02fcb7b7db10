"""Shared neural modules.

Counterpart of ``dyglib_tpu/nn/modules.py`` (``LN_EPS``, the torch-init
helpers, ``TimeEncoder``, ``MergeLayer``). Parameters are drawn from an
explicit ``torch.Generator`` so a seed fixes the whole model:

  * ``linear``: torch ``nn.Linear``'s default distribution,
    weight and bias U(+-1/sqrt(fan_in)) (the JAX package's ``TorchLinear``);
    ``xavier=True`` gives ``nn.init.xavier_uniform_`` (attention in/out
    projections), ``zero_bias=True`` a zero bias;
  * ``TimeEncoder``: cos(t * w + b) with w the fixed spectrum
    1/10**linspace(0, 9, Dt), stored (1, Dt), and b = 0.
"""
from __future__ import annotations

import numpy as np
import torch
from torch import nn

LN_EPS = 1e-5  # torch nn.LayerNorm default


def _uniform(shape, bound: float, gen: torch.Generator) -> torch.Tensor:
    return torch.empty(shape).uniform_(-bound, bound, generator=gen)


@torch.no_grad()
def linear(
    fan_in: int, fan_out: int, gen: torch.Generator, *, xavier: bool = False,
    zero_bias: bool = False,
) -> nn.Linear:
    """An ``nn.Linear`` whose weight, then bias, are drawn from ``gen`` (the
    global RNG is not touched)."""
    lin = torch.nn.utils.skip_init(nn.Linear, fan_in, fan_out)
    bound = (6.0 / (fan_in + fan_out)) ** 0.5 if xavier else fan_in**-0.5
    lin.weight.copy_(_uniform(lin.weight.shape, bound, gen))
    if zero_bias:
        lin.bias.zero_()
    else:
        lin.bias.copy_(_uniform(lin.bias.shape, fan_in**-0.5, gen))
    return lin


def time_encoder_spectrum(time_dim: int) -> np.ndarray:
    """The fixed 1/10^linspace(0,9,d) frequency init, shape (1, d)."""
    return (1.0 / 10 ** np.linspace(0, 9, time_dim, dtype=np.float32)).reshape(1, time_dim)


class TimeEncoder(nn.Module):
    """Cosine time features phi(t) = cos(w * t + b) with exact ``cos``."""

    def __init__(self, time_dim: int):
        super().__init__()
        self.w = nn.Parameter(torch.from_numpy(time_encoder_spectrum(time_dim)))
        self.b = nn.Parameter(torch.zeros(time_dim))

    def forward(self, timestamps: torch.Tensor) -> torch.Tensor:
        """(...,) times -> (..., time_dim) features."""
        return torch.cos(timestamps[..., None] * self.w[0] + self.b)


class MergeLayer(nn.Module):
    """concat(x1, x2) -> Linear -> ReLU -> Linear."""

    def __init__(self, input_dim: int, hidden_dim: int, output_dim: int, gen: torch.Generator):
        super().__init__()
        self.fc1 = linear(input_dim, hidden_dim, gen)
        self.fc2 = linear(hidden_dim, output_dim, gen)

    def forward(self, input_1: torch.Tensor, input_2: torch.Tensor) -> torch.Tensor:
        h = self.fc1(torch.cat([input_1, input_2], dim=-1))
        return self.fc2(torch.relu(h))
