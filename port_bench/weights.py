"""The starting parameters of a run, made by the benchmark from its seed.

The program's parameter names and shapes say what each tensor is; the
values come from one uniform draw on the device (a ``torch.Generator``
seeded from --seed), in the distributions the models' own
initialisations use: a weight (out, in) and its bias U(+-1/sqrt(in)),
LayerNorm scale 1 and shift 0, the time encoder's fixed spectrum
1/10**linspace(0, 9, d) and zero phase, an LSTM direction's input and
recurrent weights (in, 4H) and (H, 4H) and its two biases (4H,) each
U(+-1/sqrt(H)), as torch's ``nn.LSTM`` (CAWN's encoders). The same
tensors go to the program (``load_params``) and to the reference.
"""
from __future__ import annotations

import re

import numpy as np
import torch

_NORM = re.compile(r"(^|[._])(layer_norm|norm\d*)\.(weight|bias)$")
_LSTM = re.compile(r"(^|\.)(fwd|bwd)_(wx|wh|b|bh)$")


def make(shapes: dict[str, tuple], seed: int, device) -> dict[str, torch.Tensor]:
    """{name: tensor} for {name: shape}; a name the rules do not cover raises."""
    fan_in: dict[str, int] = {}
    drawn: list[tuple[str, tuple, float]] = []
    fixed: dict[str, torch.Tensor] = {}
    for name, shape in shapes.items():
        shape = tuple(shape)
        norm = _NORM.search(name)
        if norm:
            fill = 1.0 if norm.group(3) == "weight" else 0.0
            fixed[name] = torch.full(shape, fill, device=device)
        elif name.endswith("time_encoder.w"):
            d = shape[-1]
            spec = 1.0 / 10 ** np.linspace(0, 9, d, dtype=np.float32)
            fixed[name] = torch.from_numpy(spec.reshape(shape)).to(device)
        elif name.endswith("time_encoder.b"):
            fixed[name] = torch.zeros(shape, device=device)
        elif _LSTM.search(name) and shape[-1] % 4 == 0:
            drawn.append((name, shape, (shape[-1] // 4) ** -0.5))
        elif name.endswith(".weight") and len(shape) == 2:
            fan_in[name[: -len("weight")]] = shape[1]
            drawn.append((name, shape, shape[1] ** -0.5))
        elif name.endswith(".bias") and len(shape) == 1:
            drawn.append((name, shape, None))
        else:
            raise ValueError(f"no rule makes parameter {name!r} of shape {shape}")
    total = sum(int(np.prod(s)) for _, s, _ in drawn)
    gen = torch.Generator(device=device).manual_seed(seed)
    u = torch.rand(total, generator=gen, device=device) * 2.0 - 1.0
    out, at = {}, 0
    for name, shape, bound in drawn:
        if bound is None:
            prefix = name[: -len("bias")]
            if prefix not in fan_in:
                raise ValueError(f"bias {name!r} has no weight beside it")
            bound = fan_in[prefix] ** -0.5
        n = int(np.prod(shape))
        out[name] = (u[at : at + n] * bound).view(shape).clone()
        at += n
    out.update(fixed)
    return {name: out[name] for name in shapes}
