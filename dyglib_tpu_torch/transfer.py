"""Parameter transfer from the JAX package's tree to the port's state dicts.

``from_jax_params`` takes the JAX trainer's parameter tree as numpy arrays
(``{"backbone": ..., "head": ...}`` as ``init_params`` builds it, or a
checkpoint's ``"params"``) and returns ``{"backbone": state_dict,
"head": state_dict}`` for the port's modules. Layouts:

  * a Linear's ``kernel`` is (in, out): ``weight = kernel.T``, ``bias`` as is
    (the plain and the kernel paths share this tree: ``RawLinearParams``
    mirrors ``TorchLinear``);
  * a LayerNorm's ``scale``/``bias`` map to ``weight``/``bias``;
  * ``time_encoder/w`` (1, Dt) and ``time_encoder/b`` (Dt,) keep their shapes;
  * nested module names join with ".", so ``transformer_0/q_proj`` becomes
    ``transformer_0.q_proj`` (the port names its modules alike). TGAT's
    tree (``temporal_conv_{l}/{query,key,value}_projection/kernel``, no
    bias; ``.../residual_fc``, ``.../layer_norm``, ``merge_{l}/fc1|fc2``,
    ``time_encoder/w|b``) maps the same way; the JAX kernel paths'
    ``_RawKernel`` projections share ``Dense``'s names, so one tree serves
    every configuration.
"""
from __future__ import annotations

from collections.abc import Mapping

import numpy as np
import torch


def _unwrap(tree: Mapping) -> Mapping:
    """Drop flax's top-level {"params": ...} collection, if present."""
    return tree["params"] if set(tree) == {"params"} else tree


def module_state_dict(tree: Mapping) -> dict[str, torch.Tensor]:
    """One module's flax parameter tree -> a torch state dict."""
    out: dict[str, torch.Tensor] = {}

    def walk(node: Mapping, prefix: str) -> None:
        leaves = {k: v for k, v in node.items() if not isinstance(v, Mapping)}
        for k, v in node.items():
            if isinstance(v, Mapping):
                walk(v, f"{prefix}{k}.")
        t = lambda a: torch.from_numpy(np.array(a, dtype=np.float32))
        if "kernel" in leaves:  # Linear: (in, out) -> weight (out, in)
            out[prefix + "weight"] = t(leaves.pop("kernel")).T.contiguous()
        if "scale" in leaves:  # LayerNorm
            out[prefix + "weight"] = t(leaves.pop("scale"))
        for k, v in leaves.items():
            out[prefix + k] = t(v)

    walk(_unwrap(tree), "")
    return out


def from_jax_params(params: Mapping) -> dict[str, dict[str, torch.Tensor]]:
    return {
        "backbone": module_state_dict(params["backbone"]),
        "head": module_state_dict(params["head"]),
    }
