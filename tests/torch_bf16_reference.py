"""The JAX package's bf16 and f32 references for tests/test_torch_bf16.py
(not a test module): run as a script in a process of its own,

    python tests/torch_bf16_reference.py DATA_ROOT OUT.pkl [default]

with XLA's excess precision off (``--xla_allow_excess_precision=false``,
set here before JAX starts), or, with ``default``, with XLA's own flags
(the JAX package as it normally runs; probabilities only). By default
XLA's CPU compiler may keep a bf16 value in f32 where the next operation
reads it in f32 (a dot whose bf16 output is converted to f32, an add whose
bf16 sum is), which drops some of the roundings the JAX package writes;
with the flag off every bf16 value is rounded where the program says,
which is the arithmetic the port follows.

For each model (dropout 0, parameters from seed 0) it writes the
parameters, the probabilities of one ``eval_step`` on the first 64 train
edges (the quad: neg_src = src, neg_dst = the next 64 destinations) in f32
and in bf16, and, for DyGFormer and TGAT, ``jax.grad`` of the training loss
on the same batch in both dtypes.
"""
import os
import pickle
import sys

DEFAULT_FLAGS = sys.argv[3:] == ["default"]
if not DEFAULT_FLAGS:
    os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "")
                               + " --xla_allow_excess_precision=false").strip()
os.environ["JAX_PLATFORMS"] = "cpu"

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(HERE))
sys.path.insert(0, HERE)

from dyglib_tpu.data import get_link_prediction_data  # noqa: E402
from dyglib_tpu.graph.csr import time_keys  # noqa: E402
from dyglib_tpu.models import CAWN, TGAT, DyGFormer  # noqa: E402
from dyglib_tpu.train import LinkPredictionTrainer, TrainConfig  # noqa: E402
from torch_parity import jax_params  # noqa: E402

B = 64
# name -> (backbone of a dtype, whether to take gradients)
MODELS = {
    "DyGFormer": (lambda cd: DyGFormer(max_input_sequence_length=32, patch_size=2, num_layers=2,
                                       dropout=0.0, compute_dtype=cd, use_time_kernel=True,
                                       gelu_approximate=False), True),
    "TGAT": (lambda cd: TGAT(num_neighbors=5, num_layers=2, dropout=0.0, compute_dtype=cd), True),
    "CAWN": (lambda cd: CAWN(num_neighbors=8, dropout=0.0, compute_dtype=cd,
                             sample_strategy="recent"), False),
}


def batch_arrays(data):
    """The 64-edge batch, as the seven int32 / float32 host arrays."""
    t = data.train
    return (t.src[:B], t.dst[:B], t.src[:B], t.dst[B : 2 * B], time_keys(t.ts[:B]), t.eid[:B],
            np.ones(B))


def main(root: str, out: str) -> None:
    data = get_link_prediction_data("synthetic", data_root=root)
    batch = tuple(jnp.asarray(a, jnp.float32 if i == 6 else jnp.int32)
                  for i, a in enumerate(batch_arrays(data)))
    results = {}
    for name, (make, grads) in MODELS.items():
        entry = {}
        for cd in ("float32", "bfloat16"):
            tr = LinkPredictionTrainer(make(cd), data, TrainConfig(batch_size=B), None)
            if "params" not in entry:
                entry["params"] = jax_params(tr)
            params = jax.tree_util.tree_map(jnp.asarray, entry["params"])
            loss, probs, _ = tr.eval_step(params, None, tr.full_csr, batch, jax.random.PRNGKey(0))
            entry[cd] = {"loss": float(loss), "probs": [np.asarray(p) for p in probs]}
            if grads and not DEFAULT_FLAGS:
                def loss_fn(p, tr=tr):
                    return tr._forward(p, tr.train_csr, tr.tables, batch, jax.random.PRNGKey(0),
                                       True, None, False)[0]

                tl, g = jax.jit(jax.value_and_grad(loss_fn))(params)
                entry[cd]["train_loss"] = float(tl)
                entry[cd]["grads"] = jax.tree_util.tree_map(np.asarray, g)
        results[name] = entry
    with open(out, "wb") as f:
        pickle.dump(results, f)


if __name__ == "__main__":
    main(sys.argv[1], sys.argv[2])
