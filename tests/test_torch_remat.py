"""DyGFormer's per-layer remat, tanh GELU and bf16-mask dropout in the port,
on the CPU.

  * ``remat=True`` against ``remat=False`` at dropout 0.1, f32 and bf16: the
    same loss, bitwise equal gradients and an equal dropout generator
    after the step (the selective checkpoint saves the matmul outputs and
    the dropout draws, so the recompute draws no new mask and does not
    advance the generator);
  * at dropout 0, one train step's gradients against ``jax.grad`` of the
    JAX package's ``remat=True`` model within 2e-5 of each tensor's
    largest entry (both f32, sums in other orders; the bound of
    tests/test_torch_train.py, with its rule for the k_proj bias, whose
    gradient is zero in exact arithmetic);
  * under a 2-rank gloo ``sequence_axis`` (tests/torch_dist.py): remat
    against no remat bitwise again, in f32 and bf16, the bf16 tokens
    crossing the all-to-alls as bf16 (half the f32 bytes), and the counts:
    a remat step makes six all-to-alls a block (two in the forward, two in
    the recompute, two in the backward) where one without makes four;
  * ``gelu_approximate``: the block's forward against the JAX block's with
    the tanh GELU, within 1e-5 (f32);
  * ``dropout_impl="bf16mask"``: the mask's values against the JAX
    package's ``_bf16_mask_dropout`` (0 or the bf16-rounded 1 / keep, the
    same on both sides) and its keep rate within 4 standard deviations of
    1 - p on both sides (the two draw from different generators: compared
    in distribution only); in evaluation it is the identity, so a model
    with it evaluates exactly as one without.
"""
import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_dist
from dyglib_tpu.models import DyGFormer as JaxDyGFormer
from dyglib_tpu.models.dygformer import PreLNTransformerEncoder as JaxEncoder
from dyglib_tpu.models.dygformer import _bf16_mask_dropout
from dyglib_tpu.train import LinkPredictionTrainer as JaxTrainer
from dyglib_tpu.train import TrainConfig as JaxConfig
from dyglib_tpu_torch.data import get_link_prediction_data
from dyglib_tpu_torch.models import DyGFormer
from dyglib_tpu_torch.models.dygformer import PreLNTransformerEncoder
from dyglib_tpu_torch.nn.modules import bf16_mask_dropout
from dyglib_tpu_torch.transfer import module_state_dict
from torch_parity import assert_grads_match, jax_grads, jax_params, port_grads, port_trainer

KW = dict(max_input_sequence_length=32, patch_size=4, num_layers=2)


@pytest.mark.parametrize("compute_dtype", ["float32", "bfloat16"])
def test_remat_is_bitwise_no_remat(compute_dtype):
    runs = [torch_dist.remat_step(None, remat, compute_dtype) for remat in (False, True)]
    plain, remat = runs
    assert plain["loss"] == remat["loss"]
    assert set(plain["grads"]) == set(remat["grads"]) and len(plain["grads"]) > 20
    for k, g in plain["grads"].items():
        np.testing.assert_array_equal(remat["grads"][k], g, err_msg=k)
    np.testing.assert_array_equal(remat["generator"], plain["generator"])


def test_remat_matches_jax_grad_at_dropout_0(link_data, synthetic_dataset):
    jtr = JaxTrainer(JaxDyGFormer(**KW, dropout=0.0, remat=True, use_time_kernel=False,
                                  gelu_approximate=False),
                     link_data, JaxConfig(batch_size=200), None)
    params = jax_params(jtr)
    data = get_link_prediction_data("synthetic", data_root=synthetic_dataset)
    tr = port_trainer(DyGFormer(**KW, dropout=0.0, remat=True), data, params, batch_size=200)
    b, arrays, bucket = list(tr.train_batches())[2]
    neg = arrays[3].numpy()
    assert bucket == jtr._pick_bucket(jtr.train_csr, b, b.src, neg)
    jarrays = jtr._batch_arrays(b, b.src, neg)

    def loss_fn(p):
        return jtr._forward(p, jtr.train_csr, jtr.tables, jarrays, jax.random.PRNGKey(0), True,
                            None, False, bucket)[0]

    jloss, grads = jax.jit(jax.value_and_grad(loss_fn))(jax.tree_util.tree_map(jnp.asarray,
                                                                               params))
    loss, _ = tr.train_step(arrays, bucket)
    assert abs(float(loss) - float(jloss)) < 1e-5
    assert_grads_match(port_grads(tr), jax_grads(grads), rtol=2e-5)


@pytest.fixture(scope="module")
def ranks():
    return torch_dist.run_ranks(torch_dist.remat_ulysses_checks, 2, timeout=300)


@pytest.mark.parametrize("compute_dtype", ["float32", "bfloat16"])
def test_remat_under_the_sequence_axis(ranks, compute_dtype):
    for r in ranks:
        plain, remat = r[(False, compute_dtype)], r[(True, compute_dtype)]
        assert plain["loss"] == remat["loss"]
        for k, g in plain["grads"].items():
            np.testing.assert_array_equal(remat["grads"][k], g, err_msg=k)
        np.testing.assert_array_equal(remat["generator"], plain["generator"])


def test_remat_all_to_alls(ranks):
    layers = 2
    for cd in ("float32", "bfloat16"):
        plain, remat = ranks[0][(False, cd)]["collectives"], ranks[0][(True, cd)]["collectives"]
        for site in ("dygformer/qkv", "dygformer/hidden"):
            # the eval forward before the step, the step's forward (and recompute)
            assert plain[site][0] == 2 * layers and remat[site][0] == 3 * layers
            assert plain[site + ":bwd"][0] == remat[site + ":bwd"][0] == layers
        # the step's all-to-alls: every flip counted, less the eval forward's two a block
        step = lambda c: sum(c[s][0] for s in ("dygformer/qkv", "dygformer/hidden",
                                               "dygformer/qkv:bwd", "dygformer/hidden:bwd"))
        assert step(plain) - 2 * layers == 4 * layers
        assert step(remat) - 2 * layers == 6 * layers
    f32, b16 = ranks[0][(False, "float32")]["collectives"], ranks[0][(False, "bfloat16")][
        "collectives"]
    assert 2 * b16["dygformer/qkv"][1] == f32["dygformer/qkv"][1]  # bf16 tokens, half the bytes


def test_bf16_ulysses_forward_matches_one_process(ranks):
    single = torch_dist.remat_step(None, False, "bfloat16")["embeddings"]
    for r in ranks:
        np.testing.assert_array_equal(r[(False, "bfloat16")]["embeddings"], single)


def _encoder_pair(gelu_approximate):
    d, heads = 24, 2
    x = np.random.RandomState(0).randn(3, 10, d).astype(np.float32)
    jm = JaxEncoder(d, heads, dropout=0.0, gelu_approximate=gelu_approximate)
    params = jm.init(jax.random.PRNGKey(0), jnp.asarray(x))
    tm = PreLNTransformerEncoder(d, heads, 0.0, torch.Generator(),
                                 gelu_approximate=gelu_approximate).eval()
    tm.load_state_dict(module_state_dict(jax.tree_util.tree_map(np.asarray, params)))
    return x, np.asarray(jm.apply(params, jnp.asarray(x))), tm


@pytest.mark.parametrize("approximate", [False, True], ids=["erf", "tanh"])
def test_gelu_approximate_matches_jax(approximate):
    x, want, tm = _encoder_pair(approximate)
    with torch.no_grad():
        got = tm(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)
    if approximate:  # the two GELUs differ enough to tell apart
        _, exact, _ = _encoder_pair(False)
        assert np.abs(want - exact).max() > 1e-5


class _MaskDropout(fnn.Module):
    rate: float

    @fnn.compact
    def __call__(self, x):
        return _bf16_mask_dropout(self, x, self.rate, True)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_bf16_mask_dropout_matches_jax_in_distribution(dtype):
    n, p = 200_000, 0.1
    jx = jnp.ones((n,), dtype)
    want = np.asarray(_MaskDropout(p).apply({}, jx, rngs={"dropout": jax.random.PRNGKey(0)}),
                      np.float32)
    got = bf16_mask_dropout(torch.ones(n, dtype=getattr(torch, dtype)), p,
                            torch.Generator().manual_seed(0))
    assert str(got.dtype) == f"torch.{dtype}" and str(want.dtype) == "float32"
    got = got.float().numpy()
    scale = float(torch.tensor(1 / (1 - p), dtype=torch.bfloat16))
    assert scale != 1 / (1 - p)  # the scale is rounded to bf16
    assert set(np.unique(got)) == set(np.unique(want)) == {0.0, scale}
    sigma = (p * (1 - p) / n) ** 0.5
    for vals in (got, want):
        assert abs((vals != 0).mean() - (1 - p)) < 4 * sigma


def test_bf16_mask_dropout_trains_and_is_the_identity_in_eval(synthetic_dataset):
    data = get_link_prediction_data("synthetic", data_root=synthetic_dataset)
    out, batch = {}, None
    for impl in ("flax", "bf16mask"):
        tr = port_trainer(DyGFormer(**KW, dropout=0.1, dropout_impl=impl), data, None,
                          batch_size=200)
        _, arrays, bucket = batch = batch or next(iter(tr.train_batches()))
        probs = tr.eval_step(tr.full_csr, arrays, bucket)[1]
        loss, _ = tr.train_step(arrays, bucket)
        out[impl] = probs, float(loss)
    for a, b in zip(out["flax"][0], out["bf16mask"][0]):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    assert np.isfinite(out["bf16mask"][1]) and out["bf16mask"][1] != out["flax"][1]
    with pytest.raises(ValueError, match="dropout_impl"):
        DyGFormer(dropout_impl="xla")
