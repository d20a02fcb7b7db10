"""Historical and inductive negatives in the port against the JAX package
on the CPU.

  * the negative samplers are host numpy in both packages: the port's
    ``build_eval_neg_samplers`` and the JAX evaluation CLI's layout
    (``runners._build_eval_neg_samplers``) give the same negatives, array
    for array, over whole chronological sweeps of every split under each
    strategy, twice (``reset_random_state`` between), including batches
    whose historical pool is too small (the collision-checked top-up);
  * ``evaluate`` under historical and inductive negatives (the quad [src ||
    dst || neg_src || neg_dst], neg_src as drawn) for TGAT, DyGFormer, TGN,
    GraphMixer and TCL (all ``recent``, small widths, dropout 0) with the
    JAX seed-0 parameters carried by ``from_jax_params``: probabilities and
    losses within 1e-5 of the JAX trainer's ``evaluate``; under random
    negatives the same trainers keep the triple.
"""
import types

import numpy as np
import pytest

from dyglib_tpu.models import TCL as JaxTCL
from dyglib_tpu.models import TGAT as JaxTGAT
from dyglib_tpu.models import DyGFormer as JaxDyGFormer
from dyglib_tpu.models import GraphMixer as JaxGraphMixer
from dyglib_tpu.models import MemoryModel as JaxMemoryModel
from dyglib_tpu.runners import _build_eval_neg_samplers as jax_eval_samplers
from dyglib_tpu.train import LinkPredictionTrainer as JaxTrainer
from dyglib_tpu.train import TrainConfig as JaxConfig
from dyglib_tpu_torch.data import chronological_batches, get_link_prediction_data
from dyglib_tpu_torch.graph import build_eval_neg_samplers
from dyglib_tpu_torch.models import TCL, TGAT, DyGFormer, GraphMixer, MemoryModel
from dyglib_tpu_torch.models import compute_src_dst_node_time_shifts
from tests.torch_parity import assert_probs_close, jax_evaluate, jax_params, port_trainer

STRATEGIES = ["historical", "inductive"]
B = 200


@pytest.fixture(scope="module")
def port_data(synthetic_dataset):
    return get_link_prediction_data("synthetic", data_root=synthetic_dataset)


def _sweep(sampler, stream, batch_size):
    """One sweep's negatives and whether the pool ran short at some batch."""
    sampler.reset_random_state()
    out, topped_up = [], False
    for b in chronological_batches(stream, batch_size):
        n = b.num_valid
        if sampler.negative_sample_strategy == "random":
            out.append(sampler.sample(n))
            continue
        sampler._advance_pool(b.batch_start_time)
        topped_up |= sampler._pool_n < n
        out.append(sampler.sample(n, batch_src_node_ids=b.src[:n], batch_dst_node_ids=b.dst[:n],
                                  current_batch_start_time=b.batch_start_time,
                                  current_batch_end_time=b.batch_end_time))
    return out, topped_up


@pytest.mark.parametrize("strategy", ["random"] + STRATEGIES)
def test_samplers_equal_jax_array_for_array(link_data, port_data, strategy):
    ours = build_eval_neg_samplers(port_data, strategy)
    ref = jax_eval_samplers(types.SimpleNamespace(negative_sample_strategy=strategy), link_data)
    splits = ("val", "new_node_val", "test", "new_node_test")
    topped_up = False
    for sampler, jsampler, split in zip(ours, ref, splits):
        assert sampler.seed == jsampler.seed
        assert sampler.negative_sample_strategy == strategy
        stream, jstream = getattr(port_data, split), getattr(link_data, split)
        for batch_size in (B, 50):
            first, short = _sweep(sampler, stream, batch_size)
            again, _ = _sweep(sampler, stream, batch_size)  # after a reset
            want, _ = _sweep(jsampler, jstream, batch_size)
            topped_up |= short
            assert len(first) == len(want) > 0
            for (s, d), (s2, d2), (js, jd) in zip(first, again, want):
                np.testing.assert_array_equal(s, js)
                np.testing.assert_array_equal(d, jd)
                np.testing.assert_array_equal(s, s2)
                np.testing.assert_array_equal(d, d2)
    assert topped_up == (strategy != "random")


def _models(data):
    shifts = compute_src_dst_node_time_shifts(data.train.src, data.train.dst, data.train.ts)
    small = dict(num_neighbors=4, dropout=0.0)
    return {
        "TGAT": (TGAT, JaxTGAT, dict(small, num_layers=2, time_feat_dim=16), {}),
        "DyGFormer": (DyGFormer, JaxDyGFormer,
                      dict(max_input_sequence_length=16, patch_size=2, num_layers=1,
                           channel_embedding_dim=8, time_feat_dim=16, dropout=0.0),
                      dict(use_time_kernel=False, gelu_approximate=False)),
        "TGN": (MemoryModel, JaxMemoryModel,
                dict(small, model_name="TGN", num_layers=1, time_shifts=shifts), {}),
        "GraphMixer": (GraphMixer, JaxGraphMixer, dict(small, num_layers=1, time_gap=10), {}),
        "TCL": (TCL, JaxTCL, dict(small, num_layers=1), {}),
    }


@pytest.mark.parametrize("name", ["TGAT", "DyGFormer", "TGN", "GraphMixer", "TCL"])
def test_evaluate_matches_jax(link_data, port_data, tmp_path, name):
    ours_cls, jax_cls, kw, jax_kw = _models(port_data)[name]
    jtr = JaxTrainer(jax_cls(**kw, **jax_kw), link_data, JaxConfig(batch_size=B),
                     str(tmp_path / "unused.pkl"))
    params = jax_params(jtr)
    tr = port_trainer(ours_cls(**kw), port_data, params, batch_size=B)
    assert tr._layout(False) == "quad"
    assert tr._layout() == ("triple" if name in ("DyGFormer", "TCL") else "dedup")
    for strategy in STRATEGIES:
        ours = build_eval_neg_samplers(port_data, strategy)[0]
        ref = jax_eval_samplers(types.SimpleNamespace(negative_sample_strategy=strategy),
                                link_data)[0]
        state = jtr.init_state() if tr.has_state else None
        jlosses, _, jprobs, _ = jax_evaluate(jtr, params, link_data.val, ref, state=state)
        out = tr.evaluate(port_data.val, ours)
        assert_probs_close(out[2], jprobs)
        np.testing.assert_allclose(out[0], jlosses, atol=1e-5)
