"""DyGFormer's Ulysses sequence axis against the unsharded net, on the CPU.

Two gloo ranks form a (1, 2) grid and DyGFormer runs with
``sequence_axis="model"`` (``models/dygformer.py``): after the channel
projections each rank keeps half of the joint patch tokens for LN, the
projections and the FFN; an all-to-all turns the token shards into head
shards for the attention and a second one turns them back; the tokens are
gathered (differentiably) before the pooling. As the JAX
``tests/test_seq_sharded_attention.py`` holds its sharded attention:

  * the forward under the same seed-0 parameters within 2e-5 of the
    unsharded net's, on both ranks;
  * one training epoch's losses within rtol 2e-3 / atol 2e-4 and val AP
    within 2e-2 of one process (the mesh tolerances);
  * the all-to-alls counted (the JAX test finds an all-to-all in the HLO),
    with their backward, and the token gather;
  * a model axis that does not divide the heads is refused.
"""
import numpy as np
import pytest
import torch_dist


@pytest.fixture(scope="module")
def ranks():
    return torch_dist.run_ranks(torch_dist.ulysses_checks, 2, timeout=200)


def test_sharded_forward_matches_unsharded(ranks):
    ref = torch_dist.quad_embeddings(torch_dist.trainer("DyGFormer-ulysses"))
    for r in ranks:
        np.testing.assert_allclose(r["embeddings"], ref, atol=2e-5, rtol=0)


def test_sharded_training_matches_single_process(ranks):
    ref = torch_dist.train_case("DyGFormer-ulysses")
    for r in ranks:
        np.testing.assert_allclose(r["train"]["losses"], ref["losses"], rtol=2e-3, atol=2e-4)
        assert abs(r["train"]["val_ap"] - ref["val_ap"]) < 2e-2


@pytest.mark.parametrize("site", ["dygformer/qkv", "dygformer/hidden", "dygformer/tokens"])
def test_forward_issues_the_flips(ranks, site):
    calls, nbytes = ranks[0]["forward_collectives"][site]
    assert calls == 1 and nbytes > 0  # one layer, one batch


@pytest.mark.parametrize("site", ["dygformer/qkv:bwd", "dygformer/hidden:bwd",
                                  "dygformer/tokens:bwd"])
def test_training_transposes_them(ranks, site):
    train_steps = len(ranks[0]["train"]["losses"])
    assert ranks[0]["collectives"][site][0] == train_steps


def test_heads_must_divide(ranks):
    assert "does not divide num_heads 1" in ranks[0]["odd_heads"]
