"""Node-sharded memory state over the data axis, on the CPU (two gloo ranks).

Each data rank owns a contiguous block of the memory's node rows (and a
dump row of its own); reads ask the owners for the rows they need and
commits route each kept message to its owner (``models/memory_model.py``).
The two ranks are started once for the module (``torch_dist.memory_checks``):

  * the memory chain: TGN with fixed seed-0 parameters commits five train
    batches through ``eval_step``; the gathered memory and messages within
    1e-5 of one process, clocks and flags equal (the JAX
    ``test_memory_state_chain_exact_under_mesh``);
  * TGN training at data 2 against one process (losses rtol 2e-3 / atol
    2e-4, val AP 2e-2);
  * the collective guard (the JAX ``tests/test_collective_guard.py``): a
    TGN train step and eval step on the fixture and on the fixture with
    1000 more nodes move the same bytes at every call site; the one
    collective that grows with the nodes, the checkpoint's gather
    (``checkpoint/*``), is measured apart and does grow;
  * a whole state sharded and gathered back is itself; a shard holds
    ceil(R / 2) + 1 rows;
  * ``check_memory_order`` runs on the shards: a sweep passes, and a batch
    committed again after later ones moves clocks backwards.
"""
import numpy as np
import pytest
import torch_dist


@pytest.fixture(scope="module")
def ranks():
    return torch_dist.run_ranks(torch_dist.memory_checks, 2, timeout=200)


@pytest.fixture(scope="module")
def single_chain():
    return torch_dist.memory_chain(None)


@pytest.mark.parametrize("field", ["memory", "msg", "last_update", "msg_time", "msg_valid"])
def test_memory_chain_matches_single_process(ranks, single_chain, field):
    ref = single_chain[field]
    for r in ranks:
        got = r["chain"][field]
        assert got.shape == ref.shape
        if got.dtype.kind == "f":
            np.testing.assert_allclose(got, ref, atol=1e-5, rtol=0)
        else:
            np.testing.assert_array_equal(got, ref)


def test_tgn_training_matches_single_process(ranks):
    ref = torch_dist.train_case("TGN")
    for r in ranks:
        np.testing.assert_allclose(r["train"]["losses"], ref["losses"], rtol=2e-3, atol=2e-4)
        assert abs(r["train"]["val_ap"] - ref["val_ap"]) < 2e-2


def test_collectives_do_not_grow_with_nodes(ranks):
    for r in ranks:
        small, big = r["guard"]
        assert big["num_nodes"] == small["num_nodes"] + 1000
        assert small["step"] == big["step"], "a step's collective bytes depend on num_nodes"
        assert {"memory/ids", "memory/rows", "memory/messages", "train/grads"} <= set(small["step"])
        assert not any(site.startswith("checkpoint/") for site in small["step"])


def test_checkpoint_gather_is_the_named_exception(ranks):
    small, big = ranks[0]["guard"]
    assert set(small["checkpoint"]) == {f"checkpoint/{f}" for f in
                                        ("memory", "last_update", "msg", "msg_time", "msg_valid")}
    for site, (calls, nbytes) in small["checkpoint"].items():
        assert big["checkpoint"][site][1] > nbytes


def test_shards_round_trip(ranks):
    from dyglib_tpu_torch.models.memory_model import state_rows

    rows = state_rows(torch_dist.fixture_data().num_nodes)
    for r in ranks:
        assert r["round_trip"]
        assert r["shard_rows"] == -(-rows // 2) + 1


def test_memory_order_checked_on_shards(ranks):
    assert sum(r["violations"] for r in ranks) > 0
