"""Training over a rank grid against one process, on the CPU (gloo ranks).

Two ranks (``torch_dist.run_ranks``, started once for the module) train
one epoch and sweep val on the JAX mesh test's tiny configurations, with
dropout 0 and the same seeded train negatives; the test process trains
the same without a mesh. As ``tests/test_mesh_training.py`` holds the JAX
mesh to the single device: per-batch losses within rtol 2e-3 / atol 2e-4,
val AP within 2e-2. The cases:

  * data axis 2: JODIE and TGAT, and TGAT under ``uniform`` sampling (every
    rank draws for the global batch from the same generator and keeps its
    rows, so the seed-0 parameters' val probabilities match too, within
    1e-5);
  * model axis 2: TGAT (feature tables sharded by columns, gathered rows
    feeding the gathered-attention kernel's plain version);
  * the scan path under the mesh (``train_epoch_scanned``,
    ``evaluate(scanned=True)``): TGAT at data 2 against its loop;
  * the port's single-process JODIE losses against the JAX package's
    single-device ones on the same parameters and negatives, tying the
    chain to the reference.

The other families (TGN, DyRep, CAWN, TCL, GraphMixer, DyGFormer at data
2) are the same code path and are marked slow, as the JAX file marks
them; the 2 x 2 grid is ``test_torch_parallel_grid.py``.
"""
import numpy as np
import pytest
import torch_dist

FAST = [("JODIE", 1, False), ("TGAT", 1, False), ("TGAT-uniform", 1, False),
        ("TGAT", 2, False), ("TGAT", 1, True)]
SLOW = ["TGN", "DyRep", "CAWN", "TCL", "GraphMixer", "DyGFormer"]


@pytest.fixture(scope="module")
def two_ranks():
    return torch_dist.run_ranks(torch_dist.mesh_cases, 2, FAST, timeout=200)


@pytest.fixture(scope="module")
def single():
    return {}


def _single(cache, name, scanned=False):
    if (name, scanned) not in cache:
        cache[(name, scanned)] = torch_dist.train_case(name, None, scanned)
    return cache[(name, scanned)]


def _assert_matches(mesh_res, ref):
    np.testing.assert_allclose(mesh_res["losses"], ref["losses"], rtol=2e-3, atol=2e-4)
    assert abs(mesh_res["val_ap"] - ref["val_ap"]) < 2e-2


@pytest.mark.parametrize("case", FAST, ids=lambda c: f"{c[0]}-model{c[1]}{'-scan' * c[2]}")
def test_mesh_matches_single_process(two_ranks, single, case):
    name, mp_, scanned = case
    ref = _single(single, name)
    for rank_res in two_ranks:
        _assert_matches(rank_res[case], ref)
    # every rank reports the same (global) numbers
    np.testing.assert_array_equal(two_ranks[0][case]["losses"], two_ranks[1][case]["losses"])


def test_uniform_sampling_draws_as_one_process(two_ranks, single):
    ref = _single(single, "TGAT-uniform")
    # under the same parameters (training drifts them by reduction order)
    got = two_ranks[0][("TGAT-uniform", 1, False)]["init_val_probs"]
    for a, b in zip(got, ref["init_val_probs"]):
        np.testing.assert_allclose(a, b, atol=1e-5, rtol=0)


def test_scan_under_mesh_matches_its_loop(two_ranks):
    loop, scan = two_ranks[0][("TGAT", 1, False)], two_ranks[0][("TGAT", 1, True)]
    np.testing.assert_allclose(scan["losses"], loop["losses"], atol=1e-6, rtol=0)
    for a, b in zip(scan["val_probs"], loop["val_probs"]):
        np.testing.assert_allclose(a, b, atol=1e-6, rtol=0)


def test_model_axis_gathers_feature_rows(two_ranks):
    counts = two_ranks[0][("TGAT", 2, False)]["collectives"]
    assert counts["features/node"][0] > 0 and counts["features/edge"][0] > 0
    # the data axis has one rank: batches are not split, no memory moves
    assert not any(site.startswith("memory/") for site in counts)


def test_data_axis_collectives_per_step(two_ranks):
    """One gradient all-reduce a train step, one loss all-reduce and one
    probability gather a step of either kind (two val sweeps), one
    parameter broadcast."""
    counts = two_ranks[0][("TGAT", 1, False)]["collectives"]
    train_steps = len(two_ranks[0][("TGAT", 1, False)]["losses"])
    val_steps = len(two_ranks[0][("TGAT", 1, False)]["val_probs"])
    assert counts["train/grads"][0] == train_steps
    assert counts["step/loss"][0] == counts["step/probs"][0] == train_steps + 2 * val_steps
    assert counts["init/params"][0] == 1
    assert not any(site.startswith("features/") for site in counts)


@pytest.mark.slow
@pytest.mark.parametrize("name", SLOW)
def test_other_families_match_single_process(name):
    got = torch_dist.run_ranks(torch_dist.mesh_cases, 2, [(name, 1, False)], timeout=600)
    ref = torch_dist.train_case(name)
    for rank_res in got:
        _assert_matches(rank_res[(name, 1, False)], ref)


def test_port_single_process_matches_jax(link_data, synthetic_dataset, tmp_path):
    """JODIE (dropout 0): the JAX trainer's seed-0 parameters in both, the
    same seeded train negatives; one epoch's per-batch losses within the
    mesh tolerance."""
    import jax

    from dyglib_tpu.graph import NegativeEdgeSampler as JaxSampler
    from dyglib_tpu.models import MemoryModel as JaxMemoryModel
    from dyglib_tpu.train import LinkPredictionTrainer as JaxTrainer
    from dyglib_tpu.train import TrainConfig as JaxConfig
    from dyglib_tpu_torch.data import get_link_prediction_data
    from dyglib_tpu_torch.graph import NegativeEdgeSampler
    from dyglib_tpu_torch.models import MemoryModel, compute_src_dst_node_time_shifts
    from dyglib_tpu_torch.train import LinkPredictionTrainer, TrainConfig
    from dyglib_tpu_torch.transfer import from_jax_params
    from dyglib_tpu.models.memory_model import TimeShiftStats as JaxShifts

    d = get_link_prediction_data("synthetic", data_root=synthetic_dataset)
    sh = compute_src_dst_node_time_shifts(d.train.src, d.train.dst, d.train.ts)
    jtr = JaxTrainer(JaxMemoryModel(model_name="JODIE", dropout=0.0, time_shifts=JaxShifts(*sh)),
                     link_data, JaxConfig(learning_rate=1e-3), str(tmp_path / "j.pkl"))
    jtr.train_neg = JaxSampler(link_data.train.src, link_data.train.dst, seed=3)
    params, opt_state = jtr.init_params(0)
    host_params = jax.tree_util.tree_map(np.asarray, params)
    *_, jlosses, _ = jtr.train_epoch(params, opt_state, jtr.init_state(), 0,
                                     jax.random.PRNGKey(0))

    tr = LinkPredictionTrainer(MemoryModel("JODIE", dropout=0.0, time_shifts=sh), d,
                               TrainConfig(learning_rate=1e-3), device="cpu")
    tr.train_neg = NegativeEdgeSampler(d.train.src, d.train.dst, seed=3)
    tr.init_params(0)
    tr.load_params(from_jax_params(host_params))
    losses = tr.train_epoch()[0]
    np.testing.assert_allclose(losses, jlosses, rtol=2e-3, atol=2e-4)
