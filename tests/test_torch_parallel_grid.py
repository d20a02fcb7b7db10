"""A 2 x 2 rank grid against one process, on the CPU (four gloo ranks).

Both axes at once: every batch split over the data axis, feature tables
column-sharded over the model axis, gradients summed over all four ranks
(each model rank's loss counted at 1/mp). GraphMixer (stateless) and TGN
(its memory node-sharded over the data axis as well) train one epoch and
sweep val; per-batch losses within rtol 2e-3 / atol 2e-4 and val AP
within 2e-2 of one process, as the JAX mesh test holds its 8-device
(4, 2) mesh; all four ranks report the same numbers.
"""
import numpy as np
import pytest
import torch_dist

CASES = [("GraphMixer", 2, False), ("TGN", 2, False)]


@pytest.fixture(scope="module")
def four_ranks():
    return torch_dist.run_ranks(torch_dist.mesh_cases, 4, CASES, timeout=200)


@pytest.mark.parametrize("case", CASES, ids=lambda c: c[0])
def test_grid_matches_single_process(four_ranks, case):
    ref = torch_dist.train_case(case[0])
    for r in four_ranks:
        np.testing.assert_allclose(r[case]["losses"], ref["losses"], rtol=2e-3, atol=2e-4)
        assert abs(r[case]["val_ap"] - ref["val_ap"]) < 2e-2
        np.testing.assert_array_equal(r[case]["losses"], four_ranks[0][case]["losses"])


@pytest.mark.parametrize("case", CASES, ids=lambda c: c[0])
def test_grid_uses_both_axes(four_ranks, case):
    counts = four_ranks[0][case]["collectives"]
    assert counts["features/node"][0] > 0 and counts["step/probs"][0] > 0
    assert ("memory/messages" in counts) == (case[0] == "TGN")
