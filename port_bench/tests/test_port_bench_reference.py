"""The plain reference against the port's plain path at tiny sizes on the
CPU: a train cell and an eval cell of each model, driven as the benchmark
drives them (set-up, a window of sweeps, the check), come out correct,
and the control (the reference in TF32 in the program's place) fails."""
import io
import json

import pytest

from port_bench import catalog, harness

from . import _tiny

CELLS = [f"{c}.{p}" for c in _tiny.CONFIGS for p in ("train", "eval")]


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return _tiny.make_root(tmp_path_factory.mktemp("tiny"))


def drive(root, name, seed=2**33 + 5):
    out, err = io.StringIO(), io.StringIO()
    rc = harness.execute(catalog.cell(name, root), seed, 0.2, False, harness.Clock(),
                         device="cpu", root=root, out=out, err=err)
    return rc, json.loads(out.getvalue().strip().splitlines()[-1]), err.getvalue()


@pytest.mark.parametrize("name", CELLS)
def test_program_agrees_with_reference(root, name):
    rc, line, err = drive(root, name)
    assert rc == 0
    assert line["correct"] is True, line["checks"]
    assert list(line)[-1] == "checks"
    assert err.strip().splitlines()[-1].startswith("check ")
    for v in line["checks"].values():
        assert v["value"] <= 1e-5


CONTROLS = [(name, c) for name in CELLS
            for c in ("tf32", "half_batch")[: 2 if name.endswith(".train") else 1]]


@pytest.mark.parametrize("name,control", CONTROLS, ids=[f"{n}-{c}" for n, c in CONTROLS])
def test_tf32_control_fails(root, name, control):
    """The reference put in the program's place, in TF32 (and, in a train
    cell, with half of each batch left out), through the run's own
    judgement: ``correct`` comes out false."""
    out, err = io.StringIO(), io.StringIO()
    rc = harness.execute(catalog.cell(name, root), 7, 0.0, False, harness.Clock(), device="cpu",
                         root=root, out=out, err=err, control=control)
    line = json.loads(out.getvalue().strip().splitlines()[-1])
    assert rc == 0 and line["correct"] is False, line["checks"]
    assert any(v["value"] > v["limit"] for v in line["checks"].values())


@pytest.mark.cuda
def test_tf32_control_fails_on_the_card(root):
    """As above, on the card: the kernel path's run at tiny sizes, and its
    TF32 control coming out false through ``execute``."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("no CUDA card")
    for control, want in ((None, True), ("tf32", False)):
        out = io.StringIO()
        rc = harness.execute(catalog.cell("tiny_dygformer.train", root), 7, 0.2, False,
                             harness.Clock(), device="cuda", root=root, out=out,
                             err=io.StringIO(), control=control)
        line = json.loads(out.getvalue().strip().splitlines()[-1])
        assert rc == 0 and line["correct"] is want, (control, line["checks"])


def test_seeds_are_reproducible(root):
    a = drive(root, "tiny_tgat.eval", seed=11)[1]["checks"]
    b = drive(root, "tiny_tgat.eval", seed=11)[1]["checks"]
    assert a == b
