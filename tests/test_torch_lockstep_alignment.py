"""chip_smoke.py's TGAT lockstep at a ReLU kink.

The lockstep compares the kernel path's gradients with the plain path's
from the same parameters. Where a ReLU input lies within rounding of zero
the two paths can take different branches, and the row's whole share of
the later gradients then differs. ``chip_smoke.kernel_side`` gives the
plain path the kernel path's value at each such input while its gradient
stays the identity. These tests plant one such input in each direction
(kernel positive and plain negative, kernel negative and plain positive,
and plain exactly zero) in a two-layer ReLU network. They show that the
gradients then match the kernel path's bit for bit, and that without the
alignment they do not.
"""
import importlib.util
import pathlib

import numpy as np
import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
_spec = importlib.util.spec_from_file_location("chip_smoke", ROOT / "chip_smoke.py")
chip_smoke = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(chip_smoke)

ROWS, DIN, DH = 3, 4, 6
# (kernel path's input, plain path's input) at the planted entry (1, 2)
PLANTS = {
    "kernel_positive": (1e-7, -1e-7),
    "kernel_negative": (-2e-7, 3e-7),
    "plain_zero": (5e-8, 0.0),
}


class Planted(torch.nn.Module):
    """A Linear layer whose output takes the value ``target`` exactly while
    its gradient with respect to the weights, the bias and the input is the
    Linear layer's."""

    def __init__(self, weight, bias):
        super().__init__()
        self.weight = torch.nn.Parameter(weight)
        self.bias = torch.nn.Parameter(bias)
        self.target = None

    def forward(self, x):
        z = torch.nn.functional.linear(x, self.weight, self.bias)
        return z - z.detach() + self.target


def _setup(seed=0):
    rng = np.random.RandomState(seed)
    x = torch.from_numpy(rng.randn(ROWS, DIN).astype(np.float32))
    fc1 = Planted(torch.from_numpy(rng.randn(DH, DIN).astype(np.float32)),
                  torch.from_numpy(rng.randn(DH).astype(np.float32)))
    fc2 = torch.nn.Linear(DH, 1)
    with torch.no_grad():
        fc2.weight.copy_(torch.from_numpy(rng.randn(1, DH).astype(np.float32)))
        fc2.bias.copy_(torch.from_numpy(rng.randn(1).astype(np.float32)))
    target = torch.from_numpy(rng.randn(ROWS, DH).astype(np.float32))
    return x, fc1, fc2, target


def _grads(x, fc1, fc2, target):
    fc1.target = target
    # linear in the network's output: its cotangent is the same on both paths
    loss = (fc2(torch.relu(fc1(x))) * torch.tensor([[1.0], [-2.0], [0.5]])).sum()
    return torch.autograd.grad(loss, [fc1.weight, fc1.bias, fc2.weight, fc2.bias])


def _lockstep(plant, align):
    """Both paths' gradients and the flips, as tgat_lockstep takes them:
    the kernel pass records fc1's outputs, the plain pass is aligned to
    them by a forward hook."""
    x, fc1, fc2, target = _setup()
    t_kernel, t_plain = target.clone(), target.clone()
    t_kernel[1, 2], t_plain[1, 2] = PLANTS[plant]
    recorded, seen = [], {}

    def hook(mod, inputs, out):
        if not recorded:
            recorded.append(out.detach())
            return None
        aligned, n, worst = chip_smoke.kernel_side(out, recorded[0])
        seen.update(n=n, worst=worst)
        return aligned if align else None

    handle = fc1.register_forward_hook(hook)
    try:
        kernel = _grads(x, fc1, fc2, t_kernel)
        plain = _grads(x, fc1, fc2, t_plain)
    finally:
        handle.remove()
    return kernel, plain, seen


@pytest.mark.parametrize("plant", sorted(PLANTS))
def test_aligned_plain_path_matches_the_kernel_path_bit_for_bit(plant):
    kernel, plain, seen = _lockstep(plant, align=True)
    assert seen["n"] == 1
    assert seen["worst"] == pytest.approx(max(abs(v) for v in PLANTS[plant]), rel=1e-6)
    assert seen["worst"] <= chip_smoke.FLIP_ATOL
    for gk, gp in zip(kernel, plain):
        torch.testing.assert_close(gp, gk, rtol=0, atol=0)


@pytest.mark.parametrize("plant", sorted(PLANTS))
def test_unaligned_plain_path_differs_at_the_kink(plant):
    kernel, plain, seen = _lockstep(plant, align=False)
    assert seen["n"] == 1
    # fc1's row 2 and fc2's column 2 take the other branch's gradient
    assert not torch.equal(kernel[0][2], plain[0][2])
    assert not torch.equal(kernel[2][0, 2], plain[2][0, 2])
    # rows of fc1 with no flipped input agree
    torch.testing.assert_close(plain[0][:2], kernel[0][:2], rtol=0, atol=0)


def test_no_flip_leaves_the_plain_path_alone():
    out = torch.tensor([[1.0, -2.0, 0.0]])
    aligned, n, worst = chip_smoke.kernel_side(out, torch.tensor([[3.0, -1.0, -1.0]]))
    assert aligned is None and n == 0 and worst == 0.0
