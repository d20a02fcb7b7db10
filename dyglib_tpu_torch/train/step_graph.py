"""A sweep's steps replayed as CUDA graphs: the port's counterpart of the
JAX trainers' ``lax.scan`` epochs.

The JAX package compiles a whole train epoch or eval sweep into one
program (``jax.jit(lax.scan)``), so the host dispatches once a sweep
instead of once an op. Here a step stays the trainer's Python function of
tensors (``train_step``, ``eval_step``); ``StepGraphs.run`` captures it
once per static shape (its ``key``) into a ``torch.cuda.CUDAGraph`` and,
for every later batch, copies the batch into the captured (static) input
tensors and replays the graph: a step costs the host a few copies and one
replay instead of some hundreds of launches.

  * Warm-up: the first call of a key runs eagerly on the capture stream.
    It is a real step of the sweep, so nothing is computed twice
    or thrown away: it makes what a step creates lazily (the optimizer's
    state, the kernels' libraries and the phase marks' (``phases.py``),
    cuBLAS's workspace on that stream, the gradients' first allocation)
    before the capture, which must not allocate outside its pool or touch
    the host. The call that captures then replays the graph once for its
    own batch (a capture runs nothing).
  * Generators: each generator the step draws from (dropout, neighbour
    sampling) is registered with its graph. A replay draws what the eager
    step would have drawn and advances the generator by as much (PyTorch's
    graph-safe Philox offsets), so a captured sweep leaves every generator
    in the state the eager loop leaves it.
  * State: inputs are copied into the static tensors before each replay,
    the outputs are the graph's static tensors, overwritten by the next
    replay of the same key. A memory model's state goes out and comes back
    in as such a copy; the caller clones what it keeps.
  * Launch counts: a kernel wrapper counts a launch that a capture
    records in its ``captured`` counter, not in ``launches``
    (``ops.captured_counts``); ``run`` reads what each capture recorded
    and ``launches()`` multiplies it by the graph's replays. The wrappers'
    ``launches`` count what ran eagerly.
  * Phase marks: a captured step launches the mark kernel of each of its
    phases (``phases.phase``) and, after its last operation, the one that
    closes it (``phases.end_step``), so that a profiler trace of the
    replays splits each one's device time by phase. They are no wrapper's
    launches.

On a device other than ``cuda`` (the CPU tests) nothing is captured: every
call runs eagerly, the same staged loop. A capture or replay that fails
raises; nothing falls back to eager execution.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .. import ops
from ..utils.rng import eval_seed
from . import phases


def stack_columns(rows, device) -> tuple[torch.Tensor, ...]:
    """Rows of equal-shaped numpy arrays (one row a batch) -> each column
    stacked as a (T, ...) tensor on ``device``, one copy each (a scanned
    sweep's staging)."""
    return tuple(torch.from_numpy(np.stack(col)).to(device) for col in zip(*rows))


def eval_generator(gen: torch.Generator | None, device, salt: int) -> torch.Generator:
    """An evaluation sweep's draws, seeded from 12345 + salt: ``gen`` re-seeded
    (made on ``device`` when None). A trainer keeps one: a captured eval
    graph keeps drawing from the generator it registered."""
    if gen is None:
        gen = torch.Generator(device=device)
    return gen.manual_seed(eval_seed(salt))


def _leaves(tree) -> list[torch.Tensor]:
    """The tensors of nested (named) tuples, in order; None is skipped."""
    if isinstance(tree, tuple):
        return [x for item in tree for x in _leaves(item)]
    return [] if tree is None else [tree]


def _like(tree):
    """Fresh tensors shaped as ``tree``'s (the static inputs of a capture)."""
    if isinstance(tree, tuple):
        items = [_like(item) for item in tree]
        return type(tree)(*items) if hasattr(tree, "_fields") else tuple(items)
    return None if tree is None else torch.empty_like(tree)


def _clone(tree):
    if isinstance(tree, tuple):
        items = [_clone(item) for item in tree]
        return type(tree)(*items) if hasattr(tree, "_fields") else tuple(items)
    return None if tree is None else tree.clone()


@dataclasses.dataclass
class _Entry:
    graph: torch.cuda.CUDAGraph | None = None
    static_in: tuple | None = None
    static_out: object = None
    per_replay: dict[str, int] = dataclasses.field(default_factory=dict)
    replays: int = 0


class StepGraphs:
    """One CUDA graph per key of a trainer's steps, captured at first need
    and replayed for every later batch of that key."""

    def __init__(self, device: torch.device):
        self.device = torch.device(device)
        self.capture = self.device.type == "cuda"
        self._entries: dict = {}
        self._side: torch.cuda.Stream | None = None  # made at the first step

    @property
    def _stream(self) -> torch.cuda.Stream:
        if self._side is None:
            self._side = torch.cuda.Stream(self.device)
        return self._side

    def run(self, key, fn, args: tuple, generators=()):
        """``fn(*args)`` for one batch: eagerly at the first call of ``key``
        (and always off ``cuda``), then as a replay of its graph. ``args`` are
        tensors in nested (named) tuples, or None; ``generators`` are those
        ``fn`` draws from."""
        if not self.capture:
            return fn(*args)
        if key not in self._entries:  # the warm-up step
            phases.load()
            self._entries[key] = _Entry()
            return self._on_stream(fn, args)
        e = self._entries[key]
        if e.graph is None:
            self._capture(e, fn, args, generators)
        for dst, src in zip(_leaves(e.static_in), _leaves(args)):
            if dst.data_ptr() != src.data_ptr():
                dst.copy_(src)
        e.graph.replay()
        e.replays += 1
        return e.static_out

    def _on_stream(self, fn, args):
        cur = torch.cuda.current_stream(self._stream.device)
        self._stream.wait_stream(cur)
        with torch.cuda.stream(self._stream):
            out = fn(*args)
        cur.wait_stream(self._stream)
        return out

    def _capture(self, e: _Entry, fn, args, generators) -> None:
        e.static_in = _like(args)
        graph = torch.cuda.CUDAGraph()
        for gen in generators:
            graph.register_generator_state(gen)
        before = ops.captured_counts()
        cur = torch.cuda.current_stream(self._stream.device)
        self._stream.wait_stream(cur)
        with torch.cuda.graph(graph, stream=self._stream):
            e.static_out = fn(*e.static_in)
            phases.end_step()
        cur.wait_stream(self._stream)
        after = ops.captured_counts()
        e.per_replay = {k: after[k] - before[k] for k in after if after[k] != before[k]}
        e.graph = graph

    def scan(self, key, step, xs: tuple[torch.Tensor, ...], state, generators=()):
        """``step(x_i, state) -> (outputs, state)`` over the leading (T) axis
        of ``xs``, each step through ``run``; the outputs go into (T, ...)
        device buffers. Returns (the buffers, a copy of the final state)."""
        bufs = None
        for i in range(xs[0].shape[0]):
            outs, state = self.run(key, step, (tuple(x[i] for x in xs), state), generators)
            if bufs is None:
                bufs = [o.new_empty((xs[0].shape[0], *o.shape)) for o in outs]
            for buf, o in zip(bufs, outs):
                buf[i].copy_(o)
        return bufs, _clone(state)

    def launches(self) -> dict[str, int]:
        """Kernel launches the replays made: each graph's launches a replay
        times its replays, summed over the graphs."""
        out: dict[str, int] = {}
        for e in self._entries.values():
            for name, n in e.per_replay.items():
                out[name] = out.get(name, 0) + n * e.replays
        return out

    @property
    def replays(self) -> int:
        return sum(e.replays for e in self._entries.values())

    def reset_counts(self) -> None:
        """Zero the replay counts (the graphs stay)."""
        for e in self._entries.values():
            e.replays = 0
