"""Early stopping on a set of validation metrics.

Counterpart of ``dyglib_tpu/train/early_stopping.py``: a step counts as an
improvement only when EVERY tracked metric is >= its best (ties
included); on improvement the parameters are checkpointed and the counter
resets; otherwise the counter advances toward ``patience``. With
``write=False`` (a rank of a mesh other than the lead) the best
checkpoint is kept in memory instead of written.
"""
from __future__ import annotations

from typing import Any

from .checkpoints import checkpoint_payload, load_checkpoint, save_checkpoint


class EarlyStopping:
    def __init__(
        self,
        patience: int,
        save_path: str,
        higher_better: dict[str, bool] | None = None,
        write: bool = True,
    ):
        self.patience = patience
        self.write = write
        self._best_payload: dict | None = None
        self.counter = 0
        self.best: dict[str, float] = {}
        self.save_path = save_path
        self.higher_better = higher_better or {}

    def step(self, metrics: dict[str, float], params: Any, state: Any = None) -> bool:
        """Returns True when training should stop."""
        improved_all = True
        for name, value in metrics.items():
            hb = self.higher_better.get(name, True)
            v = value if hb else -value
            if name in self.best and v < self.best[name]:
                improved_all = False
        if improved_all:
            for name, value in metrics.items():
                hb = self.higher_better.get(name, True)
                self.best[name] = value if hb else -value
            if self.write:
                save_checkpoint(self.save_path, params, state)
            else:
                self._best_payload = checkpoint_payload(params, state)
            self.counter = 0
        else:
            self.counter += 1
        return self.counter >= self.patience

    def load_best(self) -> dict:
        return load_checkpoint(self.save_path) if self.write else self._best_payload
