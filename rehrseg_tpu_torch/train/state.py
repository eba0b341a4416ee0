"""Training state: the trained modules, their optimizer, its schedule and
the step (``rehrseg_tpu.train.state``), saved and restored through
:mod:`rehrseg_tpu_torch.train.checkpoint`.

``params`` is the SegModel, or ``{"seg": SegModel, "distiller":
Distiller}`` when distillation trains both jointly (as the JAX params
tree). Modules are updated in place; ``step`` counts applied updates.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable

import torch

from . import checkpoint as ckpt
from .optim import set_lr


def _load(params, state_dict):
    if isinstance(params, dict):
        for k, m in params.items():
            _load(m, state_dict[k])
    else:
        params.load_state_dict(state_dict, strict=True)


@dataclass
class TrainState:
    params: Any
    optimizer: torch.optim.Optimizer
    schedule: Callable[[int], float]
    step: int = 0

    def apply_gradients(self) -> None:
        """One optimizer update at lr = schedule(step), then step += 1."""
        set_lr(self.optimizer, self.schedule, self.step)
        self.optimizer.step()
        self.step += 1

    def save(self, directory: str, tag: str | None = None,
             step: int | None = None) -> str:
        """Checkpoint params, optimizer state and step under
        ``directory/<tag or step>``."""
        return ckpt.save_checkpoint(
            directory, self.params, self.optimizer,
            step=self.step if step is None else step, tag=tag)

    def restore(self, directory: str, step: int | str | None = None):
        """Load the latest (or the named) checkpoint into the modules and
        the optimizer, in place; returns self."""
        raw = ckpt.restore_checkpoint_raw(directory, step)
        _load(self.params, raw["params"])
        self.optimizer.load_state_dict(raw["opt_state"])
        self.step = int(raw["step"])
        return self
