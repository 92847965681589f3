"""Train state (counterpart of ``custom_yolo_tpu/train/train_state.py``):
the model with its parameters and BatchNorm buffers, the optimizer with its
moments and learning rate, step and epoch counters, a random generator,
the plateau scheduler's state and, optionally, an exponential moving
average of the parameters *and* the BatchNorm statistics — everything a
resume needs.

Where the JAX state is an immutable pytree that each step replaces, this
one owns mutable objects and the train step updates them in place.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import torch
from torch import nn

from custom_yolo_tpu_torch.train.optim import PlateauState, plateau_init


def _is_statistic(name: str) -> bool:
    """BatchNorm running statistics among a model's buffers."""
    return name.endswith(("running_mean", "running_var"))


@dataclasses.dataclass
class TrainState:
    model: nn.Module
    optimizer: torch.optim.Optimizer
    step: int
    epoch: int
    rng: torch.Generator
    plateau: PlateauState
    # EMA of parameters and BatchNorm statistics, keyed as the state dict
    # (None when disabled). EMA weights paired with the live statistics
    # would be inconsistent, so both are averaged, and evaluation and
    # serving read both from here.
    ema: Optional[Dict[str, torch.Tensor]] = None

    @classmethod
    def create(cls, model: nn.Module, optimizer: torch.optim.Optimizer,
               rng: torch.Generator, ema: bool = False) -> "TrainState":
        return cls(model=model, optimizer=optimizer, step=0, epoch=0,
                   rng=rng, plateau=plateau_init(),
                   ema=({k: v.detach().clone()
                         for k, v in cls._tracked(model).items()}
                        if ema else None))

    @staticmethod
    def _tracked(model: nn.Module) -> Dict[str, torch.Tensor]:
        """Parameters and BatchNorm statistics, by state-dict key."""
        out = dict(model.named_parameters())
        out.update((k, v) for k, v in model.named_buffers()
                   if _is_statistic(k))
        return out

    @property
    def variables(self) -> Dict[str, torch.Tensor]:
        """The live parameters and BatchNorm statistics."""
        return {k: v.detach() for k, v in self._tracked(self.model).items()}

    @property
    def eval_variables(self) -> Dict[str, torch.Tensor]:
        """What validation and serving read: the EMA when it is tracked
        (parameters and statistics), else the live values."""
        return self.ema if self.ema is not None else self.variables
