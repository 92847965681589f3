"""Optimizer and learning-rate schedule (counterpart of
``custom_yolo_tpu/train/optim.py``): AdamW with global-norm clipping and a
ReduceLROnPlateau whose state is part of the train state.

The learning rate lives in the optimizer's param groups, where
:func:`set_learning_rate` and :func:`current_learning_rate` reach it — the
place ``optax.inject_hyperparams`` gives it in the JAX package. Clipping is
applied by the train step (:func:`clip_by_global_norm_`), in optax's form.
"""

from __future__ import annotations

from typing import Iterable, NamedTuple

import torch

from custom_yolo_tpu_torch.config import TrainingConfig


class PlateauState(NamedTuple):
    """ReduceLROnPlateau: scale the LR by ``factor`` after ``patience``
    epochs without improvement of the validation loss (relative threshold
    1e-4)."""
    scale: torch.Tensor        # current multiplicative LR factor, fp32
    best: torch.Tensor         # best validation loss seen, fp32
    bad_epochs: torch.Tensor   # epochs since the last improvement, int32


def plateau_init() -> PlateauState:
    return PlateauState(scale=torch.tensor(1.0, dtype=torch.float32),
                        best=torch.tensor(torch.inf, dtype=torch.float32),
                        bad_epochs=torch.tensor(0, dtype=torch.int32))


def plateau_update(state: PlateauState, val_loss, patience: int,
                   factor: float, threshold: float = 1e-4,
                   base_lr: float = 1.0, min_lr: float = 0.0,
                   eps: float = 1e-8) -> PlateauState:
    """One ``ReduceLROnPlateau.step(val_loss)``: relative-threshold
    improvement, patience counting, the ``min_lr`` floor, and the ``eps``
    guard that skips LR changes smaller than eps. ``base_lr`` turns the
    tracked ``scale`` into LR units for the min_lr/eps comparisons."""
    val_loss = torch.as_tensor(val_loss, dtype=torch.float32)
    improved = val_loss < state.best * (1.0 - threshold)
    best = torch.where(improved, val_loss, state.best)
    bad = torch.where(improved, 0, state.bad_epochs + 1)
    trigger = bad > patience
    candidate = (state.scale * factor).clamp_min(min_lr / base_lr)
    apply = trigger & ((state.scale - candidate) * base_lr > eps)
    scale = torch.where(apply, candidate, state.scale)
    bad = torch.where(trigger, 0, bad).to(torch.int32)
    return PlateauState(scale=scale, best=best, bad_epochs=bad)


class Optimizer(torch.optim.AdamW):
    """``torch.optim.AdamW`` that also carries the clip threshold of
    :func:`build_optimizer`'s configuration for the train step."""

    def __init__(self, params, grad_clip: float, **kwargs):
        super().__init__(params, **kwargs)
        self.grad_clip = grad_clip


def build_optimizer(params: Iterable[torch.nn.Parameter],
                    cfg: TrainingConfig) -> Optimizer:
    """AdamW (b1 0.9, b2 0.999, eps 1e-8) with decoupled weight decay on
    *every* parameter, as ``optax.adamw`` without a mask applies it;
    ``cfg.grad_clip`` is the global-norm threshold the train step clips
    to before the update."""
    if cfg.optimizer.lower() != "adamw":
        raise ValueError(f"unsupported optimizer {cfg.optimizer!r} "
                         "(adamw only)")
    return Optimizer(params, cfg.grad_clip, lr=cfg.learning_rate,
                     betas=(0.9, 0.999), eps=1e-8,
                     weight_decay=cfg.weight_decay)


def set_learning_rate(optimizer: torch.optim.Optimizer, lr) -> None:
    """Set the learning rate of every param group."""
    for group in optimizer.param_groups:
        group["lr"] = float(lr)


def current_learning_rate(optimizer: torch.optim.Optimizer) -> float:
    return optimizer.param_groups[0]["lr"]


def global_norm(tensors: Iterable[torch.Tensor]) -> torch.Tensor:
    """L2 norm over all of ``tensors`` together, in fp32."""
    norms = torch._foreach_norm([t.detach().float() for t in tensors])
    return torch.linalg.vector_norm(torch.stack(norms))


def clip_by_global_norm_(grads: Iterable[torch.Tensor], norm: torch.Tensor,
                         max_norm: float) -> None:
    """Scale ``grads`` in place by ``max_norm / max(norm, max_norm)``, the
    form of ``optax.clip_by_global_norm`` (``torch.nn.utils.
    clip_grad_norm_`` divides by ``norm + 1e-6`` instead)."""
    torch._foreach_mul_(list(grads), max_norm / norm.clamp_min(max_norm))
