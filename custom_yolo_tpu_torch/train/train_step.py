"""Train and eval steps (counterpart of
``custom_yolo_tpu/train/train_step.py``): forward, loss, backward,
clipping, AdamW, EMA — eagerly, on the state's device. bf16 needs no
loss scaling, so there is no GradScaler.

The same steps run under dp and fsdp (``parallel.sharding.
shard_train_state``): the forward goes through the state's ``module`` (the
DDP wrapper, or the model that FSDP2 shards), gradients are synchronised
on the last microbatch only, the parameters FSDP2 leaves whole have their
gradients averaged here, clipping takes the norm of the full gradient, and
the EMA is updated shard by shard.
"""

from __future__ import annotations

import contextlib
import math
from typing import Callable, Dict, Tuple

import torch
import torch.distributed as dist
from torch import nn
from torch.nn.parallel import DistributedDataParallel

from custom_yolo_tpu_torch.train.losses import DetectionLoss
from custom_yolo_tpu_torch.train.optim import (clip_by_global_norm_,
                                               current_learning_rate,
                                               global_norm, local_tensors,
                                               set_learning_rate)
from custom_yolo_tpu_torch.train.train_state import TrainState, full_tensor
from custom_yolo_tpu_torch.utils.profiling import span

Batch = Dict[str, torch.Tensor]


def make_train_step(model: nn.Module, loss_fn: DetectionLoss,
                    optimizer: torch.optim.Optimizer,
                    accumulate_steps: int = 1, ema_decay: float = 0.0,
                    ema_tau: float = 2000.0,
                    warmup_steps: int = 0) -> Callable:
    """Returns ``train_step(state, batch) -> (state, metrics)``.

    batch: dict with
      images    (N, H, W, 3) float
      gt_boxes  (N, G, 4) centre-xywh px
      gt_labels (N, G) integer
      gt_mask   (N, G) bool
    on the model's device. ``state`` is updated in place and returned.
    ``optimizer`` comes from :func:`~custom_yolo_tpu_torch.train.optim.
    build_optimizer`, whose ``grad_clip`` the step clips to.

    ``accumulate_steps > 1`` splits the batch into that many microbatches
    (N must divide): BatchNorm statistics update per microbatch, the
    gradients are averaged, ONE optimizer update follows, and the metrics
    are the mean over the microbatches.

    ``ema_decay > 0`` (the state made with ``ema=True``) keeps
    ema ← d·ema + (1−d)·value over parameters and BatchNorm statistics,
    with d = decay·(1 − exp(−(step+1)/tau)) from the step *before* it is
    incremented.

    ``warmup_steps > 0`` scales the learning rate by
    ``min((step+1)/warmup_steps, 1)`` for this update only; the optimizer
    keeps the base value, which the plateau scheduler owns.

    ``metrics["grad_norm"]`` is the global norm *before* clipping.

    ``model`` is what the forward calls: the state's ``module`` under dp
    (DDP), else the model itself.

    Under a running profiler the step carries its spans
    (``utils.profiling.span``): ``train/step`` around ``train/forward``,
    ``train/loss`` (the assigner's ``train/assign`` inside) and
    ``train/backward`` a microbatch, then ``train/clip`` (the gradient
    average, the global norm and the clip), ``train/optimizer`` and
    ``train/ema``.
    """
    params = [p for p in model.parameters() if p.requires_grad]

    def forward_backward(batch: Batch, sync: bool
                         ) -> Dict[str, torch.Tensor]:
        with _gradient_sync(model, sync):
            with span("train/forward"):
                preds, anchors, strides = model(batch["images"])
            with span("train/loss"):
                loss, metrics = loss_fn(preds, anchors, strides,
                                        batch["gt_boxes"], batch["gt_labels"],
                                        batch["gt_mask"])
            with span("train/backward"):
                loss.backward()
        return {k: v.detach() for k, v in metrics.items()}

    def step(state: TrainState, batch: Batch
             ) -> Tuple[TrainState, Dict[str, torch.Tensor]]:
        if ema_decay > 0.0 and state.ema is None:
            raise ValueError("ema_decay set but the state was created "
                             "without ema=True")
        model.train()
        optimizer.zero_grad(set_to_none=True)
        if accumulate_steps <= 1:
            metrics = forward_backward(batch, sync=True)
        else:
            n = batch["images"].shape[0]
            if n % accumulate_steps:
                raise ValueError(f"batch of {n} does not divide into "
                                 f"{accumulate_steps} microbatches")
            size = n // accumulate_steps
            # gradients add up across the microbatches' backward passes;
            # the ranks exchange them after the last one only
            seq = [forward_backward({k: v[i * size:(i + 1) * size]
                                     for k, v in batch.items()},
                                    sync=i == accumulate_steps - 1)
                   for i in range(accumulate_steps)]
            torch._foreach_div_(local_tensors(p.grad for p in params),
                                accumulate_steps)
            metrics = {k: torch.stack([m[k] for m in seq]).mean()
                       for k in seq[0]}
        with span("train/clip"):
            _average_gradients(state.replicated)
            grads = [p.grad for p in params]
            norm = global_norm(grads)
            metrics["grad_norm"] = norm
            clip_by_global_norm_(grads, norm, optimizer.grad_clip)

        with span("train/optimizer"):
            base_lr = current_learning_rate(optimizer)
            if warmup_steps > 0:
                set_learning_rate(optimizer, base_lr * min(
                    (state.step + 1) / warmup_steps, 1.0))
            optimizer.step()
            if warmup_steps > 0:
                # the base (plateau-owned) learning rate stays in the
                # optimizer
                set_learning_rate(optimizer, base_lr)

        if ema_decay > 0.0:
            with span("train/ema"):
                d = ema_decay * (1.0 - math.exp(-(state.step + 1) / ema_tau))
                live = state.variables
                keys = list(state.ema)
                # ema + (1 − d)·(value − ema), shard by shard
                torch._foreach_lerp_(
                    local_tensors(state.ema[k] for k in keys),
                    local_tensors(live[k] for k in keys), 1.0 - d)
        state.step += 1
        return state, metrics

    def train_step(state: TrainState, batch: Batch
                   ) -> Tuple[TrainState, Dict[str, torch.Tensor]]:
        with span("train/step"):
            return step(state, batch)

    return train_step


@contextlib.contextmanager
def _gradient_sync(module: nn.Module, enabled: bool):
    """Whether the backward passes inside exchange gradients between ranks
    (DDP's ``no_sync``, FSDP2's ``set_requires_gradient_sync``); a module
    on one device has nothing to exchange."""
    if isinstance(module, DistributedDataParallel) and not enabled:
        with module.no_sync():
            yield
        return
    if hasattr(module, "set_requires_gradient_sync"):
        module.set_requires_gradient_sync(enabled)
    yield


def _average_gradients(params) -> None:
    """Average the gradients of ``params`` over every rank, in one
    ``all_reduce`` of their concatenation: the parameters FSDP2 leaves
    whole, which no wrapper synchronises."""
    grads = [p.grad for p in params if p.grad is not None]
    if not grads:
        return
    flat = torch.cat([g.reshape(-1) for g in grads])
    with span("collective/average_gradients"):
        dist.all_reduce(flat)
    flat /= dist.get_world_size()
    torch._foreach_copy_(grads, [part.view_as(g) for part, g in zip(
        flat.split([g.numel() for g in grads]), grads)])


def make_eval_step(model: nn.Module, loss_fn: DetectionLoss) -> Callable:
    """``eval_step(state, batch) -> (metrics, preds, anchors, strides)``:
    forward in evaluation mode (running BatchNorm statistics) on the
    state's ``eval_variables`` — the EMA when it is tracked — and the
    loss. The model's own values are not touched. Under fsdp ``model`` is
    the state's ``eval_model``, a plain replica, and the sharded variables
    are gathered whole before the forward."""

    @torch.no_grad()
    def eval_step(state: TrainState, batch: Batch):
        was_training = model.training
        model.eval()
        variables = {k: full_tensor(v)
                     for k, v in state.eval_variables.items()}
        try:
            preds, anchors, strides = torch.func.functional_call(
                model, variables, (batch["images"],))
        finally:
            model.train(was_training)
        _, metrics = loss_fn(preds, anchors, strides, batch["gt_boxes"],
                             batch["gt_labels"], batch["gt_mask"])
        return metrics, preds, anchors, strides

    return eval_step
