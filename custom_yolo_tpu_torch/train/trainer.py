"""Epoch/step training engine (counterpart of
``custom_yolo_tpu/train/trainer.py``), on one device or, under ``dp`` and
``fsdp`` with more than one process, data parallel over every rank
(``parallel.sharding.shard_train_state``; with one process both train as
``single``, as the JAX trainer does on one device).

* The loader reshuffles per epoch; one ``torch.Generator`` on the device is
  reseeded for each ``(project.seed, epoch, step)`` of training and each
  ``(project.seed + 1, epoch, step)`` of validation — the roles of
  ``prng.epoch_key`` and ``fold_in`` — so a resumed run draws exactly what
  an unbroken run draws. Ranks above 0 fold their rank into that seed, so
  that no two ranks draw one stream for different rows; rank 0 draws the
  single-process stream;
* each rank loads, stages and augments its own rows; logging, the metrics
  logger and checkpoint writes belong to the rank that is given them
  (rank 0), and validation sums the detection counters and averages the
  loss means over the ranks;
* with ``data.pin_memory`` batch N+1 is copied through pinned memory
  (non-blocking) and augmented before batch N's step is awaited;
* metrics stay device tensors and are read once per log interval;
* validation runs the eval step, the fixed-shape decode (no NMS) and the
  greedy ``DetectionMetrics``, skipping ``sample_pad`` rows;
* ReduceLROnPlateau on the validation loss, best-metric tracking (with the
  ``val/loss`` alias) and early stopping;
* a checkpoint of the full state every ``checkpoint.save_interval`` epochs.
"""

from __future__ import annotations

import time
from collections import deque
from typing import Any, Dict, Optional

import numpy as np
import torch
from torch import nn

from custom_yolo_tpu_torch.config import Config
from custom_yolo_tpu_torch.core.mesh import (MeshSpec, create_mesh, rank,
                                             world_size)
from custom_yolo_tpu_torch.data.transforms import make_device_batch
from custom_yolo_tpu_torch.eval.decode import (decode_predictions,
                                               decoded_to_lists)
from custom_yolo_tpu_torch.eval.metrics import DetectionMetrics
from custom_yolo_tpu_torch.parallel.collectives import (reduce_metrics,
                                                        reduce_value)
from custom_yolo_tpu_torch.parallel.sharding import shard_train_state
from custom_yolo_tpu_torch.train.losses import DetectionLoss, LossConfig
from custom_yolo_tpu_torch.train.optim import (build_optimizer,
                                               plateau_update,
                                               set_learning_rate)
from custom_yolo_tpu_torch.train.train_state import TrainState
from custom_yolo_tpu_torch.train.train_step import (make_eval_step,
                                                    make_train_step)


def step_seed(seed: int, epoch: int, step: int, rank: int = 0) -> int:
    """The generator's seed for one step of one epoch: a hash of the three
    (numpy's ``SeedSequence``), so that neighbouring steps and epochs draw
    unrelated streams; a rank above 0 is hashed in as a fourth word."""
    entropy = [seed % 2 ** 64, epoch, step] + ([rank] if rank else [])
    return int(np.random.SeedSequence(entropy).generate_state(
        1, np.uint64)[0])


def _fetch(metrics: Dict[str, torch.Tensor]) -> Dict[str, float]:
    """Device scalars → floats, in one copy."""
    values = torch.stack([v.float() for v in metrics.values()]).tolist()
    return dict(zip(metrics, values))


class Trainer:
    """Trains ``model`` (from ``create_train_model``, on its device) as the
    config says. Under ``dp``/``fsdp`` in a process group of more than one
    rank, every rank builds its Trainer from the same config and seed and
    calls ``fit`` with its own loaders (``process_index``/``process_count``
    of the ranks); only rank 0 is given a logger's files, a metrics logger
    and a checkpoint manager."""

    def __init__(self, config: Config, model: nn.Module, logger=None,
                 metrics_logger=None, checkpoint_manager=None):
        tcfg = config.training
        self.config = config
        self.model = model
        self.logger = logger
        self.metrics_logger = metrics_logger
        self.ckpt = checkpoint_manager
        self.device = next(model.parameters()).device

        self.mesh = None
        if tcfg.sharding.mode != "single" and world_size() > 1:
            self.mesh = create_mesh(MeshSpec.for_mode(tcfg.sharding.mode),
                                    device_type=self.device.type)
        self.loss_fn = DetectionLoss(LossConfig(
            num_classes=config.model.num_classes,
            reg_max=config.model.reg_max,
            lambda_cls=tcfg.lambda_cls,
            lambda_box=tcfg.lambda_box,
            lambda_dfl=tcfg.lambda_dfl,
            assigner=tcfg.assigner), global_batch=self.mesh is not None)
        self.state = TrainState.create(
            model, build_optimizer(model.parameters(), tcfg),
            torch.Generator().manual_seed(config.project.seed),
            ema=tcfg.ema_decay > 0)
        if self.mesh is not None:
            self.state = shard_train_state(
                self.state, self.mesh,
                min_weight_size=tcfg.sharding.fsdp_min_weight_size)
        self.optimizer = self.state.optimizer
        self.train_step = make_train_step(
            self.state.module or model, self.loss_fn, self.optimizer,
            accumulate_steps=tcfg.accumulate_steps,
            ema_decay=tcfg.ema_decay, ema_tau=tcfg.ema_tau,
            warmup_steps=tcfg.warmup_steps)
        self.eval_step = make_eval_step(self.state.eval_model or model,
                                        self.loss_fn)
        self.base_lr = tcfg.learning_rate
        self.history: list = []
        # the augmentation draws, reseeded for every step
        self._gen = torch.Generator(device=self.device)

    # ------------------------------------------------------------------
    def load_state(self, state: TrainState) -> None:
        """Install a (restored) train state, which must hold this trainer's
        model and optimizer (``CheckpointManager.restore(trainer.state)``
        restores in place; ``train_state_from_jax`` is given them)."""
        if state.model is not self.model or \
                state.optimizer is not self.optimizer:
            raise ValueError("the state holds another model or optimizer "
                             "than this trainer's")
        self.state = state

    def _log(self, msg: str) -> None:
        if self.logger is not None:
            self.logger.info(msg)
        elif rank() == 0:
            print(msg)

    def _device_batches(self, loader, seed: int, epoch: int, train: bool,
                        mosaic_prob: float = 0.0, mixup_prob: float = 0.0):
        """Yield ``(step, host_batch, device_batch)``, staging ahead of
        consumption with ``data.pin_memory``: batch N+1's copy and
        augmentation are enqueued before the caller waits on batch N (depth
        2); depth 1 otherwise."""
        pin = self.config.data.pin_memory
        depth = 2 if pin else 1
        buf: deque = deque()
        for step, host_batch in enumerate(loader):
            self._gen.manual_seed(step_seed(seed, epoch, step, rank()))
            buf.append((step, host_batch, make_device_batch(
                host_batch, self._gen, self.device, train=train,
                mosaic_prob=mosaic_prob, mixup_prob=mixup_prob,
                pin_memory=pin)))
            if len(buf) >= depth:
                yield buf.popleft()
        while buf:
            yield buf.popleft()

    # ------------------------------------------------------------------
    def fit(self, train_loader, val_loader,
            epochs: Optional[int] = None) -> Dict[str, Any]:
        cfg = self.config.training
        ckpt_cfg = self.config.checkpoint
        epochs = epochs if epochs is not None else cfg.epochs
        self._epochs_total = epochs   # close_mosaic gating in _train_epoch
        start_epoch = int(self.state.epoch)
        # best-model tracking per checkpoint.best_model_metric/mode;
        # "val/loss" aliases "val/total_loss"
        metric_key = {"val/loss": "val/total_loss"}.get(
            ckpt_cfg.best_model_metric, ckpt_cfg.best_model_metric)
        sign = 1.0 if ckpt_cfg.best_model_mode == "min" else -1.0
        best_val = float("inf")
        best_epoch = None
        bad_epochs = 0
        if self.mesh is not None:
            _check_same_everywhere(
                [len(train_loader), len(val_loader)],
                "every rank's loaders must give as many batches")
        for epoch in range(start_epoch, epochs):
            t0 = time.time()
            train_metrics = self._train_epoch(train_loader, epoch)
            val_metrics, det_metrics = self._validate(val_loader, epoch)

            # plateau scheduler (torch ReduceLROnPlateau semantics)
            plateau = plateau_update(
                self.state.plateau, val_metrics["total_loss"],
                patience=cfg.learning_rate_patience,
                factor=cfg.learning_rate_factor, base_lr=self.base_lr)
            lr = float(self.base_lr * plateau.scale)
            self.state.plateau = plateau
            set_learning_rate(self.optimizer, lr)
            self.state.epoch = epoch + 1

            record = {
                **{f"train/{k}": v for k, v in train_metrics.items()},
                **{f"val/{k}": v for k, v in val_metrics.items()},
                **{f"val/{k}": v for k, v in det_metrics.items()},
                "lr": lr,
                "epoch_time_s": time.time() - t0,
            }
            self.history.append(record)
            if self.metrics_logger is not None:
                self.metrics_logger.log(record, step=epoch)
            self._log(
                f"epoch {epoch}: train_loss="
                f"{train_metrics['total_loss']:.4f} "
                f"val_loss={val_metrics['total_loss']:.4f} "
                f"P={det_metrics.get('precision', 0):.4f} "
                f"R={det_metrics.get('recall', 0):.4f} "
                f"mAP={det_metrics.get('mAP', 0):.4f} lr={lr:.2e} "
                f"({record['epoch_time_s']:.1f}s)")

            if (epoch + 1) % ckpt_cfg.save_interval == 0:
                self._checkpoint(epoch, {k: float(v)
                                         for k, v in record.items()})

            tracked = sign * float(record.get(
                metric_key, val_metrics["total_loss"]))
            if tracked < best_val - 1e-6:
                best_val = tracked
                best_epoch = epoch
                bad_epochs = 0
            else:
                bad_epochs += 1
                if bad_epochs > cfg.early_stopping_patience:
                    self._log(f"early stopping at epoch {epoch}")
                    break
        if self.ckpt is not None:
            self.ckpt.wait()
        return {"history": self.history,
                "best_val_loss": sign * best_val,
                "best_metric": sign * best_val,
                "best_metric_name": metric_key,
                "best_epoch": best_epoch}

    def _checkpoint(self, epoch: int, metrics: Dict[str, float]) -> None:
        """Save through the checkpoint manager, where this rank has one.
        Under fsdp the state is gathered whole by every rank (a
        collective), and the rank with the manager writes it."""
        if self.ckpt is not None:
            self.ckpt.save(epoch, self.state, metrics=metrics)
        elif self.state.eval_model is not None:
            self.state.state_dict()

    # ------------------------------------------------------------------
    def _train_epoch(self, loader, epoch: int) -> Dict[str, float]:
        cfg = self.config.training
        loader.set_epoch(epoch)
        # mosaic/mixup off for the final close_mosaic epochs
        total = getattr(self, "_epochs_total", cfg.epochs)
        heavy_aug = epoch < total - cfg.close_mosaic
        mosaic_prob = cfg.mosaic if cfg.mosaic > 0 and heavy_aug else 0.0
        mixup_prob = cfg.mixup if cfg.mixup > 0 and heavy_aug else 0.0
        sums: Dict[str, float] = {}
        count = 0
        pending = None
        for step, _, batch in self._device_batches(
                loader, self.config.project.seed, epoch,
                train=self.config.data.augment,
                mosaic_prob=mosaic_prob, mixup_prob=mixup_prob):
            self.state, metrics = self.train_step(self.state, batch)
            pending = metrics
            count += 1
            if (step + 1) % cfg.log_interval == 0:
                fetched = _fetch(metrics)
                for k, v in fetched.items():
                    sums[k] = sums.get(k, 0.0) + v * cfg.log_interval
                if self.metrics_logger is not None:
                    self.metrics_logger.log(
                        {f"step/{k}": v for k, v in fetched.items()},
                        step=self.state.step)
                pending = None
        if pending is not None:
            rem = count % cfg.log_interval or cfg.log_interval
            for k, v in _fetch(pending).items():
                sums[k] = sums.get(k, 0.0) + v * rem
        if count == 0:
            return {"total_loss": float("nan")}
        return {k: v / count for k, v in sums.items()}

    # ------------------------------------------------------------------
    def _validate(self, loader, epoch: int):
        det = DetectionMetrics(self.config.model.num_classes)
        sums: Dict[str, float] = {}
        count = 0
        for _, host_batch, batch in self._device_batches(
                loader, self.config.project.seed + 1, epoch, train=False):
            metrics, preds, anchors, strides = self.eval_step(self.state,
                                                              batch)
            for k, v in _fetch(metrics).items():
                sums[k] = sums.get(k, 0.0) + v
            pred_lists = decoded_to_lists(decode_predictions(
                preds, anchors, strides, reg_max=self.config.model.reg_max))
            gt_boxes = host_batch["gt_boxes"]
            gt_labels = host_batch["gt_labels"]
            gt_mask = host_batch["gt_mask"]
            sample_pad = host_batch.get(
                "sample_pad", np.zeros(gt_boxes.shape[0], bool))
            for i, plist in enumerate(pred_lists):
                if sample_pad[i]:
                    continue  # a repeat that pads the batch, not an image
                m = gt_mask[i]
                targets = np.concatenate(
                    [gt_boxes[i][m],
                     gt_labels[i][m, None].astype(np.float32)], axis=1)
                det.update(plist, targets)
            count += 1
        loss_metrics = ({k: v / count for k, v in sums.items()}
                        if count else {"total_loss": float("nan")})
        if self.mesh is not None:
            det.all_reduce()
            loss_metrics = reduce_metrics(loss_metrics)
        return loss_metrics, det.compute()


def _check_same_everywhere(values, what: str) -> None:
    """Raise on every rank unless each rank holds the same ``values``
    (their sum squared equals the world size times their sum of squares
    only when they are equal)."""
    values = np.asarray(values, np.float64)
    total, squares = reduce_value(np.stack([values, values * values]),
                                  average=False)
    if np.any(total * total != world_size() * squares):
        raise ValueError(f"{what}: this rank has {values.tolist()}, the "
                         f"sums over {world_size()} ranks are "
                         f"{total.tolist()}")
