"""Typed configuration of the training step (the port's own copy of the
dataclasses of ``custom_yolo_tpu/config.py`` that the step reads, with the
same fields and defaults). Loading from YAML comes with the trainer."""

from __future__ import annotations

import dataclasses
from typing import List, Tuple


@dataclasses.dataclass
class ModelConfig:
    input_size: Tuple[int, int] = (640, 640)
    num_classes: int = 172
    width: List[int] = dataclasses.field(
        default_factory=lambda: [3, 96, 192, 384, 768, 768])
    depth: List[int] = dataclasses.field(
        default_factory=lambda: [2, 2, 2, 2, 2, 2])
    csp: List[bool] = dataclasses.field(default_factory=lambda: [True, True])
    reg_max: int = 16  # DFL bins
    # kept for configuration parity: the port always trains through its
    # attention kernels on the card (one route per device), which is what
    # True selects in the JAX package
    pallas_attention: bool = False


@dataclasses.dataclass
class ShardingConfig:
    mode: str = "dp"                  # "dp" | "fsdp" | "single"
    fsdp_min_weight_size: int = 2 ** 16  # shard params >= this many elements
    precision: str = "bfloat16"       # compute dtype: bfloat16|float32


@dataclasses.dataclass
class TrainingConfig:
    is_test: bool = False
    batch_size: int = 4
    epochs: int = 1
    learning_rate: float = 1e-4
    weight_decay: float = 1e-4
    optimizer: str = "adamw"
    scheduler: str = "reduce_on_plateau"
    grad_clip: float = 1.0
    early_stopping_patience: int = 5
    learning_rate_patience: int = 3
    learning_rate_factor: float = 0.5
    lambda_cls: float = 1.0
    lambda_box: float = 1.5
    lambda_dfl: float = 1.5
    assigner: str = "nearest"         # "nearest" (reference parity) | "tal"
    accumulate_steps: int = 1         # gradient accumulation microbatches
    remat: bool = False               # rematerialize activations
    # EMA of params for validation/serving (0 = off; typical 0.9998)
    ema_decay: float = 0.0
    ema_tau: float = 2000.0           # warm-up ramp time constant (steps)
    # linear LR warm-up over the first N steps (0 = off); composes with the
    # plateau scheduler: effective lr = base · plateau_scale · ramp
    warmup_steps: int = 0
    # mosaic probability per sample and the number of final epochs trained
    # without it
    mosaic: float = 0.0
    close_mosaic: int = 10
    # mixup probability per sample, applied after mosaic
    mixup: float = 0.0
    log_interval: int = 10
    sharding: ShardingConfig = dataclasses.field(default_factory=ShardingConfig)
