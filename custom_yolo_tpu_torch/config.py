"""Typed configuration (the port's own copy of ``custom_yolo_tpu/config.py``,
with the same fields, defaults, YAML mapping and errors).

A single YAML file in the reference's layout parses into typed dataclasses.
``yaml`` is imported only where a file is read or written.
"""

from __future__ import annotations

import dataclasses
import pathlib
from typing import Any, Dict, List, Optional, Tuple


def load_config(config_path: str = "configs/config.yaml") -> Dict[str, Any]:
    """The YAML file as a raw dict."""
    import yaml

    with open(config_path, "r") as f:
        return yaml.safe_load(f)


@dataclasses.dataclass
class ProjectConfig:
    name: str = "multi_class_object_detection"
    description: str = ""
    seed: int = 42
    num_classes: int = 172
    device: str = "tpu"
    distributed: bool = True
    mixed_precision: bool = True
    output_dir: str = "experiments"
    log_dir: str = "./dataset/experiments/run_logs"
    profile_dir: str = "./dataset/experiments/profiles"


@dataclasses.dataclass
class DataConfig:
    root_dir: str = "./dataset"
    raw_dir: str = "./dataset/raw"
    processed_dir: str = "./dataset/processed/parquet"
    metadata_dir: str = "./dataset/processed/metadata"
    annotations_dir: str = "./dataset/raw/annotations"
    train_parquet: str = "train"
    val_parquet: str = "val"
    train_images: str = "./dataset/raw/images/train"
    val_images: str = "./dataset/raw/images/val"
    # default image folder for examples/serve_folder.py (the reference's
    # test split directory, config.yaml:33)
    test_images: str = "./dataset/raw/images/test"
    num_workers: int = 8
    # pin_memory=True: the Trainer stages batch N+1 through pinned memory
    # (non-blocking copy) and augments it while batch N's step runs
    pin_memory: bool = True
    prefetch_factor: int = 2         # host-side decode-ahead queue depth
    is_test: bool = False
    # ragged ground truth is padded to this many slots per image
    max_gt_boxes: int = 128
    # aspect-preserving letterbox resize instead of the reference's squash
    # (transforms.py:9); geometry is emitted per-sample for inverse mapping
    letterbox: bool = False
    # stochastic train-time augmentation (flip/jitter). False =
    # deterministic preprocessing only (equivalence tests, ablations)
    augment: bool = True


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
    # recompute the backbone's and neck's activations in the backward pass
    # (torch.utils.checkpoint): less memory for more arithmetic
    remat: bool = False
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


@dataclasses.dataclass
class WandbConfig:
    enable: bool = False
    project_name: str = "hpc_project"
    entity: Optional[str] = None
    run_name: str = "training_run"
    log_frequency: int = 1
    mode: str = "disabled"


@dataclasses.dataclass
class CheckpointConfig:
    save_interval: int = 1
    resume_training: bool = False
    best_model_metric: str = "val/loss"
    best_model_mode: str = "min"
    checkpoint_dir: str = "./dataset/experiments/checkpoints"
    # None = keep every saved epoch, matching the reference's
    # save_checkpoint (src/training/utils_train.py:49 — never prunes).
    # Set a number to bound disk for long runs.
    max_to_keep: Optional[int] = None


@dataclasses.dataclass
class LoggingConfig:
    console_log: bool = True
    file_log: bool = False
    log_level: str = "INFO"


@dataclasses.dataclass
class Config:
    project: ProjectConfig = dataclasses.field(default_factory=ProjectConfig)
    data: DataConfig = dataclasses.field(default_factory=DataConfig)
    model: ModelConfig = dataclasses.field(default_factory=ModelConfig)
    training: TrainingConfig = dataclasses.field(default_factory=TrainingConfig)
    wandb: WandbConfig = dataclasses.field(default_factory=WandbConfig)
    checkpoint: CheckpointConfig = dataclasses.field(
        default_factory=CheckpointConfig)
    logging: LoggingConfig = dataclasses.field(default_factory=LoggingConfig)

    @classmethod
    def from_yaml(cls, path: str) -> "Config":
        return cls.from_dict(load_config(path))

    @classmethod
    def from_dict(cls, raw: Dict[str, Any]) -> "Config":
        def build(dc_cls, section: Dict[str, Any]):
            fields = {f.name: f for f in dataclasses.fields(dc_cls)}
            kwargs = {}
            for key, value in (section or {}).items():
                if key not in fields:
                    continue  # tolerate legacy keys (e.g. fsdp/ddp blocks)
                f = fields[key]
                if dataclasses.is_dataclass(f.type) or (
                        isinstance(f.type, str)
                        and f.type in _NESTED_TYPES):
                    kwargs[key] = build(_NESTED_TYPES[str(f.type).split(".")[-1]
                                        if isinstance(f.type, str) else
                                        f.type.__name__], value)
                else:
                    kwargs[key] = value
            return dc_cls(**kwargs)

        raw = dict(raw or {})
        # Reference nests the arch preset under model.config
        # (config.yaml:53); flatten it.
        model_raw = dict(raw.get("model") or {})
        preset = model_raw.pop("config", None)
        if isinstance(preset, dict):
            model_raw.update({k: preset[k] for k in ("csp", "depth", "width")
                              if k in preset})
        raw["model"] = model_raw

        # Map the reference's fsdp/fsdp2/ddp precision blocks
        # (config.yaml:73-83) onto the unified sharding config.
        training_raw = dict(raw.get("training") or {})
        sharding_raw = dict(training_raw.pop("sharding", {}) or {})
        for legacy_mode, new_mode in (("ddp", "dp"), ("fsdp", "fsdp"),
                                      ("fsdp2", "fsdp")):
            block = training_raw.pop(legacy_mode, None)
            if isinstance(block, dict) and "precision" in block and \
                    "precision" not in sharding_raw:
                if sharding_raw.get("mode", "dp") == new_mode or \
                        legacy_mode == "ddp":
                    sharding_raw.setdefault("precision", block["precision"])
        weights = training_raw.pop("weights", None)
        if isinstance(weights, dict):
            training_raw.setdefault("lambda_cls", weights.get("cls_loss", 1.0))
            training_raw.setdefault("lambda_box", weights.get("bbox_loss", 1.5))
        training_raw["sharding"] = sharding_raw

        cfg = cls(
            project=build(ProjectConfig, raw.get("project")),
            data=build(DataConfig, raw.get("data")),
            model=build(ModelConfig, raw.get("model")),
            training=dataclasses.replace(
                build(TrainingConfig, training_raw),
                sharding=build(ShardingConfig, sharding_raw)),
            wandb=build(WandbConfig, raw.get("wandb")),
            checkpoint=build(CheckpointConfig, raw.get("checkpoint")),
            logging=build(LoggingConfig, raw.get("logging")),
        )
        cfg.validate()
        return cfg

    def validate(self) -> None:
        m = self.model
        if len(m.width) != 6:
            raise ValueError(f"model.width must have 6 entries, got {m.width}")
        if len(m.depth) != 6:
            raise ValueError(f"model.depth must have 6 entries, got {m.depth}")
        if len(m.csp) != 2:
            raise ValueError(f"model.csp must have 2 entries, got {m.csp}")
        if self.training.sharding.mode not in ("dp", "fsdp", "single"):
            raise ValueError(
                f"unknown sharding mode {self.training.sharding.mode}")
        if self.training.assigner not in ("nearest", "tal"):
            raise ValueError(f"unknown assigner {self.training.assigner}")
        if self.checkpoint.best_model_mode not in ("min", "max"):
            raise ValueError(
                f"best_model_mode must be min|max, got "
                f"{self.checkpoint.best_model_mode}")
        # project-level switches override the detailed knobs (these keys are
        # decorative in the reference — SURVEY §5; here they act):
        if not self.project.distributed:
            self.training.sharding.mode = "single"
        if not self.project.mixed_precision:
            self.training.sharding.precision = "float32"

    def to_dict(self) -> Dict[str, Any]:
        return dataclasses.asdict(self)

    def save(self, path: str) -> None:
        import yaml

        pathlib.Path(path).parent.mkdir(parents=True, exist_ok=True)
        with open(path, "w") as f:
            yaml.safe_dump(self.to_dict(), f, sort_keys=False)


_NESTED_TYPES = {
    "ShardingConfig": ShardingConfig,
}
