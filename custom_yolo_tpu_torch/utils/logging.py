"""Experiment logging (the port's own copy of
``custom_yolo_tpu/utils/logging.py``): console and file logging driven by
the config's ``logging`` section, TensorBoard through ``tensorboardX`` and
wandb, each imported only when asked for and a silent no-op where it is
not installed."""

from __future__ import annotations

import logging
import os
import time
from typing import Any, Dict, Optional


def setup_console_logging(level: str = "INFO", log_dir: Optional[str] = None,
                          file_log: bool = False) -> logging.Logger:
    logger = logging.getLogger("custom_yolo_tpu_torch")
    logger.setLevel(getattr(logging, level.upper(), logging.INFO))
    logger.propagate = False
    if not logger.handlers:
        fmt = logging.Formatter(
            "%(asctime)s %(levelname)s %(name)s: %(message)s")
        sh = logging.StreamHandler()
        sh.setFormatter(fmt)
        logger.addHandler(sh)
        if file_log and log_dir:
            os.makedirs(log_dir, exist_ok=True)
            fh = logging.FileHandler(
                os.path.join(log_dir, f"train_{int(time.time())}.log"))
            fh.setFormatter(fmt)
            logger.addHandler(fh)
    return logger


class MetricsLogger:
    """Fan-out of step and epoch metrics to TensorBoard and wandb."""

    def __init__(self, wandb_config=None, log_dir: Optional[str] = None,
                 run_name: str = "run", enabled: bool = True,
                 config_dict: Optional[Dict[str, Any]] = None):
        self.enabled = enabled
        self._tb = None
        self._wandb = None
        if not enabled:
            return
        if log_dir:
            try:
                from tensorboardX import SummaryWriter
                self._tb = SummaryWriter(os.path.join(log_dir, run_name))
            except ImportError:
                self._tb = None
        if wandb_config is not None and getattr(wandb_config, "enable", False):
            try:
                import wandb
                self._wandb = wandb.init(
                    project=wandb_config.project_name,
                    entity=wandb_config.entity,
                    name=f"{run_name}_{time.strftime('%Y%m%d_%H%M%S')}",
                    mode=wandb_config.mode,
                    config=config_dict)
            except ImportError:
                self._wandb = None

    def log_summary(self, text: str, name: str = "model_summary") -> None:
        """Attach the model summary to the run: TensorBoard text and a wandb
        artifact."""
        if not self.enabled:
            return
        if self._tb is not None:
            self._tb.add_text(name, f"```\n{text}\n```")
        if self._wandb is not None:
            import tempfile

            import wandb
            art = wandb.Artifact(name, type="model-summary")
            with tempfile.TemporaryDirectory() as tmp:
                path = os.path.join(tmp, f"{name}.txt")
                with open(path, "w") as f:
                    f.write(text)
                art.add_file(path, name=f"{name}.txt")
                self._wandb.log_artifact(art)

    def log(self, metrics: Dict[str, float], step: int) -> None:
        if not self.enabled:
            return
        if self._tb is not None:
            for key, value in metrics.items():
                self._tb.add_scalar(key, float(value), step)
        if self._wandb is not None:
            self._wandb.log(metrics, step=step)

    def close(self) -> None:
        if self._tb is not None:
            self._tb.close()
        if self._wandb is not None:
            self._wandb.finish()
