"""Checkpoints of the full train state (counterpart of
``custom_yolo_tpu/utils/checkpoint.py``).

``model_epoch_{e}/`` holds ``state.pt`` (``torch.save`` of
:meth:`TrainState.state_dict`: the model with its BatchNorm statistics,
the optimizer's moments, step, epoch, plateau, EMA and the generator's
state) and ``metrics.json`` beside it. A ``model_config.json`` sidecar
records the architecture, precision and mode. Every epoch is kept unless
``max_to_keep`` says otherwise. Orbax checkpoints of the JAX package are
not read here.

The file holds the whole state whatever the mode that wrote it: under
fsdp ``TrainState.state_dict`` gathers the sharded values (every rank
takes part; the rank with the manager writes), and ``restore`` puts each
rank's shard of them into a sharded state, so a single, dp or fsdp
checkpoint resumes in any mode, as orbax's sharding-aware restore does
for the JAX package (``custom_yolo_tpu/utils/checkpoint.py:68-80``).
"""

from __future__ import annotations

import json
import os
import re
import shutil
import tempfile
from concurrent.futures import Future, ThreadPoolExecutor
from typing import Any, Dict, Optional, Tuple

import torch

from custom_yolo_tpu_torch.train.train_state import TrainState

CKPT_RE = re.compile(r"model_epoch_(\d+)$")
STATE_FILE = "state.pt"
METRICS_FILE = "metrics.json"
# Detector.save_weights: the flat state dict and the transforms sidecar
WEIGHTS_FILE = "weights.pt"
TRANSFORMS_FILE = "transforms.json"


def save_sidecar(checkpoint_dir: str, config: Dict[str, Any]) -> None:
    os.makedirs(checkpoint_dir, exist_ok=True)
    with open(os.path.join(checkpoint_dir, "model_config.json"), "w") as f:
        json.dump(config, f, indent=2)


def load_sidecar(checkpoint_dir: str) -> Optional[Dict[str, Any]]:
    path = os.path.join(checkpoint_dir, "model_config.json")
    if not os.path.exists(path):
        return None
    with open(path) as f:
        return json.load(f)


def find_weights(path: str) -> Tuple[Optional[str], str, Optional[int]]:
    """Where the weights under ``path`` are, as ``(kind, directory,
    epoch)``. ``path`` is a ``Detector.save_weights`` directory, a
    ``model_epoch_N`` directory, or a root whose latest ``model_epoch_N``
    is taken. ``kind`` is ``"weights"`` (``directory`` holds the
    ``transforms.json`` sidecar), ``"state"`` (a train-state checkpoint of
    ``epoch`` under the root ``directory``) or None (nothing there)."""
    path = os.path.normpath(path)
    if os.path.exists(os.path.join(path, TRANSFORMS_FILE)):
        return "weights", path, None
    m = CKPT_RE.match(os.path.basename(path))
    if m:
        root, epoch = os.path.dirname(path), int(m.group(1))
    else:
        names = os.listdir(path) if os.path.isdir(path) else []
        root, epoch = path, max((int(found.group(1)) for found in
                                 map(CKPT_RE.match, names) if found),
                                default=None)
    if epoch is None:
        return None, root, None
    epoch_dir = os.path.join(root, f"model_epoch_{epoch}")
    if os.path.exists(os.path.join(epoch_dir, TRANSFORMS_FILE)):
        return "weights", epoch_dir, None
    if os.path.exists(os.path.join(epoch_dir, STATE_FILE)):
        return "state", root, epoch
    return None, root, None


def restore_variables(root: str, epoch: int, live: bool = False
                      ) -> Tuple[Dict[str, torch.Tensor], int, str]:
    """The variables that serving reads from the train-state checkpoint of
    ``epoch`` under ``root``: the model's state dict with the EMA over it
    where the state tracks one, the live state dict with ``live``. The file
    is read onto the host; its optimizer part goes unused, and
    ``Detector.load_variables`` checks the keys. Returns (variables, the
    state's epoch, "EMA" or "live")."""
    state = torch.load(os.path.join(root, f"model_epoch_{epoch}",
                                    STATE_FILE),
                       map_location="cpu", weights_only=True)
    if live or state["ema"] is None:
        return state["model"], int(state["epoch"]), "live"
    return {**state["model"], **state["ema"]}, int(state["epoch"]), "EMA"


def host_copy(obj):
    """A copy of ``obj`` with every tensor copied to the host."""
    if isinstance(obj, torch.Tensor):
        return obj.detach().to("cpu", copy=True)
    if isinstance(obj, dict):
        return {k: host_copy(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(host_copy(v) for v in obj)
    return obj


class CheckpointManager:
    """Writes ``model_epoch_{e}`` directories. ``save`` copies the state to
    the host at once and writes it from a background thread; ``wait``
    waits for that write and raises its error, if any. A directory appears
    under its final name only once it is complete."""

    def __init__(self, checkpoint_dir: str,
                 max_to_keep: Optional[int] = None):
        self.directory = os.path.abspath(checkpoint_dir)
        os.makedirs(self.directory, exist_ok=True)
        self.max_to_keep = max_to_keep
        self._writer = ThreadPoolExecutor(max_workers=1,
                                          thread_name_prefix="checkpoint")
        self._pending: Optional[Future] = None

    def epoch_dir(self, epoch: int) -> str:
        return os.path.join(self.directory, f"model_epoch_{epoch}")

    def save(self, epoch: int, state: TrainState,
             metrics: Optional[Dict[str, float]] = None) -> None:
        self.wait()
        payload = host_copy(state.state_dict())
        self._pending = self._writer.submit(self._write, epoch, payload,
                                            metrics)

    def _write(self, epoch: int, payload: Dict[str, Any],
               metrics: Optional[Dict[str, float]]) -> None:
        tmp = tempfile.mkdtemp(prefix=f".model_epoch_{epoch}.",
                               dir=self.directory)
        torch.save(payload, os.path.join(tmp, STATE_FILE))
        if metrics is not None:
            with open(os.path.join(tmp, METRICS_FILE), "w") as f:
                json.dump(metrics, f, indent=2)
        final = self.epoch_dir(epoch)
        if os.path.isdir(final):
            shutil.rmtree(final)
        os.rename(tmp, final)
        self._prune()

    def _prune(self) -> None:
        if self.max_to_keep is None:
            return
        epochs = self.all_epochs()
        for epoch in epochs[:max(0, len(epochs) - self.max_to_keep)]:
            shutil.rmtree(self.epoch_dir(epoch))

    def all_epochs(self) -> list:
        found = []
        for name in os.listdir(self.directory):
            m = CKPT_RE.match(name)
            if m and os.path.exists(os.path.join(self.directory, name,
                                                 STATE_FILE)):
                found.append(int(m.group(1)))
        return sorted(found)

    def restore(self, state: TrainState,
                epoch: Optional[int] = None) -> TrainState:
        """Load the checkpoint of ``epoch`` (the latest when None) into
        ``state`` in place and return it. The file is read onto the host
        and copied into the state's own tensors, on whatever device they
        lie (not the one they were saved from); the optimizer's step
        counts stay on the host, where PyTorch keeps them."""
        self.wait()
        epoch = epoch if epoch is not None else self.latest_epoch()
        if epoch is None:
            raise FileNotFoundError(
                f"no checkpoint found under {self.directory}")
        payload = torch.load(os.path.join(self.epoch_dir(epoch), STATE_FILE),
                             map_location="cpu", weights_only=True)
        state.load_state_dict(payload)
        return state

    def latest_epoch(self) -> Optional[int]:
        epochs = self.all_epochs()
        return epochs[-1] if epochs else None

    def wait(self) -> None:
        pending, self._pending = self._pending, None
        if pending is not None:
            pending.result()

    def close(self) -> None:
        try:
            self.wait()
        finally:
            self._writer.shutdown()
