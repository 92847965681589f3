"""The port's trainer and checkpoints against the JAX package, on the
CPU.

``Trainer.fit`` of both packages runs two fp32 epochs over one fixture from
one carried mid-training state; a resumed run is held bit for bit to an
unbroken one. Every tolerance is stated where it is used.
"""

import json
import os

import numpy as np
import pytest
import torch

from custom_yolo_tpu import config as jax_config
from custom_yolo_tpu.core.dtypes import resolve_policy as jax_policy
from custom_yolo_tpu.data.dataset import DetectionDataset as JaxDataset
from custom_yolo_tpu.data.loader import DataLoader as JaxLoader
from custom_yolo_tpu.models import YoloModel as JaxYoloModel
from custom_yolo_tpu.train.trainer import Trainer as JaxTrainer
from custom_yolo_tpu_torch import config as port_config
from custom_yolo_tpu_torch.data.dataset import DetectionDataset
from custom_yolo_tpu_torch.data.loader import DataLoader
from custom_yolo_tpu_torch.models.detector import create_train_model
from custom_yolo_tpu_torch.train.trainer import Trainer, step_seed
from custom_yolo_tpu_torch.utils.checkpoint import (CheckpointManager,
                                                    load_sidecar,
                                                    save_sidecar)
from custom_yolo_tpu_torch.utils.weights import train_state_from_jax
from test_torch_train import _jax_state_as_numpy, _mid_training_state
from torch_project import make_project, random_jax_variables

torch.set_num_threads(2)

WIDTH = [3, 8, 16, 32, 64, 64]
DEPTH = [1, 1, 1, 1, 1, 1]
CSP = [False, True]
NC = 3
HW = 64


def _raw_config(**training):
    return {
        "project": {"num_classes": NC, "seed": 0},
        "model": {"num_classes": NC, "input_size": [HW, HW],
                  "config": {"csp": CSP, "depth": DEPTH, "width": WIDTH}},
        "data": {"augment": False, "pin_memory": True, "num_workers": 2},
        "training": {"batch_size": 4, "epochs": 2, "log_interval": 1,
                     "learning_rate": 2e-3, "ema_decay": 0.99,
                     "ema_tau": 30.0, "warmup_steps": 60,
                     "assigner": "nearest", "learning_rate_patience": 0,
                     "early_stopping_patience": 0,
                     "sharding": {"mode": "single",
                                  "precision": "float32"},
                     **training},
    }


@pytest.fixture(scope="module")
def project(tmp_path_factory):
    return make_project(tmp_path_factory.mktemp("proj"), [(96, 96)] * 8)


def _loaders(project, dataset_cls, loader_cls):
    ds = dataset_cls(str(project / "parquet" / "val"),
                     str(project / "images"), input_size=(HW, HW), max_gt=8)
    return (loader_cls(ds, 4, shuffle=True, drop_last=True, num_workers=2,
                       seed=0, use_native=False),
            loader_cls(ds, 4, shuffle=False, drop_last=False,
                       num_workers=2, seed=0, use_native=False))


def _port_model(cfg, seed=0):
    return create_train_model(cfg.model.width, cfg.model.depth,
                              cfg.model.csp, cfg.model.num_classes,
                              precision="float32", device="cpu", seed=seed)


# ------------------------------------------------------------ fit vs JAX
def test_fit_tracks_jax_trainer(project):
    """Two fp32 epochs, no augmentation, nearest assigner, EMA and warm-up
    on, from one mid-training state carried into both packages (fresh
    AdamW moments would turn the fp32 noise of gradients that are zero in
    exact arithmetic into ±lr steps). Per-epoch train and validation
    total_loss within 3e-4 relative (the whole-step limit of
    tests/test_torch_train.py), ``lr`` equal, the detection metrics equal
    (1e-4 where non-zero), the history keys, ``best_epoch`` and the epoch
    training stopped at equal."""
    raw = _raw_config()
    cfg_j = jax_config.Config.from_dict(raw)
    model_j = JaxYoloModel(tuple(WIDTH), tuple(DEPTH), tuple(CSP), NC,
                           policy=jax_policy("float32"))
    variables = random_jax_variables(model_j, HW, seed=0)
    trainer_j = JaxTrainer(cfg_j, model_j, variables)
    mid = _mid_training_state(variables, trainer_j.tx)
    # before the JAX steps donate its buffers
    carried = _jax_state_as_numpy(mid)
    trainer_j.load_state(mid)
    result_j = trainer_j.fit(*_loaders(project, JaxDataset, JaxLoader))

    cfg = port_config.Config.from_dict(raw)
    trainer = Trainer(cfg, _port_model(cfg))
    trainer.load_state(train_state_from_jax(carried, trainer.model,
                                            trainer.optimizer))
    result = trainer.fit(*_loaders(project, DetectionDataset, DataLoader))

    assert len(result["history"]) == len(result_j["history"]) >= 1
    assert result["best_epoch"] == result_j["best_epoch"]
    assert result["best_metric_name"] == result_j["best_metric_name"]
    for rec, rec_j in zip(result["history"], result_j["history"]):
        assert set(rec) == set(rec_j)
        for key in ("train/total_loss", "val/total_loss"):
            np.testing.assert_allclose(rec[key], rec_j[key], rtol=3e-4,
                                       err_msg=key)
        assert rec["lr"] == rec_j["lr"]
        for key, value in rec_j.items():
            if key.startswith("val/") and "loss" not in key:
                np.testing.assert_allclose(rec[key], value, atol=1e-4,
                                           rtol=1e-4, err_msg=key)
    assert trainer.state.epoch == int(trainer_j.state.epoch)
    assert trainer.state.step == int(trainer_j.state.step)


# --------------------------------------------------------- resume, exactly
def _snapshot(trainer):
    state = trainer.state
    moments = {f"{i}.{k}": v.clone()
               for i, s in enumerate(trainer.optimizer.state.values())
               for k, v in s.items()}
    return ({k: v.clone() for k, v in trainer.model.state_dict().items()},
            {k: v.clone() for k, v in state.ema.items()}, moments,
            state.plateau, state.step, state.epoch)


def test_resumed_fit_is_bit_identical(project, tmp_path):
    """With mosaic, mixup, flip and jitter on: two epochs straight against
    one epoch → checkpoint → a new Trainer on a new model → restore →
    one more epoch. Parameters, BatchNorm statistics, EMA, AdamW moments,
    plateau state and the epoch's losses are bit-identical."""
    raw = _raw_config(mosaic=0.5, mixup=0.5, close_mosaic=0,
                      learning_rate_patience=3, early_stopping_patience=5)
    raw["data"]["augment"] = True
    cfg = port_config.Config.from_dict(raw)
    loaders = _loaders(project, DetectionDataset, DataLoader)
    straight = Trainer(cfg, _port_model(cfg),
                       checkpoint_manager=CheckpointManager(
                           str(tmp_path / "ck")))
    history = straight.fit(*loaders)["history"]
    assert len(history) == 2
    resumed_ckpt = CheckpointManager(str(tmp_path / "ck"))
    assert resumed_ckpt.all_epochs() == [0, 1]
    resumed = Trainer(cfg, _port_model(cfg, seed=9))
    resumed.load_state(resumed_ckpt.restore(resumed.state, epoch=0))
    assert resumed.state.epoch == 1
    again = resumed.fit(*loaders)["history"]
    assert len(again) == 1
    for key in ("train/total_loss", "val/total_loss", "lr"):
        assert again[0][key] == history[1][key], key
    want, got = _snapshot(straight), _snapshot(resumed)
    for w, g in zip(want[:3], got[:3]):
        assert set(w) == set(g)
        for key in w:
            assert torch.equal(w[key], g[key]), key
    for w, g in zip(want[3], got[3]):
        assert torch.equal(w, g)
    assert want[4:] == got[4:]
    # the generator was reseeded per step: another epoch draws otherwise
    assert step_seed(0, 0, 1) != step_seed(0, 1, 0) != step_seed(1, 0, 0)


def test_checkpoint_round_trip_keeps_ema_and_statistics(tmp_path):
    """A saved state restores into another model's state bit for bit: EMA
    (parameters and statistics), BatchNorm statistics, AdamW moments, step,
    epoch, plateau, the generator; metrics beside it; every epoch kept by
    default, the oldest pruned under ``max_to_keep``. A trainer in dp or
    fsdp mode in one process steps as ``single`` does."""
    cfg = port_config.Config.from_dict(_raw_config())
    src = Trainer(cfg, _port_model(cfg))
    with torch.no_grad():
        for i, value in enumerate(src.state.ema.values()):
            value.fill_(7.0 + i)
        for name, buf in src.model.named_buffers():
            if name.endswith("running_var"):
                buf.uniform_(0.5, 1.5)
    src.state.step, src.state.epoch = 12, 3
    src.state.rng.manual_seed(123)
    ckpt = CheckpointManager(str(tmp_path / "ck"), max_to_keep=2)
    for epoch in range(3):
        ckpt.save(epoch, src.state, metrics={"val/total_loss": 1.5})
    ckpt.wait()
    assert ckpt.all_epochs() == [1, 2] and ckpt.latest_epoch() == 2
    with open(os.path.join(ckpt.epoch_dir(2), "metrics.json")) as f:
        assert json.load(f) == {"val/total_loss": 1.5}
    dst = Trainer(cfg, _port_model(cfg, seed=4))
    restored = ckpt.restore(dst.state)
    assert restored is dst.state
    for key, value in src.state.ema.items():
        assert torch.equal(restored.ema[key], value), key
    for key, value in src.model.state_dict().items():
        assert torch.equal(dst.model.state_dict()[key], value), key
    assert restored.eval_variables is restored.ema
    assert (restored.step, restored.epoch) == (12, 3)
    assert torch.equal(restored.rng.get_state(), src.state.rng.get_state())
    ckpt.close()
    with pytest.raises(FileNotFoundError):
        CheckpointManager(str(tmp_path / "empty")).restore(dst.state)
    save_sidecar(str(tmp_path / "ck"), {"width": WIDTH})
    assert load_sidecar(str(tmp_path / "ck")) == {"width": WIDTH}
    with pytest.raises(ValueError, match="another model"):
        Trainer(cfg, _port_model(cfg)).load_state(dst.state)
    # dp and fsdp in one process train as single, as the JAX trainer does
    # on one device: one step of each equals single's, bit for bit
    batch = {"images": torch.rand(4, HW, HW, 3,
                                  generator=torch.Generator().manual_seed(5)),
             "gt_boxes": torch.full((4, 2, 4), 20.0),
             "gt_labels": torch.tensor([[0, 1]] * 4),
             "gt_mask": torch.ones(4, 2, dtype=torch.bool)}
    stepped = {}
    for mode in ("single", "dp", "fsdp"):
        raw = _raw_config()
        raw["training"]["sharding"]["mode"] = mode
        trainer = Trainer(port_config.Config.from_dict(raw), _port_model(cfg))
        assert trainer.mesh is None and trainer.state.module is None
        _, metrics = trainer.train_step(trainer.state, batch)
        stepped[mode] = (metrics, trainer.model.state_dict())
    for mode in ("dp", "fsdp"):
        for key, value in stepped["single"][0].items():
            assert torch.equal(stepped[mode][0][key], value), (mode, key)
        for key, value in stepped["single"][1].items():
            assert torch.equal(stepped[mode][1][key], value), (mode, key)
