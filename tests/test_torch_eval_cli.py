"""``scripts/torch_evaluate.py`` against ``scripts/evaluate.py``, both run
in-process on the CPU over one fixture with the same fp32 weights (saved
by each package's ``Detector.save_weights``): the greedy metrics and COCO
mAP must be equal (counts exact, floats within 1e-6) and non-zero. Also:
the port decodes with the config's ``reg_max`` where the JAX script
decodes with 16, restores EMA or live weights from a train-state
checkpoint, refuses a checkpoint path with nothing under it, and runs the
int8 paths."""

import json
import math
import sys

import numpy as np
import pytest
import torch
import yaml

from custom_yolo_tpu.eval import coco_map as jax_coco_map
from custom_yolo_tpu.eval import decode as jax_decode
from custom_yolo_tpu.eval import metrics as jax_metrics
from custom_yolo_tpu.models import Detector as JaxDetector
from custom_yolo_tpu.models import YoloModel as JaxYoloModel
from custom_yolo_tpu_torch import Detector
from custom_yolo_tpu_torch.config import Config
from custom_yolo_tpu_torch.train.optim import build_optimizer
from custom_yolo_tpu_torch.train.train_state import TrainState
from custom_yolo_tpu_torch.utils.checkpoint import CheckpointManager

from test_torch_model import perturbed_variables
from torch_project import load_script, make_project, random_jax_variables

torch.set_num_threads(2)

WIDTH = (3, 8, 16, 32, 64, 256)
DEPTH = (2, 1, 1, 1, 2, 1)
CSP = (True, True)
NC = 3
HW = 64
SIZES = [(96, 80), (80, 96), (64, 64), (120, 72)] * 2
TOL = 1e-6


def confident_boxes(variables, reg_max=16):
    """The box branch's output biases set so that each side's distribution
    peaks at one to two strides (boxes the size of the fixture's ground
    truth) and the class logits' near -1 (scores around 0.27), so that
    random weights still match some of the ground truth."""
    bias = np.full(reg_max, -2.0, np.float32)
    bias[1:3] = (3.0, 2.0)
    for i in range(3):
        head = variables["params"]["head"]
        head[f"box{i}_out"]["bias"] = np.tile(bias, 4)
        head[f"cls{i}_out"]["bias"] = np.full(NC, -1.0, np.float32)
    return variables


@pytest.fixture(scope="module")
def project(tmp_path_factory):
    return make_project(tmp_path_factory.mktemp("evalproj"), SIZES,
                        boxes_per_image=3, seed=2)


def write_config(tmp_path, project, reg_max=16, **training):
    raw = {"project": {"num_classes": NC, "seed": 0},
           "model": {"num_classes": NC, "input_size": [HW, HW],
                     "reg_max": reg_max,
                     "config": {"csp": list(CSP), "depth": list(DEPTH),
                                "width": list(WIDTH)}},
           "data": {"processed_dir": str(project / "parquet"),
                    "val_parquet": "val",
                    "val_images": str(project / "images"),
                    "max_gt_boxes": 8},
           "training": {"batch_size": 4,
                        "sharding": {"mode": "single",
                                     "precision": "float32"}, **training},
           "checkpoint": {"checkpoint_dir": str(tmp_path / "none")}}
    path = tmp_path / f"cfg_{reg_max}.yaml"
    path.write_text(yaml.safe_dump(raw))
    return str(path)


@pytest.fixture(scope="module")
def weights(tmp_path_factory):
    """The same fp32 variables saved by the JAX and by the port's
    ``Detector.save_weights``, as ``model_epoch_0`` directories."""
    root = tmp_path_factory.mktemp("weights")
    variables = confident_boxes(perturbed_variables(random_jax_variables(
        JaxYoloModel(WIDTH, DEPTH, CSP, NC), HW, seed=3), seed=3))
    jax_det = JaxDetector(WIDTH, DEPTH, CSP, NC, precision="float32",
                          input_size=(HW, HW))
    jax_det.load_variables(variables)
    jax_det.save_weights(str(root / "jax" / "model_epoch_0"))
    port = Detector(WIDTH, DEPTH, CSP, NC, precision="float32",
                    input_size=(HW, HW), device="cpu")
    port.load_variables(variables)
    port.save_weights(str(root / "port" / "model_epoch_0"))
    return root


def run_jax(monkeypatch, argv, reg_max=None):
    """``scripts/evaluate.py``'s ``main`` with ``argv``; returns the
    results its ``DetectionMetrics`` and ``COCOmAP`` computed. Its
    ``decode_predictions(use_nms=True)`` fails under its own ``jit`` (a
    traced threshold reaches a static argument), so that call runs the
    undecorated function here. A ``reg_max`` is passed to its decode,
    which the script calls with the default 16."""
    record = {}
    for cls, key in ((jax_metrics.DetectionMetrics, "metrics"),
                     (jax_coco_map.COCOmAP, "coco")):
        def compute(self, _orig=cls.compute, _key=key):
            record[_key] = _orig(self)
            return record[_key]
        monkeypatch.setattr(cls, "compute", compute)
    jitted = jax_decode.decode_predictions

    def decode(*args, **kw):
        if reg_max is not None:
            kw["reg_max"] = reg_max
        return (jitted.__wrapped__ if kw.get("use_nms") else jitted)(
            *args, **kw)
    monkeypatch.setattr(jax_decode, "decode_predictions", decode)
    monkeypatch.setattr(sys, "argv", ["evaluate.py"] + argv)
    load_script("evaluate").main()
    return record


def assert_results_equal(got, want):
    assert got.keys() == want.keys()
    for key, value in want.items():
        if isinstance(value, (int, np.integer)):
            assert got[key] == value, key
        else:
            assert abs(got[key] - value) <= TOL, (key, got[key], value)


@pytest.mark.parametrize("flags", [
    [], ["--use_nms", "--coco_map"],
    ["--coco_map", "--model_coords", "--ref_box_convention"]],
    ids=["plain", "nms_coco", "model_coords_ref_boxes"])
def test_evaluate_cli_matches_jax(project, weights, tmp_path, monkeypatch,
                                  flags):
    cfg = write_config(tmp_path, project)
    common = ["--config", cfg, "--device", "cpu", "--conf_threshold",
              "0.3"] + flags
    got = load_script("torch_evaluate").main(
        common + ["--checkpoint", str(weights / "port" / "model_epoch_0")])
    want = run_jax(monkeypatch, common + [
        "--checkpoint", str(weights / "jax" / "model_epoch_0")])
    assert got["images"] == len(SIZES)
    # a comparison of zeros would prove nothing
    assert got["metrics"]["true_positives"] > 0
    assert got["metrics"]["false_positives"] > 0
    assert_results_equal(got["metrics"], want["metrics"])
    if "--coco_map" in flags:
        assert got["coco"]["mAP_50"] > 0 and got["coco"]["AR_100"] > 0
        assert_results_equal(got["coco"], want["coco"])


def test_evaluate_cli_decodes_at_the_configs_reg_max(project, tmp_path,
                                                     monkeypatch):
    """At ``reg_max = 8`` the port's metrics equal those of the JAX script
    whose decode is held at the config's ``reg_max`` (JAX's model on the
    same carried weights). The JAX script as it stands decodes at its
    default 16, which on these ``4 * 8 + 3`` channels cannot reshape."""
    cfg_path = write_config(tmp_path, project, reg_max=8)
    variables = confident_boxes(perturbed_variables(random_jax_variables(
        JaxYoloModel(WIDTH, DEPTH, CSP, NC, reg_max=8), HW, seed=4),
        seed=4), reg_max=8)
    jax_det = JaxDetector(WIDTH, DEPTH, CSP, NC, reg_max=8,
                          precision="float32", input_size=(HW, HW))
    jax_det.load_variables(variables)
    jax_det.save_weights(str(tmp_path / "jax" / "model_epoch_0"))
    port = Detector(WIDTH, DEPTH, CSP, NC, reg_max=8, precision="float32",
                    input_size=(HW, HW), device="cpu")
    port.load_variables(variables)
    port.save_weights(str(tmp_path / "port" / "model_epoch_0"))
    common = ["--config", cfg_path, "--device", "cpu", "--conf_threshold",
              "0.2"]
    got = load_script("torch_evaluate").main(
        common + ["--checkpoint", str(tmp_path / "port" / "model_epoch_0")])
    jax_argv = common + ["--checkpoint",
                         str(tmp_path / "jax" / "model_epoch_0")]
    with pytest.raises(TypeError, match="reshape"):
        run_jax(monkeypatch, jax_argv)
    monkeypatch.undo()
    want = run_jax(monkeypatch, jax_argv, reg_max=8)
    assert got["metrics"]["true_positives"] > 0
    assert_results_equal(got["metrics"], want["metrics"])


def test_evaluate_cli_restores_ema_or_live_weights(project, tmp_path,
                                                   capsys):
    """A train-state checkpoint: the EMA weights by default, the live ones
    with ``--no_ema``, each scored as the same weights through a
    ``save_weights`` directory are; a ``--checkpoint`` with nothing under
    it is refused."""
    cfg_path = write_config(tmp_path, project, ema_decay=0.9)
    cfg = Config.from_yaml(cfg_path)
    from custom_yolo_tpu_torch.models.detector import create_train_model
    model = create_train_model(WIDTH, DEPTH, CSP, NC, precision="float32",
                               device="cpu", seed=5)
    state = TrainState.create(model, build_optimizer(model.parameters(),
                                                     cfg.training),
                              torch.Generator(), ema=True)
    gen = torch.Generator().manual_seed(6)
    with torch.no_grad():
        for value in state.ema.values():
            value.add_(0.05 * torch.randn(value.shape, generator=gen))
    manager = CheckpointManager(str(tmp_path / "ck"))
    manager.save(0, state)
    manager.close()
    evaluate = load_script("torch_evaluate")
    for flags, variables in (([], state.ema), (["--no_ema"],
                                               state.variables)):
        got = evaluate.main(["--config", cfg_path, "--device", "cpu",
                             "--checkpoint", str(tmp_path / "ck"),
                             "--conf_threshold", "0.01"] + flags)
        det = Detector(WIDTH, DEPTH, CSP, NC, precision="float32",
                       input_size=(HW, HW), device="cpu")
        det.load_variables(variables)
        det.save_weights(str(tmp_path / "w"))
        want = evaluate.main(["--config", cfg_path, "--device", "cpu",
                              "--checkpoint", str(tmp_path / "w"),
                              "--conf_threshold", "0.01"])
        assert got["metrics"] == want["metrics"]
        assert got["metrics"]["total_predictions"] > 0
    assert "restored epoch 0" in capsys.readouterr().out
    assert state.ema is not None and not torch.equal(
        state.ema["net.p1_conv.conv.weight"],
        state.variables["net.p1_conv.conv.weight"])
    with pytest.raises(SystemExit, match="refusing"):
        evaluate.main(["--config", cfg_path, "--device", "cpu",
                       "--checkpoint", str(tmp_path / "nothing")])


@pytest.mark.parametrize("mode", ["dynamic", "static"])
def test_evaluate_cli_int8(project, weights, tmp_path, capsys, mode):
    """``--quantize dynamic|static`` evaluates the int8 serving path
    (static scales calibrated on the first batch); its metrics are finite,
    it prints the JAX script's lines, and its ``[INFO] results:`` line
    holds what ``main`` returns."""
    cfg = write_config(tmp_path, project)
    got = load_script("torch_evaluate").main(
        ["--config", cfg, "--device", "cpu", "--checkpoint",
         str(weights / "port" / "model_epoch_0"), "--conf_threshold", "0.3",
         "--quantize", mode, "--calib_batches", "1", "--coco_map"])
    out = capsys.readouterr().out
    printed = [line for line in out.splitlines()
               if line.startswith("[INFO] results: ")]
    assert [json.loads(line[len("[INFO] results: "):])
            for line in printed] == [got]
    assert ("calibrated on 1 batches" in out) == (mode == "static")
    assert "images in" in out and "  mAP_50_95: " in out
    assert "kernel launches" in out
    assert got["metrics"]["total_predictions"] > 0
    assert all(math.isfinite(v) for v in got["metrics"].values())
    assert all(math.isfinite(v) for v in got["coco"].values())
