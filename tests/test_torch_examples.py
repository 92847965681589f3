"""The port's examples against the JAX package's, on the CPU, each run
in-process (the JAX examples read ``sys.argv``): ``--help`` of the three;
``examples/torch_serve_folder.py`` against ``examples/serve_folder.py``
and ``examples/torch_inference_demo.py`` against
``examples/inference_demo.py`` on the same fp32 weights of the n preset at
64²; ``examples/torch_train_smoke.py``'s synthetic batch against the JAX
example's, and its steps from that batch and from the config's data.
The JAX examples' own random init (~25 s of eager dispatch for the n
model on the CPU) is replaced by seeded weights of the same tree
(``shape_only_init``): the examples overwrite them from the checkpoint,
or (train_smoke) only their batch is compared.

Tolerances: detection counts and classes exact, boxes within 1e-3 px,
scores within 1e-5 (both sides run one fp32 forward on the CPU, whose
outputs agree to ~1e-6, ``tests/test_torch_eval_cli.py``); the synthetic
batch byte for byte."""

import json
import math
import os
import sys

import jax
import numpy as np
import pytest
import torch
import yaml

import custom_yolo_tpu.train.train_step as jax_train_step
from custom_yolo_tpu.models import Detector as JaxDetector
from custom_yolo_tpu.models import YoloModel as JaxYoloModel
from custom_yolo_tpu.train.optim import build_optimizer as jax_optimizer
from custom_yolo_tpu.train.train_state import TrainState as JaxTrainState
from custom_yolo_tpu.utils.checkpoint import \
    CheckpointManager as JaxCheckpointManager
from custom_yolo_tpu_torch import PRESETS, Detector
from custom_yolo_tpu_torch.config import Config
from custom_yolo_tpu_torch.models.detector import create_train_model
from custom_yolo_tpu_torch.train.optim import build_optimizer
from custom_yolo_tpu_torch.train.train_state import TrainState
from custom_yolo_tpu_torch.utils.checkpoint import CheckpointManager
from custom_yolo_tpu_torch.utils.weights import from_jax_variables

from test_torch_model import perturbed_variables
from torch_project import load_script, make_project, random_jax_variables

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N = PRESETS["n"]
WIDTH, DEPTH, CSP = N["width"], N["depth"], N["csp"]
NC = 3
HW = 64
SIZES = [(96, 80), (80, 96), (64, 64), (120, 72), (70, 90), (100, 100)]
BOX_TOL = 1e-3
SCORE_TOL = 1e-5
EXAMPLES = ("torch_train_smoke", "torch_inference_demo",
            "torch_serve_folder")


def confident(variables, reg_max=16):
    """Box distributions that peak at one to two strides and class
    logits near -1 (scores around 0.27), so that random weights detect
    boxes above the examples' 0.25 gate."""
    bias = np.full(reg_max, -2.0, np.float32)
    bias[1:3] = (3.0, 2.0)
    for i in range(3):
        head = variables["params"]["head"]
        head[f"box{i}_out"]["bias"] = np.tile(bias, 4)
        head[f"cls{i}_out"]["bias"] = np.full(NC, -1.0, np.float32)
    return variables


def n_variables(seed, detect=True):
    variables = perturbed_variables(random_jax_variables(
        JaxYoloModel(WIDTH, DEPTH, CSP, NC), HW, seed=seed), seed=seed)
    return confident(variables) if detect else variables


@pytest.fixture(scope="module")
def project(tmp_path_factory):
    return make_project(tmp_path_factory.mktemp("examples"), SIZES,
                        boxes_per_image=2, seed=4)


def write_config(tmp_path, project, **training):
    raw = {"project": {"num_classes": NC, "seed": 0},
           "model": {"num_classes": NC, "input_size": [HW, HW],
                     "config": {"csp": list(CSP), "depth": list(DEPTH),
                                "width": list(WIDTH)}},
           "data": {"processed_dir": str(project / "parquet"),
                    "train_parquet": "val",
                    "train_images": str(project / "images"),
                    "test_images": str(project / "images"),
                    "max_gt_boxes": 8},
           "training": {"sharding": {"mode": "single",
                                     "precision": "float32"}, **training},
           "checkpoint": {"checkpoint_dir": str(tmp_path / "none")}}
    path = tmp_path / "cfg.yaml"
    path.write_text(yaml.safe_dump(raw))
    return str(path)


def shape_only_init(monkeypatch):
    """JAX's ``Detector.init`` and ``YoloModel.init`` give seeded numpy
    weights of their variable tree, traced by ``jax.eval_shape`` without
    compiling or running the init."""
    traced = JaxYoloModel.init

    def model_init(self, rng, x, train=False):
        shapes = jax.eval_shape(
            lambda r, v: traced(self, r, v, train=train), rng, x)
        return jax.tree_util.tree_map(
            lambda leaf: np.zeros(leaf.shape, leaf.dtype), shapes)

    def detector_init(self, seed=0, batch_size=1):
        self.variables = random_jax_variables(self.module,
                                              self.input_size[0], seed)
        return self.variables

    monkeypatch.setattr(JaxDetector, "init", detector_init)
    monkeypatch.setattr(JaxYoloModel, "init", model_init)


def run_jax_example(monkeypatch, name, argv):
    monkeypatch.setattr(sys, "argv", [f"{name}.py"] + argv)
    load_script(name, "examples").main()


def assert_detections_close(got, want):
    """(n, 6) [x1, y1, x2, y2, conf, cls] rows, in the same order."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    np.testing.assert_array_equal(got[:, 5], want[:, 5])
    np.testing.assert_allclose(got[:, :4], want[:, :4], rtol=0,
                               atol=BOX_TOL)
    np.testing.assert_allclose(got[:, 4], want[:, 4], rtol=0,
                               atol=SCORE_TOL)


@pytest.mark.parametrize("name", EXAMPLES)
def test_example_help(name, capsys):
    with pytest.raises(SystemExit) as exit_info:
        load_script(name, "examples").main(["--help"])
    assert exit_info.value.code == 0
    out = capsys.readouterr().out
    assert "usage" in out.lower() and "--device" in out


def test_serve_folder_matches_jax(project, tmp_path, monkeypatch):
    """6 JPEGs at B=4 (the last batch padded), weights saved by the JAX
    ``Detector`` and carried to the port: the same files, detection
    counts and classes, boxes within 1e-3 px, scores within 1e-5."""
    cfg = write_config(tmp_path, project)
    jax_det = JaxDetector(WIDTH, DEPTH, CSP, NC, precision="float32",
                          input_size=(HW, HW))
    jax_det.load_variables(n_variables(seed=5))
    jax_det.save_weights(str(tmp_path / "jax_w"))
    port = Detector(WIDTH, DEPTH, CSP, NC, precision="float32",
                    input_size=(HW, HW), device="cpu")
    port.load_variables(jax_det.variables)
    port.save_weights(str(tmp_path / "port_w"))
    common = ["--config", cfg, "--images", str(project / "images"),
              "--batch_size", "4"]
    got = load_script("torch_serve_folder", "examples").main(
        common + ["--checkpoint", str(tmp_path / "port_w"), "--device",
                  "cpu", "--out", str(tmp_path / "port.json")])
    with open(tmp_path / "port.json") as f:
        assert json.load(f) == got
    shape_only_init(monkeypatch)
    run_jax_example(monkeypatch, "serve_folder", common + [
        "--checkpoint", str(tmp_path / "jax_w"), "--out",
        str(tmp_path / "jax.json")])
    with open(tmp_path / "jax.json") as f:
        want = json.load(f)
    assert list(got) == list(want) and len(got) == len(SIZES)
    assert sum(len(v) for v in got.values()) > 0
    for name, dets in want.items():
        assert_detections_close(
            [d["bbox_xyxy"] + [d["score"], d["class_id"]]
             for d in got[name]],
            [d["bbox_xyxy"] + [d["score"], d["class_id"]] for d in dets])


def test_inference_demo_deploys_the_ema(project, tmp_path, monkeypatch,
                                        capsys):
    """A train-state checkpoint of each package holding the same live and
    EMA weights: both demos restore it, deploy the EMA (the live weights
    detect nothing here), fuse and detect the same boxes on one image."""
    cfg_path = write_config(tmp_path, project, ema_decay=0.9)
    cfg = Config.from_yaml(cfg_path)
    live, ema = n_variables(seed=6, detect=False), n_variables(seed=7)
    image = str(project / "images" / "img_001.jpg")

    # the JAX package's checkpoint (orbax) at epoch 3
    tx = jax_optimizer(cfg.training)
    jax_state = jax.device_get(JaxTrainState.create(
        live, tx, jax.random.key(0), ema=True)).replace(
        ema_params=ema["params"], ema_batch_stats=ema["batch_stats"],
        epoch=np.asarray(3, np.int32))
    manager = JaxCheckpointManager(str(tmp_path / "jax_ck"))
    manager.save(2, jax_state)
    manager.wait()
    # the port's (state.pt)
    model = create_train_model(WIDTH, DEPTH, CSP, NC, precision="float32",
                               device="cpu", variables=live)
    state = TrainState.create(model, build_optimizer(model.parameters(),
                                                     cfg.training),
                              torch.Generator(), ema=True)
    ema_state = from_jax_variables(ema, model)
    with torch.no_grad():
        for key, value in state.ema.items():
            value.copy_(ema_state[key])
    state.epoch = 3
    port_manager = CheckpointManager(str(tmp_path / "port_ck"))
    port_manager.save(2, state)
    port_manager.close()

    common = ["--config", cfg_path, "--image", image, "--fuse"]
    got = load_script("torch_inference_demo", "examples").main(
        common + ["--checkpoint", str(tmp_path / "port_ck"), "--device",
                  "cpu"])
    assert "[INFO] restored epoch 3" in capsys.readouterr().out
    seen = []
    original = JaxDetector.inference

    def inference(self, *args, **kwargs):
        seen.append(original(self, *args, **kwargs)[0])
        return [seen[-1]]
    monkeypatch.setattr(JaxDetector, "inference", inference)
    shape_only_init(monkeypatch)
    run_jax_example(monkeypatch, "inference_demo", common + [
        "--checkpoint", str(tmp_path / "jax_ck")])
    assert "[INFO] restored epoch 3" in capsys.readouterr().out
    assert len(got) > 0
    assert_detections_close(got, seen[0])
    live_det = Detector(WIDTH, DEPTH, CSP, NC, precision="float32",
                        input_size=(HW, HW), device="cpu")
    live_det.load_variables(live)
    assert len(live_det.fuse().inference(image)[0]) == 0


def test_train_smoke_synthetic_batch_and_steps(tmp_path, monkeypatch):
    """The synthetic batch equals the JAX example's byte for byte (its
    step is replaced by one that records the batch), and three of the
    port's steps from it give finite losses."""
    config = os.path.join(REPO, "configs", "config.yaml")
    seen = []

    def recording_step(*_args, **_kwargs):
        def step(state, batch):
            seen.append(jax.device_get(batch))
            zero = np.float32(0)
            return state, {"total_loss": zero, "box_loss": zero,
                           "cls_loss": zero}
        return step
    monkeypatch.setattr(jax_train_step, "make_train_step", recording_step)
    shape_only_init(monkeypatch)
    argv = ["--config", config, "--synthetic", "--preset", "n",
            "--input_size", str(HW), "--batch_size", "2"]
    run_jax_example(monkeypatch, "train_smoke", argv + ["--steps", "1"])
    smoke = load_script("torch_train_smoke", "examples")
    mine = smoke.synthetic_batch(2, (HW, HW),
                                 Config.from_yaml(config).model.num_classes)
    assert mine.keys() == seen[0].keys()
    for key, value in seen[0].items():
        assert mine[key].dtype == value.dtype, key
        assert mine[key].tobytes() == np.asarray(value).tobytes(), key
    history = smoke.main(argv + ["--steps", "3", "--device", "cpu"])
    assert len(history) == 3
    assert all(math.isfinite(v) for m in history for v in m.values())


def test_train_smoke_reads_the_configs_data(project, tmp_path, capsys):
    """Without ``--synthetic`` the steps read the config's parquet and
    JPEGs through the loader and ``make_device_batch``."""
    cfg = write_config(tmp_path, project)
    history = load_script("torch_train_smoke", "examples").main(
        ["--config", cfg, "--input_size", str(HW), "--batch_size", "2",
         "--steps", "2", "--device", "cpu"])
    assert len(history) == 2
    assert all(math.isfinite(v) for m in history for v in m.values())
    out = capsys.readouterr().out
    assert "step 0: total=" in out and "2 steps," in out
