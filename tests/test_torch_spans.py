"""The port's own spans (``utils.profiling.span``) on the CPU, n at 160²,
B=2: under ``utils.profiling.trace`` one ``Detector.serve`` call holds one
``serve`` span with its four phases and a ``fwd/<stage>`` span a stage
inside the forward, and one train step (TAL, EMA) holds ``train/step``
with its seven phases; with no profiler running neither enters a
``record_function`` of its own; the exported serving graph holds no
profiler op."""

import json
import os

import pytest
import torch

from custom_yolo_tpu_torch import Detector
from custom_yolo_tpu_torch.config import TrainingConfig
from custom_yolo_tpu_torch.export import export_serving
from custom_yolo_tpu_torch.models.detector import create_train_model
from custom_yolo_tpu_torch.models.presets import PRESETS
from custom_yolo_tpu_torch.train.losses import DetectionLoss, LossConfig
from custom_yolo_tpu_torch.train.optim import build_optimizer
from custom_yolo_tpu_torch.train.train_state import TrainState
from custom_yolo_tpu_torch.train.train_step import make_train_step
from custom_yolo_tpu_torch.utils import profiling

torch.set_num_threads(2)

N = PRESETS["n"]
NC = 5
HW = 160
BATCH = 2
SERVE_PHASES = ("serve/input", "serve/forward", "serve/decode", "serve/nms")
TRAIN_PHASES = ("train/forward", "train/loss", "train/backward",
                "train/clip", "train/optimizer", "train/ema")


@pytest.fixture(scope="module")
def detector():
    det = Detector(N["width"], N["depth"], N["csp"], NC, precision="float32",
                   input_size=(HW, HW), device="cpu")
    det.init(seed=0)
    return det.fuse()


@pytest.fixture(scope="module")
def frames():
    return torch.randint(0, 256, (BATCH, HW, HW, 3), dtype=torch.uint8,
                         generator=torch.Generator().manual_seed(0))


def _train_step():
    """A fresh n model, its AdamW state with an EMA, the TAL step and a
    batch of four boxes an image."""
    model = create_train_model(N["width"], N["depth"], N["csp"], NC,
                               precision="float32", device="cpu", seed=0)
    optimizer = build_optimizer(model.parameters(), TrainingConfig())
    state = TrainState.create(model, optimizer,
                              torch.Generator().manual_seed(1), ema=True)
    step = make_train_step(model, DetectionLoss(LossConfig(
        num_classes=NC, assigner="tal")), optimizer, ema_decay=0.9)
    g = torch.Generator().manual_seed(2)
    batch = {"images": torch.rand(BATCH, HW, HW, 3, generator=g),
             "gt_boxes": torch.rand(BATCH, 4, 4, generator=g) * 60 + 20,
             "gt_labels": torch.randint(0, NC, (BATCH, 4), generator=g),
             "gt_mask": torch.ones(BATCH, 4, dtype=torch.bool)}
    return step, state, batch


def _spans(tmp_path, fn):
    """The ``user_annotation`` events of a trace of ``fn()``."""
    with profiling.trace(str(tmp_path)):
        fn()
    with open(os.path.join(tmp_path, profiling.TRACE_FILE)) as f:
        events = json.load(f)["traceEvents"]
    return [e for e in events if e.get("cat") == "user_annotation"]


def _one(spans, name):
    found = [e for e in spans if e["name"] == name]
    assert len(found) == 1, (name, len(found))
    return found[0]


def _inside(inner, outer):
    return (outer["ts"] <= inner["ts"]
            and inner["ts"] + inner["dur"] <= outer["ts"] + outer["dur"])


def _stage_spans(model):
    return {f"fwd/{part}.{name}" for part in ("net", "fpn")
            for name, _ in getattr(model, part).named_children()} | {
        "fwd/head"}


def test_serve_call_holds_its_spans(tmp_path, detector, frames):
    spans = _spans(tmp_path, lambda: detector.serve(
        frames, conf_thres=0.001, device_preprocess=True))
    serve = _one(spans, "serve")
    phases = {name: _one(spans, name) for name in SERVE_PHASES}
    assert all(_inside(p, serve) for p in phases.values())
    order = [phases[name]["ts"] for name in SERVE_PHASES]
    assert order == sorted(order)
    stages = _stage_spans(detector.model)
    assert len(stages) == 18
    for name in stages:
        assert _inside(_one(spans, name), phases["serve/forward"]), name
    assert {e["name"] for e in spans} == {"serve", *SERVE_PHASES, *stages}


def test_train_step_holds_its_spans(tmp_path):
    step, state, batch = _train_step()
    spans = _spans(tmp_path, lambda: step(state, batch))
    whole = _one(spans, "train/step")
    phases = {name: _one(spans, name) for name in TRAIN_PHASES}
    assert all(_inside(p, whole) for p in phases.values())
    order = [phases[name]["ts"] for name in TRAIN_PHASES]
    assert order == sorted(order)
    assert _inside(_one(spans, "train/assign"), phases["train/loss"])
    assert _inside(_one(spans, "fwd/head"), phases["train/forward"])
    # torch.optim's own spans sit inside the step's optimizer phase
    assert all(_inside(e, phases["train/optimizer"]) for e in spans
               if e["name"].startswith("Optimizer.step#"))


def test_no_record_function_without_a_profiler(monkeypatch, detector,
                                                frames):
    entered = []
    enter = torch.ops.profiler._record_function_enter_new

    def counting(name, *args):
        entered.append(name)
        return enter(name, *args)

    monkeypatch.setattr(torch.ops.profiler, "_record_function_enter_new",
                        counting)
    with torch.profiler.record_function("probe"):
        pass
    assert entered == ["probe"]        # the count sees a record_function
    entered.clear()
    with profiling.span("probe"):
        pass
    detector.serve(frames, conf_thres=0.001, device_preprocess=True)
    assert entered == []
    step, state, batch = _train_step()
    step(state, batch)
    # only torch.optim's own, which it enters whether or not a profiler runs
    assert entered and all(name.startswith("Optimizer.")
                           for name in entered), entered


def test_exported_serving_graph_holds_no_profiler_op(tmp_path, detector):
    path = export_serving(detector, str(tmp_path / "serving"),
                          batch_size=BATCH, conf_thres=0.001)
    program = torch.export.load(os.path.join(path, "serving.pt2"))
    targets = {str(node.target) for node in program.graph.nodes
               if node.op == "call_function"}
    assert any("nms" in t for t in targets)
    assert not [t for t in targets if "profiler" in t or "record" in t]
