"""The plain reference held to the program's CPU path at a small size (the
n preset), in fp32, where both compute the same arithmetic: the served
forward (BatchNorm folded by each on its own) and its detections, and
the train step's loss, first gradient and change. The weights, frames and
batches are the benchmark's own."""

import time

import torch

from perfbench import core
from perfbench.reference import detect
from perfbench.reference.model import Reference, decode, fold, state_layout
from perfbench.run import Run
from perfbench.traffic import serve, train
from perfbench.weights import frames, make_state, settle_statistics

CPU = torch.device("cpu")


def config(size=128):
    cfg = core.load_json(core.BENCH / "configs" / "n640.json")
    cfg["input_size"] = [size, size]
    cfg["precision"] = "float32"
    return cfg


def test_layout_is_the_programs_state_dict():
    from custom_yolo_tpu_torch.models.detector import YoloModel

    for name in ("n640", "x640"):
        cfg = core.load_json(core.BENCH / "configs" / f"{name}.json")
        layout = state_layout(cfg["width"], cfg["depth"], cfg["csp"],
                              cfg["num_classes"], cfg["reg_max"])
        with torch.device("meta"):
            model = YoloModel(cfg["width"], cfg["depth"], cfg["csp"],
                              cfg["num_classes"], cfg["reg_max"])
        assert {k: tuple(v.shape) for k, v in
                model.state_dict().items()} == layout


def test_serving_forward_and_detections_match_the_program():
    cfg = config()
    layout = state_layout(cfg["width"], cfg["depth"], cfg["csp"],
                          cfg["num_classes"], cfg["reg_max"])
    images = frames(3, (2, 128, 128, 3), CPU, pinned=False)
    state = settle_statistics(make_state(layout, 3, CPU), cfg, [images])
    det = serve.build_detector(cfg, state, CPU)
    seen = {}
    det.model.register_forward_hook(
        lambda m, i, o: seen.__setitem__("preds", o[0]))
    res = det.serve(images, device_preprocess=True, conf_thres=0.001,
                    iou_thres=0.45, top_k=1024, max_det=300)
    ref = Reference(cfg["width"], cfg["depth"], cfg["csp"],
                    cfg["num_classes"], cfg["reg_max"], mode="eval")
    x = ((images.float() / 255.0) - torch.tensor([0.485, 0.456, 0.406])) \
        / torch.tensor([0.229, 0.224, 0.225])
    with torch.no_grad():
        preds, anchors, strides = ref(fold(state), x)
    assert torch.allclose(seen["preds"], preds, rtol=1e-4, atol=1e-4)
    boxes, logits = decode(preds, anchors, strides, cfg["reg_max"])
    dets = detect.nms(boxes, logits, 0.001, 0.45, 1024, 300)
    for k in range(2):
        n = int(res.num_valid[k])
        assert n == len(dets[k]["anchor"])
        gaps = detect.image_gaps(res.boxes[k, :n], res.scores[k, :n],
                                 res.classes[k, :n], boxes[k], logits[k],
                                 strides, dets[k], 300)
        assert len(gaps["gap"]) == n
        assert float(gaps["gap"].max()) < 1e-3
        assert gaps["unmatched"] == 0 and gaps["counted"] > n


def test_train_step_matches_the_program():
    cfg = config(96)
    mix = core.load_json(core.BENCH / "mixes" / "train_b16.json")
    mix.update(batch=2, slots=8)
    cell = {"config": cfg, "mix": mix}
    r = Run(cell, seed=5, seconds=0.01, trace=False, device=CPU,
            t_start=time.time())
    r.limits = {name: float("inf") for name in train.CANDIDATES}
    numbers = {c["name"]: c["value"] for c in train.run(r)["compared"]}
    assert numbers["preds1_gap"] < 1e-5, numbers
    assert numbers["loss_gap"] < 1e-4, numbers
    assert numbers["grad_median_gap"] < 1e-4, numbers
    assert numbers["grad_gap"] < 1e-2, numbers
    assert numbers["delta_gap"] < 1e-2, numbers


def test_overlapping_pairs_of_one_class():
    """Greedy NMS keeps no pair of one class above the threshold: pairs
    are counted above it by more than the rounding band, and boxes of two
    classes never overlap."""
    boxes = torch.tensor([[0.0, 0.0, 10.0, 10.0],
                          [1.0, 0.0, 11.0, 10.0],     # IoU 9/11 with 0
                          [0.0, 0.0, 10.0, 10.0],     # class 1
                          [50.0, 50.0, 60.0, 60.0]])
    classes = torch.tensor([0, 0, 1, 0])
    assert detect.overlapping_pairs(boxes, classes, 0.45) == 1
    assert detect.overlapping_pairs(boxes, classes, 0.85) == 0
    # IoU 9/11 just above a threshold set at it: inside the band
    iou = 9 / 11 * (1 - 2 ** -12)
    assert detect.overlapping_pairs(boxes, classes, iou) == 0
    assert detect.overlapping_pairs(boxes[:0], classes[:0], 0.45) == 0
