"""The port's evaluation path against the JAX package, on the CPU:
``decode_predictions`` (with and without NMS, tied scores included),
``decoded_to_lists``, ``DetectionMetrics`` and ``COCOmAP`` on the same
random streams, and the path as a whole — a small model's eval forward,
decode and metrics in both packages.

Inputs come from numpy seeds; tolerances are stated where they are used.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from custom_yolo_tpu.eval.coco_map import COCOmAP as JaxCOCOmAP
from custom_yolo_tpu.eval.decode import (
    decode_predictions as jax_decode_predictions,
    decoded_to_lists as jax_decoded_to_lists)
from custom_yolo_tpu.eval.metrics import (
    DetectionMetrics as JaxDetectionMetrics,
    compute_average_iou as jax_compute_average_iou)
from custom_yolo_tpu.models import Detector as JaxDetector
from custom_yolo_tpu.ops.anchors import make_anchors as jax_make_anchors
from custom_yolo_tpu_torch import Detector
from custom_yolo_tpu_torch.eval import (COCOmAP, DetectionMetrics,
                                        decode_predictions)
from custom_yolo_tpu_torch.eval.decode import decoded_to_lists
from custom_yolo_tpu_torch.eval.metrics import compute_average_iou
from custom_yolo_tpu_torch.ops.anchors import make_anchors

from test_torch_model import (CSP, DEPTH, HW, NC, WIDTH, perturbed_variables,
                              to_numpy_tree)

torch.set_num_threads(2)

SHAPES, STRIDES = [(8, 8), (4, 4), (2, 2)], [8, 16, 32]
REG_MAX = 16


def _raw_predictions(n=3, nc=5, seed=0, tied=True):
    """Raw head output ``(n, 84, 4·16 + nc)``. With ``tied`` the class
    logits lie on a coarse grid, so many anchors share one best score and
    the order among them shows."""
    rng = np.random.RandomState(seed)
    dist = rng.randn(n, 84, 4 * REG_MAX).astype(np.float32) * 2
    logits = rng.randn(n, 84, nc).astype(np.float32)
    if tied:
        logits = np.round(logits * 1.5) / 1.5
    return np.concatenate([dist, logits], axis=-1)


def _jax_decode(*args, use_nms, **kw):
    """The JAX ``decode_predictions``. With ``use_nms`` its own ``jit``
    hands the traced threshold to ``batched_nms``, which wants it static,
    and fails; the same function is then run without that outer ``jit``."""
    fn = jax_decode_predictions.__wrapped__ if use_nms \
        else jax_decode_predictions
    return fn(*args, use_nms=use_nms, **kw)


def _assert_decoded_equal(got, want):
    """Boxes to 1e-4 px and 1e-5 relative (the DFL softmax sums in another
    order), scores to 1e-6, classes and validity exactly — which also pins
    the order among equal scores."""
    np.testing.assert_array_equal(got.valid.numpy(), np.asarray(want.valid))
    np.testing.assert_array_equal(got.classes.numpy(),
                                  np.asarray(want.classes))
    assert got.classes.dtype == torch.int32
    np.testing.assert_allclose(got.scores.numpy(), np.asarray(want.scores),
                               atol=1e-6, rtol=0)
    np.testing.assert_allclose(got.boxes_xywh.numpy(),
                               np.asarray(want.boxes_xywh), atol=1e-4,
                               rtol=1e-5)


@pytest.mark.parametrize("use_nms", [False, True], ids=["plain", "nms"])
@pytest.mark.parametrize("conf,top_k", [(0.7, 100), (0.8, 10)])
def test_decode_predictions_matches_jax(use_nms, conf, top_k):
    preds = _raw_predictions()
    anchors_j, strides_j = jax_make_anchors(SHAPES, STRIDES)
    anchors_t, strides_t = make_anchors(SHAPES, STRIDES)
    want = _jax_decode(jnp.asarray(preds), anchors_j, strides_j,
                       conf_threshold=conf, top_k=top_k, use_nms=use_nms)
    got = decode_predictions(torch.from_numpy(preds), anchors_t, strides_t,
                             conf_threshold=conf, top_k=top_k,
                             use_nms=use_nms)
    assert got.boxes_xywh.shape == (3, min(top_k, 84), 4)
    assert got.valid.any() and (top_k < 100 or not got.valid.all())
    _assert_decoded_equal(got, want)
    for a, b in zip(decoded_to_lists(got), jax_decoded_to_lists(want)):
        assert a.shape == b.shape and a.shape[1] == 5
        np.testing.assert_allclose(a, b, atol=1e-4, rtol=1e-5)


def test_decode_keeps_the_gate_fill_and_score_floor():
    """Nothing passes a gate of 0.99: every slot is invalid with score 0
    (the −1 fill never shows), in the lowest-index order."""
    preds = _raw_predictions(n=2, tied=False, seed=1)
    anchors, strides = make_anchors(SHAPES, STRIDES)
    got = decode_predictions(torch.from_numpy(preds), anchors, strides,
                             conf_threshold=0.99, top_k=200)
    assert got.scores.shape == (2, 84)                 # top_k capped at M
    assert not got.valid.any() and float(got.scores.abs().max()) == 0.0
    want = jax_decode_predictions(jnp.asarray(preds),
                                  *jax_make_anchors(SHAPES, STRIDES),
                                  conf_threshold=0.99, top_k=200)
    _assert_decoded_equal(got, want)


def _random_scene(rng, nc, n_pred, n_gt):
    """Predictions jittered off the ground truth, plus strays."""
    gt = np.concatenate([rng.rand(n_gt, 2) * 200 + 28,
                         rng.rand(n_gt, 2) * 120 + 6,
                         rng.randint(0, nc, (n_gt, 1))], axis=1)
    near = gt[rng.randint(0, max(n_gt, 1), n_pred)].copy() if n_gt else \
        np.zeros((0, 5))
    near[:, :4] += rng.randn(len(near), 4) * 6
    flip = rng.rand(len(near)) < 0.15
    near[flip, 4] = rng.randint(0, nc, int(flip.sum()))
    stray = np.concatenate([rng.rand(3, 2) * 256, rng.rand(3, 2) * 90 + 4,
                            rng.randint(0, nc, (3, 1))], axis=1)
    preds = np.concatenate([near, stray]).astype(np.float32)
    preds[:, 2:4] = np.abs(preds[:, 2:4]) + 1
    scores = rng.rand(len(preds)).astype(np.float32)
    return preds, scores, gt.astype(np.float32)


def _scenes(seed, nc, count=24):
    rng = np.random.RandomState(seed)
    scenes = [_random_scene(rng, nc, rng.randint(0, 12), rng.randint(0, 8))
              for _ in range(count)]
    # an image with neither predictions nor targets, and one of each alone
    empty = np.zeros((0, 5), np.float32)
    scenes.append((empty, np.zeros(0, np.float32), empty))
    scenes.append((empty, np.zeros(0, np.float32), scenes[0][2]))
    scenes.append((scenes[1][0], scenes[1][1], empty))
    return scenes


@pytest.mark.parametrize("with_scores", [False, True])
def test_detection_metrics_match_jax(with_scores):
    nc = 6
    ours, theirs = DetectionMetrics(nc), JaxDetectionMetrics(nc)
    for preds, scores, gt in _scenes(3, nc):
        kw = dict(pred_scores=scores, score_threshold=0.3) \
            if with_scores else {}
        ours.update(preds, gt, **kw)
        theirs.update(preds, gt, **kw)
    got, want = ours.compute(), theirs.compute()
    assert got == want and got["true_positives"] > 0       # equal dicts
    assert got["false_positives"] > 0 and got["false_negatives"] > 0
    for cls in range(nc):
        assert ours.get_class_metrics(cls) == theirs.get_class_metrics(cls)
    # in one process both packages' all_reduce leave the counters as they are
    assert ours.all_reduce() is ours and theirs.all_reduce() is theirs
    assert ours.compute() == theirs.compute() == got
    ours.reset()
    assert ours.compute()["total_predictions"] == 0


def test_average_iou_matches_jax():
    scenes = _scenes(4, 5)
    preds = [s[0] for s in scenes]
    gts = [s[2] for s in scenes]
    assert compute_average_iou(preds, gts) == jax_compute_average_iou(
        preds, gts)


@pytest.mark.parametrize("crowd", [False, True])
def test_coco_map_matches_jax(crowd):
    nc = 6
    ours, theirs = COCOmAP(nc), JaxCOCOmAP(nc)
    rng = np.random.RandomState(9)
    for preds, scores, gt in _scenes(5, nc, count=40):
        flags = (rng.rand(len(gt)) < 0.2) if crowd else None
        ours.update(preds, scores, gt, flags)
        theirs.update(preds, scores, gt, flags)
    got, want = ours.compute(), theirs.compute()
    assert got == want                                      # equal dicts
    assert set(got) >= {"mAP_50_95", "mAP_50", "AR_100", "mAP_small"}
    assert 0 < got["mAP_50"] < 1


def test_eval_path_matches_jax():
    """The path as a whole: one set of variables, an eval forward in each
    package, decode, lists, and both metrics on the same targets. The gate
    sits in the widest gap of the JAX scores near rank 20, away from any
    score that the 1e-5 between the two forwards could move across it."""
    jax_det = JaxDetector(WIDTH, DEPTH, CSP, num_classes=NC,
                          precision="float32", input_size=(HW, HW))
    jax_det.init(seed=7)
    variables = perturbed_variables(to_numpy_tree(
        jax.device_get(jax_det.variables)), seed=7)
    jax_det.load_variables(variables)
    port = Detector(WIDTH, DEPTH, CSP, NC, precision="float32",
                    input_size=(HW, HW), device="cpu")
    port.load_variables(variables)
    x = np.random.RandomState(17).randn(4, HW, HW, 3).astype(np.float32)
    out_j = jax_det(jnp.asarray(x))
    out_t = port(x)
    best = np.sort(np.asarray(jax.nn.sigmoid(out_j[0][..., 64:])).max(-1),
                   axis=None)[::-1]
    gaps = best[10:40] - best[11:41]
    at = 10 + int(gaps.argmax())
    conf = float((best[at] + best[at + 1]) / 2)
    assert gaps.max() > 1e-4

    rng = np.random.RandomState(18)
    for use_nms in (False, True):
        dec_j = _jax_decode(*out_j, conf_threshold=conf, use_nms=use_nms)
        dec_t = decode_predictions(*out_t, conf_threshold=conf,
                                   use_nms=use_nms)
        _assert_decoded_equal(dec_t, dec_j)
        lists_t, lists_j = decoded_to_lists(dec_t), jax_decoded_to_lists(dec_j)
        assert sum(len(a) for a in lists_t) > 0
        ours, theirs = DetectionMetrics(NC), JaxDetectionMetrics(NC)
        coco_t, coco_j = COCOmAP(NC), JaxCOCOmAP(NC)
        for i, (a, b) in enumerate(zip(lists_t, lists_j)):
            # targets: this image's own detections, some shifted, so that
            # true and false positives both occur
            gt = np.array(b[: max(1, len(b) // 2)], np.float32)
            gt[:, :2] += rng.randn(len(gt), 2).astype(np.float32)
            ours.update(a, gt)
            theirs.update(b, gt)
            valid = dec_t.valid[i].numpy()
            coco_t.update(a, dec_t.scores[i].numpy()[valid], gt)
            coco_j.update(b, np.asarray(dec_j.scores[i])[valid], gt)
        counters = ("true_positives", "false_positives", "false_negatives",
                    "total_predictions", "total_ground_truths")
        got, want = ours.compute(), theirs.compute()
        assert {k: got[k] for k in counters} == {k: want[k] for k in counters}
        assert got["true_positives"] > 0
        # AP from boxes that agree to 1e-4 px: 1e-6
        got, want = coco_t.compute(), coco_j.compute()
        for key in want:
            assert abs(got[key] - want[key]) <= 1e-6, key
