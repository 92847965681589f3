"""The port's training slice against the JAX package, on the CPU.

The same numpy-seeded inputs go through the JAX function and its
counterpart in ``custom_yolo_tpu_torch``: the attention backward twin
against the Pallas backward kernel (interpret mode) and against
``jax.grad`` of the einsum reference, training-mode ConvBN against flax,
both assigners, the detection loss with its gradient, the plateau
schedule, and whole fp32 train steps from carried weights. Every tolerance
is stated where it is used.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from custom_yolo_tpu.config import TrainingConfig as JaxTrainingConfig
from custom_yolo_tpu.core.dtypes import resolve_policy as jax_policy
from custom_yolo_tpu.models import YoloModel as JaxYoloModel
from custom_yolo_tpu.nn.blocks import ConvBN as JaxConvBN
from custom_yolo_tpu.ops import boxes as jax_boxes
from custom_yolo_tpu.ops.anchors import make_anchors as jax_make_anchors
from custom_yolo_tpu.ops.dfl import (
    dfl_expectation_matmul as jax_dfl_expectation_matmul)
from custom_yolo_tpu.ops.pallas.attention_kernel import (
    _psa_attention_bwd_pallas, psa_attention_reference as jax_attention_ref)
from custom_yolo_tpu.train import assigner as jax_assigner
from custom_yolo_tpu.train import optim as jax_optim
from custom_yolo_tpu.train.losses import (DetectionLoss as JaxDetectionLoss,
                                          LossConfig as JaxLossConfig)
from custom_yolo_tpu.train.train_state import TrainState as JaxTrainState
from custom_yolo_tpu.train.train_step import (
    make_eval_step as jax_make_eval_step,
    make_train_step as jax_make_train_step)
from custom_yolo_tpu_torch import Detector
from custom_yolo_tpu_torch.config import (ModelConfig, ShardingConfig,
                                          TrainingConfig)
from custom_yolo_tpu_torch.models.detector import create_train_model
from custom_yolo_tpu_torch.nn.blocks import ConvBN
from custom_yolo_tpu_torch.ops import attention
from custom_yolo_tpu_torch.ops import boxes as port_boxes
from custom_yolo_tpu_torch.ops.dfl import dfl_expectation_matmul
from custom_yolo_tpu_torch.train import assigner as port_assigner
from custom_yolo_tpu_torch.train import optim as port_optim
from custom_yolo_tpu_torch.train.losses import DetectionLoss, LossConfig
from custom_yolo_tpu_torch.train.train_state import TrainState
from custom_yolo_tpu_torch.train.train_step import (make_eval_step,
                                                    make_train_step)
from custom_yolo_tpu_torch.utils.weights import (from_jax_variables,
                                                 train_state_from_jax)

torch.set_num_threads(2)

# the model of tests/test_torch_model.py: at 64² the deepest level is 2×2,
# so with batch 2 its BatchNorms see n = 8 values per channel
WIDTH = (3, 8, 16, 32, 64, 256)
DEPTH = (2, 1, 1, 1, 2, 1)
CSP = (True, True)
NC = 7
HW = 64
BATCH = 2
BOXES = 4


def t2n(x: torch.Tensor) -> np.ndarray:
    return x.detach().float().numpy()


def to_numpy_tree(tree):
    """A flax variable tree → nested plain dicts of numpy arrays."""
    if hasattr(tree, "items"):
        return {k: to_numpy_tree(v) for k, v in tree.items()}
    return np.asarray(tree)


# ------------------------------------------------- attention backward (K4)
def _attention_inputs(shape, seed):
    b, t, nh, dk, dh = shape
    rng = np.random.RandomState(seed)
    return (rng.randn(b, t, nh * (2 * dk + dh)).astype(np.float32),
            rng.randn(b, t, nh * dh).astype(np.float32),
            rng.randn(b, t, nh * dh).astype(np.float32))


@pytest.mark.parametrize("shape,dtype,tol", [
    ((2, 16, 2, 8, 16), "float32", 1e-5),
    ((3, 37, 2, 8, 16), "float32", 1e-5),
    # bf16 results are rounded to bf16: atol = rtol = 2e-2 on unit-scale
    # inputs lets two fp32 sums taken in another order round one bf16 step
    # apart
    ((1, 400, 6, 32, 64), "bfloat16", 2e-2),
    # one token past a 64-row tile of the bf16 kernels
    ((1, 65, 2, 32, 64), "bfloat16", 2e-2),
])
def test_attention_bwd_twin_matches_pallas_kernel(shape, dtype, tol):
    _, _, nh, dk, dh = shape
    arrays = _attention_inputs(shape, seed=11)
    qkv_t, do_t, dv_t = (torch.from_numpy(a).to(getattr(torch, dtype))
                         for a in arrays)
    got = attention.psa_attention_bwd(qkv_t, do_t, dv_t, nh, dk, dh)
    assert got.dtype == qkv_t.dtype and got.shape == qkv_t.shape
    want = _psa_attention_bwd_pallas(
        *(jnp.asarray(a, dtype) for a in arrays), nh, dk, dh, interpret=True)
    np.testing.assert_allclose(t2n(got), np.asarray(want, np.float32),
                               atol=tol, rtol=tol)
    assert attention.psa_attention_bwd.launches == 0


@pytest.mark.parametrize("shape,dtype", [
    ((2, 16, 2, 8, 16), "float32"),
    ((1, 400, 6, 32, 64), "bfloat16"),      # the x preset at 640²
])
def test_attention_bwd_twin_matches_jax_grad_of_reference(shape, dtype):
    """Against autodiff through the einsum path, whose rounding points
    differ from the kernel's: 1e-4 in fp32; in bf16 0.15 (atol = rtol)
    and cosine > 0.999 — the limits the JAX package sets its own kernel."""
    _, _, nh, dk, dh = shape
    arrays = _attention_inputs(shape, seed=12)
    qkv_t, do_t, dv_t = (torch.from_numpy(a).to(getattr(torch, dtype))
                         for a in arrays)
    got = t2n(attention.psa_attention_bwd_reference(qkv_t, do_t, dv_t, nh,
                                                    dk, dh))
    qkv_j, do_j, dv_j = (jnp.asarray(a, dtype) for a in arrays)
    _, vjp = jax.vjp(lambda x: jax_attention_ref(x, nh, dk, dh), qkv_j)
    want = np.asarray(vjp((do_j, dv_j))[0], np.float32)
    if dtype == "float32":
        np.testing.assert_allclose(got, want, atol=1e-4, rtol=1e-4)
    else:
        np.testing.assert_allclose(got, want, atol=0.15, rtol=0.15)
        cos = (got * want).sum() / (np.linalg.norm(got)
                                    * np.linalg.norm(want))
        assert cos > 0.999


@pytest.mark.parametrize("use_v", [True, False], ids=["out+v", "out-only"])
def test_attention_function_gradient_is_the_twin(use_v):
    """``psa_attention`` is differentiable through its Function, whose
    backward is the backward wrapper (exactly: same code on the CPU); an
    unused output's cotangent counts as zeros; only qkv is saved."""
    nh, dk, dh = 2, 8, 16
    qkv_np, w_out, w_v = _attention_inputs((2, 16, nh, dk, dh), seed=13)
    qkv = torch.from_numpy(qkv_np).requires_grad_()
    out, v = attention.psa_attention(qkv, nh, dk, dh)
    assert out.grad_fn is not None and v.grad_fn is not None
    assert [t.data_ptr() for t in out.grad_fn.saved_tensors] == \
        [qkv.data_ptr()]
    loss = (out * torch.from_numpy(w_out)).sum()
    if use_v:
        loss = loss + (v * torch.from_numpy(w_v)).sum()
    loss.backward()
    dv = torch.from_numpy(w_v) if use_v else torch.zeros(2, 16, nh * dh)
    want = attention.psa_attention_bwd_reference(
        qkv.detach(), torch.from_numpy(w_out), dv, nh, dk, dh)
    assert torch.equal(qkv.grad, want)
    # and equals autograd through the forward twin to fp32 rounding (1e-5)
    qkv2 = torch.from_numpy(qkv_np).requires_grad_()
    out2, v2 = attention.psa_attention_reference(qkv2, nh, dk, dh)
    loss2 = (out2 * torch.from_numpy(w_out)).sum()
    if use_v:
        loss2 = loss2 + (v2 * torch.from_numpy(w_v)).sum()
    loss2.backward()
    np.testing.assert_allclose(t2n(qkv.grad), t2n(qkv2.grad), atol=1e-5,
                               rtol=1e-5)


# ------------------------------------------------ training-mode BatchNorm
def test_convbn_training_matches_flax_at_n8():
    """Output and running statistics after one and three training steps,
    to 1e-5, at n = B·H·W = 8 values per channel, where the biased batch
    variance flax stores and the unbiased one ``F.batch_norm`` would store
    differ by 8/7."""
    rng = np.random.RandomState(21)
    c_in, c_out = 3, 5
    jax_mod = JaxConvBN(c_out, kernel_size=3, padding=1,
                        policy=jax_policy("float32"))
    xs = [(rng.randn(2, 2, 2, c_in) * 2 + 1.5).astype(np.float32)
          for _ in range(3)]
    variables = to_numpy_tree(jax_mod.init(jax.random.key(0),
                                           jnp.asarray(xs[0]), train=False))
    variables["params"]["bn"]["scale"] = rng.uniform(
        0.5, 1.5, c_out).astype(np.float32)
    variables["params"]["bn"]["bias"] = rng.randn(c_out).astype(np.float32)
    variables["batch_stats"]["bn"]["mean"] = rng.randn(c_out).astype(
        np.float32)
    variables["batch_stats"]["bn"]["var"] = rng.uniform(
        0.5, 1.5, c_out).astype(np.float32)

    port = ConvBN(c_in, c_out, 3, padding=1).train()
    port.load_state_dict(from_jax_variables(variables, port), strict=True)
    default = torch.nn.BatchNorm2d(c_out, eps=port.bn.eps,
                                   momentum=port.bn.momentum).train()
    default.load_state_dict(port.bn.state_dict())

    stats = variables["batch_stats"]
    for step, x in enumerate(xs, start=1):
        y_j, mutated = jax_mod.apply(
            {"params": variables["params"], "batch_stats": stats},
            jnp.asarray(x), train=True, mutable=["batch_stats"])
        stats = mutated["batch_stats"]
        x_t = torch.from_numpy(x).permute(0, 3, 1, 2)
        y_t = port(x_t)
        with torch.no_grad():
            default(torch.nn.functional.conv2d(x_t, port.conv.weight,
                                               padding=1))
        if step in (1, 3):
            np.testing.assert_allclose(
                t2n(y_t.permute(0, 2, 3, 1)), np.asarray(y_j), atol=1e-5,
                rtol=1e-5)
            np.testing.assert_allclose(
                t2n(port.bn.running_mean), np.asarray(stats["bn"]["mean"]),
                atol=1e-5, rtol=1e-5)
            np.testing.assert_allclose(
                t2n(port.bn.running_var), np.asarray(stats["bn"]["var"]),
                atol=1e-5, rtol=1e-5)
    # PyTorch's own running update is measurably elsewhere
    gap = (default.running_var - port.bn.running_var).abs().max().item()
    assert gap > 1e-3, gap
    # evaluation mode reads the running statistics, as before
    y_eval = port.eval()(torch.from_numpy(xs[0]).permute(0, 3, 1, 2))
    y_eval_j = jax_mod.apply({"params": variables["params"],
                              "batch_stats": stats}, jnp.asarray(xs[0]),
                             train=False)
    np.testing.assert_allclose(t2n(y_eval.permute(0, 2, 3, 1)),
                               np.asarray(y_eval_j), atol=1e-5, rtol=1e-5)


def test_batch_statistics_noise_floor():
    """The biased batch variance of a first-layer-sized activation
    (n = 2048) against float64: the port's (``torch.var_mean``, as
    ``ConvBN`` takes it) stays within 5e-6 relative; XLA's on the CPU,
    E[x²] − E[x]² over sequential fp32 sums, is held only to 1e-3 — its
    error sets the floor of every whole-model comparison in training mode
    below."""
    rng = np.random.RandomState(22)
    x = (rng.randn(2048, 8) * 0.3 + rng.rand(8) * 2).astype(np.float32)
    truth = x.astype(np.float64).var(axis=0)
    port = torch.var_mean(torch.from_numpy(x), dim=0,
                          unbiased=False)[0].numpy()
    xj = jnp.asarray(x)
    mean_j = jnp.mean(xj, axis=0)
    xla = np.asarray(jnp.maximum(0., jnp.mean(xj * xj, axis=0)
                                 - mean_j * mean_j))
    port_err = np.abs(port / truth - 1).max()
    xla_err = np.abs(xla / truth - 1).max()
    assert port_err < 5e-6, port_err
    assert xla_err < 1e-3, xla_err
    print(f"relative variance error vs float64: port {port_err:.2e}, "
          f"XLA:CPU {xla_err:.2e}")


# ----------------------------------------------------- geometry and DFL
def test_loss_geometry_matches_jax():
    """bbox2dist, aligned IoU and CIoU (value and gradient), and the DFL
    expectation as a matvec: 1e-6 relative / 1e-6 absolute, the same
    formulas in fp32."""
    rng = np.random.RandomState(31)
    xy = rng.rand(2, 50, 2).astype(np.float32) * 40
    wh = rng.rand(2, 50, 2).astype(np.float32) * 30 + 1
    b1 = np.concatenate([xy, xy + wh], -1)
    shift = rng.randn(2, 50, 4).astype(np.float32) * 4
    b2 = np.concatenate([xy, xy + wh * 1.3], -1) + shift
    b2[0, :5] = b1[0, :5]                        # identical boxes
    b2[1, :5, :2] += 500                         # disjoint boxes
    b2[1, :5, 2:] += 500
    tol = dict(atol=1e-6, rtol=1e-6)
    t1, t2 = torch.from_numpy(b1), torch.from_numpy(b2)
    j1, j2 = jnp.asarray(b1), jnp.asarray(b2)
    np.testing.assert_allclose(t2n(port_boxes.box_iou_aligned(t1, t2)),
                               np.asarray(jax_boxes.box_iou_aligned(j1, j2)),
                               **tol)
    t1.requires_grad_()
    ciou = port_boxes.box_ciou(t1, t2)
    np.testing.assert_allclose(t2n(ciou),
                               np.asarray(jax_boxes.box_ciou(j1, j2)), **tol)
    ciou.sum().backward()
    grad_j = jax.grad(lambda x: jax_boxes.box_ciou(x, j2).sum())(j1)
    np.testing.assert_allclose(t2n(t1.grad), np.asarray(grad_j), atol=1e-5,
                               rtol=1e-5)
    anchors = rng.rand(2, 50, 2).astype(np.float32) * 20
    np.testing.assert_array_equal(
        t2n(port_boxes.bbox2dist(torch.from_numpy(b1 / 4),
                                 torch.from_numpy(anchors), 16)),
        np.asarray(jax_boxes.bbox2dist(jnp.asarray(b1 / 4),
                                       jnp.asarray(anchors), 16)))
    logits = rng.randn(2, 84, 64).astype(np.float32) * 3
    np.testing.assert_allclose(
        t2n(dfl_expectation_matmul(torch.from_numpy(logits))),
        np.asarray(jax_dfl_expectation_matmul(jnp.asarray(logits))),
        atol=1e-5, rtol=1e-6)


# ------------------------------------------------------------ assigners
def _grid():
    anchors, strides = jax_make_anchors(
        [(HW // 8, HW // 8), (HW // 16, HW // 16), (HW // 32, HW // 32)],
        [8, 16, 32])
    return np.array(anchors), np.array(strides)


def test_nearest_assign_matches_jax_with_ties():
    """Random centres, and GT centres equidistant from several predicted
    centres on a coarse grid (with duplicated predictions): the lowest
    anchor index wins in both. Fields equal exactly."""
    rng = np.random.RandomState(41)
    anchors, strides = _grid()
    centers = np.tile((anchors * strides)[None], (2, 1, 1)).astype(np.float32)
    centers[:, 10] = centers[:, 3]               # duplicated prediction
    centers[1, 70] = centers[1, 20]
    gt = (rng.rand(2, 6, 2) * 60).astype(np.float32)
    gt[0, 0] = (16, 12)     # ties (12,12), (20,12) at stride 8, (16,16) at 32
    gt[0, 1] = (8, 8)       # four stride-8 cells at 32, the stride-16 cell at 0
    gt[1, 0] = centers[1, 20]                    # the duplicated pair
    gt[1, 1] = (32, 32)     # the image centre: ties at every level
    mask = np.ones((2, 6), bool)
    mask[1, 4:] = False
    got = port_assigner.nearest_center_assign(
        torch.from_numpy(gt), torch.from_numpy(centers),
        torch.from_numpy(mask))
    want = jax_assigner.nearest_center_assign(
        jnp.asarray(gt), jnp.asarray(centers), jnp.asarray(mask))
    np.testing.assert_array_equal(got.anchor_idx.numpy(),
                                  np.asarray(want.anchor_idx))
    np.testing.assert_array_equal(got.valid.numpy(), np.asarray(want.valid))
    assert got.anchor_idx[1, 0] == 20 and got.anchor_idx[0, 0] < 64


def _tal_inputs(tied: bool):
    rng = np.random.RandomState(42)
    anchors, strides = _grid()
    m = anchors.shape[0]
    anchor_px = (anchors * strides).astype(np.float32)
    n, g = 2, 5
    xy = (rng.rand(n, g, 2) * 30).astype(np.float32)
    wh = (rng.rand(n, g, 2) * 25 + 8).astype(np.float32)
    gt = np.concatenate([xy, xy + wh], -1)
    labels = rng.randint(0, NC, (n, g)).astype(np.int32)
    mask = np.ones((n, g), bool)
    mask[1, 3:] = False
    if tied:
        # every anchor predicts the first GT box exactly and every class
        # scores 0.5: all in-box anchors tie on the metric; two GTs share
        # one box under different labels, so the conflict ties on IoU too
        gt[:, 0] = (10, 10, 50, 50)
        gt[:, 1] = gt[:, 0]
        labels[:, 1] = (labels[:, 0] + 1) % NC
        boxes = np.tile(gt[:, :1], (1, m, 1)).astype(np.float32)
        scores = np.full((n, m, NC), 0.5, np.float32)
    else:
        half = (rng.rand(n, m, 2) * 20 + 2).astype(np.float32)
        jitter = (rng.randn(n, m, 2) * 3).astype(np.float32)
        boxes = np.concatenate([anchor_px[None] + jitter - half,
                                anchor_px[None] + jitter + half], -1)
        scores = rng.rand(n, m, NC).astype(np.float32)
    return scores, boxes, anchor_px, gt, labels, mask


@pytest.mark.parametrize("tied", [False, True], ids=["random", "tied"])
@pytest.mark.parametrize("dense", [True, False], ids=["dense", "sparse"])
def test_task_aligned_assign_matches_jax(tied, dense):
    """Field by field: indices, labels and masks exactly, scores and boxes
    to 1e-6 (the same fp32 formulas; ``pow`` may round differently)."""
    arrays = _tal_inputs(tied)
    kw = dict(num_classes=NC, topk=4, dense_scores=dense)
    got = port_assigner.task_aligned_assign(
        *(torch.from_numpy(a) for a in arrays), **kw)
    want = jax_assigner.task_aligned_assign(
        *(jnp.asarray(a) for a in arrays), **kw)
    assert got.fg_mask.any()
    np.testing.assert_array_equal(got.fg_mask.numpy(),
                                  np.asarray(want.fg_mask))
    np.testing.assert_array_equal(got.target_labels.numpy(),
                                  np.asarray(want.target_labels))
    np.testing.assert_array_equal(got.target_boxes.numpy(),
                                  np.asarray(want.target_boxes))
    np.testing.assert_allclose(got.anchor_scores.numpy(),
                               np.asarray(want.anchor_scores), atol=1e-6,
                               rtol=1e-6)
    if dense:
        np.testing.assert_allclose(got.target_scores.numpy(),
                                   np.asarray(want.target_scores),
                                   atol=1e-6, rtol=1e-6)
    else:
        assert got.target_scores is None and want.target_scores is None
    if tied:
        # top-k = 4 of equal metrics: the first GT's positives are the 4
        # lowest in-box anchor indices, and its twin (same box, IoU tied at
        # 1) gets none of them
        _, _, anchor_px, gt, labels, _ = arrays
        for img in range(2):
            x1, y1, x2, y2 = gt[img, 0]
            inside = np.flatnonzero(
                (anchor_px[:, 0] > x1) & (anchor_px[:, 0] < x2)
                & (anchor_px[:, 1] > y1) & (anchor_px[:, 1] < y2))
            assert len(inside) > 4
            first = torch.from_numpy(inside[:4])
            assert got.fg_mask[img][first].all()
            assert (got.target_labels[img][first] == int(labels[img, 0])).all()
            later = torch.from_numpy(inside[4:])
            box = torch.from_numpy(gt[img, 0])
            assert not (got.fg_mask[img][later] & (
                got.target_boxes[img][later] == box).all(dim=-1)).any()


# ----------------------------------------------------------------- loss
def _loss_inputs():
    rng = np.random.RandomState(51)
    anchors, strides = _grid()
    m = anchors.shape[0]
    preds = (rng.randn(3, m, 64 + NC) * 2).astype(np.float32)
    preds[0, 5, 64 + 2] = 18.0          # fp32 sigmoid rounds to exactly 1
    preds[2, 9, 64 + 1] = 40.0
    preds[0, 6, 64 + 3] = -30.0
    xy = (rng.rand(3, BOXES, 2) * 40 + 10).astype(np.float32)
    wh = (rng.rand(3, BOXES, 2) * 30 + 8).astype(np.float32)
    gt = np.concatenate([xy, wh], -1)
    gt[2, 1] = gt[2, 0]                 # two GTs on one spot, one class
    labels = rng.randint(0, NC, (3, BOXES)).astype(np.int32)
    labels[2, 1] = labels[2, 0]
    mask = np.ones((3, BOXES), bool)
    mask[0, 3] = False
    mask[1] = False                     # an image with no boxes
    return preds, anchors, strides, gt, labels, mask


@pytest.mark.parametrize("bug", [False, True], ids=["iou", "iou_compat_bug"])
@pytest.mark.parametrize("sparse", [True, False], ids=["sparse", "dense"])
@pytest.mark.parametrize("assigner", ["nearest", "tal"])
def test_detection_loss_value_and_gradient_match_jax(assigner, sparse, bug):
    """Loss and every metric to 1e-5 relative, d loss / d preds to 1e-5
    absolute, with saturated logits (≥ 17, where ``log(1 − σ + 1e-12)``
    would give −inf), a duplicated GT and an image without boxes."""
    preds, anchors, strides, gt, labels, mask = _loss_inputs()
    cfg = dict(num_classes=NC, assigner=assigner, sparse_targets=sparse,
               iou_compat_bug=bug, tal_topk=5)
    jax_loss = JaxDetectionLoss(JaxLossConfig(**cfg))
    port_loss = DetectionLoss(LossConfig(**cfg))
    rest_j = tuple(jnp.asarray(a) for a in (anchors, strides, gt, labels,
                                            mask))
    (want, metrics_j), grad_j = jax.value_and_grad(
        lambda p: jax_loss(p, *rest_j), has_aux=True)(jnp.asarray(preds))
    preds_t = torch.from_numpy(preds).requires_grad_()
    got, metrics_t = port_loss(preds_t, *(torch.from_numpy(a) for a in (
        anchors, strides, gt, labels, mask)))
    got.backward()
    assert np.isfinite(float(want)) and torch.isfinite(got)
    assert set(metrics_t) == set(metrics_j)
    assert ("dfl_loss" in metrics_t) == (assigner == "tal")
    for key, value in metrics_j.items():
        np.testing.assert_allclose(float(metrics_t[key].detach()),
                                   float(value), rtol=1e-5, err_msg=key)
    np.testing.assert_allclose(float(got.detach()), float(want), rtol=1e-5)
    assert float(preds_t.grad.abs().max()) > 1e-3
    np.testing.assert_allclose(t2n(preds_t.grad), np.asarray(grad_j),
                               atol=1e-5, rtol=0)


# ------------------------------------------------------------ optimizer
def test_plateau_trajectory_matches_jax():
    """Scale, best and bad-epoch count equal after every step, through
    improvements, two decays, the min_lr floor and the eps guard."""
    losses = [1.0, 0.9, 0.95, 0.95, 0.95, 0.5, 0.6, 0.6, 0.6, 0.6, 0.6, 0.6,
              0.49999, 0.7, 0.7, 0.7]
    kw = dict(patience=1, factor=0.5, base_lr=1e-3, min_lr=2e-4)
    state_j, state_t = jax_optim.plateau_init(), port_optim.plateau_init()
    scales = []
    for loss in losses:
        state_j = jax_optim.plateau_update(state_j, jnp.asarray(loss), **kw)
        state_t = port_optim.plateau_update(state_t, loss, **kw)
        assert float(state_t.scale) == float(state_j.scale)
        assert float(state_t.best) == float(state_j.best)
        assert int(state_t.bad_epochs) == int(state_j.bad_epochs)
        scales.append(float(state_t.scale))
    assert scales[0] == 1.0 and min(scales) == pytest.approx(0.2)
    assert state_t.bad_epochs.dtype == torch.int32


def test_config_defaults_match_jax():
    import dataclasses

    from custom_yolo_tpu import config as jax_config
    for port_cls, jax_cls in ((TrainingConfig, jax_config.TrainingConfig),
                              (ShardingConfig, jax_config.ShardingConfig),
                              (ModelConfig, jax_config.ModelConfig)):
        assert dataclasses.asdict(port_cls()) == dataclasses.asdict(jax_cls())
    with pytest.raises(ValueError, match="adamw"):
        port_optim.build_optimizer([], TrainingConfig(optimizer="sgd"))


# ------------------------------------------------------------ train step
LR = 2e-3
EMA_DECAY, EMA_TAU, WARMUP = 0.99, 30.0, 52
STEPS = 3


def _batches(n=BATCH):
    rng = np.random.RandomState(61)
    out = []
    for _ in range(STEPS):
        mask = np.ones((n, BOXES), bool)
        mask[1, 3] = False
        # boxes large enough for the task-aligned metric IoU⁶ to clear its
        # 1e-9 floor against the wide boxes an untrained head predicts
        xy = rng.rand(n, BOXES, 2) * 24 + 20
        wh = rng.rand(n, BOXES, 2) * 32 + 24
        out.append({
            "images": rng.rand(n, HW, HW, 3).astype(np.float32),
            "gt_boxes": np.concatenate([xy, wh], -1).astype(np.float32),
            "gt_labels": rng.randint(0, NC, (n, BOXES)).astype(np.int32),
            "gt_mask": mask,
        })
    return out


def _jax_state_as_numpy(state):
    """The parts of a JAX TrainState that ``train_state_from_jax`` reads."""
    adam = [leaf for leaf in jax.tree_util.tree_leaves(
        state.opt_state, is_leaf=lambda x: hasattr(x, "mu"))
        if hasattr(leaf, "mu")][0]
    return {
        "params": to_numpy_tree(state.params),
        "batch_stats": to_numpy_tree(state.batch_stats),
        "mu": to_numpy_tree(adam.mu), "nu": to_numpy_tree(adam.nu),
        "count": int(adam.count),
        "learning_rate": float(
            jax_optim.current_learning_rate(state.opt_state)),
        "step": int(state.step), "epoch": int(state.epoch),
        "plateau": {k: np.asarray(v)
                    for k, v in state.plateau._asdict().items()},
        "ema_params": (None if state.ema_params is None
                       else to_numpy_tree(state.ema_params)),
        "ema_batch_stats": (None if state.ema_batch_stats is None
                            else to_numpy_tree(state.ema_batch_stats)),
    }


def _mid_training_state(variables, tx):
    """A JAX train state as it looks some way into training: BatchNorm
    scales, biases and running statistics off their initial values, AdamW
    moments filled (count 50). From fresh moments AdamW's first updates are
    ``lr·sign(g)``, which turns the fp32 noise of a gradient that is zero
    in exact arithmetic (a bias in front of a training-mode BatchNorm) into
    a full step of either sign; with ``nu`` filled that noise stays
    noise."""
    rng = np.random.RandomState(71)
    tree = to_numpy_tree(variables)

    def walk(node, path):
        out = {}
        for key, value in node.items():
            if isinstance(value, dict):
                out[key] = walk(value, path + (key,))
            elif path[-1:] == ("bn",) and key in ("scale", "var"):
                out[key] = rng.uniform(0.5, 1.5, value.shape).astype(
                    np.float32)
            elif path[-1:] == ("bn",) and key in ("bias", "mean"):
                out[key] = (0.1 * rng.randn(*value.shape)).astype(np.float32)
            else:
                out[key] = value
        return out

    tree = walk(tree, ())
    state = JaxTrainState.create(jax.tree.map(jnp.asarray, tree), tx,
                                 jax.random.key(0), ema=True)
    mu = jax.tree.map(lambda p: jnp.asarray(
        1e-3 * rng.randn(*p.shape), jnp.float32), state.params)
    nu = jax.tree.map(lambda p: jnp.asarray(
        rng.uniform(1e-5, 1e-3, p.shape), jnp.float32), state.params)
    opt_state = jax.tree_util.tree_map(
        lambda x: x._replace(count=jnp.asarray(50, jnp.int32), mu=mu, nu=nu)
        if hasattr(x, "mu") else x,
        state.opt_state, is_leaf=lambda x: hasattr(x, "mu"))
    return state.replace(opt_state=opt_state,
                         step=jnp.asarray(50, jnp.int32))


@pytest.fixture(scope="module")
def jax_model():
    model = JaxYoloModel(WIDTH, DEPTH, CSP, NC, policy=jax_policy("float32"))
    variables = model.init(jax.random.key(0), jnp.zeros((1, HW, HW, 3)),
                           train=False)
    return model, variables


@pytest.fixture(scope="module")
def jax_runs(jax_model):
    """JAX trajectories by (assigner, accumulate_steps), each computed
    once: the states before and after every step, as numpy, and the
    metrics of every step."""
    model, variables = jax_model
    cache = {}

    def run(assigner, accumulate):
        key = (assigner, accumulate)
        if key not in cache:
            cfg = JaxTrainingConfig(learning_rate=LR, grad_clip=1.0)
            tx = jax_optim.build_optimizer(cfg)
            loss_fn = JaxDetectionLoss(JaxLossConfig(
                num_classes=NC, assigner=assigner))
            step = jax_make_train_step(
                model, loss_fn, tx, donate=False,
                accumulate_steps=accumulate, ema_decay=EMA_DECAY,
                ema_tau=EMA_TAU, warmup_steps=WARMUP)
            state = _mid_training_state(variables, tx)
            states, metrics = [_jax_state_as_numpy(state)], []
            for batch in _batches(BATCH * accumulate):
                state, m = step(state, {k: jnp.asarray(v)
                                        for k, v in batch.items()})
                states.append(_jax_state_as_numpy(state))
                metrics.append({k: float(v) for k, v in m.items()})
            cache[key] = (states, metrics, state, loss_fn)
        return cache[key]

    return run


def _port_engine(assigner, accumulate, jax_state):
    model = create_train_model(WIDTH, DEPTH, CSP, NC, precision="float32",
                               device="cpu", seed=5)
    cfg = TrainingConfig(learning_rate=LR, grad_clip=1.0)
    optimizer = port_optim.build_optimizer(model.parameters(), cfg)
    state = train_state_from_jax(jax_state, model, optimizer)
    loss_fn = DetectionLoss(LossConfig(num_classes=NC, assigner=assigner))
    step = make_train_step(model, loss_fn, optimizer,
                           accumulate_steps=accumulate, ema_decay=EMA_DECAY,
                           ema_tau=EMA_TAU, warmup_steps=WARMUP)
    return model, optimizer, state, loss_fn, step


def _torch_batch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


# What bounds the agreement of whole steps: XLA's CPU reductions sum
# sequentially in fp32 where PyTorch sums pairwise
# (test_batch_statistics_noise_floor measures both against float64), and
# every training-mode BatchNorm at n = 8 divides by a small batch deviation,
# so a forward gap of ~1e-5 after the first layer grows with depth, and the
# backward pass runs the depth again. Observed here: total_loss within
# 1e-4 relative, the other loss terms 2e-4, grad_norm 1.4e-3, parameters
# 4e-5, statistics 2e-4. The limits leave about 3× for another CPU:
# total_loss 3e-4 relative, the other loss terms 1e-3, grad_norm 5e-3;
# parameters (and their EMA) 1e-4 absolute; BatchNorm statistics (and
# their EMA) 5e-4 absolute-or-relative.
METRIC_RTOL = {"total_loss": 3e-4, "grad_norm": 5e-3}
OTHER_METRIC_RTOL = 1e-3
PARAM_ATOL = 1e-4
STATS_TOL = 5e-4


def _assert_metrics_match(metrics, metrics_j, label):
    assert set(metrics) == set(metrics_j)
    for key, value in metrics_j.items():
        assert np.isfinite(value)
        np.testing.assert_allclose(
            float(metrics[key]), value,
            rtol=METRIC_RTOL.get(key, OTHER_METRIC_RTOL),
            err_msg=f"{label} {key}")


def _assert_state_matches(state: TrainState, jax_state):
    """Parameters, BatchNorm statistics and both EMA collections against
    the JAX state."""
    model = state.model
    live = from_jax_variables({"params": jax_state["params"],
                               "batch_stats": jax_state["batch_stats"]},
                              model)
    ema = from_jax_variables({"params": jax_state["ema_params"],
                              "batch_stats": jax_state["ema_batch_stats"]},
                             model)
    variables = state.variables
    assert set(variables) == set(state.ema)
    assert any(k.endswith("running_var") for k in variables)
    for key, value in variables.items():
        tol = (dict(atol=STATS_TOL, rtol=STATS_TOL) if "running_" in key
               else dict(atol=PARAM_ATOL, rtol=0))
        np.testing.assert_allclose(t2n(value), t2n(live[key]), err_msg=key,
                                   **tol)
        np.testing.assert_allclose(t2n(state.ema[key]), t2n(ema[key]),
                                   err_msg=f"ema {key}", **tol)
    assert state.step == jax_state["step"]


@pytest.mark.parametrize("assigner,accumulate", [
    ("nearest", 1), ("tal", 1), ("nearest", 2)],
    ids=["nearest", "tal", "nearest-accumulate2"])
def test_three_train_steps_track_jax(jax_runs, assigner, accumulate):
    """Three fp32 steps from a carried mid-training state, with warm-up,
    EMA and clipping on (and once as two microbatches of two images):
    metrics at every step and the whole state after the third within the
    tolerances above."""
    states_j, metrics_j, _, _ = jax_runs(assigner, accumulate)
    model, optimizer, state, _, step = _port_engine(assigner, accumulate,
                                                    states_j[0])
    start = {k: v.clone() for k, v in state.variables.items()}
    for i, batch in enumerate(_batches(BATCH * accumulate)):
        state, metrics = step(state, _torch_batch(batch))
        _assert_metrics_match(metrics, metrics_j[i], f"step {i + 1}")
        # the base learning rate stays in the optimizer through warm-up
        assert port_optim.current_learning_rate(optimizer) == \
            pytest.approx(LR)
    assert metrics_j[0]["grad_norm"] > 1.0        # clipping was active
    if assigner == "tal":
        assert metrics_j[0]["box_loss"] > 0       # there were positives
    _assert_state_matches(state, states_j[STEPS])
    moved = max(float((v - start[k]).abs().max())
                for k, v in state.variables.items() if "running_" not in k)
    assert moved > 10 * PARAM_ATOL, moved
    assert model.training


def test_train_state_from_jax_round_trip(jax_runs):
    """A JAX state after two steps (AdamW moments and count, learning
    rate, step, plateau, EMA) carried into a fresh port model: the third
    step then matches JAX's third step at the tolerances above."""
    states_j, metrics_j, _, _ = jax_runs("nearest", 1)
    _, optimizer, state, _, step = _port_engine("nearest", 1, states_j[2])
    assert state.step == 52 and state.epoch == 0
    assert float(state.plateau.scale) == 1.0
    assert torch.isinf(state.plateau.best)
    some = next(iter(optimizer.state.values()))
    assert float(some["step"]) == 52.0
    assert port_optim.current_learning_rate(optimizer) == pytest.approx(LR)
    state, metrics = step(state, _torch_batch(_batches()[2]))
    _assert_metrics_match(metrics, metrics_j[2], "step 3")
    _assert_state_matches(state, states_j[3])


def test_eval_step_reads_the_ema_like_jax(jax_runs, jax_model):
    """``make_eval_step`` on the state after three steps: evaluation mode,
    EMA parameters and statistics; loss within 1e-4 relative and
    predictions within 1e-4 of JAX's (evaluation mode divides by the
    running deviations, which are not small). The model's own values stay, and
    ``Detector.load_variables`` serves the same EMA."""
    jax_net, _ = jax_model
    states_j, _, state_j, jax_loss = jax_runs("nearest", 1)
    model, _, state, loss_fn, _ = _port_engine("nearest", 1, states_j[STEPS])
    batch = _batches()[0]
    metrics_j, preds_j, _, _ = jax_make_eval_step(jax_net, jax_loss)(
        state_j, {k: jnp.asarray(v) for k, v in batch.items()})
    before = {k: v.clone() for k, v in model.state_dict().items()}
    metrics, preds, anchors, strides = make_eval_step(model, loss_fn)(
        state, _torch_batch(batch))
    _assert_metrics_match(metrics, {k: float(v)
                                    for k, v in metrics_j.items()}, "eval")
    np.testing.assert_allclose(t2n(preds), np.asarray(preds_j), atol=1e-4,
                               rtol=1e-4)
    assert model.training
    for key, value in model.state_dict().items():
        assert torch.equal(value, before[key]), key
    det = Detector(WIDTH, DEPTH, CSP, NC, precision="float32",
                   input_size=(HW, HW), device="cpu")
    det.load_variables(state.eval_variables)
    np.testing.assert_allclose(t2n(det(batch["images"])[0]), t2n(preds),
                               atol=1e-6, rtol=1e-6)


def test_train_step_refuses_misuse():
    model = create_train_model(WIDTH, (1, 1, 1, 1, 1, 1), CSP, NC,
                               precision="float32", device="cpu")
    optimizer = port_optim.build_optimizer(model.parameters(),
                                           TrainingConfig())
    loss_fn = DetectionLoss(LossConfig(num_classes=NC))
    state = TrainState.create(model, optimizer,
                              torch.Generator().manual_seed(0))
    batch = _torch_batch(_batches()[0])
    with pytest.raises(ValueError, match="ema=True"):
        make_train_step(model, loss_fn, optimizer, ema_decay=0.9)(state,
                                                                  batch)
    three = {k: torch.cat([v, v[:1]]) for k, v in batch.items()}
    with pytest.raises(ValueError, match="microbatches"):
        make_train_step(model, loss_fn, optimizer, accumulate_steps=2)(
            state, three)
    if not torch.cuda.is_available():
        # the default device is the card; there is no fallback
        with pytest.raises((RuntimeError, AssertionError)):
            create_train_model(WIDTH, DEPTH, CSP, NC)
