"""The port's ops against the JAX package, on the CPU.

Same numpy-seeded inputs go through the JAX function and its counterpart
in ``custom_yolo_tpu_torch``; on the CPU the port's kernel wrappers take
their plain twins, and the JAX side runs its Pallas kernels in interpret
mode or its XLA reference.
"""

import shutil
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from custom_yolo_tpu.ops.anchors import make_anchors as jax_make_anchors
from custom_yolo_tpu.ops.boxes import box_iou_pairwise as jax_iou
from custom_yolo_tpu.ops.dfl import dfl_decode as jax_dfl_decode
from custom_yolo_tpu.ops.nms import _suppress as jax_suppress
from custom_yolo_tpu.ops.nms import batched_nms as jax_batched_nms
from custom_yolo_tpu.ops.pallas.attention_kernel import (
    psa_attention_pallas, psa_attention_reference as jax_attention_reference)
from custom_yolo_tpu.ops.pallas.nms_kernel import nms_keep_pallas_batched
from custom_yolo_tpu_torch.ops import attention, nms_kernel
from custom_yolo_tpu_torch.ops.anchors import make_anchors
from custom_yolo_tpu_torch.ops.boxes import (box_iou_pairwise, dist2bbox,
                                             xywh2xyxy, xyxy2xywh)
from custom_yolo_tpu_torch.ops.cuda import build
from custom_yolo_tpu_torch.ops.dfl import dfl_decode
from custom_yolo_tpu_torch.ops.nms import MAX_WH, batched_nms

torch.set_num_threads(2)

REPO = Path(__file__).resolve().parents[1]


# ------------------------------------------------------------ attention (K1)
@pytest.mark.parametrize("shape,dtype,atol", [
    ((2, 16, 2, 8, 16), "float32", 1e-5),
    ((2, 400, 6, 32, 64), "bfloat16", 2e-2),   # the x preset at 640²
    # T=1024 (a 1024² input) and one token past a 64-row tile: the T the
    # bf16 kernel takes since its key tiles stream through shared memory
    ((1, 1024, 2, 32, 64), "bfloat16", 2e-2),
    ((2, 65, 2, 32, 64), "bfloat16", 2e-2),
])
def test_attention_twin_matches_jax_kernel(shape, dtype, atol):
    b, t, nh, dk, dh = shape
    rng = np.random.RandomState(1)
    qkv_np = rng.randn(b, t, nh * (2 * dk + dh)).astype(np.float32)
    qkv_j = jnp.asarray(qkv_np, dtype)
    qkv_t = torch.from_numpy(qkv_np).to(getattr(torch, dtype))
    out_t, v_t = attention.psa_attention(qkv_t, nh, dk, dh)
    assert out_t.dtype == qkv_t.dtype and v_t.dtype == qkv_t.dtype
    for fn in (lambda q: psa_attention_pallas(q, nh, dk, dh, interpret=True),
               lambda q: jax_attention_reference(q, nh, dk, dh)):
        out_j, v_j = fn(qkv_j)
        np.testing.assert_array_equal(v_t.float().numpy(),
                                      np.asarray(v_j, np.float32))
        np.testing.assert_allclose(out_t.float().numpy(),
                                   np.asarray(out_j, np.float32),
                                   atol=atol, rtol=atol)
    assert attention.psa_attention.launches == 0


# -------------------------------------------------------------- NMS (K2)
def _iou_f32(a, b):
    """IoU of two fp32 xyxy boxes in box_iou_pairwise's operation order."""
    lt = np.maximum(a[:2], b[:2])
    rb = np.minimum(a[2:], b[2:])
    wh = np.maximum(rb - lt, np.float32(0))
    inter = wh[0] * wh[1]
    area_a = (a[2] - a[0]) * (a[3] - a[1])
    area_b = (b[2] - b[0]) * (b[3] - b[1])
    return inter / (area_a + area_b - inter + np.float32(1e-7))


def _boundary_pair(target, x0, y0, offset=0.0):
    """A (kept, challenger) pair of fp32 boxes whose IoU, once ``offset``
    (a class shift, added to all four coordinates) is added, is exactly
    ``target``. The search runs in shifted space; unshifting is exact
    (Sterbenz) and shifting back restores the same values."""
    off = np.float32(offset)
    x0, y0 = np.float32(np.float32(x0) + off), np.float32(np.float32(y0) + off)
    a = np.array([x0, y0, x0 + np.float32(100), y0 + np.float32(100)],
                 np.float32)
    # the challenger is narrower and taller than the kept box, so both the
    # intersection and the union move as it grows: every fp32 IoU near the
    # target is reachable
    y2 = a[3]
    for _ in range(20000):
        y2 = np.nextafter(y2, np.float32(np.inf))
        h = float(y2) - float(y0)
        x2 = np.float32(float(x0) + float(target) * 1e4
                        / (100 - float(target) * (h - 100)))
        for _ in range(3):
            x2 = np.nextafter(x2, np.float32(0))
        for _ in range(7):
            b = np.array([x0, y0, x2, y2], np.float32)
            if _iou_f32(a, b) == target:
                shift = np.full(4, off, np.float32)
                return a - shift, b - shift
            x2 = np.nextafter(x2, np.float32(np.inf))
    raise AssertionError(f"no fp32 boxes with IoU {target!r} at {x0}")


def _threshold_pairs(thres, x0, y0, offset=0.0):
    """Three box pairs stacked at x0 whose IoU (after ``offset``) is one
    fp32 ulp below, exactly at, and one ulp above ``thres``."""
    t = np.float32(thres)
    targets = (np.nextafter(t, np.float32(0)), t,
               np.nextafter(t, np.float32(1)))
    return [_boundary_pair(target, x0, y0 + 150 * i, offset)
            for i, target in enumerate(targets)]


def _nms_pool(n, k, seed, thres):
    """Score-sorted candidate pools: random boxes, boundary pairs, a fully
    overlapping cluster, and one all-invalid image."""
    rng = np.random.RandomState(seed)
    centers = rng.rand(n, k, 2) * 300
    wh = rng.rand(n, k, 2) * 60 + 5
    boxes = np.concatenate([centers - wh / 2, centers + wh / 2],
                           axis=2).astype(np.float32)
    for img in range(n):
        pairs = (_threshold_pairs(thres, 1000 + 30 * img, 10)
                 + _threshold_pairs(thres, 1300, 500 + 30 * img))
        for slot, (a, b) in enumerate(pairs):
            boxes[img, 2 * slot], boxes[img, 2 * slot + 1] = a, b
        boxes[img, 20:28] = boxes[img, 20]          # identical cluster
    valid = rng.rand(n, k) > 0.15
    valid[-1] = False
    return boxes, valid


@pytest.mark.parametrize("n,k", [(3, 128), (8, 256)])
def test_nms_twin_matches_jax_kernel_exactly(n, k):
    thres = 0.45
    boxes, valid = _nms_pool(n, k, seed=n, thres=thres)
    keep_t = nms_kernel.nms_keep(torch.from_numpy(boxes),
                                 torch.from_numpy(valid), thres).numpy()
    keep_p = np.asarray(nms_keep_pallas_batched(
        jnp.asarray(boxes), jnp.asarray(valid), thres, interpret=True))
    np.testing.assert_array_equal(keep_t, keep_p)
    for i in range(n):
        iou = jax_iou(jnp.asarray(boxes[i]), jnp.asarray(boxes[i]))
        keep_x = np.asarray(jax_suppress(iou, thres,
                                         init_keep=jnp.asarray(valid[i])))
        np.testing.assert_array_equal(keep_t[i], keep_x)
    # the boundary pairs: only the challenger one ulp above is suppressed
    for img in range(n - 1):
        for slot in range(6):
            a_kept, b_kept = keep_t[img, 2 * slot], keep_t[img, 2 * slot + 1]
            if valid[img, 2 * slot] and valid[img, 2 * slot + 1]:
                assert a_kept and b_kept == (slot % 3 != 2)
    assert not keep_t[-1].any()
    assert nms_kernel.nms_keep_batched.launches == 0
    assert nms_kernel.nms_keep_single.launches == 0


def _nms_inputs(n=3, m=200, nc=5, seed=0):
    """Boxes with class-shifted boundary pairs and heavily tied scores."""
    rng = np.random.RandomState(seed)
    centers = rng.rand(n, m, 2) * 400
    wh = rng.rand(n, m, 2) * 80 + 4
    boxes = np.concatenate([centers - wh / 2, centers + wh / 2],
                           axis=2).astype(np.float32)
    classes = rng.randint(0, nc, (n, m)).astype(np.int32)
    # scores on a 0.05 grid: many exact ties
    scores = (rng.randint(1, 20, (n, m)) * 0.05).astype(np.float32)
    for img in range(n):
        cls = img % 2                       # class shift 0 or MAX_WH
        for slot, (a, b) in enumerate(_threshold_pairs(
                0.45, 500 + 100 * img, 20, cls * MAX_WH)):
            boxes[img, 2 * slot], boxes[img, 2 * slot + 1] = a, b
            scores[img, 2 * slot], scores[img, 2 * slot + 1] = 0.95, 0.9
            classes[img, 2 * slot] = classes[img, 2 * slot + 1] = cls
    all_scores = rng.rand(n, m, nc).astype(np.float32)
    all_scores[..., 0] = all_scores[..., 1]           # tied class scores
    return boxes, scores, classes, all_scores


@pytest.mark.parametrize("opts", [
    dict(),
    dict(agnostic=True),
    dict(merge=True),
    dict(class_filter=(0, 2, 3)),
    dict(multi_label=True, conf_thres=0.3),
    dict(max_det=7, top_k=64),
    dict(conf_thres=0.5, iou_thres=0.3, top_k=128),
], ids=["hard", "agnostic", "merge", "class_filter", "multi_label",
        "max_det", "thresholds"])
def test_batched_nms_matches_jax(opts):
    boxes, scores, classes, all_scores = _nms_inputs()
    kw = dict(conf_thres=0.25, iou_thres=0.45, top_k=1024, max_det=300)
    kw.update(opts)
    extra_j = {"all_scores": jnp.asarray(all_scores)} \
        if kw.get("multi_label") else {}
    extra_t = {"all_scores": torch.from_numpy(all_scores)} \
        if kw.get("multi_label") else {}
    res_j = jax_batched_nms(jnp.asarray(boxes), jnp.asarray(scores),
                            jnp.asarray(classes), backend="xla", **kw,
                            **extra_j)
    res_t = batched_nms(torch.from_numpy(boxes), torch.from_numpy(scores),
                        torch.from_numpy(classes), **kw, **extra_t)
    assert res_t.valid.any()
    for name in res_j._fields:
        got = getattr(res_t, name).numpy()
        want = np.asarray(getattr(res_j, name))
        assert got.shape == want.shape, name
        if name == "boxes" and kw.get("merge"):
            # weighted means: the matmul sums in another order than XLA's
            np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-4,
                                       err_msg=name)
        else:
            np.testing.assert_array_equal(got, want.astype(got.dtype),
                                          err_msg=name)


# ------------------------------------------------------- small pure ops
def test_geometry_and_decode_match_jax():
    rng = np.random.RandomState(3)
    anchors_j, strides_j = jax_make_anchors([(8, 8), (4, 4), (2, 2)],
                                            [8, 16, 32])
    anchors_t, strides_t = make_anchors([(8, 8), (4, 4), (2, 2)], [8, 16, 32])
    np.testing.assert_array_equal(anchors_t.numpy(), np.asarray(anchors_j))
    np.testing.assert_array_equal(strides_t.numpy(), np.asarray(strides_j))

    logits = rng.randn(2, 84, 64).astype(np.float32) * 3
    ltrb_t = dfl_decode(torch.from_numpy(logits))
    ltrb_j = np.asarray(jax_dfl_decode(jnp.asarray(logits)))
    np.testing.assert_allclose(ltrb_t.numpy(), ltrb_j, atol=1e-5, rtol=1e-6)

    from custom_yolo_tpu.ops.boxes import (dist2bbox as jd2b,
                                           xywh2xyxy as jx2x,
                                           xyxy2xywh as jxy2)
    dist = torch.from_numpy(np.abs(logits[..., :4]))
    for xywh in (True, False):
        np.testing.assert_array_equal(
            dist2bbox(dist, anchors_t[None], xywh).numpy(),
            np.asarray(jd2b(jnp.asarray(dist.numpy()), anchors_j[None],
                            xywh)))
    boxes = rng.rand(10, 4).astype(np.float32) * 50
    np.testing.assert_array_equal(xywh2xyxy(torch.from_numpy(boxes)).numpy(),
                                  np.asarray(jx2x(jnp.asarray(boxes))))
    np.testing.assert_array_equal(xyxy2xywh(torch.from_numpy(boxes)).numpy(),
                                  np.asarray(jxy2(jnp.asarray(boxes))))
    xyxy = np.concatenate([boxes[:, :2], boxes[:, :2] + boxes[:, 2:]], 1)
    np.testing.assert_array_equal(
        box_iou_pairwise(torch.from_numpy(xyxy), torch.from_numpy(xyxy)
                         ).numpy(),
        np.asarray(jax_iou(jnp.asarray(xyxy), jnp.asarray(xyxy))))


# -------------------------------------------------------------- wrappers
def test_wrappers_refuse_instead_of_falling_back():
    """Off the CPU a wrapper launches its kernel or raises; here there is
    no CUDA device, so every non-CPU path raises and nothing launches."""
    qkv = torch.empty(1, 16, 2 * 32, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        attention.psa_attention(qkv, 1, 16, 32)
    boxes = torch.empty(1, 8, 4, device="meta")
    valid = torch.empty(1, 8, dtype=torch.bool, device="meta")
    with pytest.raises(ValueError, match="CUDA device"):
        nms_kernel.nms_keep(boxes, valid, 0.45)
    grad = torch.empty(1, 16, 32, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        attention.psa_attention_bwd(qkv, grad, grad, 1, 16, 32)
    # nor with cotangents that do lie on the CPU
    with pytest.raises(ValueError, match="unsupported device"):
        attention.psa_attention_bwd(qkv, torch.empty(1, 16, 32),
                                    torch.empty(1, 16, 32), 1, 16, 32)
    if not torch.cuda.is_available():
        for name in build.SOURCES:
            with pytest.raises(RuntimeError, match="needs a CUDA device"):
                build.load(name)
        with pytest.raises((RuntimeError, AssertionError)):
            torch.empty(1, device="cuda")
    assert attention.psa_attention.launches == 0
    assert attention.psa_attention_bwd.launches == 0
    assert nms_kernel.nms_keep_batched.launches == 0
    assert nms_kernel.nms_keep_single.launches == 0


def test_build_names_libraries_by_source_hash():
    paths = {name: build.library_path(name) for name in build.SOURCES}
    assert len(set(paths.values())) == len(paths)
    for name, path in paths.items():
        assert path.parent == build.BUILD_DIR and path.name.startswith(name)
        src, flags = build.SOURCES[name]
        assert (build.CSRC / src).exists()
    assert set(build.SOURCES) == {"attention", "attention_bwd", "nms", "sppf",
                                  "head", "quant"}
    assert "-fmad=false" in build.SOURCES["nms"][1]
    assert "arch=compute_90a,code=sm_90a" in build.FLAGS
    ignored = (REPO / ".gitignore").read_text()
    assert "custom_yolo_tpu_torch/ops/cuda/_build/" in ignored


def test_library_hash_covers_shared_header(tmp_path, monkeypatch):
    """Both attention sources include attention_tiles.cuh; an edit to the
    header renames (so rebuilds) every library."""
    for src in ("attention.cu", "attention_bwd.cu"):
        text = (build.CSRC / src).read_text()
        assert '#include "attention_tiles.cuh"' in text
    csrc = tmp_path / "csrc"
    shutil.copytree(build.CSRC, csrc)
    monkeypatch.setattr(build, "CSRC", csrc)
    before = {name: build.library_path(name) for name in build.SOURCES}
    header = csrc / "attention_tiles.cuh"
    header.write_text(header.read_text() + "\n// edited\n")
    after = {name: build.library_path(name) for name in build.SOURCES}
    assert all(before[name] != after[name] for name in build.SOURCES)


# --------------------------------------------------------------- imports
def test_port_imports_no_jax_or_reference_package():
    files = sorted((REPO / "custom_yolo_tpu_torch").rglob("*.py"))
    files.append(REPO / "chip_smoke.py")
    for path in files:
        for line in path.read_text().splitlines():
            words = line.split()
            if words[:1] in (["import"], ["from"]) and len(words) > 1:
                mod = words[1].split(".")[0].rstrip(",")
                assert mod not in ("jax", "jaxlib", "flax", "optax", "orbax",
                                   "custom_yolo_tpu"), (path, line)
    names = {str(path.relative_to(REPO)) for path in files}
    assert {"custom_yolo_tpu_torch/config.py",
            "custom_yolo_tpu_torch/train/assigner.py",
            "custom_yolo_tpu_torch/train/losses.py",
            "custom_yolo_tpu_torch/train/optim.py",
            "custom_yolo_tpu_torch/train/train_state.py",
            "custom_yolo_tpu_torch/train/train_step.py",
            "custom_yolo_tpu_torch/eval/decode.py",
            "custom_yolo_tpu_torch/eval/metrics.py",
            "custom_yolo_tpu_torch/eval/coco_map.py",
            "custom_yolo_tpu_torch/ops/sppf_kernel.py",
            "custom_yolo_tpu_torch/ops/head_kernel.py",
            "custom_yolo_tpu_torch/ops/quant.py",
            "custom_yolo_tpu_torch/ops/quant_kernel.py"} <= names


def test_port_detector_runs_without_jax_loaded():
    code = (
        "import sys, numpy as np, torch\n"
        "torch.set_num_threads(1)\n"
        "from custom_yolo_tpu_torch import Detector\n"
        "det = Detector((3, 8, 16, 16, 32, 64), (1, 1, 1, 1, 1, 1),\n"
        "               (False, True), 3, precision='float32',\n"
        "               input_size=(32, 32), device='cpu')\n"
        "det.init(0)\n"
        "det.fuse()\n"
        "img = np.random.RandomState(0).randint(0, 255, (2, 32, 32, 3))\n"
        "res = det.serve(img.astype(np.uint8), conf_thres=0.001,\n"
        "                device_preprocess=True)\n"
        "assert res.boxes.shape == (2, 21, 4), res.boxes.shape\n"
        "from custom_yolo_tpu_torch.config import TrainingConfig\n"
        "from custom_yolo_tpu_torch.models.detector import "
        "create_train_model\n"
        "from custom_yolo_tpu_torch.train.losses import DetectionLoss, "
        "LossConfig\n"
        "from custom_yolo_tpu_torch.train.optim import build_optimizer\n"
        "from custom_yolo_tpu_torch.train.train_state import TrainState\n"
        "from custom_yolo_tpu_torch.train.train_step import "
        "make_train_step\n"
        "model = create_train_model((3, 8, 16, 16, 32, 64), (1,) * 6,\n"
        "    (False, True), 3, precision='float32', device='cpu')\n"
        "opt = build_optimizer(model.parameters(), TrainingConfig())\n"
        "state = TrainState.create(model, opt, torch.Generator(), ema=True)\n"
        "step = make_train_step(model, DetectionLoss(LossConfig(\n"
        "    num_classes=3, assigner='tal')), opt, ema_decay=0.99)\n"
        "batch = {'images': torch.rand(2, 32, 32, 3),\n"
        "         'gt_boxes': torch.tensor([[[16., 16., 20., 20.]]] * 2),\n"
        "         'gt_labels': torch.zeros(2, 1, dtype=torch.int64),\n"
        "         'gt_mask': torch.ones(2, 1, dtype=torch.bool)}\n"
        "state, metrics = step(state, batch)\n"
        "assert state.step == 1 and torch.isfinite(metrics['total_loss'])\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in\n"
        "       ('jax', 'jaxlib', 'flax', 'optax', 'custom_yolo_tpu')]\n"
        "assert not bad, bad\n"
        "print('ok')\n")
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                       capture_output=True, text=True, timeout=240)
    assert r.returncode == 0, r.stderr[-3000:]
    assert r.stdout.strip() == "ok"
