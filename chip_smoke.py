"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the port's hand-written CUDA kernels from ``custom_yolo_tpu_torch/
ops/cuda/csrc``, holds each against its plain PyTorch twin on the card
(and the int8 contraction's routes against their float64 twin), serves the
full-width ``x`` preset (640², 172 classes, bf16, random seeded weights)
through ``Detector.serve`` and ``Detector.inference``, fused, then also
through ``optimize_for_serving`` with the fused cls tower on, then int8
(``quantize(stochastic=True)`` → ``calibrate``), trains the same preset
for a few steps (``create_train_model`` / ``build_optimizer`` /
``TrainState.create`` / ``make_train_step``, TAL then nearest, EMA and
warm-up on), evaluates the trained state (``make_eval_step`` →
``decode_predictions`` → ``DetectionMetrics`` / ``COCOmAP``), all while
counting kernel launches, compares the card with the CPU in fp32 for
serving (float and int8), for one train step and for evaluation, and
times the kernels, the serving variants, the train step and the eval step
with CUDA events (K1 and K4, whose calls take microseconds, and their
library yardsticks by their device time in a profiler trace). Any failed check ends the run with a non-zero exit. The
last line is ``{"ok": true, "device": {...}}``; the line before it is the
card's name and power limit as ``nvidia-smi`` reports them.
"""

from __future__ import annotations

import json
import os
import shutil
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch
import torch.nn.functional as F

from custom_yolo_tpu_torch import PRESETS, Detector
from custom_yolo_tpu_torch.config import TrainingConfig
from custom_yolo_tpu_torch.eval import (COCOmAP, DetectionMetrics,
                                        decode_predictions)
from custom_yolo_tpu_torch.eval.decode import decoded_to_lists
from custom_yolo_tpu_torch.models.detector import (IMAGENET_MEAN,
                                                   IMAGENET_STD,
                                                   create_train_model,
                                                   decode_raw_predictions,
                                                   normalize_uint8)
from custom_yolo_tpu_torch.models.head import CLS_BIAS
from custom_yolo_tpu_torch.ops import (attention, head_kernel, nms_kernel,
                                       quant, quant_kernel, sppf_kernel)
from custom_yolo_tpu_torch.ops.anchors import num_anchors
from custom_yolo_tpu_torch.ops.cuda import build
from custom_yolo_tpu_torch.ops.nms import MAX_WH, _gather_candidates, \
    batched_nms
from custom_yolo_tpu_torch.train.losses import DetectionLoss, LossConfig
from custom_yolo_tpu_torch.train.optim import build_optimizer
from custom_yolo_tpu_torch.train.train_state import TrainState
from custom_yolo_tpu_torch.train.train_step import (make_eval_step,
                                                    make_train_step)

SEED = 0
HW = 640
NUM_CLASSES = 172
SERVE_BATCH = 8
TRAIN_BATCH = 8
TRAIN_MAX_BOXES = 16
# the small model of the CPU tests, for the card-against-CPU train step and
# int8 forward
SMALL = dict(width=(3, 8, 16, 32, 64, 256), depth=(2, 1, 1, 1, 2, 1),
             csp=(True, True), num_classes=7, hw=64, batch=2, boxes=4)
# int8 x model against the bf16 one: Pearson of the box logits (the JAX
# test's 0.99; 0.9984 measured on an H100). The exact transforms after
# quantize: within INT8_STEPS int8 steps (of 1/127) of the largest
# prediction, box-logit Pearson above INT8_OPT_CORR (1.3e-5 of the largest
# and 0.99916 measured on an H100). int8 card against CPU (small model,
# fp32): the same step limit and INT8_CPU_CORR (2.5e-11 of the largest,
# Pearson 1 − 3e-16 on an H100). A flipped int8 step moves a prediction by
# about one step (1.6 steps measured on the CPU against JAX), hence two.
INT8_CORR = 0.99
INT8_STEPS = 2
INT8_OPT_CORR = 0.995
INT8_CPU_CORR = 0.9999
# attention shapes (B, T, nh, dk, dh) of phases 3 and 4b and their dtypes:
# the x preset's and a small ragged one in both; in bf16 also T=1024 (a
# 1024² input), one token past a 64-row tile and another dk/dh; and rows
# whose stride (c_qkv = 132) is not a multiple of 8, in both
BOTH = (torch.bfloat16, torch.float32)
ATTN_CASES = (((SERVE_BATCH, 400, 6, 32, 64), BOTH), ((3, 37, 2, 8, 16), BOTH),
              ((2, 1024, 6, 32, 64), (torch.bfloat16,)),
              ((2, 65, 6, 32, 64), (torch.bfloat16,)),
              ((1, 400, 2, 16, 32), (torch.bfloat16,)),
              ((2, 70, 3, 12, 20), BOTH))
ATTN_TOL = {torch.bfloat16: 2e-2, torch.float32: 1e-5}
# random weights score ~0.01; a gate this low fills every 1024-candidate
# pool, so the NMS kernel does its full work
POOL_CONF = 0.001
# H100 SXM peaks (NVIDIA data sheet): HBM bytes/s, dense bf16 tensor-core
# FLOP/s, fp32 CUDA-core FLOP/s
HBM_BYTES_S = 3.35e12
BF16_FLOPS = 989e12
FP32_FLOPS = 67e12
# fp32 operations per IoU test in the greedy sweep: 4 min/max, 2 sub,
# 2 clamp, 1 mul, 3 add/sub, 1 div, 1 compare
NMS_OPS_PER_PAIR = 14
# device-time categories of a profile, matched in this order on the
# kernel's name; the last takes the rest
KERNEL_CATEGORIES = (
    ("port kernels", ("psa_attention_fwd", "psa_attention_bwd",
                      "nms_keep_kernel", "nms_mask_kernel",
                      "nms_sweep_kernel", "sppf_pyramid_kernel",
                      "cls_stage_kernel", "stochastic_round_kernel")),
    ("int8 product", ("gemm_s8", "imma", "s8s32", "i8816", "i8i8")),
    ("batch norm", ("bn_fw", "bn_bw", "batch_norm", "batchnorm",
                    "BatchNorm")),
    ("optimizer and EMA", ("multi_tensor", "lerp")),
    ("reductions", ("reduce_kernel", "Welford", "welford")),
    ("convolution", ("fprop", "conv", "xmma", "cudnn", "cutlass", "gemm")),
    ("copy and concat", ("copy", "Cat")),
    ("pooling", ("pool",)),
    ("sort and select", ("sort", "Sort", "radix", "scan", "gather", "index")),
    ("elementwise", ("elementwise",)),
    ("other", ()),
)


# the wrappers that count their kernel launches, by the name used in the
# launch tables below
COUNTED = {
    "attention": attention.psa_attention,
    "attention_bwd": attention.psa_attention_bwd,
    "nms_batched": nms_kernel.nms_keep_batched,
    "nms_single": nms_kernel.nms_keep_single,
    "sppf": sppf_kernel.sppf_pyramid,
    "cls_tower": head_kernel.cls_tower,
    "stochastic_round": quant_kernel.stochastic_round,
}


def reset_counts() -> None:
    for wrapper in COUNTED.values():
        wrapper.launches = 0


def read_counts() -> dict:
    return {name: wrapper.launches for name, wrapper in COUNTED.items()}


def counts(**nonzero) -> dict:
    """A launch table with the named counts and 0 elsewhere."""
    return {name: nonzero.get(name, 0) for name in COUNTED}


def log(*args):
    print(*args, flush=True)


def fail(msg: str) -> None:
    print(f"FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def check(cond: bool, msg: str) -> None:
    if not cond:
        fail(msg)


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


def normalize(images: torch.Tensor) -> torch.Tensor:
    """uint8 NHWC → the model's normalised fp32 input, as
    ``serve(device_preprocess=True)`` computes it."""
    return normalize_uint8(images, torch.from_numpy(IMAGENET_MEAN).to(
        images.device), torch.from_numpy(IMAGENET_STD).to(images.device))


def time_ms(fn, reps: int = 25, warmup: int = 3) -> float:
    """Median over ``reps`` runs of one call, by CUDA events."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def profile_call(fn, reps: int = 5) -> dict:
    """Device busy share of ``reps`` calls of ``fn`` under torch.profiler,
    and the kernels that took the most device time. Busy time is the union
    of the kernel, copy and memset intervals of the trace; the window is
    the host's clock from the first call to the end of the last (the
    profiler's own host cost included)."""
    fn()
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with tempfile.TemporaryDirectory() as tmp:
        with torch.profiler.profile(activities=acts) as prof:
            t0 = time.perf_counter()
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
            window_ms = (time.perf_counter() - t0) * 1e3
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    spans, by_name = [], {}
    for e in events:
        if e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset") \
                and "dur" in e:
            spans.append((float(e["ts"]), float(e["ts"]) + float(e["dur"])))
            total, count = by_name.get(e["name"], (0.0, 0))
            by_name[e["name"]] = (total + float(e["dur"]) / 1e3, count + 1)
    busy_ms, end = 0.0, -1.0
    for lo, hi in sorted(spans):
        if hi > end:
            busy_ms += (hi - max(lo, end)) / 1e3
            end = hi
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:8]
    by_category = {}
    for name, (ms, count) in by_name.items():
        category = next(c for c, keys in KERNEL_CATEGORIES
                        if not keys or any(k in name for k in keys))
        total, n = by_category.get(category, (0.0, 0))
        by_category[category] = (total + ms / reps, n + count // reps)
    return {"calls": reps, "window_ms": window_ms, "device_busy_ms": busy_ms,
            "idle_share": (1 - busy_ms / window_ms) if spans else None,
            "kernels_per_call": sum(c for _, c in by_name.values()) / reps,
            "by_category_ms_launches": by_category,
            "top": [[name[:80], ms / reps, count // reps]
                    for name, (ms, count) in top]}


def device_ms(fn, reps: int = 20) -> float:
    """Device time of one call of ``fn``: the busy time of ``reps`` calls
    back to back in a profiler trace, over ``reps``. Unlike one call's CUDA
    events it leaves out the host's launch path, which at a few
    microseconds of kernel is most of an event time."""
    return profile_call(fn, reps)["device_busy_ms"] / reps


def attention_bounds(b: int, t: int, nh: int, dk: int, dh: int,
                     dtype) -> tuple:
    """(forward, backward) least times of PSA attention: each input read
    once, each output written once; operations of the products (forward:
    q·kᵀ and p·v; backward: q·kᵀ, do·vᵀ, pᵀ·do, ds·k, dsᵀ·q) at the dtype's
    peak (bf16 tensor cores, fp32 CUDA cores)."""
    size = 2 if dtype == torch.bfloat16 else 4
    peak = BF16_FLOPS if dtype == torch.bfloat16 else FP32_FLOPS
    qkv_bytes = b * t * nh * (2 * dk + dh) * size
    out_bytes = b * t * nh * dh * size
    return (roofline(qkv_bytes + 2 * out_bytes,
                     2 * b * nh * t * t * (dk + dh), peak),
            roofline(2 * qkv_bytes + 2 * out_bytes,
                     2 * b * nh * t * t * (3 * dk + 2 * dh), peak))


# ------------------------------------------------------------ NMS inputs
def iou_f32(a: np.ndarray, b: np.ndarray) -> np.float32:
    """fp32 IoU in the operation order of ops/boxes.py::box_iou_pairwise."""
    lt = np.maximum(a[:2], b[:2])
    rb = np.minimum(a[2:], b[2:])
    wh = np.maximum(rb - lt, np.float32(0))
    inter = wh[0] * wh[1]
    area_a = (a[2] - a[0]) * (a[3] - a[1])
    area_b = (b[2] - b[0]) * (b[3] - b[1])
    return inter / (area_a + area_b - inter + np.float32(1e-7))


def boundary_pair(target: np.float32, x0: float, y0: float):
    """Two fp32 boxes whose IoU is exactly ``target``: the second is
    narrower and taller than the first, so its growth moves both the
    intersection and the union and every nearby fp32 IoU is reachable."""
    x0, y0 = np.float32(x0), np.float32(y0)
    a = np.array([x0, y0, x0 + np.float32(100), y0 + np.float32(100)],
                 np.float32)
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
            if iou_f32(a, b) == target:
                return a, b
            x2 = np.nextafter(x2, np.float32(np.inf))
    fail(f"no fp32 boxes with IoU {target!r}")


def nms_pool(n: int, k: int, thres: float, rng: np.random.RandomState):
    """Class-offset candidate pools: random boxes of 20 classes; pairs at
    IoU one ulp below, at and one ulp above the threshold (placed in class
    3's offset band); a cluster of identical boxes (tied candidates); the
    last image all invalid."""
    centers = rng.rand(n, k, 2) * 600
    wh = rng.rand(n, k, 2) * 120 + 4
    boxes = np.concatenate([centers - wh / 2, centers + wh / 2], 2)
    classes = rng.randint(0, 20, (n, k, 1))
    boxes = (boxes + classes * MAX_WH).astype(np.float32)
    t = np.float32(thres)
    targets = (np.nextafter(t, np.float32(0)), t,
               np.nextafter(t, np.float32(1)))
    for img in range(n):
        for slot, target in enumerate(targets):
            a, b = boundary_pair(target, 3 * MAX_WH + 700 + 10 * img,
                                 3 * MAX_WH + 150 * slot)
            boxes[img, 2 * slot], boxes[img, 2 * slot + 1] = a, b
        boxes[img, 10:18] = boxes[img, 10]
    valid = rng.rand(n, k) > 0.1
    valid[-1] = False
    return boxes, valid


def nms_bound_ms(keep: torch.Tensor) -> tuple:
    """Least time for the greedy sweep on this data: every kept box i is
    tested against the K-1-i boxes after it."""
    n, k = keep.shape
    later = torch.arange(k - 1, -1, -1, device=keep.device)
    pairs = int((keep.long() * later).sum())
    t_ops = pairs * NMS_OPS_PER_PAIR / FP32_FLOPS * 1e3
    t_bytes = n * k * (16 + 1 + 1) / HBM_BYTES_S * 1e3
    return max(t_ops, t_bytes), "operations" if t_ops > t_bytes else "bytes"


def roofline(n_bytes: float, ops: float, peak_ops: float) -> tuple:
    """(least ms, what bounds it) for this many bytes and operations."""
    t_bytes = n_bytes / HBM_BYTES_S * 1e3
    t_ops = ops / peak_ops * 1e3
    return max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def channels_last(shape, dtype, gen, dev) -> torch.Tensor:
    """A seeded NCHW tensor in channels_last memory."""
    return torch.randn(shape, generator=gen).to(dev, dtype).contiguous(
        memory_format=torch.channels_last)


def tower_params(cin: int, mid: int, nc: int, dtype, gen, dev):
    """Seeded cls-tower weights in the layout ``cls_tower`` takes."""
    def mk(*shape):
        return (torch.randn(*shape, generator=gen) * 0.1).to(dev, dtype)
    return ((mk(3, 3, cin), mk(cin)), (mk(cin, mid), mk(mid)),
            (mk(3, 3, mid), mk(mid)), (mk(mid, mid), mk(mid)),
            (mk(mid, nc), mk(nc)))


def ground_truth_lists(batch: dict) -> list:
    """A train batch's padded targets → per-image (n, 5) [cx, cy, w, h,
    cls] numpy arrays."""
    boxes = batch["gt_boxes"].cpu().numpy()
    labels = batch["gt_labels"].cpu().numpy()
    mask = batch["gt_mask"].cpu().numpy()
    return [np.concatenate([boxes[i][mask[i]],
                            labels[i][mask[i], None].astype(np.float32)], 1)
            for i in range(len(boxes))]


def evaluate(eval_step, state, batch, num_classes: int, conf: float,
             use_nms: bool):
    """One eval step, decode, and both metrics over the batch, through the
    port's evaluation entry points. Returns (loss metrics, decoded batch,
    DetectionMetrics, COCOmAP results)."""
    loss_metrics, preds, anchors, strides = eval_step(state, batch)
    decoded = decode_predictions(preds, anchors, strides,
                                 conf_threshold=conf, use_nms=use_nms)
    greedy, coco = DetectionMetrics(num_classes), COCOmAP(num_classes)
    scores = decoded.scores.cpu().numpy()
    valid = decoded.valid.cpu().numpy()
    for i, (dets, gt) in enumerate(zip(decoded_to_lists(decoded),
                                       ground_truth_lists(batch))):
        greedy.update(dets, gt)
        coco.update(dets, scores[i][valid[i]], gt)
    return ({k: float(v) for k, v in loss_metrics.items()}, decoded,
            greedy.compute(), coco.compute())


def widen_cls_logits(detector, x: torch.Tensor) -> tuple:
    """Scale the cls towers' logit weights of ``detector`` by a power of two
    (exact to undo) until the class logits of ``x`` through the conv chain
    spread by at least 1 around the bias prior. Random weights leave every
    class logit at the prior, and a comparison of such logits says nothing
    of the tower before them. Returns ``(factor, chain's class logits)``."""
    head = detector.model.head
    head.fused_cls_tower = False
    factor = 1.0
    while True:
        cls = detector(x)[0][..., 4 * head.reg_max:].float()
        if (cls - CLS_BIAS).abs().max().item() >= 1.0:
            return factor, cls
        check(factor < 2.0 ** 60, "class logits do not spread")
        scale_cls_logits(head, 16.0)
        factor *= 16.0


def scale_cls_logits(head, factor: float) -> None:
    with torch.no_grad():
        for i in range(len(head.in_chs)):
            getattr(head, f"cls{i}_out").weight.mul_(factor)
    head.pack_cls_tower()


def cosine(a: torch.Tensor, b: torch.Tensor) -> float:
    return float((a * b).sum() / (a.norm() * b.norm()))


def pearson(a: torch.Tensor, b: torch.Tensor) -> float:
    a, b = a.double().flatten(), b.double().flatten()
    return cosine(a - a.mean(), b - b.mean())


def bf16_steps(got: torch.Tensor, want: torch.Tensor) -> float:
    """Largest |got − want| in units of want's bf16 spacing."""
    got, want = got.double(), want.double()
    spacing = torch.exp2(torch.floor(torch.log2(
        want.abs().clamp_min(1e-30))) - 7)
    return float(((got - want).abs() / spacing).max())


def attention_loss64(qkv: torch.Tensor, w_out: torch.Tensor,
                     w_v: torch.Tensor, nh: int, dk: int, dh: int):
    """``Σ out·w_out + Σ v·w_v`` of the attention forward, in float64
    throughout (for finite differences)."""
    b, t, _ = qkv.shape
    qkv4 = qkv.reshape(b, t, nh, 2 * dk + dh)
    q, k, v = qkv4[..., :dk], qkv4[..., dk:2 * dk], qkv4[..., 2 * dk:]
    p = torch.softmax(torch.einsum("bqhd,bkhd->bhqk", q, k) * dk ** -0.5, -1)
    out = torch.einsum("bhqk,bkhd->bqhd", p, v).reshape(b, t, nh * dh)
    return (out * w_out).sum() + (v.reshape(b, t, nh * dh) * w_v).sum()


def train_batch(n: int, hw: int, max_boxes: int, num_classes: int,
                seed: int, device, size=(0.06, 0.46)) -> dict:
    """A seeded synthetic batch: normalised images, 1..max_boxes
    centre-xywh boxes per image (padded, masked), their sides between
    ``size`` fractions of the image's, and labels."""
    gen = torch.Generator().manual_seed(seed)
    images = normalize(torch.randint(0, 256, (n, hw, hw, 3), generator=gen,
                                     dtype=torch.uint8))
    centres = torch.rand(n, max_boxes, 2, generator=gen) * hw * 0.75 \
        + hw * 0.125
    sizes = (torch.rand(n, max_boxes, 2, generator=gen)
             * (size[1] - size[0]) + size[0]) * hw
    counts = torch.randint(1, max_boxes + 1, (n, 1), generator=gen)
    batch = {
        "images": images,
        "gt_boxes": torch.cat([centres, sizes], dim=-1),
        "gt_labels": torch.randint(0, num_classes, (n, max_boxes),
                                   generator=gen),
        "gt_mask": torch.arange(max_boxes)[None] < counts,
    }
    return {k: v.to(device) for k, v in batch.items()}


def train_engine(width, depth, csp, num_classes, precision, device, seed,
                 assigner, ema_decay=0.9999, warmup_steps=3):
    """Model, state and step through the port's training entry points."""
    model = create_train_model(width, depth, csp, num_classes,
                               precision=precision, device=device, seed=seed)
    optimizer = build_optimizer(model.parameters(), TrainingConfig())
    state = TrainState.create(model, optimizer,
                              torch.Generator().manual_seed(seed), ema=True)
    loss_fn = DetectionLoss(LossConfig(num_classes=num_classes,
                                       assigner=assigner))
    step = make_train_step(model, loss_fn, optimizer, ema_decay=ema_decay,
                           warmup_steps=warmup_steps)
    return model, optimizer, state, step


def main() -> None:
    if not torch.cuda.is_available():
        fail("no CUDA device: this script runs the port on the GPU")
    # COCOmAP.compute forks worker processes once it holds 2048 per-class
    # records; this process holds a CUDA context, which a forked child must
    # not touch. The batches here stay far below that size, and one worker
    # keeps it so whatever their size.
    os.environ["COCO_MAP_WORKERS"] = "1"
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    card = card_line()
    kind = torch.cuda.get_device_name(0)
    log(f"phase 1 device: {kind} | {card} | torch {torch.__version__} "
        f"cuda {torch.version.cuda}")

    # ---------------------------------------------------------- 2. build
    t0 = time.perf_counter()
    logs = build.build()
    build_s = time.perf_counter() - t0
    for name in build.SOURCES:
        check(build.library_path(name).exists(), f"{name} was not built")
    log(f"phase 2 build: {sorted(build.SOURCES)} in {build_s:.2f} s")
    for name, text in logs.items():
        for line in text.splitlines():
            if "registers" in line or "spill" in line \
                    or "Compiling entry" in line:
                log(f"  {name}: {line.strip()}")
    # the bf16 attention kernels run on the tensor cores: HMMA in the SASS
    cuobjdump = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    if os.path.exists(cuobjdump):
        for name in ("attention", "attention_bwd"):
            sass = subprocess.run([cuobjdump, "-sass",
                                   str(build.library_path(name))],
                                  capture_output=True, text=True,
                                  check=True).stdout
            check("HMMA" in sass, f"{name}: no HMMA instruction in the SASS")
            log(f"  {name}: {sass.count('HMMA')} HMMA instructions in the "
                f"SASS")

    # ------------------------------------------- 3. K1 against its twin
    gen = torch.Generator().manual_seed(SEED)
    b, t, nh, dk, dh = SERVE_BATCH, 400, 6, 32, 64
    attn_err = {}
    for shape, dtypes in ATTN_CASES:
        sb, st, snh, sdk, sdh = shape
        qkv32 = torch.randn(sb, st, snh * (2 * sdk + sdh),
                            generator=gen).to(dev)
        for dtype in dtypes:
            tol = ATTN_TOL[dtype]
            qkv = qkv32.to(dtype)
            out, v = attention.psa_attention(qkv, snh, sdk, sdh)
            torch.cuda.synchronize()
            ref_out, ref_v = attention.psa_attention_reference(
                qkv, snh, sdk, sdh)
            check(torch.equal(v, ref_v), f"attention v differs {shape} "
                  f"{dtype}")
            err = (out.float() - ref_out.float()).abs().max().item()
            check(torch.allclose(out.float(), ref_out.float(), atol=tol,
                                 rtol=tol),
                  f"attention out differs {shape} {dtype}: max abs err {err}")
            attn_err[shape, dtype] = err
            log(f"phase 3 attention {shape} {dtype}: v exact, out max abs "
                f"err {err} (tolerance {tol})")
    qkv_x = torch.randn(b, t, nh * (2 * dk + dh), generator=gen).to(
        dev, torch.bfloat16)

    # ------------------------------------------- 4. K2 against its twin
    rng = np.random.RandomState(SEED)
    nms_mismatch = nms_single_mismatch = 0
    for n, k in ((8, 1024), (3, 300)):
        boxes, valid = nms_pool(n, k, 0.45, rng)
        boxes_d = torch.from_numpy(boxes).to(dev)
        valid_d = torch.from_numpy(valid).to(dev)
        keep = nms_kernel.nms_keep_batched(boxes_d, valid_d, 0.45)
        torch.cuda.synchronize()
        ref = nms_kernel.nms_keep_reference(boxes_d, valid_d, 0.45)
        mismatch = int((keep != ref).sum())
        check(mismatch == 0, f"NMS keep differs at N={n} K={k}: "
              f"{mismatch} entries")
        # K3, the single-image route, on each image of the same pools
        # (and on the whole pool at once: it takes any N)
        for img in list(range(n)) + [slice(None)]:
            one = boxes_d[img].reshape(-1, k, 4).contiguous()
            one_valid = valid_d[img].reshape(-1, k).contiguous()
            keep_one = nms_kernel.nms_keep_single(one, one_valid, 0.45)
            torch.cuda.synchronize()
            wrong = int((keep_one != ref[img].reshape(-1, k)).sum())
            check(wrong == 0, f"single-image NMS keep differs at N={n} "
                  f"K={k}, image {img}: {wrong} entries")
            nms_single_mismatch += wrong
        keep_np = keep.cpu().numpy()
        for img in range(n - 1):
            for slot in range(3):
                if valid[img, 2 * slot] and valid[img, 2 * slot + 1]:
                    check(bool(keep_np[img, 2 * slot]) and bool(
                        keep_np[img, 2 * slot + 1]) == (slot != 2),
                        f"boundary pair {slot} of image {img} mis-kept")
        check(not keep_np[-1].any(), "an all-invalid image kept a box")
        nms_mismatch += mismatch
        log(f"phase 4 nms N={n} K={k}: keep-masks of the batched kernel, "
            f"of the single-image kernels (image by image and all at once) "
            f"and of the twin equal ({int(keep.sum())} kept)")
    before = read_counts()
    routed = nms_kernel.nms_keep(boxes_d[:1].contiguous(),
                                 valid_d[:1].contiguous(), 0.45)
    after = read_counts()
    check(routed.equal(ref[:1])
          and after["nms_single"] == before["nms_single"] + 1
          and after["nms_batched"] == before["nms_batched"],
          "nms_keep did not send one image to the single-image kernels")

    # ------------------------------------------- 4b. K4 against its twin
    # the same cases, with random cotangents for out and v
    bwd_err = {}
    for shape, dtypes in ATTN_CASES:
        sb, st, snh, sdk, sdh = shape
        qkv32 = torch.randn(sb, st, snh * (2 * sdk + sdh),
                            generator=gen).to(dev)
        do32 = torch.randn(sb, st, snh * sdh, generator=gen).to(dev)
        dv32 = torch.randn(sb, st, snh * sdh, generator=gen).to(dev)
        for dtype in dtypes:
            args = (qkv32.to(dtype), do32.to(dtype), dv32.to(dtype),
                    snh, sdk, sdh)
            got = attention.psa_attention_bwd(*args)
            torch.cuda.synchronize()
            again = attention.psa_attention_bwd(*args)
            ref = attention.psa_attention_bwd_reference(*args)
            check(torch.equal(got, again), f"attention backward {shape} "
                  f"{dtype} differs between two runs")
            g, r = got.float(), ref.float()
            check(bool(torch.isfinite(g).all()), "attention backward not "
                  f"finite {shape} {dtype}")
            err = (g - r).abs().max().item()
            cos = cosine(g, r)
            if dtype == torch.float32:
                check(err <= 1e-4, f"attention backward {shape} fp32: max "
                      f"abs err {err} > 1e-4")
            else:
                check(torch.allclose(g, r, atol=0.15, rtol=0.15)
                      and cos > 0.999, f"attention backward {shape} bf16: "
                      f"max abs err {err}, cosine {cos}")
            bwd_err[shape, dtype] = err
            log(f"phase 4b attention backward {shape} {dtype}: max abs err "
                f"{err}, cosine {cos:.7f} (limits: fp32 1e-4; bf16 atol/rtol "
                f"0.15 and cosine > 0.999), |dqkv| max {r.abs().max().item()}")
    # the Function's gradient on the card against central differences of
    # a float64 forward, along a random direction
    fd_shape = (2, 16, 2, 8, 16)
    fb, ft, fnh, fdk, fdh = fd_shape
    q0 = torch.randn(fb, ft, fnh * (2 * fdk + fdh), generator=gen).to(dev)
    w_out = torch.randn(fb, ft, fnh * fdh, generator=gen).to(dev)
    w_v = torch.randn(fb, ft, fnh * fdh, generator=gen).to(dev)
    direction = torch.randn(q0.shape, generator=gen).to(dev)
    leaf = q0.clone().requires_grad_()
    out, v = attention.psa_attention(leaf, fnh, fdk, fdh)
    ((out * w_out).sum() + (v * w_v).sum()).backward()
    analytic = float((leaf.grad.double() * direction.double()).sum())
    eps = 1e-6
    f64 = [attention_loss64(q0.double() + sign * eps * direction.double(),
                            w_out.double(), w_v.double(), fnh, fdk, fdh)
           for sign in (1, -1)]
    numeric = float((f64[0] - f64[1]) / (2 * eps))
    check(abs(analytic - numeric) <= 1e-3 * max(abs(numeric), 1.0),
          f"attention Function gradient {analytic} vs finite differences "
          f"{numeric}")
    log(f"phase 4b attention Function {fd_shape} fp32: directional "
        f"derivative {analytic} vs float64 central differences {numeric}")
    do_x = torch.randn(b, t, nh * dh, generator=gen).to(dev, torch.bfloat16)
    dv_x = torch.randn(b, t, nh * dh, generator=gen).to(dev, torch.bfloat16)

    # ------------------------------------------- 4c. K5 against its twin
    # the x preset's p5 map at batch 8, and a ragged map narrower than the
    # pooling window reaches, each with ±inf entries, then with a NaN
    sppf_mismatch = 0
    for shape in ((SERVE_BATCH, 384, 20, 20), (2, 40, 13, 7)):
        for dtype in (torch.bfloat16, torch.float32):
            x = channels_last(shape, dtype, gen, dev)
            x[0, 3, 2, 1] = float("inf")
            x[1, 5, 0, 0] = -float("inf")
            x[1, 7, 4:9, 1:6] = -float("inf")
            got = sppf_kernel.sppf_pyramid(x)
            torch.cuda.synchronize()
            ref = sppf_kernel.sppf_pyramid_reference(x)
            check(got.shape == ref.shape and got.dtype == dtype
                  and got.is_contiguous(memory_format=torch.channels_last),
                  f"SPPF pyramid result {tuple(got.shape)} {got.dtype}")
            check(torch.equal(got, ref),
                  f"SPPF pyramid differs from its twin {shape} {dtype}")
            sppf_mismatch += int((got != ref).sum())
            x[0, 1, 4, 4] = float("nan")
            got = sppf_kernel.sppf_pyramid(x)
            ref = sppf_kernel.sppf_pyramid_reference(x)
            nans = int(torch.isnan(got).sum())
            check(nans > 1 and torch.equal(torch.isnan(got), torch.isnan(ref))
                  and torch.equal(got.nan_to_num(0.0), ref.nan_to_num(0.0)),
                  f"SPPF pyramid with a NaN differs {shape} {dtype}")
            log(f"phase 4c sppf {shape} {dtype}: bit-exact, with ±inf and "
                f"with a NaN (spread to {nans} outputs)")

    # ------------------------------------------- 4d. K6 against its twin
    # the x preset's three head levels at batch 8, and a ragged map whose
    # tiles hang over the border; limits: fp32 atol/rtol 1e-4; bf16 against
    # the twin on the card, which rounds where the kernel rounds, within
    # 1e-2 of the largest logit (at most one bf16 step there) and 1e-4 of it
    # on average; bf16 against the CPU's twin within 3e-2 of it
    tower_err = {}
    x_levels = ((SERVE_BATCH, 384, 80, 80), (SERVE_BATCH, 768, 40, 40),
                (SERVE_BATCH, 768, 20, 20))
    for shape, mid, nc in [(s, 384, NUM_CLASSES) for s in x_levels] \
            + [((2, 128, 13, 7), 128, 17)]:
        for dtype in (torch.bfloat16, torch.float32):
            x = channels_last(shape, dtype, gen, dev)
            params = tower_params(shape[1], mid, nc, dtype, gen, dev)
            got = head_kernel.cls_tower(x, *params)
            torch.cuda.synchronize()
            refs = {"twin": head_kernel.cls_tower_reference(x, *params)}
            if shape[0] < SERVE_BATCH:
                # the card's convs may sum as the kernel does; the CPU's
                # twin is an implementation that shares nothing with it
                refs["twin on the CPU"] = head_kernel.cls_tower_reference(
                    x.cpu(), *[(k.cpu(), b.cpu()) for k, b in params]).to(dev)
            check(got.shape == (shape[0], nc, *shape[2:])
                  and got.dtype == dtype
                  and got.is_contiguous(memory_format=torch.channels_last),
                  f"cls tower result {tuple(got.shape)} {got.dtype}")
            for name, ref in refs.items():
                g, r = got.float(), ref.float()
                err = (g - r).abs().max().item()
                mean_err = (g - r).abs().mean().item()
                top = r.abs().max().item()
                if dtype == torch.float32:
                    ok = torch.allclose(g, r, atol=1e-4, rtol=1e-4)
                elif name == "twin":
                    ok = err < 1e-2 * top and mean_err < 1e-4 * top
                else:
                    ok = err < 3e-2 * top
                check(bool(torch.isfinite(g).all()) and ok,
                      f"cls tower differs from its {name} {shape} {dtype}: "
                      f"max abs err {err}, mean {mean_err}, largest logit "
                      f"{top}")
                log(f"phase 4d cls tower {shape} {dtype} vs {name}: max abs "
                    f"err {err}, mean {mean_err} (largest logit {top})")
                if name == "twin":
                    tower_err[shape, dtype] = err

    # ------------------------------------------- 4e. K7 against its twin
    # every ConvBN kernel of the x model (fused fp32, the seed of `det`
    # below) as quantize() hands it to the kernel: (kh·kw·cin, cout),
    # divided by the channel's scale and clipped; seed 0, as every leaf of
    # the main path gets. Bit-exact against the twin, at most one step from
    # round-to-nearest; a 64-bit seed on the largest leaf; unbiased over 64
    # seeds there (the JAX test's bound, 0.45 of a step)
    p = PRESETS["x"]
    xq = Detector(p["width"], p["depth"], p["csp"], NUM_CLASSES,
                  precision="bfloat16", input_size=(HW, HW), device="cuda")
    xq.init(SEED)
    xq.fuse()
    k7_mismatch = k7_far = 0
    path_leaves = {}            # the main path's leaves: (operand, K7 result)
    leaves = [key for key in xq._state if key.endswith(".conv.weight")]
    for key in leaves:
        flat, _ = quant.stochastic_operand(xq._state[key])
        got = quant_kernel.stochastic_round(flat, 0)
        torch.cuda.synchronize()
        ref = quant_kernel.stochastic_round_reference(flat, 0)
        k7_mismatch += int((got != ref).sum())
        k7_far = max(k7_far, int((got.int() - torch.round(flat).int())
                                 .abs().max()))
        if not any(part in quant.DEFAULT_QUANT_SKIP
                   for part in key.split(".")):
            path_leaves[key] = (flat, got)
    check(k7_mismatch == 0, f"K7 differs from its twin in {k7_mismatch} "
          f"elements over {len(leaves)} leaves")
    check(k7_far <= 1, f"K7 rounded {k7_far} steps from the nearest")
    largest = max(leaves, key=lambda key: xq._state[key].numel())
    flat_l, _ = quant.stochastic_operand(xq._state[largest])
    seed_hi = 2 ** 40 + 7
    check(torch.equal(quant_kernel.stochastic_round(flat_l, seed_hi),
                      quant_kernel.stochastic_round_reference(flat_l,
                                                              seed_hi)),
          f"K7 differs from its twin under seed {seed_hi}")
    mean_q = torch.zeros_like(flat_l, dtype=torch.float64)
    for seed in range(64):
        mean_q += quant_kernel.stochastic_round(flat_l, seed).double()
    k7_bias = mean_q / 64 - flat_l.double()
    k7_bias_max, k7_bias_mean = (k7_bias.abs().max().item(),
                                 k7_bias.mean().item())
    check(k7_bias_max < 0.45, f"K7 over 64 seeds is {k7_bias_max} steps "
          f"from the value it rounds (limit 0.45)")
    # round to nearest, the card's quantize_fused_params against the CPU's
    # on the same fp32 fold: equal int8 weights and scales
    q_card = quant.quantize_fused_params(xq._state)
    q_cpu = quant.quantize_fused_params({k: v.cpu()
                                         for k, v in xq._state.items()})
    q_differ = [k for k, v in q_cpu.items()
                if not torch.equal(q_card[k].cpu(), v)]
    check(not q_differ, f"int8 state: card differs from CPU at {q_differ[:4]}")
    log(f"phase 4e stochastic round: {len(leaves)} leaves of the x model "
        f"({sum(xq._state[k].numel() for k in leaves)} weights), kernel "
        f"equal to its twin bit for bit at seed 0 and at {seed_hi} on "
        f"{largest} {tuple(flat_l.shape)}; at most {k7_far} step from the "
        f"nearest; over 64 seeds mean error {k7_bias_mean:.3g}, largest "
        f"{k7_bias_max:.4f} steps (limit 0.45); round-to-nearest int8 "
        f"weights and scales of the card equal the CPU's")
    del xq, mean_q, k7_bias, q_card, q_cpu

    # ------------------------------------------- 4f. int8 contraction
    # each route at x channel widths and small maps: the int32 accumulators
    # on the card against the float64 twin on the CPU, bit for bit, and the
    # whole dynamic int8 conv (quantize, contract, dequantize to bf16)
    # against the CPU's, within one bf16 step. Depthwise goes through a
    # float32 conv of the int8 values, checked with TF32 off and on. Then
    # the shape rules of torch._int_mm on this card, probed
    int8_routes = {
        "1x1": ((8, 768, 10, 10), (768, 768, 1, 1), 1, 0, 1),
        "3x3_s1": ((8, 384, 12, 12), (384, 384, 3, 3), 1, 1, 1),
        "3x3_s2": ((8, 768, 12, 12), (768, 768, 3, 3), 2, 1, 1),
        "depthwise_3x3": ((8, 384, 12, 12), (384, 1, 3, 3), 1, 1, 384),
        "s2d_stem_2x2": ((8, 12, 17, 17), (96, 12, 2, 2), 1, 0, 1),
        "stem_3x3_s2": ((2, 3, 16, 16), (96, 3, 3, 3), 2, 1, 1),  # K 27
        "1x1_16_rows": ((1, 768, 4, 4), (768, 768, 1, 1), 1, 0, 1),
    }
    int8_steps = {}
    for name, (xs, ws, stride, pad, groups) in int8_routes.items():
        x = channels_last(xs, torch.bfloat16, gen, dev)
        qw, wscale = quant.quantize_kernel_int8(
            torch.randn(ws, generator=gen) * 0.05)
        bias = torch.randn(ws[0], generator=gen) * 0.1
        qx, ascale = quant.quantize_act_int8(x)
        qx_cpu, ascale_cpu = quant.quantize_act_int8(x.cpu())
        check(torch.equal(qx.cpu(), qx_cpu)
              and torch.equal(ascale.cpu(), ascale_cpu),
              f"int8 activations {name}: card differs from CPU")
        ref = quant.int8_contract_reference(qx_cpu, qw, stride, pad, groups)
        for tf32 in ((False, True) if groups > 1 else (False,)):
            torch.backends.cudnn.allow_tf32 = tf32
            acc = quant.int8_contract(qx, qw.to(dev), stride, pad, groups)
            torch.cuda.synchronize()
            check(acc.dtype == torch.int32 and torch.equal(acc.cpu(), ref),
                  f"int8 contraction {name} (TF32 {tf32}) differs from "
                  f"its float64 twin")
        torch.backends.cudnn.allow_tf32 = False
        got = quant.int8_conv(x, qw.to(dev), wscale.to(dev), bias.to(dev),
                              stride, pad, groups, act=False)
        want = quant.int8_conv(x.cpu(), qw, wscale, bias, stride, pad,
                               groups, act=False,
                               contract=quant.int8_contract_reference)
        int8_steps[name] = bf16_steps(got.cpu(), want)
        check(got.dtype == torch.bfloat16 and int8_steps[name] <= 1.0,
              f"int8 conv {name}: {int8_steps[name]} bf16 steps from the "
              f"CPU's")
    int_mm_rules = {}
    for m, k, n in ((16, 32, 32), (17, 32, 32), (17, 12, 32), (17, 32, 12),
                    (8, 8, 8)):
        a = torch.randint(-127, 128, (m, k), generator=gen,
                          dtype=torch.int8).to(dev)
        bt = torch.randint(-127, 128, (n, k), generator=gen,
                           dtype=torch.int8).to(dev)
        try:
            exact = torch.equal(torch._int_mm(a, bt.t()).cpu(),
                                a.cpu().int() @ bt.cpu().int().t())
            int_mm_rules[f"{m}x{k}x{n}"] = "exact" if exact else "WRONG"
        except RuntimeError as err:
            int_mm_rules[f"{m}x{k}x{n}"] = str(err).splitlines()[0][:80]
    check("WRONG" not in int_mm_rules.values(),
          f"torch._int_mm {int_mm_rules}")
    # the card turns a division by a Python number into a multiplication
    # by its reciprocal: how often that misses the CPU's quotient over the
    # 256 uint8 levels, and that device_preprocess's scaling does not
    levels = torch.arange(256, dtype=torch.uint8)
    scale_255_differ = int((levels.to(dev).float() / 255.0).cpu().ne(
        levels.float() / 255.0).sum())
    pixels = levels.reshape(1, 16, 16, 1).expand(1, 16, 16, 3)
    check(torch.equal(normalize(pixels.to(dev)).cpu(), normalize(pixels)),
          "device_preprocess normalises uint8 levels otherwise on the card "
          "than on the CPU")
    log(f"phase 4f int8 contraction: activations and scales of the card "
        f"equal the CPU's; routes {sorted(int8_routes)} equal "
        f"to the float64 twin in int32 (depthwise with TF32 off and on); "
        f"int8 conv vs the CPU's in bf16 steps {int8_steps}; torch._int_mm "
        f"(M x K x N) on this card: {int_mm_rules}; x / 255.0 misses the "
        f"CPU's quotient at {scale_255_differ} of 256 uint8 levels on the "
        f"card, normalize_uint8 at none")

    # ------------------------------------------- 5. full-width serving
    det = Detector(p["width"], p["depth"], p["csp"], NUM_CLASSES,
                   precision="bfloat16", input_size=(HW, HW), device="cuda")
    t0 = time.perf_counter()
    det.init(SEED)
    det.fuse()
    log(f"phase 5 x preset: {sum(x.numel() for x in det.model.parameters())} "
        f"parameters, init+fuse {time.perf_counter() - t0:.2f} s")
    img_gen = torch.Generator().manual_seed(SEED + 1)
    batch = torch.randint(0, 256, (SERVE_BATCH, HW, HW, 3), generator=img_gen,
                          dtype=torch.uint8).to(dev)
    single = torch.randint(0, 256, (HW, HW, 3), generator=img_gen,
                           dtype=torch.uint8).numpy()

    reset_counts()
    result = det.serve(batch, conf_thres=POOL_CONF, device_preprocess=True)
    torch.cuda.synchronize()
    serve_launches = read_counts()
    dets = det.inference(single, conf_thres=POOL_CONF)
    torch.cuda.synchronize()
    launches = read_counts()
    check(serve_launches == counts(attention=2, nms_batched=1, sppf=1),
          f"serve launched {serve_launches}, want attention 2, batched NMS "
          f"1, SPPF 1")
    check(launches == counts(attention=4, nms_batched=1, nms_single=1,
                             sppf=2),
          f"serve + inference launched {launches}, want attention 4, SPPF "
          f"2, one batched and one single-image NMS")

    nv = result.num_valid.cpu()
    max_det = min(300, num_anchors((HW, HW)))
    check(result.boxes.shape == (SERVE_BATCH, max_det, 4),
          "serve result shape")
    for name in result._fields:
        value = getattr(result, name)
        if value.is_floating_point():
            check(bool(torch.isfinite(value).all()), f"non-finite {name}")
    check(int(nv.min()) > 0, "an image of the batch has no detection")
    check(len(dets) == 1 and dets[0].shape[1] == 6 and len(dets[0]) > 0,
          "inference returned no (n, 6) detections")
    preds, anchors, strides = det(normalize(batch))
    _, scores = decode_raw_predictions(preds, anchors, strides)
    n_cand = (scores.amax(-1) > POOL_CONF).sum(-1).cpu().tolist()
    log(f"phase 5 serve B={SERVE_BATCH}: candidates above {POOL_CONF} "
        f"{n_cand} (pool 1024), detections {nv.tolist()}; inference: "
        f"{len(dets[0])} detections; launches {launches}")

    # ------------------------------- 5b. optimised serving, full width
    # init → fuse → optimize_for_serving (space-to-depth stem, merged C3K
    # convs), then the fused cls tower on top; same seed as `det`
    opt = Detector(p["width"], p["depth"], p["csp"], NUM_CLASSES,
                   precision="bfloat16", input_size=(HW, HW), device="cuda")
    opt.init(SEED)
    opt.fuse().optimize_for_serving()
    state_keys = list(opt.model.state_dict())
    n_merged = sum(k.endswith(".conv12.conv.weight") for k in state_keys)
    check(opt.model.net.p1_conv.conv.weight.shape[1:] == (12, 2, 2)
          and n_merged > 0
          and "net.p2_csp.m0.conv1.conv.weight" in state_keys,
          "optimize_for_serving: stem not space-to-depth, no merged C3K, "
          "or the narrow p2 C3K merged")
    norm_batch = normalize(batch)
    preds_plain = det(norm_batch)[0].float()
    preds_opt = opt(norm_batch)[0].float()
    top = preds_plain.abs().max().item()
    opt_err = (preds_opt - preds_plain).abs().max().item()
    check(opt_err < 3e-2 * top, f"bf16 predictions: optimised vs fused "
          f"{opt_err}, limit 3e-2 of {top}")
    # the fused cls tower against the conv chain, on logits widened so that
    # they depend on the tower; the weights are put back after
    widen, cls_chain = widen_cls_logits(opt, norm_batch)
    opt.model.head.fused_cls_tower = True
    cls_k6 = opt(norm_batch)[0][..., 4 * opt.model.head.reg_max:].float()
    scale_cls_logits(opt.model.head, 1.0 / widen)
    k6_top = cls_chain.abs().max().item()
    k6_err = (cls_k6 - cls_chain).abs().max().item()
    k6_mean_err = (cls_k6 - cls_chain).abs().mean().item()
    check(bool(torch.isfinite(cls_k6).all()) and k6_err < 3e-2 * k6_top
          and k6_mean_err < 1e-3 * k6_top,
          f"bf16 class logits (weights x{widen}): fused cls tower vs conv "
          f"chain {k6_err}, mean {k6_mean_err}, limits 3e-2 and 1e-3 of "
          f"{k6_top}")
    check(torch.equal(opt(norm_batch)[0][..., :4 * opt.model.head.reg_max]
                      .float(), preds_opt[..., :4 * opt.model.head.reg_max]),
          "the fused cls tower changed the box logits")
    reset_counts()
    result_opt = opt.serve(batch, conf_thres=POOL_CONF,
                           device_preprocess=True)
    torch.cuda.synchronize()
    opt_serve_launches = read_counts()
    dets_opt = opt.inference(single, conf_thres=POOL_CONF)
    torch.cuda.synchronize()
    opt_launches = read_counts()
    check(opt_serve_launches == counts(attention=2, nms_batched=1, sppf=1,
                                       cls_tower=6),
          f"optimised serve launched {opt_serve_launches}, want attention "
          f"2, SPPF 1, cls tower 6 (2 stages x 3 levels), batched NMS 1")
    check(opt_launches == counts(attention=4, nms_batched=1, nms_single=1,
                                 sppf=2, cls_tower=12),
          f"optimised serve + inference launched {opt_launches}; the "
          f"single request must take the single-image NMS and no batched")
    for name in result_opt._fields:
        value = getattr(result_opt, name)
        if value.is_floating_point():
            check(bool(torch.isfinite(value).all()),
                  f"optimised serve: non-finite {name}")
    check(int(result_opt.num_valid.min()) > 0 and len(dets_opt) == 1
          and dets_opt[0].shape[1] == 6 and len(dets_opt[0]) > 0,
          "optimised serve or inference returned no detection")
    log(f"phase 5b x preset fused+optimised bf16: {n_merged} merged C3Ks, "
        f"s2d stem; predictions vs fused max abs err {opt_err} (limit 3e-2 "
        f"of {top}); class logits with their weights x{widen}, fused cls "
        f"tower vs its conv chain: max abs err {k6_err}, mean "
        f"{k6_mean_err} (limits 3e-2 and 1e-3 of {k6_top}); detections {result_opt.num_valid.cpu().tolist()}, "
        f"inference {len(dets_opt[0])}; launches serve "
        f"{opt_serve_launches}, serve + inference {opt_launches}")

    # ------------------------------------------- 5c. int8 serving, full width
    # the seed of `det`: init → fuse → quantize(stochastic=True, skip="auto")
    # → calibrate on two seeded uint8 batches → serve and inference, with
    # the fused cls tower asked for (a quantized head never takes K6)
    def x_detector():
        return Detector(p["width"], p["depth"], p["csp"], NUM_CLASSES,
                        precision="bfloat16", input_size=(HW, HW),
                        device="cuda")

    q8 = x_detector()
    q8.init(SEED)
    q8.fuse()
    reset_counts()
    q8.quantize(stochastic=True)
    torch.cuda.synchronize()
    quantize_launches = read_counts()
    n_leaves = sum(key.endswith(".conv.scale") for key in q8._state)
    check(quantize_launches == counts(stochastic_round=n_leaves)
          and n_leaves == len(path_leaves),
          f"quantize launched {quantize_launches}, want K7 once for each "
          f"of {n_leaves} int8 leaves ({len(path_leaves)} in phase 4e)")
    for key, (_, q) in path_leaves.items():
        o, i, kh, kw = q8._state[key].shape
        check(torch.equal(q8._state[key], q.view(kh, kw, i, o)
                          .permute(3, 2, 0, 1)),
              f"{key}: quantize() holds other int8 weights than K7 gave")
    dyn_state = dict(q8._state)
    cal_gen = torch.Generator().manual_seed(SEED + 5)
    cal_batches = [norm_batch, normalize(torch.randint(
        0, 256, (SERVE_BATCH, HW, HW, 3), generator=cal_gen,
        dtype=torch.uint8).to(dev))]
    reset_counts()
    q8.calibrate(cal_batches)
    torch.cuda.synchronize()
    calibrate_launches = read_counts()
    check(calibrate_launches == counts(attention=4, sppf=2),
          f"calibrate launched {calibrate_launches}, want attention 4 and "
          f"SPPF 2 (two dynamic forwards)")
    q8.model.head.fused_cls_tower = True
    reset_counts()
    result8 = q8.serve(batch, conf_thres=POOL_CONF, device_preprocess=True)
    torch.cuda.synchronize()
    dets8 = q8.inference(single, conf_thres=POOL_CONF)
    torch.cuda.synchronize()
    serve8_launches = read_counts()
    check(serve8_launches == counts(attention=4, nms_batched=1,
                                    nms_single=1, sppf=2),
          f"int8 serve + inference launched {serve8_launches}, want "
          f"attention 4, SPPF 2, one batched and one single-image NMS, no "
          f"cls tower")
    int8_launches = {k: quantize_launches[k] + calibrate_launches[k]
                     + serve8_launches[k] for k in COUNTED}
    for name in result8._fields:
        value = getattr(result8, name)
        if value.is_floating_point():
            check(bool(torch.isfinite(value).all()),
                  f"int8 serve: non-finite {name}")
    check(int(result8.num_valid.min()) > 0 and len(dets8) == 1
          and dets8[0].shape[1] == 6 and len(dets8[0]) > 0,
          "int8 serve or inference returned no detection")
    # raw predictions against the bf16 fused `det`: the box logits (the
    # class logits of random weights are all bias)
    rm4 = 4 * q8.model.head.reg_max
    preds8 = q8(norm_batch)[0].float()
    check(bool(torch.isfinite(preds8).all()), "int8 predictions not finite")
    int8_corr = pearson(preds8[..., :rm4], preds_plain[..., :rm4])
    int8_corr_all = pearson(preds8, preds_plain)
    check(int8_corr > INT8_CORR, f"int8 box logits vs bf16: Pearson "
          f"{int8_corr} (limit {INT8_CORR})")
    # static equals dynamic on the batch it was calibrated on
    q8dyn = x_detector()
    q8dyn.load_variables(dyn_state)
    q8one = x_detector()
    q8one.load_variables(dyn_state)
    q8one.calibrate(cal_batches[:1])
    check(torch.equal(q8one(norm_batch)[0], q8dyn(norm_batch)[0]),
          "static int8 differs from dynamic on its calibration batch")
    # the exact transforms after quantize: only the float stem's conv sums
    # in another order, so int8 steps flip downstream
    q8opt = x_detector()
    q8opt.load_variables(q8._state)
    q8opt.optimize_for_serving()
    check(q8opt.model.net.p1_conv.conv.weight.shape[1:] == (12, 2, 2)
          and any(".conv12.conv.in_scale" in k for k in q8opt._state),
          "optimize_for_serving after quantize: no s2d stem or no merged "
          "static int8 C3K")
    preds8_opt = q8opt(norm_batch)[0].float()
    int8_top = preds8.abs().max().item()
    int8_opt_err = (preds8_opt - preds8).abs().max().item()
    int8_opt_corr = pearson(preds8_opt[..., :rm4], preds8[..., :rm4])
    check(int8_opt_err <= INT8_STEPS / 127 * int8_top
          and int8_opt_corr > INT8_OPT_CORR,
          f"int8 predictions: optimised vs not {int8_opt_err} (limit "
          f"{INT8_STEPS}/127 of {int8_top}), box-logit Pearson "
          f"{int8_opt_corr} (limit {INT8_OPT_CORR})")
    log(f"phase 5c x preset int8 (stochastic, skip {quant.DEFAULT_QUANT_SKIP}"
        f", static): {n_leaves} int8 leaves, K7 launched once each at "
        f"quantize and equal to phase 4e's; calibrate on two batches; "
        f"detections {result8.num_valid.cpu().tolist()}, inference "
        f"{len(dets8[0])}; box logits vs bf16 fused Pearson {int8_corr} "
        f"(limit {INT8_CORR}; all logits {int8_corr_all}); static == "
        f"dynamic bit for bit on its calibration batch; optimised vs not "
        f"max abs err {int8_opt_err} of {int8_top}, Pearson {int8_opt_corr}"
        f"; launches quantize {quantize_launches}, calibrate "
        f"{calibrate_launches}, serve + inference {serve8_launches}")
    del q8one, q8opt, dyn_state

    # ------------------------------------------- 6. card against CPU
    gpu32 = Detector(p["width"], p["depth"], p["csp"], NUM_CLASSES,
                     precision="float32", input_size=(HW, HW), device="cuda")
    cpu32 = Detector(p["width"], p["depth"], p["csp"], NUM_CLASSES,
                     precision="float32", input_size=(HW, HW), device="cpu")
    for d in (gpu32, cpu32):
        d.init(SEED)
        d.fuse()
    image = batch[:1].cpu()
    norm = normalize(image)
    t0 = time.perf_counter()
    preds_c, anchors_c, strides_c = cpu32(norm)
    cpu_s = time.perf_counter() - t0
    preds_g, _, _ = gpu32(norm)
    scale = preds_c.abs().max().item()
    pred_err = (preds_g.cpu() - preds_c).abs().max().item()
    pred_tol = 1e-3 * max(scale, 1.0)
    check(pred_err <= pred_tol, f"fp32 predictions: card vs CPU max abs err "
          f"{pred_err} > {pred_tol}")
    boxes_c, scores_c = decode_raw_predictions(preds_c, anchors_c, strides_c)
    # NMS from identical decoded inputs: the kernel path must equal the twin
    nms_args = (boxes_c, scores_c.amax(-1), scores_c.argmax(-1))
    res_c = batched_nms(*nms_args, conf_thres=POOL_CONF)
    res_g = batched_nms(*(a.to(dev) for a in nms_args), conf_thres=POOL_CONF)
    for name in res_c._fields:
        check(torch.equal(getattr(res_g, name).cpu(), getattr(res_c, name)),
              f"batched_nms {name}: card differs from CPU on equal inputs")
    # end to end. The class logits of random weights all sit at the bias
    # prior, so rounding decides which class wins; the logit weights of
    # both models are widened by the same power of two (exact to undo) so
    # that the features decide. Then a gate in a wide gap of the CPU's
    # scores, away from ties
    widen_e2e, cls_c = widen_cls_logits(cpu32, norm)
    scale_cls_logits(gpu32.model.head, widen_e2e)
    best = torch.sort(torch.sigmoid(cls_c).amax(-1)[0],
                      descending=True).values
    lo, hi = len(best) // 80, len(best) // 28     # ranks 105..300 at 640²
    gaps = best[lo:hi] - best[lo + 1:hi + 1]
    at = lo + int(gaps.argmax())
    conf = float((best[at] + best[at + 1]) / 2)
    e2e_c = cpu32.serve(image, conf_thres=conf, device_preprocess=True)
    e2e_g = gpu32.serve(image.to(dev), conf_thres=conf,
                        device_preprocess=True)
    n_c, n_g = int(e2e_c.num_valid[0]), int(e2e_g.num_valid[0])
    check(n_c == n_g, f"end-to-end detections: card {n_g} vs CPU {n_c}")
    check(torch.equal(e2e_g.classes.cpu(), e2e_c.classes),
          "end-to-end detection classes differ")
    box_err = (e2e_g.boxes.cpu() - e2e_c.boxes).abs().max().item()
    check(box_err <= 1e-2, f"end-to-end boxes differ by {box_err} px")
    # the exact transforms, fp32 on the card: same predictions (1e-4, the
    # merged and space-to-depth convs sum in another order) and the same
    # detections; the fused cls tower on top within the same limit
    opt32 = Detector(p["width"], p["depth"], p["csp"], NUM_CLASSES,
                     precision="float32", input_size=(HW, HW), device="cuda")
    opt32.init(SEED)
    opt32.optimize_for_serving().fuse()        # the other order than 5b
    check(any(".conv12." in k for k in opt32.model.state_dict()),
          "fuse() after optimize_for_serving() did not merge the C3Ks")
    preds_o, _, _ = opt32(norm)
    opt32_err = (preds_o - preds_g).abs().max().item()
    check(torch.allclose(preds_o, preds_g, atol=1e-4 * max(scale, 1.0),
                         rtol=1e-4),
          f"fp32 predictions: fused+optimised vs fused differ by {opt32_err}")
    widen32, cls_o = widen_cls_logits(opt32, norm)
    opt32.model.head.fused_cls_tower = True
    cls_k = opt32(norm)[0][..., 4 * opt32.model.head.reg_max:]
    # from the K6 check's widening to the end-to-end one
    scale_cls_logits(opt32.model.head, widen_e2e / widen32)
    k6_32_top = cls_o.abs().max().item()
    k6_32_err = (cls_k - cls_o).abs().max().item()
    check(torch.allclose(cls_k, cls_o, atol=1e-4 * max(k6_32_top, 1.0),
                         rtol=1e-4),
          f"fp32 class logits (weights x{widen32}): fused cls tower vs conv "
          f"chain differ by {k6_32_err}, largest {k6_32_top}")
    for label, on in (("conv chain", False), ("fused cls tower", True)):
        opt32.model.head.fused_cls_tower = on
        e2e_o = opt32.serve(image.to(dev), conf_thres=conf,
                            device_preprocess=True)
        check(int(e2e_o.num_valid[0]) == n_g
              and torch.equal(e2e_o.classes, e2e_g.classes)
              and torch.equal(e2e_o.valid, e2e_g.valid),
              f"fused+optimised ({label}) and fused serve give other "
              f"detections")
        o_box_err = (e2e_o.boxes - e2e_g.boxes).abs().max().item()
        check(o_box_err <= 1e-2, f"fused+optimised ({label}) boxes differ "
              f"by {o_box_err} px")
    log(f"phase 6 fp32 fused+optimised vs fused on the card: preds max abs "
        f"err {opt32_err} (limit 1e-4 of max(|preds|, 1)); class logits "
        f"with their weights x{widen32}, fused cls tower vs conv chain "
        f"{k6_32_err} (limit 1e-4 of {k6_32_top}); detections equal, boxes within "
        f"{o_box_err} px")
    log(f"phase 6 fp32 card vs CPU (TF32 off): preds max abs err {pred_err} "
        f"(tolerance {pred_tol}, |preds| max {scale}); NMS on equal inputs "
        f"identical ({int(res_c.num_valid[0])} detections at {POOL_CONF}); "
        f"end to end (class logit weights x{widen_e2e}) at conf "
        f"{conf:.6f}: {n_g} detections each, classes equal, boxes within "
        f"{box_err} px; CPU forward {cpu_s:.1f} s")
    del gpu32, cpu32, opt32

    # ------------------------------------------- 6b. full-width training
    # x preset, 640², bf16: 5 steps with the task-aligned assigner, then 2
    # with the nearest-centre one, on one seeded batch
    torch.cuda.empty_cache()
    train_n = TRAIN_BATCH
    nearest_steps, tal_steps = 2, 5
    while True:
        model = optimizer = state = tal_step = None
        try:
            torch.cuda.reset_peak_memory_stats()
            model, optimizer, state, tal_step = train_engine(
                p["width"], p["depth"], p["csp"], NUM_CLASSES, "bfloat16",
                "cuda", SEED, "tal")
            tbatch = train_batch(train_n, HW, TRAIN_MAX_BOXES, NUM_CLASSES,
                                 SEED + 2, dev)
            reset_counts()
            tal_metrics = []
            for _ in range(tal_steps):
                state, metrics = tal_step(state, tbatch)
                tal_metrics.append({k: float(v) for k, v in metrics.items()})
            break
        except torch.cuda.OutOfMemoryError:
            check(train_n > 1, "the x preset does not train at batch 1")
            log(f"phase 6b batch {train_n} does not fit in device memory; "
                f"halving the batch (the width stays)")
            del model, optimizer, state, tal_step
            torch.cuda.empty_cache()
            train_n //= 2
    qkv_grads = {name: float(prm.grad.float().abs().max())
                 for name, prm in model.named_parameters()
                 if name.endswith("attn.qkv.conv.weight")}
    nearest_step = make_train_step(
        model, DetectionLoss(LossConfig(num_classes=NUM_CLASSES,
                                        assigner="nearest")),
        optimizer, ema_decay=0.9999, warmup_steps=3)
    nearest_metrics = []
    for _ in range(nearest_steps):
        state, metrics = nearest_step(state, tbatch)
        nearest_metrics.append({k: float(v) for k, v in metrics.items()})
    torch.cuda.synchronize()
    train_peak_gb = torch.cuda.max_memory_allocated() / 2 ** 30
    train_launches = read_counts()
    steps = tal_steps + nearest_steps
    check(train_launches == counts(attention=2 * steps,
                                   attention_bwd=2 * steps),
          f"{steps} train steps launched {train_launches}, want attention "
          f"and attention_bwd {2 * steps} each (2 per step) and no other "
          f"kernel (a training forward keeps the max_pool2d chain)")
    for i, metrics in enumerate(tal_metrics + nearest_metrics):
        check(all(np.isfinite(v) for v in metrics.values()),
              f"train step {i + 1}: non-finite metric in {metrics}")
    check(set(tal_metrics[0]) == {"total_loss", "box_loss", "cls_loss",
                                  "dfl_loss", "grad_norm"}
          and set(nearest_metrics[0]) == {"total_loss", "box_loss",
                                          "cls_loss", "grad_norm"},
          "train metrics carry other names than the reference's")
    check(len(qkv_grads) == 2 and all(g > 0 for g in qkv_grads.values()),
          f"the PSA qkv convolutions' weight gradients: {qkv_grads} (zero "
          f"means the attention kernel cut the graph)")
    check(tal_metrics[-1]["total_loss"] < tal_metrics[0]["total_loss"],
          f"TAL loss did not fall on one batch: {tal_metrics[0]} → "
          f"{tal_metrics[-1]}")
    check(state.step == steps and tal_metrics[0]["box_loss"] > 0,
          "train state step count, or no TAL positive in the batch")
    ema_gap = max(float((state.ema[k] - v).abs().max())
                  for k, v in state.variables.items())
    check(0 < ema_gap, "the EMA did not lag the live parameters")
    log(f"phase 6b x preset train B={train_n} bf16: "
        f"{sum(x.numel() for x in model.parameters())} parameters; TAL "
        f"total_loss per step {[m['total_loss'] for m in tal_metrics]}, "
        f"grad_norm {[m['grad_norm'] for m in tal_metrics]}; nearest "
        f"total_loss {[m['total_loss'] for m in nearest_metrics]}; qkv "
        f"weight |grad| max {qkv_grads}; launches {train_launches}; peak "
        f"memory {train_peak_gb:.2f} GiB")

    # ------------------------------------------- 6d. full-width evaluation
    # the state trained above, the same batch: eval step (EMA weights,
    # running statistics), decode without and with NMS, both metrics. The
    # gate is the low one of serving: after 7 steps no score reaches 0.25.
    eval_step = make_eval_step(
        model, DetectionLoss(LossConfig(num_classes=NUM_CLASSES,
                                        assigner="tal")))
    eval_launches = counts()
    eval_results = {}
    for use_nms in (False, True):
        reset_counts()
        loss_metrics, decoded, greedy, coco = evaluate(
            eval_step, state, tbatch, NUM_CLASSES, POOL_CONF, use_nms)
        torch.cuda.synchronize()
        got = read_counts()
        want = counts(attention=2, sppf=1, nms_batched=int(use_nms))
        check(got == want, f"eval step + decode (use_nms={use_nms}) "
              f"launched {got}, want {want}")
        eval_launches = {k: eval_launches[k] + v for k, v in got.items()}
        check(model.training, "the eval step left the model in eval mode")
        check(decoded.boxes_xywh.shape == (train_n, 100, 4)
              and int(decoded.valid.sum()) > 0
              and bool(torch.isfinite(decoded.boxes_xywh).all()),
              f"decode (use_nms={use_nms}) gave no finite detections")
        for name, values in (("loss", loss_metrics), ("greedy", greedy),
                             ("coco", coco)):
            check(all(np.isfinite(v) for v in values.values()),
                  f"eval (use_nms={use_nms}): non-finite {name} metric in "
                  f"{values}")
        check(0 < greedy["total_predictions"] <= int(decoded.valid.sum())
              and greedy["total_ground_truths"]
              <= int(tbatch["gt_mask"].sum()),
              f"DetectionMetrics counted {greedy}")
        eval_results[use_nms] = (greedy, coco)
        log(f"phase 6d x preset eval B={train_n} use_nms={use_nms} at conf "
            f"{POOL_CONF}: loss {loss_metrics}; DetectionMetrics {greedy}; "
            f"COCOmAP {coco}; launches {got}")
    check(eval_results[True][0]["total_predictions"]
          <= eval_results[False][0]["total_predictions"],
          "NMS in the decode added predictions")

    # ------------------------------------------- 6c. train step, card vs CPU
    small_metrics, small_grads = {}, {}
    for device in ("cpu", "cuda"):
        small, _, small_state, small_step = train_engine(
            SMALL["width"], SMALL["depth"], SMALL["csp"],
            SMALL["num_classes"], "float32", device, SEED, "tal")
        sbatch = train_batch(SMALL["batch"], SMALL["hw"], SMALL["boxes"],
                             SMALL["num_classes"], SEED + 3, device,
                             size=(0.4, 0.9))
        _, metrics = small_step(small_state, sbatch)
        small_metrics[device] = {k: float(v) for k, v in metrics.items()}
        small_grads[device] = {k: prm.grad.detach().cpu()
                               for k, prm in small.named_parameters()}
    loss_c = small_metrics["cpu"]["total_loss"]
    loss_g = small_metrics["cuda"]["total_loss"]
    check(small_metrics["cpu"]["box_loss"] > 0,
          "the small batch gave the task-aligned assigner no positive")
    check(abs(loss_g - loss_c) <= 1e-4 * abs(loss_c),
          f"fp32 train step: loss on the card {loss_g} vs CPU {loss_c}")
    g_max = max(float(g.abs().max()) for g in small_grads["cpu"].values())
    g_err = max(float((small_grads["cuda"][k] - g).abs().max())
                for k, g in small_grads["cpu"].items())
    check(g_err <= 1e-3 * g_max, f"fp32 train step: gradients differ by "
          f"{g_err}, largest gradient {g_max}")
    log(f"phase 6c fp32 train step card vs CPU (TF32 off, small model, "
        f"64², B={SMALL['batch']}): loss {loss_g} vs {loss_c} (limit 1e-4 "
        f"relative); gradients max abs err {g_err} (limit 1e-3 of the "
        f"largest, {g_max}); metrics card {small_metrics['cuda']}")
    del small, small_state, small_step, small_grads

    # ------------------------------------------- 6e. evaluation, card vs CPU
    # the small model, fp32, the same seeded weights on both devices: the same
    # decoded boxes (1e-3 of the largest coordinate) and identical metric
    # counters, with the gate in a wide gap of the CPU's scores
    small_eval = {}
    conf_small = None
    for device in ("cpu", "cuda"):
        small, _, small_state, _ = train_engine(
            SMALL["width"], SMALL["depth"], SMALL["csp"],
            SMALL["num_classes"], "float32", device, SEED, "tal")
        sbatch = train_batch(SMALL["batch"], SMALL["hw"], SMALL["boxes"],
                             SMALL["num_classes"], SEED + 3, device,
                             size=(0.4, 0.9))
        step_fn = make_eval_step(small, DetectionLoss(LossConfig(
            num_classes=SMALL["num_classes"], assigner="tal")))
        # untrained, every class score sits within 1e-7 of the bias prior:
        # widen the logits' weights so that the scores spread and a gate
        # can sit in a gap
        for key, value in small_state.eval_variables.items():
            if key.startswith("head.cls") and key.endswith("_out.weight"):
                value.mul_(5000.0)
        if conf_small is None:
            _, preds_s, _, _ = step_fn(small_state, sbatch)
            best = torch.sort(torch.sigmoid(preds_s[..., 64:]).amax(-1)
                              .flatten(), descending=True).values
            gaps = best[8:40] - best[9:41]
            at = 8 + int(gaps.argmax())
            conf_small = float((best[at] + best[at + 1]) / 2)
        small_eval[device] = {
            use_nms: evaluate(step_fn, small_state, sbatch,
                              SMALL["num_classes"], conf_small, use_nms)
            for use_nms in (False, True)}
    for use_nms in (False, True):
        (loss_c, dec_c, greedy_c, coco_c) = small_eval["cpu"][use_nms]
        (loss_g, dec_g, greedy_g, coco_g) = small_eval["cuda"][use_nms]
        check(torch.equal(dec_g.valid.cpu(), dec_c.valid)
              and torch.equal(dec_g.classes.cpu(), dec_c.classes)
              and int(dec_c.valid.sum()) > 0,
              f"small eval (use_nms={use_nms}): card and CPU decode other "
              f"detections")
        span = dec_c.boxes_xywh.abs().max().item()
        dec_err = (dec_g.boxes_xywh.cpu() - dec_c.boxes_xywh).abs().max() \
            .item()
        check(dec_err <= 1e-3 * span, f"small eval (use_nms={use_nms}): "
              f"decoded boxes differ by {dec_err}, largest {span}")
        counters = ("true_positives", "false_positives", "false_negatives",
                    "total_predictions", "total_ground_truths")
        check(all(greedy_g[k] == greedy_c[k] for k in counters),
              f"small eval (use_nms={use_nms}): metric counters differ, "
              f"card {greedy_g} vs CPU {greedy_c}")
        check(all(abs(coco_g[k] - coco_c[k]) <= 1e-6 for k in coco_c),
              f"small eval (use_nms={use_nms}): COCOmAP differs, card "
              f"{coco_g} vs CPU {coco_c}")
        log(f"phase 6e fp32 eval card vs CPU (small model, use_nms="
            f"{use_nms}, conf {conf_small:.6f}): "
            f"{int(dec_c.valid.sum())} detections each, boxes within "
            f"{dec_err} (limit 1e-3 of {span}); counters equal "
            f"{ {k: greedy_c[k] for k in counters} }; mAP_50 card "
            f"{coco_g['mAP_50']} vs CPU {coco_c['mAP_50']}")
    del small, small_state, small_eval

    # ------------------------------------------- 6f. int8, card vs CPU
    # the small model, fp32, TF32 off: quantized and calibrated on the CPU,
    # the same static state served on both devices. The int32 products are
    # exact on both; the float stages (p1, p2) sum in another order, and an
    # activation one ulp apart can flip an int8 step downstream
    small_gen = torch.Generator().manual_seed(SEED + 6)
    small_in = [normalize(torch.randint(
        0, 256, (SMALL["batch"], SMALL["hw"], SMALL["hw"], 3),
        generator=small_gen, dtype=torch.uint8)) for _ in range(2)]
    small8 = {}
    for device in ("cpu", "cuda"):
        small8[device] = Detector(
            SMALL["width"], SMALL["depth"], SMALL["csp"],
            SMALL["num_classes"], precision="float32",
            input_size=(SMALL["hw"], SMALL["hw"]), device=device)
    small8["cpu"].init(SEED)
    small8["cpu"].quantize()
    small8["cpu"].calibrate(small_in[:1])
    small8["cuda"].load_variables({k: v.to(dev) for k, v
                                   in small8["cpu"]._state.items()})
    p8_c = small8["cpu"](small_in[1])[0]
    p8_g = small8["cuda"](small_in[1].to(dev))[0].cpu()
    int8_cpu_top = p8_c.abs().max().item()
    int8_cpu_err = (p8_g - p8_c).abs().max().item()
    int8_cpu_corr = pearson(p8_g, p8_c)
    check(int8_cpu_err <= INT8_STEPS / 127 * int8_cpu_top
          and int8_cpu_corr > INT8_CPU_CORR,
          f"int8 fp32 predictions: card vs CPU {int8_cpu_err} (limit "
          f"{INT8_STEPS}/127 of {int8_cpu_top}), Pearson {int8_cpu_corr} "
          f"(limit {INT8_CPU_CORR})")
    log(f"phase 6f int8 fp32 card vs CPU (TF32 off, small model, static "
        f"scales from the CPU): preds max abs err {int8_cpu_err} (limit "
        f"{INT8_STEPS}/127 of {int8_cpu_top}), Pearson {int8_cpu_corr} "
        f"(limit {INT8_CPU_CORR}), equal: {torch.equal(p8_g, p8_c)}")
    del small8

    # ------------------------------------------------------ 7. timings
    # K1 at the x shape: device time (profiler) and one call's events, the
    # library's attention the same two ways; then the fp32 route at the
    # same shape, B=1 beside the library, and T=1024
    qkv = qkv_x

    def k1_of(x):
        return lambda: attention.psa_attention(x, nh, dk, dh)

    def sdpa_of(x):
        x4 = x.view(x.shape[0], x.shape[1], nh, 2 * dk + dh).transpose(1, 2)
        return lambda: F.scaled_dot_product_attention(
            x4[..., :dk], x4[..., dk:2 * dk], x4[..., 2 * dk:])

    k1_ms = device_ms(k1_of(qkv))
    k1_call_ms = time_ms(k1_of(qkv))
    k1_plain = time_ms(lambda: attention.psa_attention_reference(
        qkv, nh, dk, dh))
    q4 = qkv.view(b, t, nh, 2 * dk + dh).transpose(1, 2)
    q, kk, vv = q4[..., :dk], q4[..., dk:2 * dk], q4[..., 2 * dk:]
    k1_lib = device_ms(sdpa_of(qkv))
    k1_lib_call = time_ms(sdpa_of(qkv))
    k1_bound, k4_bound = attention_bounds(b, t, nh, dk, dh, torch.bfloat16)
    qkv_fp32 = qkv.float()
    k1_fp32_ms = device_ms(k1_of(qkv_fp32))
    k1_fp32_bound, k4_fp32_bound = attention_bounds(b, t, nh, dk, dh,
                                                    torch.float32)
    qkv_b1 = qkv[:1].contiguous()
    k1_b1_ms = device_ms(k1_of(qkv_b1))
    k1_b1_lib = device_ms(sdpa_of(qkv_b1))
    k1_b1_bound = attention_bounds(1, t, nh, dk, dh, torch.bfloat16)[0]
    qkv_long = torch.randn(2, 1024, nh * (2 * dk + dh), generator=gen).to(
        dev, torch.bfloat16)
    k1_long_ms = device_ms(k1_of(qkv_long))
    k1_long_lib = device_ms(sdpa_of(qkv_long))
    k1_long_bound = attention_bounds(2, 1024, nh, dk, dh,
                                     torch.bfloat16)[0]
    del qkv_long

    # K2 on the pool the main path hands it: the serve batch's candidates
    boxes_s, scores_s = decode_raw_predictions(
        *det(normalize(batch)))
    cand_boxes, _, cand_classes, cand_valid = _gather_candidates(
        boxes_s, scores_s.amax(-1), scores_s.argmax(-1).to(torch.int32),
        conf_thres=POOL_CONF, top_k=1024)
    shifted = (cand_boxes + (cand_classes.float() * MAX_WH)[..., None]
               ).contiguous()
    keep = nms_kernel.nms_keep_batched(shifted, cand_valid, 0.45)
    k2_ms = time_ms(lambda: nms_kernel.nms_keep_batched(
        shifted, cand_valid, 0.45))
    k2_plain = time_ms(lambda: nms_kernel.nms_keep_reference(
        shifted, cand_valid, 0.45), reps=10, warmup=1)
    k2_bound = nms_bound_ms(keep)

    # K3 on the pool a single-image request hands it (the first image's),
    # beside the batched kernel on the same one image
    one_boxes = shifted[:1].contiguous()
    one_valid = cand_valid[:1].contiguous()
    keep_one = nms_kernel.nms_keep_single(one_boxes, one_valid, 0.45)
    check(torch.equal(keep_one, keep[:1]),
          "single-image NMS differs from the batched kernel on the serve "
          "pool")
    k3_ms = time_ms(lambda: nms_kernel.nms_keep_single(
        one_boxes, one_valid, 0.45))
    k3_batched_ms = time_ms(lambda: nms_kernel.nms_keep_batched(
        one_boxes, one_valid, 0.45))
    k3_plain = time_ms(lambda: nms_kernel.nms_keep_reference(
        one_boxes, one_valid, 0.45), reps=10, warmup=1)
    k3_bound = nms_bound_ms(keep_one)
    # and on a pool where nearly every box survives (random boxes of 20
    # classes): the batched kernel then pays a block-wide barrier per box
    dense_boxes, dense_valid = nms_pool(2, 1024, 0.45,
                                        np.random.RandomState(SEED + 4))
    dense_boxes = torch.from_numpy(dense_boxes[:1]).to(dev)
    dense_valid = torch.from_numpy(dense_valid[:1]).to(dev)
    dense_keep = nms_kernel.nms_keep_single(dense_boxes, dense_valid, 0.45)
    check(torch.equal(dense_keep, nms_kernel.nms_keep_batched(
        dense_boxes, dense_valid, 0.45)), "single-image NMS differs from "
        "the batched kernel on the dense pool")
    k3_dense_ms = time_ms(lambda: nms_kernel.nms_keep_single(
        dense_boxes, dense_valid, 0.45))
    k3_dense_batched_ms = time_ms(lambda: nms_kernel.nms_keep_batched(
        dense_boxes, dense_valid, 0.45))

    # K5 at the x preset's p5 map; the library's chain is its twin
    p5 = channels_last((SERVE_BATCH, 384, 20, 20), torch.bfloat16, gen, dev)
    k5_ms = time_ms(lambda: sppf_kernel.sppf_pyramid(p5))
    k5_plain = time_ms(lambda: sppf_kernel.sppf_pyramid_reference(p5))

    def pool_chain():
        y1 = F.max_pool2d(p5, 5, 1, 2)
        y2 = F.max_pool2d(y1, 5, 1, 2)
        return torch.cat([p5, y1, y2, F.max_pool2d(y2, 5, 1, 2)], dim=1)

    k5_lib = time_ms(pool_chain)
    k5_bound = roofline(5 * p5.numel() * 2, 3 * 8 * p5.numel(), FP32_FLOPS)

    # K6 on what the main path hands it: the three feature maps of the
    # serve batch and the head's own weights; one call is all three levels
    # (six launches). The library's version is the head's conv chain.
    head = opt.model.head
    with torch.inference_mode():
        feats = opt.model.fpn(opt.model.net(
            norm_batch.to(torch.bfloat16).permute(0, 3, 1, 2)))
        feats = [f.contiguous(memory_format=torch.channels_last)
                 for f in feats]
        head.pack_cls_tower()
        packs = head._cls_packs

        def towers(fn):
            return [fn(f, *packs[i]) for i, f in enumerate(feats)]

        def chain():
            return [head._tower(f, f"cls{i}_dw1", f"cls{i}_pw1",
                                f"cls{i}_dw2", f"cls{i}_pw2", f"cls{i}_out")
                    for i, f in enumerate(feats)]

        k6_ms = time_ms(lambda: towers(head_kernel.cls_tower), reps=10)
        k6_plain = time_ms(lambda: towers(head_kernel.cls_tower_reference),
                           reps=10)
        k6_lib = time_ms(chain, reps=10)
        k6_levels = [time_ms(lambda i=i, f=f: head_kernel.cls_tower(
            f, *packs[i]), reps=10) for i, f in enumerate(feats)]
    mid, ncls = head.cls_ch, NUM_CLASSES
    k6_dw_ops = k6_mm_ops = k6_bytes = 0
    for f in feats:
        n_pix, cin = f.shape[0] * f.shape[2] * f.shape[3], f.shape[1]
        k6_dw_ops += 2 * n_pix * 9 * (cin + mid)
        k6_mm_ops += 2 * n_pix * (cin * mid + mid * mid + mid * ncls)
        k6_bytes += 2 * (n_pix * (cin + ncls) + 10 * (cin + mid) + cin * mid
                         + mid * mid + 2 * mid + mid * ncls + ncls)
    # bf16: the 1x1 products run on the tensor cores, the depthwise taps in
    # fp32 on the CUDA cores
    k6_t_ops = (k6_mm_ops / BF16_FLOPS + k6_dw_ops / FP32_FLOPS) * 1e3
    k6_t_bytes = k6_bytes / HBM_BYTES_S * 1e3
    k6_bound = (max(k6_t_ops, k6_t_bytes),
                "operations" if k6_t_ops > k6_t_bytes else "bytes")
    # the fp32 kernel (CUDA cores throughout) on the same maps and weights
    feats32 = [f.float().contiguous(memory_format=torch.channels_last)
               for f in feats]
    packs32 = [tuple((k.float(), bias.float()) for k, bias in pack)
               for pack in packs]
    k6_fp32_ms = time_ms(lambda: [head_kernel.cls_tower(f, *packs32[i])
                                  for i, f in enumerate(feats32)], reps=5)
    k6_fp32_bound = roofline(2 * k6_bytes, k6_mm_ops + k6_dw_ops, FP32_FLOPS)
    del feats32, packs32

    # K4 at the x shape (device time and events), its twin, the library's
    # attention backward, and the fp32 route at the same shape
    def k4_of(x, g, gv):
        return lambda: attention.psa_attention_bwd(x, g, gv, nh, dk, dh)

    k4_ms = device_ms(k4_of(qkv, do_x, dv_x))
    k4_call_ms = time_ms(k4_of(qkv, do_x, dv_x))
    k4_plain = time_ms(lambda: attention.psa_attention_bwd_reference(
        qkv, do_x, dv_x, nh, dk, dh))
    lq, lk, lv = (x.detach().clone().requires_grad_() for x in (q, kk, vv))
    lib_out = F.scaled_dot_product_attention(lq, lk, lv)
    lib_do = do_x.view(b, t, nh, dh).transpose(1, 2)

    def sdpa_bwd():
        return torch.autograd.grad(lib_out, (lq, lk, lv), lib_do,
                                   retain_graph=True)

    k4_lib = device_ms(sdpa_bwd)
    k4_lib_call = time_ms(sdpa_bwd)
    k4_fp32_ms = device_ms(k4_of(qkv_fp32, do_x.float(), dv_x.float()))
    del qkv_fp32

    # K7 on the largest leaf of the x model, and over the leaves of one
    # quantize() of the main path, launched back to back
    k7_ms = time_ms(lambda: quant_kernel.stochastic_round(flat_l, 0))
    k7_plain = time_ms(lambda: quant_kernel.stochastic_round_reference(
        flat_l, 0), reps=5, warmup=1)
    path_flats = [flat for flat, _ in path_leaves.values()]
    k7_quantize_ms = time_ms(lambda: [quant_kernel.stochastic_round(f, 0)
                                      for f in path_flats], reps=5)
    # bytes: 4 read and 1 written per element; fp32 operations: add,
    # floor, two clamps (Philox's integer work has no peak in the table)
    k7_bound = roofline(5 * flat_l.numel(), 4 * flat_l.numel(), FP32_FLOPS)
    path_weights = sum(flat.numel() for flat in path_flats)
    k7_quantize_bound = roofline(5 * path_weights, 4 * path_weights,
                                 FP32_FLOPS)

    train_ms = time_ms(lambda: tal_step(state, tbatch), reps=5, warmup=1)

    def eval_and_decode():
        _, preds_e, anchors_e, strides_e = eval_step(state, tbatch)
        return decode_predictions(preds_e, anchors_e, strides_e,
                                  conf_threshold=POOL_CONF)

    eval_ms = time_ms(eval_and_decode, reps=5, warmup=1)

    # the three serving variants, each timed once by its median
    one = batch[:1].contiguous()

    def serve_of(detector, tower, images):
        """``serve`` of ``images``, with the fused cls tower set now, for
        the calls that follow at once."""
        detector.model.head.fused_cls_tower = tower
        return lambda: detector.serve(images, conf_thres=POOL_CONF,
                                      device_preprocess=True)

    inputs = {"b8": batch, "b1": one}
    both = ("b8", "b1")
    variants = (("fused", det, False, both),
                ("fused_optimized", opt, False, both),
                ("fused_optimized_cls_tower", opt, True, both),
                ("int8_static", q8, False, both),
                ("int8_dynamic", q8dyn, False, ("b8",)))
    serve_ms = {name: {key: time_ms(serve_of(detector, tower, inputs[key]))
                       for key in keys}
                for name, detector, tower, keys in variants}
    opt.model.head.fused_cls_tower = False
    serve_b = serve_ms["fused"]["b8"]
    serve_1 = serve_ms["fused"]["b1"]
    timing = {
        "card": card,
        "serve_x640_bf16": {
            "batch": SERVE_BATCH, "ms": serve_b,
            "img_per_s": SERVE_BATCH / serve_b * 1e3,
            "conf_thres": POOL_CONF},
        "latency_x640_bf16_b1_ms": serve_1,
        "serve_variants_ms": serve_ms,
        "eval_x640_bf16": {"batch": train_n, "step_and_decode_ms": eval_ms},
        "nms_single_image": {
            "serve_pool": {"k3_ms": k3_ms, "batched_kernel_ms": k3_batched_ms,
                           "kept": int(keep_one.sum())},
            "dense_pool": {"k3_ms": k3_dense_ms,
                           "batched_kernel_ms": k3_dense_batched_ms,
                           "kept": int(dense_keep.sum())}},
        "serve_x640_int8_static": {
            "batch": SERVE_BATCH, "ms": serve_ms["int8_static"]["b8"],
            "img_per_s": SERVE_BATCH / serve_ms["int8_static"]["b8"] * 1e3,
            "b1_ms": serve_ms["int8_static"]["b1"],
            "dynamic_b8_ms": serve_ms["int8_dynamic"]["b8"]},
        "quantize_x_k7": {"leaves": n_leaves, "weights": path_weights,
                          "ms": k7_quantize_ms,
                          "bound_ms": k7_quantize_bound[0],
                          "largest_leaf": list(flat_l.shape),
                          "largest_leaf_ms": k7_ms},
        "attention_x640": {
            "shape": [b, t, nh, dk, dh],
            "k1_bf16": {"ms": k1_ms, "call_ms": k1_call_ms,
                        "bound_ms": k1_bound[0], "sdpa_ms": k1_lib,
                        "sdpa_call_ms": k1_lib_call},
            "k1_fp32": {"ms": k1_fp32_ms, "bound_ms": k1_fp32_bound[0],
                        "bound_by": k1_fp32_bound[1]},
            "k1_bf16_b1": {"ms": k1_b1_ms, "bound_ms": k1_b1_bound[0],
                           "sdpa_ms": k1_b1_lib},
            "k1_bf16_b2_t1024": {"ms": k1_long_ms,
                                 "bound_ms": k1_long_bound[0],
                                 "sdpa_ms": k1_long_lib},
            "k4_bf16": {"ms": k4_ms, "call_ms": k4_call_ms,
                        "bound_ms": k4_bound[0], "sdpa_bwd_ms": k4_lib,
                        "sdpa_bwd_call_ms": k4_lib_call},
            "k4_fp32": {"ms": k4_fp32_ms, "bound_ms": k4_fp32_bound[0],
                        "bound_by": k4_fp32_bound[1]}},
        "cls_tower_ms_by_level": k6_levels,
        "cls_tower_fp32": {"ms": k6_fp32_ms, "bound_ms": k6_fp32_bound[0],
                           "bound_by": k6_fp32_bound[1]},
        "train_x640_bf16": {
            "batch": train_n, "assigner": "tal", "ms": train_ms,
            "img_per_s": train_n / train_ms * 1e3,
            "peak_memory_gib": train_peak_gb},
        "build_s": build_s,
    }
    log(json.dumps(timing))
    prof = profile_call(lambda: tal_step(state, tbatch), reps=2)
    log(json.dumps({"card": card, "profile_train_batch": train_n, **prof}))
    for name, detector, tower, keys in variants:
        for key in keys:
            prof = profile_call(serve_of(detector, tower, inputs[key]))
            log(json.dumps({"card": card, "profile_serve": name,
                            "batch": len(inputs[key]), **prof}))
    opt.model.head.fused_cls_tower = False
    prof = profile_call(eval_and_decode, reps=2)
    log(json.dumps({"card": card, "profile_eval_batch": train_n, **prof}))

    paths = {"serve": launches, "train": train_launches,
             "serve_optimized": opt_launches, "eval": eval_launches,
             "int8": int8_launches}

    def kernel_entry(name, counter, source, replaces, err, ms, plain, bound,
                     library):
        by_path = {path: table[counter] for path, table in paths.items()}
        check(sum(by_path.values()) > 0,
              f"kernel {name} was launched on no path")
        return {"name": name, "route": "cuda",
                "source": f"custom_yolo_tpu_torch/ops/cuda/csrc/{source}",
                "replaces": f"custom_yolo_tpu/ops/{replaces}",
                "launches": sum(by_path.values()),
                "launches_by_path": by_path, "max_abs_err": err, "ms": ms,
                "plain_ms": plain, "bound_ms": bound[0],
                "bound_by": bound[1], "library_ms": library}

    x_shape = (b, t, nh, dk, dh)
    kernels = [
        kernel_entry("psa_attention_fwd", "attention", "attention.cu",
                     "pallas/attention_kernel.py:37",
                     attn_err[x_shape, torch.bfloat16], k1_ms, k1_plain,
                     k1_bound, k1_lib),
        kernel_entry("nms_keep_batched", "nms_batched", "nms.cu",
                     "pallas/nms_kernel.py:82", float(nms_mismatch), k2_ms,
                     k2_plain, k2_bound, None),
        kernel_entry("nms_keep_single", "nms_single", "nms.cu",
                     "pallas/nms_kernel.py:34", float(nms_single_mismatch),
                     k3_ms, k3_plain, k3_bound, None),
        kernel_entry("psa_attention_bwd", "attention_bwd",
                     "attention_bwd.cu", "pallas/attention_kernel.py:90",
                     bwd_err[x_shape, torch.bfloat16], k4_ms, k4_plain,
                     k4_bound, k4_lib),
        kernel_entry("sppf_pyramid", "sppf", "sppf.cu",
                     "pallas/sppf_kernel.py:36", float(sppf_mismatch), k5_ms,
                     k5_plain, k5_bound, k5_lib),
        kernel_entry("cls_tower", "cls_tower", "head.cu",
                     "pallas/head_kernel.py:52",
                     max(tower_err[s, torch.bfloat16] for s in x_levels),
                     k6_ms, k6_plain, k6_bound, k6_lib),
        kernel_entry("stochastic_round_int8", "stochastic_round", "quant.cu",
                     "quant.py:69", float(k7_mismatch), k7_ms, k7_plain,
                     k7_bound, None),
    ]
    log(json.dumps({"kernels": kernels}))
    log(card)
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
