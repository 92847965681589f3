"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the port's hand-written CUDA kernels from ``custom_yolo_tpu_torch/
ops/cuda/csrc``, holds each against its plain PyTorch twin on the card,
serves the full-width ``x`` preset (640², 172 classes, bf16, random seeded
weights) through ``Detector.serve`` and ``Detector.inference`` while
counting kernel launches, compares the card with the CPU in fp32, and
times the kernels and the serving path with CUDA events. Any failed check
ends the run with a non-zero exit. The last line is
``{"ok": true, "device": {...}}``; the line before it is the card's name
and power limit as ``nvidia-smi`` reports them.
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch
import torch.nn.functional as F

from custom_yolo_tpu_torch import PRESETS, Detector
from custom_yolo_tpu_torch.models.detector import (IMAGENET_MEAN,
                                                   IMAGENET_STD,
                                                   decode_raw_predictions)
from custom_yolo_tpu_torch.ops import attention, nms_kernel
from custom_yolo_tpu_torch.ops.anchors import num_anchors
from custom_yolo_tpu_torch.ops.cuda import build
from custom_yolo_tpu_torch.ops.nms import MAX_WH, _gather_candidates, \
    batched_nms

SEED = 0
HW = 640
NUM_CLASSES = 172
SERVE_BATCH = 8
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
# device-time categories of the serve profile, matched in this order on
# the kernel's name; the last takes the rest
KERNEL_CATEGORIES = (
    ("port kernels", ("psa_attention_fwd", "nms_keep_kernel")),
    ("convolution", ("fprop", "conv", "xmma", "cudnn", "cutlass", "gemm")),
    ("copy and concat", ("copy", "Cat")),
    ("pooling", ("pool",)),
    ("sort and select", ("sort", "Sort", "radix", "scan", "gather", "index")),
    ("elementwise", ("elementwise",)),
    ("other", ()),
)


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
    """uint8 NHWC → the model's normalised fp32 input (preprocess_image's
    arithmetic)."""
    mean = torch.from_numpy(IMAGENET_MEAN).to(images.device)
    std = torch.from_numpy(IMAGENET_STD).to(images.device)
    return (images.float() / 255.0 - mean) / std


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


def profile_serve(fn, reps: int = 5) -> dict:
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


def main() -> None:
    if not torch.cuda.is_available():
        fail("no CUDA device: this script runs the port on the GPU")
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
            if "registers" in line or "spill" in line:
                log(f"  {name}: {line.strip()}")

    # ------------------------------------------- 3. K1 against its twin
    # the x preset's shape (B=8, T=400, nh=6, dk=32, dh=64), then a small
    # one with a ragged last row tile
    gen = torch.Generator().manual_seed(SEED)
    b, t, nh, dk, dh = SERVE_BATCH, 400, 6, 32, 64
    attn_err = {}
    for shape in ((b, t, nh, dk, dh), (3, 37, 2, 8, 16)):
        sb, st, snh, sdk, sdh = shape
        qkv32 = torch.randn(sb, st, snh * (2 * sdk + sdh),
                            generator=gen).to(dev)
        for dtype, tol in ((torch.bfloat16, 2e-2), (torch.float32, 1e-5)):
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
    nms_mismatch = 0
    for n, k in ((8, 1024), (3, 300)):
        boxes, valid = nms_pool(n, k, 0.45, rng)
        boxes_d = torch.from_numpy(boxes).to(dev)
        valid_d = torch.from_numpy(valid).to(dev)
        keep = nms_kernel.nms_keep(boxes_d, valid_d, 0.45)
        torch.cuda.synchronize()
        ref = nms_kernel.nms_keep_reference(boxes_d, valid_d, 0.45)
        mismatch = int((keep != ref).sum())
        check(mismatch == 0, f"NMS keep differs at N={n} K={k}: "
              f"{mismatch} entries")
        keep_np = keep.cpu().numpy()
        for img in range(n - 1):
            for slot in range(3):
                if valid[img, 2 * slot] and valid[img, 2 * slot + 1]:
                    check(bool(keep_np[img, 2 * slot]) and bool(
                        keep_np[img, 2 * slot + 1]) == (slot != 2),
                        f"boundary pair {slot} of image {img} mis-kept")
        check(not keep_np[-1].any(), "an all-invalid image kept a box")
        nms_mismatch += mismatch
        log(f"phase 4 nms N={n} K={k}: keep-masks equal "
            f"({int(keep.sum())} kept)")

    # ------------------------------------------- 5. full-width serving
    p = PRESETS["x"]
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

    attention.psa_attention.launches = 0
    nms_kernel.nms_keep.launches = 0
    result = det.serve(batch, conf_thres=POOL_CONF, device_preprocess=True)
    torch.cuda.synchronize()
    serve_launches = (attention.psa_attention.launches,
                      nms_kernel.nms_keep.launches)
    dets = det.inference(single, conf_thres=POOL_CONF)
    torch.cuda.synchronize()
    launches = {"attention": attention.psa_attention.launches,
                "nms": nms_kernel.nms_keep.launches}
    check(serve_launches == (2, 1),
          f"serve launched (attention, nms) {serve_launches}, want (2, 1)")
    check(launches == {"attention": 4, "nms": 2},
          f"serve + inference launched {launches}, want attention 4, nms 2")

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
    # end to end: a gate in a wide gap of the CPU's scores, away from ties
    best = torch.sort(scores_c.amax(-1)[0], descending=True).values
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
    log(f"phase 6 fp32 card vs CPU (TF32 off): preds max abs err {pred_err} "
        f"(tolerance {pred_tol}, |preds| max {scale}); NMS on equal inputs "
        f"identical ({int(res_c.num_valid[0])} detections at {POOL_CONF}); "
        f"end to end at conf {conf:.6f}: {n_g} detections each, classes "
        f"equal, boxes within {box_err} px; CPU forward {cpu_s:.1f} s")
    del gpu32, cpu32

    # ------------------------------------------------------ 7. timings
    qkv = qkv_x
    k1_ms = time_ms(lambda: attention.psa_attention(qkv, nh, dk, dh))
    k1_plain = time_ms(lambda: attention.psa_attention_reference(
        qkv, nh, dk, dh))
    q4 = qkv.view(b, t, nh, 2 * dk + dh).transpose(1, 2)
    q, kk, vv = q4[..., :dk], q4[..., dk:2 * dk], q4[..., 2 * dk:]
    k1_lib = time_ms(lambda: F.scaled_dot_product_attention(q, kk, vv))
    k1_bytes = qkv.numel() * 2 + 2 * b * t * nh * dh * 2
    k1_ops = 2 * b * nh * t * t * (dk + dh)
    t_bytes = k1_bytes / HBM_BYTES_S * 1e3
    t_ops = k1_ops / BF16_FLOPS * 1e3
    k1_bound = (max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops
                else "operations")

    # K2 on the pool the main path hands it: the serve batch's candidates
    boxes_s, scores_s = decode_raw_predictions(
        *det(normalize(batch)))
    cand_boxes, _, cand_classes, cand_valid = _gather_candidates(
        boxes_s, scores_s.amax(-1), scores_s.argmax(-1).to(torch.int32),
        conf_thres=POOL_CONF, top_k=1024)
    shifted = (cand_boxes + (cand_classes.float() * MAX_WH)[..., None]
               ).contiguous()
    keep = nms_kernel.nms_keep(shifted, cand_valid, 0.45)
    k2_ms = time_ms(lambda: nms_kernel.nms_keep(shifted, cand_valid, 0.45))
    k2_plain = time_ms(lambda: nms_kernel.nms_keep_reference(
        shifted, cand_valid, 0.45), reps=20, warmup=1)
    k2_bound = nms_bound_ms(keep)

    serve_b = time_ms(lambda: det.serve(batch, conf_thres=POOL_CONF,
                                        device_preprocess=True))
    one = batch[:1].contiguous()
    serve_1 = time_ms(lambda: det.serve(one, conf_thres=POOL_CONF,
                                        device_preprocess=True))
    timing = {
        "card": card,
        "serve_x640_bf16": {
            "batch": SERVE_BATCH, "ms": serve_b,
            "img_per_s": SERVE_BATCH / serve_b * 1e3,
            "conf_thres": POOL_CONF},
        "latency_x640_bf16_b1_ms": serve_1,
        "build_s": build_s,
    }
    log(json.dumps(timing))
    for images in (batch, one):
        prof = profile_serve(lambda: det.serve(
            images, conf_thres=POOL_CONF, device_preprocess=True))
        log(json.dumps({"card": card, "profile_serve_batch": len(images),
                        **prof}))

    kernels = [
        {"name": "psa_attention_fwd", "route": "cuda",
         "source": "custom_yolo_tpu_torch/ops/cuda/csrc/attention.cu",
         "replaces": "custom_yolo_tpu/ops/pallas/attention_kernel.py:37",
         "launches": launches["attention"],
         "max_abs_err": attn_err[(b, t, nh, dk, dh), torch.bfloat16],
         "ms": k1_ms, "plain_ms": k1_plain, "bound_ms": k1_bound[0],
         "bound_by": k1_bound[1], "library_ms": k1_lib},
        {"name": "nms_keep_batched", "route": "cuda",
         "source": "custom_yolo_tpu_torch/ops/cuda/csrc/nms.cu",
         "replaces": "custom_yolo_tpu/ops/pallas/nms_kernel.py:82",
         "launches": launches["nms"], "max_abs_err": float(nms_mismatch),
         "ms": k2_ms, "plain_ms": k2_plain, "bound_ms": k2_bound[0],
         "bound_by": k2_bound[1], "library_ms": None},
    ]
    log(json.dumps({"kernels": kernels}))
    log(card)
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
