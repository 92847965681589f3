"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the port's hand-written CUDA kernels from ``custom_yolo_tpu_torch/
ops/cuda/csrc``, holds each against its plain PyTorch twin on the card
(and the int8 contraction's routes against their float64 twin), serves the
full-width ``x`` preset (640², 172 classes, bf16, random seeded weights)
through ``Detector.serve`` and ``Detector.inference``, fused, then also
through ``optimize_for_serving`` with the fused cls tower on, then int8
(``quantize(stochastic=True)``, one K7 launch for every leaf, →
``calibrate``), serves one 4K frame (2176 × 3840), trains the same preset
for a few steps (``create_train_model`` / ``build_optimizer`` /
``TrainState.create`` / ``make_train_step``, TAL then nearest, EMA and
warm-up on), evaluates the trained state (``make_eval_step`` →
``decode_predictions`` → ``DetectionMetrics`` / ``COCOmAP``), holds the
on-device augmentation of a B=8 640² batch against the CPU's and its
draws by their distributions, and runs ``Trainer.fit`` at full width on
a parquet fixture it writes (staged through pinned memory, augmented on
the card, checkpointed, restored into a new trainer and resumed), all
while counting kernel launches, compares the card with the CPU in fp32
for serving (float and int8), for one train step, for evaluation and for
a small model's ``Trainer.fit``, and
times the kernels, the serving variants, the train step and the eval step
with CUDA events (every kernel and its library yardstick also by its
device time in a profiler trace; K6 and the head's cuDNN chain level by
level; K2 and K3 on the serve pool and on a dense pool, split into their
two kernels; K5 at the serve shape, one image, the 4K map and in fp32; K7
over one ``quantize()``, with its bound counted from its SASS, and the
whole ``quantize()``). With a second card it also runs K1, K5 and K6 on
``cuda:1`` while ``cuda:0`` is current. Phase 1b prints which optional
host packages are there (and whether g++ finds ``jpeglib.h``); phase 8b
reads its data through the port's ``DataLoader`` where pandas, pyarrow
and PIL are, else from an in-memory loader, and says which. Phase 9 runs
the deployment path through the command-line entry points, each a child
process on the card: the ETL (``scripts/torch_make_fixture.py``,
``scripts/torch_data_preprocess.py``), one training epoch
(``scripts/torch_train.py``), ``scripts/torch_evaluate.py`` on its
checkpoint (plain, with NMS and COCO mAP, static int8; a small fp32
model's metrics card against CPU), ``Detector.save_weights`` /
``load_weights`` bit for bit, and ``scripts/torch_serve.py`` against
``Detector.serve``; the CLIs' launch counts make the ``cli`` path. Phase
10 runs the distributed path: DDP and FSDP2 train steps as ranks in child
processes (one card a rank under NCCL, or two gloo ranks sharing the one
card) against the one-card step on the same global batch, ``torchrun
scripts/torch_train.py --mode dp|fsdp`` against phase 9b's single-process
epoch (validation counters, the fsdp checkpoint restored into ``single``
bit for bit), and ``parallel.serve.make_sharded_serve_fn`` against
``Detector.serve``; its launch counts make the ``distributed`` path.
Phase 11 exports the x detector with ``export.export_serving`` (fused at
B=8 and B=1, optimised with the fused cls tower, static int8), loads each
artifact fresh, holds its result to ``serve`` bit for bit and counts the
kernel launches of its calls (the ``export`` path), times it beside
``serve``, and imports a reference-format checkpoint of the seeded x
model through ``scripts/torch_import_torch.py``. Phase 12 runs the
quality-diagnosis scripts (``scripts/torch_sweep_eval.py``,
``scripts/torch_rank_diag.py``) as child processes on phase 9's fixture
and checkpoint and holds the sweep's rows to ``scripts/torch_evaluate.py``
at the same thresholds; their launch counts make the ``quality`` path.
Phase 13 runs the last user entry points in this process: the examples
(``examples/torch_serve_folder.py`` and ``torch_inference_demo.py`` held
to ``Detector.serve`` and ``inference`` on phase 9's images and weights,
``torch_train_smoke.py`` at x/640²), ``scripts/torch_profile.py`` and its
digest ``scripts/torch_analyze_profile.py`` held to phase 7's profile of
the same train step, and ``scripts/torch_soak.py``'s phases at a reduced
scale (two ``fit_chunk`` runs, the second resuming the first); their
launch counts make the ``examples``, ``profile`` and ``soak`` paths.
Phase 14 runs ``scripts/torch_multichip_report.py`` as a child process
(beside phase 12's, before phase 13) at
x/640² bf16 on four ranks (data 2 × fsdp 2, hybrid sharding), holds each
source's collectives to the modules' prediction and its two steps to the
same steps on one card; its ranks' launch counts make the ``multichip``
path, and its report is printed.
Phase 15 holds ``Detector.serve``'s CUDA graphs to the eager path: the
card tests of ``tests/test_torch_serve_graph.py`` in a child ``pytest``
(graph and eager bit for bit at x/640² B=8 uint8 and float, n/640² B=64,
``inference`` at B=1, three batches in flight, dynamic and static int8,
the optimised model with K6, ``make_sharded_serve_fn`` on side streams,
a capture that fails), then x/640² B=8 timed eager against graph: a
call's CUDA events, the pace of the benchmark's closed loop (two batches
in flight) and the device's busy time and events a call in a profiler
trace, with the hit share and the launch counts before and after.
Any failed check ends the run with a non-zero exit. The last line is
``{"ok": true, "device": {...}}``; the line before it is the card's name
and power limit as ``nvidia-smi`` reports them.
"""

from __future__ import annotations

import contextlib
import importlib.util
import io
import json
import os
import re
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
from custom_yolo_tpu_torch.config import Config, TrainingConfig
from custom_yolo_tpu_torch.data import transforms
from custom_yolo_tpu_torch.eval import (COCOmAP, DetectionMetrics,
                                        decode_predictions)
from custom_yolo_tpu_torch.eval.decode import decoded_to_lists
from custom_yolo_tpu_torch.export import export_serving, load_exported
from custom_yolo_tpu_torch.models.detector import (IMAGENET_MEAN,
                                                   IMAGENET_STD,
                                                   create_train_model,
                                                   decode_raw_predictions,
                                                   normalize_uint8,
                                                   serve_pipeline)
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
from custom_yolo_tpu_torch.train.trainer import Trainer
from custom_yolo_tpu_torch.utils.checkpoint import (CheckpointManager,
                                                    host_copy)
from custom_yolo_tpu_torch.utils.profiling import (kernel_launches,
                                                   kernel_wrappers,
                                                   serve_graph_stats)
from custom_yolo_tpu_torch.utils.torch_port import to_torch_state_dict

SEED = 0
HW = 640
NUM_CLASSES = 172
SERVE_BATCH = 8
# a 4K frame (3840 wide, 2160 high padded to a multiple of 32)
K4_SIZE = (2176, 3840)
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
# the x preset's and a small ragged one in both; T=1024 (a 1024² input)
# and T=1600 (1280²) in both, beyond the T the fp32 kernels took before
# they streamed their keys; in bf16 also one token past a 64-row tile and
# another dk/dh; and rows whose stride (c_qkv = 132) is not a multiple of
# 8, in both; in bf16 the two 4K calls, YOLO12's area attention at p4 (4
# strips of 8,160 tokens, 12 heads of 32) and x's PSA on a 2176×3840 frame
BOTH = (torch.bfloat16, torch.float32)
ATTN_CASES = (((SERVE_BATCH, 400, 6, 32, 64), BOTH), ((3, 37, 2, 8, 16), BOTH),
              ((2, 1024, 6, 32, 64), BOTH),
              ((1, 1600, 6, 32, 64), BOTH),
              ((2, 65, 6, 32, 64), (torch.bfloat16,)),
              ((1, 400, 2, 16, 32), (torch.bfloat16,)),
              ((2, 70, 3, 12, 20), BOTH),
              ((4, 8160, 12, 32, 32), (torch.bfloat16,)),
              ((1, 8160, 6, 32, 64), (torch.bfloat16,)))
ATTN_TOL = {torch.bfloat16: 2e-2, torch.float32: 1e-5}
# q and k of the two 4K cases are scaled by this gain (logits of standard
# deviation 1.7² ≈ 2.9), so that each query picks out a few of its 8,160
# keys. From plain randn the softmax over 8,160 keys is almost flat and
# the output lies near 0.02, under ATTN_TOL's atol: a kernel 10% wrong
# everywhere would pass. With the gain a 2% error in the scale, a 5% error
# in the output, or a key tile dropped or shifted each fails ATTN_TOL,
# while the sound kernel reads about a quarter of it
# (scripts/torch_attention_probe.py --faults)
ATTN_GAIN = {(4, 8160, 12, 32, 32): 1.7, (1, 8160, 6, 32, 64): 1.7}
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
                      "nms_mask_kernel",
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
# launch tables below and in the CLIs' closing launch counts
COUNTED = kernel_wrappers()


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


STARTED = time.perf_counter()


def stamp(phase: str) -> None:
    """The run's elapsed seconds as a phase starts."""
    log(f"phase {phase} starts at {time.perf_counter() - STARTED:.1f} s")


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


def profile_call(fn, reps: int = 5, span_names: tuple = ()) -> dict:
    """Device busy share of ``reps`` calls of ``fn`` under torch.profiler,
    and the kernels that took the most device time. Busy time is the union
    of the kernel, copy and memset intervals of the trace; the window is
    the host's clock from the first call to the end of the last (the
    profiler's own host cost included). ``span_names``: the port's
    spans whose device ms a call to report (:func:`span_device_ms`)."""
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
            "span_device_ms": span_device_ms(events, span_names, reps),
            "kernels_per_call": sum(c for _, c in by_name.values()) / reps,
            "by_category_ms_launches": by_category,
            "top": [[name[:80], ms / reps, count // reps]
                    for name, (ms, count) in top]}


def span_device_ms(events: list, names: tuple, reps: int) -> dict:
    """Device ms a call of the kernels, copies and memsets launched inside
    each span of ``names`` in a Chrome trace's ``events``: a device event
    belongs to the span that encloses its launch (the runtime call of the
    same correlation id) on the launching thread. A graph's kernels
    correlate to the ``cudaGraphLaunch`` that replayed them."""
    launches, opened = {}, []
    for e in events:
        cat = e.get("cat")
        if cat in ("cuda_runtime", "cuda_driver"):
            corr = (e.get("args") or {}).get("correlation")
            if corr is not None:
                launches[corr] = (e.get("tid"), float(e["ts"]))
        elif cat == "user_annotation" and e.get("name") in names:
            lo = float(e["ts"])
            opened.append((e.get("tid"), lo, lo + float(e["dur"]),
                           e["name"]))
    ms = dict.fromkeys(names, 0.0)
    for e in events:
        if e.get("cat") not in ("kernel", "gpu_memcpy", "gpu_memset") \
                or "dur" not in e:
            continue
        launch = launches.get((e.get("args") or {}).get("correlation"))
        if launch is None:
            continue
        tid, ts = launch
        for span_tid, lo, hi, name in opened:
            if span_tid == tid and lo <= ts <= hi:
                ms[name] += float(e["dur"]) / 1e3 / reps
                break
    return ms


def device_ms(fn, reps: int = 20) -> float:
    """Device time of one call of ``fn``: the busy time of ``reps`` calls
    back to back in a profiler trace, over ``reps``. Unlike one call's CUDA
    events it leaves out the host's launch path, which at a few
    microseconds of kernel is most of an event time. A trace that holds no
    device activity (the profiler loses one now and then) is taken again,
    up to three times."""
    for _ in range(3):
        busy = profile_call(fn, reps)["device_busy_ms"]
        if busy > 0:
            break
    check(busy > 0, "three profiler traces held no device activity")
    return busy / reps


def split_ms(fn, reps: int = 20) -> dict:
    """Device time of one call of ``fn`` (as :func:`device_ms`) and its
    share by kernel, named by the word before its parameter list."""
    prof = profile_call(fn, reps)
    by_kernel = {}
    for name, ms, _ in prof["top"]:
        short = re.search(r"(\w+)(<[^>]*>)?\(", name)
        short = short.group(1) if short else name
        by_kernel[short] = by_kernel.get(short, 0.0) + ms
    return {"device_ms": prof["device_busy_ms"] / reps,
            "by_kernel_ms": by_kernel}


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


# K5 timed at: the x serve shape, one image, a 4K frame's p5 map, fp32
SPPF_TIMED = (((SERVE_BATCH, 384, 20, 20), torch.bfloat16),
              ((1, 384, 20, 20), torch.bfloat16),
              ((1, 384, 68, 120), torch.bfloat16),
              ((SERVE_BATCH, 384, 20, 20), torch.float32))
# K7's rates, thread instructions a clock per SM of sm_90 (NVIDIA CUDA C++
# Programming Guide, arithmetic instruction throughput, compute capability
# 9.0; the pipes from the Nsight Compute Kernel Profiling Guide): integer
# multiply-add (IMAD) on the FMA pipe's heavy half, 64; fp32 add and
# multiply on both halves, 128; integer logic, shift and min/max on the ALU
# pipe, 64, beside the FMA pipe; conversions, 16; and one warp instruction
# a clock for each of the 4 schedulers, 128
RATE_PER_CLOCK_SM = {"imad": 64, "fma_pipe": 128, "alu": 64,
                     "conversion": 16, "issue": 128}


def sppf_bound(x: torch.Tensor) -> tuple:
    """K5's least time: x read once, four slices written once; three levels
    of 8 comparisons an element at the fp32 rate."""
    return roofline(5 * x.numel() * x.element_size(), 3 * 8 * x.numel(),
                    FP32_FLOPS)


def sppf_times(x: torch.Tensor, fn=None) -> dict:
    """``fn`` (K5's wrapper) on ``x``, and the library's chain (three
    ``max_pool2d`` and a cat): device time and one call's events each; one
    call of the twin (the chain and its signs of zeros) by events; the
    bound."""
    fn = fn or sppf_kernel.sppf_pyramid

    def chain():
        return sppf_kernel.max_pool_chain(x)

    bound = sppf_bound(x)
    return {"shape": list(x.shape), "dtype": str(x.dtype).split(".")[-1],
            "device_ms": device_ms(lambda: fn(x)),
            "events_ms": time_ms(lambda: fn(x)),
            "chain_device_ms": device_ms(chain),
            "chain_events_ms": time_ms(chain),
            "twin_events_ms": time_ms(
                lambda: sppf_kernel.sppf_pyramid_reference(x)),
            "bound_ms": bound[0], "bound_by": bound[1]}


def sm_clock_hz() -> float:
    """The card's largest SM clock, as nvidia-smi reports it."""
    mhz = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    return float(mhz) * 1e6


def sass_instructions(library, kernel: str) -> list:
    """One kernel's SASS instructions in a built library (``cuobjdump
    -sass``), each as its text with any predicate."""
    cuobjdump = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    check(os.path.exists(cuobjdump), "cuobjdump not found: K7's bound "
          "counts its SASS")
    sass = subprocess.run([cuobjdump, "-sass", str(library)],
                          capture_output=True, text=True, check=True).stdout
    out, inside = [], False
    for line in sass.splitlines():
        if "Function :" in line:
            inside = kernel in line
            continue
        match = re.search(r"/\*[0-9a-f]{4,}\*/\s+([^;]*);", line)
        if inside and match:
            out.append(match.group(1).strip())
    check(out, f"no SASS found for {kernel}")
    return out


def k7_sass_per_element() -> dict:
    """The instructions a K7 element needs, counted in the kernel's SASS
    and divided by the elements a thread takes: Philox's multiplies (an
    IMAD by one of its multipliers) and xors (LOP3 of LUT 0x96 or 0x3c),
    the shift of its word by 8, the conversions (I2F, FRND, F2I), the fp32
    add and multiply, the clip (FMNMX). The leaf search, the addresses and
    counters, the packing and the elementwise path of a leaf's tail are
    left out."""
    sass = sass_instructions(build.library_path("quant"),
                             "stochastic_round_grouped_kernel")
    multipliers = tuple(f"{m - (1 << 32):#x}" if m >= 1 << 31 else f"{m:#x}"
                        for m in quant_kernel.PHILOX_M)
    kinds = {"multiply": lambda op, ins: op.startswith("IMAD") and any(
                 f"{m}," in ins for m in multipliers),
             "xor": lambda op, ins: op.startswith("LOP3") and re.search(
                 r", 0x(96|3c), !?PT$", ins) is not None,
             "shift": lambda op, ins: op == "SHF.R.U32.HI"
             and ", RZ, 0x8," in ins,
             "conversion": lambda op, ins: op.startswith(("I2F", "F2I",
                                                          "FRND")),
             "fp32": lambda op, ins: op in ("FADD", "FMUL", "FFMA"),
             "clip": lambda op, ins: op == "FMNMX"}
    counts_ = dict.fromkeys(kinds, 0)
    for ins in sass:
        op = ins.split()[0]
        if op.startswith("@"):      # a predicated instruction: not every
            continue                # element's work
        kind = next((k for k, test in kinds.items() if test(op, ins)), None)
        if kind:
            counts_[kind] += 1
    per = {k: n / quant_kernel.PER_THREAD for k, n in counts_.items()}
    per["issued"] = sum(per.values())
    per["kernel_sass"] = len(sass) / quant_kernel.PER_THREAD
    return per


def k7_bound_of(n: int, per_element: dict) -> tuple:
    """(least ms, what bounds it) of K7 on ``n`` elements: 5 bytes an
    element over the memory rate, or the clocks its instructions need on
    the busiest of the pipes that run side by side (RATE_PER_CLOCK_SM), at
    the card's largest SM clock."""
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    clock = sm_clock_hz()
    e = per_element
    clocks = max(e["multiply"] / RATE_PER_CLOCK_SM["imad"],
                 (e["multiply"] + e["fp32"]) / RATE_PER_CLOCK_SM["fma_pipe"],
                 (e["xor"] + e["shift"] + e["clip"])
                 / RATE_PER_CLOCK_SM["alu"],
                 e["conversion"] / RATE_PER_CLOCK_SM["conversion"],
                 e["issued"] / RATE_PER_CLOCK_SM["issue"])
    times = {"bytes": 5 * n / HBM_BYTES_S * 1e3,
             "operations": clocks * n / (sms * clock) * 1e3}
    by = max(times, key=times.get)
    return times[by], by


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


def by_item(fn, *args):
    """``fn`` on each batch element of its tensor arguments, the results
    concatenated along the batch. The attention twins treat elements
    apart, and one element's fp32 scores at T = 8,160 and 12 heads already
    take 3.2 GB."""
    parts = [fn(*(a[i:i + 1] if isinstance(a, torch.Tensor) else a
                  for a in args)) for i in range(args[0].shape[0])]
    if isinstance(parts[0], tuple):
        return tuple(torch.cat(group) for group in zip(*parts))
    return torch.cat(parts)


def attn_qkv(shape, gen: torch.Generator,
             gain: float | None = None) -> torch.Tensor:
    """fp32 qkv on the host for an ``ATTN_CASES`` shape (B, T, nh, dk,
    dh), q and k scaled by ``gain``, by default the case's ``ATTN_GAIN``."""
    b, t, nh, dk, dh = shape
    qkv = torch.randn(b, t, nh, 2 * dk + dh, generator=gen)
    qkv[..., :2 * dk] *= ATTN_GAIN.get(shape, 1.0) if gain is None else gain
    return qkv.reshape(b, t, nh * (2 * dk + dh))


def tol_share(out: torch.Tensor, ref: torch.Tensor, tol: float) -> float:
    """The largest share of ``allclose``'s limit ``tol + tol·|ref|`` that
    ``out`` takes: ≤ 1 where ``allclose(out, ref, atol=tol, rtol=tol)``."""
    r = ref.float()
    return ((out.float() - r).abs() / (tol + tol * r.abs())).max().item()


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


def device_guard(gen: torch.Generator) -> None:
    """Phase 4g: K1, K5 and K6 on ``cuda:1`` while ``cuda:0`` is current.
    Every launch goes through ``build.launch``, which makes the tensors'
    device current for it (and for its ``cudaFuncSetAttribute``); each
    result is held to its twin on ``cuda:1``. On one card it says that
    this is unverified there."""
    if torch.cuda.device_count() > 1:
        other = torch.device("cuda", 1)
        torch.cuda.set_device(0)
        qkv1 = torch.randn(2, 400, 6 * 128, generator=gen).to(
            other, torch.bfloat16)
        out1, v1 = attention.psa_attention(qkv1, 6, 32, 64)
        ref_out1, ref_v1 = attention.psa_attention_reference(qkv1, 6, 32, 64)
        check(torch.equal(v1, ref_v1) and torch.allclose(
            out1.float(), ref_out1.float(), atol=2e-2, rtol=2e-2),
              "attention on cuda:1 differs from its twin")
        p5_1 = channels_last((2, 384, 20, 20), torch.bfloat16, gen, other)
        check(torch.equal(sppf_kernel.sppf_pyramid(p5_1),
                          sppf_kernel.sppf_pyramid_reference(p5_1)),
              "SPPF on cuda:1 differs from its twin")
        # K6 first on cuda:0, then on cuda:1: its shared-memory attribute
        # is set once per device, so the second device must get its own
        x1 = channels_last((2, 384, 20, 20), torch.bfloat16, gen, other)
        params1 = tower_params(384, 384, NUM_CLASSES, torch.bfloat16, gen,
                               other)
        ref1 = head_kernel.cls_tower_reference(x1, *params1).float()
        top1 = ref1.abs().max().item()
        for dev in (torch.device("cuda", 0), other):
            got1 = head_kernel.cls_tower(
                x1.to(dev), *[(k.to(dev), b.to(dev)) for k, b in params1])
            check(got1.device == dev and (got1.float().to(other) - ref1)
                  .abs().max().item() < 1e-2 * top1,
                  f"cls tower on {dev} differs from its twin")
        check(torch.cuda.current_device() == 0,
              "a launch changed the current device")
        log("phase 4g device guard: K1, K5 and K6 on cuda:1 with cuda:0 "
            "current agree with their twins on cuda:1 (K6 after a launch "
            "on cuda:0)")
    else:
        log("phase 4g device guard: one card here, so C1 (each launch on "
            "its tensors' device) is unverified on the card; the CPU tests "
            "hold build.launch to it")


# K5's cases: the x preset's p5 map at batch 8 and 1, a 4K frame's p5 map
# (x at 2176 x 3840), an fp32 map past the 3,632 pixels the untiled kernel
# took, ragged maps whose tiles hang over every border, a map narrower than
# the pooling window reaches, channel counts that are no multiple of a
# 16-byte vector and a tensor one element past a 16-byte boundary
SPPF_CASES = (((SERVE_BATCH, 384, 20, 20), (torch.bfloat16, torch.float32)),
              ((1, 384, 20, 20), (torch.bfloat16,)),
              ((1, 384, 68, 120), (torch.bfloat16,)),
              ((1, 64, 62, 62), (torch.float32,)),
              ((2, 40, 37, 29), (torch.bfloat16, torch.float32)),
              ((2, 40, 13, 7), (torch.bfloat16, torch.float32)),
              ((2, 5, 13, 7), (torch.bfloat16,)),
              ((2, 6, 9, 11), (torch.bfloat16, torch.float32)))


def sppf_checks(gen: torch.Generator, dev) -> int:
    """Phase 4c: K5 against its twin on the card at SPPF_CASES, each with
    ±inf entries and a whole −inf window, then with signed zeros (a channel
    of zeros of both signs, and one where windows of negatives hold a zero),
    then with a NaN. Every output has the twin's bits, the signs of zeros
    included, and NaN sits where the twin's does (the twin's NaN bits are
    not held: max.NaN returns the canonical NaN); the zeros whose sign
    differs from the bare ``max_pool2d`` chain's are counted and printed.
    Returns the number of values that differ (0)."""
    mismatch = 0
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    offsets = [(shape, dtype, 0) for shape, dtypes in SPPF_CASES
               for dtype in dtypes] + [((2, 40, 37, 29), torch.bfloat16, 1)]
    for shape, dtype, offset in offsets:
        b, c, h, w = shape
        base = torch.randn(b * c * h * w + offset, generator=gen).to(
            dev, dtype)
        x = base[offset:].view(b, h, w, c).permute(0, 3, 1, 2)
        x[0, min(3, c - 1), min(2, h - 1), min(1, w - 1)] = float("inf")
        x[b - 1, min(4, c - 1), 0, 0] = -float("inf")
        x[b - 1, c - 1, 4:9, 1:6] = -float("inf")
        got = sppf_kernel.sppf_pyramid(x)
        torch.cuda.synchronize()
        ref = sppf_kernel.sppf_pyramid_reference(x)
        check(got.shape == ref.shape and got.dtype == dtype
              and got.is_contiguous(memory_format=torch.channels_last),
              f"SPPF pyramid result {tuple(got.shape)} {got.dtype}")
        bits = torch.int16 if dtype == torch.bfloat16 else torch.int32
        check(torch.equal(got.view(bits), ref.view(bits)),
              f"SPPF pyramid differs from its twin {shape} {dtype} "
              f"offset {offset}")
        mismatch += int((got.view(bits) != ref.view(bits)).sum())
        # signed zeros: channel 0 all ±0; channel 1 negative with zeros of
        # both signs, so some windows' maximum is a zero
        signs = torch.randint(0, 2, (b, h, w), generator=gen).to(dev)
        x[:, 0] = torch.where(signs > 0, 0.0, -0.0).to(dtype)
        if c > 1:
            x[:, 1] = -x[:, 1].abs()
            x[:, 1, ::3, ::4] = torch.where(signs[:, ::3, ::4] > 0, 0.0,
                                            -0.0).to(dtype)
        got = sppf_kernel.sppf_pyramid(x)
        ref = sppf_kernel.sppf_pyramid_reference(x)
        zeros = got == 0
        sign_diff = int((got.view(bits) != ref.view(bits)).sum())
        check(sign_diff == 0, f"SPPF pyramid with signed zeros differs "
              f"{shape} {dtype} in {sign_diff} outputs' bits")
        mismatch += sign_diff
        chain = sppf_kernel.max_pool_chain(x)
        chain_diff = int((zeros & (got.view(bits) != chain.view(bits))).sum())
        x[0, min(1, c - 1), min(4, h - 1), min(4, w - 1)] = float("nan")
        got = sppf_kernel.sppf_pyramid(x)
        ref = sppf_kernel.sppf_pyramid_reference(x)
        nans = int(torch.isnan(got).sum())
        check(nans > 1 and torch.equal(torch.isnan(got), torch.isnan(ref))
              and torch.equal(got.nan_to_num(0.0).view(bits),
                              ref.nan_to_num(0.0).view(bits)),
              f"SPPF pyramid with a NaN differs {shape} {dtype}")
        launch = sppf_kernel.launch_shape(b, c, h, w, x.element_size(), sms,
                                          x.data_ptr(), got.data_ptr())
        log(f"phase 4c sppf {shape} {dtype} offset {offset} (vec, th, tw, "
            f"cvb {launch}): equal to the twin, with ±inf and a −inf window, "
            f"with signed zeros ({int(zeros.sum())} zero outputs, each of "
            f"the twin's sign; {chain_diff} of another sign than the bare "
            f"max_pool2d chain's) and with a NaN (spread to {nans} "
            f"outputs)")
    return mismatch


def nms_checks(dev) -> tuple:
    """Phase 4: K2 (``nms_keep_batched``) and K3 (``nms_keep_single``)
    against the twin on the card, keep-sets exactly equal. Returns the
    summed mismatches of each (0, or the run has failed)."""
    rng = np.random.RandomState(SEED)
    batched = single = 0

    def held(boxes_d, valid_d, what, images=()):
        """K2 on the pool, K3 on the whole pool and on each of ``images``,
        against the twin; returns (K2's keep, the twin's)."""
        nonlocal batched, single
        ref = nms_kernel.nms_keep_reference(boxes_d, valid_d, 0.45)
        keep = nms_kernel.nms_keep_batched(boxes_d, valid_d, 0.45)
        torch.cuda.synchronize()
        wrong = int((keep != ref).sum())
        check(wrong == 0, f"NMS keep differs, {what}: {wrong} entries")
        batched += wrong
        k = boxes_d.shape[1]
        for img in [slice(None)] + list(images):
            one = boxes_d[img].reshape(-1, k, 4).contiguous()
            one_valid = valid_d[img].reshape(-1, k).contiguous()
            keep_one = nms_kernel.nms_keep_single(one, one_valid, 0.45)
            torch.cuda.synchronize()
            wrong = int((keep_one != ref[img].reshape(-1, k)).sum())
            check(wrong == 0, f"single-image NMS keep differs, {what}, "
                  f"image {img}: {wrong} entries")
            single += wrong
        return keep, ref

    def pool(n, k):
        boxes, valid = nms_pool(n, max(k, 18), 0.45, rng)
        return (torch.from_numpy(boxes[:, :k].copy()).to(dev),
                torch.from_numpy(valid[:, :k].copy()).to(dev))

    for n, k in ((8, 1024), (3, 300)):
        boxes, valid = nms_pool(n, k, 0.45, rng)
        boxes_d = torch.from_numpy(boxes).to(dev)
        valid_d = torch.from_numpy(valid).to(dev)
        # K3, the single-image route, on each image of the same pools
        # (and on the whole pool at once: it takes any N)
        keep, ref = held(boxes_d, valid_d, f"N={n} K={k}", range(n))
        keep_np = keep.cpu().numpy()
        for img in range(n - 1):
            for slot in range(3):
                if valid[img, 2 * slot] and valid[img, 2 * slot + 1]:
                    check(bool(keep_np[img, 2 * slot]) and bool(
                        keep_np[img, 2 * slot + 1]) == (slot != 2),
                        f"boundary pair {slot} of image {img} mis-kept")
        check(not keep_np[-1].any(), "an all-invalid image kept a box")
        log(f"phase 4 nms N={n} K={k}: keep-masks of the batched kernel, "
            f"of the single-image kernels (image by image and all at once) "
            f"and of the twin equal ({int(keep.sum())} kept)")
        if k == 1024:
            # two calls bit-equal, each route
            check(torch.equal(keep, nms_kernel.nms_keep_batched(
                boxes_d, valid_d, 0.45)), "two K2 calls differ")
            first = nms_kernel.nms_keep_single(boxes_d[:1], valid_d[:1], 0.45)
            check(torch.equal(first, nms_kernel.nms_keep_single(
                boxes_d[:1], valid_d[:1], 0.45)), "two K3 calls differ")
            log("phase 4 nms N=8 K=1024: two calls of each route bit-equal")
            pool_1024 = boxes_d, valid_d
    before = read_counts()
    routed = nms_kernel.nms_keep(boxes_d[:1].contiguous(),
                                 valid_d[:1].contiguous(), 0.45)
    after = read_counts()
    check(routed.equal(ref[:1])
          and after["nms_single"] == before["nms_single"] + 1
          and after["nms_batched"] == before["nms_batched"],
          "nms_keep did not send one image to the single-image kernels")

    # pools whose K is not a multiple of 64, and K below one word
    for k in (1, 64, 65, 1000):
        keep, _ = held(*pool(3, k), f"N=3 K={k}", range(3))
        log(f"phase 4 nms N=3 K={k}: K2, K3 and the twin equal "
            f"({int(keep.sum())} kept)")
    # a cluster of identical boxes over boxes 58-69 and 124-131, alone in
    # a class band: box 58 (and 124) is kept and clears its copies, in its
    # own 64-box word and in the next
    boxes_d, valid_d = pool(2, 200)
    for lo, hi, x in ((58, 70, 0.0), (124, 132, 300.0)):
        boxes_d[:, lo:hi] = torch.tensor(
            [25 * MAX_WH + x, 10.0, 25 * MAX_WH + x + 80, 90.0], device=dev)
        valid_d[:, lo:hi] = True
    keep, _ = held(boxes_d, valid_d, "straddling clusters", range(2))
    check(bool(keep[:, 58].all() and keep[:, 124].all()
               and not keep[:, 59:70].any() and not keep[:, 125:132].any()),
          "a cluster across boxes 63/64 (or 127/128) was not cleared by "
          "its first box")
    log("phase 4 nms clusters over boxes 58-69 and 124-131: the first box "
        "of each kept, its copies in both words cleared; K2, K3 and the "
        "twin equal")
    # C3: a pool of K = 10240, beyond the 9685 (K2) and 28,608 (K3) that
    # the kernels' shared memory allowed before
    big_boxes, big_valid = pool(3, 10240)
    big_boxes, big_valid = big_boxes[:2], big_valid[:2]
    keep, _ = held(big_boxes, big_valid, "N=2 K=10240", (0,))
    log(f"phase 4 nms N=2 K=10240 (K2) and N=1 (K3, image 0): equal to the "
        f"twin ({int(keep.sum())} kept)")
    # the removed words in global memory, as for K > 65,536: the same
    # pools with no removed word allowed in shared memory
    shared_words = nms_kernel.SHARED_REMOVED_WORDS
    nms_kernel.SHARED_REMOVED_WORDS = 0
    try:
        held(*pool_1024, "removed words in global memory, N=8 K=1024",
             (0,))
        held(big_boxes[:1].contiguous(), big_valid[:1].contiguous(),
             "removed words in global memory, N=1 K=10240")
    finally:
        nms_kernel.SHARED_REMOVED_WORDS = shared_words
    log("phase 4 nms with the removed words in global memory (N=8 K=1024, "
        "N=1 K=10240): equal to the twin")
    return batched, single


# ------------------------------------------------------------- trainer phases
# the keys of one epoch's record in the history of the JAX package's
# Trainer with the task-aligned assigner (custom_yolo_tpu/train/trainer.py:
# 191-197: the loss terms of train/losses.py:354-357, the train step's
# grad_norm, eval/metrics.py's DetectionMetrics.compute, lr, epoch_time_s)
JAX_TAL_HISTORY_KEYS = frozenset(
    [f"train/{k}" for k in ("total_loss", "box_loss", "cls_loss",
                            "dfl_loss", "grad_norm")]
    + [f"val/{k}" for k in ("total_loss", "box_loss", "cls_loss", "dfl_loss",
                            "precision", "recall", "f1_score", "mAP",
                            "true_positives", "false_positives",
                            "false_negatives", "total_predictions",
                            "total_ground_truths")]
    + ["lr", "epoch_time_s"])
# phase 8b: batches of the trainer's full-width run, and the real images of
# its one validation batch (the rest of it is sample_pad)
TRAINER_BATCHES = 3
TRAINER_VAL_REAL = 6
# (w, h) of the fixture's JPEGs, cycled; the loader resizes them to 640²
FIXTURE_SIZES = ((640, 480), (480, 640), (800, 600), (640, 640), (500, 375),
                 (1024, 768))


def environment() -> dict:
    """Phase 1b: which optional host packages import (``cv2`` turns RLE
    segmentations into polygons in the ETL, ``matplotlib`` draws the
    plots of ``utils.visualization``), whether g++ runs and whether it
    finds ``jpeglib.h`` (the port's native decoder needs both)."""
    import importlib

    found = {}
    for name in ("yaml", "pandas", "pyarrow", "PIL", "tensorboardX",
                 "wandb", "cv2", "matplotlib"):
        try:
            importlib.import_module(name)
            found[name] = True
        except ImportError:
            found[name] = False
    gxx = shutil.which("g++")
    found["g++"] = gxx is not None and subprocess.run(
        [gxx, "--version"], capture_output=True).returncode == 0
    found["jpeglib.h"] = found["g++"] and subprocess.run(
        [gxx, "-fsyntax-only", "-x", "c++", "-"],
        input=b"#include <cstdio>\n#include <jpeglib.h>\n",
        capture_output=True).returncode == 0
    return found


def write_fixture(root: str, n_images: int, num_classes: int,
                  seed: int) -> tuple:
    """Seeded random JPEGs of ``FIXTURE_SIZES`` and their parquet (the
    columns ``DetectionDataset`` reads: COCO top-left xywh boxes, category
    ids) under ``root``. Returns (parquet path, image dir, boxes per
    image)."""
    import pandas as pd
    from PIL import Image

    rng = np.random.RandomState(seed)
    image_dir = os.path.join(root, "images")
    os.makedirs(image_dir)
    rows, counts = [], []
    for i in range(n_images):
        w, h = FIXTURE_SIZES[i % len(FIXTURE_SIZES)]
        name = f"img_{i:04d}.jpg"
        Image.fromarray(rng.randint(0, 256, (h, w, 3), dtype=np.uint8)).save(
            os.path.join(image_dir, name), quality=90)
        k = int(rng.randint(1, 25))
        bw = rng.uniform(0.05, 0.5, k) * w
        bh = rng.uniform(0.05, 0.5, k) * h
        x = rng.uniform(0, 1, k) * (w - bw)
        y = rng.uniform(0, 1, k) * (h - bh)
        rows.append({"id": i + 1, "file_name": name,
                     "bbox": np.stack([x, y, bw, bh], 1).tolist(),
                     "category_id": rng.randint(0, num_classes, k).tolist()})
        counts.append(k)
    path = os.path.join(root, "fixture.parquet")
    pd.DataFrame(rows).to_parquet(path)
    return path, image_dir, counts


class MemoryLoader:
    """The data loader's contract over seeded in-memory batches, for a
    machine without pandas, pyarrow or PIL: ``set_epoch``, ``__len__`` and
    ``__iter__`` of host batch dicts with ``_stack``'s keys, reshuffled per
    epoch; the last ``pad`` rows of the last batch are ``sample_pad``."""

    def __init__(self, n_batches: int, batch: int, hw: int, max_gt: int,
                 num_classes: int, seed: int, pad: int = 0):
        rng = np.random.RandomState(seed)
        n = n_batches * batch
        counts = rng.randint(1, 25, n)
        boxes = np.zeros((n, max_gt, 4), np.float32)
        wh = rng.uniform(0.05, 0.5, (n, max_gt, 2)) * hw
        boxes[..., 2:] = wh
        boxes[..., :2] = wh / 2 + rng.uniform(0, 1, (n, max_gt, 2)) * (hw - wh)
        mask = np.arange(max_gt)[None] < counts[:, None]
        boxes[~mask] = 0.0
        self.samples = {
            "image": rng.randint(0, 256, (n, hw, hw, 3), dtype=np.uint8),
            "gt_boxes": boxes,
            "gt_labels": np.where(mask, rng.randint(0, num_classes,
                                                    (n, max_gt)), 0
                                  ).astype(np.int32),
            "gt_mask": mask, "image_id": np.arange(1, n + 1, dtype=np.int64),
            "num_gt": counts.astype(np.int32),
            "scale": np.ones((n, 2), np.float32),
            "offset": np.zeros((n, 2), np.float32),
            "orig_size": np.full((n, 2), hw, np.int32),
            "sample_pad": np.arange(n) >= n - pad}
        self.batch, self.seed, self.epoch = batch, seed, 0
        self.shuffle = pad == 0
        self.gt_total = int(counts[:n - pad].sum())

    def set_epoch(self, epoch: int) -> None:
        self.epoch = epoch

    def __len__(self) -> int:
        return len(self.samples["image"]) // self.batch

    def __iter__(self):
        order = np.arange(len(self.samples["image"]))
        if self.shuffle:
            np.random.RandomState(self.seed + self.epoch).shuffle(order)
        for i in range(len(self)):
            rows = order[i * self.batch:(i + 1) * self.batch]
            yield {k: v[rows] for k, v in self.samples.items()}


def trainer_loaders(env: dict, root: str, hw: int, num_classes: int,
                    seed: int) -> tuple:
    """(train loader, validation loader, source, ground-truth boxes of the
    validation batch's real images): the port's ``DataLoader`` over a
    fixture written now where pandas, pyarrow and PIL are there (PIL or the
    native decoder decodes), else :class:`MemoryLoader`. The train loader
    gives ``TRAINER_BATCHES`` batches of ``TRAIN_BATCH``; the validation
    loader one batch of ``TRAINER_VAL_REAL`` images padded to
    ``TRAIN_BATCH`` (``sample_pad``)."""
    n_train = TRAINER_BATCHES * TRAIN_BATCH
    max_gt = 128
    if env["pandas"] and env["pyarrow"] and env["PIL"]:
        from custom_yolo_tpu_torch.data.dataset import DetectionDataset
        from custom_yolo_tpu_torch.data.loader import DataLoader

        path, image_dir, counts = write_fixture(
            root, n_train + TRAINER_VAL_REAL, num_classes, seed)
        kw = dict(input_size=(hw, hw), max_gt=max_gt, seed=seed)
        train_ds = DetectionDataset(path, image_dir, **kw)
        train_ds.df = train_ds.df.iloc[:n_train].reset_index(drop=True)
        val_ds = DetectionDataset(path, image_dir, **kw)
        val_ds.df = val_ds.df.iloc[n_train:].reset_index(drop=True)
        train = DataLoader(train_ds, TRAIN_BATCH, shuffle=True,
                           drop_last=True, num_workers=4, seed=seed)
        val = DataLoader(val_ds, TRAIN_BATCH, shuffle=False, drop_last=False,
                         num_workers=4, seed=seed,
                         pad_to_multiple=TRAIN_BATCH)
        source = ("fixture: DataLoader, "
                  f"{'native decoder' if train._native else 'PIL'}")
        return (train, val, source,
                int(np.minimum(counts[n_train:], max_gt).sum()))
    train = MemoryLoader(TRAINER_BATCHES, TRAIN_BATCH, hw, max_gt,
                         num_classes, seed)
    val = MemoryLoader(1, TRAIN_BATCH, hw, max_gt, num_classes, seed + 1,
                       pad=TRAIN_BATCH - TRAINER_VAL_REAL)
    return train, val, "in-memory MemoryLoader", val.gt_total


def same_tree(a, b) -> bool:
    """Nested dicts, lists and tuples of tensors and plain values equal,
    every tensor bit for bit (on the host)."""
    if isinstance(a, torch.Tensor):
        return isinstance(b, torch.Tensor) and a.dtype == b.dtype \
            and torch.equal(a.cpu(), b.cpu())
    if isinstance(a, dict):
        return isinstance(b, dict) and a.keys() == b.keys() and all(
            same_tree(a[k], b[k]) for k in a)
    if isinstance(a, (list, tuple)):
        return len(a) == len(b) and all(same_tree(x, y) for x, y in zip(a, b))
    return a == b


def timed(fn, sink: list):
    """``fn`` that appends its wall time, the device's work included, to
    ``sink``."""
    def wrapper(*args, **kwargs):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn(*args, **kwargs)
        torch.cuda.synchronize()
        sink.append(time.perf_counter() - t0)
        return out
    return wrapper


def draw_checks(gen: torch.Generator) -> dict:
    """The port's draws from ``gen`` by their distributions, as
    tests/test_torch_transforms.py holds them on the CPU: flip rate ½,
    jitter factors in range, hue within ±0.1·2π, permutations valid, crop
    offsets in [0, H] reaching both ends, Beta(32, 32) mean ½ and variance
    1/260 over 20k draws, apply rates at their probability."""
    n = 20000
    flip = transforms.draw_flip(n, gen).float().mean().item()
    jit = transforms.draw_color_jitter(n, gen)
    factors = [(f.min().item(), f.max().item()) for f in jit[:3]]
    hue = jit.hue.abs().max().item()
    mos = [transforms.draw_mosaic(TRAIN_BATCH, HW, HW, 0.5, gen)
           for _ in range(400)]
    perms_ok = all(torch.equal(m.src_idx[:, j].sort().values,
                               torch.arange(TRAIN_BATCH, device=gen.device))
                   for m in mos for j in range(4))
    oy = torch.cat([m.oy for m in mos])
    ox = torch.cat([m.ox for m in mos])
    apply = torch.cat([m.apply for m in mos]).float().mean().item()
    lam = transforms.draw_beta(32.0, 32.0, n, gen).double()
    stats = {"flip_rate": flip, "jitter_ranges": factors, "hue_max": hue,
             "offsets": [int(oy.min()), int(oy.max()), int(ox.min()),
                         int(ox.max())],
             "mosaic_apply_rate": apply, "beta_mean": lam.mean().item(),
             "beta_var": lam.var().item()}
    check(abs(flip - 0.5) < 0.02, f"flip rate {flip}")
    check(all(0.8 <= lo and hi < 1.2 for lo, hi in factors),
          f"jitter factors {factors}")
    check(hue <= 0.1 * 2 * np.pi, f"hue angle {hue}")
    check(perms_ok, "a mosaic permutation is not one")
    check(stats["offsets"] == [0, HW, 0, HW], f"crop offsets {stats}")
    check(abs(apply - 0.5) < 0.03, f"mosaic apply rate {apply}")
    check(abs(stats["beta_mean"] - 0.5) < 0.01
          and abs(stats["beta_var"] - 1 / 260) < 0.1 / 260,
          f"Beta(32, 32) draws: {stats}")
    return stats


def host_batch(n: int, hw: int, max_gt: int, num_classes: int,
               seed: int) -> dict:
    """A loader-shaped host batch: uint8 images, 1..max_gt centre-xywh
    boxes per image (padded, masked) and their labels."""
    return {k: v for k, v in MemoryLoader(1, n, hw, max_gt, num_classes,
                                          seed).samples.items()}


def trainer_config(preset: dict, hw: int, precision: str,
                   checkpoint_dir: str, **training) -> Config:
    """The config of phases 8b and 8c: ``preset``'s widths, 172 classes,
    one device, batches of ``TRAIN_BATCH``, two epochs, staging through
    pinned memory, augmentation on unless ``training`` says otherwise."""
    augment = training.pop("augment", True)
    return Config.from_dict({
        "project": {"seed": SEED, "num_classes": NUM_CLASSES},
        "model": {"num_classes": NUM_CLASSES, "input_size": [hw, hw],
                  "config": {k: list(preset[k])
                             for k in ("width", "depth", "csp")}},
        "data": {"pin_memory": True, "augment": augment,
                 "max_gt_boxes": 128},
        "training": {"batch_size": TRAIN_BATCH, "epochs": 2,
                     "log_interval": TRAINER_BATCHES,
                     "sharding": {"mode": "single", "precision": precision},
                     **training},
        "checkpoint": {"checkpoint_dir": checkpoint_dir}})


def augmentation_phase(dev, train_ms: float) -> dict:
    """Phase 8a: ``batch_augment`` (mosaic and mixup everywhere) and
    ``batch_preprocess`` at x/640² B=8, 128 box slots, given one set of
    draws on the card and on the CPU; the card's own draws by their
    distributions; staging and augmenting a batch without waiting for the
    device; device and events times beside the train step's."""
    host = host_batch(TRAIN_BATCH, HW, 128, NUM_CLASSES, SEED + 20)
    keys = ("image", "gt_boxes", "gt_labels", "gt_mask")

    def on(device):
        return [torch.from_numpy(host[k]).to(device) for k in keys]

    draws = transforms.draw_augment(
        TRAIN_BATCH, HW, HW, torch.Generator().manual_seed(SEED + 21),
        mosaic_prob=1.0, mixup_prob=1.0)
    out = {}
    for name, device in (("cpu", torch.device("cpu")), ("card", dev)):
        images, boxes, labels, mask = on(device)
        d = draws.to(device)
        out[name] = (
            transforms.batch_augment(images, boxes, labels, mask, draws=d),
            transforms.batch_preprocess(images, boxes, draws=d),
            transforms.batch_preprocess(images, boxes, train=False))
    errs = {}
    for i, name in enumerate(("batch_augment", "batch_preprocess",
                              "batch_preprocess eval")):
        got = [t.cpu() for t in out["card"][i]]
        want = out["cpu"][i]
        check(all(torch.equal(g, w) for g, w in zip(got[1:], want[1:])),
              f"{name}: boxes, labels or mask differ between card and CPU")
        errs[name] = (got[0] - want[0]).abs().max().item()
        check(errs[name] <= 1e-6, f"{name}: images differ by {errs[name]} "
              f"between card and CPU (limit 1e-6)")
    unit = transforms.to_unit(on(dev)[0]).cpu()
    check(torch.equal(unit, torch.from_numpy(
        host["image"].astype(np.float32) / np.float32(255.0))),
        "÷255 on the card is not the correctly rounded quotient")
    n_valid = int(out["card"][0][3].sum())
    stats = draw_checks(torch.Generator(device=dev).manual_seed(SEED + 22))

    # staging and augmenting wait for nothing on the device
    gen = torch.Generator(device=dev).manual_seed(SEED + 23)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        transforms.make_device_batch(host, gen, dev, train=True,
                                     mosaic_prob=0.5, mixup_prob=0.5,
                                     pin_memory=True)
    finally:
        torch.cuda.set_sync_debug_mode("default")

    images, boxes, labels, mask = on(dev)
    calls = {
        "batch_augment": lambda: transforms.batch_augment(
            images, boxes, labels, mask, gen, mosaic_prob=1.0,
            mixup_prob=1.0),
        "batch_preprocess": lambda: transforms.batch_preprocess(
            images, boxes, gen),
        "make_device_batch": lambda: transforms.make_device_batch(
            host, gen, dev, train=True, mosaic_prob=0.5, mixup_prob=0.5,
            pin_memory=True)}
    times = {name: {"device_ms": device_ms(fn), "events_ms": time_ms(fn)}
             for name, fn in calls.items()}
    log(f"phase 8a augmentation x/640² B={TRAIN_BATCH}, 128 box slots: "
        f"card vs CPU on one set of draws, boxes, labels and mask equal, "
        f"images max abs err {errs} (limit 1e-6), ÷255 exact; "
        f"{n_valid} boxes valid after mosaic and mixup; the card's own "
        f"draws {stats}; make_device_batch waits for nothing; times "
        f"{times}; train step {train_ms} ms (phase 7) | {card_line()}")
    return {"max_abs_err": errs, "draws": stats, "times": times,
            "train_step_ms": train_ms}


def trainer_phase(dev, env: dict, preset: dict) -> tuple:
    """Phase 8b: ``Trainer.fit`` at full width (``preset``, 172 classes,
    640², bf16, B=8, TAL, EMA, warm-up, mosaic 0.5, mixup 0.5, close_mosaic
    1, pinned staging) for two epochs of ``TRAINER_BATCHES`` train batches
    and one validation batch, checkpointing each epoch; then a new Trainer
    on other weights restores epoch 0 and resumes for one. Returns (launch
    counts of the whole phase, numbers)."""
    with tempfile.TemporaryDirectory() as root:
        train_l, val_l, source, val_gt = trainer_loaders(
            env, os.path.join(root, "data"), HW, NUM_CLASSES, SEED + 30)
        ckdir = os.path.join(root, "checkpoints")
        cfg = trainer_config(preset, HW, "bfloat16", ckdir, assigner="tal",
                             ema_decay=0.9999, warmup_steps=3, mosaic=0.5,
                             mixup=0.5, close_mosaic=1)
        kept = {}

        class KeepingManager(CheckpointManager):
            """Keeps a host copy of every state it saves."""

            def save(self, epoch, state, metrics=None):
                kept[epoch] = host_copy(state.state_dict())
                super().save(epoch, state, metrics)

        def new_trainer(seed, manager):
            return Trainer(cfg, create_train_model(
                preset["width"], preset["depth"], preset["csp"],
                NUM_CLASSES, precision="bfloat16", device=dev, seed=seed),
                checkpoint_manager=manager)

        reset_counts()
        torch.cuda.reset_peak_memory_stats()
        trainer = new_trainer(SEED + 31, KeepingManager(ckdir))
        train_s, val_s = [], []
        trainer._train_epoch = timed(trainer._train_epoch, train_s)
        trainer._validate = timed(trainer._validate, val_s)
        history = trainer.fit(train_l, val_l)["history"]
        check(len(history) == 2 and trainer.state.epoch == 2
              and trainer.state.step == 2 * TRAINER_BATCHES,
              f"fit ran {len(history)} epochs, {trainer.state.step} steps")
        resumed = new_trainer(SEED + 32, CheckpointManager(ckdir))
        resumed.load_state(resumed.ckpt.restore(resumed.state, epoch=0))
        check(same_tree(host_copy(resumed.state.state_dict()), kept[0]),
              "the state restored from epoch 0 differs from the saved one")
        again = resumed.fit(train_l, val_l)["history"]
        torch.cuda.synchronize()
        launches = read_counts()
        peak_gb = torch.cuda.max_memory_allocated() / 2 ** 30
        epochs_run = len(history) + len(again)
        want = counts(attention=2 * (TRAINER_BATCHES + 1) * epochs_run,
                      attention_bwd=2 * TRAINER_BATCHES * epochs_run,
                      sppf=epochs_run)
        check(launches == want, f"the trainer launched {launches}, want "
              f"{want}: K1 twice a forward, K4 twice a train step, K5 once "
              f"a validation forward")
        for rec in history + again:
            check(set(rec) == JAX_TAL_HISTORY_KEYS,
                  f"history keys {sorted(rec)} are not the JAX trainer's")
            check(all(np.isfinite(v) for v in rec.values()),
                  f"non-finite value in the history: {rec}")
            # every ground-truth box is matched or missed, predictions or
            # none (total_ground_truths counts only where there are some)
            seen = rec["val/true_positives"] + rec["val/false_negatives"]
            check(seen == val_gt,
                  f"validation counted {seen} ground-truth boxes, the "
                  f"{TRAINER_VAL_REAL} real images hold {val_gt}: sample_pad "
                  f"rows were not skipped")
        prof = profile_call(lambda: resumed._train_epoch(train_l, 1), reps=1)
    n_img = TRAINER_BATCHES * TRAIN_BATCH
    numbers = {
        "source": source,
        "train_loss": [r["train/total_loss"] for r in history],
        "val_loss": [r["val/total_loss"] for r in history],
        "resumed_epoch1": {"train_loss": again[0]["train/total_loss"],
                           "val_loss": again[0]["val/total_loss"]},
        "lr": [r["lr"] for r in history + again],
        "train_epoch_s": train_s, "train_img_per_s": [n_img / s
                                                      for s in train_s],
        "validate_s": val_s, "peak_memory_gib": peak_gb,
        "epoch_idle_share": prof["idle_share"],
        "epoch_device_busy_ms": prof["device_busy_ms"],
        "epoch_window_ms": prof["window_ms"],
        "epoch_launches": prof["kernels_per_call"]}
    log(f"phase 8b Trainer.fit x/640² bf16 B={TRAIN_BATCH}, TAL, EMA, "
        f"warm-up, mosaic/mixup 0.5, close_mosaic 1, pinned staging; data: "
        f"{source}; {json.dumps(numbers)}; restored epoch 0 bit for bit; "
        f"launches {launches} | {card_line()}")
    return launches, numbers


def mid_training(cfg: Config, model, seed: int) -> Trainer:
    """A Trainer whose state looks some way into training, the same on
    every device: BatchNorm scales, biases and statistics off their initial
    values, AdamW moments filled and 50 steps counted. From fresh moments
    AdamW's first updates are ``±lr``, which turns the rounding noise of a
    gradient that is zero in exact arithmetic (a shift in front of a
    training-mode BatchNorm) into a full step of either sign on each device
    (the start of tests/test_torch_train.py's whole-step comparisons)."""
    gen = torch.Generator().manual_seed(seed)

    def draw(shape, low=None, high=None):
        if low is None:
            return 0.1 * torch.randn(shape, generator=gen)
        return torch.rand(shape, generator=gen) * (high - low) + low

    with torch.no_grad():
        for mod in model.modules():
            if isinstance(mod, torch.nn.BatchNorm2d):
                for t, bounds in ((mod.weight, (0.5, 1.5)), (mod.bias, ()),
                                  (mod.running_mean, ()),
                                  (mod.running_var, (0.5, 1.5))):
                    t.copy_(draw(t.shape, *bounds))
    trainer = Trainer(cfg, model)
    for param in model.parameters():
        trainer.optimizer.state[param] = {
            "step": torch.tensor(50.0),
            "exp_avg": (1e-2 * draw(param.shape)).to(param.device),
            "exp_avg_sq": draw(param.shape, 1e-5, 1e-3).to(param.device)}
    trainer.state.step = 50
    return trainer


def trainer_card_vs_cpu(env: dict) -> dict:
    """Phase 8c: the small model's fp32 ``Trainer.fit`` (two epochs, no
    augmentation, nearest assigner, EMA and warm-up, TF32 off) on the card
    and on the CPU over the same batches, from one mid-training state
    (:func:`mid_training`): per-epoch losses within 3e-4 relative, the same
    ``lr`` and ``best_epoch``."""
    results = {}
    with tempfile.TemporaryDirectory() as root:
        train_l, val_l, source, _ = trainer_loaders(
            env, os.path.join(root, "data"), SMALL["hw"], NUM_CLASSES,
            SEED + 40)
        for device in ("cpu", "cuda"):
            cfg = trainer_config(SMALL, SMALL["hw"], "float32",
                                 os.path.join(root, device), augment=False,
                                 ema_decay=0.99, warmup_steps=60,
                                 learning_rate_patience=0)
            model = create_train_model(
                SMALL["width"], SMALL["depth"], SMALL["csp"], NUM_CLASSES,
                precision="float32", device=device, seed=SEED + 41)
            results[device] = mid_training(cfg, model, SEED + 42).fit(
                train_l, val_l)
    cpu, card = results["cpu"], results["cuda"]
    check(len(cpu["history"]) == len(card["history"]) == 2
          and cpu["best_epoch"] == card["best_epoch"],
          f"best epoch {card['best_epoch']} on the card, {cpu['best_epoch']}"
          f" on the CPU")
    errs = []
    for rec_c, rec_g in zip(cpu["history"], card["history"]):
        check(rec_c["lr"] == rec_g["lr"],
              f"lr {rec_g['lr']} on the card, {rec_c['lr']} on the CPU")
        for key in ("train/total_loss", "val/total_loss"):
            err = abs(rec_g[key] - rec_c[key]) / abs(rec_c[key])
            errs.append(err)
            check(err <= 3e-4, f"{key}: card {rec_g[key]} vs CPU "
                  f"{rec_c[key]} (limit 3e-4 relative)")
    log(f"phase 8c fp32 Trainer.fit card vs CPU (small model, "
        f"{SMALL['hw']}², B={TRAIN_BATCH}, 2 epochs, no augmentation, TF32 "
        f"off; data: {source}): losses card "
        f"{[(r['train/total_loss'], r['val/total_loss']) for r in card['history']]}"
        f" vs CPU "
        f"{[(r['train/total_loss'], r['val/total_loss']) for r in cpu['history']]}"
        f", largest relative gap {max(errs)} (limit 3e-4); lr "
        f"{[r['lr'] for r in card['history']]}; best epoch "
        f"{card['best_epoch']} on both")
    return {"max_rel_err": max(errs), "best_epoch": card["best_epoch"]}


# ------------------------------------------------------------ the CLI phase
REPO = os.path.dirname(os.path.abspath(__file__))
# phase 9: the fixture of torch_make_fixture.py (24 train and 8 validation
# JPEGs, sides 320-639, 8 classes), the small model's classes for the
# card-against-CPU evaluation, the copies of the fixture's 32 images and a
# PNG that the serve CLI reads, and the lines the CLIs print
CLI_TRAIN_IMAGES = 24
CLI_CLASSES = 8
CLI_SMALL = dict(SMALL, num_classes=CLI_CLASSES)
SERVE_REPEATS = 8
LAUNCH_LINE = "[INFO] kernel launches: "
RESULTS_LINE = "[INFO] results: "


def run_cli(script: str, args, sink=None, env=None,
            timeout: int = 600) -> tuple:
    """``python3 scripts/{script} args`` in a child process; a non-zero
    exit fails the run. The CLI's closing launch counts are added to
    ``sink`` when it is given. Returns (standard output, seconds)."""
    cmd = [sys.executable, os.path.join(REPO, "scripts", script),
           *map(str, args)]
    t0 = time.perf_counter()
    r = subprocess.run(cmd, capture_output=True, text=True, cwd=REPO,
                       env=env, timeout=timeout)
    seconds = time.perf_counter() - t0
    check(r.returncode == 0, f"{' '.join(cmd)} exited with {r.returncode}:"
          f"\n{r.stdout[-3000:]}\n{r.stderr[-6000:]}")
    if sink is not None:
        lines = [line[len(LAUNCH_LINE):] for line in r.stdout.splitlines()
                 if line.startswith(LAUNCH_LINE)]
        check(len(lines) == 1, f"{script} printed no launch counts")
        for name, n in json.loads(lines[0]).items():
            sink[name] += n
    return r.stdout, seconds


def printed_results(out: str) -> dict:
    """The unrounded results that ``torch_evaluate.py`` (and
    ``torch_rank_diag.py``) print on an ``[INFO] results:`` line."""
    lines = [line[len(RESULTS_LINE):] for line in out.splitlines()
             if line.startswith(RESULTS_LINE)]
    check(len(lines) == 1, f"torch_evaluate.py printed no results: "
          f"{out[-2000:]}")
    return json.loads(lines[0])


def rle_string(counts) -> str:
    """COCO's compressed RLE string of run lengths (pycocotools
    ``rleToString``: 6-bit chunks offset by 48, counts from the fourth on
    as deltas against the one two before)."""
    out = []
    for i, x in enumerate(counts):
        x = x - counts[i - 2] if i > 2 else x
        more = True
        while more:
            c = x & 0x1F
            x >>= 5
            more = x != -1 if c & 0x10 else x != 0
            out.append(chr((c | 0x20 if more else c) + 48))
    return "".join(out)


def etl_segmentations(env: dict, root: str) -> str:
    """Phase 9a: polygon and crowd rows through ``DataPreprocess``, and RLE
    rows (uncompressed and compressed) where ``cv2`` imports: the polygon
    kept as given, the crowd row's segmentation empty, each RLE rectangle
    a four-corner contour. Returns what was checked."""
    import pandas as pd

    from custom_yolo_tpu_torch.data.preprocess import DataPreprocess

    mask = np.zeros((40, 50), np.uint8)
    mask[5:20, 10:30] = 1
    flat = mask.T.ravel()
    edges = np.flatnonzero(np.diff(flat)) + 1
    counts = np.diff(np.concatenate([[0], edges, [flat.size]])).tolist()
    polygon = [[10.0, 5.0, 29.0, 5.0, 29.0, 19.0]]
    segs = [(polygon, 0), ({"counts": rle_string(counts),
                            "size": [40, 50]}, 1)]
    if env["cv2"]:
        segs += [({"counts": counts, "size": [40, 50]}, 0),
                 ({"counts": rle_string(counts), "size": [40, 50]}, 0)]
    doc = {"images": [{"id": 1, "file_name": "a.jpg", "height": 40,
                       "width": 50}],
           "annotations": [{"id": i + 1, "image_id": 1, "category_id": 3,
                            "bbox": [10.0, 5.0, 20.0, 15.0], "area": 300.0,
                            "iscrowd": crowd, "segmentation": seg}
                           for i, (seg, crowd) in enumerate(segs)],
           "categories": [{"id": 3, "name": "c", "supercategory": "s"}]}
    ann = os.path.join(root, "rle")
    os.makedirs(ann)
    with open(os.path.join(ann, "instances_val2017.json"), "w") as f:
        json.dump(doc, f)
    DataPreprocess.create_parquet_data(
        annotations_dir=ann, output_dir=ann, output_folder="val",
        file_names=["instances_val2017.json"],
        keys=["images", "annotations", "categories"],
        columns=[["id", "file_name", "height", "width"],
                 ["id", "image_id", "category_id", "bbox", "area",
                  "iscrowd", "segmentation"], ["id", "name", "supercategory"]],
        chunk_sizes=[100, 100, 100], is_test=False)
    row = pd.read_parquet(os.path.join(ann, "val")).iloc[0]
    got = [[list(map(float, p)) for p in seg] for seg in row["segmentation"]]
    check(got[0] == polygon and got[1] == [],
          f"ETL segmentations {got[:2]}: the polygon or the crowd row "
          f"changed")
    corners = [[10.0, 5.0, 10.0, 19.0, 29.0, 19.0, 29.0, 5.0]]
    check(all(seg == corners for seg in got[2:]),
          f"ETL: RLE rectangles became {got[2:]}, not {corners}")
    return ("polygon, crowd and RLE (uncompressed, compressed) rows"
            if env["cv2"] else "no cv2 here: polygon and crowd rows only, "
            "RLE rows need cv2")


def cli_serve_direct(det, paths, hw: int, batch: int, conf: float) -> list:
    """What ``scripts/torch_serve.py`` writes, computed here: its decoder
    choice (native for all-JPEG batches where it builds, else PIL), its
    padded batches and ``Detector.serve`` on them, boxes in original
    pixels, clipped, rounded as the CLI rounds."""
    from PIL import Image

    from custom_yolo_tpu_torch.runtime import NativeDecoder, native_available

    dec = NativeDecoder(os.cpu_count() or 1) if native_available() else None
    out = []
    for i in range(0, len(paths), batch):
        chunk = paths[i:i + batch]
        padded = chunk + [chunk[-1]] * (batch - len(chunk))
        if dec is not None and all(p.lower().endswith((".jpg", ".jpeg"))
                                   for p in padded):
            u8, sizes, _ = dec.decode_batch(padded, hw, hw)
        else:
            u8 = np.zeros((batch, hw, hw, 3), np.uint8)
            sizes = np.zeros((batch, 2), np.int32)
            for j, path in enumerate(padded):
                with Image.open(path) as im:
                    im = im.convert("RGB")
                    sizes[j] = im.size
                    u8[j] = np.asarray(im.resize((hw, hw), Image.BILINEAR))
        res = det.serve(torch.from_numpy(u8), conf_thres=conf,
                        device_preprocess=True)
        boxes, scores = res.boxes.cpu().numpy(), res.scores.cpu().numpy()
        classes, nv = res.classes.cpu().numpy(), res.num_valid.cpu().numpy()
        for j, path in enumerate(chunk):
            w, h = int(sizes[j][0]), int(sizes[j][1])
            b = boxes[j, :int(nv[j])].astype(np.float64)
            b[:, [0, 2]] = (b[:, [0, 2]] * (w / hw)).clip(0, w)
            b[:, [1, 3]] = (b[:, [1, 3]] * (h / hw)).clip(0, h)
            out.append({"image": os.path.basename(path), "width": w,
                        "height": h, "detections": [
                            [round(float(v), 2) for v in b[k]]
                            + [round(float(scores[j, k]), 4),
                               int(classes[j, k])]
                            for k in range(len(b))]})
    return out


def trace_idle_share(path: str, after: str = None) -> tuple:
    """(idle share, busy ms, window ms) of a Chrome trace: the union of its
    kernel, copy and memset intervals over the span of all its events, or
    over the span from the end of the one event named ``after`` to the
    last event's end (the host's span of ``after``)."""
    with open(path) as f:
        events = [e for e in json.load(f)["traceEvents"]
                  if "ts" in e and "dur" in e]
    start = min(float(e["ts"]) for e in events)
    if after is not None:
        # the host's span; a CUDA trace also holds its copy on the card's
        # timeline ("gpu_user_annotation")
        marks = [float(e["ts"]) + float(e["dur"]) for e in events
                 if e.get("name") == after
                 and e.get("cat") == "user_annotation"]
        check(len(marks) == 1, f"{path} holds {len(marks)} events {after}")
        start = marks[0]
    stop = max(float(e["ts"]) + float(e["dur"]) for e in events)
    spans = sorted((max(float(e["ts"]), start),
                    float(e["ts"]) + float(e["dur"])) for e in events
                   if e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset")
                   and float(e["ts"]) + float(e["dur"]) > start)
    check(spans, f"{path} holds no device activity")
    busy, end = 0.0, -1.0
    for lo, hi in spans:
        if hi > end:
            busy += hi - max(lo, end)
            end = hi
    window = stop - start
    return 1 - busy / window, busy / 1e3, window / 1e3


def small_eval_cli(root: str, cfg_path: str, sink: dict,
                   devices=("cpu", "cuda")) -> dict:
    """Phase 9c's comparison: ``torch_evaluate.py --use_nms --coco_map`` of
    the small fp32 model (seeded weights whose boxes and class scores are
    set so that some of them pass the gate of 0.3 and match the fixture's
    ground truth) on each of
    ``devices``, TF32 off, over the validation set of the config at
    ``cfg_path`` resized to 64²: the same counts, floats within 1e-6.
    Launches on the card are added to ``sink``. Returns the last device's
    results."""
    small = Detector(CLI_SMALL["width"], CLI_SMALL["depth"],
                     CLI_SMALL["csp"], CLI_CLASSES, precision="float32",
                     input_size=(CLI_SMALL["hw"],) * 2, device="cpu")
    small.init(SEED + 50)
    with torch.no_grad():
        bins = torch.full((16,), -2.0)
        bins[1:3] = torch.tensor([3.0, 2.0])
        for i in range(3):
            getattr(small.model.head, f"box{i}_out").bias.copy_(
                bins.repeat(4))
            # untrained, the class scores sit within 1e-5 of the bias
            # prior; widened weights spread them over 0.27-0.36
            cls_out = getattr(small.model.head, f"cls{i}_out")
            cls_out.bias.fill_(-1.0)
            cls_out.weight.mul_(5000.0)
    small.save_weights(os.path.join(root, "small_w"))
    cfg = Config.from_yaml(cfg_path)
    cfg.project.num_classes = cfg.model.num_classes = CLI_CLASSES
    for key in ("width", "depth", "csp"):
        setattr(cfg.model, key, list(CLI_SMALL[key]))
    cfg.model.input_size = [CLI_SMALL["hw"]] * 2
    cfg.training.sharding.precision = "float32"
    cfg.save(os.path.join(root, "small.yaml"))
    results = {}
    for device in devices:
        out, _ = run_cli("torch_evaluate.py", [
            "--config", os.path.join(root, "small.yaml"), "--checkpoint",
            os.path.join(root, "small_w"), "--device", device,
            "--conf_threshold", 0.3, "--use_nms", "--coco_map"],
            sink if device == "cuda" else None,
            env={**os.environ, "NVIDIA_TF32_OVERRIDE": "0"})
        results[device] = printed_results(out)
    want = results[devices[0]]
    check(want["metrics"]["true_positives"] > 0,
          f"small evaluate: no true positive to compare ({want})")
    for device in devices[1:]:
        for part in ("metrics", "coco"):
            for key, value in want[part].items():
                got = results[device][part][key]
                check(got == value if isinstance(value, int)
                      else abs(got - value) <= 1e-6,
                      f"small evaluate {part}/{key}: {device} {got} vs "
                      f"{devices[0]} {value}")
    return results[devices[-1]]


def cli_fixture(env: dict, preset: dict, root: str) -> tuple:
    """Phase 9a: ``torch_make_fixture.py`` (24 train and 8 validation JPEGs
    at 640, 8 classes) and ``torch_data_preprocess.py`` under
    ``root/data``, and the x/640² bf16 config that reads them
    (``root/x.yaml``: TAL, EMA, warm-up, checkpoints to ``root/ckpt``).
    Returns (the config's path, the scripts' seconds)."""
    check(env["pandas"] and env["pyarrow"] and env["PIL"],
          "phase 9 needs pandas, pyarrow and PIL for the ETL")
    numbers = {}
    data = os.path.join(root, "data")
    _, numbers["fixture_s"] = run_cli(
        "torch_make_fixture.py", ["--root", data, "--images",
                                  CLI_TRAIN_IMAGES, "--size", HW,
                                  "--seed", 2, "--classes", CLI_CLASSES])
    cfg = trainer_config(preset, HW, "bfloat16",
                         os.path.join(root, "ckpt"), assigner="tal",
                         ema_decay=0.999, warmup_steps=3)
    cfg.data.annotations_dir = os.path.join(data, "raw", "annotations")
    cfg.data.processed_dir = os.path.join(data, "processed", "parquet")
    cfg.data.train_images = os.path.join(data, "raw", "images", "train")
    cfg.data.val_images = os.path.join(data, "raw", "images", "val")
    cfg.project.log_dir = os.path.join(root, "logs")
    cfg_path = os.path.join(root, "x.yaml")
    cfg.save(cfg_path)
    _, numbers["data_preprocess_s"] = run_cli(
        "torch_data_preprocess.py", ["--mode", "val", "--config",
                                     cfg_path])
    return cfg_path, numbers


def cli_phase(env: dict, preset: dict, root: str) -> tuple:
    """Phase 9: the deployment path through the command-line entry points,
    each a child process on the card: 9a the ETL (``torch_make_fixture.py``
    at 640, ``torch_data_preprocess.py``, RLE rows), 9b one epoch of
    ``torch_train.py`` at x/640² bf16 B=8 (EMA on), 9c
    ``torch_evaluate.py`` on its checkpoint (plain, ``--use_nms
    --coco_map``, ``--quantize static``) and a small fp32 model's metrics
    card against CPU, 9d ``save_weights``/``load_weights`` of the x
    detector fused, optimised and static int8 (bit for bit on the card),
    9e ``torch_serve.py`` over the fixture's images and a PNG, repeated to
    a few hundred, from a ``save_weights`` directory, against
    ``Detector.serve`` called here, then its warm-up, steady-state rate,
    decode time and the card's idle share. The fixture and 9b's
    checkpoint go under ``root`` and stay there. Returns (launch counts
    of the CLI processes, launch counts of 9d's calls in this process,
    numbers)."""
    from PIL import Image

    from custom_yolo_tpu_torch.utils.checkpoint import restore_variables

    launches = counts()
    # ------------------------------------------------------- 9a. ETL
    cfg_path, numbers = cli_fixture(env, preset, root)
    cfg = Config.from_yaml(cfg_path)
    data = os.path.join(root, "data")
    t0 = time.perf_counter()
    seg_note = etl_segmentations(env, root)
    numbers["segmentations_s"] = time.perf_counter() - t0
    n_val = len(os.listdir(cfg.data.val_images))
    log(f"phase 9a ETL: torch_make_fixture.py --images "
        f"{CLI_TRAIN_IMAGES} --size {HW} --seed 2 ({CLI_TRAIN_IMAGES} "
        f"train + {n_val} val JPEGs and their parquet) "
        f"{numbers['fixture_s']} s, torch_data_preprocess.py --mode val "
        f"{numbers['data_preprocess_s']} s (process start included); "
        f"{seg_note}")

    # ----------------------------------------------------- 9b. train
    out, numbers["train_cli_s"] = run_cli(
        "torch_train.py", ["--config", cfg_path, "--mode", "single",
                           "--device", "cuda", "--epochs", 1], launches)
    ckpt_epoch = os.path.join(root, "ckpt", "model_epoch_0")
    check(os.path.exists(os.path.join(ckpt_epoch, "state.pt")),
          "torch_train.py wrote no model_epoch_0")
    # the epoch's record, phase 10b's single-process reference
    records = [line.split(": ", 1)[1] for line in out.splitlines()
               if line.startswith("[INFO] history: ")]
    check(len(records) == 1, "torch_train.py printed no history")
    numbers["train_record"] = json.loads(records[0])
    log(f"phase 9b torch_train.py --device cuda --epochs 1, x/640² bf16 "
        f"B={TRAIN_BATCH} on the 9a fixture: "
        f"{numbers['train_cli_s']} s, model_epoch_0 written")

    # -------------------------------------------------- 9c. evaluate
    evals = {}
    for name, flags in (("plain", []),
                        ("nms_coco", ["--use_nms", "--coco_map"]),
                        ("static_int8", ["--quantize", "static",
                                         "--calib_batches", 1])):
        out, seconds = run_cli("torch_evaluate.py", [
            "--config", cfg_path, "--checkpoint", ckpt_epoch,
            "--device", "cuda"] + flags, launches)
        res = printed_results(out)
        values = list(res["metrics"].values()) + list(
            (res["coco"] or {}).values())
        check(res["images"] == n_val and all(
            np.isfinite(v) for v in values),
            f"evaluate {name}: {res}")
        check("(EMA params)" in out,
              f"evaluate {name} did not restore the EMA: {out[-2000:]}")
        # the loop is one cold batch of the 8 validation images: its
        # time is start-up, not a rate
        evals[name] = {"process_s": seconds,
                       "cold_loop_s": res["seconds"],
                       "metrics": res["metrics"], "coco": res["coco"]}
    log(f"phase 9c torch_evaluate.py --device cuda on model_epoch_0 "
        f"(EMA), x/640² bf16 B={TRAIN_BATCH}: {json.dumps(evals)}")
    numbers["evaluate"] = evals

    # the small fp32 model on the card and on the CPU, TF32 off
    small = small_eval_cli(root, cfg_path, launches)
    log(f"phase 9c small fp32 evaluate CLI card vs CPU (TF32 off, "
        f"{CLI_SMALL['hw']}², --use_nms --coco_map): equal (counts "
        f"exact, floats within 1e-6): {json.dumps(small['metrics'])}; "
        f"mAP_50 {small['coco']['mAP_50']}")

    # -------------------------------------------- 9d. save and load
    x = torch.from_numpy(np.random.RandomState(SEED + 51).randint(
        0, 256, (SERVE_BATCH, HW, HW, 3), dtype=np.uint8))
    variables, _, _ = restore_variables(os.path.join(root, "ckpt"), 0)
    persistence = counts()
    reset_counts()
    for name in ("fused", "optimized", "static_int8"):
        det = Detector(preset["width"], preset["depth"], preset["csp"],
                       NUM_CLASSES, input_size=(HW, HW))
        det.load_variables(variables)
        det.fuse()
        if name == "optimized":
            det.optimize_for_serving()
        if name == "static_int8":
            det.quantize().calibrate([normalize(x.cuda())])
        wdir = os.path.join(root, f"w_{name}")
        det.save_weights(wdir)
        new = Detector(preset["width"], preset["depth"], preset["csp"],
                       NUM_CLASSES, input_size=(HW, HW))
        new.load_weights(wdir)
        check(new._transform_flags() == det._transform_flags(),
              f"9d {name}: flags {new._transform_flags()} after the "
              f"load, {det._transform_flags()} before")
        want = det.serve(x, conf_thres=POOL_CONF, device_preprocess=True)
        got = new.serve(x, conf_thres=POOL_CONF, device_preprocess=True)
        check(all(torch.equal(a, b) for a, b in zip(got, want))
              and int(want.num_valid.sum()) > 0,
              f"9d {name}: the reloaded detector serves another result")
        del det, new
    torch.cuda.synchronize()
    for name, n in read_counts().items():
        persistence[name] += n
    log(f"phase 9d save_weights/load_weights, x/640² bf16 B="
        f"{SERVE_BATCH}, from model_epoch_0's EMA: fused, fused + "
        f"optimize_for_serving and static int8 each serve bit for bit "
        f"after the round trip; flags equal")

    # ----------------------------------------------------- 9e. serve
    # the fixture's 32 JPEGs and a PNG, repeated to a few hundred
    # images so that the steady state after the first batch is timed
    # over tens of batches
    images = os.path.join(root, "serve_images")
    os.makedirs(images)
    unique = []
    for split in ("train", "val"):
        folder = os.path.join(data, "raw", "images", split)
        unique += [os.path.join(folder, name)
                   for name in sorted(os.listdir(folder))]
    with Image.open(unique[0]) as im:
        im.save(os.path.join(root, "frame.png"))
    unique.append(os.path.join(root, "frame.png"))
    for k in range(SERVE_REPEATS):
        for src in unique:
            shutil.copy(src, os.path.join(
                images, f"r{k}_{os.path.basename(src)}"))
    paths = sorted(os.path.join(images, n) for n in os.listdir(images))
    wdir = os.path.join(root, "w_fused")
    serve_args = ["--images", images, "--checkpoint", wdir, "--preset",
                  "x", "--num_classes", NUM_CLASSES, "--input_size", HW,
                  "--batch_size", SERVE_BATCH, "--inflight", 2, "--conf",
                  POOL_CONF, "--device", "cuda"]
    runs = {}
    for name, extra in (("plain", []),
                        ("profiled", ["--profile_dir",
                                      os.path.join(root, "prof")])):
        out, seconds = run_cli("torch_serve.py", serve_args + [
            "--output", os.path.join(root, f"det_{name}.json")] + extra,
            launches)
        m = re.search(r"(\d+) images -> (\d+) detections in ([\d.]+) s "
                      r"\(([\d.]+) img/s", out)
        w = re.search(r"first batch fetched after ([\d.]+) s; the other "
                      r"(\d+) images in ([\d.]+) s \(([\d.]+) img/s\); "
                      r"decode on the producer thread ([\d.]+) s "
                      r"\(([\d.]+) ms/img\)", out)
        check(m is not None and w is not None
              and int(m.group(1)) == len(paths),
              f"serve CLI {name}: {out[-2000:]}")
        runs[name] = {
            "process_s": seconds, "wall_s": float(m.group(3)),
            "img_per_s_incl_warm_up": float(m.group(4)),
            "first_batch_s": float(w.group(1)),
            "steady_images": int(w.group(2)),
            "steady_s": float(w.group(3)),
            "steady_img_per_s": float(w.group(4)),
            "decode_s": float(w.group(5)),
            "decode_ms_per_img": float(w.group(6)),
            "detections": int(m.group(2))}
    decoder = re.search(r"decoder: (\w+)", out).group(1)
    with open(os.path.join(root, "det_plain.json")) as f:
        served = json.load(f)
    direct = Detector(preset["width"], preset["depth"], preset["csp"],
                      NUM_CLASSES, input_size=(HW, HW))
    direct.load_weights(wdir)
    want = cli_serve_direct(direct, paths, HW, SERVE_BATCH, POOL_CONF)
    check(served == want and sum(len(r["detections"])
                                 for r in want) > 0,
          "serve CLI: detections.json differs from Detector.serve on "
          "the same decoded batches")
    del direct
    trace_path = os.path.join(root, "prof", "trace.json")
    idle_all, busy_all, window_all = trace_idle_share(trace_path)
    idle, busy_ms, window_ms = trace_idle_share(
        trace_path, after="serve_cli.first_fetch")
    runs["profiled"].update(
        idle_share_steady=idle, device_busy_ms_steady=busy_ms,
        trace_window_ms_steady=window_ms, idle_share_whole=idle_all,
        device_busy_ms_whole=busy_all, trace_window_ms_whole=window_all)
    numbers["serve"] = dict(
        images=len(paths), batches=-(-len(paths) // SERVE_BATCH),
        decoder=decoder, **runs)
    log(f"phase 9e serve CLI x/640² bf16 B={SERVE_BATCH} --inflight 2, "
        f"{len(paths)} images ({len(unique)} files, PNGs among them, "
        f"{SERVE_REPEATS} times), from a save_weights directory: "
        f"detections.json equal to Detector.serve on the same decoded "
        f"batches; {json.dumps(numbers['serve'])}")
    plain = runs["plain"]
    log(f"phase 9e serve CLI: wall {plain['img_per_s_incl_warm_up']} "
        f"img/s with the warm-up; steady state "
        f"{plain['steady_img_per_s']} img/s over "
        f"{plain['steady_images']} images after a first batch of "
        f"{plain['first_batch_s']} s; decoder {decoder}, "
        f"{plain['decode_ms_per_img']} ms/img on the producer thread "
        f"({plain['decode_s']} s of {plain['wall_s']} s); device idle "
        f"share {idle} over the profiled run's steady state "
        f"({idle_all} with its warm-up) | {card_line()}")
    # the fixture and 9b's checkpoint stay for phases 10 and 12
    return launches, persistence, numbers


# ------------------------------------------------- the last entry points
# phase 13: the examples, the train-step profiler and its digest, and the
# soak at a reduced scale, each run in this process; the soak's sizes, and
# the steps the profiler captures
SOAK_SIZES = dict(train_images=512, val_images=64, loader_batches=50,
                  train_steps=30, fit_steps=5, eval_images=500)
SOAK_BATCH = 16
PROFILE_STEPS = 3
# phase 13b: the digest's device ms a step against phase 7's busy ms of
# the same step, and its phase rows against its total
PROFILE_AGREEMENT = 0.2
PHASE_SUM_TOL = 0.01


def load_entry_point(folder: str, name: str):
    """The module of ``folder/name.py``, imported without running its
    ``main`` and registered in ``sys.modules`` (the soak's forked workers
    unpickle its functions by that name)."""
    spec = importlib.util.spec_from_file_location(
        f"{folder}_{name}", os.path.join(REPO, folder, f"{name}.py"))
    module = importlib.util.module_from_spec(spec)
    sys.modules[spec.name] = module
    spec.loader.exec_module(module)
    return module


def argv(*args) -> list:
    return [str(a) for a in args]


def run_entry_point(fn, sink: dict, printed: bool = True):
    """``fn()`` in this process with the launch counts zeroed first; its
    launches are added to ``sink``. A script's ``main`` prints its launch
    counts last (``printed``): the line must equal the counters. Returns
    (fn's result, its standard output, seconds)."""
    reset_counts()
    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        result = fn()
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    out = buf.getvalue()
    log(out.rstrip())
    got = read_counts()
    if printed:
        lines = [line[len(LAUNCH_LINE):] for line in out.splitlines()
                 if line.startswith(LAUNCH_LINE)]
        check(len(lines) == 1 and json.loads(lines[0]) == got,
              f"the launch line {lines} differs from the counters {got}")
    for name, n in got.items():
        sink[name] += n
    return result, out, seconds


def folder_serve_direct(det, paths, hw: int, batch: int,
                        conf: float) -> dict:
    """What ``examples/torch_serve_folder.py`` writes, computed here: its
    decoder choice (native where it builds, else PIL), its batches (the
    last padded from its own first images), host normalisation and
    ``Detector.serve``, boxes scaled to the original image."""
    from PIL import Image

    from custom_yolo_tpu_torch.runtime import NativeDecoder, native_available

    dec = NativeDecoder(8) if native_available() else None
    out = {}
    for i in range(0, len(paths), batch):
        chunk = paths[i:i + batch]
        if dec is not None:
            images, sizes = dec.decode_batch(chunk, hw, hw)[:2]
        else:
            imgs, sizes = [], []
            for path in chunk:
                with Image.open(path) as im:
                    im = im.convert("RGB")
                    sizes.append(im.size)
                    imgs.append(np.asarray(im.resize(
                        (hw, hw), Image.Resampling.BILINEAR)))
            images, sizes = np.stack(imgs), np.asarray(sizes, np.int32)
        n = len(chunk)
        images = np.concatenate([images, images[np.arange(batch - n) % n]])
        x = (images.astype(np.float32) / 255.0 - IMAGENET_MEAN) / IMAGENET_STD
        r = det.serve(torch.from_numpy(x), conf_thres=conf)
        boxes, scores = r.boxes.cpu().numpy(), r.scores.cpu().numpy()
        classes, valid = r.classes.cpu().numpy(), r.valid.cpu().numpy()
        for j, path in enumerate(chunk):
            sx, sy, v = sizes[j, 0] / hw, sizes[j, 1] / hw, valid[j]
            out[os.path.basename(path)] = [{
                "bbox_xyxy": [float(x1 * sx), float(y1 * sy),
                              float(x2 * sx), float(y2 * sy)],
                "score": float(s), "class_id": int(c)}
                for (x1, y1, x2, y2), s, c in zip(
                    boxes[j][v], scores[j][v], classes[j][v])]
    return out


def examples_phase(preset: dict, root: str, sink: dict) -> dict:
    """Phase 13a: ``examples/torch_serve_folder.py`` over phase 9's train
    JPEGs from 9d's fused ``save_weights`` directory, equal to
    ``Detector.serve`` on the same decoded batches;
    ``examples/torch_inference_demo.py`` on one of them from 9b's
    checkpoint (EMA), equal to ``Detector.inference``;
    ``examples/torch_train_smoke.py --synthetic`` at x/640² B=8, five
    steps, finite losses."""
    from custom_yolo_tpu_torch.utils.checkpoint import restore_variables

    numbers = {}
    cfg_path = os.path.join(root, "x.yaml")
    folder = os.path.join(root, "data", "raw", "images", "train")
    paths = sorted(os.path.join(folder, n) for n in os.listdir(folder))
    wdir = os.path.join(root, "w_fused")
    folder_json = os.path.join(root, "folder.json")
    batch = 16
    serve_folder = load_entry_point("examples", "torch_serve_folder")
    served, out, numbers["serve_folder_s"] = run_entry_point(
        lambda: serve_folder.main(argv(
            "--images", folder, "--config", cfg_path, "--checkpoint", wdir,
            "--batch_size", batch, "--conf", POOL_CONF, "--out",
            folder_json, "--device", "cuda")), sink)
    with open(folder_json) as f:
        check(json.load(f) == served, "serve_folder: its JSON file differs "
              "from what its main returned")
    det = Detector(preset["width"], preset["depth"], preset["csp"],
                   NUM_CLASSES, input_size=(HW, HW))
    det.load_weights(wdir)
    det.fuse()
    want = folder_serve_direct(det, paths, HW, batch, POOL_CONF)
    n_det = sum(len(v) for v in want.values())
    check(served == want and n_det > 0, "serve_folder: detections differ "
          "from Detector.serve on the same decoded batches")
    numbers["serve_folder"] = {"images": len(paths), "detections": n_det,
                               "line": out.splitlines()[-2]}
    del det

    image = paths[0]
    demo = load_entry_point("examples", "torch_inference_demo")
    got, out, numbers["inference_demo_s"] = run_entry_point(
        lambda: demo.main(argv(
            "--image", image, "--config", cfg_path, "--checkpoint",
            os.path.join(root, "ckpt"), "--conf", POOL_CONF, "--fuse",
            "--device", "cuda")), sink)
    check("[INFO] restored epoch 1" in out,
          f"inference_demo did not restore 9b's checkpoint: {out[-1000:]}")
    det = Detector(preset["width"], preset["depth"], preset["csp"],
                   NUM_CLASSES, input_size=(HW, HW))
    det.load_variables(restore_variables(os.path.join(root, "ckpt"), 0)[0])
    det.fuse()
    want = det.inference(image, conf_thres=POOL_CONF)[0]
    check(np.array_equal(got, want) and len(want) > 0,
          "inference_demo: detections differ from Detector.inference")
    numbers["inference_demo_detections"] = len(want)
    del det

    smoke = load_entry_point("examples", "torch_train_smoke")
    history, out, numbers["train_smoke_s"] = run_entry_point(
        lambda: smoke.main(argv(
            "--config", os.path.join(REPO, "configs", "config.yaml"),
            "--synthetic", "--preset", "x", "--input_size", HW,
            "--batch_size", TRAIN_BATCH, "--steps", 5, "--device",
            "cuda")), sink)
    check(len(history) == 5 and all(np.isfinite(v) for m in history
                                    for v in m.values()),
          f"train_smoke: {history}")
    numbers["train_smoke"] = {"total_loss": [m["total_loss"]
                                             for m in history],
                              "line": out.splitlines()[-2]}
    log(f"phase 13a examples, x/640² bf16: torch_serve_folder.py B={batch} "
        f"over {len(paths)} JPEGs equal to Detector.serve on the same "
        f"decoded batches, torch_inference_demo.py --fuse equal to "
        f"Detector.inference ({len(want)} detections), "
        f"torch_train_smoke.py --synthetic B={TRAIN_BATCH} 5 steps finite: "
        f"{json.dumps(numbers)}")
    return numbers


def profile_phase(root: str, train_busy_ms: float, sink: dict) -> dict:
    """Phase 13b: ``scripts/torch_profile.py`` at x/640² B=8 TAL (16 box
    slots, phase 7's) for ``PROFILE_STEPS`` steps, then
    ``scripts/torch_analyze_profile.py``: its phase rows sum to its
    total, fwd and bwd both hold time, K1 and K4 run as often as the
    captured steps launch them, and its device ms a step lies within
    ``PROFILE_AGREEMENT`` of phase 7's busy ms of the same step."""
    cfg = Config.from_yaml(os.path.join(REPO, "configs", "config.yaml"))
    cfg.project.profile_dir = os.path.join(root, "profile")
    cfg_path = os.path.join(root, "profile.yaml")
    cfg.save(cfg_path)
    profile = load_entry_point("scripts", "torch_profile")
    _, _, capture_s = run_entry_point(lambda: profile.main(argv(
        "--config", cfg_path, "--preset", "x", "--batch_size", TRAIN_BATCH,
        "--assigner", "tal", "--max_gt", TRAIN_MAX_BOXES, "--steps",
        PROFILE_STEPS, "--device", "cuda")), sink)
    steps = PROFILE_STEPS + 1    # the warm-up step is launched too
    check(sink["attention"] == 2 * steps
          and sink["attention_bwd"] == 2 * steps,
          f"torch_profile.py launched {sink}, want K1 and K4 {2 * steps} "
          f"times each")
    analyze = load_entry_point("scripts", "torch_analyze_profile")
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(io.StringIO()) as buf:
        digest = analyze.main(argv("--dir", cfg.project.profile_dir,
                                   "--steps", PROFILE_STEPS))
    digest_s = time.perf_counter() - t0
    log(buf.getvalue().rstrip())
    phases = {row[0]: row[1] for row in digest["phase"]}
    check(digest["on_device"] and abs(sum(phases.values())
                                      - digest["total_ms"])
          <= PHASE_SUM_TOL * digest["total_ms"],
          f"13b: phase rows {phases} against the total "
          f"{digest['total_ms']} ms")
    check(phases.get("fwd", 0) > 0 and phases.get("bwd", 0) > 0,
          f"13b: fwd or bwd holds no time: {phases}")
    # K1 one kernel a call, K4 two (dq, dkv); two calls of each a step
    port = digest["port_kernels"]
    check(port.get("K1 psa_attention_fwd") == 2 * PROFILE_STEPS
          and port.get("K4 psa_attention_bwd") == 4 * PROFILE_STEPS,
          f"13b: port kernels in the capture {port}, want K1 "
          f"{2 * PROFILE_STEPS} and K4 {4 * PROFILE_STEPS}")
    ratio = digest["total_ms"] / train_busy_ms
    check(abs(ratio - 1) <= PROFILE_AGREEMENT,
          f"13b: the digest's {digest['total_ms']} device ms a step against "
          f"phase 7's busy {train_busy_ms} ms (ratio {ratio})")
    numbers = {"capture_s": capture_s, "digest_s": digest_s,
               "device_ms_per_step": digest["total_ms"],
               "wall_ms_per_step": digest["wall_ms"],
               "phase7_busy_ms": train_busy_ms, "ratio": ratio,
               "phase_ms": phases, "port_kernels": port,
               "family_ms": {row[0]: row[1] for row in digest["family"]},
               "hottest": digest["hottest"][:8]}
    log(f"phase 13b torch_profile.py x/640² B={TRAIN_BATCH} TAL "
        f"{PROFILE_STEPS} steps + torch_analyze_profile.py: device "
        f"{digest['total_ms']} ms a step (phase 7 busy {train_busy_ms}, "
        f"ratio {ratio}), wall {digest['wall_ms']} ms a step; "
        f"{json.dumps(numbers)} | {card_line()}")
    return numbers


def soak_phase(root: str, sink: dict) -> dict:
    """Phase 13c: ``scripts/torch_soak.py``'s phases at ``SOAK_SIZES``:
    gen, etl, loader, train (x, 180 classes, B=16), ``fit_chunk`` twice on
    a copy of ``configs/soak_coco_scale.yaml`` whose data and checkpoint
    paths point under ``root`` (the second resumes the first's global
    step), eval."""
    import yaml

    soak = load_entry_point("scripts", "torch_soak")
    data = os.path.join(root, "soak")
    workers = max(4, os.cpu_count() - 2)
    z = SOAK_SIZES
    stats, seconds = {}, {}

    def timed_phase(name, fn):
        stats[name], _, seconds[name] = run_entry_point(fn, sink,
                                                        printed=False)

    timed_phase("gen", lambda: soak.phase_gen(
        data, z["train_images"], z["val_images"], workers))
    timed_phase("etl", lambda: soak.phase_etl(data))
    timed_phase("loader", lambda: soak.phase_loader(
        data, SOAK_BATCH, workers, n_batches=z["loader_batches"]))
    timed_phase("train", lambda: soak.phase_train(
        data, SOAK_BATCH, workers, z["train_steps"]))
    with open(os.path.join(REPO, "configs", "soak_coco_scale.yaml")) as f:
        raw = yaml.safe_load(f)
    raw["data"].update(
        processed_dir=os.path.join(data, "processed", "parquet"),
        train_images=os.path.join(data, "raw", "images", "train"),
        val_images=os.path.join(data, "raw", "images", "val"),
        num_workers=workers)
    raw["checkpoint"]["checkpoint_dir"] = os.path.join(data, "ckpt")
    fit_cfg = os.path.join(data, "soak_coco_scale.yaml")
    with open(fit_cfg, "w") as f:
        yaml.safe_dump(raw, f)
    chunks, seconds["fit_chunks"] = [], []
    for _ in range(2):
        chunk, _, chunk_s = run_entry_point(lambda: soak.phase_fit_chunk(
            z["fit_steps"], fit_cfg), sink, printed=False)
        chunks.append(chunk)
        seconds["fit_chunks"].append(chunk_s)
    stats["fit_chunks"] = chunks
    timed_phase("eval", lambda: soak.phase_eval(
        data, SOAK_BATCH, workers, n_images=z["eval_images"]))
    check(stats["gen"]["train"]["images"] == z["train_images"]
          and stats["loader"]["images"] == z["loader_batches"] * SOAK_BATCH
          and stats["train"]["steps"] == z["train_steps"],
          f"13c: {stats}")
    check([c["chunk"] for c in chunks] == [0, 1]
          and chunks[1]["global_step"] == chunks[0]["global_step"]
          + z["fit_steps"] == 2 * z["fit_steps"]
          and all(np.isfinite(c["final_loss"]) for c in chunks),
          f"13c: the second chunk does not resume the first: {chunks}")
    check(0 < stats["eval"]["map_50_95"] < 1, f"13c eval: {stats['eval']}")
    log(f"phase 13c torch_soak.py phases at {json.dumps(z)} (B="
        f"{SOAK_BATCH}, {workers} workers): the second fit_chunk resumed "
        f"global step {chunks[0]['global_step']}; stats "
        f"{json.dumps(stats)}; seconds {json.dumps(seconds)} | "
        f"{card_line()}")
    return {"stats": stats, "seconds": seconds}


def entry_points_phase(preset: dict, root: str,
                       train_busy_ms: float) -> tuple:
    """Phase 13: the examples (13a), the train-step profiler and its
    digest (13b) and the soak at a reduced scale (13c), in this process,
    after phase 9 (its fixture, checkpoint and ``save_weights``
    directory under ``root``). Returns (the launch counts of the
    ``examples``, ``profile`` and ``soak`` paths, numbers)."""
    t0 = time.perf_counter()
    launches = {"examples": counts(), "profile": counts(), "soak": counts()}
    numbers = {"examples": examples_phase(preset, root,
                                          launches["examples"])}
    torch.cuda.empty_cache()
    numbers["profile"] = profile_phase(root, train_busy_ms,
                                       launches["profile"])
    torch.cuda.empty_cache()
    numbers["soak"] = soak_phase(root, launches["soak"])
    torch.cuda.empty_cache()
    log(f"phase 13 took {time.perf_counter() - t0:.1f} s")
    return launches, numbers


# ----------------------------------------------------- the multichip phase
# phase 14: scripts/torch_multichip_report.py at x/640² bf16 on four ranks
# (data 2 × fsdp 2, sharing the card over gloo where there are fewer
# cards), global batch 8
MULTICHIP_RANKS = 4
MULTICHIP_ARGS = ("--preset", "x", "--input_size", str(HW), "--devices",
                  str(MULTICHIP_RANKS), "--device", "cuda")


def start_multichip(root: str) -> tuple:
    """Phase 14's report started as a child process, its ranks running
    while phase 12's processes do (neither times anything the other could
    disturb); its report goes under ``root``. Returns (the process, its
    command, the report's path, the start time)."""
    doc = os.path.join(root, "MULTICHIP_TORCH.md")
    cmd = [sys.executable, os.path.join(REPO, "scripts",
                                        "torch_multichip_report.py"),
           *MULTICHIP_ARGS, "--out", doc]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True, cwd=REPO)
    return proc, cmd, doc, time.perf_counter()


def multichip_phase(started: tuple) -> tuple:
    """Phase 14: the multi-card report (:func:`start_multichip`). Its
    collectives must equal the modules' prediction source by source on
    every rank,
    FSDP2's all-gathers and reduce-scatters must carry the bytes of the
    parameters ``param_shardings`` splits, its ranks must launch K1 and
    K4, and its two steps' ``total_loss`` and ``grad_norm`` must agree
    with the same steps on one card over the same global batch, run
    here, within phase 10's bf16 limits (against the one-card fp32 run,
    DIST_BF16_FACTOR times the one-card bf16 run's own error, at least
    DIST_BF16_FLOOR). The report (``docs/MULTICHIP_TORCH.md`` when the
    script runs alone) is printed. Returns (the ranks' launch counts,
    numbers)."""
    card = card_line()
    report = load_entry_point("scripts", "torch_multichip_report")
    proc, cmd, doc, t0 = started
    out, err = proc.communicate(timeout=900)
    seconds = time.perf_counter() - t0
    check(proc.returncode == 0, f"{' '.join(cmd)} exited with "
          f"{proc.returncode}:\n{out[-3000:]}\n{err[-6000:]}")
    res = printed_results(out)
    check(os.path.exists(doc), f"14: no {doc}")
    with open(doc) as f:
        log(f"phase 14 report:\n{f.read()}")
    check(res["mesh"] == {"data": 2, "fsdp": 2},
          f"14: the mesh is {res['mesh']}")
    bad = {k: v for k, v in res["by_source"].items() if not v["match"]}
    check(res["all_match"] and not bad and res["ranks_agree"],
          f"14: collectives against their prediction {bad}, ranks agree "
          f"{res['ranks_agree']}")
    src = res["by_source"]
    split = res["split_param_bytes"]
    check(split > 0 and src["fsdp_reduce_scatter"]["bytes"] == split
          and src["fsdp_all_gather"]["bytes"] >= split,
          f"14: FSDP2 moved {src['fsdp_all_gather']['bytes']} B gathered, "
          f"{src['fsdp_reduce_scatter']['bytes']} B reduce-scattered for "
          f"{split} B of split parameters")
    launches = counts(**res["launches"])
    for name in ("attention", "attention_bwd"):
        check(launches[name] > 0, f"14: the ranks never launched {name}: "
              f"{res['launches']}")
    # the same two steps on one card over the whole global batch
    args = report.parse_args([*MULTICHIP_ARGS])
    data = report.synthetic_batch(TRAIN_BATCH, HW, args.num_classes)
    batch = {k: torch.from_numpy(v).cuda() for k, v in data.items()}
    runs = {}
    for precision in ("float32", "bfloat16"):
        model, state, loss_fn = report.build_step(args, "cuda", False,
                                                  precision)
        step = make_train_step(model, loss_fn, state.optimizer)
        runs[precision] = []
        for _ in range(2):
            state, m = step(state, batch)
            runs[precision].append({k: float(v) for k, v in m.items()})
        del model, state, step
        torch.cuda.empty_cache()

    def errors(got):
        """Each step's relative error of total_loss and grad_norm against
        the one-card fp32 run."""
        return [{key: abs(g[key] - w[key]) / abs(w[key])
                 for key in ("total_loss", "grad_norm")}
                for g, w in zip(got, runs["float32"])]

    # step by step: after the first AdamW update, bf16 and fp32 part
    # (near-zero gradients change sign, each a ±lr step)
    own = errors(runs["bfloat16"])
    limits = [{k: DIST_BF16_FACTOR * max(v, DIST_BF16_FLOOR)
               for k, v in step_errs.items()} for step_errs in own]
    errs = errors(res["metrics"])
    check(all(e[k] <= lim[k] for e, lim in zip(errs, limits) for k in lim),
          f"14: the report's steps {res['metrics']} against one card "
          f"{runs['float32']}: errors {errs} above {limits}")
    numbers = {"seconds": seconds, "phase_s": time.perf_counter() - t0,
               "errors": errs, "own_bf16_errors": own, "limits": limits,
               "metrics": res["metrics"], "one_card": runs,
               "collectives": {k: [v["count"], v["bytes"]]
                               for k, v in src.items() if v["count"]},
               "split_param_bytes": split, "flops": res["flops"],
               "counted_ms": res["counted_ms"], "backend": res["backend"]}
    log(f"phase 14 torch_multichip_report.py {' '.join(MULTICHIP_ARGS)} "
        f"(started before phase 12, its ranks beside phase 12's processes): "
        f"{json.dumps(numbers)} | {card}")
    return launches, numbers


# ------------------------------------------------------ the quality phase
# phase 12: the thresholds at which the sweep's rows are held to the
# evaluate CLI: the gate's 0.25, and 0.001, where a one-epoch model has
# detections and the top 100 of 8,400 anchors binds
QUALITY_THRESHOLDS = (0.001, 0.25)


def quality_phase(root: str) -> tuple:
    """Phase 12: ``torch_sweep_eval.py`` and ``torch_rank_diag.py`` as
    child processes on the card, on phase 9's fixture and its
    ``model_epoch_0`` (x/640² bf16, EMA); each of the sweep's rows at
    ``QUALITY_THRESHOLDS`` equal to ``torch_evaluate.py --conf_threshold t
    --coco_map --model_coords`` (the sweep scores in model-input pixels);
    the diagnostic's oracle mAP at least its as-is mAP. Returns (launch
    counts of the child processes, numbers)."""
    launches = counts()
    cfg_path = os.path.join(root, "x.yaml")
    ckpt = os.path.join(root, "ckpt")
    numbers = {}
    sweep_json = os.path.join(root, "sweep.json")
    out, numbers["sweep_s"] = run_cli("torch_sweep_eval.py", [
        "--config", cfg_path, "--checkpoint", ckpt, "--epochs", "all",
        "--thresholds", ",".join(map(str, QUALITY_THRESHOLDS)), "--out",
        sweep_json], launches)
    with open(sweep_json) as f:
        sweep = json.load(f)
    check(list(sweep) == ["0"], f"sweep epochs {list(sweep)}: {out[-2000:]}")
    numbers["evaluate_s"] = {}
    for thr in QUALITY_THRESHOLDS:
        out, numbers["evaluate_s"][thr] = run_cli("torch_evaluate.py", [
            "--config", cfg_path, "--checkpoint",
            os.path.join(ckpt, "model_epoch_0"), "--conf_threshold", thr,
            "--coco_map", "--model_coords", "--device", "cuda"], launches)
        want = printed_results(out)
        row = sweep["0"][f"{thr:g}"]
        for part in ("metrics", "coco"):
            for key, value in want[part].items():
                check(row[key] == value, f"phase 12 sweep at {thr} {key}: "
                      f"{row[key]} vs the evaluate CLI's {value}")
    low = sweep["0"][f"{QUALITY_THRESHOLDS[0]:g}"]
    check(low["total_predictions"] > 0,
          f"phase 12: no detection above {QUALITY_THRESHOLDS[0]}: {low}")
    out, numbers["rank_diag_s"] = run_cli("torch_rank_diag.py", [
        "--config", cfg_path, "--checkpoint", ckpt, "--epoch", 0],
        launches)
    diag = printed_results(out)
    check(diag["preds"] > 0 and diag["images"] > 0
          and np.isfinite(diag["mean_best_iou"])
          and diag["oracle"]["mAP_50_95"] >= diag["as_is"]["mAP_50_95"],
          f"phase 12 rank_diag: {diag}")
    numbers.update(sweep_rows=sweep["0"], rank_diag=diag)
    log(f"phase 12 torch_sweep_eval.py on model_epoch_0 (x/640² bf16, "
        f"EMA), rows at {list(QUALITY_THRESHOLDS)} equal to "
        f"torch_evaluate.py --model_coords at each; torch_rank_diag.py: "
        f"{json.dumps(numbers)}")
    log(f"phase 12 process s: sweep {numbers['sweep_s']}, evaluate "
        f"{numbers['evaluate_s']}, rank_diag {numbers['rank_diag_s']} | "
        f"{card_line()}")
    return launches, numbers


# ------------------------------------------------------ the distributed phase
# phase 10a: the DDP and FSDP2 train steps against one card on the same
# global batch: x/640² bf16 (8 images a rank, 4 where two ranks share a
# card) and the small model in fp32, DIST_STEPS SGD steps each (lr
# DIST_LR, clipped to global norm 1, EMA on; TAL, so that score_sum
# crosses the ranks); then, for x only, DIST_TIMED timed steps and one
# profiled one
DIST_STEPS = 3
DIST_TIMED = 3
DIST_LR = 1e-3
DIST_FSDP_MIN = 1024
# limits, against the one-card run: each step's total_loss and grad_norm
# (relative errors) and the change of the parameters and BatchNorm
# statistics over the DIST_STEPS steps as one vector (its error's norm
# over its norm). fp32 (TF32 off), against the one-card fp32 run: the
# loss limit of tests/test_sharding.py (1e-5); the norm's of
# tests/test_torch_train.py (5e-3: the gradient's norm is the most
# sensitive number of a step, 5.5e-5 to 1.45e-4 measured on an H100);
# 1e-4 for the change, where a gradient that the ranks did not
# synchronise misses by tens of percent. bf16: the ranks convolve batches
# of another size, for
# which cuDNN picks other kernels, BatchNorm sums in another order, and a
# rounding may move one of TAL's top-k picks, so the one-card bf16 run is
# no tighter a reference; both bf16 runs are held to the one-card fp32
# run, and the ranks' error may be DIST_BF16_FACTOR times the one-card
# bf16 run's own (at least DIST_BF16_FLOOR).
DIST_TOL = {"total_loss": 1e-5, "grad_norm": 5e-3, "change": 1e-4}
DIST_BF16_FACTOR = 3.0
DIST_BF16_FLOOR = 1e-3
# 10b: torch_train.py's batch per device; 10c: sharded serve's timed calls
DIST_CLI_BATCH = 4
GLOO_PROBE = ("all_reduce", "broadcast", "all_gather_into_tensor",
              "reduce_scatter_tensor", "all_gather", "reduce_scatter")


def dist_cases(preset: dict, shared: bool) -> list:
    """Phase 10a's cases: (name, widths, precision, hw, classes, images a
    rank)."""
    widths = {k: preset[k] for k in ("width", "depth", "csp")}
    small = {k: SMALL[k] for k in ("width", "depth", "csp")}
    return [("small_fp32", small, "float32", SMALL["hw"],
             SMALL["num_classes"], SMALL["batch"]),
            ("x_bf16", widths, "bfloat16", HW, NUM_CLASSES,
             TRAIN_BATCH // 2 if shared else TRAIN_BATCH)]


def dist_engine(case: tuple, device, global_batch: bool):
    """Model, state, step and batch of a 10a case: the port's training
    entry points with plain SGD (clip threshold 1, EMA on) and the TAL
    loss; the whole global batch, on the host."""
    _, widths, precision, hw, nc, _ = case
    model = create_train_model(widths["width"], widths["depth"],
                               widths["csp"], nc, precision=precision,
                               device=device, seed=SEED + 60)
    optimizer = torch.optim.SGD(model.parameters(), lr=DIST_LR)
    optimizer.grad_clip = 1.0
    state = TrainState.create(model, optimizer,
                              torch.Generator().manual_seed(SEED), ema=True)
    loss_fn = DetectionLoss(LossConfig(num_classes=nc, assigner="tal"),
                            global_batch=global_batch)
    return model, state, loss_fn


def dist_worker(job: str, args_path: str, rank: int, world: int,
                addr: str) -> None:
    """One rank of phase 10 (``chip_smoke.py --dist-worker``): ``probe``
    tries each collective that DDP and FSDP2 call on CUDA tensors under
    ``args["backend"]``; ``step`` runs a 10a case's steps under dp or
    fsdp. Writes its results to ``args["out"].{rank}.pt``."""
    import faulthandler

    from custom_yolo_tpu_torch.core.mesh import (MeshSpec, create_mesh,
                                                 initialize_distributed)
    from custom_yolo_tpu_torch.parallel.sharding import (shard_batch,
                                                         shard_train_state)

    # a crash in a collective's thread prints every thread's stack
    faulthandler.enable()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    with open(args_path) as f:
        args = json.load(f)
    dev = initialize_distributed(addr, world, rank, device="cuda",
                                 backend=args["backend"])
    if world == 1:
        # a group of one, which initialize_distributed does not make
        torch.distributed.init_process_group(
            args["backend"], init_method=f"tcp://{addr}", world_size=1,
            rank=0)
    result = {"device": str(dev)}
    if job == "probe":
        import torch.distributed as dist
        t = torch.full((8,), float(rank + 1), device=dev)
        ops = {
            "all_reduce": lambda: dist.all_reduce(t.clone()),
            "broadcast": lambda: dist.broadcast(t.clone(), 0),
            "all_gather_into_tensor": lambda: dist.all_gather_into_tensor(
                torch.empty(8 * world, device=dev), t),
            "reduce_scatter_tensor": lambda: dist.reduce_scatter_tensor(
                torch.empty(8 // world, device=dev), t),
            "all_gather": lambda: dist.all_gather(
                [torch.empty(8, device=dev) for _ in range(world)], t),
            "reduce_scatter": lambda: dist.reduce_scatter(
                torch.empty(8 // world, device=dev), list(t.chunk(world)))}
        for name in GLOO_PROBE:
            try:
                ops[name]()
                torch.cuda.synchronize(dev)
                result[name] = "ok"
            except Exception as e:     # the probe's answer, not a failure
                result[name] = f"{type(e).__name__}: {str(e)[:200]}"
    else:
        case = tuple(args["case"])
        model, state, loss_fn = dist_engine(case, dev, global_batch=True)
        mesh = create_mesh(MeshSpec.for_mode(args["mode"]),
                           device_type=dev.type)
        state = shard_train_state(state, mesh,
                                  min_weight_size=DIST_FSDP_MIN)
        step = make_train_step(state.module, loss_fn, state.optimizer,
                               ema_decay=0.999)
        n = case[5]
        batch = shard_batch({k: v[rank * n:(rank + 1) * n] for k, v in
                             torch.load(args["batch"]).items()}, dev)
        reset_counts()
        torch.cuda.reset_peak_memory_stats(dev)
        metrics = []
        for _ in range(DIST_STEPS):
            state, m = step(state, batch)
            metrics.append({k: float(v) for k, v in m.items()})
        result["metrics"] = metrics
        result["model"] = host_copy(state.state_dict()["model"])
        result["sharded"] = sum(
            type(p).__name__ == "DTensor" for p in model.parameters())
        result["launches"] = read_counts()
        times = []
        for _ in range(DIST_TIMED if args["timed"] else 0):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            state, _ = step(state, batch)
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end))
        result["peak_bytes"] = torch.cuda.max_memory_allocated(dev)
        if times:
            result["step_ms"] = statistics.median(times)
            result["comm"] = comm_share(lambda: step(state, batch), reps=1)
            result["launches"] = read_counts()
    torch.save(result, f"{args['out']}.{rank}.pt")
    torch.distributed.destroy_process_group()


def comm_share(fn, reps: int) -> dict:
    """What ``reps`` calls of ``fn`` spend in collectives, from a profiler
    trace: the device time of NCCL kernels, of host-device copies (gloo
    stages CUDA tensors through the host) and of all kernels, and on the
    host the union of the spans of collective ops (names with ``nccl``,
    ``gloo`` or ``c10d``), against the window."""
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
    nccl = copies = busy = 0.0
    host, by_name = [], {}
    for e in events:
        if "dur" not in e:
            continue
        name, dur = e.get("name", ""), float(e["dur"]) / 1e3
        if e.get("cat") == "kernel":
            busy += dur
            nccl += dur if "nccl" in name.lower() else 0.0
        elif e.get("cat") == "gpu_memcpy":
            copies += dur
        elif e.get("cat") == "cpu_op" and any(
                k in name.lower() for k in ("nccl", "gloo", "c10d")):
            host.append((float(e["ts"]), float(e["ts"]) + float(e["dur"])))
            total, n = by_name.get(name, (0.0, 0))
            by_name[name] = (total + dur, n + 1)
    host_ms, end = 0.0, -1.0
    for lo, hi in sorted(host):
        if hi > end:
            host_ms += (hi - max(lo, end)) / 1e3
            end = hi
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:5]
    return {"calls": reps, "window_ms": window_ms,
            "kernel_ms": busy, "nccl_kernel_ms": nccl,
            "memcpy_ms": copies, "host_collective_ms": host_ms,
            "nccl_share_of_window": nccl / window_ms,
            "host_collective_share_of_window": host_ms / window_ms,
            "kernel_share_of_window": busy / window_ms,
            "host_collective_ops": [[k[:60], ms, n] for k, (ms, n) in top]}


def spawn_ranks(job: str, args: dict, world: int, root: str,
                timeout: int = 600) -> list:
    """``world`` ranks of ``dist_worker`` as child processes on a free
    port of this host; a rank's non-zero exit fails the run. Returns each
    rank's results."""
    import socket

    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    args = dict(args, out=os.path.join(root, f"{job}_{len(os.listdir(root))}"))
    path = args["out"] + ".json"
    with open(path, "w") as f:
        json.dump(args, f)
    procs = [subprocess.Popen(
        [sys.executable, os.path.join(REPO, "chip_smoke.py"),
         "--dist-worker", job, path, str(rank), str(world),
         f"localhost:{port}"], cwd=REPO, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for rank in range(world)]
    try:
        outs = [p.communicate(timeout=timeout)[0] for p in procs]
    finally:
        for p in procs:
            p.kill()
    for rank, (p, out) in enumerate(zip(procs, outs)):
        check(p.returncode == 0, f"phase 10 {job} rank {rank} exited with "
              f"{p.returncode}:\n{out[-6000:]}")
    return [torch.load(f"{args['out']}.{rank}.pt", weights_only=False)
            for rank in range(world)]


def one_card(case: tuple, batch: dict) -> tuple:
    """A 10a case's DIST_STEPS steps on one card over the whole global
    batch: (the state dict before, each step's metrics, the state dict
    after), on the host."""
    model, state, loss_fn = dist_engine(case, "cuda", global_batch=False)
    before = host_copy(model.state_dict())
    step = make_train_step(model, loss_fn, state.optimizer, ema_decay=0.999)
    cuda_batch = {k: v.cuda() for k, v in batch.items()}
    metrics = []
    for _ in range(DIST_STEPS):
        state, m = step(state, cuda_batch)
        metrics.append({k: float(v) for k, v in m.items()})
    after = host_copy(model.state_dict())
    del model, state, step, cuda_batch
    torch.cuda.empty_cache()
    return before, metrics, after


def step_errors(ref: tuple, got: tuple) -> dict:
    """The largest relative error of a run's total_loss and grad_norm over
    its steps, and of its change of the state (:func:`change_error`),
    against ``ref`` (:func:`one_card`'s result); ``got`` is (metrics,
    state dict after)."""
    before, ref_metrics, ref_after = ref
    metrics, after = got[-2], got[-1]
    errs = {key: max(abs(g[key] - w[key]) / abs(w[key])
                     for g, w in zip(metrics, ref_metrics))
            for key in ("total_loss", "grad_norm")}
    errs["change"] = change_error(before, ref_after, after)
    return errs


def change_error(before: dict, ref: dict, got: dict) -> float:
    """‖(got − before) − (ref − before)‖ / ‖ref − before‖ over every float
    tensor of the state dicts: the parameters' and statistics' change."""
    num = den = 0.0
    for key, b in before.items():
        if not b.is_floating_point():
            continue
        d_ref = ref[key].double() - b.double()
        num += float(((got[key].double() - b.double()) - d_ref).square()
                     .sum())
        den += float(d_ref.square().sum())
    return (num / den) ** 0.5


def torchrun_train(cfg_path: str, modes, world: int, work: str,
                   backend: str, sink: dict) -> dict:
    """Phase 10b: ``torchrun --nproc_per_node world scripts/torch_train.py
    --mode mode`` for one epoch at DIST_CLI_BATCH images a device, one
    job for each of ``modes``, all at once (each its own port and
    ``work/ck_<mode>``); the ranks' launch counts go to ``sink``. Returns
    {mode: (rank 0's last epoch record, seconds)}."""
    import contextlib
    import socket

    with contextlib.ExitStack() as stack:
        # every port held until all are chosen, so that no two jobs share one
        socks = [stack.enter_context(socket.socket()) for _ in modes]
        for sock in socks:
            sock.bind(("localhost", 0))
        ports = [sock.getsockname()[1] for sock in socks]
    jobs = {}
    for mode, port in zip(modes, ports):
        cmd = [sys.executable, "-m", "torch.distributed.run",
               "--nproc_per_node", str(world), "--master_port", str(port),
               os.path.join(REPO, "scripts", "torch_train.py"), "--config",
               cfg_path, "--device", "cuda", "--mode", mode, "--epochs",
               "1", "--checkpoint_dir", os.path.join(work, f"ck_{mode}"),
               "--batch_size", str(DIST_CLI_BATCH), "--backend", backend]
        # into files: a pipe that fills while another job is waited on
        # would stall its job
        logs = [open(os.path.join(work, f"{mode}.{k}"), "w+")
                for k in ("out", "err")]
        jobs[mode] = (cmd, time.perf_counter(), logs, subprocess.Popen(
            cmd, stdout=logs[0], stderr=logs[1], text=True, cwd=REPO))
    results = {}
    try:
        for mode, (cmd, t0, logs, proc) in jobs.items():
            proc.wait(timeout=900)
            seconds = time.perf_counter() - t0
            for f in logs:
                f.seek(0)
            stdout, stderr = (f.read() for f in logs)
            check(proc.returncode == 0, f"{' '.join(cmd)} exited with "
                  f"{proc.returncode}:\n{stdout[-3000:]}\n{stderr[-6000:]}")
            lines = stdout.splitlines()
            launch_lines = [line[len(LAUNCH_LINE):] for line in lines
                            if line.startswith(LAUNCH_LINE)]
            check(len(launch_lines) == world, f"10b {mode}: "
                  f"{len(launch_lines)} launch lines from {world} ranks")
            for line in launch_lines:
                for name, n in json.loads(line).items():
                    sink[name] += n
            history = [json.loads(line.split(": ", 1)[1]) for line in lines
                       if line.startswith("[INFO] history: ")]
            check(len(history) == 1, f"10b {mode}: no history line")
            results[mode] = history[0], seconds
    finally:
        for _, _, logs, proc in jobs.values():
            proc.kill()
            for f in logs:
                f.close()
    return results


def distributed_phase(env: dict, preset: dict, root: str,
                      single: dict) -> tuple:
    """Phase 10, distributed training and sharded serving. With two or more
    cards the ranks are one a card under NCCL; with one, 10a first asks
    gloo whether it takes CUDA tensors for every collective DDP and FSDP2
    call, and then runs two gloo ranks on ``cuda:0`` (or, if not, a world
    of one NCCL rank). 10a: DDP and FSDP2 steps as child processes against
    the one-card step on the same global batch; 10b: ``torchrun
    scripts/torch_train.py`` dp and fsdp at once, one epoch each, on
    phase 9's fixture (``root/x.yaml``), the validation counters against a
    single-process run over the same global batches, the fsdp checkpoint
    restored into ``single`` bit for bit (``single`` is phase 9b's record,
    an epoch of one process over those global batches); 10c:
    ``make_sharded_serve_fn``
    over the cards at x/640² B=8, fused and static int8, against
    ``Detector.serve``. Returns (the launch counts of the distributed
    path, numbers)."""
    from custom_yolo_tpu_torch.parallel.serve import make_sharded_serve_fn

    card = card_line()
    cards = torch.cuda.device_count()
    launches = counts()
    numbers = {}
    work = os.path.join(root, "dist")
    os.makedirs(work, exist_ok=True)
    # ------------------------------------------------ 10a. one step each
    if cards >= 2:
        world, backend, shared = 2, "nccl", False
        how = "two ranks under NCCL, one card each"
    else:
        probe = spawn_ranks("probe", {"backend": "gloo"}, 2, work)
        bad = {k: v for r in probe for k, v in r.items()
               if k in GLOO_PROBE and v != "ok"}
        if bad:
            world, backend, shared = 1, "nccl", False
            how = f"a world of one NCCL rank (gloo refused {bad})"
        else:
            world, backend, shared = 2, "gloo", True
            how = ("two gloo ranks on cuda:0 (gloo took CUDA tensors for "
                   f"{', '.join(GLOO_PROBE)})")
    log(f"phase 10a ranks: {how} | {card}")
    steps = {}
    for case in dist_cases(preset, shared):
        name, _, precision, hw, nc, per_rank = case
        n = per_rank * world
        batch = train_batch(n, hw, TRAIN_MAX_BOXES if hw == HW
                            else SMALL["boxes"], nc, SEED + 61, "cpu")
        torch.save(batch, os.path.join(work, f"{name}_batch.pt"))
        # the one-card runs over the whole global batch: fp32 (the
        # reference) and, for bf16, bf16 (its own error)
        truth = one_card(case[:2] + ("float32",) + case[3:], batch)
        floor = None
        if precision != "float32":
            own = one_card(case, batch)
            floor = step_errors(truth, own)
            limits = {k: DIST_BF16_FACTOR * max(v, DIST_BF16_FLOOR)
                      for k, v in floor.items()}
        else:
            limits = DIST_TOL
        for mode in ("dp", "fsdp"):
            ranks = spawn_ranks("step", {
                "case": list(case), "mode": mode, "backend": backend,
                "batch": os.path.join(work, f"{name}_batch.pt"),
                "timed": precision != "float32"}, world, work)
            for r in ranks:
                for table_name, count in r["launches"].items():
                    launches[table_name] += count
            errs = step_errors(truth, (ranks[0]["metrics"],
                                       ranks[0]["model"]))
            same = all(torch.equal(ranks[0]["model"][k], r["model"][k])
                       for r in ranks[1:] for k in truth[2])
            log(f"phase 10a {name} {mode}: errors against one card in fp32 "
                f"{errs}, the one-card {precision} run's own {floor}, "
                f"limits {limits}, ranks agree {same}")
            check(all(errs[k] <= limits[k] for k in limits) and same,
                  f"10a {name} {mode}: errors {errs} above {limits} (or the "
                  f"ranks disagree: {not same})")
            check((ranks[0]["sharded"] > 0) == (mode == "fsdp" and
                                                world > 1),
                  f"10a {name} {mode}: {ranks[0]['sharded']} parameters "
                  f"sharded")
            steps[name, mode] = {
                "ranks": world, "images_a_rank": per_rank,
                "peak_bytes_per_rank": [r["peak_bytes"] for r in ranks],
                "sharded_params": ranks[0]["sharded"],
                "errors": errs, "own_bf16_errors": floor}
            if "step_ms" in ranks[0]:
                step_ms = [r["step_ms"] for r in ranks]
                steps[name, mode].update(
                    step_ms_per_rank=step_ms,
                    img_per_s_all_ranks=n / max(step_ms) * 1e3,
                    comm_rank0=ranks[0]["comm"])
            log(f"phase 10a {name} {mode}, {how}, {n} images ({per_rank} a "
                f"rank), {DIST_STEPS} SGD steps, held to one card on the "
                f"same batch: {json.dumps(steps[name, mode])} | {card}")
    numbers["steps"] = {f"{k[0]}/{k[1]}": v for k, v in steps.items()}

    # ------------------------------------------------------ 10b. the CLI
    cfg_path = os.path.join(root, "x.yaml")
    records, cli_s = {"single": single}, {}
    jobs = torchrun_train(cfg_path, ("dp", "fsdp"), world, work, backend,
                          launches)
    for mode, (record, seconds) in jobs.items():
        records[mode], cli_s[mode] = record, seconds
    counters = ("val/true_positives", "val/false_positives",
                "val/false_negatives", "val/total_ground_truths",
                "val/total_predictions")
    for mode in ("dp", "fsdp"):
        check(all(records[mode][k] == records["single"][k]
                  for k in counters),
              f"10b {mode}: counters "
              f"{[records[mode][k] for k in counters]} against single's "
              f"{[records['single'][k] for k in counters]}")
    # the fsdp checkpoint into a single-card trainer
    cfg = Config.from_yaml(cfg_path)
    trainer = Trainer(cfg, create_train_model(
        preset["width"], preset["depth"], preset["csp"], NUM_CLASSES,
        device="cuda", seed=SEED + 62))
    CheckpointManager(os.path.join(work, "ck_fsdp")).restore(trainer.state)
    written = torch.load(os.path.join(work, "ck_fsdp", "model_epoch_0",
                                      "state.pt"), weights_only=True)
    restored = trainer.state.state_dict()
    same = all(torch.equal(restored[part][k].cpu(), v)
               for part in ("model", "ema")
               for k, v in written[part].items())
    same &= all(torch.equal(restored["optimizer"]["state"][i][k].cpu(), v)
                for i, moments in written["optimizer"]["state"].items()
                for k, v in moments.items())
    check(same and trainer.state.epoch == written["epoch"] == 1,
          "10b: the fsdp checkpoint did not restore into single bit for "
          "bit")
    del trainer, restored, written
    torch.cuda.empty_cache()
    numbers["cli"] = {"seconds": cli_s, "records": records}
    log(f"phase 10b torchrun --nproc_per_node {world} torch_train.py "
        f"--backend {backend}, x/640² bf16, {DIST_CLI_BATCH} images a "
        f"device, one epoch, the two jobs at once: dp {cli_s['dp']} s, "
        f"fsdp {cli_s['fsdp']} s; "
        f"validation counters equal to phase 9b's single process over the "
        f"same global batches "
        f"({[records['single'][k] for k in counters]}); val loss dp "
        f"{records['dp']['val/total_loss']} fsdp "
        f"{records['fsdp']['val/total_loss']} single "
        f"{records['single']['val/total_loss']}; the fsdp checkpoint "
        f"restores into single bit for bit | {card}")

    # ---------------------------------------------- 10c. sharded serving
    devices = ([f"cuda:{i}" for i in range(cards)] if cards >= 2
               else ["cuda:0", "cuda:0"])
    images = torch.from_numpy(np.random.RandomState(SEED + 63).randint(
        0, 256, (SERVE_BATCH, HW, HW, 3), dtype=np.uint8))
    det = Detector(preset["width"], preset["depth"], preset["csp"],
                   NUM_CLASSES, input_size=(HW, HW))
    det.init(SEED)
    det.fuse()
    serve_kw = dict(conf_thres=POOL_CONF, device_preprocess=True)
    served = {}
    for variant in ("fused", "int8_static"):
        if variant == "int8_static":
            det.quantize().calibrate([normalize(images.cuda())])
        fn = make_sharded_serve_fn(det, devices, **serve_kw)
        reset_counts()
        out = fn(images)
        ms = time_ms(lambda: fn(images), reps=10, warmup=2)
        torch.cuda.synchronize()
        for name, n in read_counts().items():
            launches[name] += n
        whole = det.serve(images, **serve_kw)
        v = whole.valid.cpu()
        exact = all(torch.equal(a.cpu(), b.cpu())
                    for a, b in zip(out[2:], whole[2:]))
        check(exact and int(v.sum()) > 0 and torch.allclose(
            out.boxes.cpu()[v], whole.boxes.cpu()[v], rtol=1e-5, atol=1e-4)
            and torch.allclose(out.scores.cpu()[v], whole.scores.cpu()[v],
                               rtol=1e-5, atol=1e-6),
              f"10c {variant}: the sharded serve differs from "
              f"Detector.serve (num_valid {out.num_valid.tolist()} vs "
              f"{whole.num_valid.tolist()})")
        served[variant] = {"ms": ms, "img_per_s": SERVE_BATCH / ms * 1e3,
                           "serve_ms": time_ms(lambda: det.serve(
                               images, **serve_kw), reps=10, warmup=2)}
    numbers["serve"] = served
    log(f"phase 10c make_sharded_serve_fn over {devices}, x/640² B="
        f"{SERVE_BATCH} (uint8, device_preprocess): fused bf16 and static "
        f"int8 equal to Detector.serve (num_valid, valid, classes exact; "
        f"boxes and scores within tests/test_sharding.py's tolerances); "
        f"{json.dumps(served)} | {card}")
    del det
    torch.cuda.empty_cache()
    return launches, numbers


EXPORT_BATCHES = (SERVE_BATCH, 1)
# the x preset's 10 kernel launches of one serve, by table name, at each
# batch: K1 twice, K5 once, the keep mask of a batch or of one image
EXPORT_SERVE = {SERVE_BATCH: dict(attention=2, sppf=1, nms_batched=1),
                1: dict(attention=2, sppf=1, nms_single=1)}


def same_result(got, want) -> tuple:
    """(bit-equal, the first field that differs and its largest gap, or
    None; classes and valid equal and boxes within 1e-3 px)."""
    for name in got._fields:
        a, b = getattr(got, name), getattr(want, name)
        if not torch.equal(a, b):
            gap = (a.double() - b.double()).abs().max().item()
            near = (torch.equal(got.classes, want.classes)
                    and torch.equal(got.valid, want.valid)
                    and (got.boxes - want.boxes).abs().max().item() <= 1e-3)
            return False, (name, gap), near
    return True, None, True


def export_phase(preset: dict, root: str, detectors: dict,
                 norm_batch: torch.Tensor) -> tuple:
    """Phase 11: the serving artifacts of ``export.py`` on the card and the
    reference-checkpoint importer. 11a the fused x detector exported at
    B=8 and B=1, each loaded in a fresh ``ExportedServer`` and called on
    phase 7's batch: bit-equal to ``serve``, its launches counted; 11b
    ``optimize_for_serving`` with the fused cls tower; 11c static int8;
    11d export seconds, artifact MB, events ms and a profile (device busy
    ms, idle share, kernels a call) beside ``serve``'s; 11e
    ``to_torch_state_dict`` of the seeded x model as a reference checkpoint
    (``module.`` keys in ``{"model_state": …}``) through
    ``scripts/torch_import_torch.py --fuse`` as a child process, then
    ``load_weights`` serves bit-equal to the fused detector. Returns the
    artifact calls' launch table and the numbers."""
    launches, numbers = counts(), {}
    cases = [("fused", detectors["fused"], False, EXPORT_BATCHES),
             ("optimized_cls_tower", detectors["optimized"], True,
              (SERVE_BATCH,)),
             ("static_int8", detectors["int8"], False, (SERVE_BATCH,))]
    for name, det, tower, batches in cases:
        det.model.head.fused_cls_tower = tower
        for b in batches:
            images = norm_batch[:b].contiguous()
            path = os.path.join(root, f"export_{name}_b{b}")
            t0 = time.perf_counter()
            export_serving(det, path, batch_size=b, conf_thres=POOL_CONF)
            export_s = time.perf_counter() - t0
            server = load_exported(path)
            want = det.serve(images, conf_thres=POOL_CONF)
            torch.cuda.synchronize()
            reset_counts()
            got = server(images)
            torch.cuda.synchronize()
            call = read_counts()
            want_call = counts(**EXPORT_SERVE[b],
                               cls_tower=6 if tower else 0)
            check(call == want_call, f"11 {name} B={b}: one artifact call "
                  f"launched {call}, want {want_call}")
            for k in call:
                launches[k] += call[k]
            equal, first, near = same_result(got, want)
            if not equal:
                log(f"phase 11 {name} B={b}: artifact differs from serve, "
                    f"first at {first[0]} by {first[1]}; classes and valid "
                    f"equal, boxes within 1e-3 px: {near}")
            check(near, f"11 {name} B={b}: the artifact differs from serve "
                  f"beyond the limit ({first})")
            check(int(want.num_valid.min()) > 0, f"11 {name} B={b}: an "
                  "image has no detection")
            row = {"export_s": export_s,
                   "artifact_mb": os.path.getsize(os.path.join(
                       path, "serving.pt2")) / 2 ** 20,
                   "weights_moved_at_load": server.weights_moved,
                   "bit_equal": equal, "first_difference": first,
                   "launches": {k: v for k, v in call.items() if v},
                   "artifact_ms": time_ms(lambda: server(images)),
                   "serve_ms": time_ms(lambda: det.serve(
                       images, conf_thres=POOL_CONF)),
                   "graph_ops": sum(node.op == "call_function" for node
                                    in server.program.graph.nodes)}
            for label, fn in (("artifact", lambda: server(images)),
                              ("serve", lambda: det.serve(
                                  images, conf_thres=POOL_CONF))):
                prof = profile_call(fn)
                row[f"{label}_profile"] = {
                    k: prof[k] for k in ("device_busy_ms", "window_ms",
                                         "idle_share", "kernels_per_call")}
            numbers[f"{name}_b{b}"] = row
            log(f"phase 11 {name} B={b}: {json.dumps(row)}")
            shutil.rmtree(path)
            del server
    detectors["optimized"].model.head.fused_cls_tower = False

    # ------------------------------------------------- 11e. the importer
    unfused = Detector(preset["width"], preset["depth"], preset["csp"],
                       NUM_CLASSES, input_size=(HW, HW))
    unfused.init(SEED)
    ref = {f"module.{k}": v for k, v in
           to_torch_state_dict(unfused.model.state_dict()).items()}
    del unfused
    ckpt = os.path.join(root, "reference.pt")
    torch.save({"model_state": ref, "epoch": 0}, ckpt)
    out = os.path.join(root, "imported")
    _, import_s = run_cli("torch_import_torch.py", [
        "--torch_checkpoint", ckpt, "--output", out, "--preset", "x",
        "--num_classes", NUM_CLASSES, "--fuse"])
    new = Detector(preset["width"], preset["depth"], preset["csp"],
                   NUM_CLASSES, input_size=(HW, HW)).load_weights(out)
    want = detectors["fused"].serve(norm_batch, conf_thres=POOL_CONF)
    got = new.serve(norm_batch, conf_thres=POOL_CONF)
    check(all(torch.equal(a, b) for a, b in zip(got, want)),
          "11e the imported reference checkpoint serves another result "
          "than the fused detector")
    numbers["import"] = {"reference_keys": len(ref), "import_s": import_s}
    log(f"phase 11e torch_import_torch.py --preset x --fuse on a "
        f"{len(ref)}-key reference checkpoint: {import_s:.2f} s; the "
        f"loaded directory serves bit-equal to the fused detector")
    del new
    return launches, numbers


# ---------------------------------------------------------------------------
# phase 15: serve's CUDA graphs (models/serve_graph.py) against the eager
# path. The card tests run in a child pytest without tests/conftest.py,
# which imports JAX; a call's timings, four rounds in turns.
GRAPH_TESTS = "tests/test_torch_serve_graph.py"
GRAPH_ROUNDS = 4
SERVE_SPANS = ("serve/input", "serve/forward", "serve/decode", "serve/nms")
# batches of the closed loop a round, two in flight as in the benchmark
GRAPH_LOOP = 60


def closed_loop_ms(fn, n: int = GRAPH_LOOP, inflight: int = 2) -> float:
    """Host ms a batch of ``n`` calls of ``fn`` in a closed loop: each
    result fetched to the host once ``inflight`` newer ones are
    dispatched, as ``perfbench/traffic/serve.py`` drives ``serve``."""
    fn().num_valid.cpu()
    queue = []
    t0 = time.perf_counter()
    for _ in range(n):
        queue.append(fn())
        if len(queue) > inflight:
            queue.pop(0).num_valid.cpu()
    for res in queue:
        res.num_valid.cpu()
    return (time.perf_counter() - t0) * 1e3 / n


def serve_graph_phase() -> tuple:
    """Phase 15: the card tests of ``GRAPH_TESTS``, then x/640² B=8
    (fused, pinned uint8, ``device_preprocess``) eager against graph, the
    device ms of each serve phase eager against replayed, and
    ``make_sharded_serve_fn`` with the card listed twice (its two slices
    replayed one after the other) against one graph call. Returns the
    launches the phase counted in this process and its numbers."""
    from custom_yolo_tpu_torch.parallel.serve import make_sharded_serve_fn

    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "pytest", "--noconftest", "-q", "-p",
         "no:cacheprovider", "-W", "ignore::pytest.PytestUnknownMarkWarning",
         "-m", "card", os.path.join(REPO, GRAPH_TESTS)],
        capture_output=True, text=True, cwd=REPO)
    tail = (proc.stdout + proc.stderr)[-4000:]
    log(f"phase 15a pytest -m card {GRAPH_TESTS} "
        f"({time.perf_counter() - t0:.1f} s), exit {proc.returncode}:\n"
        f"{tail}")
    passed = re.search(r"(\d+) passed", proc.stdout)
    check(proc.returncode == 0 and passed is not None
          and "skipped" not in proc.stdout,
          "phase 15a: the card tests of serve's CUDA graphs failed or "
          "skipped")

    launches_before, stats_before = kernel_launches(), serve_graph_stats()
    p = PRESETS["x"]
    det = Detector(p["width"], p["depth"], p["csp"], NUM_CLASSES,
                   precision="bfloat16", input_size=(HW, HW), device="cuda")
    det.init(SEED)
    det.fuse()
    gen = torch.Generator().manual_seed(SEED + 15)
    batch = torch.randint(0, 256, (SERVE_BATCH, HW, HW, 3), generator=gen,
                          dtype=torch.uint8).pin_memory()
    opts = dict(conf_thres=POOL_CONF, iou_thres=0.45, max_det=300,
                top_k=1024, merge=False, class_filter=None,
                multi_label=False)

    made = {"eager": 0, "graph": 0, "sharded": 0}
    shard_fn = make_sharded_serve_fn(det, ["cuda:0", "cuda:0"],
                                     device_preprocess=True, **opts)

    @torch.inference_mode()
    def eager():
        made["eager"] += 1
        return serve_pipeline(det.model, det._input(batch, True),
                              det.reg_max, **opts)

    def graph():
        made["graph"] += 1
        return det.serve(batch, device_preprocess=True, **opts)

    def sharded():
        made["sharded"] += 1
        return shard_fn(batch)

    want, got = eager(), graph()
    for _ in range(2):
        got = graph()
    torch.cuda.synchronize()
    for name, a, b in zip(want._fields, want, got):
        check(torch.equal(a, b), f"phase 15b: graph serve's {name} "
              f"differs from the eager path's")
    rounds = {"event_ms": {"eager": [], "graph": []},
              "loop_ms": {"eager": [], "graph": []}}
    for _ in range(GRAPH_ROUNDS):
        for name, fn in (("eager", eager), ("graph", graph)):
            rounds["event_ms"][name].append(time_ms(fn))
            rounds["loop_ms"][name].append(closed_loop_ms(fn))
    profiles = {name: profile_call(fn, reps=10, span_names=SERVE_SPANS)
                for name, fn in (("eager", eager), ("graph", graph))}
    # held as phase 10c holds it: its B/2 slices may take other cuDNN
    # algorithms than the whole batch
    got = sharded()
    v = want.valid
    check(all(torch.equal(a, b) for a, b in zip(want[2:], got[2:]))
          and torch.allclose(got.boxes[v], want.boxes[v], rtol=1e-5,
                             atol=1e-4)
          and torch.allclose(got.scores[v], want.scores[v], rtol=1e-5,
                             atol=1e-6),
          "phase 15b: the sharded serve differs from the eager path "
          "beyond phase 10c's tolerances")
    rounds["sharded_ms"] = []
    for _ in range(GRAPH_ROUNDS):
        rounds["sharded_ms"].append(time_ms(sharded))
    numbers = {
        "card": card_line(), "batch": SERVE_BATCH, "rounds": rounds,
        "median": {k: ({n: statistics.median(v) for n, v in d.items()}
                       if isinstance(d, dict) else statistics.median(d))
                   for k, d in rounds.items()},
        "device_busy_ms": {n: prof["device_busy_ms"] / prof["calls"]
                           for n, prof in profiles.items()},
        "span_device_ms": {n: prof["span_device_ms"]
                           for n, prof in profiles.items()},
        "events_per_call": {n: prof["kernels_per_call"]
                            for n, prof in profiles.items()},
        "idle_share": {n: prof["idle_share"]
                       for n, prof in profiles.items()}}
    check(numbers["events_per_call"]["graph"]
          >= numbers["events_per_call"]["eager"],
          f"phase 15b: the trace holds fewer device events a graph call "
          f"than an eager one: {numbers['events_per_call']}")
    stats = serve_graph_stats()
    calls = stats["serve_calls"] - stats_before["serve_calls"]
    replays = stats["replays"] - stats_before["replays"]
    numbers["hit_share"] = replays / calls
    numbers["serve_graph_stats"] = stats
    now = kernel_launches()
    launches = {k: now[k] - launches_before[k] for k in now}
    total = made["eager"] + made["graph"] + 2 * made["sharded"]
    check(launches == counts(attention=2 * total, sppf=total,
                             nms_batched=total),
          f"phase 15b: {made} calls counted the launches {launches}; want "
          f"K1 twice, K5 and K2 once a call (two a sharded call), replays "
          f"included")
    numbers["calls"] = made
    log(f"phase 15b serve x/640² B={SERVE_BATCH} eager against graph: "
        f"{json.dumps(numbers)}; kernel launches before {launches_before}, "
        f"after {now}")
    del det
    torch.cuda.empty_cache()
    return launches, numbers


def main() -> None:
    if not torch.cuda.is_available():
        fail("no CUDA device: this script runs the port on the GPU")
    if sys.argv[1:2] == ["--dist-worker"]:
        dist_worker(sys.argv[2], sys.argv[3], int(sys.argv[4]),
                    int(sys.argv[5]), sys.argv[6])
        return
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
    env = environment()
    log(f"phase 1b environment: {json.dumps(env)}")

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
        qkv32 = attn_qkv(shape, gen).to(dev)
        for dtype in dtypes:
            tol = ATTN_TOL[dtype]
            qkv = qkv32.to(dtype)
            out, v = attention.psa_attention(qkv, snh, sdk, sdh)
            torch.cuda.synchronize()
            ref_out, ref_v = by_item(attention.psa_attention_reference,
                                     qkv, snh, sdk, sdh)
            check(torch.equal(v, ref_v), f"attention v differs {shape} "
                  f"{dtype}")
            err = (out.float() - ref_out.float()).abs().max().item()
            share = tol_share(out, ref_out, tol)
            check(torch.allclose(out.float(), ref_out.float(), atol=tol,
                                 rtol=tol),
                  f"attention out differs {shape} {dtype}: max abs err {err}")
            attn_err[shape, dtype] = err
            log(f"phase 3 attention {shape} {dtype}: v exact, out max abs "
                f"err {err}, {share:.3f} of the tolerance {tol} (|ref| max "
                f"{ref_out.float().abs().max().item()})")
    qkv_x = torch.randn(b, t, nh * (2 * dk + dh), generator=gen).to(
        dev, torch.bfloat16)

    # ------------------------------------- 4. K2 and K3 against their twin
    nms_mismatch, nms_single_mismatch = nms_checks(dev)

    # ------------------------------------------- 4b. K4 against its twin
    # the same cases, with random cotangents for out and v
    bwd_err = {}
    for shape, dtypes in ATTN_CASES:
        sb, st, snh, sdk, sdh = shape
        qkv32 = attn_qkv(shape, gen).to(dev)
        do32 = torch.randn(sb, st, snh * sdh, generator=gen).to(dev)
        dv32 = torch.randn(sb, st, snh * sdh, generator=gen).to(dev)
        for dtype in dtypes:
            args = (qkv32.to(dtype), do32.to(dtype), dv32.to(dtype),
                    snh, sdk, sdh)
            got = attention.psa_attention_bwd(*args)
            torch.cuda.synchronize()
            again = attention.psa_attention_bwd(*args)
            ref = by_item(attention.psa_attention_bwd_reference, *args)
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
    sppf_mismatch = sppf_checks(gen, dev)

    # ------------------------------------------- 4d. K6 against its twin
    # the x preset's three head levels at batch 8, and a ragged map whose
    # tiles hang over the border; limits: fp32 atol/rtol 1e-4; bf16 against
    # the twin on the card, which rounds where the kernel rounds, within
    # 1e-2 of the largest logit (at most one bf16 step there) and 1e-4 of it
    # on average; bf16 against the CPU's twin within 3e-2 of it. Two runs
    # of the kernel are equal bit for bit.
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
            check(torch.equal(got, head_kernel.cls_tower(x, *params)),
                  f"cls tower {shape} {dtype} differs between two runs")
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
                    f"err {err}, mean {mean_err} (largest logit {top}); two "
                    f"runs equal")
                if name == "twin":
                    tower_err[shape, dtype] = err

    # ------------------------------------------- 4e. K7 against its twin
    # every ConvBN kernel of the x model (fused fp32, the seed of `det`
    # below) as quantize() hands it to the kernel: (kh·kw·cin, cout),
    # divided by the channel's scale and clipped; seed 0, as every leaf of
    # the main path gets; all of them in one grouped launch. Bit-exact
    # against the twin, at most one step from round-to-nearest; a 64-bit
    # seed on the largest leaf; unbiased over 64 seeds there (the JAX test's
    # bound, 0.45 of a step); leaves of odd sizes, one of them not aligned
    # to 16 bytes
    p = PRESETS["x"]
    xq = Detector(p["width"], p["depth"], p["csp"], NUM_CLASSES,
                  precision="bfloat16", input_size=(HW, HW), device="cuda")
    xq.init(SEED)
    xq.fuse()
    k7_mismatch = k7_far = 0
    path_leaves = {}            # the main path's leaves: (operand, K7 result)
    leaves = [key for key in xq._state if key.endswith(".conv.weight")]
    flats = [quant.stochastic_operand(xq._state[key])[0] for key in leaves]
    rounded = quant_kernel.stochastic_round_many(flats, 0)
    torch.cuda.synchronize()
    for key, flat, got in zip(leaves, flats, rounded):
        ref = quant_kernel.stochastic_round_reference(flat, 0)
        k7_mismatch += int((got != ref).sum())
        k7_far = max(k7_far, int((got.int() - torch.round(flat).int())
                                 .abs().max()))
        if not any(part in quant.DEFAULT_QUANT_SKIP
                   for part in key.split(".")):
            path_leaves[key] = (flat, got)
    del flats, rounded
    check(k7_mismatch == 0, f"K7 differs from its twin in {k7_mismatch} "
          f"elements over {len(leaves)} leaves")
    check(k7_far <= 1, f"K7 rounded {k7_far} steps from the nearest")
    odd = torch.rand(1 + 3 + 1023 + 1025 + 4097 + 7 + 1, generator=gen)
    odd = ((odd - 0.5) * 254).to(dev)
    odd_leaves = [odd[:1], odd[1:4], odd[4:1027].view(31, 33),
                  odd[1027:2052], odd[2052:6149], odd[6149:6156], odd[:0]]
    for seed in (3, 2 ** 33 + 1):
        for flat, got in zip(odd_leaves, quant_kernel.stochastic_round_many(
                odd_leaves, seed)):
            check(torch.equal(got, quant_kernel.stochastic_round_reference(
                flat, seed)), f"K7 differs from its twin on a leaf of "
                  f"{flat.numel()} at {flat.data_ptr() % 16} bytes past 16, "
                  f"seed {seed}")
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
        f"({sum(xq._state[k].numel() for k in leaves)} weights) in one "
        f"launch, each equal to its twin bit for bit at seed 0; leaves of "
        f"{[f.numel() for f in odd_leaves]} elements, "
        f"{[f.data_ptr() % 16 for f in odd_leaves]} bytes past 16, equal at "
        f"seeds 3 and 2**33 + 1; at {seed_hi} on "
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

    # ------------------------------- 4g. kernels on a card not current
    device_guard(gen)

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
    check(quantize_launches == counts(stochastic_round=1)
          and n_leaves == len(path_leaves),
          f"quantize launched {quantize_launches}, want K7 once for all "
          f"{n_leaves} int8 leaves ({len(path_leaves)} in phase 4e)")
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
        f", static): {n_leaves} int8 leaves, K7 launched once for all at "
        f"quantize and equal to phase 4e's; calibrate on two batches; "
        f"detections {result8.num_valid.cpu().tolist()}, inference "
        f"{len(dets8[0])}; box logits vs bf16 fused Pearson {int8_corr} "
        f"(limit {INT8_CORR}; all logits {int8_corr_all}); static == "
        f"dynamic bit for bit on its calibration batch; optimised vs not "
        f"max abs err {int8_opt_err} of {int8_top}, Pearson {int8_opt_corr}"
        f"; launches quantize {quantize_launches}, calibrate "
        f"{calibrate_launches}, serve + inference {serve8_launches}")
    del q8one, q8opt, dyn_state

    # ------------------------------------------- 5d. a 4K frame, full width
    # the seed of `det` at 2176 x 3840 (a 68 x 120 p5 map, which K5 refused
    # in bf16 before it worked on tiles), B=1, fused bf16: one serve, K5
    # once, K3 for the batch of one, detections; its events time
    big = Detector(p["width"], p["depth"], p["csp"], NUM_CLASSES,
                   precision="bfloat16", input_size=K4_SIZE, device="cuda")
    big.init(SEED)
    big.fuse()
    frame = torch.randint(0, 256, (1, *K4_SIZE, 3),
                          generator=torch.Generator().manual_seed(SEED + 9),
                          dtype=torch.uint8).to(dev)
    reset_counts()
    result4k = big.serve(frame, conf_thres=POOL_CONF, device_preprocess=True)
    torch.cuda.synchronize()
    launches4k = read_counts()
    check(launches4k == counts(attention=2, nms_single=1, sppf=1),
          f"4K serve launched {launches4k}, want attention 2, single-image "
          f"NMS 1 (a batch of one), SPPF 1")
    for name in result4k._fields:
        value = getattr(result4k, name)
        if value.is_floating_point():
            check(bool(torch.isfinite(value).all()),
                  f"4K serve: non-finite {name}")
    check(int(result4k.num_valid.min()) > 0, "4K serve returned no detection")
    serve4k_ms = time_ms(lambda: big.serve(frame, conf_thres=POOL_CONF,
                                           device_preprocess=True),
                         reps=5, warmup=1)
    log(f"phase 5d x preset {K4_SIZE[0]}x{K4_SIZE[1]} bf16 B=1 (p5 map "
        f"{K4_SIZE[0] // 32}x{K4_SIZE[1] // 32}): detections "
        f"{result4k.num_valid.cpu().tolist()}, launches {launches4k}; "
        f"serve {serve4k_ms} ms by events, median of 5 | {card}")
    del big, frame, result4k

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

    # K2 on the pool the main path hands it: the serve batch's candidates;
    # device time (profiler) and one call's events
    boxes_s, scores_s = decode_raw_predictions(
        *det(normalize(batch)))
    cand_boxes, _, cand_classes, cand_valid = _gather_candidates(
        boxes_s, scores_s.amax(-1), scores_s.argmax(-1).to(torch.int32),
        conf_thres=POOL_CONF, top_k=1024)
    shifted = (cand_boxes + (cand_classes.float() * MAX_WH)[..., None]
               ).contiguous()
    keep = nms_kernel.nms_keep_batched(shifted, cand_valid, 0.45)

    def k2_of(bx, vd):
        return lambda: nms_kernel.nms_keep_batched(bx, vd, 0.45)

    def k3_of(bx, vd):
        return lambda: nms_kernel.nms_keep_single(bx, vd, 0.45)

    k2_split = split_ms(k2_of(shifted, cand_valid))
    k2_ms = k2_split["device_ms"]
    k2_call_ms = time_ms(k2_of(shifted, cand_valid))
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
    k3_split = split_ms(k3_of(one_boxes, one_valid))
    k3_ms = k3_split["device_ms"]
    k3_call_ms = time_ms(k3_of(one_boxes, one_valid))
    k3_plain = time_ms(lambda: nms_kernel.nms_keep_reference(
        one_boxes, one_valid, 0.45), reps=10, warmup=1)
    k3_bound = nms_bound_ms(keep_one)
    # and on a pool where nearly every box survives (random boxes of 20
    # classes): one image for K3, the same image eight times for K2
    dense_boxes, dense_valid = nms_pool(2, 1024, 0.45,
                                        np.random.RandomState(SEED + 4))
    dense_boxes = torch.from_numpy(dense_boxes[:1]).to(dev)
    dense_valid = torch.from_numpy(dense_valid[:1]).to(dev)
    dense_keep = nms_kernel.nms_keep_single(dense_boxes, dense_valid, 0.45)
    check(torch.equal(dense_keep, nms_kernel.nms_keep_batched(
        dense_boxes, dense_valid, 0.45)), "single-image NMS differs from "
        "the batched kernel on the dense pool")
    dense8_boxes = dense_boxes.expand(SERVE_BATCH, -1, -1).contiguous()
    dense8_valid = dense_valid.expand(SERVE_BATCH, -1).contiguous()
    check(torch.equal(nms_kernel.nms_keep_batched(
        dense8_boxes, dense8_valid, 0.45), dense_keep.expand(
            SERVE_BATCH, -1)), "batched NMS differs image by image on the "
        "dense pool")
    nms_times = {
        "serve_pool": {
            "k2": {**k2_split, "events_ms": k2_call_ms,
                   "kept": int(keep.sum()), "images": SERVE_BATCH},
            "k3": {**k3_split, "events_ms": k3_call_ms,
                   "kept": int(keep_one.sum()), "images": 1}},
        "dense_pool": {
            "k2": {**split_ms(k2_of(dense8_boxes, dense8_valid)),
                   "events_ms": time_ms(k2_of(dense8_boxes, dense8_valid)),
                   "kept": int(dense_keep.sum()) * SERVE_BATCH,
                   "images": SERVE_BATCH},
            "k3": {**split_ms(k3_of(dense_boxes, dense_valid)),
                   "events_ms": time_ms(k3_of(dense_boxes, dense_valid)),
                   "kept": int(dense_keep.sum()), "images": 1}}}
    for pool, rows in nms_times.items():
        log(f"phase 7 NMS {pool} (K=1024): " + "; ".join(
            f"{name} {row['device_ms']} device ms {row['by_kernel_ms']}, "
            f"{row['events_ms']} ms by events, {row['kept']} kept of "
            f"{row['images']} images" for name, row in rows.items()))

    # K5 at the shapes of SPPF_TIMED, beside the library's chain (its
    # twin's code) and the bound; the serve shape's row goes to the
    # kernels line
    k5_rows = []
    for shape, dtype in SPPF_TIMED:
        k5_rows.append(sppf_times(channels_last(shape, dtype, gen, dev)))
        log(f"phase 7 K5 {json.dumps(k5_rows[-1])} | {card}")
    k5 = k5_rows[0]
    k5_bound = (k5["bound_ms"], k5["bound_by"])

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

        def chain_level(i, f):
            return head._tower(f, f"cls{i}_dw1", f"cls{i}_pw1",
                               f"cls{i}_dw2", f"cls{i}_pw2", f"cls{i}_out")

        def chain():
            return [chain_level(i, f) for i, f in enumerate(feats)]

        # device time (profiler) and events, the three levels together
        # and level by level, for K6 and for the cuDNN chain
        k6_ms = device_ms(lambda: towers(head_kernel.cls_tower))
        k6_call_ms = time_ms(lambda: towers(head_kernel.cls_tower), reps=10)
        k6_plain = time_ms(lambda: towers(head_kernel.cls_tower_reference),
                           reps=10)
        k6_lib = device_ms(chain)
        k6_lib_call = time_ms(chain, reps=10)
        k6_levels, chain_levels = [], []
        for i, f in enumerate(feats):
            def one(i=i, f=f):
                return head_kernel.cls_tower(f, *packs[i])

            def one_chain(i=i, f=f):
                return chain_level(i, f)

            k6_levels.append({"shape": list(f.shape),
                              "device_ms": device_ms(one),
                              "events_ms": time_ms(one, reps=10)})
            chain_levels.append({"shape": list(f.shape),
                                 "device_ms": device_ms(one_chain),
                                 "events_ms": time_ms(one_chain, reps=10)})
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
    log(f"phase 7 K6 x/640² B={SERVE_BATCH}, three levels (6 launches): "
        f"{k6_ms} device ms, {k6_call_ms} ms by events; cuDNN chain "
        f"{k6_lib} device ms, {k6_lib_call} by events; bound {k6_bound[0]} "
        f"ms ({k6_bound[1]}); by level (device / events ms) K6 "
        f"{[(lv['device_ms'], lv['events_ms']) for lv in k6_levels]}, "
        f"chain {[(lv['device_ms'], lv['events_ms']) for lv in chain_levels]}"
        f"; K6 {'below' if k6_ms < k6_lib else 'NOT below'} the chain by "
        f"device time, {'below' if k6_call_ms < k6_lib_call else 'NOT below'}"
        f" by events")
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

    # K7 over the leaves of one quantize() of the main path (one grouped
    # launch) and on the largest leaf alone: device time and events; its
    # twin over the same leaves; the bound from the kernel's SASS; then one
    # whole Detector.quantize(stochastic=True) by events (the per-leaf
    # operand passes stay eager), median of three fresh fused detectors
    path_flats = [flat for flat, _ in path_leaves.values()]
    path_weights = sum(flat.numel() for flat in path_flats)

    def k7_quantize():
        return quant_kernel.stochastic_round_many(path_flats, 0)

    k7_ms = device_ms(k7_quantize, reps=10)
    k7_call_ms = time_ms(k7_quantize, reps=10)
    k7_plain = time_ms(lambda: [quant_kernel.stochastic_round_reference(f, 0)
                                for f in path_flats], reps=3, warmup=1)
    k7_leaf_ms = device_ms(lambda: quant_kernel.stochastic_round(flat_l, 0))
    k7_leaf_call_ms = time_ms(lambda: quant_kernel.stochastic_round(flat_l,
                                                                    0))
    k7_ops = k7_sass_per_element()
    k7_bound = k7_bound_of(path_weights, k7_ops)
    k7_leaf_bound = k7_bound_of(flat_l.numel(), k7_ops)
    quantize_times, quantize_peaks = [], []
    for _ in range(3):
        fresh = x_detector()
        fresh.init(SEED)
        fresh.fuse()
        torch.cuda.synchronize()
        before = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fresh.quantize(stochastic=True)
        end.record()
        end.synchronize()
        quantize_times.append(start.elapsed_time(end))
        quantize_peaks.append(torch.cuda.max_memory_allocated() - before)
        del fresh
    quantize_ms = statistics.median(quantize_times)
    log(f"phase 7 K7 one quantize() ({len(path_flats)} leaves, "
        f"{path_weights} weights, 1 launch): {k7_ms} device ms, "
        f"{k7_call_ms} events ms, bound {k7_bound[0]} ms by "
        f"{k7_bound[1]}; largest leaf {tuple(flat_l.shape)}: {k7_leaf_ms} "
        f"device ms, {k7_leaf_call_ms} events, bound {k7_leaf_bound[0]} by "
        f"{k7_leaf_bound[1]}; per element from the SASS: "
        f"{k7_ops} (the whole kernel's SASS: {k7_ops['kernel_sass']} an "
        f"element); SM clock "
        f"{sm_clock_hz() / 1e6} MHz; twin {k7_plain} ms; whole "
        f"Detector.quantize(stochastic=True) {quantize_ms} ms by events "
        f"(of {quantize_times}), its peak {max(quantize_peaks)} bytes above "
        f"the fused detector's allocation (of {quantize_peaks}) | {card}")

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
        "nms_x640": nms_times,
        "sppf": k5_rows,
        "serve_4k_bf16_b1_ms": serve4k_ms,
        "serve_x640_int8_static": {
            "batch": SERVE_BATCH, "ms": serve_ms["int8_static"]["b8"],
            "img_per_s": SERVE_BATCH / serve_ms["int8_static"]["b8"] * 1e3,
            "b1_ms": serve_ms["int8_static"]["b1"],
            "dynamic_b8_ms": serve_ms["int8_dynamic"]["b8"]},
        "quantize_x_k7": {"leaves": n_leaves, "weights": path_weights,
                          "launches": 1, "device_ms": k7_ms,
                          "events_ms": k7_call_ms,
                          "bound_ms": k7_bound[0], "bound_by": k7_bound[1],
                          "sass_per_element": k7_ops,
                          "largest_leaf": list(flat_l.shape),
                          "largest_leaf_device_ms": k7_leaf_ms,
                          "largest_leaf_events_ms": k7_leaf_call_ms,
                          "largest_leaf_bound_ms": k7_leaf_bound[0],
                          "detector_quantize_events_ms": quantize_ms,
                          "detector_quantize_peak_bytes": max(
                              quantize_peaks)},
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
        "cls_tower_x640": {
            "device_ms": k6_ms, "events_ms": k6_call_ms,
            "chain_device_ms": k6_lib, "chain_events_ms": k6_lib_call,
            "bound_ms": k6_bound[0], "bound_by": k6_bound[1],
            "levels": k6_levels, "chain_levels": chain_levels},
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
    # phase 13b's yardstick: the device busy ms of one TAL step
    train_busy_ms = prof["device_busy_ms"] / prof["calls"]
    serve_profiles = {}
    for name, detector, tower, keys in variants:
        for key in keys:
            prof = serve_profiles[name, key] = profile_call(
                serve_of(detector, tower, inputs[key]))
            log(json.dumps({"card": card, "profile_serve": name,
                            "batch": len(inputs[key]), **prof}))
    opt.model.head.fused_cls_tower = False
    with_k6 = serve_profiles["fused_optimized_cls_tower", "b8"]
    without_k6 = serve_profiles["fused_optimized", "b8"]
    log(f"phase 7 serve_optimized B={SERVE_BATCH}: device busy "
        f"{with_k6['device_busy_ms'] / with_k6['calls']} ms a call with K6, "
        f"{without_k6['device_busy_ms'] / without_k6['calls']} without "
        f"(port kernels with K6: "
        f"{with_k6['by_category_ms_launches'].get('port kernels')} ms, "
        f"launches)")
    prof = profile_call(eval_and_decode, reps=2)
    log(json.dumps({"card": card, "profile_eval_batch": train_n, **prof}))
    del model, optimizer, state, tal_step, nearest_step, eval_step, tbatch
    torch.cuda.empty_cache()

    # ------------------------------------------------ 8. the trainer path
    stamp("8")
    augmentation_phase(dev, train_ms)
    trainer_launches, _ = trainer_phase(dev, env, p)
    trainer_card_vs_cpu(env)

    # --------------------------------------- 9. the command-line entry points
    stamp("9")
    root = tempfile.mkdtemp(prefix="cli_")
    try:
        cli_launches, persistence_launches, cli_numbers = cli_phase(
            env, p, root)
        for name in ("attention", "attention_bwd", "nms_batched", "sppf"):
            check(cli_launches[name] > 0, f"the CLI path never launched "
                  f"{name}: {cli_launches}")
        log(f"phase 9 launches of the cli path (the CLI processes): "
            f"{json.dumps(cli_launches)}; of the persistence path (9d, in "
            f"this process): {json.dumps(persistence_launches)}")

        # ------------------ 10. distributed training and sharded serving
        stamp("10")
        dist_launches, _ = distributed_phase(
            env, p, root, single=cli_numbers["train_record"])

        # ------------- 11. serving artifacts and the reference importer
        stamp("11")
        export_launches, _ = export_phase(
            p, root, {"fused": det, "optimized": opt, "int8": q8},
            norm_batch)

        # --------------------------------- 12. the quality-diagnosis scripts
        stamp("12")
        # beside phase 14's report, whose ranks start first
        started = start_multichip(root)
        try:
            quality_launches, _ = quality_phase(root)
            # ------------------ 14. the multi-card collectives report
            stamp("14")
            multichip_launches, _ = multichip_phase(started)
        finally:
            started[0].kill()

        # ------------ 13. the examples, the step profiler and the soak
        stamp("13")
        entry_launches, _ = entry_points_phase(p, root, train_busy_ms)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    for name in ("attention", "attention_bwd", "nms_batched", "sppf"):
        check(dist_launches[name] > 0, f"the distributed path never "
              f"launched {name}: {dist_launches}")
    log(f"phase 10 launches of the distributed path (10a's and 10b's ranks, "
        f"10c in this process): {json.dumps(dist_launches)}")
    log(f"phase 11 launches of the export path (the artifacts' calls): "
        f"{json.dumps(export_launches)}")
    for name in ("attention", "sppf"):
        check(quality_launches[name] > 0, f"the quality path never "
              f"launched {name}: {quality_launches}")
    log(f"phase 12 launches of the quality path (the scripts' processes): "
        f"{json.dumps(quality_launches)}")

    for path, names in (("examples", ("attention", "attention_bwd",
                                      "nms_batched", "nms_single", "sppf")),
                        ("profile", ("attention", "attention_bwd")),
                        ("soak", ("attention", "attention_bwd"))):
        for name in names:
            check(entry_launches[path][name] > 0, f"the {path} path never "
                  f"launched {name}: {entry_launches[path]}")
    log(f"phase 13 launches of the examples, profile and soak paths (the "
        f"scripts' calls in this process): {json.dumps(entry_launches)}")

    log(f"phase 14 launches of the multichip path (the report's ranks): "
        f"{json.dumps(multichip_launches)}")

    # ----------------------------------------------- 15. serve's CUDA graphs
    stamp("15")
    serve_graph_phase()
    log(f"serve's CUDA graphs over the whole run: "
        f"{json.dumps(serve_graph_stats())}")

    paths = {"serve": launches, "train": train_launches,
             "serve_optimized": opt_launches, "eval": eval_launches,
             "int8": int8_launches, "trainer": trainer_launches,
             "cli": cli_launches, "persistence": persistence_launches,
             "distributed": dist_launches, "export": export_launches,
             "quality": quality_launches, **entry_launches,
             "multichip": multichip_launches}

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
                     "pallas/sppf_kernel.py:36", float(sppf_mismatch),
                     k5["device_ms"], k5["twin_events_ms"], k5_bound,
                     k5["chain_device_ms"]),
        kernel_entry("cls_tower", "cls_tower", "head.cu",
                     "pallas/head_kernel.py:52",
                     max(tower_err[s, torch.bfloat16] for s in x_levels),
                     k6_ms, k6_plain, k6_bound, k6_lib),
        kernel_entry("stochastic_round_int8_grouped", "stochastic_round",
                     "quant.cu", "quant.py:69", float(k7_mismatch), k7_ms,
                     k7_plain, k7_bound, None),
    ]
    stamp("end")
    log(json.dumps({"kernels": kernels}))
    log(card)
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
