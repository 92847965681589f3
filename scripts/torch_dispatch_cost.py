#!/usr/bin/env python
"""Host cost of the serving kernels' wrappers and of ``Detector.serve``
on one card, for comparing two trees of the package in one run.

    python scripts/torch_dispatch_cost.py [--label NAME]

At x/640² bf16 with random seeded weights and inputs, it times:

- each serving kernel's public wrapper — K1 ``attention.psa_attention``,
  K2 ``nms_kernel.nms_keep_batched``, K3 ``nms_kernel.nms_keep_single``,
  K5 ``sppf_kernel.sppf_pyramid``, K6 ``head_kernel.cls_tower`` at the
  20² level (two stage launches) — by ``host_us``: 200 calls back to
  back, then one synchronise, over 200. These kernels take 5-25 µs
  of device time, so a call's host path sets this number wherever it is
  the longer; the fastest of five such blocks is kept. Beside it
  ``events_ms``: the median of 200 single calls' CUDA events;
- ``Detector.serve`` of the fused detector, B=8 and B=1 (conf 0.001,
  device preprocessing), and of the optimised detector with the fused
  cls tower at B=8: the median of 20 single calls' CUDA events, and host
  ms a call as above, in blocks of 5.

It imports the package from the repository it lies in and uses only the
wrappers' public names, so a copy of it runs against an older tree as
well. The last line is a JSON object with the numbers, ``--label`` and
the card's name and power limit.
"""

import argparse
import json
import os
import statistics
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import torch  # noqa: E402

from custom_yolo_tpu_torch import PRESETS, Detector  # noqa: E402
from custom_yolo_tpu_torch.ops import (attention, head_kernel,  # noqa: E402
                                       nms_kernel, sppf_kernel)
from custom_yolo_tpu_torch.ops.cuda import build  # noqa: E402

SEED = 0
HW = 640
NUM_CLASSES = 172
# the x model's PSA shape at 640² (B, T, heads, key dim, head dim)
ATTENTION = (8, 400, 6, 32, 64)
WRAPPER_REPS, SERVE_REPS, SERVE_BLOCK = 200, 20, 5


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=30).stdout.strip()


def events_ms(fn, reps: int) -> float:
    """Median of ``reps`` single calls' CUDA events."""
    for _ in range(3):
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


def host_us(fn, reps: int, blocks: int = 5) -> float:
    """Wall µs a call: ``blocks`` blocks of ``reps`` calls back to back,
    each ended by a sync; the fastest block's mean, since the host's other
    work only ever adds to a block."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    best = float("inf")
    for _ in range(blocks):
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
        best = min(best, (time.perf_counter() - t0) / reps)
    return best * 1e6


def wrapper_inputs(gen: torch.Generator) -> dict:
    dev = torch.device("cuda")
    b, t, nh, dk, dh = ATTENTION
    qkv = torch.randn(b, t, nh * (2 * dk + dh), generator=gen).to(
        dev, torch.bfloat16)
    # a serve-sized pool: 8 × 1024 boxes, class-offset, half of them valid
    xy = torch.rand(8, 1024, 2, generator=gen) * 600
    wh = torch.rand(8, 1024, 2, generator=gen) * 80 + 4
    boxes = torch.cat([xy, xy + wh], -1).to(dev).contiguous()
    valid = (torch.rand(8, 1024, generator=gen) < 0.5).to(dev)
    x5 = torch.randn(8, 384, 20, 20, generator=gen).to(
        dev, torch.bfloat16).contiguous(memory_format=torch.channels_last)
    x6 = torch.randn(8, 768, 20, 20, generator=gen).to(
        dev, torch.bfloat16).contiguous(memory_format=torch.channels_last)

    def mk(*shape):
        return (torch.randn(*shape, generator=gen) * 0.1).to(
            dev, torch.bfloat16)
    c, mid = 768, 384
    tower = ((mk(3, 3, c), mk(c)), (mk(c, mid), mk(mid)),
             (mk(3, 3, mid), mk(mid)), (mk(mid, mid), mk(mid)),
             (mk(mid, NUM_CLASSES), mk(NUM_CLASSES)))
    return {
        "K1 psa_attention": lambda: attention.psa_attention(
            qkv, nh, dk, dh),
        "K2 nms_keep_batched": lambda: nms_kernel.nms_keep_batched(
            boxes, valid, 0.45),
        "K3 nms_keep_single": lambda: nms_kernel.nms_keep_single(
            boxes[:1], valid[:1], 0.45),
        "K5 sppf_pyramid": lambda: sppf_kernel.sppf_pyramid(x5),
        "K6 cls_tower": lambda: head_kernel.cls_tower(x6, *tower),
    }


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--label", default=os.path.basename(REPO))
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("torch_dispatch_cost.py times the card; no CUDA "
                         "device is visible")
    build.build()
    gen = torch.Generator().manual_seed(SEED)
    result = {"label": args.label, "torch": torch.__version__,
              "wrappers": {}, "serve": {}}
    with torch.inference_mode():
        for name, fn in wrapper_inputs(gen).items():
            result["wrappers"][name] = {
                "host_us": host_us(fn, WRAPPER_REPS),
                "events_ms": events_ms(fn, WRAPPER_REPS)}

    x = PRESETS["x"]
    det = Detector(x["width"], x["depth"], x["csp"], NUM_CLASSES,
                   precision="bfloat16", input_size=(HW, HW),
                   device="cuda")
    det.init(SEED)
    det.fuse()
    opt = Detector(x["width"], x["depth"], x["csp"], NUM_CLASSES,
                   precision="bfloat16", input_size=(HW, HW),
                   device="cuda")
    opt.init(SEED)
    opt.fuse()
    opt.optimize_for_serving()
    opt.model.head.fused_cls_tower = True
    batch = torch.randint(0, 256, (8, HW, HW, 3), generator=gen,
                          dtype=torch.uint8).cuda()
    for name, detector, images in (("fused B=8", det, batch),
                                   ("fused B=1", det, batch[:1]),
                                   ("optimised + K6 B=8", opt, batch)):
        def call(detector=detector, images=images):
            return detector.serve(images, conf_thres=0.001,
                                  device_preprocess=True)
        result["serve"][name] = {
            "events_ms": events_ms(call, SERVE_REPS),
            "host_ms": host_us(call, SERVE_BLOCK) / 1e3}
    result["card"] = card_line()
    for kind, rows in (("wrappers", result["wrappers"]),
                       ("serve", result["serve"])):
        for name, row in rows.items():
            print(f"[{args.label}] {kind} {name}: "
                  + ", ".join(f"{k} {v:.4f}" for k, v in row.items()),
                  flush=True)
    print(json.dumps(result), flush=True)


if __name__ == "__main__":
    main()
