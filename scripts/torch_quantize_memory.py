"""Peak device memory and time of ``Detector.quantize(stochastic=True)`` of
the ``x`` preset on one NVIDIA GPU, for the port of a given checkout.

    python3 scripts/torch_quantize_memory.py [--root DIR] [--reps N]

Imports ``custom_yolo_tpu_torch`` from DIR (this checkout by default; an
earlier commit unpacked with ``git archive`` into a git-ignored directory
gives that commit's ``quantize()``), builds a fused ``x`` detector at
640², bf16, 172 classes, seed 0, N times (3), and quantizes each with
stochastic rounding. Prints one JSON line: for each ``quantize()`` the
bytes allocated at its peak above the fused detector's own allocation
(``torch.cuda.max_memory_allocated``) and its time by CUDA events, the
root, and the card's ``nvidia-smi`` name and power limit. Exits non-zero
without a CUDA device.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

import torch


def main() -> None:
    parser = argparse.ArgumentParser()
    parser.add_argument("--root", default=str(Path(__file__).resolve()
                                              .parents[1]))
    parser.add_argument("--reps", type=int, default=3)
    args = parser.parse_args()
    if not torch.cuda.is_available():
        sys.exit("no CUDA device: this script runs on the GPU")
    sys.path.insert(0, str(Path(args.root).resolve()))
    from custom_yolo_tpu_torch import PRESETS, Detector

    p = PRESETS["x"]
    peaks, times = [], []
    for _ in range(args.reps):
        det = Detector(p["width"], p["depth"], p["csp"], 172,
                       precision="bfloat16", input_size=(640, 640),
                       device="cuda")
        det.init(0)
        det.fuse()
        torch.cuda.synchronize()
        before = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        det.quantize(stochastic=True)
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
        peaks.append(torch.cuda.max_memory_allocated() - before)
        del det
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(json.dumps({"root": args.root, "peak_bytes_above_detector": peaks,
                      "events_ms": times, "card": card}))


if __name__ == "__main__":
    main()
