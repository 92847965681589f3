#!/usr/bin/env python3
"""Readings that a cell's correctness limits are set from, in one process
on the card: the program's numbers over many seeds (the lower readings),
the control's over a few (the upper readings), and faults planted in the
program (``faults.py``): for a training cell the half batch, for a
serving cell NMS that suppresses nothing or keeps too few.

    python3 perfbench/calibrate.py --workload x640-serve-b8 \\
        --seeds 1001-1012 --control 2001-2003 [--faults 3001-3003] \\
        --seconds 2 --out out/calibrate_x640-serve-b8.json

The control is the nearest precision below the configuration's bf16:
for serving, the program's own int8 path (``Detector.quantize()``,
dynamic activation scales) in place of the bf16 detector (``control``);
for training, the reference with every conv operand and the attention's
operands rounded to float8 e4m3 in the program's place (``control_fp8``,
gradients passed straight through). The benchmark's own runs never run
this.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from perfbench import core, faults  # noqa: E402


def seeds(text: str):
    out = []
    for part in text.split(","):
        if "-" in part:
            a, b = part.split("-")
            out.extend(range(int(a), int(b) + 1))
        elif part:
            out.append(int(part))
    return out


def program_readings(generator, resolved, seed, seconds, device):
    from perfbench.run import Run

    r = Run(resolved, seed, seconds, False, device, time.time())
    r.limits = {name: float("inf") for name in generator.CANDIDATES}
    out = generator.run(r)
    return {c["name"]: c["value"] for c in out["compared"]}


def int8_detector(original):
    def build(cfg, state, device):
        return original(cfg, state, device).quantize(stochastic=False)
    return build


def train_control(resolved, seed, device):
    from perfbench.reference.model import fp8_e4m3
    from perfbench.traffic import train
    from perfbench.weights import scene_batches

    import torch

    cfg, mix = resolved["config"], resolved["mix"]
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    batches = scene_batches(seed, mix["ring"], mix["batch"],
                            tuple(cfg["input_size"]), cfg["num_classes"],
                            mix["slots"], mix["boxes_mean"], device,
                            texture=mix["texture"])
    seen = train.reference_readings(cfg, mix, seed, batches, quant=fp8_e4m3)
    ref = train.reference_readings(cfg, mix, seed, batches)
    g = train.gaps(seen, ref)
    return {k: g[k] for k in train.CANDIDATES}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", default="")
    p.add_argument("--control", default="")
    p.add_argument("--faults", default="")
    p.add_argument("--seconds", type=float, default=2.0)
    p.add_argument("--out", required=True)
    args = p.parse_args(argv)
    core.set_cache_env()
    resolved = core.cell(args.workload)
    import importlib

    import torch

    device = torch.device("cuda", 0)
    name = resolved["mix"]["generator"]
    generator = importlib.import_module(f"perfbench.traffic.{name}")
    rows = []

    clock = [time.time()]

    def record(kind, seed, values):
        now = time.time()
        row = {"kind": kind, "seed": seed, **values,
               "seconds": round(now - clock[0], 1)}
        clock[0] = now
        rows.append(row)
        print(json.dumps(row), flush=True)
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        with open(args.out, "w") as f:
            json.dump({"workload": args.workload,
                       "device": torch.cuda.get_device_name(0),
                       "rows": rows}, f, indent=1)

    for s in seeds(args.seeds):
        record("program", s, program_readings(generator, resolved, s,
                                              args.seconds, device))
    for s in seeds(args.control):
        if name == "serve":
            original = generator.build_detector
            generator.build_detector = int8_detector(original)
            try:
                values = program_readings(generator, resolved, s,
                                          args.seconds, device)
            finally:
                generator.build_detector = original
            record("control", s, values)
        else:
            record("control_fp8", s, train_control(resolved, s, device))
    if name == "serve":
        attr, wrap, planted = ("build_detector", faults.serving,
                               ("no_suppression", "truncated_keep"))
    else:
        attr, wrap, planted = "build_step", faults.training, ("half_batch",)
    for s in seeds(args.faults):
        for fault in planted:
            original = getattr(generator, attr)
            setattr(generator, attr, wrap(original, fault))
            try:
                values = program_readings(generator, resolved, s,
                                          args.seconds, device)
            finally:
                setattr(generator, attr, original)
            record(fault, s, values)
    return 0


if __name__ == "__main__":
    sys.exit(main())
