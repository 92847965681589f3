#!/usr/bin/env python
"""The training-extension ablation on the gen2 fixture, with the PyTorch
port (counterpart of ``scripts/ablate_quality.py``).

A run matrix over {assigner, EMA, warm-up, mosaic, mixup, combo}: each
cell is trained with ``scripts/torch_train.py`` and scored with
``scripts/torch_evaluate.py --coco_map`` on the unseen validation split
(val mAP@50:95 per cell), each a child process on ``--device``.

Cells (all n preset, dataset_gen2 256/85 images, the same seed and
budget):

  nearest   the reference's nearest-centre assignment, no extensions
  tal       task-aligned assignment only
  tal+ema / tal+warmup / tal+mosaic / tal+mixup: one extension each
  combo     tal + ema + warmup + mosaic + mixup

Runs one after another. Results go to ``<out>/ablation.json`` (a cell
already there is not run again) and a markdown table to stdout. The base
config is never edited: each cell's config is a line-by-line rewrite of
it in ``<out>``.

    python scripts/torch_ablate_quality.py --base configs/ablate_gen2_n.yaml \\
        --epochs 60 --out dataset_gen2/experiments/ablate_torch
"""

import argparse
import json
import os
import re
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

CELLS = {
    "nearest":    {"assigner": "nearest"},
    "tal":        {"assigner": "tal"},
    "tal+ema":    {"assigner": "tal", "ema_decay": 0.999, "ema_tau": 200.0},
    "tal+warmup": {"assigner": "tal", "warmup_steps": 100},
    "tal+mosaic": {"assigner": "tal", "mosaic": 0.5, "close_mosaic": 10},
    "tal+mixup":  {"assigner": "tal", "mixup": 0.15},
    "combo":      {"assigner": "tal", "ema_decay": 0.999, "ema_tau": 200.0,
                   "warmup_steps": 100, "mosaic": 0.5, "close_mosaic": 10,
                   "mixup": 0.15},
}
METRIC_RE = re.compile(r"\s+(mAP_[a-z0-9_]+|precision|recall|f1"
                       r"|AR_[0-9]+): ([0-9.eE+-]+)")


def write_cell_config(base_yaml: str, cell: str, overrides: dict,
                      epochs: int, out_dir: str) -> str:
    """One cell's YAML: the base, its training-section overrides and its
    own checkpoint dir. A plain line-level rewrite (the base config keeps
    one ``key: value`` a line, configs/ablate_gen2_n.yaml)."""
    with open(base_yaml) as f:
        lines = f.read().splitlines(keepends=True)
    ckpt_dir = os.path.join(out_dir, f"ckpt_{cell.replace('+', '_')}")
    keys = dict(overrides)
    keys["epochs"] = epochs
    rewritten = []
    for ln in lines:
        m = re.match(r"^(\s+)([a-z_]+):", ln)
        if m and m.group(2) in keys:
            ln = f"{m.group(1)}{m.group(2)}: {keys.pop(m.group(2))}\n"
        elif m and m.group(2) == "checkpoint_dir":
            ln = f"{m.group(1)}checkpoint_dir: \"{ckpt_dir}\"\n"
        rewritten.append(ln)
    # an override key missing from the base is appended to training:
    if keys:
        out2 = []
        for ln in rewritten:
            out2.append(ln)
            if ln.startswith("training:"):
                for k, v in keys.items():
                    out2.append(f"  {k}: {v}\n")
        rewritten = out2
    path = os.path.join(out_dir, f"{cell.replace('+', '_')}.yaml")
    with open(path, "w") as f:
        f.write("".join(rewritten))
    return path


def parse_metrics(output: str) -> dict:
    """The metrics ``torch_evaluate.py`` prints a line each (the greedy
    precision and recall, the COCO mAPs and ARs), by the JAX script's
    pattern."""
    metrics = {}
    for line in output.splitlines():
        m = METRIC_RE.match(line)
        if m:
            metrics[m.group(1)] = float(m.group(2))
    return metrics


def run_cell(cfg_path: str, log_path: str, device: str) -> dict:
    with open(log_path, "w") as log:
        r = subprocess.run(
            [sys.executable, os.path.join(REPO, "scripts", "torch_train.py"),
             "--config", cfg_path, "--mode", "single", "--device", device],
            stdout=log, stderr=subprocess.STDOUT, cwd=REPO)
        if r.returncode != 0:
            raise RuntimeError(f"train failed for {cfg_path}, see {log_path}")
        r = subprocess.run(
            [sys.executable,
             os.path.join(REPO, "scripts", "torch_evaluate.py"),
             "--config", cfg_path, "--coco_map", "--device", device],
            capture_output=True, text=True, cwd=REPO)
        log.write(r.stdout + r.stderr)
    if r.returncode != 0:
        raise RuntimeError(f"evaluate failed for {cfg_path}:\n{r.stdout}"
                           f"\n{r.stderr}")
    return parse_metrics(r.stdout)


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--base", default="configs/ablate_gen2_n.yaml")
    p.add_argument("--epochs", type=int, default=60)
    p.add_argument("--out", default="dataset_gen2/experiments/ablate_torch")
    p.add_argument("--cells", default=None,
                   help="comma-separated subset (default: all)")
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = p.parse_args(argv)

    os.makedirs(args.out, exist_ok=True)
    cells = (args.cells.split(",") if args.cells else list(CELLS))
    results_path = os.path.join(args.out, "ablation.json")
    results = {}
    if os.path.exists(results_path):   # resumable across interruptions
        with open(results_path) as f:
            results = json.load(f)

    for cell in cells:
        if cell in results:
            print(f"[ablate] {cell}: cached {results[cell]}")
            continue
        cfg = write_cell_config(args.base, cell, CELLS[cell], args.epochs,
                                args.out)
        log = os.path.join(args.out, f"{cell.replace('+', '_')}.log")
        print(f"[ablate] {cell}: training ({cfg}) → {log}", flush=True)
        metrics = run_cell(cfg, log, args.device)
        results[cell] = metrics
        with open(results_path, "w") as f:
            json.dump(results, f, indent=1)
        print(f"[ablate] {cell}: {metrics}", flush=True)

    hdr = ["cell", "mAP_50_95", "mAP_50", "mAP_75"]
    print("\n| " + " | ".join(hdr) + " |")
    print("|" + "---|" * len(hdr))
    for cell in cells:
        r = results.get(cell, {})
        print(f"| {cell} | " + " | ".join(
            f"{r.get(k, float('nan')):.4f}" for k in hdr[1:]) + " |")
    return results


if __name__ == "__main__":
    main()
