#!/usr/bin/env python
"""The quality gate of the PyTorch port: build the gen2 fixture, train the
``n`` and ``x`` quality recipes and score them, with the port's own
command-line entry points, each a child process on the card; then export
the ``n`` model's fused EMA weights and hold the artifact to
``Detector.serve`` on a validation batch.

    python scripts/torch_quality_gate.py [--models n x] [--seed S]
        [--out DIR]

The commands it runs, in order (``--seed`` adds ``--seed S`` to both
trainings and writes the checkpoints under ``seed_S/``):

    torch_make_fixture.py --root dataset_gen2 --images 256 --size 640 --seed 2
    torch_train.py --config configs/quality_gen2_n.yaml --mode single
    torch_evaluate.py --config configs/quality_gen2_n.yaml \\
        --checkpoint dataset_gen2/experiments/quality_ckpt --coco_map
    torch_train.py --config configs/quality_gen2_x.yaml --mode single --epochs 40
    torch_evaluate.py --config configs/quality_gen2_x.yaml --checkpoint \\
        dataset_gen2/experiments/x_quality_checkpoints/model_epoch_39 \\
        --coco_map --conf_threshold 0.001

The ``n`` run is scored as ``scripts/ablate_quality.py`` scored the
reference run (the latest checkpoint, the evaluate CLI's default
threshold). Each child's output goes to ``<out>/<step>.log``; the last
line is a JSON object with every step's seconds, the epochs' seconds, the
scores against the gates (0.85 of each reference: n 0.3366, x 0.2962 val
COCO mAP@50:95) and the export check, beside the card's name and power
limit. The checkpoints stay under ``dataset_gen2/experiments`` (~0.9 GB an
``x`` epoch), not in ``<out>``.
"""

import argparse
import json
import os
import re
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if sys.path and os.path.abspath(sys.path[0] or ".") == os.path.join(
        REPO, "scripts"):
    sys.path[0] = REPO
elif REPO not in sys.path:
    sys.path.insert(0, REPO)

ROOT = "dataset_gen2"
# reference val COCO mAP@50:95 (docs/PERF.md:271, :387) and the share of
# it a gate needs: one TPU run each, seed spread ±15% on this fixture
REFERENCE = {"n": 0.3366, "x": 0.2962}
MARGIN = 0.85
RECIPES = {
    "n": {"config": "configs/quality_gen2_n.yaml",
          "checkpoint": "dataset_gen2/experiments/quality_ckpt",
          "train": [], "evaluate": []},
    "x": {"config": "configs/quality_gen2_x.yaml",
          "checkpoint": "dataset_gen2/experiments/x_quality_checkpoints",
          "epoch": 39, "train": ["--epochs", "40"],
          "evaluate": ["--conf_threshold", "0.001"]},
}
EPOCH_RE = re.compile(r"epoch (\d+): .*\(([0-9.]+)s\)")
RESULTS = "[INFO] results: "
EXPORT_BATCH = 8


def card_line() -> str:
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip()
    except (OSError, subprocess.TimeoutExpired):
        return "nvidia-smi unavailable"


def run(script: str, args, log_path: str) -> tuple:
    """One CLI as a child process from the repository root; its output to
    ``log_path``. Returns (seconds, output); raises on a non-zero exit."""
    cmd = [sys.executable, os.path.join(REPO, "scripts", script),
           *map(str, args)]
    t0 = time.perf_counter()
    with open(log_path, "w") as log:
        log.write(" ".join(cmd) + "\n")
        log.flush()
        proc = subprocess.run(cmd, cwd=REPO, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
        log.write(proc.stdout)
    seconds = time.perf_counter() - t0
    print(f"[gate] {script} {' '.join(map(str, args))}: exit "
          f"{proc.returncode} in {seconds:.1f} s", flush=True)
    if proc.returncode != 0:
        print(proc.stdout[-6000:], flush=True)
        raise SystemExit(f"{script} failed (log: {log_path})")
    return seconds, proc.stdout


def results_of(output: str) -> dict:
    lines = [ln for ln in output.splitlines() if ln.startswith(RESULTS)]
    if not lines:
        raise SystemExit("the evaluate CLI printed no results line")
    return json.loads(lines[-1][len(RESULTS):])


def gate(name: str, seed, out: str) -> dict:
    recipe = RECIPES[name]
    ckpt = recipe["checkpoint"]
    if seed is not None:
        ckpt = os.path.join(ckpt, f"seed_{seed}")
    train_args = ["--config", recipe["config"], "--mode", "single",
                  "--device", "cuda", "--checkpoint_dir", ckpt,
                  *recipe["train"]]
    if seed is not None:
        train_args += ["--seed", seed]
    train_s, train_out = run("torch_train.py", train_args,
                             os.path.join(out, f"train_{name}.log"))
    epochs = {int(e): float(s) for e, s in EPOCH_RE.findall(train_out)}
    where = ckpt if "epoch" not in recipe else os.path.join(
        ckpt, f"model_epoch_{recipe['epoch']}")
    eval_s, eval_out = run(
        "torch_evaluate.py", ["--config", recipe["config"], "--checkpoint",
                              where, "--coco_map", "--device", "cuda",
                              *recipe["evaluate"]],
        os.path.join(out, f"evaluate_{name}.log"))
    scores = results_of(eval_out)
    m = scores["coco"]["mAP_50_95"]
    threshold = MARGIN * REFERENCE[name]
    result = {"train_s": train_s, "evaluate_s": eval_s,
              "epochs_run": len(epochs),
              "epoch_s_median": sorted(epochs.values())[len(epochs) // 2]
              if epochs else None,
              "epoch_s_first": epochs.get(0), "checkpoint": where,
              "seed": seed, "scores": scores, "reference": REFERENCE[name],
              "gate": threshold, "passed": m is not None and m >= threshold}
    print(f"[gate] {name}: mAP@50:95 {m} against the gate {threshold} "
          f"({'passed' if result['passed'] else 'MISSED'}) | "
          f"{card_line()}", flush=True)
    return result


def export_check(where: str, out: str) -> dict:
    """The n model's fused EMA weights, exported at B=8 on the card,
    called on the first 8 validation images and held to ``serve``."""
    import numpy as np
    import torch

    from custom_yolo_tpu_torch import Detector
    from custom_yolo_tpu_torch.config import Config
    from custom_yolo_tpu_torch.export import export_serving, load_exported
    from custom_yolo_tpu_torch.models.detector import preprocess_image
    from custom_yolo_tpu_torch.utils.checkpoint import (find_weights,
                                                        restore_variables)
    from custom_yolo_tpu_torch.utils.profiling import kernel_launches

    cfg = Config.from_yaml(RECIPES["n"]["config"])
    kind, root, epoch = find_weights(where)
    if kind != "state":
        raise SystemExit(f"no train state under {where}")
    variables, _, which = restore_variables(root, epoch)
    det = Detector(cfg.model.width, cfg.model.depth, cfg.model.csp,
                   cfg.model.num_classes, reg_max=cfg.model.reg_max,
                   precision=cfg.training.sharding.precision,
                   input_size=tuple(cfg.model.input_size), device="cuda")
    det.load_variables(variables)
    det.fuse()
    val_dir = cfg.data.val_images
    names = sorted(os.listdir(val_dir))[:EXPORT_BATCH]
    batch = torch.from_numpy(np.concatenate([
        preprocess_image(os.path.join(val_dir, n), det.input_size)
        for n in names]))
    kw = dict(conf_thres=0.001)
    t0 = time.perf_counter()
    path = export_serving(det, os.path.join(out, "export_n"),
                          batch_size=EXPORT_BATCH, **kw)
    export_s = time.perf_counter() - t0
    server = load_exported(path)
    want = det.serve(batch, **kw)
    before = kernel_launches()
    got = server(batch)
    torch.cuda.synchronize()
    after = kernel_launches()
    equal = {f: bool(torch.equal(getattr(got, f), getattr(want, f)))
             for f in got._fields}
    result = {"epoch": epoch, "weights": which, "export_s": export_s,
              "artifact_mb": os.path.getsize(os.path.join(path,
                                                          "serving.pt2"))
              / 2 ** 20,
              "equal": equal,
              "max_box_gap_px": float((got.boxes - want.boxes).abs().max()),
              "num_valid": want.num_valid.tolist(),
              "above_0.25": int((want.valid & (want.scores > 0.25)).sum()),
              "artifact_launches": {k: after[k] - before[k] for k in after
                                    if after[k] != before[k]}}
    # the artifact itself is large: keep only its manifest
    os.remove(os.path.join(path, "serving.pt2"))
    print(f"[gate] export n B={EXPORT_BATCH}: {json.dumps(result)} | "
          f"{card_line()}", flush=True)
    if not all(equal.values()):
        raise SystemExit("the exported n model differs from serve")
    return result


def main(argv=None):
    p = argparse.ArgumentParser(description="quality gate of the port")
    p.add_argument("--models", nargs="+", default=["n", "x"],
                   choices=list(RECIPES))
    p.add_argument("--seed", type=int, default=None,
                   help="override project.seed of both trainings")
    p.add_argument("--out", default=os.path.join(
                       REPO, "dataset_gen2/experiments/quality_gate"),
                   help="where the children's logs and the export go")
    p.add_argument("--skip_fixture", action="store_true",
                   help="reuse an existing dataset_gen2")
    args = p.parse_args(argv)
    out = os.path.abspath(args.out)
    # the recipes' configs, data and checkpoints are paths relative to the
    # repository, for this process as for its children
    os.chdir(REPO)
    os.makedirs(out, exist_ok=True)
    summary = {"card": card_line(), "steps": {}}
    if not args.skip_fixture:
        summary["steps"]["fixture_s"], _ = run(
            "torch_make_fixture.py", ["--root", ROOT, "--images", 256,
                                      "--size", 640, "--seed", 2],
            os.path.join(out, "fixture.log"))
    for name in args.models:
        summary[name] = gate(name, args.seed, out)
        if name == "n":
            summary["export_n"] = export_check(summary["n"]["checkpoint"],
                                               out)
    summary["card"] = card_line()
    print(json.dumps(summary), flush=True)


if __name__ == "__main__":
    main()
