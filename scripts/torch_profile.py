#!/usr/bin/env python
"""Capture a ``torch.profiler`` trace of the training step (counterpart of
``scripts/profile.py``) into ``project.profile_dir/trace.json``, a Chrome
trace of the CPU's and the card's activity (Perfetto,
``chrome://tracing``), digested by ``scripts/torch_analyze_profile.py``.

The step is the port's (``create_train_model``, ``build_optimizer``,
``TrainState.create``, ``make_train_step``) on the JAX script's seeded
synthetic batch. One warm-up step runs outside the capture. The phases
and layers the digest reads are the port's own spans: the step's
(``train/step``, ``train/forward``, ``train/loss``, ``train/backward``,
``train/clip``, ``train/optimizer``, ``train/ema``) and each model
stage's (``fwd/net.<stage>``, ``fwd/fpn.<stage>``, ``fwd/head``); the
backward and optimizer carry autograd's and torch.optim's own too.

Usage:
  python scripts/torch_profile.py --config configs/config.yaml --preset x \\
      --batch_size 8 --assigner tal --steps 3 [--device cpu]
  python scripts/torch_analyze_profile.py --dir <profile_dir> --steps 3
"""

import argparse
import json
import os
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# the repository root in place of this script's directory, whose
# profile.py would shadow the standard library's (torch imports it)
if sys.path and os.path.abspath(sys.path[0] or ".") == os.path.join(
        REPO, "scripts"):
    sys.path[0] = REPO
elif REPO not in sys.path:
    sys.path.insert(0, REPO)


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--config", default="configs/config.yaml")
    p.add_argument("--steps", type=int, default=3)
    p.add_argument("--batch_size", type=int, default=8)
    p.add_argument("--preset", default=None,
                   help="model preset override (n/s/m/l/x)")
    p.add_argument("--assigner", default=None, choices=["nearest", "tal"],
                   help="loss assigner override (default: nearest)")
    p.add_argument("--max_gt", type=int, default=None)
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    return p.parse_args(argv)


def synthetic_batch(batch_size, input_size, max_gt, num_classes):
    """The JAX script's ``RandomState(0)`` batch as numpy arrays."""
    import numpy as np

    rng = np.random.RandomState(0)
    return {
        "images": rng.rand(batch_size, *input_size, 3).astype(np.float32),
        "gt_boxes": (rng.rand(batch_size, max_gt, 4) * 300 + 50).astype(
            np.float32),
        "gt_labels": rng.randint(0, num_classes, (batch_size, max_gt))
        .astype(np.int32),
        "gt_mask": rng.rand(batch_size, max_gt) > 0.7,
    }


def main(argv=None):
    """Trace the steps; returns the profile directory and the last loss."""
    args = parse_args(argv)

    import torch

    from custom_yolo_tpu_torch.config import Config
    from custom_yolo_tpu_torch.models.detector import create_train_model
    from custom_yolo_tpu_torch.models.presets import PRESETS
    from custom_yolo_tpu_torch.train.losses import DetectionLoss, LossConfig
    from custom_yolo_tpu_torch.train.optim import build_optimizer
    from custom_yolo_tpu_torch.train.train_state import TrainState
    from custom_yolo_tpu_torch.train.train_step import make_train_step
    from custom_yolo_tpu_torch.utils.profiling import (kernel_launches,
                                                       serve_graph_stats,
                                                       trace)

    cfg = Config.from_yaml(args.config)
    if args.preset:
        preset = PRESETS[args.preset]
        cfg.model.width = preset["width"]
        cfg.model.depth = preset["depth"]
        cfg.model.csp = preset["csp"]

    device = torch.device(args.device)
    nc = cfg.model.num_classes
    model = create_train_model(
        cfg.model.width, cfg.model.depth, cfg.model.csp, nc,
        reg_max=cfg.model.reg_max,
        precision=cfg.training.sharding.precision, device=device, seed=0)
    optimizer = build_optimizer(model.parameters(), cfg.training)
    state = TrainState.create(model, optimizer,
                              torch.Generator().manual_seed(1))
    loss_fn = DetectionLoss(LossConfig(num_classes=nc,
                                       assigner=args.assigner or "nearest"))
    step = make_train_step(model, loss_fn, optimizer)

    batch = {k: torch.from_numpy(v).to(device) for k, v in synthetic_batch(
        args.batch_size, tuple(cfg.model.input_size),
        args.max_gt or cfg.data.max_gt_boxes, nc).items()}

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    # warm-up (first launches, allocator growth) outside the trace
    state, metrics = step(state, batch)
    sync()

    profile_dir = cfg.project.profile_dir
    os.makedirs(profile_dir, exist_ok=True)
    print(f"[INFO] tracing {args.steps} steps into {profile_dir}")
    with trace(profile_dir, with_flops=True):
        for _ in range(args.steps):
            state, metrics = step(state, batch)
        sync()
    loss = float(metrics["total_loss"])
    print(f"[INFO] done; loss={loss:.4f}. Digest with: python "
          f"scripts/torch_analyze_profile.py --dir {profile_dir} --steps "
          f"{args.steps}")
    print(f"[INFO] kernel launches: {json.dumps(kernel_launches())}",
          flush=True)
    print(f"[INFO] serve graphs: {json.dumps(serve_graph_stats())}",
          flush=True)
    return {"profile_dir": profile_dir, "loss": loss}


if __name__ == "__main__":
    main()
