#!/usr/bin/env python
"""Tiny-fixture training smoke run of the PyTorch port (counterpart of
``examples/train_smoke.py``): a few train steps of a preset, from the
config's data or, with ``--synthetic``, from the JAX example's seeded
random batch (random images and boxes, the full train step all the same).

Usage:
  python examples/torch_train_smoke.py --synthetic --preset n \\
      --input_size 640 --batch_size 4 --steps 25 [--device cpu]
"""

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def synthetic_batch(batch_size, size, num_classes):
    """The JAX example's ``RandomState(0)`` batch (16 box slots) as numpy
    arrays."""
    import numpy as np

    rng = np.random.RandomState(0)
    b, g = batch_size, 16
    return {
        "images": rng.rand(b, *size, 3).astype(np.float32),
        "gt_boxes": (rng.rand(b, g, 4) * size[0] / 2 + 20).astype(
            np.float32),
        "gt_labels": rng.randint(0, num_classes, (b, g)).astype(np.int32),
        "gt_mask": rng.rand(b, g) > 0.5,
    }


def main(argv=None):
    """Run the steps; returns each step's metrics as floats."""
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--config", default="configs/config.yaml")
    p.add_argument("--preset", default="n")
    p.add_argument("--synthetic", action="store_true")
    p.add_argument("--steps", type=int, default=25)
    p.add_argument("--batch_size", type=int, default=4)
    p.add_argument("--input_size", type=int, default=640)
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = p.parse_args(argv)

    import torch

    from custom_yolo_tpu_torch.config import Config
    from custom_yolo_tpu_torch.models.detector import create_train_model
    from custom_yolo_tpu_torch.models.presets import PRESETS
    from custom_yolo_tpu_torch.train.losses import DetectionLoss, LossConfig
    from custom_yolo_tpu_torch.train.optim import build_optimizer
    from custom_yolo_tpu_torch.train.train_state import TrainState
    from custom_yolo_tpu_torch.train.train_step import make_train_step
    from custom_yolo_tpu_torch.utils.profiling import kernel_launches

    cfg = Config.from_yaml(args.config)
    preset = PRESETS[args.preset]
    device = torch.device(args.device)
    nc = cfg.model.num_classes
    model = create_train_model(preset["width"], preset["depth"],
                               preset["csp"], nc,
                               precision=cfg.training.sharding.precision,
                               device=device, seed=0)
    optimizer = build_optimizer(model.parameters(), cfg.training)
    state = TrainState.create(model, optimizer,
                              torch.Generator().manual_seed(1))
    loss_fn = DetectionLoss(LossConfig(num_classes=nc,
                                       assigner=cfg.training.assigner))
    step = make_train_step(model, loss_fn, optimizer)
    size = (args.input_size, args.input_size)

    if args.synthetic:
        batch = {k: torch.from_numpy(v).to(device) for k, v in
                 synthetic_batch(args.batch_size, size, nc).items()}
        batches = lambda: (batch for _ in range(args.steps))
    else:
        from custom_yolo_tpu_torch.data.dataset import DetectionDataset
        from custom_yolo_tpu_torch.data.loader import DataLoader
        from custom_yolo_tpu_torch.data.transforms import make_device_batch
        ds = DetectionDataset(
            os.path.join(cfg.data.processed_dir, cfg.data.train_parquet),
            cfg.data.train_images, input_size=size, is_test=True,
            max_gt=cfg.data.max_gt_boxes)
        loader = DataLoader(ds, args.batch_size, shuffle=True,
                            drop_last=True, num_workers=4)

        def batches():
            gen = torch.Generator(device=device)
            for i, hb in enumerate(loader):
                gen.manual_seed(i)
                yield make_device_batch(hb, gen, device)

    t0 = time.time()
    n = 0
    history = []
    for i, batch in enumerate(batches()):
        state, metrics = step(state, batch)
        history.append(metrics)
        n += 1
        if i % 5 == 0:
            m = {k: float(v) for k, v in metrics.items()}
            print(f"step {i}: total={m['total_loss']:.3f} "
                  f"box={m['box_loss']:.3f} "
                  f"cls={m['cls_loss']:.3f}")
        if n >= args.steps:
            break
    history = [{k: float(v) for k, v in m.items()} for m in history]
    dt = time.time() - t0
    print(f"{n} steps, {n / dt:.2f} it/s, "
          f"{n * args.batch_size / dt:.1f} img/s")
    print(f"[INFO] kernel launches: {json.dumps(kernel_launches())}",
          flush=True)
    return history


if __name__ == "__main__":
    main()
