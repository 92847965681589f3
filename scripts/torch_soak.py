#!/usr/bin/env python
"""COCO-scale soak of the PyTorch port (counterpart of ``scripts/soak.py``):
the ETL → loader → trainer → eval chain at real-COCO scale (118k images,
~860k annotations) on a procedurally generated dataset of that size, each
phase's wall-clock and peak RSS recorded.

Phases (independently runnable, ``--phases gen,etl,loader,train,eval``):

  gen        118k train + 5k val JPEGs at COCO-like sizes (worker
             processes); the same files as the JAX script writes
  etl        streaming COCO-JSON → parquet (the port's ETL)
  loader     loader-only throughput at 640² (decode + host batching)
  train      ≥1k real train steps of the x preset at 640² on the live
             loader (``Trainer._device_batches`` + ``train_step``)
  fit_chunk  one resumable chunk of training from a config
             (``configs/soak_coco_scale.yaml``): restore the latest
             checkpoint, train ``--steps`` steps, save, exit
  eval       COCO mAP over 5k seeded val images (the evaluator alone)

The phase functions take the preset, input size and image or step counts
as keyword arguments (the JAX script's values by default) and ``device``
(``cuda``, with no fallback to the CPU, or ``cpu``).

Usage (the host phases first, then the card's):
  python scripts/torch_soak.py --root <dir> --phases gen,etl,loader
  python scripts/torch_soak.py --root <dir> --phases train,eval
  python scripts/torch_soak.py --phases fit_chunk --steps 3000
"""

import argparse
import json
import multiprocessing as mp
import os
import resource
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# the repository root in place of this script's directory, whose
# profile.py would shadow the standard library's (torch imports it)
if sys.path and os.path.abspath(sys.path[0] or ".") == os.path.join(
        REPO, "scripts"):
    sys.path[0] = REPO
elif REPO not in sys.path:
    sys.path.insert(0, REPO)

NUM_CLASSES = 80          # COCO's class count
ANNS_PER_IMG = 7.3        # COCO-2017 train has ~860k anns / 118k imgs


def _peak_rss_mb():
    return resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 1024


def _rss_mb():
    """The resident set now (Linux's VmRSS), or None elsewhere."""
    try:
        with open("/proc/self/status") as f:
            for line in f:
                if line.startswith("VmRSS:"):
                    return int(line.split()[1]) / 1024
    except OSError:
        pass
    return None


def _class_colors(n):
    import colorsys
    return [tuple(int(c * 255) for c in colorsys.hsv_to_rgb(
        i / max(n, 1), 0.9, 0.9)) for i in range(n)]


def _gen_chunk(task):
    """Worker: render a contiguous range of images, return their metadata
    (the JAX script's generator, draw for draw)."""
    (split, start, count, img_dir, seed) = task
    from PIL import Image
    rng = np.random.RandomState(seed)
    colors = _class_colors(NUM_CLASSES)
    images, annotations = [], []
    for i in range(start, start + count):
        w = int(rng.randint(320, 641))
        h = int(rng.randint(240, 481))
        name = f"{split}_{i:06d}.jpg"
        img = np.full((h, w, 3), 30, np.uint8)
        n_ann = int(rng.poisson(ANNS_PER_IMG - 1)) + 1
        anns = []
        for _ in range(n_ann):
            bw = int(rng.randint(8, max(9, w // 2)))
            bh = int(rng.randint(8, max(9, h // 2)))
            x = int(rng.randint(0, max(1, w - bw)))
            y = int(rng.randint(0, max(1, h - bh)))
            cid = int(rng.randint(0, NUM_CLASSES))
            jitter = rng.randint(-15, 16, 3)
            color = np.clip(np.asarray(colors[cid]) + jitter, 0, 255)
            img[y:y + bh, x:x + bw] = color.astype(np.uint8)
            anns.append({
                "image_id": i + 1, "category_id": 100 + cid,
                "bbox": [float(x), float(y), float(bw), float(bh)],
                "area": float(bw * bh), "iscrowd": 0,
                "segmentation": [[float(x), float(y), float(x + bw),
                                  float(y), float(x + bw), float(y + bh)]],
            })
        Image.fromarray(img).save(os.path.join(img_dir, name), quality=85)
        images.append({"id": i + 1, "file_name": name,
                       "height": h, "width": w})
        annotations.extend(anns)
    return images, annotations


def phase_gen(root, train_images, val_images, workers):
    """Render both splits in chunks of 500 images over ``workers``
    processes. The chunks' results are taken in chunk order, so the
    annotation ids do not depend on which worker finishes first (the JAX
    script takes them as they finish; its files equal these whenever its
    chunks finish in order, as a split of one chunk always does). The
    workers are forked: they run numpy and PIL only, never CUDA, and
    reach ``_gen_chunk`` also where this script is imported rather than
    run."""
    ann_dir = os.path.join(root, "raw", "annotations")
    os.makedirs(ann_dir, exist_ok=True)
    categories = [{"id": 100 + i, "name": f"class_{i:02d}",
                   "supercategory": "synthetic"}
                  for i in range(NUM_CLASSES)]
    stats = {}
    for split, n in (("train", train_images), ("val", val_images)):
        img_dir = os.path.join(root, "raw", "images", split)
        os.makedirs(img_dir, exist_ok=True)
        chunk = 500
        tasks = [(split, s, min(chunk, n - s), img_dir, 1000 + s)
                 for s in range(0, n, chunk)]
        t0 = time.time()
        images, annotations = [], []
        with mp.get_context("fork").Pool(workers) as pool:
            for imgs, anns in pool.imap(_gen_chunk, tasks):
                images.extend(imgs)
                annotations.extend(anns)
        for j, a in enumerate(annotations):
            a["id"] = j + 1
        images.sort(key=lambda r: r["id"])
        with open(os.path.join(ann_dir, f"instances_{split}2017.json"),
                  "w") as f:
            json.dump({"images": images, "annotations": annotations,
                       "categories": categories}, f)
        with open(os.path.join(ann_dir, f"stuff_{split}2017.json"),
                  "w") as f:
            json.dump({"images": [], "annotations": [],
                       "categories": []}, f)
        dt = time.time() - t0
        stats[split] = {"images": len(images), "annotations": len(annotations),
                        "wall_s": round(dt, 1),
                        "img_per_s": round(len(images) / dt, 1)}
        print(f"[gen] {split}: {stats[split]}", flush=True)
    return stats


def phase_etl(root):
    from custom_yolo_tpu_torch.data.preprocess import DataPreprocess
    ann_dir = os.path.join(root, "raw", "annotations")
    out_dir = os.path.join(root, "processed", "parquet")
    stats = {}
    for split in ("train", "val"):
        t0 = time.time()
        # the process before the split (imports included), which its peak
        # rises from
        before = _rss_mb()
        DataPreprocess.create_parquet_data(
            annotations_dir=ann_dir, output_dir=out_dir, output_folder=split,
            file_names=[f"instances_{split}2017.json"],
            keys=["images", "annotations", "categories"],
            columns=[["id", "file_name", "height", "width"],
                     ["id", "image_id", "category_id", "bbox", "area",
                      "iscrowd", "segmentation"],
                     ["id", "name", "supercategory"]],
            chunk_sizes=[10_000, 50_000, 1_000], is_test=False)
        stats[split] = {"wall_s": round(time.time() - t0, 1),
                        "rss_before_mb": None if before is None
                        else round(before, 1),
                        "peak_rss_mb": round(_peak_rss_mb(), 1)}
        print(f"[etl] {split}: {stats[split]}", flush=True)
    return stats


def _make_config(root, batch_size, workers, input_size=640):
    from custom_yolo_tpu_torch.config import Config
    cfg = Config.from_yaml(os.path.join(REPO, "configs", "config.yaml"))
    cfg.data.processed_dir = os.path.join(root, "processed", "parquet")
    cfg.data.train_parquet = "train"
    cfg.data.val_parquet = "val"
    cfg.data.train_images = os.path.join(root, "raw", "images", "train")
    cfg.data.val_images = os.path.join(root, "raw", "images", "val")
    cfg.data.num_workers = workers
    cfg.model.input_size = [input_size, input_size]
    cfg.training.batch_size = batch_size
    cfg.training.is_test = False
    return cfg


def phase_loader(root, batch_size, workers, n_batches=200, input_size=640):
    from custom_yolo_tpu_torch.data.loader import get_data_loaders
    cfg = _make_config(root, batch_size, workers, input_size)
    train_loader, _ = get_data_loaders(cfg)
    it = iter(train_loader)
    # warm up worker pool + first prefetch window
    next(it)
    t0 = time.time()
    n = 0
    for _ in range(n_batches):
        try:
            batch = next(it)
        except StopIteration:
            it = iter(train_loader)
            batch = next(it)
        n += batch["image"].shape[0]
    dt = time.time() - t0
    stats = {"batches": n_batches, "images": n, "wall_s": round(dt, 1),
             "img_per_s": round(n / dt, 1),
             "peak_rss_mb": round(_peak_rss_mb(), 1),
             "dataset_len": len(train_loader.dataset)}
    print(f"[loader] {stats}", flush=True)
    return stats


def phase_train(root, batch_size, workers, steps, preset="x",
                input_size=640, device="cuda"):
    import torch

    from custom_yolo_tpu_torch.data.loader import get_data_loaders
    from custom_yolo_tpu_torch.models.detector import create_train_model
    from custom_yolo_tpu_torch.models.presets import PRESETS
    from custom_yolo_tpu_torch.train.trainer import Trainer

    cfg = _make_config(root, batch_size, workers, input_size)
    # category ids are 100..100+NUM_CLASSES-1 and the dataset uses raw ids
    # as labels (reference quirk) — the class axis must cover them
    cfg.model.num_classes = 100 + NUM_CLASSES
    p = PRESETS[preset]
    model = create_train_model(p["width"], p["depth"], p["csp"],
                               cfg.model.num_classes, precision="bfloat16",
                               device=torch.device(device), seed=0)
    trainer = Trainer(cfg, model)
    train_loader, _ = get_data_loaders(cfg)

    seed = 7
    batches = trainer._device_batches(train_loader, seed, 0, train=True)
    # first launches and allocator growth on the first batch
    _, _, batch = next(batches)
    trainer.state, metrics = trainer.train_step(trainer.state, batch)
    float(metrics["total_loss"])
    t0 = time.time()
    t_win = t0
    n = 0
    losses = []
    for i in range(steps):
        try:
            _, _, batch = next(batches)
        except StopIteration:  # epoch boundary — restart the loader
            batches = trainer._device_batches(train_loader, seed, 0,
                                              train=True)
            _, _, batch = next(batches)
        trainer.state, metrics = trainer.train_step(trainer.state, batch)
        n += batch_size
        if (i + 1) % 100 == 0:
            loss = float(metrics["total_loss"])
            losses.append(round(loss, 4))
            now = time.time()
            win = 100 * batch_size / (now - t_win)
            t_win = now
            print(f"[train] step {i+1}/{steps} loss={loss:.4f} "
                  f"({n / (now - t0):.1f} img/s cum, {win:.1f} window, "
                  f"rss {_peak_rss_mb():.0f} MB)", flush=True)
    float(metrics["total_loss"])
    dt = time.time() - t0
    stats = {"steps": steps, "batch": batch_size, "wall_s": round(dt, 1),
             "img_per_s": round(n / dt, 1), "losses_per_100": losses,
             "peak_rss_mb": round(_peak_rss_mb(), 1)}
    print(f"[train] {stats}", flush=True)
    return stats


def phase_fit_chunk(steps, config_path="configs/soak_coco_scale.yaml",
                    device="cuda"):
    """One resumable chunk of COCO-scale training: restore the latest
    checkpoint (if any), run ``steps`` real train steps on the live
    loader, save a new checkpoint, exit. Every chunk is a full
    crash-and-resume cycle through ``utils/checkpoint.py``. Drive with::

        for i in $(seq 1 N); do
            python scripts/torch_soak.py --phases fit_chunk --steps 3000
        done
        python scripts/torch_evaluate.py \\
            --config configs/soak_coco_scale.yaml --coco_map
    """
    import torch

    from custom_yolo_tpu_torch.config import Config
    from custom_yolo_tpu_torch.data.loader import get_data_loaders
    from custom_yolo_tpu_torch.models.detector import create_train_model
    from custom_yolo_tpu_torch.train.trainer import Trainer
    from custom_yolo_tpu_torch.utils.checkpoint import CheckpointManager

    cfg = Config.from_yaml(config_path)
    model = create_train_model(
        cfg.model.width, cfg.model.depth, cfg.model.csp,
        cfg.model.num_classes, reg_max=cfg.model.reg_max,
        precision=cfg.training.sharding.precision,
        device=torch.device(device), seed=cfg.project.seed)
    trainer = Trainer(cfg, model)
    ckpt = CheckpointManager(cfg.checkpoint.checkpoint_dir, max_to_keep=3)
    chunk = ckpt.latest_epoch()
    if chunk is not None:
        trainer.load_state(ckpt.restore(trainer.state))
        print(f"[fit] resumed chunk {chunk} "
              f"(global step {int(trainer.state.step)})", flush=True)
    chunk = -1 if chunk is None else chunk

    train_loader, _ = get_data_loaders(cfg)
    seed = cfg.project.seed + chunk + 1
    batches = trainer._device_batches(train_loader, seed, 0, train=True)
    _, _, batch = next(batches)
    trainer.state, metrics = trainer.train_step(trainer.state, batch)
    float(metrics["total_loss"])
    t0 = time.time()
    losses = []
    for i in range(steps - 1):
        try:
            _, _, batch = next(batches)
        except StopIteration:
            batches = trainer._device_batches(train_loader, seed, 0,
                                              train=True)
            _, _, batch = next(batches)
        trainer.state, metrics = trainer.train_step(trainer.state, batch)
        if (i + 2) % 500 == 0:
            loss = float(metrics["total_loss"])
            losses.append(round(loss, 4))
            rate = (i + 2) * cfg.training.batch_size / (time.time() - t0)
            print(f"[fit] chunk {chunk + 1} step {i+2}/{steps} "
                  f"loss={loss:.4f} ({rate:.1f} img/s, "
                  f"rss {_peak_rss_mb():.0f} MB)", flush=True)
    final_loss = float(metrics["total_loss"])
    dt = time.time() - t0
    ckpt.save(chunk + 1, trainer.state)
    ckpt.wait()
    ckpt.close()
    stats = {"chunk": chunk + 1, "steps": steps,
             "global_step": int(trainer.state.step),
             "images_seen": int(trainer.state.step)
             * cfg.training.batch_size,
             "batch": cfg.training.batch_size,
             "wall_s": round(dt, 1),
             "img_per_s": round(steps * cfg.training.batch_size / dt, 1),
             "losses_per_500": losses,
             "final_loss": final_loss,
             "peak_rss_mb": round(_peak_rss_mb(), 1)}
    print(f"[fit] {stats}", flush=True)
    return stats


def phase_eval(root, batch_size, workers, n_images=5000):
    """Full-protocol COCO mAP over seeded val images: the evaluator
    (``eval/coco_map.py``) at the 5k-image scale, on the host."""
    from custom_yolo_tpu_torch.eval.coco_map import COCOmAP

    rng = np.random.RandomState(0)
    n_classes = 172
    evaluator = COCOmAP(num_classes=n_classes)
    t0 = time.time()
    for i in range(n_images):
        # GT: (M, 5) [cx, cy, w, h, cls]; dets near GT so matching does
        # real greedy work (all-miss scenes would flatter the timing)
        n_gt = rng.randint(1, 12)
        gt = np.zeros((n_gt, 5), np.float32)
        gt[:, :2] = rng.rand(n_gt, 2) * 300 + 50
        gt[:, 2:4] = rng.rand(n_gt, 2) * 80 + 12
        gt[:, 4] = rng.randint(0, n_classes, n_gt)
        n_det = rng.randint(0, 40)
        det = np.zeros((n_det, 5), np.float32)
        src = rng.randint(0, n_gt, n_det)
        det[:, :4] = gt[src, :4] + rng.randn(n_det, 4) * 8
        det[:, 2:4] = np.abs(det[:, 2:4]) + 4
        det[:, 4] = np.where(rng.rand(n_det) < 0.8, gt[src, 4],
                             rng.randint(0, n_classes, n_det))
        scores = rng.rand(n_det).astype(np.float32)
        evaluator.update(det, scores, gt, np.zeros(n_gt, bool))
    t_update = time.time() - t0
    t0 = time.time()
    res = evaluator.compute()
    t_compute = time.time() - t0
    stats = {"images": n_images, "classes": n_classes,
             "update_wall_s": round(t_update, 1),
             "compute_wall_s": round(t_compute, 1),
             "total_wall_s": round(t_update + t_compute, 1),
             "map_50_95": round(float(res["mAP_50_95"]), 4),
             "peak_rss_mb": round(_peak_rss_mb(), 1)}
    print(f"[eval] {stats}", flush=True)
    return stats


def main(argv=None):
    """Run the phases; returns every result in ``--out`` (resumed)."""
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--root", default="soak_data")
    p.add_argument("--train_images", type=int, default=118287)
    p.add_argument("--val_images", type=int, default=5000)
    p.add_argument("--workers", type=int, default=max(4, os.cpu_count() - 2))
    p.add_argument("--batch_size", type=int, default=16)
    p.add_argument("--steps", type=int, default=1000)
    p.add_argument("--phases", default="gen,etl,loader")
    p.add_argument("--fit_config", default="configs/soak_coco_scale.yaml")
    p.add_argument("--out", default=None,
                   help="resumable results JSON (default: "
                        "<root>/soak_stats.json)")
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = p.parse_args(argv)
    out = args.out or os.path.join(args.root, "soak_stats.json")

    from custom_yolo_tpu_torch.utils.profiling import kernel_launches

    results = {}
    if os.path.exists(out):
        with open(out) as f:
            results = json.load(f)
    for phase in args.phases.split(","):
        phase = phase.strip()
        t0 = time.time()
        if phase == "gen":
            results["gen"] = phase_gen(args.root, args.train_images,
                                       args.val_images, args.workers)
        elif phase == "etl":
            results["etl"] = phase_etl(args.root)
        elif phase == "loader":
            results["loader"] = phase_loader(args.root, args.batch_size,
                                             args.workers)
        elif phase == "train":
            results["train"] = phase_train(args.root, args.batch_size,
                                           args.workers, args.steps,
                                           device=args.device)
        elif phase == "fit_chunk":
            results.setdefault("fit_chunks", []).append(
                phase_fit_chunk(args.steps, args.fit_config,
                                device=args.device))
        elif phase == "eval":
            results["eval"] = phase_eval(args.root, args.batch_size,
                                         args.workers)
        else:
            raise SystemExit(f"unknown phase {phase}")
        print(f"[soak] phase {phase} done in {time.time() - t0:.1f}s",
              flush=True)
        os.makedirs(os.path.dirname(os.path.abspath(out)), exist_ok=True)
        with open(out, "w") as f:
            json.dump(results, f, indent=1)
    print(json.dumps(results))
    print(f"[INFO] kernel launches: {json.dumps(kernel_launches())}",
          flush=True)
    return results


if __name__ == "__main__":
    main()
