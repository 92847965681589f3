#!/usr/bin/env python
"""Training entry point of the PyTorch/CUDA port (counterpart of
``scripts/train.py``).

The same command line: ``--mode single|dp|fsdp`` (``ddp`` and ``fsdp2``
are aliases of ``dp`` and ``fsdp``) and ``--device cuda|cpu`` (``cuda`` by
default, with no fallback to the CPU). Under dp and fsdp one process runs
per card, started by ``torchrun`` (whose environment gives the world) or
by hand with ``--coordinator/--num_processes/--process_id``; on the card
the ranks talk over NCCL, on the CPU over gloo. ``--batch_size`` is per
device: each rank loads ``batch_size × devices / processes`` rows of every
global batch. Rank 0 logs, writes the sidecar and the checkpoints (whole,
whatever the mode: any mode resumes them); local rank 0 builds the CUDA
kernels while the others wait. A checkpoint directory's
``model_config.json`` fixes the architecture and precision on resume;
with ``checkpoint.resume_training`` set, training resumes from the latest
checkpoint it finds. The last lines are the last epoch's record
(``[INFO] history: {json}``, rank 0) and each process's kernel launches.

Usage:
  python scripts/torch_train.py --mode single --precision bfloat16 \\
      --batch_size 8
  python scripts/torch_train.py --mode single --load_from_checkpoint <dir>
  torchrun --nproc_per_node 2 scripts/torch_train.py --mode fsdp
"""

import argparse
import json
import os
import sys
import time
import traceback

# the repository root in place of this script's directory, whose
# profile.py would shadow the standard library's (torch imports it)
sys.path[0] = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="detection training (PyTorch)")
    p.add_argument("--config", default="configs/config.yaml")
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    p.add_argument("--mode", required=True,
                   choices=["single", "dp", "fsdp", "ddp", "fsdp2"],
                   help="parallelism mode (ddp = dp, fsdp2 = fsdp)")
    p.add_argument("--coordinator", default=None,
                   help="host:port of rank 0 (else torchrun's "
                        "MASTER_ADDR/MASTER_PORT)")
    p.add_argument("--num_processes", type=int, default=None)
    p.add_argument("--process_id", type=int, default=None)
    p.add_argument("--backend", default=None, choices=["nccl", "gloo"],
                   help="process-group backend (nccl on cuda and gloo on "
                        "cpu by default; gloo on cuda lets ranks share a "
                        "card)")
    p.add_argument("--precision", default=None,
                   choices=["bfloat16", "float16", "float32"])
    p.add_argument("--batch_size", type=int, default=None)
    p.add_argument("--prefetch_factor", type=int, default=None)
    p.add_argument("--dataset_percent", type=float, default=1.0)
    p.add_argument("--load_from_checkpoint", default=None)
    p.add_argument("--epochs", type=int, default=None)
    p.add_argument("--seed", type=int, default=None,
                   help="override project.seed (init + data order + augment)")
    p.add_argument("--save_interval", type=int, default=None,
                   help="override checkpoint.save_interval")
    p.add_argument("--checkpoint_dir", default=None,
                   help="override checkpoint.checkpoint_dir")
    return p.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)

    import torch

    from custom_yolo_tpu_torch.config import Config
    from custom_yolo_tpu_torch.core.mesh import (initialize_distributed,
                                                 rank, world_size)
    from custom_yolo_tpu_torch.data.dataset import DetectionDataset
    from custom_yolo_tpu_torch.data.loader import DataLoader
    from custom_yolo_tpu_torch.models.detector import create_train_model
    from custom_yolo_tpu_torch.parallel.multihost import build_kernels
    from custom_yolo_tpu_torch.train.trainer import Trainer
    from custom_yolo_tpu_torch.utils.checkpoint import (CheckpointManager,
                                                        load_sidecar,
                                                        save_sidecar)
    from custom_yolo_tpu_torch.utils.common import get_num_workers
    from custom_yolo_tpu_torch.utils.logging import (MetricsLogger,
                                                     setup_console_logging)
    from custom_yolo_tpu_torch.utils.profiling import kernel_launches
    from custom_yolo_tpu_torch.utils.summary import count_params, summarize

    mode = {"ddp": "dp", "fsdp2": "fsdp"}.get(args.mode, args.mode)
    cfg = Config.from_yaml(args.config)
    cfg.training.sharding.mode = mode
    if args.precision:
        cfg.training.sharding.precision = args.precision
    if args.batch_size:
        cfg.training.batch_size = args.batch_size
    if args.prefetch_factor:
        cfg.data.prefetch_factor = args.prefetch_factor
    if args.epochs:
        cfg.training.epochs = args.epochs
    if args.seed is not None:
        cfg.project.seed = args.seed
    if args.save_interval is not None:
        cfg.checkpoint.save_interval = args.save_interval
    if args.checkpoint_dir is not None:
        cfg.checkpoint.checkpoint_dir = args.checkpoint_dir

    # a resumed run keeps the checkpoint's architecture and precision
    ckpt_dir = cfg.checkpoint.checkpoint_dir
    if args.load_from_checkpoint:
        ckpt_dir = args.load_from_checkpoint
        sidecar = load_sidecar(ckpt_dir)
        if sidecar:
            cfg.model.width = sidecar["width"]
            cfg.model.depth = sidecar["depth"]
            cfg.model.csp = sidecar["csp"]
            cfg.model.num_classes = sidecar["num_classes"]
            cfg.training.sharding.precision = sidecar.get(
                "precision", cfg.training.sharding.precision)

    device = torch.device(args.device)
    if mode != "single":
        device = initialize_distributed(args.coordinator,
                                        args.num_processes, args.process_id,
                                        device=args.device,
                                        backend=args.backend)
    lead = rank() == 0
    logger = setup_console_logging(
        cfg.logging.log_level if lead else "WARNING",
        cfg.project.log_dir, cfg.logging.file_log and lead)
    logger.info(f"device: {device}"
                + (f" ({torch.cuda.get_device_name(device)})"
                   if device.type == "cuda" else "")
                + f", rank {rank()} of {world_size()}")
    if device.type == "cuda":
        # every kernel library at once (one nvcc each, in parallel), rather
        # than one by one at its first launch inside the first epoch; local
        # rank 0 builds while the other ranks wait
        t0 = time.perf_counter()
        build_kernels()
        logger.info(f"CUDA kernels built in {time.perf_counter() - t0:.1f} s")
    # batch_size is per device, as under the reference's torchrun; this
    # process loads its share of the global batch
    n_devices = world_size() if mode != "single" else 1
    global_batch = cfg.training.batch_size * n_devices
    local_batch = max(1, global_batch // world_size())
    logger.info(f"mode={mode} precision="
                f"{cfg.training.sharding.precision} batch: "
                f"{cfg.training.batch_size}/device x {n_devices} devices = "
                f"{global_batch} global ({local_batch}/process)")

    model = create_train_model(
        cfg.model.width, cfg.model.depth, cfg.model.csp,
        cfg.model.num_classes, reg_max=cfg.model.reg_max,
        precision=cfg.training.sharding.precision, device=device,
        seed=cfg.project.seed, remat=cfg.training.remat)
    logger.info(f"model params: {count_params(model):,}")
    logger.info("\n" + summarize(model))

    workers = get_num_workers()
    kw = dict(input_size=tuple(cfg.model.input_size),
              is_test=cfg.training.is_test, percent=args.dataset_percent,
              max_gt=cfg.data.max_gt_boxes, seed=cfg.project.seed,
              letterbox=cfg.data.letterbox)
    train_ds = DetectionDataset(
        os.path.join(cfg.data.processed_dir, cfg.data.train_parquet),
        cfg.data.train_images, **kw)
    val_ds = DetectionDataset(
        os.path.join(cfg.data.processed_dir, cfg.data.val_parquet),
        cfg.data.val_images, **kw)
    loader_kw = dict(num_workers=workers,
                     prefetch_factor=cfg.data.prefetch_factor,
                     seed=cfg.project.seed, process_index=rank(),
                     process_count=world_size(),
                     pad_to_multiple=n_devices)
    train_loader = DataLoader(train_ds, local_batch,
                              shuffle=True, drop_last=True, **loader_kw)
    val_loader = DataLoader(val_ds, local_batch, shuffle=False,
                            drop_last=False, **loader_kw)
    logger.info(f"train: {len(train_ds)} images, val: {len(val_ds)} images")
    if len(train_loader) == 0:
        raise SystemExit(
            f"train dataset ({len(train_ds)} images) yields zero batches at "
            f"local batch {local_batch} (batch_size x devices / processes): "
            f"reduce --batch_size or add data")

    # every rank reads a checkpoint it resumes from; rank 0 alone writes
    ckpt = CheckpointManager(ckpt_dir, max_to_keep=cfg.checkpoint.max_to_keep)
    metrics_logger = None
    if lead:
        save_sidecar(ckpt_dir, {
            "width": list(cfg.model.width), "depth": list(cfg.model.depth),
            "csp": list(cfg.model.csp),
            "num_classes": cfg.model.num_classes, "mode": mode,
            "precision": cfg.training.sharding.precision})
        metrics_logger = MetricsLogger(
            cfg.wandb, log_dir=cfg.project.log_dir,
            run_name=f"{args.device}_{mode}_"
                     f"{cfg.training.sharding.precision}",
            config_dict=cfg.to_dict())
        metrics_logger.log_summary(
            f"params: {count_params(model):,}\n{summarize(model)}")

    trainer = Trainer(cfg, model, logger=logger if lead else None,
                      metrics_logger=metrics_logger,
                      checkpoint_manager=ckpt if lead else None)
    # an explicit --load_from_checkpoint, or checkpoint.resume_training
    # with a checkpoint present
    auto_resume = (cfg.checkpoint.resume_training
                   and ckpt.latest_epoch() is not None)
    if args.load_from_checkpoint or auto_resume:
        trainer.load_state(ckpt.restore(trainer.state))
        logger.info(f"resumed from epoch {trainer.state.epoch}")

    try:
        result = trainer.fit(train_loader, val_loader)
        logger.info(f"done; best val loss {result['best_val_loss']:.4f}")
    except Exception:
        traceback.print_exc()
        raise
    finally:
        if metrics_logger is not None:
            metrics_logger.close()
        ckpt.close()
    if lead and result["history"]:
        print(f"[INFO] history: {json.dumps(result['history'][-1])}")
    print(f"[INFO] kernel launches: {json.dumps(kernel_launches())}",
          flush=True)
    if world_size() > 1:
        torch.distributed.destroy_process_group()
    return result


if __name__ == "__main__":
    main()
