#!/usr/bin/env python
"""Migrate a reference PyTorch checkpoint into the PyTorch port
(counterpart of ``scripts/import_torch.py``).

Reads a checkpoint written by the reference trainer (``torch.save({...,
"model_state": model.state_dict()})``, or a bare ``state_dict``; DDP's
``module.`` prefixes are stripped), converts it with
:mod:`custom_yolo_tpu_torch.utils.torch_port`, and writes a
``Detector.save_weights`` directory (``weights.pt`` + ``transforms.json``)
that ``scripts/torch_evaluate.py --checkpoint`` and
``scripts/torch_serve.py --checkpoint`` read as it is.

    python scripts/torch_import_torch.py \\
        --torch_checkpoint experiments/checkpoints/model_epoch_90 \\
        --output experiments/imported/model_epoch_90 \\
        --preset x --num_classes 172 [--fuse] [--device cuda|cpu]

The conversion is host work; the model it fills is built on ``--device``
(``cuda`` by default, no fallback to the CPU).
"""

import argparse
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
    p = argparse.ArgumentParser(description="torch checkpoint migration "
                                            "(PyTorch port)")
    p.add_argument("--torch_checkpoint", required=True,
                   help="reference .pt/.pth file (trainer wrapper or bare "
                        "state_dict; DDP 'module.' prefixes handled)")
    p.add_argument("--output", required=True,
                   help="Detector.save_weights directory to write")
    p.add_argument("--preset", default=None,
                   help="model scale preset (n/s/m/l/x); or pass --config")
    p.add_argument("--config", default=None,
                   help="config.yaml carrying model width/depth/csp/"
                        "num_classes (preset wins if both given)")
    p.add_argument("--num_classes", type=int, default=None,
                   help="override class count (required with --preset)")
    p.add_argument("--fuse", action="store_true",
                   help="also fold conv+BN for serving before saving")
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = p.parse_args(argv)
    if args.preset and args.num_classes is None:
        p.error("--num_classes is required with --preset")
    if not (args.preset or args.config):
        p.error("pass --preset or --config")
    return args


def main(argv=None):
    args = parse_args(argv)
    from custom_yolo_tpu_torch import Detector
    from custom_yolo_tpu_torch.models.presets import PRESETS
    from custom_yolo_tpu_torch.utils.torch_port import import_torch_weights

    input_size = (640, 640)
    if args.preset:
        arch = PRESETS[args.preset]
        num_classes = args.num_classes
        width, depth, csp = arch["width"], arch["depth"], arch["csp"]
    else:
        from custom_yolo_tpu_torch.config import Config
        cfg = Config.from_yaml(args.config)
        width, depth, csp = cfg.model.width, cfg.model.depth, cfg.model.csp
        num_classes = (args.num_classes if args.num_classes is not None
                       else cfg.model.num_classes)
        input_size = tuple(cfg.model.input_size)

    det = Detector(width, depth, csp, num_classes=num_classes,
                   input_size=input_size, device=args.device)
    import_torch_weights(det, args.torch_checkpoint)
    if args.fuse:
        det.fuse()
    det.save_weights(args.output)
    n_params = sum(p.numel() for p in det.model.parameters())
    print(f"imported {args.torch_checkpoint} -> {args.output} "
          f"({n_params / 1e6:.1f}M params, fused={args.fuse})")


if __name__ == "__main__":
    main()
