#!/usr/bin/env python
"""Batch serving CLI of the PyTorch port (counterpart of
``scripts/serve.py``): a directory of images (or one file) →
``detections.json``.

The pipeline of the JAX package's script, on one device:

* decode on a producer thread: the native libjpeg decoder for batches of
  JPEGs where it builds (``--fast_decode`` adds its fast IDCT and
  DCT-domain prescale), PIL for other batches, and PIL for every batch
  where the native decoder is not there (a machine without
  ``jpeglib.h``); ``--fast_decode`` then raises;
* uint8 batches of a fixed shape, the tail padded with its last image and
  the pad rows dropped on fetch; normalisation on the device
  (``Detector.serve(device_preprocess=True)``);
* forward + DFL decode + NMS per batch, with ``--inflight`` batches
  dispatched before the oldest result is fetched (``Detector.serve``
  waits on nothing).

Output: a JSON list of {"image", "width", "height", "detections":
[[x1, y1, x2, y2, conf, cls], ...]} with boxes in ORIGINAL image pixels
(the inverse of the squash resize), clipped to the image.

Usage:
  python scripts/torch_serve.py --images ./photos --checkpoint <dir> \\
      --preset x --num_classes 172 --batch_size 8 --output detections.json
"""

import argparse
import json
import os
import queue
import sys
import threading
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# the repository root in place of this script's directory, whose
# profile.py would shadow the standard library's (torch imports it)
if sys.path and os.path.abspath(sys.path[0] or ".") == os.path.join(
        REPO, "scripts"):
    sys.path[0] = REPO
elif REPO not in sys.path:
    sys.path.insert(0, REPO)

IMG_EXTS = (".jpg", ".jpeg", ".png", ".bmp")
FIRST_FETCH = "serve_cli.first_fetch"


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--images", required=True,
                   help="directory of images (or a single image file)")
    p.add_argument("--output", default="detections.json")
    p.add_argument("--checkpoint", default=None,
                   help="Detector.save_weights dir, a model_epoch_N dir, or "
                        "a train-state checkpoint root (needs --config)")
    p.add_argument("--config", default=None,
                   help="training config YAML — required only to restore "
                        "train-state checkpoints or to derive the model "
                        "shape instead of --preset")
    p.add_argument("--preset", default="x",
                   help="model preset (models/presets.py) when no --config")
    p.add_argument("--num_classes", type=int, default=172)
    p.add_argument("--input_size", type=int, default=640)
    p.add_argument("--batch_size", type=int, default=32)
    p.add_argument("--conf", type=float, default=0.25)
    p.add_argument("--iou", type=float, default=0.45)
    p.add_argument("--top_k", type=int, default=1024)
    p.add_argument("--max_det", type=int, default=300)
    p.add_argument("--no_ema", action="store_true",
                   help="train-state checkpoints: use live (not EMA) "
                        "params")
    p.add_argument("--fast_decode", action="store_true",
                   help="the native decoder's approximate serving path; "
                        "raises where the native decoder is not there")
    p.add_argument("--host_preprocess", action="store_true",
                   help="normalize on host (fp32 to the device) instead of "
                        "sending uint8 — only useful for A/B checks")
    p.add_argument("--inflight", type=int, default=2)
    p.add_argument("--decode_threads", type=int, default=0)
    p.add_argument("--quantize", default="none",
                   choices=["none", "static"],
                   help="static: selective int8 with scales calibrated on "
                        "the first --calib_batches input batches")
    p.add_argument("--calib_batches", type=int, default=4)
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    p.add_argument("--profile_dir", default=None,
                   help="write a torch.profiler Chrome trace of the serving "
                        "loop to <dir>/trace.json")
    return p.parse_args(argv)


def build_detector(args):
    """(``Detector`` on ``args.device`` with the weights ``--checkpoint``
    names, input size (h, w))."""
    from custom_yolo_tpu_torch.models.detector import Detector
    from custom_yolo_tpu_torch.models.presets import PRESETS
    from custom_yolo_tpu_torch.utils.checkpoint import (find_weights,
                                                        restore_variables)

    if args.config:
        from custom_yolo_tpu_torch.config import Config
        cfg = Config.from_yaml(args.config)
        width, depth, csp = cfg.model.width, cfg.model.depth, cfg.model.csp
        num_classes = cfg.model.num_classes
        input_size = tuple(cfg.model.input_size)
    else:
        cfg = None
        p = PRESETS[args.preset]
        width, depth, csp = p["width"], p["depth"], p["csp"]
        num_classes = args.num_classes
        input_size = (args.input_size, args.input_size)

    det = Detector(width, depth, csp, num_classes=num_classes,
                   input_size=input_size, device=args.device)

    ckpt_dir = args.checkpoint
    if ckpt_dir is None and cfg is not None:
        ckpt_dir = cfg.checkpoint.checkpoint_dir
    if ckpt_dir is None:
        print("[WARN] no --checkpoint: serving RANDOM init weights")
        det.init()
        return det, input_size

    kind, where, epoch = find_weights(ckpt_dir)
    if kind == "weights":
        det.load_weights(where)
        print(f"[INFO] loaded Detector weights from {where}")
        return det, input_size
    if kind is None:
        raise SystemExit(f"[ERROR] no weights under {ckpt_dir}")
    if cfg is None:
        raise SystemExit(
            f"[ERROR] {ckpt_dir} is not a Detector.save_weights dir; "
            "restoring a train-state checkpoint needs --config")
    variables, restored, which = restore_variables(where, epoch,
                                                   live=args.no_ema)
    det.load_variables(variables)
    print(f"[INFO] restored epoch {restored} from {where} ({which} params)")
    return det, input_size


def main(argv=None):
    """Serve the images; returns the list written to ``--output``."""
    args = parse_args(argv)
    import numpy as np
    import torch

    from custom_yolo_tpu_torch.models.detector import (IMAGENET_MEAN,
                                                       IMAGENET_STD)
    from custom_yolo_tpu_torch.runtime import NativeDecoder, native_available
    from custom_yolo_tpu_torch.utils.profiling import kernel_launches, trace

    if os.path.isdir(args.images):
        paths = sorted(
            os.path.join(args.images, f) for f in os.listdir(args.images)
            if f.lower().endswith(IMG_EXTS))
    else:
        paths = [args.images]
    if not paths:
        raise SystemExit(f"[ERROR] no images under {args.images}")

    det, input_size = build_detector(args)
    det.fuse()
    H, W = input_size
    B = args.batch_size
    device_pre = not args.host_preprocess

    dec = None
    if native_available():
        dec = NativeDecoder(args.decode_threads or (os.cpu_count() or 1))
    elif args.fast_decode:
        raise SystemExit("[ERROR] --fast_decode needs the native decoder, "
                         "which does not build here (g++ with jpeglib.h)")
    print(f"[INFO] decoder: {'native' if dec is not None else 'PIL'}")

    def pil_decode(pth):
        # the contract of decode_batch: squash-resize to (H, W), uint8,
        # original (w, h)
        from PIL import Image
        with Image.open(pth) as im:
            im = im.convert("RGB")
            w, h = im.size
            return np.asarray(im.resize((W, H), Image.BILINEAR),
                              dtype=np.uint8), (w, h)

    def decode(padded):
        if dec is not None and all(
                p.lower().endswith((".jpg", ".jpeg")) for p in padded):
            u8, sizes, nf = dec.decode_batch(padded, H, W,
                                             fast=args.fast_decode)
            if nf:
                print(f"[WARN] {nf} images failed to decode in "
                      f"{padded[0]}..", file=sys.stderr)
            return u8, sizes
        u8 = np.zeros((len(padded), H, W, 3), np.uint8)
        sizes = np.zeros((len(padded), 2), np.int32)
        for i, pth in enumerate(padded):
            u8[i], (sizes[i][0], sizes[i][1]) = pil_decode(pth)
        return u8, sizes

    def host_pre(u8):
        return u8 if device_pre else (
            (u8.astype(np.float32) / 255.0 - IMAGENET_MEAN) / IMAGENET_STD)

    # fixed-shape batches: the tail is padded by repeating its last image
    # (the pad rows are dropped on fetch)
    batches = []
    for i in range(0, len(paths), B):
        chunk = paths[i:i + B]
        batches.append((chunk, chunk + [chunk[-1]] * (B - len(chunk))))

    if args.quantize == "static":
        det.quantize(skip="auto")
        calib = [paths[i:i + B]
                 for i in range(0, min(len(paths), args.calib_batches * B),
                                B)]
        det.calibrate(
            (decode(c)[0].astype(np.float32) / 255.0 - IMAGENET_MEAN)
            / IMAGENET_STD for c in calib)
        print(f"[INFO] selective int8, scales calibrated on "
              f"{args.calib_batches} batches")

    def run_serve(x):
        return det.serve(torch.from_numpy(x), conf_thres=args.conf,
                         iou_thres=args.iou, max_det=args.max_det,
                         top_k=args.top_k, device_preprocess=device_pre)

    q: "queue.Queue" = queue.Queue(maxsize=args.inflight + 1)
    decode_s = [0.0]   # the producer's seconds in decode and host_pre

    def producer():
        for chunk, padded in batches:
            t = time.perf_counter()
            u8, sizes = decode(padded)
            x = host_pre(u8)
            decode_s[0] += time.perf_counter() - t
            q.put((chunk, sizes, x))
        q.put(None)

    results = []

    def fetch(item):
        chunk, sizes, res = item
        boxes = res.boxes.cpu().numpy()
        scores = res.scores.cpu().numpy()
        classes = res.classes.cpu().numpy()
        nv = res.num_valid.cpu().numpy()
        for j, path in enumerate(chunk):
            n = int(nv[j])
            w, h = int(sizes[j][0]), int(sizes[j][1])
            b = boxes[j, :n].astype(np.float64)
            b[:, [0, 2]] *= w / W   # squash-resize inverse → original px
            b[:, [1, 3]] *= h / H
            # DFL boxes may reach past an edge; detections stay on the
            # canvas
            b[:, [0, 2]] = b[:, [0, 2]].clip(0, w)
            b[:, [1, 3]] = b[:, [1, 3]].clip(0, h)
            results.append({
                "image": os.path.basename(path), "width": w, "height": h,
                "detections": [
                    [round(float(v), 2) for v in b[k]]
                    + [round(float(scores[j, k]), 4), int(classes[j, k])]
                    for k in range(n)],
            })

    t_first = None

    def fetch_timed(item):
        # the first batch carries the warm-up (first launches, allocator
        # growth); its end opens the steady-state window, and its span
        # marks that point in a --profile_dir trace
        nonlocal t_first
        if t_first is not None:
            return fetch(item)
        with torch.profiler.record_function(FIRST_FETCH):
            fetch(item)
        t_first = time.perf_counter()

    with trace(args.profile_dir):
        t0 = time.perf_counter()
        threading.Thread(target=producer, daemon=True).start()
        inflight = []
        while True:
            item = q.get()
            if item is None:
                break
            chunk, sizes, x = item
            inflight.append((chunk, sizes, run_serve(x)))
            if len(inflight) > args.inflight:
                fetch_timed(inflight.pop(0))
        for item in inflight:
            fetch_timed(item)
        dt = time.perf_counter() - t0

    with open(args.output, "w") as f:
        json.dump(results, f)
    n_det = sum(len(r["detections"]) for r in results)
    print(f"[INFO] {len(results)} images -> {n_det} detections in "
          f"{dt:.3f} s ({len(results) / dt:.2f} img/s incl. warm-up) "
          f"-> {args.output}")
    rest, rest_s = len(results) - len(batches[0][0]), dt - (t_first - t0)
    print(f"[INFO] first batch fetched after {t_first - t0:.3f} s; the "
          f"other {rest} images in {rest_s:.3f} s "
          f"({rest / max(rest_s, 1e-9):.2f} img/s); decode on the producer "
          f"thread {decode_s[0]:.3f} s "
          f"({1e3 * decode_s[0] / len(batches) / B:.2f} ms/img)")
    print(f"[INFO] kernel launches: {json.dumps(kernel_launches())}")
    return results


if __name__ == "__main__":
    main()
