"""Serving traffic: a closed loop of uint8 frame batches through
``Detector.serve`` on the fused detector, as ``scripts/torch_serve.py``
drives it.

Mix parameters: ``batch``, ``inflight`` (batches in flight before the
oldest is fetched), ``ring`` (distinct pinned batches made from the
seed, served in turn), ``conf_thres``, ``iou_thres``, ``top_k``,
``max_det``, ``warm_batches``, ``trace_skip`` and ``trace_batches`` (the
traced part of a ``--trace 1`` window), and ``check_batches`` (batches of
the window compared with the reference, drawn from the seed, the last one
always among them).

A traced run adds nothing to the program: its per-layer metrics read the
program's own ``serve/*`` spans, which enclose the launches of the CUDA
graphs that ``serve`` replays as well as its eager calls.

A batch's latency runs from its hand-off to ``serve`` to its detections'
arrival on the host; ``serve_img_s`` counts every image whose detections
arrived, over the whole window, the drain of the last batches included.
"""

from __future__ import annotations

import collections
import gc
import time
from typing import Any, Dict

import numpy as np
import torch

from perfbench import trace as tr
from perfbench.reference import detect
from perfbench.reference.model import Reference, decode, fold, state_layout
from perfbench.weights import frames, make_state, settle_statistics


# batches or steps after the traced part of a window, at the least
REST_ITEMS = 20


def _fetch(res) -> Dict[str, torch.Tensor]:
    """The detections on the host, as the serve CLI fetches them."""
    return {"boxes": res.boxes.cpu(), "scores": res.scores.cpu(),
            "classes": res.classes.cpu(), "num_valid": res.num_valid.cpu()}


def build_detector(cfg: Dict[str, Any], state, device):
    from custom_yolo_tpu_torch.models.detector import Detector

    det = Detector(cfg["width"], cfg["depth"], cfg["csp"],
                   cfg["num_classes"], cfg["reg_max"],
                   precision=cfg["precision"],
                   input_size=tuple(cfg["input_size"]), device=device)
    det.load_variables(state)
    return det.fuse()


def run(r) -> Dict[str, Any]:
    cfg, mix, seed = r.config, r.mix, r.seed
    dev = r.device
    h, w = cfg["input_size"]
    b = mix["batch"]
    layout = state_layout(cfg["width"], cfg["depth"], cfg["csp"],
                          cfg["num_classes"], cfg["reg_max"])
    r.mark("imports and layout")
    ring = frames(seed, (mix["ring"], b, h, w, 3), dev,
                  pinned=dev.type == "cuda")
    state = settle_statistics(make_state(layout, seed, dev, mix["bn_gain"]), cfg,
                              [batch.to(dev) for batch in ring])
    r.mark("frames and weights made")
    det = build_detector(cfg, state, dev)
    state = {k: v.cpu() for k, v in state.items()}
    r.mark("detector built and fused")
    kw = {k: mix[k] for k in ("conf_thres", "iou_thres", "top_k",
                              "max_det")}
    if r.trace:
        tr.warm_profiler()

    def serve(i):
        with torch.profiler.record_function("bench/serve"):
            return det.serve(ring[i % mix["ring"]], device_preprocess=True,
                             **kw)

    # warm-up: the cell's one shape, through the same loop
    inflight = collections.deque()
    for i in range(mix["warm_batches"]):
        inflight.append(serve(i))
        if len(inflight) > mix["inflight"]:
            _fetch(inflight.popleft())
    while inflight:
        _fetch(inflight.popleft())
    r.sync()
    r.reset_peak()
    r.mark("warmed up")

    results, latency = {}, []
    prof, window, t_rest = None, None, None
    trace_from = mix["trace_skip"] if r.trace else -1
    # a traced run ends with an untraced rest, whose pace the idle share
    # and the utilisation read
    rest = REST_ITEMS if r.trace else 0
    trace_to = trace_from + mix["trace_batches"] if r.trace else -1
    gc.collect()
    gc.disable()           # no collector pauses inside the window
    setup_s = time.time() - r.t_start
    t0 = time.perf_counter()
    i = 0

    def retire():
        j, t_sub, res = inflight.popleft()
        with torch.profiler.record_function("bench/fetch"):
            results[j] = _fetch(res)
        latency.append(time.perf_counter() - t_sub)

    while time.perf_counter() - t0 < r.seconds or i < trace_to + rest:
        if i == trace_from:
            prof = tr.profiler()
            prof.start()
            window = torch.profiler.record_function(tr.WINDOW)
            window.__enter__()
        inflight.append((i, time.perf_counter(), serve(i)))
        i += 1
        if len(inflight) > mix["inflight"]:
            retire()
        if i == trace_to:
            window.__exit__(None, None, None)
            prof.stop()
            t_rest = time.perf_counter()
    while inflight:
        retire()
    t_end = time.perf_counter()
    gc.enable()
    elapsed = t_end - t0
    device = r.device_record()
    out: Dict[str, Any] = {
        "setup_s": setup_s, "attempted": i, "failed": i - len(results),
        "device": device,
        "end_to_end": {
            "serve_img_s": len(results) * b / elapsed,
            "serve_p95_ms": p95_ms(latency)}}
    if r.trace:
        out["digest"] = tr.Digest(tr.export_events(prof),
                                  mix["trace_batches"],
                                  mix["trace_batches"] * b,
                                  rest=(i - trace_to, (i - trace_to) * b,
                                        t_end - t_rest))
        del prof
    del det
    r.free()
    out["compared"] = check(r, ring, results, i, state)
    return out


def p95_ms(latency) -> float:
    """The 95th percentile of every batch's latency (seconds), in ms,
    interpolated linearly between order statistics."""
    return float(np.percentile(np.asarray(latency, np.float64), 95)) * 1e3


def check_sample(seed: int, n_batches: int, count: int) -> list:
    """Batches of the window to compare, drawn from the seed; the last
    one always among them."""
    rng = np.random.default_rng([seed, 3])
    pick = set(rng.choice(n_batches - 1, size=min(count, n_batches) - 1,
                          replace=False).tolist()) if n_batches > 1 else set()
    return sorted(pick | {n_batches - 1})


@torch.no_grad()
def check(r, ring, results, n_batches, state) -> list:
    """The sampled batches' detections against the reference's (fp32, TF32
    off, BatchNorm folded here): ``gap_mean`` and ``box_mean`` over the
    served detections that a kept reference detection matches,
    ``unmatched_pct``, the share of served and kept detections clear of
    the cuts that the other side does not match, and ``nms_overlaps``, the
    served pairs of one class that overlap above the threshold."""
    t_check = time.perf_counter()
    cfg, mix = r.config, r.mix
    r.exact_fp32()
    dev = r.device
    params = fold({k: v.to(dev) for k, v in state.items()})
    ref = Reference(cfg["width"], cfg["depth"], cfg["csp"],
                    cfg["num_classes"], cfg["reg_max"], mode="eval")
    mean = torch.tensor([0.485, 0.456, 0.406], device=dev)
    std = torch.tensor([0.229, 0.224, 0.225], device=dev)
    gap, box, unmatched, counted, missing, overlaps = [], [], 0, 0, 0, 0
    served, kept = [], []
    for j in check_sample(r.seed, n_batches, mix["check_batches"]):
        res = results.get(j)
        if res is None:
            missing += 1
            continue
        images = ring[j % mix["ring"]].to(dev).float()
        preds, anchors, strides = ref(params, ((images / 255.0) - mean) / std)
        boxes, logits = decode(preds, anchors, strides, cfg["reg_max"])
        dets = detect.nms(boxes, logits, mix["conf_thres"], mix["iou_thres"],
                          mix["top_k"], mix["max_det"])
        for k in range(images.shape[0]):
            n = int(res["num_valid"][k])
            g = detect.image_gaps(
                res["boxes"][k, :n].to(dev), res["scores"][k, :n].to(dev),
                res["classes"][k, :n].to(dev), boxes[k], logits[k], strides,
                dets[k], mix["max_det"])
            gap.append(g["gap"])
            box.append(g["box"])
            unmatched += g["unmatched"]
            counted += g["counted"]
            overlaps += detect.overlapping_pairs(
                res["boxes"][k, :n].to(dev), res["classes"][k, :n].to(dev),
                mix["iou_thres"])
            served.append(n)
            kept.append(len(dets[k]["anchor"]))
    gap, box = torch.cat(gap), torch.cat(box)
    whole = not missing and len(gap)
    stats = {"gap_mean": float(gap.mean()) if whole else float("inf"),
             "box_mean": float(box.mean()) if whole else float("inf"),
             "unmatched_pct": (100.0 * unmatched / max(counted, 1)
                               if not missing else float("inf")),
             "nms_overlaps": float(overlaps) if not missing else float("inf")}
    r.note(f"detections served {min(served)}-{max(served)} an image, kept by "
           f"the reference {min(kept)}-{max(kept)}; {unmatched} of {counted} "
           f"clear of the cuts unmatched; {len(gap)} matched, widest gap "
           f"{float(gap.max()) if len(gap) else 0.0:.4f}; {overlaps} served "
           f"pairs overlap; batches missing {missing}; the check took "
           f"{time.perf_counter() - t_check:.1f} s")
    return [r.compare(name, stats[name]) for name in r.limits]


# the numbers a cell may compare (its configuration's limits name them)
CANDIDATES = ("gap_mean", "box_mean", "unmatched_pct", "nms_overlaps")
