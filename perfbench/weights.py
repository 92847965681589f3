"""Seeded weights and inputs, made on the card in a few large calls.

The same seed gives the same tensors; the program and the reference are
handed the same ones.
"""

from __future__ import annotations

import math
from typing import Dict, Sequence, Tuple

import numpy as np
import torch

# class-logit prior of the detection head: a score of 0.01 before training
CLS_BIAS = math.log(0.01 / 0.99)
# a clamped normal at ±2 has this standard deviation
CLAMPED_STD = 0.8796256610342398
# the class-logit projections are drawn this much wider than LeCun's, so
# that seeded logits spread over a few units around the prior, as a
# trained head's do, and the best detections of an image stand apart from
# the rest instead of tying at the prior to the last bit of bf16
CLS_GAIN = 6.0
# BatchNorm's scale, a mix's ``bn_gain``. At 1 (a fresh network's) the
# training forward is in the chaotic regime of batch-normalised networks
# (Yang et al., "A Mean Field Theory of Batch Normalization", ICLR 2019):
# a rounding error of the first layer grows layer by layer, and bf16
# alone moves the x model's outputs by a third of their norm in one step,
# which leaves no comparison able to tell bf16 from a lower precision.
# Smaller scales put the forward in the ordered regime, as a network in
# training is. The running variance is drawn around its square, so that
# the folded serving convs keep unit gain.
BN_GAIN = 0.25


def generator(seed: int, device: torch.device, stream: int) -> torch.Generator:
    """A generator on ``device`` for one use of ``seed`` (``stream`` keeps
    the weights, the frames and the boxes apart)."""
    mixed = np.random.SeedSequence([seed, stream]).generate_state(2)
    return torch.Generator(device=device).manual_seed(
        int(mixed[0]) << 32 | int(mixed[1]))


def _moments(key: str, shape: Tuple[int, ...],
             bn_gain: float) -> Tuple[float, float]:
    """(mean, standard deviation) of the values of one leaf."""
    if key.endswith(".bn.weight"):
        return bn_gain, 0.1 * bn_gain
    if key.endswith((".bn.bias", ".bn.running_mean")):
        return 0.0, 0.1
    if key.endswith(".bn.running_var"):
        return bn_gain ** 2, 0.2 * bn_gain ** 2
    if key.endswith(".bias"):            # the head's plain output convs
        return (CLS_BIAS if ".cls" in key else 0.0), 0.0
    fan_in = int(np.prod(shape[1:]))     # conv kernels: LeCun normal
    gain = CLS_GAIN if ".cls" in key and key.endswith("_out.weight") else 1.0
    return 0.0, gain * fan_in ** -0.5 / CLAMPED_STD


def make_state(layout: Dict[str, Tuple[int, ...]], seed: int,
               device: torch.device, bn_gain: float = BN_GAIN
               ) -> Dict[str, torch.Tensor]:
    """An unfused state dict of ``layout`` from ``seed``: one clamped
    normal draw for every float leaf, scaled and shifted leaf by leaf in
    one pass; BatchNorm's step counters zero. ``bn_gain``: BatchNorm's
    scale (see :data:`BN_GAIN`)."""
    floats = [(k, s) for k, s in layout.items()
              if not k.endswith("num_batches_tracked")]
    sizes = [int(np.prod(s)) for _, s in floats]
    moments = torch.tensor([_moments(k, s, bn_gain) for k, s in floats],
                           dtype=torch.float32, device=device)
    counts = torch.tensor(sizes, device=device)
    flat = torch.randn(sum(sizes), generator=generator(seed, device, 0),
                       device=device).clamp_(-2.0, 2.0)
    flat.mul_(moments[:, 1].repeat_interleave(counts)).add_(
        moments[:, 0].repeat_interleave(counts))
    state = {k: part.view(s) for (k, s), part in
             zip(floats, flat.split(sizes))}
    for k in layout:
        if k.endswith("num_batches_tracked"):
            state[k] = torch.zeros((), dtype=torch.long, device=device)
    return {k: state[k] for k in layout}


def frames(seed: int, shape: Sequence[int], device: torch.device,
           pinned: bool) -> torch.Tensor:
    """Uniform uint8 frames of ``shape`` from ``seed``, made on the card;
    copied into pinned host memory when ``pinned``."""
    dev = torch.randint(0, 256, tuple(shape), dtype=torch.uint8,
                        generator=generator(seed, device, 1), device=device)
    if not pinned:
        return dev
    host = torch.empty(dev.shape, dtype=torch.uint8, pin_memory=True)
    host.copy_(dev)
    return host


def scene_batches(seed: int, n_batches: int, batch: int,
                  size: Tuple[int, int], num_classes: int, slots: int,
                  boxes_mean: float, device: torch.device,
                  texture: float = 0.0) -> list:
    """Training batches in the manner of the COCO-scale soak's images: a
    gray canvas with Poisson(boxes_mean − 1) + 1 filled boxes an image
    (sides 8 px to half the canvas, a colour per class with jitter), the
    boxes as centre-xywh pixels padded to ``slots``. Images are
    ImageNet-normalised NHWC fp32 on ``device``. The box draws come from
    ``seed`` on the host (a few hundred numbers); the pixels are painted
    on the card. ``texture``: uniform per-pixel noise of that amplitude
    over the whole image, as a camera's; flat regions leave batch-
    normalised channels with almost no variance, which magnify rounding
    tenfold."""
    rng = np.random.default_rng([seed, 2])
    gen = generator(seed, device, 2)
    h, w = size
    hue = np.arange(num_classes) / num_classes
    colors = torch.tensor(_hsv_rgb(hue), dtype=torch.float32, device=device)
    mean = torch.tensor([0.485, 0.456, 0.406], device=device)
    std = torch.tensor([0.229, 0.224, 0.225], device=device)
    out = []
    for _ in range(n_batches):
        img = torch.full((batch, h, w, 3), 30.0, device=device)
        gt = np.zeros((batch, slots, 4), np.float32)
        labels = np.zeros((batch, slots), np.int64)
        mask = np.zeros((batch, slots), bool)
        for i in range(batch):
            n = min(int(rng.poisson(boxes_mean - 1.0)) + 1, slots)
            for j in range(n):
                bw = int(rng.integers(8, max(9, w // 2)))
                bh = int(rng.integers(8, max(9, h // 2)))
                x = int(rng.integers(0, max(1, w - bw)))
                y = int(rng.integers(0, max(1, h - bh)))
                cid = int(rng.integers(0, num_classes))
                jitter = torch.tensor(rng.integers(-15, 16, 3),
                                      dtype=torch.float32)
                img[i, y:y + bh, x:x + bw] = (
                    colors[cid] + jitter.to(device)).clamp(0, 255)
                gt[i, j] = (x + bw / 2, y + bh / 2, bw, bh)
                labels[i, j], mask[i, j] = cid, True
        if texture:
            img.add_(torch.rand(img.shape, generator=gen, device=device)
                     .sub_(0.5).mul_(texture)).clamp_(0, 255)
        out.append({
            "images": ((img / 255.0) - mean) / std,
            "gt_boxes": torch.from_numpy(gt).to(device),
            "gt_labels": torch.from_numpy(labels).to(device),
            "gt_mask": torch.from_numpy(mask).to(device)})
    return out


def _hsv_rgb(hue: np.ndarray) -> np.ndarray:
    """Saturated colours (s = v = 0.9) of ``hue`` in [0, 1), as 0-255."""
    s = v = 0.9
    i = np.floor(hue * 6).astype(int) % 6
    f = hue * 6 - np.floor(hue * 6)
    p, q, t = v * (1 - s), v * (1 - f * s), v * (1 - (1 - f) * s)
    table = np.stack([np.stack(c, -1) for c in (
        (np.full_like(f, v), t, np.full_like(f, p)),
        (q, np.full_like(f, v), np.full_like(f, p)),
        (np.full_like(f, p), np.full_like(f, v), t),
        (np.full_like(f, p), q, np.full_like(f, v)),
        (t, np.full_like(f, p), np.full_like(f, v)),
        (np.full_like(f, v), np.full_like(f, p), q))])
    return table[i, np.arange(len(hue))] * 255.0


@torch.no_grad()
def settle_statistics(state: Dict[str, torch.Tensor], config: dict,
                      batches: Sequence[torch.Tensor]
                      ) -> Dict[str, torch.Tensor]:
    """``state`` with every BatchNorm's running statistics set to the mean
    over ``batches`` (uint8 NHWC) of each batch's own statistics in an fp32
    training forward of the reference, as training leaves them: a trained
    network's statistics track its data. Without this the folded serving
    network's activations fade layer by layer and its outputs no longer
    depend on the frame."""
    from perfbench.reference.model import Reference

    ref = Reference(config["width"], config["depth"], config["csp"],
                    config["num_classes"], config["reg_max"], mode="train")
    ref.momentum = 1.0
    sums: Dict[str, torch.Tensor] = {}
    for images in batches:
        mean = torch.tensor([0.485, 0.456, 0.406], device=images.device)
        std = torch.tensor([0.229, 0.224, 0.225], device=images.device)
        ref(state, ((images.float() / 255.0) - mean) / std)
        for k, v in ref.new_stats.items():
            sums[k] = sums[k] + v if k in sums else v.clone()
    return {**state, **{k: v / len(batches) for k, v in sums.items()}}
