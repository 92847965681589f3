"""On-device batched preprocessing and augmentation (counterpart of
``custom_yolo_tpu/data/transforms.py``).

The host delivers uint8 batches; the whole batch is scaled, augmented and
normalised on its device: 4-image mosaic, mixup, horizontal flip, colour
jitter (brightness, contrast against mean grey, saturation against luma,
hue rotation in YIQ), ImageNet normalisation — in the reference's order.

Each random function is split in two: ``draw_*`` takes every random number
it needs from an explicit ``torch.Generator`` on the images' device (never
the global one), and a deterministic function applies those draws. The
tests feed the JAX package's own draws through the apply functions, and a
resumed run that reseeds the generator draws what an unbroken run draws.
Nothing here waits for the device, so a batch can be staged and augmented
while the previous step runs.
"""

from __future__ import annotations

import math
from typing import Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch

from custom_yolo_tpu_torch.models.detector import (IMAGENET_MEAN,
                                                   IMAGENET_STD,
                                                   resize_bilinear)

# ITU-R 601 luma, as float32 values
_LUMA = np.asarray([0.299, 0.587, 0.114], np.float32)
# RGB → YIQ and back, float32 values as in the reference
_YIQ = np.asarray([[0.299, 0.587, 0.114],
                   [0.596, -0.274, -0.322],
                   [0.211, -0.523, 0.312]], np.float32).astype(np.float64)
_YIQ_INV = np.asarray([[1.0, 0.956, 0.621],
                       [1.0, -0.272, -0.647],
                       [1.0, -1.106, 1.703]], np.float32).astype(np.float64)
# the hue rotation T⁻¹·rot(θ)·T is P₀ + cos θ·P₁ + sin θ·P₂, with rot(θ)
# keeping Y and turning the (I, Q) plane
_HUE_BASIS = np.stack([
    _YIQ_INV @ np.diag([1.0, 0.0, 0.0]) @ _YIQ,
    _YIQ_INV @ np.diag([0.0, 1.0, 1.0]) @ _YIQ,
    _YIQ_INV @ np.asarray([[0.0, 0.0, 0.0], [0.0, 0.0, -1.0],
                           [0.0, 1.0, 0.0]]) @ _YIQ])
# every host constant of the batch functions in one float64 array, so that
# one copy brings them to the device: mean, std, luma (3 each), hue basis
# (27)
_CONSTANTS = np.concatenate([IMAGENET_MEAN.astype(np.float64),
                             IMAGENET_STD.astype(np.float64),
                             _LUMA.astype(np.float64), _HUE_BASIS.ravel()])


def stage(array: np.ndarray, device: torch.device,
          pin_memory: bool = True) -> torch.Tensor:
    """A host array on ``device``. On a CUDA device with ``pin_memory`` it
    goes through pinned memory with ``non_blocking=True``, so the host does
    not wait for the stream; a pageable copy waits for it."""
    tensor = torch.from_numpy(np.ascontiguousarray(array))
    if device.type != "cuda":
        return tensor.to(device)
    if pin_memory:
        return tensor.pin_memory().to(device, non_blocking=True)
    return tensor.to(device)


class Constants(NamedTuple):
    mean: torch.Tensor         # (3,) fp32, ImageNet
    std: torch.Tensor          # (3,) fp32
    luma: torch.Tensor         # (3,) fp32
    hue_basis: torch.Tensor    # (3, 3, 3) fp64: P₀, P₁, P₂


def constants(device: torch.device) -> Constants:
    """The batch functions' constants on ``device``, in one copy."""
    c = stage(_CONSTANTS, device)
    return Constants(c[:3].float(), c[3:6].float(), c[6:9].float(),
                     c[9:].view(3, 3, 3))


# ------------------------------------------------------------------ draws
class JitterDraws(NamedTuple):
    brightness: torch.Tensor   # (N,) factor in [1 − b, 1 + b)
    contrast: torch.Tensor     # (N,) factor
    saturation: torch.Tensor   # (N,) factor
    hue: torch.Tensor          # (N,) angle in radians, in [−2π·h, 2π·h)


class MosaicDraws(NamedTuple):
    src_idx: torch.Tensor      # (N, 4) sources (tl, tr, bl, br), int64
    ox: torch.Tensor           # (N,) crop offset in [0, W], int64
    oy: torch.Tensor           # (N,) crop offset in [0, H], int64
    apply: torch.Tensor        # (N,) bool


class MixupDraws(NamedTuple):
    perm: torch.Tensor         # (N,) partner of each image, int64
    lam: torch.Tensor          # (N,) blend weight, Beta(α, α), fp32
    apply: torch.Tensor        # (N,) bool


class AugmentDraws(NamedTuple):
    """Every random number of one batch: mosaic and mixup (None when their
    probability is 0), then flip and jitter."""
    flip: torch.Tensor         # (N,) bool
    jitter: JitterDraws
    mosaic: Optional[MosaicDraws] = None
    mixup: Optional[MixupDraws] = None

    def to(self, device) -> "AugmentDraws":
        def move(part):
            return None if part is None else type(part)(
                *(t.to(device) for t in part))
        return AugmentDraws(self.flip.to(device), move(self.jitter),
                            move(self.mosaic), move(self.mixup))


def _uniform(gen: torch.Generator, shape, low: float, high: float
             ) -> torch.Tensor:
    return torch.rand(shape, generator=gen, device=gen.device) \
        * (high - low) + low


def draw_flip(n: int, gen: torch.Generator) -> torch.Tensor:
    return torch.rand(n, generator=gen, device=gen.device) < 0.5


def draw_color_jitter(n: int, gen: torch.Generator, brightness: float = 0.2,
                      contrast: float = 0.2, saturation: float = 0.2,
                      hue: float = 0.1) -> JitterDraws:
    return JitterDraws(
        _uniform(gen, n, 1 - brightness, 1 + brightness),
        _uniform(gen, n, 1 - contrast, 1 + contrast),
        _uniform(gen, n, 1 - saturation, 1 + saturation),
        _uniform(gen, n, -hue, hue) * 2 * math.pi)


def draw_mosaic(n: int, h: int, w: int, prob: float,
                gen: torch.Generator) -> MosaicDraws:
    """Sample i takes itself and three images of three batch permutations;
    the crop offsets are uniform over [0, H] and [0, W], both ends
    included."""
    dev = gen.device
    perms = [torch.randperm(n, generator=gen, device=dev) for _ in range(3)]
    src_idx = torch.stack([torch.arange(n, device=dev), *perms], dim=1)
    oy = torch.randint(0, h + 1, (n,), generator=gen, device=dev)
    ox = torch.randint(0, w + 1, (n,), generator=gen, device=dev)
    apply = torch.rand(n, generator=gen, device=dev) < prob
    return MosaicDraws(src_idx, ox, oy, apply)


# Marsaglia–Tsang proposals per gamma draw. At α = 32 a proposal is refused
# with probability ~1e-3, so all of them are with ~1e-24; the first one then
# stands, which no run will meet.
_GAMMA_PROPOSALS = 8


def _gamma(alpha: float, n: int, gen: torch.Generator) -> torch.Tensor:
    """(n,) Gamma(α, 1) draws, α ≥ 1, by Marsaglia and Tsang's method
    (2000): a fixed number of proposals each, the first accepted kept, so
    that nothing waits for the device."""
    if alpha < 1.0:
        raise ValueError(f"gamma draws need alpha >= 1, got {alpha}")
    d = alpha - 1.0 / 3.0
    c = 1.0 / math.sqrt(9.0 * d)
    shape = (n, _GAMMA_PROPOSALS)
    x = torch.randn(shape, generator=gen, device=gen.device)
    u = torch.rand(shape, generator=gen, device=gen.device)
    v = (1.0 + c * x) ** 3
    accept = (v > 0) & (torch.log(u) < 0.5 * x * x + d - d * v
                        + d * torch.log(v.clamp_min(1e-30)))
    first = accept.to(torch.int32).argmax(dim=1, keepdim=True)
    return d * torch.gather(v, 1, first)[:, 0]


def draw_beta(alpha: float, beta: float, n: int, gen: torch.Generator
              ) -> torch.Tensor:
    """(n,) Beta(α, β) draws as G_α / (G_α + G_β), fp32."""
    ga = _gamma(alpha, n, gen)
    gb = _gamma(beta, n, gen)
    return ga / (ga + gb)


def draw_mixup(n: int, prob: float, gen: torch.Generator,
               alpha: float = 32.0) -> MixupDraws:
    perm = torch.randperm(n, generator=gen, device=gen.device)
    lam = draw_beta(alpha, alpha, n, gen)
    apply = torch.rand(n, generator=gen, device=gen.device) < prob
    return MixupDraws(perm, lam, apply)


def draw_augment(n: int, h: int, w: int, gen: torch.Generator,
                 mosaic_prob: float = 0.0, mixup_prob: float = 0.0
                 ) -> AugmentDraws:
    """The draws of one training batch, in the order the batch uses them:
    mosaic, mixup, flip, jitter."""
    mosaic_d = draw_mosaic(n, h, w, mosaic_prob, gen) \
        if mosaic_prob > 0.0 else None
    mixup_d = draw_mixup(n, mixup_prob, gen) if mixup_prob > 0.0 else None
    flip = draw_flip(n, gen)
    return AugmentDraws(flip, draw_color_jitter(n, gen), mosaic_d, mixup_d)


# ------------------------------------------------------------------ apply
def hue_rotation_matrices(theta: torch.Tensor, basis: torch.Tensor
                          ) -> torch.Tensor:
    """(N,) angles → (N, 3, 3) fp32 RGB hue rotations T⁻¹·rot(θ)·T, formed
    in float64 from ``basis`` (P₀, P₁, P₂) and rounded once, so every
    device gives the same matrices."""
    t = theta.double()[:, None, None]
    return (basis[0] + torch.cos(t) * basis[1]
            + torch.sin(t) * basis[2]).float()


def color_jitter(images: torch.Tensor, draws: JitterDraws,
                 consts: Optional[Constants] = None) -> torch.Tensor:
    """images (N, H, W, 3) in [0, 1] → jittered by the per-image factors of
    ``draws``: brightness scale, contrast blend against the mean grey,
    saturation blend against the luma, hue rotation; clipped to [0, 1].
    The mean grey is summed in float64 and the 3-term sums are written
    out, so the card and the CPU agree."""
    if consts is None:
        consts = constants(images.device)
    fb, fc, fs = (f.view(-1, 1, 1, 1) for f in draws[:3])
    x = images * fb
    mean_gray = (x * consts.luma).mean(dim=(1, 2, 3), keepdim=True,
                                       dtype=torch.float64).float() * 3.0
    x = (x - mean_gray) * fc + mean_gray
    l0, l1, l2 = (float(v) for v in _LUMA)
    luma = x[..., 0:1] * l0 + x[..., 1:2] * l1 + x[..., 2:3] * l2
    x = (x - luma) * fs + luma
    rot = hue_rotation_matrices(draws.hue, consts.hue_basis)  # (N, 3, 3)
    r = rot[:, None, None]                               # (N, 1, 1, 3, 3)
    x = torch.stack([x[..., 0] * r[..., d, 0] + x[..., 1] * r[..., d, 1]
                     + x[..., 2] * r[..., d, 2] for d in range(3)], dim=-1)
    return x.clamp(0.0, 1.0)


def horizontal_flip(images: torch.Tensor, gt_boxes: torch.Tensor,
                    flip: torch.Tensor
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Flip the images where ``flip``; centre-xywh boxes flip as
    cx → W − cx."""
    w = images.shape[2]
    images = torch.where(flip[:, None, None, None], images.flip(2), images)
    cx = torch.where(flip[:, None], w - gt_boxes[..., 0], gt_boxes[..., 0])
    return images, torch.cat([cx[..., None], gt_boxes[..., 1:]], dim=-1)


def _valid_first(boxes: torch.Tensor, labels: torch.Tensor,
                 valid: torch.Tensor, g: int):
    """Keep the first ``g`` candidates in valid-first stable order; the
    padding's boxes are zeroed."""
    order = torch.argsort((~valid).to(torch.int32), dim=1,
                          stable=True)[:, :g]
    out_boxes = torch.gather(boxes, 1, order[..., None].expand(-1, -1, 4))
    out_labels = torch.gather(labels, 1, order)
    out_mask = torch.gather(valid, 1, order)
    return out_boxes * out_mask[..., None], out_labels, out_mask


def mosaic_compose(images: torch.Tensor, gt_boxes: torch.Tensor,
                   gt_labels: torch.Tensor, gt_mask: torch.Tensor,
                   src_idx: torch.Tensor, ox: torch.Tensor, oy: torch.Tensor):
    """Deterministic 4-image mosaic: output i is the H×W window at offset
    ``(oy[i], ox[i])`` of the 2H×2W canvas that tiles sources
    ``src_idx[i] = (tl, tr, bl, br)``, gathered straight from the sources
    (a pure copy). Boxes move into window coordinates, are clipped and
    dropped when a side is 2 px or less; the G first valid of the 4G
    candidates are kept."""
    n, h, w, _ = images.shape
    g = gt_boxes.shape[1]
    dev = images.device
    ys = oy[:, None] + torch.arange(h, device=dev)       # canvas rows
    xs = ox[:, None] + torch.arange(w, device=dev)       # canvas columns
    below, right = ys >= h, xs >= w
    quad = below[:, :, None].long() * 2 + right[:, None, :].long()
    src = torch.gather(src_idx, 1, quad.view(n, -1)).view(n, h, w)
    crop = images[src, (ys - h * below.long())[:, :, None],
                  (xs - w * right.long())[:, None, :]]

    quads = torch.arange(4, device=dev)
    qx = ((quads % 2) * w).float()
    qy = ((quads // 2) * h).float()
    b = gt_boxes[src_idx]                                # (N, 4, G, 4)
    labels = gt_labels[src_idx].reshape(n, 4 * g)
    mask = gt_mask[src_idx].reshape(n, 4 * g)
    cx = b[..., 0] + qx[None, :, None] - ox[:, None, None].float()
    cy = b[..., 1] + qy[None, :, None] - oy[:, None, None].float()
    x1 = (cx - b[..., 2] / 2).clamp(0.0, float(w))
    x2 = (cx + b[..., 2] / 2).clamp(0.0, float(w))
    y1 = (cy - b[..., 3] / 2).clamp(0.0, float(h))
    y2 = (cy + b[..., 3] / 2).clamp(0.0, float(h))
    bw, bh = x2 - x1, y2 - y1
    boxes = torch.stack([(x1 + x2) / 2, (y1 + y2) / 2, bw, bh],
                        dim=-1).reshape(n, 4 * g, 4)
    valid = mask & (bw > 2.0).reshape(n, 4 * g) & (bh > 2.0).reshape(n, 4 * g)
    return (crop, *_valid_first(boxes, labels, valid, g))


def _where_applied(apply: torch.Tensor, mixed, original):
    return tuple(torch.where(apply.view(-1, *[1] * (m.dim() - 1)), m, o)
                 for m, o in zip(mixed, original))


def mosaic(images, gt_boxes, gt_labels, gt_mask, draws: MosaicDraws):
    """Mosaic where ``draws.apply``, the inputs elsewhere."""
    mixed = mosaic_compose(images, gt_boxes, gt_labels, gt_mask,
                           draws.src_idx, draws.ox, draws.oy)
    return _where_applied(draws.apply, mixed,
                          (images, gt_boxes, gt_labels, gt_mask))


def mixup_compose(images: torch.Tensor, gt_boxes: torch.Tensor,
                  gt_labels: torch.Tensor, gt_mask: torch.Tensor,
                  perm: torch.Tensor, lam: torch.Tensor):
    """Deterministic mixup: output i blends image i with image ``perm[i]``
    at weight ``lam[i]`` and keeps the union of both label sets at full
    strength, truncated back to G slots valid-first."""
    g = gt_boxes.shape[1]
    lam4 = lam[:, None, None, None]
    img = lam4 * images + (1.0 - lam4) * images[perm]
    boxes = torch.cat([gt_boxes, gt_boxes[perm]], dim=1)
    labels = torch.cat([gt_labels, gt_labels[perm]], dim=1)
    valid = torch.cat([gt_mask, gt_mask[perm]], dim=1)
    return (img, *_valid_first(boxes, labels, valid, g))


def mixup(images, gt_boxes, gt_labels, gt_mask, draws: MixupDraws):
    """Mixup where ``draws.apply``, the inputs elsewhere."""
    mixed = mixup_compose(images, gt_boxes, gt_labels, gt_mask, draws.perm,
                          draws.lam)
    return _where_applied(draws.apply, mixed,
                          (images, gt_boxes, gt_labels, gt_mask))


def to_unit(images_u8: torch.Tensor) -> torch.Tensor:
    """uint8 → fp32 in [0, 1]. 255 is a tensor on the images' device: CUDA
    turns a division by a Python number into a multiplication by its
    reciprocal, one ulp off for about half of the levels."""
    x = images_u8.float()
    return x / x.new_full((), 255.0)


def batch_preprocess(images_u8: torch.Tensor, gt_boxes: torch.Tensor,
                     gen: Optional[torch.Generator] = None,
                     train: bool = True,
                     draws: Optional[AugmentDraws] = None
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """uint8 batch → normalised fp32 batch (+ flip-adjusted boxes). With
    ``train``: flip and jitter, drawn from ``gen`` unless ``draws`` are
    given (their mosaic and mixup parts are not used here)."""
    consts = constants(images_u8.device)
    x = to_unit(images_u8)
    if train:
        if draws is None:
            n = x.shape[0]
            draws = AugmentDraws(draw_flip(n, gen), draw_color_jitter(n, gen))
        x, gt_boxes = horizontal_flip(x, gt_boxes, draws.flip)
        x = color_jitter(x, draws.jitter, consts)
    return (x - consts.mean) / consts.std, gt_boxes


def batch_augment(images_u8: torch.Tensor, gt_boxes: torch.Tensor,
                  gt_labels: torch.Tensor, gt_mask: torch.Tensor,
                  gen: Optional[torch.Generator] = None, train: bool = True,
                  mosaic_prob: float = 0.0, mixup_prob: float = 0.0,
                  draws: Optional[AugmentDraws] = None):
    """The label-aware program: mosaic (if its probability or draws are
    given) → mixup (likewise) → flip → jitter → normalise. Draws come from
    ``gen`` unless ``draws`` are given."""
    consts = constants(images_u8.device)
    x = to_unit(images_u8)
    if train:
        if draws is None:
            n, h, w, _ = x.shape
            draws = draw_augment(n, h, w, gen, mosaic_prob, mixup_prob)
        if draws.mosaic is not None:
            x, gt_boxes, gt_labels, gt_mask = mosaic(
                x, gt_boxes, gt_labels, gt_mask, draws.mosaic)
        if draws.mixup is not None:
            x, gt_boxes, gt_labels, gt_mask = mixup(
                x, gt_boxes, gt_labels, gt_mask, draws.mixup)
        x, gt_boxes = horizontal_flip(x, gt_boxes, draws.flip)
        x = color_jitter(x, draws.jitter, consts)
    return (x - consts.mean) / consts.std, gt_boxes, gt_labels, gt_mask


def letterbox_resize(image: torch.Tensor, target: Tuple[int, int],
                     pad_value: float = 114.0 / 255.0
                     ) -> Tuple[torch.Tensor, float, Tuple[int, int]]:
    """Aspect-preserving resize + pad of one (H, W, C) float image in
    [0, 1] to ``target``. Returns (letterboxed (H', W', C), scale,
    (pad_x, pad_y)); boxes map as ``b * scale + pad``."""
    h, w = image.shape[0], image.shape[1]
    th, tw = target
    scale = min(th / h, tw / w)
    nh, nw = int(round(h * scale)), int(round(w * scale))
    resized = resize_bilinear(image, nh, nw)
    pad_y, pad_x = (th - nh) // 2, (tw - nw) // 2
    out = image.new_full((th, tw, image.shape[2]), pad_value)
    out[pad_y:pad_y + nh, pad_x:pad_x + nw] = resized
    return out, scale, (pad_x, pad_y)


def make_device_batch(host_batch: Dict[str, np.ndarray],
                      gen: Optional[torch.Generator],
                      device: torch.device, train: bool = True,
                      mosaic_prob: float = 0.0, mixup_prob: float = 0.0,
                      pin_memory: bool = True) -> Dict[str, torch.Tensor]:
    """Host uint8 batch dict (the loader's keys) → the train step's device
    batch dict. The arrays are staged by :func:`stage`; draws come from
    ``gen``, a generator on ``device``."""
    device = torch.device(device)
    images, gt_boxes, gt_labels, gt_mask = (
        stage(host_batch[k], device, pin_memory)
        for k in ("image", "gt_boxes", "gt_labels", "gt_mask"))
    if train and (mosaic_prob > 0.0 or mixup_prob > 0.0):
        images, gt_boxes, gt_labels, gt_mask = batch_augment(
            images, gt_boxes, gt_labels, gt_mask, gen, train=True,
            mosaic_prob=mosaic_prob, mixup_prob=mixup_prob)
    else:
        images, gt_boxes = batch_preprocess(images, gt_boxes, gen,
                                            train=train)
    return {"images": images, "gt_boxes": gt_boxes, "gt_labels": gt_labels,
            "gt_mask": gt_mask}
