"""Full detector and its serving wrapper (counterpart of
``custom_yolo_tpu/models/detector.py``).

:class:`YoloModel` is Backbone + Neck + Head on NHWC input. :class:`Detector`
holds one model on one device and serves it: ``init`` (seeded weights) or
``load_variables`` (a JAX variable tree as numpy, or a train state's
variables), ``fuse`` (fold each
BatchNorm into its conv), ``__call__`` (raw head output), ``serve``
(forward + DFL decode + class-aware batched NMS, fixed-shape result) and
``inference`` (one image in, ``(n, 6)`` detections out).
:func:`create_train_model` gives the unfused model in training mode for
the train step.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from custom_yolo_tpu_torch.core.dtypes import DTypePolicy, resolve_policy
from custom_yolo_tpu_torch.models.backbone import Backbone
from custom_yolo_tpu_torch.models.head import CLS_BIAS, Head
from custom_yolo_tpu_torch.models.neck import Neck
from custom_yolo_tpu_torch.nn.blocks import BN_EPS
from custom_yolo_tpu_torch.ops.boxes import dist2bbox
from custom_yolo_tpu_torch.ops.dfl import dfl_decode
from custom_yolo_tpu_torch.ops.nms import NMSResult, batched_nms, nms_to_lists
from custom_yolo_tpu_torch.utils.weights import from_jax_variables

# ImageNet normalisation (reference src/data/transforms.py:12-13)
IMAGENET_MEAN = np.array([0.485, 0.456, 0.406], dtype=np.float32)
IMAGENET_STD = np.array([0.229, 0.224, 0.225], dtype=np.float32)


class YoloModel(nn.Module):
    """Backbone + Neck + Head. Input NHWC float; output (preds (N, M,
    4·reg_max+nc), anchors (M, 2), strides (M, 1))."""

    def __init__(self, width: Sequence[int], depth: Sequence[int],
                 csp: Sequence[bool], num_classes: int, reg_max: int = 16,
                 policy: DTypePolicy = DTypePolicy(), fused: bool = False):
        super().__init__()
        self.policy = policy
        self.net = Backbone(width, depth, csp, fused=fused)
        self.fpn = Neck(width, depth, csp, fused=fused)
        self.head = Head(num_classes, (width[3], width[4], width[5]),
                         reg_max=reg_max, fused=fused)

    def forward(self, x: torch.Tensor):
        x = x.to(self.policy.compute_dtype).permute(0, 3, 1, 2)
        return self.head(self.fpn(self.net(x)))


def init_weights(model: YoloModel, seed: int) -> None:
    """The port's own seeded initialisation, in the JAX package's manner:
    truncated-normal (LeCun) conv kernels, zero biases, identity
    BatchNorm, prior-probability bias on the class logits."""
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for name, mod in model.named_modules():
            if isinstance(mod, nn.Conv2d):
                fan_in = mod.weight[0].numel()
                # flax lecun_normal: stddev of the ±2σ truncated normal
                std = (1.0 / fan_in) ** 0.5 / 0.87962566103423978
                nn.init.trunc_normal_(mod.weight, 0.0, std, -2 * std,
                                      2 * std, generator=gen)
                if mod.bias is not None:
                    mod.bias.fill_(CLS_BIAS if name.startswith("head.cls")
                                   and name.endswith("_out") else 0.0)
            elif isinstance(mod, nn.BatchNorm2d):
                mod.reset_parameters()


def create_train_model(width: Sequence[int], depth: Sequence[int],
                       csp: Sequence[bool], num_classes: int,
                       reg_max: int = 16, precision: str = "bfloat16",
                       device: str | torch.device = "cuda",
                       seed: int = 0,
                       variables: Optional[Mapping[str, Any]] = None
                       ) -> YoloModel:
    """The unfused model for the train step: in training mode, on
    ``device`` (``cuda`` unless the caller says otherwise; no fallback),
    ``channels_last``. Weights from ``variables`` (a JAX
    ``{"params", "batch_stats"}`` tree as numpy) when given, else seeded
    random ones."""
    model = YoloModel(width, depth, csp, num_classes, reg_max,
                      resolve_policy(precision), fused=False)
    if variables is not None:
        model.load_state_dict(from_jax_variables(variables, model),
                              strict=True)
    else:
        init_weights(model, seed)
    model = model.to(torch.device(device), memory_format=torch.channels_last)
    return model.train()


def fuse_state_dict(state: Mapping[str, torch.Tensor]
                    ) -> Dict[str, torch.Tensor]:
    """Unfused state dict → fused: every ``….conv.weight`` with a
    ``….bn`` beside it becomes the BN-folded kernel plus ``….conv.bias``,
    folded in fp32 with ``BN_EPS`` (``_fold_convbn``)."""
    out: Dict[str, torch.Tensor] = {}
    for key, value in state.items():
        if ".bn." in key:
            continue
        prefix = key[:-len(".conv.weight")]
        if key.endswith(".conv.weight") and f"{prefix}.bn.weight" in state:
            bn = {k: state[f"{prefix}.bn.{k}"].float()
                  for k in ("weight", "bias", "running_mean", "running_var")}
            scale = bn["weight"] / torch.sqrt(bn["running_var"] + BN_EPS)
            out[key] = value.float() * scale[:, None, None, None]
            out[f"{prefix}.conv.bias"] = bn["bias"] - bn["running_mean"] * scale
        else:
            out[key] = value
    return out


def preprocess_image(image, input_size: Tuple[int, int] = (640, 640),
                     letterbox: bool = False, return_geometry: bool = False):
    """One image (path, PIL image or HWC array) → normalised NHWC
    ``(1, H, W, 3)`` float32 numpy: squash-resize (or letterbox with
    114-gray padding), scale to [0, 1], ImageNet-normalise. Arrays are
    resized bilinearly with antialiasing, as ``jax.image.resize`` does.
    With ``return_geometry`` also ``(scale (2,), offset (2,))`` such that
    model = orig·scale + offset."""
    th, tw = input_size
    if isinstance(image, str) or type(image).__module__.startswith("PIL."):
        from PIL import Image

        if isinstance(image, str):
            image = Image.open(image).convert("RGB")
        orig_w, orig_h = image.size
        if letterbox:
            s = min(th / max(orig_h, 1), tw / max(orig_w, 1))
            nw, nh = int(round(orig_w * s)), int(round(orig_h * s))
            dx, dy = (tw - nw) // 2, (th - nh) // 2
            canvas = np.full((th, tw, 3), 114, np.uint8)
            canvas[dy:dy + nh, dx:dx + nw] = np.asarray(
                image.resize((nw, nh), Image.Resampling.BILINEAR), np.uint8)
            arr = canvas.astype(np.float32) / 255.0
            scale = np.asarray([s, s], np.float32)
            offset = np.asarray([dx, dy], np.float32)
        else:
            arr = np.asarray(
                image.resize((tw, th), Image.Resampling.BILINEAR),
                dtype=np.float32) / 255.0
            scale = np.asarray([tw / max(orig_w, 1), th / max(orig_h, 1)],
                               np.float32)
            offset = np.zeros(2, np.float32)
    else:
        # array input: keep float precision (no uint8 round trip)
        arr = np.asarray(image, dtype=np.float32)
        if arr.max() > 1.5:  # assume uint8 range
            arr = arr / 255.0
        orig_h, orig_w = arr.shape[:2]
        if letterbox:
            s = min(th / max(orig_h, 1), tw / max(orig_w, 1))
            nw, nh = int(round(orig_w * s)), int(round(orig_h * s))
            dx, dy = (tw - nw) // 2, (th - nh) // 2
            canvas = np.full((th, tw, arr.shape[-1]), 114.0 / 255.0,
                             np.float32)
            canvas[dy:dy + nh, dx:dx + nw] = _resize_bilinear(arr, nh, nw)
            arr = canvas
            scale = np.asarray([s, s], np.float32)
            offset = np.asarray([dx, dy], np.float32)
        else:
            if arr.shape[:2] != (th, tw):
                arr = _resize_bilinear(arr, th, tw)
            scale = np.asarray([tw / max(orig_w, 1), th / max(orig_h, 1)],
                               np.float32)
            offset = np.zeros(2, np.float32)
    arr = (arr - IMAGENET_MEAN) / IMAGENET_STD
    if return_geometry:
        return arr[None], scale, offset
    return arr[None]


def _resize_bilinear(arr: np.ndarray, h: int, w: int) -> np.ndarray:
    """HWC float32 → (h, w, C): half-pixel bilinear with an antialiasing
    triangle filter when shrinking (``jax.image.resize(..., "bilinear")``)."""
    x = torch.from_numpy(np.ascontiguousarray(arr)).permute(2, 0, 1)[None]
    y = F.interpolate(x, size=(h, w), mode="bilinear", align_corners=False,
                      antialias=True)
    return y[0].permute(1, 2, 0).numpy()


def decode_raw_predictions(preds: torch.Tensor, anchors: torch.Tensor,
                           strides: torch.Tensor, reg_max: int = 16):
    """Raw head output → (boxes_xyxy (N, M, 4) pixels, class scores (N, M,
    nc) sigmoid): DFL expectation → dist2bbox → ×stride."""
    preds = preds.float()
    ltrb = dfl_decode(preds[..., :4 * reg_max], reg_max)
    boxes = dist2bbox(ltrb, anchors[None], xywh=False) * strides[None]
    return boxes, torch.sigmoid(preds[..., 4 * reg_max:])


class Detector:
    """One model on one device, with the serving entry points.

    ``device`` defaults to ``"cuda"``; there is no fallback to the CPU when
    CUDA is missing — pass ``device="cpu"`` to run the plain twins."""

    def __init__(self, width: Sequence[int], depth: Sequence[int],
                 csp: Sequence[bool], num_classes: int, reg_max: int = 16,
                 precision: str = "bfloat16",
                 input_size: Tuple[int, int] = (640, 640),
                 device: str | torch.device = "cuda"):
        self.policy = resolve_policy(precision)
        self.width, self.depth, self.csp = tuple(width), tuple(depth), \
            tuple(csp)
        self.num_classes = num_classes
        self.reg_max = reg_max
        self.input_size = tuple(input_size)
        self.device = torch.device(device)
        self._mean = torch.from_numpy(IMAGENET_MEAN).to(self.device)
        self._std = torch.from_numpy(IMAGENET_STD).to(self.device)
        self.model: Optional[YoloModel] = None
        self._fused = False

    def _build(self, fused: bool) -> YoloModel:
        return YoloModel(self.width, self.depth, self.csp, self.num_classes,
                         self.reg_max, self.policy, fused=fused)

    def _install(self, model: YoloModel, fused: bool) -> None:
        model = model.to(self.device, memory_format=torch.channels_last)
        if fused:
            # folded in fp32; cast once so each conv reads the compute dtype
            model = model.to(self.policy.compute_dtype)
        self.model = model.eval()
        self._fused = fused

    def init(self, seed: int = 0) -> Dict[str, torch.Tensor]:
        """Seeded random weights (unfused); returns the state dict."""
        model = self._build(fused=False)
        init_weights(model, seed)
        self._install(model, fused=False)
        return self.model.state_dict()

    def load_variables(self, variables: Mapping[str, Any]) -> None:
        """Load a JAX variable tree given as nested dicts of numpy arrays:
        ``{"params", "batch_stats"}`` (unfused) or ``{"params"}`` (fused);
        or the port's own variables, a flat dict of tensors by state-dict
        key (``TrainState.eval_variables``), which are copied."""
        if all(isinstance(v, torch.Tensor) for v in variables.values()):
            fused = not any(".bn." in key for key in variables)
            model = self._build(fused)
            state = {**model.state_dict(),
                     **{k: v.detach().clone() for k, v in variables.items()}}
        else:
            fused = "batch_stats" not in variables
            model = self._build(fused)
            state = from_jax_variables(variables, model)
        model.load_state_dict(state, strict=True)
        self._install(model, fused)

    def fuse(self) -> "Detector":
        """Fold conv+BN for inference: each ConvBN then runs conv(+bias)+act."""
        assert self.model is not None, "call .init() or load weights"
        if self._fused:
            return self
        model = self._build(fused=True)
        model.load_state_dict(fuse_state_dict(self.model.state_dict()),
                              strict=True)
        self._install(model, fused=True)
        return self

    @torch.inference_mode()
    def __call__(self, x):
        assert self.model is not None, "call .init() or load weights"
        return self.model(torch.as_tensor(x).to(self.device))

    def inference(self, image, conf_thres: float = 0.25,
                  iou_thres: float = 0.45, max_det: int = 300,
                  letterbox: bool = False, original_coords: bool = False):
        """One image (path / PIL / array) → list with one (n, 6)
        [x1, y1, x2, y2, conf, cls] array, in model-input pixels, or in the
        source image's with ``original_coords=True``."""
        arr, scale, offset = preprocess_image(
            image, self.input_size, letterbox=letterbox,
            return_geometry=True)
        lists = nms_to_lists(self.serve(torch.from_numpy(arr),
                                        conf_thres=conf_thres,
                                        iou_thres=iou_thres,
                                        max_det=max_det))
        if original_coords:
            for det in lists:
                det[:, [0, 2]] = (det[:, [0, 2]] - offset[0]) / scale[0]
                det[:, [1, 3]] = (det[:, [1, 3]] - offset[1]) / scale[1]
        return lists

    @torch.inference_mode()
    def serve(self, images, conf_thres: float = 0.25, iou_thres: float = 0.45,
              max_det: int = 300, top_k: int = 1024, merge: bool = False,
              class_filter: Optional[Tuple[int, ...]] = None,
              multi_label: bool = False,
              device_preprocess: bool = False) -> NMSResult:
        """Batched serving: preprocessed NHWC batch → fixed-shape
        :class:`NMSResult`. ``device_preprocess=True`` takes resized raw
        uint8 NHWC and scales and normalises it on the device (fp32, the
        arithmetic of :func:`preprocess_image`). Nothing here waits for
        the device."""
        assert self.model is not None, "call .init() or load weights"
        images = torch.as_tensor(images).to(self.device)
        if device_preprocess:
            images = (images.float() / 255.0 - self._mean) / self._std
        preds, anchors, strides = self.model(images)
        boxes, scores = decode_raw_predictions(preds, anchors, strides,
                                               self.reg_max)
        return batched_nms(boxes, scores.amax(-1), scores.argmax(-1),
                           conf_thres=conf_thres, iou_thres=iou_thres,
                           max_det=max_det, top_k=top_k, merge=merge,
                           class_filter=class_filter,
                           multi_label=multi_label,
                           all_scores=scores if multi_label else None)
