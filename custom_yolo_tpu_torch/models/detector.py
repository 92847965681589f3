"""Full detector and its serving wrapper (counterpart of
``custom_yolo_tpu/models/detector.py``).

:class:`YoloModel` is Backbone + Neck + Head on NHWC input. :class:`Detector`
holds one model on one device and serves it: ``init`` (seeded weights) or
``load_variables`` (a JAX variable tree as numpy, or a train state's
variables), ``fuse`` (fold each
BatchNorm into its conv), ``optimize_for_serving`` (the exact
output-preserving transforms: space-to-depth stem and merged C3K branch
convs), ``quantize`` and ``calibrate`` (int8 serving, dynamic then
static), ``save_weights`` and ``load_weights`` (the weights and the
transforms that made them, on disk), ``__call__`` (raw head output),
``serve``
(forward + DFL decode + class-aware batched NMS, fixed-shape result,
replayed as CUDA graphs from a signature's second call:
``models.serve_graph``) and ``inference`` (one image in, ``(n, 6)``
detections out).
:func:`create_train_model` gives the unfused model in training mode for
the train step.
"""

from __future__ import annotations

import contextlib
import json
import os
from typing import Any, Dict, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from custom_yolo_tpu_torch.core.dtypes import DTypePolicy, resolve_policy
from custom_yolo_tpu_torch.models.backbone import (BACKBONE_STAGES,
                                                   Backbone,
                                                   stem_kernel_to_s2d)
from custom_yolo_tpu_torch.models import yolo12
from custom_yolo_tpu_torch.models.head import CLS_BIAS, Head
from custom_yolo_tpu_torch.models.neck import Neck
from custom_yolo_tpu_torch.models.serve_graph import (Phase, ServeGraphs,
                                                      run_phases)
from custom_yolo_tpu_torch.nn.blocks import (BN_EPS, MERGE_MIN_HALF,
                                             _QuantConv, frozen_statistics)
from custom_yolo_tpu_torch.ops.boxes import dist2bbox
from custom_yolo_tpu_torch.ops.dfl import dfl_decode
from custom_yolo_tpu_torch.ops.nms import NMSResult, batched_nms, nms_to_lists
from custom_yolo_tpu_torch.ops.quant import (DEFAULT_QUANT_SKIP,
                                             bake_static_scales,
                                             has_static_scales,
                                             quantize_fused_params)
from custom_yolo_tpu_torch.utils.checkpoint import (TRANSFORMS_FILE,
                                                    WEIGHTS_FILE)
from custom_yolo_tpu_torch.utils.profiling import span
from custom_yolo_tpu_torch.utils.weights import from_jax_variables

# ImageNet normalisation (reference src/data/transforms.py:12-13)
IMAGENET_MEAN = np.array([0.485, 0.456, 0.406], dtype=np.float32)
IMAGENET_STD = np.array([0.229, 0.224, 0.225], dtype=np.float32)

# the architectures a model is built as, with their backbone's stages by
# the names that quant_skip takes
ARCH_STAGES = {"yolo11": BACKBONE_STAGES, "yolo12": yolo12.BACKBONE_STAGES}


class YoloModel(nn.Module):
    """Backbone + Neck + Head. Input NHWC float; output (preds (N, M,
    4·reg_max+nc), anchors (M, 2), strides (M, 1)). ``arch`` chooses the
    backbone and neck: ``"yolo11"`` (``models/backbone.py``, ``neck.py``)
    or ``"yolo12"`` (``models/yolo12.py``, which takes neither serving
    form); the head is the same. ``s2d_stem`` and
    ``merged`` select the exactly equivalent serving forms of the stem and
    of the C3K blocks (``models.backbone``, ``nn.blocks.C3K``); their
    weights come from :func:`convert_stem_variables` and
    :func:`merge_c3k_params`. ``quantized`` (fused only) makes every ConvBN
    int8 except the backbone stages in ``quant_skip``; the weights come
    from :func:`ops.quant.quantize_fused_params` with the same skip.
    ``remat`` recomputes the backbone's and the neck's activations in the
    backward pass of a training forward (``torch.utils.checkpoint``), as
    the JAX model's ``nn.remat`` does; the recompute leaves the BatchNorm
    running statistics alone."""

    def __init__(self, width: Sequence[int], depth: Sequence[int],
                 csp: Sequence[bool], num_classes: int, reg_max: int = 16,
                 policy: DTypePolicy = DTypePolicy(), fused: bool = False,
                 s2d_stem: bool = False, merged: bool = False,
                 quantized: bool = False, quant_skip: Sequence[str] = (),
                 remat: bool = False, arch: str = "yolo11"):
        super().__init__()
        self.policy = policy
        self.remat = remat
        if arch == "yolo11":
            self.net = Backbone(width, depth, csp, fused=fused,
                                s2d_stem=s2d_stem, merged=merged,
                                quantized=quantized, quant_skip=quant_skip)
            self.fpn = Neck(width, depth, csp, fused=fused, merged=merged,
                            quantized=quantized)
        elif arch == "yolo12":
            if s2d_stem or merged:
                raise ValueError("yolo12 has no space-to-depth stem or "
                                 "merged C3K form")
            self.net = yolo12.Yolo12Backbone(width, depth, csp, fused=fused,
                                             quantized=quantized,
                                             quant_skip=quant_skip)
            self.fpn = yolo12.Yolo12Neck(width, depth, csp, fused=fused,
                                         quantized=quantized)
        else:
            raise ValueError(f"unknown architecture {arch!r}; known: "
                             f"{sorted(ARCH_STAGES)}")
        self.head = Head(num_classes, (width[3], width[4], width[5]),
                         reg_max=reg_max, fused=fused, quantized=quantized)

    def forward(self, x: torch.Tensor):
        x = x.to(self.policy.compute_dtype).permute(0, 3, 1, 2)
        if self.remat and self.training and torch.is_grad_enabled():
            feats = self._recomputed(self.fpn, self._recomputed(self.net, x))
        else:
            feats = self.fpn(self.net(x))
        with span("fwd/head"):
            return self.head(feats)

    @staticmethod
    def _recomputed(module: nn.Module, x):
        """``module(x)`` keeping only its input for the backward pass."""
        return checkpoint(module, x, use_reentrant=False,
                          preserve_rng_state=False,
                          context_fn=lambda: (contextlib.nullcontext(),
                                              frozen_statistics(module)))


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
                       variables: Optional[Mapping[str, Any]] = None,
                       remat: bool = False) -> YoloModel:
    """The unfused model for the train step: in training mode, on
    ``device`` (``cuda`` unless the caller says otherwise; no fallback),
    ``channels_last``. Weights from ``variables`` (a JAX
    ``{"params", "batch_stats"}`` tree as numpy) when given, else seeded
    random ones. ``remat``: see :class:`YoloModel`."""
    model = YoloModel(width, depth, csp, num_classes, reg_max,
                      resolve_policy(precision), fused=False, remat=remat)
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


STEM_KEY = "net.p1_conv.conv.weight"


def convert_stem_variables(state: Mapping[str, torch.Tensor]
                           ) -> Dict[str, torch.Tensor]:
    """State dict of a standard model → that of the same model with
    ``s2d_stem=True``: only the stem kernel is re-expressed
    (``stem_kernel_to_s2d``), so it works on fused and unfused states
    alike (counterpart of the reference's ``convert_stem_variables``)."""
    out = dict(state)
    stem = state[STEM_KEY]
    hwio = stem.detach().float().cpu().permute(2, 3, 1, 0).numpy()
    out[STEM_KEY] = torch.from_numpy(stem_kernel_to_s2d(hwio)).permute(
        3, 2, 0, 1).contiguous().to(stem.device, stem.dtype)
    return out


def merge_c3k_params(state: Mapping[str, torch.Tensor]
                     ) -> Dict[str, torch.Tensor]:
    """Fused state dict → that of ``merged=True`` modules: every C3K's
    ``conv1``/``conv2`` (two convs on the same input) become one ``conv12``,
    kernels, biases and int8 scales concatenated on the output-channel axis
    and calibrated input scales merged by their maximum (both read the same
    tensor); the counterpart of the reference's ``merge_c3k_params``. A C3K
    is told from a C3K2, which also owns ``conv1``/``conv2``, by its
    ``res0`` child; those with fewer than ``MERGE_MIN_HALF`` channels per
    branch stay as they are, which is the module's own gate."""
    suffix = ".conv1.conv.weight"
    prefixes = [key[:-len(suffix)] for key, value in state.items()
                if key.endswith(suffix)
                and f"{key[:-len(suffix)]}.res0.conv1.conv.weight" in state
                and value.shape[0] >= MERGE_MIN_HALF]
    out = dict(state)
    for prefix in prefixes:
        if f"{prefix}.conv1.bn.weight" in state:
            raise ValueError("merge_c3k_params expects a fused state (fuse "
                             "first)")
        for leaf in ("weight", "bias", "scale", "in_scale"):
            if f"{prefix}.conv1.conv.{leaf}" not in state:
                continue
            a = out.pop(f"{prefix}.conv1.conv.{leaf}")
            b = out.pop(f"{prefix}.conv2.conv.{leaf}")
            out[f"{prefix}.conv12.conv.{leaf}"] = (
                torch.maximum(a, b) if leaf == "in_scale"
                else torch.cat([a, b], dim=0))
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


def normalize_uint8(images: torch.Tensor, mean: torch.Tensor,
                    std: torch.Tensor,
                    out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Resized uint8 NHWC → the model's normalised fp32 input, the
    arithmetic of :func:`preprocess_image`: ÷255, minus ``mean``, ÷``std``
    (the last division written into ``out`` where given).
    255 is a tensor on the images' device: CUDA turns a division by a
    Python number into a multiplication by its reciprocal, which misses the
    correctly rounded quotient for about half of the 256 levels."""
    x = images.float()
    return torch.div(x / x.new_full((), 255.0) - mean, std, out=out)


def resize_bilinear(x: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """HWC float tensor → (h, w, C): half-pixel bilinear with an
    antialiasing triangle filter when shrinking (``jax.image.resize(...,
    "bilinear")``)."""
    y = F.interpolate(x.permute(2, 0, 1)[None], size=(h, w),
                      mode="bilinear", align_corners=False, antialias=True)
    return y[0].permute(1, 2, 0)


def _resize_bilinear(arr: np.ndarray, h: int, w: int) -> np.ndarray:
    """:func:`resize_bilinear` of a float32 numpy array."""
    return resize_bilinear(torch.from_numpy(np.ascontiguousarray(arr)), h,
                           w).numpy()


def decode_raw_predictions(preds: torch.Tensor, anchors: torch.Tensor,
                           strides: torch.Tensor, reg_max: int = 16):
    """Raw head output → (boxes_xyxy (N, M, 4) pixels, class scores (N, M,
    nc) sigmoid): DFL expectation → dist2bbox → ×stride."""
    preds = preds.float()
    ltrb = dfl_decode(preds[..., :4 * reg_max], reg_max)
    boxes = dist2bbox(ltrb, anchors[None], xywh=False) * strides[None]
    return boxes, torch.sigmoid(preds[..., 4 * reg_max:])


def serve_phases(model: YoloModel, reg_max: int, *, conf_thres: float,
                 iou_thres: float, max_det: int, top_k: int, merge: bool,
                 class_filter: Optional[Tuple[int, ...]],
                 multi_label: bool) -> Tuple[Phase, ...]:
    """The phases of serving a preprocessed NHWC batch, as (span, fn)
    pairs, each fn taking the previous one's output: ``serve/forward``
    (the model), ``serve/decode`` (DFL decode) and ``serve/nms``
    (class-aware batched NMS, a fixed-shape :class:`NMSResult`)."""
    def decode(out):
        preds, anchors, strides = out
        return decode_raw_predictions(preds, anchors, strides, reg_max)

    def nms(out):
        boxes, scores = out
        return batched_nms(boxes, scores.amax(-1), scores.argmax(-1),
                           conf_thres=conf_thres, iou_thres=iou_thres,
                           max_det=max_det, top_k=top_k, merge=merge,
                           class_filter=class_filter,
                           multi_label=multi_label,
                           all_scores=scores if multi_label else None)

    return (("serve/forward", model), ("serve/decode", decode),
            ("serve/nms", nms))


def serve_pipeline(model: YoloModel, images: torch.Tensor, reg_max: int,
                   *, conf_thres: float, iou_thres: float, max_det: int,
                   top_k: int, merge: bool,
                   class_filter: Optional[Tuple[int, ...]],
                   multi_label: bool) -> NMSResult:
    """The body of :meth:`Detector.serve` on a preprocessed NHWC batch,
    run eagerly: :func:`serve_phases`, each in its span.
    ``export.export_serving`` traces it, with no profiler running, so its
    graph holds no span."""
    return run_phases(serve_phases(
        model, reg_max, conf_thres=conf_thres, iou_thres=iou_thres,
        max_det=max_det, top_k=top_k, merge=merge, class_filter=class_filter,
        multi_label=multi_label), images)


def _has_key(tree: Mapping[str, Any], name: str) -> bool:
    return any(key == name or (isinstance(value, Mapping)
                               and _has_key(value, name))
               for key, value in tree.items())


def _int8_paths(tree: Mapping[str, Any], path: str = "") -> list:
    """Dotted paths of the int8 leaves of a nested variable tree."""
    out = []
    for key, value in tree.items():
        if isinstance(value, Mapping):
            out += _int8_paths(value, f"{path}{key}.")
        elif np.asarray(value).dtype == np.int8:
            out.append(f"{path}{key}")
    return out


def _quant_layout(int8_keys: Sequence[str], stages: Sequence[str]
                  ) -> Tuple[bool, Tuple[str, ...]]:
    """(quantized, quant_skip) of a state whose int8 leaves are these: the
    skipped stages are the backbone's ``stages`` that hold none."""
    if not int8_keys:
        return False, ()
    return True, tuple(stage for stage in stages
                       if not any(k.startswith(f"net.{stage}.")
                                  for k in int8_keys))


class Detector:
    """One model on one device, with the serving entry points.

    ``device`` defaults to ``"cuda"``; there is no fallback to the CPU when
    CUDA is missing — pass ``device="cpu"`` to run the plain twins.
    ``arch`` is :class:`YoloModel`'s: ``"yolo12"`` (``width``, ``depth``
    and ``csp`` from ``models.yolo12.SCALES``) takes the port's own
    weights only, and no ``optimize_for_serving``."""

    def __init__(self, width: Sequence[int], depth: Sequence[int],
                 csp: Sequence[bool], num_classes: int, reg_max: int = 16,
                 precision: str = "bfloat16",
                 input_size: Tuple[int, int] = (640, 640),
                 device: str | torch.device = "cuda", arch: str = "yolo11"):
        if arch not in ARCH_STAGES:
            raise ValueError(f"unknown architecture {arch!r}; known: "
                             f"{sorted(ARCH_STAGES)}")
        self.arch = arch
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
        self._s2d_stem = False
        self._merged = False
        # optimize_for_serving was asked for: fuse() then merges as well
        self._optimized = False
        self._quantized = False
        self._quant_skip: Tuple[str, ...] = ()
        # a fused model's state as folded, fp32 (int8 where quantized)
        self._state: Optional[Dict[str, torch.Tensor]] = None
        # serve's CUDA graphs, by call signature
        self._graphs = ServeGraphs()

    def _build(self, fused: bool) -> YoloModel:
        return YoloModel(self.width, self.depth, self.csp, self.num_classes,
                         self.reg_max, self.policy, fused=fused,
                         s2d_stem=self._s2d_stem, merged=self._merged,
                         quantized=self._quantized,
                         quant_skip=self._quant_skip, arch=self.arch)

    def _install(self, model: YoloModel, fused: bool) -> None:
        # the graphs captured the model that this one replaces
        self._graphs.clear()
        model = model.to(self.device, memory_format=torch.channels_last)
        self._state = None
        if fused:
            # the transforms after fuse() start from the fp32 fold, as the
            # JAX package keeps its variables in fp32; the model's float
            # convs are cast once so that each reads the compute dtype, and
            # the int8 convs keep their fp32 scales and bias
            self._state = {k: v.detach().clone()
                           for k, v in model.state_dict().items()}
            for module in model.modules():
                if isinstance(module, nn.Conv2d):
                    module.to(self.policy.compute_dtype)
        if self.model is not None:
            # the opt-in survives fuse() and optimize_for_serving()
            model.head.fused_cls_tower = self.model.head.fused_cls_tower
        self.model = model.eval()
        self._fused = fused

    def _rebuild(self, state: Mapping[str, torch.Tensor], fused: bool
                 ) -> None:
        model = self._build(fused)
        model.load_state_dict(state, strict=True)
        self._install(model, fused)

    def _transform_state(self) -> Dict[str, torch.Tensor]:
        """The state the transforms start from: the fused model's kept fold
        or the unfused model's own (fp32) state."""
        return dict(self._state) if self._fused else self.model.state_dict()

    def init(self, seed: int = 0) -> Dict[str, torch.Tensor]:
        """Seeded random weights (unfused); returns the state dict."""
        self._s2d_stem = self._merged = self._optimized = False
        self._quantized, self._quant_skip = False, ()
        model = self._build(fused=False)
        init_weights(model, seed)
        self._install(model, fused=False)
        return self.model.state_dict()

    def load_variables(self, variables: Mapping[str, Any]) -> None:
        """Load a JAX variable tree given as nested dicts of numpy arrays:
        ``{"params", "batch_stats"}`` (unfused) or ``{"params"}`` (fused);
        or the port's own variables, a flat dict of tensors by state-dict
        key (``TrainState.eval_variables``), which are copied. A tree that
        already has the space-to-depth stem (a 2×2 stem kernel), merged C3K
        convs (``conv12``) and/or int8 leaves, dynamic or calibrated, is
        taken as it is; the stages left float give ``quant_skip``."""
        if all(isinstance(v, torch.Tensor) for v in variables.values()):
            fused = not any(".bn." in key for key in variables)
            self._s2d_stem = variables[STEM_KEY].shape[-1] == 2
            self._merged = any(".conv12." in key for key in variables)
            self._quantized, self._quant_skip = _quant_layout(
                [k for k, v in variables.items() if v.dtype == torch.int8],
                ARCH_STAGES[self.arch])
            model = self._build(fused)
            state = {**model.state_dict(),
                     **{k: v.detach().clone() for k, v in variables.items()}}
        else:
            if self.arch != "yolo11":
                raise ValueError(f"{self.arch} loads the port's own "
                                 "variables only, not a JAX tree")
            fused = "batch_stats" not in variables
            params = variables["params"]
            stem = params["net"]["p1_conv"]["conv"]["kernel"]
            self._s2d_stem = tuple(stem.shape[:2]) == (2, 2)
            self._merged = _has_key(params, "conv12")
            self._quantized, self._quant_skip = _quant_layout(
                _int8_paths(params), BACKBONE_STAGES)
            model = self._build(fused)
            state = from_jax_variables(variables, model)
        self._optimized = self._s2d_stem or self._merged
        model.load_state_dict(state, strict=True)
        self._install(model, fused)

    def _transform_flags(self) -> Dict[str, Any]:
        """The transforms that made the current weights, with the keys and
        values of the JAX ``Detector._transform_flags``."""
        return {"fused": self._fused, "s2d_stem": self._s2d_stem,
                "merged": self._merged, "quantized": self._quantized,
                "quant_skip": list(self._quant_skip),
                "static_quant": bool(self.model is not None
                                     and self._quantized
                                     and has_static_scales(self._state))}

    def save_weights(self, path: str) -> None:
        """Write the weights to the directory ``path``: ``weights.pt``, a
        ``torch.save`` of the flat state dict on the CPU, and the
        ``transforms.json`` sidecar of :meth:`_transform_flags`. A fused
        detector saves its fp32 fold (int8 leaves where quantized), not its
        convs cast to the compute dtype, so a reloaded detector serves and
        quantizes as this one does."""
        assert self.model is not None, "call .init() or load weights"
        os.makedirs(path, exist_ok=True)
        torch.save({k: v.detach().cpu()
                    for k, v in self._transform_state().items()},
                   os.path.join(path, WEIGHTS_FILE))
        with open(os.path.join(path, TRANSFORMS_FILE), "w") as f:
            json.dump(self._transform_flags(), f)

    def load_weights(self, path: str) -> "Detector":
        """Load what :meth:`save_weights` wrote: the recorded transforms are
        replayed on a fresh template (the model built with them), which the
        saved state must fill exactly. A directory without the sidecar
        holds an unfused state. The fused cls tower is off afterwards."""
        flags: Dict[str, Any] = {}
        sidecar = os.path.join(path, TRANSFORMS_FILE)
        if os.path.exists(sidecar):
            with open(sidecar) as f:
                flags = json.load(f)
        state = torch.load(os.path.join(path, WEIGHTS_FILE),
                           map_location="cpu", weights_only=True)
        if bool(flags.get("static_quant")) != has_static_scales(state):
            raise ValueError(f"{path}: the sidecar's static_quant does not "
                             "match the saved scales")
        self._s2d_stem = bool(flags.get("s2d_stem", False))
        self._merged = bool(flags.get("merged", False))
        self._optimized = self._s2d_stem or self._merged
        self._quantized = bool(flags.get("quantized", False))
        self._quant_skip = tuple(flags.get("quant_skip", ()))
        self.model = None
        self._rebuild(state, fused=bool(flags.get("fused", False)))
        return self

    def fuse(self) -> "Detector":
        """Fold conv+BN for inference: each ConvBN then runs conv(+bias)+act."""
        assert self.model is not None, "call .init() or load weights"
        if self._fused:
            return self
        state = fuse_state_dict(self.model.state_dict())
        if self._optimized and not self._merged:
            state = merge_c3k_params(state)
            self._merged = True
        self._rebuild(state, fused=True)
        return self

    def optimize_for_serving(self) -> "Detector":
        """Apply the exactly output-preserving serving transforms
        (counterpart of the reference's ``optimize_for_tpu``): the
        space-to-depth stem — the stem kernel re-expressed, not retrained —
        and, once fused, the merge of each C3K's ``conv1``/``conv2`` into
        one conv (:func:`merge_c3k_params`). Composes with :meth:`fuse` in
        either order: when this runs first, ``fuse`` merges. YOLO12 has
        neither form and is refused."""
        assert self.model is not None, "call .init() or load weights"
        if self.arch != "yolo11":
            raise ValueError(f"optimize_for_serving: {self.arch} has no "
                             "space-to-depth stem or merged C3K form")
        state = self._transform_state()
        if not self._s2d_stem:
            state = convert_stem_variables(state)
            self._s2d_stem = True
        if self._fused and not self._merged:
            state = merge_c3k_params(state)
            self._merged = True
        self._optimized = True
        self._rebuild(state, self._fused)
        return self

    def quantize(self, stochastic: bool = False,
                 skip: Any = "auto") -> "Detector":
        """Switch to int8 serving: fuse if needed, quantize each ConvBN's
        fp32 folded kernel per output channel (the head's logit projections
        stay float), and rebuild with int8 convs. ``stochastic`` rounds with
        kernel K7 (one launch for all int8 leaves, seed 0 for every leaf, as
        in the JAX package). ``skip``: backbone stages kept float, ``"auto"``
        for ``ops.quant.DEFAULT_QUANT_SKIP``, ``()`` for none.

        Activations are then quantized per batch (*dynamic*, one absmax
        pass per conv); :meth:`calibrate` bakes static scales."""
        assert self.model is not None, "call .init() or load weights"
        if self._quantized:
            return self
        if not self._fused:
            self.fuse()
        skip = DEFAULT_QUANT_SKIP if skip == "auto" else tuple(skip)
        state = quantize_fused_params(self._state, stochastic=stochastic,
                                      skip=skip)
        self._quantized, self._quant_skip = True, skip
        self._rebuild(state, fused=True)
        return self

    def calibrate(self, batches) -> "Detector":
        """Static-quantization calibration: run ``batches`` (preprocessed
        NHWC arrays or tensors) through the dynamic int8 model, record at
        each int8 conv the largest input scale ×127 it saw, and bake each
        conv's static ``in_scale`` (``ops.quant.bake_static_scales``). On a
        calibration batch the static output then equals the dynamic one."""
        assert self.model is not None, "call .init() or load weights"
        assert self._quantized, "call .quantize() before .calibrate()"
        assert not has_static_scales(self._state), "already calibrated"
        convs = {name: module for name, module in self.model.named_modules()
                 if isinstance(module, _QuantConv)}
        for module in convs.values():
            module.observing, module.observed = True, None
        n = 0
        try:
            for batch in batches:
                self(batch)
                n += 1
        finally:
            for module in convs.values():
                module.observing = False
        assert n, "calibrate() needs at least one batch"
        stats = {name: module.observed for name, module in convs.items()
                 if module.observed is not None}
        self._rebuild(bake_static_scales(self._state, stats), fused=True)
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
        the device beyond the batch's copy to it. Under a running profiler
        the call carries its spans (``utils.profiling.span``): ``serve``
        around ``serve/input`` (the copy to the device and the
        normalisation), ``serve/forward`` (a ``fwd/<stage>`` span a stage
        of the model inside), ``serve/decode`` and ``serve/nms``.

        On a CUDA device the phases after the input run as CUDA graphs
        (``models.serve_graph``) from the second call of a signature: the
        device, the batch's shape and dtype, ``device_preprocess``, the
        other arguments and whether the head takes the fused cls tower.
        The first call of a signature runs eagerly, as does every call on
        the CPU and a signature whose capture failed
        (``utils.profiling.serve_graph_stats`` counts each). A replay runs
        no Python of the model: its forward hooks and ``fwd/<stage>``
        spans run only at the capture. The result is a copy out of the
        graphs' buffers, so batches may be held in flight; one detector's
        graphs serve one CUDA stream at a time (a call waits for the
        previous call's replay, on whatever stream it ran). A batch that
        already lies on the device is copied into the graphs' input."""
        assert self.model is not None, "call .init() or load weights"
        images = torch.as_tensor(images)
        if class_filter is not None:
            class_filter = tuple(class_filter)
        options = dict(conf_thres=conf_thres, iou_thres=iou_thres,
                       max_det=max_det, top_k=top_k, merge=merge,
                       class_filter=class_filter, multi_label=multi_label)
        tower, packs = self.model.head.graph_inputs()
        key = (self.device, tuple(images.shape), images.dtype,
               device_preprocess, *options.values(), tower,
               tuple(map(id, packs)))
        dtype = torch.float32 if device_preprocess else images.dtype
        with span("serve"):
            return self._graphs.run(
                key, self.device,
                lambda out: self._input(images, device_preprocess, out),
                lambda: torch.empty_like(images, dtype=dtype,
                                         device=self.device),
                serve_phases(self.model, self.reg_max, **options),
                held=packs)

    def _input(self, images: torch.Tensor, device_preprocess: bool,
               out: Optional[torch.Tensor] = None) -> torch.Tensor:
        """``serve``'s input phase: the batch on the device, normalised
        where it is raw uint8; written into ``out`` where given."""
        if device_preprocess:
            return normalize_uint8(images.to(self.device), self._mean,
                                   self._std, out=out)
        if out is None:
            return images.to(self.device)
        return out.copy_(images)
