"""Anchor-free decoupled detect head with DFL box regression (counterpart
of ``custom_yolo_tpu/models/head.py``): per level a box tower (two 3×3
ConvBNs → 1×1 to 4·reg_max logits) and a cls tower (depthwise + pointwise
twice → 1×1 to nc logits), flattened anchor-major and concatenated over
levels p3, p4, p5.

``Head.fused_cls_tower`` (off by default, the counterpart of the
reference's ``pallas_cls_tower`` field) sends the cls tower of a fused
model in evaluation mode through :func:`ops.head_kernel.cls_tower`, for
every level whose channel counts the kernel takes. Switching it on packs
the towers' weights as the kernel reads them, once;
:meth:`Head.pack_cls_tower` packs them again after a later change. A
quantized head (int8 towers; ``box{i}_out`` and ``cls{i}_out`` stay float)
never takes the kernel, as in the JAX package."""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Sequence, Tuple

import torch
from torch import nn

from custom_yolo_tpu_torch.nn.blocks import ConvBN, conv2d
from custom_yolo_tpu_torch.ops.anchors import make_anchors
from custom_yolo_tpu_torch.ops.head_kernel import cls_tower

# the fused cls tower's gate, the reference's: middle and input channels in
# whole groups of 128
CLS_TOWER_MULTIPLE = 128

PRIOR_PROB = 1e-2  # classification bias prior (reference head.py:68)
CLS_BIAS = math.log(PRIOR_PROB / (1 - PRIOR_PROB))


class Head(nn.Module):
    def __init__(self, num_classes: int, filters: Sequence[int],
                 reg_max: int = 16, strides: Sequence[int] = (8, 16, 32),
                 fused: bool = False, quantized: bool = False):
        super().__init__()
        nc, rm = num_classes, reg_max
        self.num_classes, self.reg_max = nc, rm
        self.strides = tuple(strides)
        self.fused, self.quantized = fused, quantized
        kw = dict(fused=fused, quantized=quantized)
        self.in_chs = tuple(filters)
        # opt-in: callers set ``model.head.fused_cls_tower = True``
        self._fused_cls_tower = False
        self._cls_packs: List[Optional[Tuple]] = [None] * len(filters)
        box_ch = max(64, filters[0] // 4)
        cls_ch = max(80, filters[0], nc)
        self.cls_ch = cls_ch
        for i, in_ch in enumerate(filters):
            layers = {
                f"box{i}_conv1": ConvBN(in_ch, box_ch, 3, padding=1, **kw),
                f"box{i}_conv2": ConvBN(box_ch, box_ch, 3, padding=1, **kw),
                f"box{i}_out": nn.Conv2d(box_ch, 4 * rm, 1),
                f"cls{i}_dw1": ConvBN(in_ch, in_ch, 3, padding=1,
                                      groups=in_ch, **kw),
                f"cls{i}_pw1": ConvBN(in_ch, cls_ch, **kw),
                f"cls{i}_dw2": ConvBN(cls_ch, cls_ch, 3, padding=1,
                                      groups=cls_ch, **kw),
                f"cls{i}_pw2": ConvBN(cls_ch, cls_ch, **kw),
                f"cls{i}_out": nn.Conv2d(cls_ch, nc, 1),
            }
            for name, layer in layers.items():
                self.add_module(name, layer)
        self._anchors: Dict[Tuple, Tuple[torch.Tensor, torch.Tensor]] = {}

    @property
    def no(self) -> int:
        return self.num_classes + 4 * self.reg_max

    def anchors(self, feat_shapes: List[Tuple[int, int]],
                device: torch.device) -> Tuple[torch.Tensor, torch.Tensor]:
        """Anchors and strides for these level shapes, made once per
        (shapes, device)."""
        key = (tuple(feat_shapes), str(device))
        if key not in self._anchors:
            self._anchors[key] = make_anchors(feat_shapes, self.strides,
                                              offset=0.5, device=device)
        return self._anchors[key]

    def _tower(self, x: torch.Tensor, *names: str) -> torch.Tensor:
        for name in names:
            layer = getattr(self, name)
            x = conv2d(x, layer) if isinstance(layer, nn.Conv2d) else layer(x)
        return x

    @property
    def fused_cls_tower(self) -> bool:
        return self._fused_cls_tower

    @fused_cls_tower.setter
    def fused_cls_tower(self, on: bool) -> None:
        self._fused_cls_tower = bool(on)
        if on:
            self.pack_cls_tower()

    def pack_cls_tower(self) -> None:
        """Pack the cls-tower weights of every level the kernel takes as
        :func:`cls_tower` reads them — ``(kernel, bias)`` pairs in the
        weights' own dtype and on their device, depthwise kernels
        ``(3, 3, C)``, 1×1 kernels ``(C_in, C_out)`` — from the ``cls{i}_*``
        submodules. Runs when ``fused_cls_tower`` is switched on, which
        ``Detector`` does after it has installed a model; call it again
        after changing those weights or moving the module. A quantized head
        packs nothing."""
        takes = (self.fused and not self.quantized
                 and self.cls_ch % CLS_TOWER_MULTIPLE == 0)
        for i, in_ch in enumerate(self.in_chs):
            if not (takes and in_ch % CLS_TOWER_MULTIPLE == 0):
                self._cls_packs[i] = None
                continue
            convs = [getattr(self, f"cls{i}_{n}").conv
                     for n in ("dw1", "pw1", "dw2", "pw2")]
            convs.append(getattr(self, f"cls{i}_out"))
            pairs = []
            for conv in convs:
                weight = conv.weight.detach()
                if conv.groups > 1:           # (C, 1, 3, 3) → (3, 3, C)
                    kernel = weight[:, 0].permute(1, 2, 0)
                else:                         # (C_out, C_in, 1, 1) → (in, out)
                    kernel = weight[:, :, 0, 0].t()
                pairs.append((kernel.contiguous(),
                              conv.bias.detach().clone()))
            self._cls_packs[i] = tuple(pairs)

    def graph_inputs(self) -> Tuple[bool, Tuple]:
        """What a captured forward of this head reads beyond its parameters
        and buffers: whether it takes the fused cls tower, and the packed
        weights the kernel reads (new tensors after every
        :meth:`pack_cls_tower`)."""
        return self._fused_cls_tower, tuple(self._cls_packs)

    def forward(self, feats: Sequence[torch.Tensor]):
        use_fused_cls = self._fused_cls_tower and not self.training
        outs = []
        for i, x in enumerate(feats):
            b = self._tower(x, f"box{i}_conv1", f"box{i}_conv2", f"box{i}_out")
            # the kernel defines no gradient: a forward that records one
            # keeps the chain, as SPPF keeps its pooling chain
            if use_fused_cls and self._cls_packs[i] is not None \
                    and not (torch.is_grad_enabled() and x.requires_grad):
                c = cls_tower(
                    x.contiguous(memory_format=torch.channels_last),
                    *self._cls_packs[i])
            else:
                c = self._tower(x, f"cls{i}_dw1", f"cls{i}_pw1",
                                f"cls{i}_dw2", f"cls{i}_pw2", f"cls{i}_out")
            outs.append(torch.cat([b, c], dim=1).flatten(2).transpose(1, 2))
        preds = torch.cat(outs, dim=1)  # (N, M, 4·reg_max + nc)
        anchors, strides = self.anchors(
            [(f.shape[2], f.shape[3]) for f in feats], preds.device)
        return preds, anchors, strides
