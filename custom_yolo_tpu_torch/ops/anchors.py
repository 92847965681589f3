"""Anchor points (counterpart of ``custom_yolo_tpu/ops/anchors.py``).

Cell centres are built in float64 numpy and cast to float32, as the JAX
package does, so both packages hold bit-identical anchors.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np
import torch


def make_anchors(feat_shapes: Sequence[Tuple[int, int]],
                 strides: Sequence[int], offset: float = 0.5,
                 dtype: torch.dtype = torch.float32,
                 device: torch.device | str = "cpu"
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(H, W) per level → anchors (M, 2) as (x, y) cell centres, x fastest,
    and the stride of each anchor (M, 1)."""
    assert len(feat_shapes) == len(strides)
    anchor_parts: List[np.ndarray] = []
    stride_parts: List[np.ndarray] = []
    for (h, w), stride in zip(feat_shapes, strides):
        sx = np.arange(w, dtype=np.float64) + offset
        sy = np.arange(h, dtype=np.float64) + offset
        gx, gy = np.meshgrid(sx, sy)
        anchor_parts.append(np.stack([gx, gy], axis=-1).reshape(-1, 2))
        stride_parts.append(np.full((h * w, 1), float(stride)))
    anchors = np.concatenate(anchor_parts, axis=0).astype(np.float32)
    stride_arr = np.concatenate(stride_parts, axis=0).astype(np.float32)
    return (torch.from_numpy(anchors).to(device=device, dtype=dtype),
            torch.from_numpy(stride_arr).to(device=device, dtype=dtype))


def level_shapes(input_size: Tuple[int, int],
                 strides: Sequence[int] = (8, 16, 32)) -> List[Tuple[int, int]]:
    """Feature-map (H, W) of each detection level at an input size."""
    h, w = input_size
    return [(h // s, w // s) for s in strides]


def num_anchors(input_size: Tuple[int, int],
                strides: Sequence[int] = (8, 16, 32)) -> int:
    return sum(h * w for h, w in level_shapes(input_size, strides))
