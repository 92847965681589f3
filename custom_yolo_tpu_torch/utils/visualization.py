"""Notebook and report plotting (the port's own copy of
``custom_yolo_tpu/utils/visualization.py``): image display, box overlay and
original / ground truth / prediction panels. matplotlib is imported inside
each function, so headless training never loads it. Images are numpy
arrays (uint8, or ImageNet-normalised floats, which are undone for
display) or CPU tensors."""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Union

import numpy as np


def _denormalize(image: np.ndarray) -> np.ndarray:
    """Undo ImageNet normalization for display if the image looks float."""
    if hasattr(image, "detach"):       # a tensor (bf16 has no numpy dtype)
        image = image.detach().cpu()
        image = (image.float() if image.is_floating_point()
                 else image).numpy()
    img = np.asarray(image)
    if img.dtype == np.uint8:
        return img
    mean = np.array([0.485, 0.456, 0.406])
    std = np.array([0.229, 0.224, 0.225])
    img = img * std + mean
    return np.clip(img * 255, 0, 255).astype(np.uint8)


def show_image(image, title: str = "", ax=None):
    """Display one image."""
    import matplotlib.pyplot as plt

    if ax is None:
        _, ax = plt.subplots(figsize=(8, 8))
    ax.imshow(_denormalize(image))
    ax.set_title(title)
    ax.axis("off")
    return ax


def draw_bboxes(image, boxes_xywh: np.ndarray,
                labels: Optional[Sequence] = None,
                scores: Optional[Sequence[float]] = None,
                class_names: Optional[Dict[int, str]] = None,
                color: str = "lime", ax=None, title: str = ""):
    """Overlay centre-xywh boxes."""
    import matplotlib.patches as patches
    import matplotlib.pyplot as plt

    if ax is None:
        _, ax = plt.subplots(figsize=(8, 8))
    ax.imshow(_denormalize(image))
    boxes_xywh = np.asarray(boxes_xywh).reshape(-1, 4)
    for i, (cx, cy, w, h) in enumerate(boxes_xywh):
        rect = patches.Rectangle((cx - w / 2, cy - h / 2), w, h,
                                 linewidth=1.5, edgecolor=color,
                                 facecolor="none")
        ax.add_patch(rect)
        text = ""
        if labels is not None:
            lbl = int(labels[i])
            text = class_names.get(lbl, str(lbl)) if class_names else str(lbl)
        if scores is not None:
            text += f" {float(scores[i]):.2f}"
        if text:
            ax.text(cx - w / 2, cy - h / 2 - 2, text, color=color,
                    fontsize=8, backgroundcolor="black")
    ax.set_title(title)
    ax.axis("off")
    return ax


def visualize_comparison(image, gt_boxes_xywh, gt_labels,
                         pred_boxes_xywh, pred_labels,
                         pred_scores=None,
                         class_names: Optional[Dict[int, str]] = None,
                         save_path: Optional[str] = None):
    """Original / ground-truth / prediction three-panel figure."""
    import matplotlib.pyplot as plt

    fig, axes = plt.subplots(1, 3, figsize=(21, 7))
    show_image(image, "original", ax=axes[0])
    draw_bboxes(image, gt_boxes_xywh, gt_labels, class_names=class_names,
                color="lime", ax=axes[1], title="ground truth")
    draw_bboxes(image, pred_boxes_xywh, pred_labels, pred_scores,
                class_names=class_names, color="red", ax=axes[2],
                title="predictions")
    fig.tight_layout()
    if save_path:
        fig.savefig(save_path, dpi=120, bbox_inches="tight")
    return fig
