"""COCO RLE mask decoding in pure numpy (the port's own copy of
``custom_yolo_tpu/data/coco_rle.py``).

Stands in for the ``pycocotools.mask`` C extension in the offline ETL. Both
COCO RLE container formats are read:

* uncompressed: {"counts": [int, ...], "size": [h, w]}
* compressed:   {"counts": "<LEB128-style string>", "size": [h, w]}

COCO RLE is column-major (Fortran order) runs of alternating 0/1 starting
with zeros. The compressed string packs each count as a variable-length
sequence of 6-bit chunks (offset by 48), with counts [2:] delta-encoded
against count[i-2]. ``cv2`` is imported only inside
:func:`rle_to_polygons`.
"""

from __future__ import annotations

from typing import Dict, List, Union

import numpy as np


def decode_rle_counts(counts: Union[str, bytes, List[int]]) -> List[int]:
    """Compressed count string → run lengths (6-bit varints offset by 48;
    counts from index 3 on are delta-encoded against count[i-2], matching
    pycocotools ``rleFrString``)."""
    if isinstance(counts, (list, tuple)):
        return list(counts)
    if isinstance(counts, str):
        counts = counts.encode("ascii")
    out: List[int] = []
    i = 0
    n = len(counts)
    while i < n:
        x = 0
        k = 0
        while True:
            c = counts[i] - 48
            x |= (c & 0x1F) << (5 * k)
            i += 1
            k += 1
            if not (c & 0x20):
                if c & 0x10:
                    x |= -1 << (5 * k)
                break
        if len(out) > 2:
            x += out[-2]
        out.append(x)
    return out


def rle_decode(rle: Dict) -> np.ndarray:
    """RLE dict → (h, w) uint8 binary mask."""
    h, w = rle["size"]
    counts = decode_rle_counts(rle["counts"])
    total = h * w
    flat = np.zeros(total, dtype=np.uint8)
    pos = 0
    val = 0
    for run in counts:
        run = int(run)
        if val:
            flat[pos:pos + run] = 1
        pos += run
        val ^= 1
    if pos != total:
        # tolerate truncated/overlong runs (matches pycocotools leniency)
        flat = flat[:total]
    return flat.reshape((w, h)).T  # column-major → (h, w)


def rle_to_polygons(rle: Dict, min_points: int = 3) -> List[List[float]]:
    """RLE → list of flattened polygon coordinate lists via contour
    extraction (reference ``_polygonFromMask_row``,
    data_preprocessor.py:155-207 — pycocotools.decode + cv2.findContours)."""
    import cv2

    mask = rle_decode(rle)
    contours, _ = cv2.findContours(mask, cv2.RETR_TREE,
                                   cv2.CHAIN_APPROX_SIMPLE)
    polygons = []
    for contour in contours:
        if contour.size >= 2 * min_points:
            polygons.append(contour.flatten().astype(float).tolist())
    return polygons
