"""Serving over several devices (counterpart of
``custom_yolo_tpu/parallel/serve.py``: ``make_sharded_serve_fn`` :37-68,
``shard_serve_batch`` :71-73).

Serving is batch-parallel, so each device holds one replica of the served
``Detector`` (fused, optimised or int8 — whatever it is) and runs the
single-device serving program (forward, DFL decode, NMS, with the port's
kernels) on its slice of the batch; no collective is needed. The JAX
function runs one ``shard_map`` over the mesh; here one host thread per
slice drives its device, each on a CUDA stream of its own, so slices of
distinct devices run side by side. A card listed twice holds one replica,
whose serving CUDA graphs serve one stream at a time: its two slices run
side by side on a signature's first call and one after the other once the
graphs replay. The slices' fixed-shape ``NMSResult``s are concatenated in
batch order on the first device.
"""

from __future__ import annotations

import copy
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, List, Optional, Sequence, Tuple

import torch

from custom_yolo_tpu_torch.models.detector import Detector
from custom_yolo_tpu_torch.models.serve_graph import ServeGraphs
from custom_yolo_tpu_torch.ops.nms import NMSResult


def _indexed(device: torch.device) -> torch.device:
    """``cuda`` as the card it means now (``cuda:N``)."""
    if device.type == "cuda" and device.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return device


def _replica(detector: Detector, device: torch.device) -> Detector:
    """``detector`` served from ``device``: itself where it already lies
    there, else a copy of its model and normalisation constants moved
    there, with serving graphs of its own (the kept fp32 fold is shared,
    not copied: serving does not read it)."""
    if _indexed(device) == _indexed(detector.device):
        return detector
    rep = copy.copy(detector)
    rep.device = device
    rep.model = copy.deepcopy(detector.model).to(device)
    rep._graphs = ServeGraphs(detector._graphs.capture)
    rep._mean = detector._mean.to(device)
    rep._std = detector._std.to(device)
    return rep


def shard_serve_batch(images, devices: Sequence[torch.device]
                      ) -> List[torch.Tensor]:
    """The batch split into one equal slice per entry of ``devices``, each
    copied to its device. The batch must divide evenly (the loader's
    ``pad_to_multiple`` pads a ragged one)."""
    images = torch.as_tensor(images)
    n = len(devices)
    if images.shape[0] % n:
        raise ValueError(f"a batch of {images.shape[0]} does not split "
                         f"over {n} devices")
    return [part.to(dev, non_blocking=True)
            for part, dev in zip(images.chunk(n), devices)]


def make_sharded_serve_fn(detector: Detector, devices: Sequence,
                          conf_thres: float = 0.25, iou_thres: float = 0.45,
                          max_det: int = 300, top_k: int = 1024,
                          merge: bool = False,
                          class_filter: Optional[Tuple[int, ...]] = None,
                          multi_label: bool = False,
                          device_preprocess: bool = False) -> Callable:
    """``serve_fn(images) -> NMSResult`` over ``devices`` (names or
    ``torch.device``s; one listed twice gets two slices and two streams).
    Each slice goes through ``Detector.serve`` with these arguments on its
    device's replica, so the result equals ``detector.serve`` of the whole
    batch. The batch must divide evenly over ``devices``."""
    devices = [_indexed(torch.device(d)) for d in devices]
    if not devices:
        raise ValueError("no device to serve on")
    replicas = {}
    for dev in devices:
        if dev not in replicas:
            replicas[dev] = _replica(detector, dev)
    streams = [torch.cuda.Stream(dev) if dev.type == "cuda" else None
               for dev in devices]
    pool = ThreadPoolExecutor(max_workers=len(devices),
                              thread_name_prefix="sharded_serve")
    kwargs = dict(conf_thres=conf_thres, iou_thres=iou_thres,
                  max_det=max_det, top_k=top_k, merge=merge,
                  class_filter=class_filter, multi_label=multi_label,
                  device_preprocess=device_preprocess)

    def run(i: int, part: torch.Tensor, main) -> NMSResult:
        dev, stream = devices[i], streams[i]
        if stream is None:
            return replicas[dev].serve(part, **kwargs)
        # the slice was copied on the caller's stream, which must not reuse
        # its memory before this stream has read it
        stream.wait_stream(main)
        part.record_stream(stream)
        with torch.cuda.stream(stream):
            return replicas[dev].serve(part, **kwargs)

    def serve_fn(images) -> NMSResult:
        mains = [torch.cuda.current_stream(d) if d.type == "cuda" else None
                 for d in devices]
        parts = shard_serve_batch(images, devices)
        results = list(pool.map(run, range(len(devices)), parts, mains))
        for result, stream, main in zip(results, streams, mains):
            if stream is not None:
                # what follows on the caller's stream waits for the slice,
                # whose memory is not reused before it has been read
                main.wait_stream(stream)
                for t in result:
                    t.record_stream(main)
        return NMSResult(*(torch.cat([r[j].to(devices[0]) for r in results])
                           for j in range(len(NMSResult._fields))))

    return serve_fn
