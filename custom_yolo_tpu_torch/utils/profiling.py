"""Profiling (counterpart of ``custom_yolo_tpu/utils/profiling.py``):
``trace`` captures a ``torch.profiler`` trace of a block into a Chrome
trace file (viewable in Perfetto or ``chrome://tracing``), ``span`` names
a block of the port's hot path in such a trace, ``time_fn`` times a
function with the device synchronised, ``kernel_launches`` reads the
launch counts of the port's hand-written kernels, and
``serve_graph_stats`` how ``Detector.serve`` ran: CUDA-graph replays,
captures, and eager calls by their reason."""

from __future__ import annotations

import contextlib
import json
import os
import time
from typing import Callable, Dict, Optional

import torch

from custom_yolo_tpu_torch.ops import (attention, head_kernel, nms_kernel,
                                       quant_kernel, sppf_kernel)

TRACE_FILE = "trace.json"
_OFF = contextlib.nullcontext()


def span(name: str):
    """A context manager that names the enclosed block ``name`` in a
    running ``torch.profiler`` capture: a ``record_function``, recorded as
    a ``user_annotation`` event on the capture's clock beside the card's
    kernels. With no profiler running it is a shared no-op, and the call
    costs one check of the profiler's state."""
    if torch.autograd._profiler_enabled():
        return torch.profiler.record_function(name)
    return _OFF


@contextlib.contextmanager
def trace(profile_dir: Optional[str], with_flops: bool = False):
    """Capture a ``torch.profiler`` trace of the enclosed block, the CPU's
    activity and, where CUDA is there, the card's, into
    ``profile_dir/trace.json``; nothing when ``profile_dir`` is empty.
    ``with_flops``: the profiler's FLOP estimates (convolutions and matrix
    products), which its Chrome export leaves out, are written into the
    ``args`` of their ops as ``flops``."""
    if not profile_dir:
        yield
        return
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(profile_dir, exist_ok=True)
    path = os.path.join(profile_dir, TRACE_FILE)
    with profile(activities=activities, with_flops=with_flops) as prof:
        yield
    prof.export_chrome_trace(path)
    if with_flops:
        _add_flops(path, {e.id: e.flops for e in prof.events() if e.flops})


def _add_flops(path: str, flops: Dict[int, int]) -> None:
    """Write ``flops`` (by the op's id, the trace's ``External id``) into
    the ``args`` of the trace's CPU ops at ``path``."""
    with open(path) as f:
        doc = json.load(f)
    for e in doc["traceEvents"]:
        if e.get("cat") == "cpu_op":
            n = flops.get((e.get("args") or {}).get("External id"))
            if n:
                e["args"]["flops"] = n
    with open(path, "w") as f:
        json.dump(doc, f)


def _cuda_tensor(out) -> Optional[torch.Tensor]:
    """The first CUDA tensor in ``out`` (a tensor, or a tuple, list or dict
    holding tensors), else None."""
    if isinstance(out, torch.Tensor):
        return out if out.is_cuda else None
    items = out.values() if isinstance(out, dict) else (
        out if isinstance(out, (tuple, list)) else ())
    for item in items:
        found = _cuda_tensor(item)
        if found is not None:
            return found
    return None


def time_fn(fn: Callable, *args, iters: int = 10, warmup: int = 2,
            **kwargs) -> Dict[str, float]:
    """Time ``iters`` calls of ``fn(*args, **kwargs)`` after ``warmup``
    calls. Where the result holds a CUDA tensor, CUDA events on its
    device's current stream bracket the calls; otherwise ``perf_counter``
    does (with ``warmup=0``, one untimed call shows which). Returns
    ``total_s``, ``mean_s`` and ``iters``."""
    out = None
    for _ in range(warmup):
        out = fn(*args, **kwargs)
    probe = _cuda_tensor(out) if warmup else _cuda_tensor(
        fn(*args, **kwargs))
    if probe is not None:
        with torch.cuda.device(probe.device):
            torch.cuda.synchronize()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(iters):
                fn(*args, **kwargs)
            end.record()
            end.synchronize()
            dt = start.elapsed_time(end) / 1e3
    else:
        t0 = time.perf_counter()
        for _ in range(iters):
            fn(*args, **kwargs)
        dt = time.perf_counter() - t0
    return {"total_s": dt, "mean_s": dt / iters, "iters": iters}


def kernel_wrappers() -> Dict[str, Callable]:
    """The wrappers of the hand-written kernels by name; each counts in its
    ``launches`` attribute the launches of its kernel on CUDA tensors (not
    the calls that a CPU tensor sends to the twin)."""
    return {"attention": attention.psa_attention,
            "attention_bwd": attention.psa_attention_bwd,
            "nms_batched": nms_kernel.nms_keep_batched,
            "nms_single": nms_kernel.nms_keep_single,
            "sppf": sppf_kernel.sppf_pyramid,
            "cls_tower": head_kernel.cls_tower,
            "stochastic_round": quant_kernel.stochastic_round_many}


def kernel_launches() -> Dict[str, int]:
    """Launches of each hand-written kernel in this process so far."""
    return {name: wrapper.launches
            for name, wrapper in kernel_wrappers().items()}


def serve_graph_stats() -> Dict[str, object]:
    """How ``Detector.serve`` ran in this process so far: CUDA-graph
    captures and replays, eager calls by reason, and the replays' share
    (``models.serve_graph.serve_graph_stats``)."""
    # imported here: models.serve_graph imports this module
    from custom_yolo_tpu_torch.models import serve_graph
    return serve_graph.serve_graph_stats()
