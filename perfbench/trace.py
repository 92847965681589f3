"""The traced window: spans the benchmark opens around the program's
layers, the ``torch.profiler`` capture, and the reduction of its Chrome
trace to what the per-layer metrics read.

The capture records the CPU's ops and the card's kernels, copies and
memsets, without shapes, stacks or FLOP estimates (they multiply the
capture's host cost). Each device event is attributed by its
``correlation`` id to the runtime call that launched it, and through that
call to the host ops and spans that enclose it on its thread (the
attribution of ``scripts/torch_analyze_profile.py``, frozen here):

* ``bwd``: under an ``autograd::engine::evaluate_function:`` op;
* ``optim``: under torch.optim's ``Optimizer.step#`` span, or launched by
  the main thread after a step's backward (norm, clip, EMA);
* ``loss``: under the ``loss/assign`` span;
* ``decode_nms``: under the ``decode_nms`` span, open from the model's
  return to ``serve``'s;
* ``fwd``: under a ``fwd/<stage>`` span;
* ``other``: the rest (input copies, normalisation, fetches).
"""

from __future__ import annotations

import collections
import contextlib
import json
import os
import re
import tempfile
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

import torch

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")
HOST_CATS = ("cpu_op", "user_annotation")
WINDOW = "bench/window"
STEP = "bench/step"
BWD_PREFIX = "autograd::engine::evaluate_function:"
OPTIMIZER_PREFIX = "Optimizer.step#"
LOSS_SPAN = "loss/assign"
DECODE_SPAN = "decode_nms"
FWD_PREFIX = "fwd/"


class Spans:
    """``fwd/<stage>`` spans around each named stage's forward, opened by
    forward pre-hooks and closed by forward hooks; with ``decode_after``,
    a ``decode_nms`` span opened when that module returns and closed by
    :meth:`close_decode`. :meth:`remove` takes every hook away."""

    def __init__(self, stages: Dict[str, torch.nn.Module],
                 decode_after: Optional[torch.nn.Module] = None):
        self._open: Dict[str, contextlib.AbstractContextManager] = {}
        self._handles = []
        for name, module in stages.items():
            self._handles.append(module.register_forward_pre_hook(
                self._enter(f"{FWD_PREFIX}{name}")))
            self._handles.append(module.register_forward_hook(
                self._exit(f"{FWD_PREFIX}{name}")))
        if decode_after is not None:
            self._handles.append(decode_after.register_forward_hook(
                lambda *_: self._start(DECODE_SPAN)))

    def _start(self, name: str) -> None:
        span = torch.profiler.record_function(name)
        span.__enter__()
        self._open[name] = span

    def _stop(self, name: str) -> None:
        span = self._open.pop(name, None)
        if span is not None:
            span.__exit__(None, None, None)

    def _enter(self, name):
        return lambda *_: self._start(name)

    def _exit(self, name):
        return lambda *_: self._stop(name)

    def close_decode(self) -> None:
        self._stop(DECODE_SPAN)

    def remove(self) -> None:
        for h in self._handles:
            h.remove()


def model_stages(model: torch.nn.Module) -> Dict[str, torch.nn.Module]:
    """The spans' stages: the backbone's and the neck's children and the
    head, by their names in the model."""
    stages = {}
    for part in ("net", "fpn"):
        for name, child in getattr(model, part).named_children():
            stages[f"{part}.{name}"] = child
    stages["head"] = model.head
    return stages


def profiler():
    from torch.profiler import ProfilerActivity, profile
    return profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])


def warm_profiler() -> None:
    """Start and stop the profiler once, so that the traced window does
    not pay for loading CUPTI."""
    with profiler():
        torch.zeros(1, device="cuda").add_(1)
        torch.cuda.synchronize()


def export_events(prof) -> List[dict]:
    """The capture's Chrome trace events, through a file under the
    temporary directory that is deleted at once."""
    fd, path = tempfile.mkstemp(suffix=".json", prefix="perfbench_trace_")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            return json.load(f)["traceEvents"]
    finally:
        os.unlink(path)


def _end(e) -> float:
    return float(e["ts"]) + float(e.get("dur", 0))


def _host_stacks(events) -> Tuple[Dict, Dict]:
    """Sweep each thread's host events in start order: the host events
    enclosing each launch (by correlation id), and the launches by
    correlation id."""
    threads = collections.defaultdict(list)
    for e in events:
        if e.get("ph") == "X" and e.get("cat") in HOST_CATS + LAUNCH_CATS:
            threads[e.get("pid"), e.get("tid")].append(e)
    stacks, launches = {}, {}
    for evs in threads.values():
        evs.sort(key=lambda e: (float(e["ts"]), -float(e.get("dur", 0))))
        stack: List[dict] = []
        for e in evs:
            ts = float(e["ts"])
            while stack and _end(stack[-1]) <= ts:
                stack.pop()
            if e["cat"] in LAUNCH_CATS:
                corr = (e.get("args") or {}).get("correlation")
                if corr is not None:
                    stacks[corr] = tuple(stack)
                    launches[corr] = e
                continue
            stack.append(e)
    return stacks, launches


def _phase(stack) -> str:
    names = [e["name"] for e in stack]
    if any(n.startswith(BWD_PREFIX) for n in names):
        return "bwd"
    if any(n.startswith(OPTIMIZER_PREFIX) for n in names):
        return "optim"
    if LOSS_SPAN in names:
        return "loss"
    if DECODE_SPAN in names:
        return "decode_nms"
    if any(n.startswith(FWD_PREFIX) for n in names):
        return "fwd"
    return "other"


def merge(intervals: Iterable[Tuple[float, float]]
          ) -> List[Tuple[float, float]]:
    out: List[List[float]] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [(a, b) for a, b in out]


def short_name(name: str) -> str:
    """A kernel's name without ``void``, template arguments and parameter
    list: ``at::native::vectorized_elementwise_kernel``."""
    if name.startswith("void "):
        name = name[5:]
    cut = min((i for i in (name.find("<"), name.find("(")) if i > 0),
              default=len(name))
    return name[:cut].strip()[:80]


class Digest:
    """The traced window reduced: its length, the device's busy time in
    it, and every device event in it with its phase.

    ``items``: the batches or steps the window held; ``images``: the
    images they carried. ``rest``: (items, images, seconds) of the
    untraced part of the run's window after the traced one, whose pace
    carries no cost of the profiler's."""

    def __init__(self, events: List[dict], items: int, images: int,
                 rest: Tuple[int, int, float] = (0, 0, 0.0)):
        self.items, self.images = items, images
        self.rest_items, self.rest_images, self.rest_s = rest
        windows = [e for e in events if e.get("cat") == "user_annotation"
                   and e.get("name") == WINDOW]
        if len(windows) != 1:
            raise ValueError(f"{len(windows)} '{WINDOW}' spans in the trace")
        w = windows[0]
        self.t0, self.t1 = float(w["ts"]), _end(w)
        self.main_thread = (w.get("pid"), w.get("tid"))
        stacks, launches = _host_stacks(events)
        steps = [(float(e["ts"]), _end(e)) for e in events
                 if e.get("cat") == "user_annotation" and e["name"] == STEP]
        device = [e for e in events if e.get("ph") == "X"
                  and e.get("cat") in DEVICE_CATS
                  and self.t0 <= float(e["ts"]) < self.t1]
        # the end of each step's backward on the device's launching side:
        # the last launch under an autograd op within the step
        bwd_launch = sorted(float(launches[c]["ts"]) for c, s in
                            stacks.items() if _phase(s) == "bwd")
        bwd_end = []
        for a, b in steps:
            inside = [t for t in bwd_launch if a <= t < b]
            bwd_end.append((a, b, max(inside) if inside else None))
        self.events = []
        for e in device:
            corr = (e.get("args") or {}).get("correlation")
            stack = stacks.get(corr, ())
            phase = _phase(stack)
            launch = launches.get(corr)
            if phase == "other" and launch is not None and (
                    launch.get("pid"), launch.get("tid")) == self.main_thread:
                ts = float(launch["ts"])
                if any(end is not None and end < ts < b
                       for _, b, end in bwd_end):
                    phase = "optim"
            self.events.append({"name": e["name"], "phase": phase,
                                "ts": float(e["ts"]),
                                "dur": float(e.get("dur", 0)),
                                "stack": stack})
        self.busy = merge((max(e["ts"], self.t0),
                           min(e["ts"] + e["dur"], self.t1))
                          for e in self.events)
        self.host = sorted(
            (e for e in events if e.get("ph") == "X"
             and e.get("cat") in HOST_CATS
             and (e.get("pid"), e.get("tid")) == self.main_thread
             and _end(e) > self.t0 and float(e["ts"]) < self.t1),
            key=lambda e: float(e["ts"]))

    @property
    def window_s(self) -> float:
        return (self.t1 - self.t0) / 1e6

    @property
    def busy_s(self) -> float:
        return sum(b - a for a, b in self.busy) / 1e6

    def phase_s(self, phase: str) -> float:
        return sum(e["dur"] for e in self.events if e["phase"] == phase) / 1e6

    def kernel_s(self, names: Sequence[str]) -> Tuple[float, int]:
        """(device seconds, events) of the kernels whose name holds one of
        ``names``."""
        hits = [e for e in self.events
                if any(n in e["name"] for n in names)]
        return sum(e["dur"] for e in hits) / 1e6, len(hits)

    def top_ops(self, n: int = 10) -> List[Tuple[str, float]]:
        by = collections.Counter()
        for e in self.events:
            by[short_name(e["name"])] += e["dur"] / 1e6
        return [[k, v] for k, v in by.most_common(n)]

    def idle_gaps(self, n: int = 10) -> List[Tuple[str, float]]:
        """Idle time between the device's busy intervals, summed by what
        the main thread was in at each gap's start (its innermost op or
        span); the ``n`` largest."""
        edges = [self.t0] + [x for ab in self.busy for x in ab] + [self.t1]
        gaps = [(edges[i], edges[i + 1]) for i in range(0, len(edges), 2)
                if edges[i + 1] > edges[i]]
        by = collections.Counter()
        stack: List[dict] = []
        i = 0
        for a, b in gaps:
            while i < len(self.host) and float(self.host[i]["ts"]) <= a:
                stack.append(self.host[i])
                i += 1
            while stack and _end(stack[-1]) <= a:
                stack.pop()
            live = [e for e in stack if _end(e) > a]
            by[(live[-1]["name"] if live else "idle")[:80]] += (b - a) / 1e6
        return [[k, v] for k, v in by.most_common(n)]
