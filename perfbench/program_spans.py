"""The program's own spans in the traced window, and the arithmetic of the
per-layer metrics that read them.

The program opens these spans itself (``custom_yolo_tpu_torch/utils/
profiling.py::span``), only while a profiler runs; they are named here as
literals, and nothing of the program is imported. A checkout of the
program without them leaves every reader here with nothing to read: each
then returns None.

* serving (``Detector.serve``): ``serve`` around the call, ``serve/input``
  around the copy of the batch to the card and its normalisation,
  ``serve/forward``, ``serve/decode`` and ``serve/nms`` around the phases
  after it (the last with the copy of the result out of the graphs'
  buffers), eager or replayed as CUDA graphs;
* training (``make_train_step``): ``train/step`` around the step,
  ``train/assign`` around the assigner's call inside the loss.

A device event is under a span where the span encloses the runtime call
that launched it (``Digest.events[*].stack``): for a replayed CUDA graph,
every kernel of the graph is under the spans around its
``cudaGraphLaunch``. An idle gap opens at the end of a busy interval of
the card (or at the window's start) and is under a span of the main
thread where the span is open at that instant, the rule of
``Digest.idle_gaps``.
"""

from __future__ import annotations

import bisect
from typing import List, Optional, Tuple

from perfbench.readers import idle_pct

SERVE = "serve"
SERVE_INPUT = "serve/input"
SERVE_FORWARD = "serve/forward"
SERVE_DECODE = "serve/decode"
SERVE_NMS = "serve/nms"
TRAIN_STEP = "train/step"
TRAIN_ASSIGN = "train/assign"


def device_ms(view, *spans: str) -> Optional[float]:
    """Device milliseconds an item of the events launched under any of
    ``spans``."""
    d = view.digest
    hits = [e["dur"] for e in d.events
            if any(s["name"] in spans for s in e["stack"])]
    if not hits:
        return None
    return sum(hits) / 1e3 / d.items


def _intervals(digest, span: str) -> List[Tuple[float, float]]:
    """The main thread's ``span`` events as (start, end) in µs, clipped to
    the window, in start order."""
    out = []
    for e in digest.host:
        if e.get("cat") == "user_annotation" and e["name"] == span:
            a = max(float(e["ts"]), digest.t0)
            b = min(float(e["ts"]) + float(e.get("dur", 0)), digest.t1)
            if b > a:
                out.append((a, b))
    return sorted(out)


def host_ms(view, span: str) -> Optional[float]:
    """Host milliseconds an item that the main thread spends inside
    ``span`` in the traced window."""
    d = view.digest
    spans = _intervals(d, span)
    if not spans:
        return None
    return sum(b - a for a, b in spans) / 1e3 / d.items


def _open_at(spans: List[Tuple[float, float]], t: float) -> bool:
    """Whether one of ``spans`` (disjoint, in start order) is open at
    ``t``."""
    i = bisect.bisect_right(spans, (t, float("inf"))) - 1
    return i >= 0 and spans[i][0] <= t < spans[i][1]


def gaps(digest) -> List[Tuple[float, float]]:
    """The card's idle gaps in the window, as ``Digest.idle_gaps`` cuts
    them: (start, end) in µs."""
    edges = ([digest.t0] + [x for ab in digest.busy for x in ab]
             + [digest.t1])
    return [(edges[i], edges[i + 1]) for i in range(0, len(edges), 2)
            if edges[i + 1] > edges[i]]


def dispatch_idle_pct(view, inside: str,
                      outside: Optional[str] = None) -> Optional[float]:
    """The part of the idle share (``readers.idle_pct``, on the untraced
    pace) that opens while the main thread is inside ``inside`` and not
    inside ``outside``: the idle share times that part of the traced idle
    time over all of it. The traced split is scaled by the untraced share,
    since the traced window's length carries the profiler's host cost."""
    share = idle_pct(view)
    d = view.digest
    within = _intervals(d, inside)
    if share is None or not within:
        return None
    without = _intervals(d, outside) if outside else []
    idle = gaps(d)
    total = sum(b - a for a, b in idle)
    if total <= 0:
        return None
    mine = sum(b - a for a, b in idle if _open_at(within, a)
               and not _open_at(without, a))
    return share * mine / total
