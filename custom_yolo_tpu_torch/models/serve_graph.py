"""CUDA-graph replay of ``Detector.serve`` (no counterpart in the JAX
package, whose ``jit`` compiles the serving program once per shape).

Eager PyTorch pays the host's dispatch on every kernel of a batch, ~757
launches for the x preset at B=8, and the host then takes longer to launch
a batch's kernels than the card takes to run them. :class:`ServeGraphs` captures the
serving phases of one call signature into CUDA graphs and replays them, so
that a batch costs the host three graph launches:

* one graph a phase (``serve/forward``, ``serve/decode``, ``serve/nms``),
  captured in that order into one memory pool and replayed in that order,
  each inside its span, so that a trace still splits the card's work by
  phase;
* the input phase (``serve/input``: the batch's copy to the device and the
  normalisation of raw uint8) stays eager and writes into the forward
  graph's static input;
* the result is cloned out of the last graph's static outputs, so that a
  caller may hold results while later batches replay.

A signature's first call runs eagerly (it warms cuDNN, cuBLAS, the head's
anchors and the hand-written kernels' first-launch set-up, and a one-off
shape never captures); the first call after it has returned captures. A
batch on the CPU never captures, and a signature whose capture failed
stays eager. Each case is counted (:func:`serve_graph_stats`, which
``utils.profiling`` exports too). A detector keeps at most
``MAX_SIGNATURES`` signatures, the least recently used out first.

A replay runs no Python of the model: forward hooks and the model's
``fwd/<stage>`` spans run at capture only. The graphs read the parameters
by address, so weights changed in place are served; a model that is
rebuilt or swapped is not, and ``Detector`` drops the graphs wherever it
installs a model. One detector's graphs serve one stream at a time: each
call waits, on its own stream, for the previous replay's reads of the
static buffers, wherever that ran.

The hand-written kernels' launch counts (``utils.profiling
.kernel_launches``) stay truthful: a capture counts the launches it
records into its own thread's tally (``ops.cuda.build.launch_tally``),
and each replay adds that tally to the counts.
"""

from __future__ import annotations

import collections
import functools
import threading
import warnings
from typing import (Any, Callable, Dict, Hashable, NamedTuple, Optional,
                    Sequence, Tuple)

import torch

from custom_yolo_tpu_torch.ops.cuda import build
from custom_yolo_tpu_torch.utils.profiling import span

# signatures a detector keeps, captured or not
MAX_SIGNATURES = 4
SERVE_INPUT = "serve/input"

# (span, fn): one phase of serving, fn taking the previous phase's output
Phase = Tuple[str, Callable[[Any], Any]]

# torch.cuda.graph allows one capture under way in a process at a time
_CAPTURE_LOCK = threading.Lock()
# a signature whose first eager call is under way, or has returned; a
# signature whose capture failed
_WARMING, _SEEN, _FAILED = "warming", "seen", "failed"

# why a call ran eagerly: its batch lay on the CPU, its signature was new,
# or capturing the signature's graphs failed
EAGER_REASONS = ("cpu", "first_call", "capture_failed")
# "capture", "replay" and each reason → its count in this process
_counts: collections.Counter = collections.Counter()
_counts_lock = threading.Lock()


def _count(event: str) -> None:
    with _counts_lock:
        _counts[event] += 1


def serve_graph_stats() -> Dict[str, object]:
    """``Detector.serve`` in this process so far: ``captures``,
    ``replays`` (calls served by graph replay, the capturing call
    included), ``eager`` (calls by reason, ``EAGER_REASONS``),
    ``serve_calls`` and ``hit_share``, replays over serve calls (None
    before the first)."""
    with _counts_lock:
        counts = dict(_counts)
    eager = {reason: counts.get(reason, 0) for reason in EAGER_REASONS}
    replays = counts.get("replay", 0)
    calls = replays + sum(eager.values())
    return {"captures": counts.get("capture", 0), "replays": replays,
            "eager": eager, "serve_calls": calls,
            "hit_share": replays / calls if calls else None}


def run_phases(phases: Sequence[Phase], x):
    """``x`` through ``phases`` eagerly, each inside its span."""
    for name, fn in phases:
        with span(name):
            x = fn(x)
    return x


class CudaCapture:
    """How :class:`ServeGraphs` captures: CUDA devices only, each phase
    into a CUDA graph. An object with the same two methods can stand in
    for it, which is how the CPU tests drive the cache."""

    def accepts(self, device: torch.device) -> bool:
        return device.type == "cuda"

    def session(self, device: torch.device) -> Callable:
        """``capture(fn) -> (replay, outputs)`` for one signature: each
        call captures ``fn()`` into a new graph. The graphs of a session
        share one memory pool and one capture stream, so they must be
        replayed in the order captured, never two at once."""
        pool = torch.cuda.graph_pool_handle()
        stream = torch.cuda.Stream(device)

        def capture(fn):
            graph = torch.cuda.CUDAGraph()
            with torch.cuda.device(device):
                current = torch.cuda.current_stream()
                try:
                    # thread_local: threads that serve other replicas keep
                    # working while this one captures
                    with torch.cuda.graph(graph, pool=pool, stream=stream,
                                          capture_error_mode="thread_local"):
                        outputs = fn()
                finally:
                    # a capture that fails to end leaves its stream current
                    torch.cuda.set_stream(current)
            return graph.replay, outputs

        return capture


class _Captured(NamedTuple):
    static_in: torch.Tensor
    # (span, replay, ((kernel wrapper, launches), ...)) a phase
    phases: Tuple[Tuple[str, Callable[[], None], tuple], ...]
    outputs: Any
    # recorded after each replay's last read of the static buffers
    done: Optional[torch.cuda.Event]
    # what the key names by identity, kept alive so the ids stay unique
    held: Any


class ServeGraphs:
    """The graphs of one detector's serving signatures (module docstring).
    ``capture`` is the capture seam, :class:`CudaCapture` by default."""

    def __init__(self, capture=None):
        self.capture = CudaCapture() if capture is None else capture
        self._lock = threading.Lock()
        self._signatures: collections.OrderedDict = collections.OrderedDict()

    def __len__(self) -> int:
        return len(self._signatures)

    def clear(self) -> None:
        """Drop every signature and its graphs."""
        with self._lock:
            self._signatures.clear()

    def run(self, key: Hashable, device: torch.device,
            prepare: Callable[[Optional[torch.Tensor]], torch.Tensor],
            new_input: Callable[[], torch.Tensor], phases: Sequence[Phase],
            held: Any = ()):
        """One serving call of signature ``key`` on ``device``.
        ``prepare(out)`` is the input phase: it writes the batch, ready for
        the forward, into ``out``, or returns it where ``out`` is None;
        ``new_input()`` allocates a tensor that it can write into.
        ``phases`` follow it. ``held``: objects that ``key`` names by
        identity, kept with the graphs."""
        if not self.capture.accepts(device):
            return _eager("cpu", prepare, phases)
        with self._lock:
            state = self._signatures.pop(key, None)
            if state is None or state is _WARMING:
                # another thread's first call may still be warming up
                self._keep(key, _WARMING)
                reason = "first_call"
            elif state is _FAILED:
                self._keep(key, _FAILED)
                reason = "capture_failed"
            else:
                fresh = state is _SEEN
                if fresh:
                    self._trim(MAX_SIGNATURES - 1)
                    state = self._capture(device, prepare, new_input, phases,
                                          held)
                self._keep(key, state)
                if state is not _FAILED:
                    return _replay(state, None if fresh else prepare)
                reason = "capture_failed"
        out = _eager(reason, prepare, phases)
        if reason == "first_call":
            with self._lock:
                if self._signatures.get(key) is _WARMING:
                    self._signatures[key] = _SEEN
        return out

    def _keep(self, key: Hashable, state) -> None:
        self._signatures[key] = state
        self._trim(MAX_SIGNATURES)

    def _trim(self, size: int) -> None:
        while len(self._signatures) > size:
            self._signatures.popitem(last=False)

    def _capture(self, device, prepare, new_input, phases, held):
        """The input phase into a new static input, then each phase
        captured on the previous one's static output; ``_FAILED`` where a
        capture raised."""
        static_in = new_input()
        with span(SERVE_INPUT):
            prepare(static_in)
        out, captured = static_in, []
        try:
            with _CAPTURE_LOCK:
                capture = self.capture.session(device)
                for name, fn in phases:
                    # the launches this thread records, which each replay
                    # counts; other threads' launches count as they run
                    with span(name), build.launch_tally() as tally:
                        replay, out = capture(functools.partial(fn, out))
                    captured.append((name, replay, tuple(tally.items())))
        except RuntimeError as err:
            warnings.warn(f"Detector.serve: capturing the CUDA graphs of a "
                          f"signature failed, so it runs eagerly: {err}",
                          RuntimeWarning)
            return _FAILED
        _count("capture")
        done = torch.cuda.Event() if device.type == "cuda" else None
        return _Captured(static_in, tuple(captured), out, done, held)


def _eager(reason: str, prepare, phases: Sequence[Phase]):
    _count(reason)
    with span(SERVE_INPUT):
        x = prepare(None)
    return run_phases(phases, x)


def _replay(graphs: _Captured, prepare):
    """Write the batch into the static input (unless ``prepare`` is None:
    the capturing call wrote it), replay each phase in its span, and clone
    the result out of the static outputs."""
    stream = (torch.cuda.current_stream(graphs.static_in.device)
              if graphs.done is not None else None)
    if stream is not None:
        stream.wait_event(graphs.done)
    if prepare is not None:
        with span(SERVE_INPUT):
            prepare(graphs.static_in)
    last = len(graphs.phases) - 1
    for i, (name, replay, launches) in enumerate(graphs.phases):
        with span(name):
            replay()
            for wrapper, n in launches:
                build.count_launch(wrapper, n)
            if i == last:
                result = graphs.outputs._make(t.clone()
                                              for t in graphs.outputs)
    if stream is not None:
        graphs.done.record(stream)
    _count("replay")
    return result
