"""``Detector.serve``'s CUDA-graph replay (``models/serve_graph.py``).

On the CPU the cache is driven through its capture seam: ``EagerCapture``
"captures" a phase by running it once and "replays" it by running it
again into the captured outputs, so that the static buffers, the clone
out of them and the cache's bookkeeping behave as they do on the card.
The tests marked ``card`` run the real capture on an NVIDIA card and hold
graph and eager ``serve`` bit for bit; without a card they skip. This
file imports no JAX: on the card it runs with ``pytest --noconftest``.
"""

import os
import sys
import threading
from typing import NamedTuple

import numpy as np
import pytest
import torch

from custom_yolo_tpu_torch import Detector, PRESETS
from custom_yolo_tpu_torch.models import serve_graph
from custom_yolo_tpu_torch.models.detector import serve_pipeline
from custom_yolo_tpu_torch.ops import nms_kernel
from custom_yolo_tpu_torch.ops.cuda import build
from custom_yolo_tpu_torch.parallel.serve import make_sharded_serve_fn
from custom_yolo_tpu_torch.utils import profiling

torch.set_num_threads(2)

WIDTH = (3, 8, 16, 32, 64, 256)
DEPTH = (2, 1, 1, 1, 2, 1)
CSP = (True, True)
NC = 7
HW = 64
SERVE = dict(conf_thres=0.01, iou_thres=0.45, max_det=300, top_k=1024,
             merge=False, class_filter=None, multi_label=False)


class EagerCapture:
    """A capture seam that accepts every device: ``capture(fn)`` runs
    ``fn`` once for the outputs, and its replay runs ``fn`` again and
    copies the new result into them."""

    def accepts(self, device):
        return True

    def session(self, device):
        def capture(fn):
            outputs = fn()

            def replay():
                for static, new in zip(outputs, fn()):
                    static.copy_(new)
            return replay, outputs
        return capture


class FailingCapture(EagerCapture):
    def session(self, device):
        def capture(fn):
            raise RuntimeError("operation not permitted when stream is "
                               "capturing")
        return capture


class CountingCapture(EagerCapture):
    """As ``EagerCapture``, and each capture of the NMS phase counts one
    batched NMS launch, as the card's wrapper does while it is captured."""

    def session(self, device):
        inner = super().session(device)

        def capture(fn):
            replay, outputs = inner(fn)
            if hasattr(outputs, "num_valid"):
                build.count_launch(nms_kernel.nms_keep_batched)
                self.captured_nms()
            return replay, outputs
        return capture

    def captured_nms(self):
        pass


class PausingCapture(CountingCapture):
    """As ``CountingCapture``, and the capture of the NMS phase, once it
    has counted its launch, waits until ``resume`` is set."""

    def __init__(self):
        self.paused, self.resume = threading.Event(), threading.Event()

    def captured_nms(self):
        self.paused.set()
        assert self.resume.wait(timeout=60)


def _detector(seed=3, fuse=True):
    det = Detector(WIDTH, DEPTH, CSP, NC, precision="float32",
                   input_size=(HW, HW), device="cpu")
    det.init(seed)
    return det.fuse() if fuse else det


def _uint8(seed, n=2):
    return torch.from_numpy(np.random.RandomState(seed).randint(
        0, 256, (n, HW, HW, 3)).astype(np.uint8))


def _eager(det, images, device_preprocess=True, **kw):
    """What the eager ``serve`` computes: the input phase, then
    ``serve_pipeline``."""
    opts = {**SERVE, **kw}
    with torch.inference_mode():
        x = det._input(torch.as_tensor(images), device_preprocess)
        return serve_pipeline(det.model, x, det.reg_max, **opts)


def _assert_equal(got, want):
    assert got._fields == want._fields
    for name, a, b in zip(got._fields, got, want):
        assert a.dtype == b.dtype and torch.equal(a, b), name


def _delta(before):
    after = profiling.serve_graph_stats()
    return {"captures": after["captures"] - before["captures"],
            "replays": after["replays"] - before["replays"],
            **{f"eager/{k}": after["eager"][k] - before["eager"][k]
               for k in after["eager"]}}


def _counts(captures=0, replays=0, cpu=0, first_call=0, capture_failed=0):
    return {"captures": captures, "replays": replays, "eager/cpu": cpu,
            "eager/first_call": first_call,
            "eager/capture_failed": capture_failed}


@pytest.fixture(scope="module")
def fused():
    return _detector()


@pytest.fixture()
def seamed(fused):
    """The module's fused detector with an empty cache on the seam."""
    fused._graphs = serve_graph.ServeGraphs(EagerCapture())
    return fused


def test_cpu_serve_never_captures(fused):
    fused._graphs = serve_graph.ServeGraphs()
    images = _uint8(1)
    before = profiling.serve_graph_stats()
    for _ in range(3):
        got = fused.serve(images, device_preprocess=True, **SERVE)
        _assert_equal(got, _eager(fused, images))
    floats = torch.from_numpy(np.random.RandomState(2).rand(
        2, HW, HW, 3).astype(np.float32))
    _assert_equal(fused.serve(floats, **SERVE),
                  _eager(fused, floats, device_preprocess=False))
    assert _delta(before) == _counts(cpu=4)
    assert len(fused._graphs) == 0
    stats = profiling.serve_graph_stats()
    assert stats["serve_calls"] == stats["replays"] + sum(
        stats["eager"].values())
    assert stats["hit_share"] == stats["replays"] / stats["serve_calls"]


def test_first_call_eager_second_captures(seamed):
    images = _uint8(4)
    want = _eager(seamed, images)
    before = profiling.serve_graph_stats()
    _assert_equal(seamed.serve(images, device_preprocess=True, **SERVE),
                  want)
    assert _delta(before) == _counts(first_call=1)
    assert len(seamed._graphs) == 1
    _assert_equal(seamed.serve(images, device_preprocess=True, **SERVE),
                  want)
    assert _delta(before) == _counts(first_call=1, captures=1, replays=1)
    assert len(seamed._graphs) == 1
    other = _uint8(5)
    _assert_equal(seamed.serve(other, device_preprocess=True, **SERVE),
                  _eager(seamed, other))
    assert _delta(before) == _counts(first_call=1, captures=1, replays=2)


def test_batches_held_in_flight_keep_their_results(seamed):
    """Three batches served before any is read, each equal to its own
    eager result: the result is a copy out of the graphs' buffers."""
    batches = [_uint8(10 + i) for i in range(3)]
    seamed.serve(batches[0], device_preprocess=True, **SERVE)
    seamed.serve(batches[0], device_preprocess=True, **SERVE)
    results = [seamed.serve(b, device_preprocess=True, **SERVE)
               for b in batches]
    for got, images in zip(results, batches):
        _assert_equal(got, _eager(seamed, images))


def _float_images(seed, n=2, dtype=np.float32):
    return torch.from_numpy(np.random.RandomState(seed).rand(
        n, HW, HW, 3).astype(dtype))


# each changes one part of the signature of the base call
# (float32 batch of two, device_preprocess=False, SERVE)
SIGNATURE_CHANGES = {
    "shape": (dict(n=3), {}),
    "dtype": (dict(dtype=np.float64), {}),
    "device_preprocess": (dict(uint8=True), dict(device_preprocess=True)),
    "conf_thres": ({}, dict(conf_thres=0.02)),
    "iou_thres": ({}, dict(iou_thres=0.5)),
    "max_det": ({}, dict(max_det=50)),
    "top_k": ({}, dict(top_k=512)),
    "merge": ({}, dict(merge=True)),
    "class_filter": ({}, dict(class_filter=(0, 2, 3))),
    "multi_label": ({}, dict(multi_label=True)),
}


@pytest.mark.parametrize("change", sorted(SIGNATURE_CHANGES))
def test_signature_change_captures_anew(seamed, change):
    images_kw, serve_kw = map(dict, SIGNATURE_CHANGES[change])
    base = _float_images(20)
    for _ in range(2):
        seamed.serve(base, **SERVE)
    assert len(seamed._graphs) == 1
    if images_kw.pop("uint8", False):
        images = _uint8(21)
    else:
        images = _float_images(21, **images_kw)
    dp = serve_kw.pop("device_preprocess", False)
    opts = {**SERVE, **serve_kw}
    want = _eager(seamed, images, device_preprocess=dp, **serve_kw)
    before = profiling.serve_graph_stats()
    for _ in range(3):
        _assert_equal(seamed.serve(images, device_preprocess=dp, **opts),
                      want)
    assert _delta(before) == _counts(first_call=1, captures=1, replays=2)
    assert len(seamed._graphs) == 2
    # the base signature is still captured, and still serves its own
    before = profiling.serve_graph_stats()
    _assert_equal(seamed.serve(base, **SERVE),
                  _eager(seamed, base, device_preprocess=False))
    assert _delta(before) == _counts(replays=1)


def test_fused_cls_tower_switch_is_part_of_the_signature(seamed):
    head = seamed.model.head
    images = _uint8(22)
    for _ in range(2):
        seamed.serve(images, device_preprocess=True, **SERVE)
    try:
        head.fused_cls_tower = True
        before = profiling.serve_graph_stats()
        seamed.serve(images, device_preprocess=True, **SERVE)
        assert _delta(before) == _counts(first_call=1)
    finally:
        head.fused_cls_tower = False
    before = profiling.serve_graph_stats()
    seamed.serve(images, device_preprocess=True, **SERVE)
    assert _delta(before) == _counts(replays=1)


def test_eviction_keeps_the_cap(seamed):
    cap = serve_graph.MAX_SIGNATURES
    batches = [_uint8(30 + n, n=n) for n in range(1, cap + 3)]
    for images in batches:
        before = profiling.serve_graph_stats()
        for _ in range(2):
            seamed.serve(images, device_preprocess=True, **SERVE)
        assert _delta(before) == _counts(first_call=1, captures=1, replays=1)
        assert len(seamed._graphs) <= cap
    assert len(seamed._graphs) == cap
    # the least recently used went first: the two oldest are new again
    before = profiling.serve_graph_stats()
    seamed.serve(batches[-1], device_preprocess=True, **SERVE)
    seamed.serve(batches[0], device_preprocess=True, **SERVE)
    assert _delta(before) == _counts(replays=1, first_call=1)
    assert len(seamed._graphs) == cap


def _quantized(det):
    return det.quantize(skip=())


TRANSFORMS = {
    "load_variables": (lambda: _detector(),
                       lambda det, tmp: det.load_variables(
                           _detector(seed=4).model.state_dict())),
    "load_weights": (lambda: _detector(),
                     lambda det, tmp: det.load_weights(_saved(tmp))),
    "fuse": (lambda: _detector(fuse=False), lambda det, tmp: det.fuse()),
    "optimize_for_serving": (lambda: _detector(),
                             lambda det, tmp: det.optimize_for_serving()),
    "quantize": (lambda: _detector(), lambda det, tmp: _quantized(det)),
    "calibrate": (lambda: _quantized(_detector()),
                  lambda det, tmp: det.calibrate([_eager_input(det)])),
}


def _saved(tmp):
    path = str(tmp / "weights")
    _detector(seed=5).save_weights(path)
    return path


def _eager_input(det):
    with torch.inference_mode():
        return det._input(_uint8(40), True)


@pytest.mark.parametrize("name", sorted(TRANSFORMS))
def test_transforms_drop_the_graphs(name, tmp_path):
    make, transform = TRANSFORMS[name]
    det = make()
    det._graphs = serve_graph.ServeGraphs(EagerCapture())
    images = _uint8(41)
    for _ in range(2):
        det.serve(images, device_preprocess=True, **SERVE)
    assert len(det._graphs) == 1
    transform(det, tmp_path)
    assert len(det._graphs) == 0
    before = profiling.serve_graph_stats()
    for _ in range(3):
        _assert_equal(det.serve(images, device_preprocess=True, **SERVE),
                      _eager(det, images))
    assert _delta(before) == _counts(first_call=1, captures=1, replays=2)


def test_failed_capture_stays_eager(fused):
    fused._graphs = serve_graph.ServeGraphs(FailingCapture())
    images = _uint8(50)
    want = _eager(fused, images)
    before = profiling.serve_graph_stats()
    _assert_equal(fused.serve(images, device_preprocess=True, **SERVE), want)
    with pytest.warns(RuntimeWarning, match="runs eagerly"):
        _assert_equal(fused.serve(images, device_preprocess=True, **SERVE),
                      want)
    _assert_equal(fused.serve(images, device_preprocess=True, **SERVE), want)
    assert _delta(before) == _counts(first_call=1, capture_failed=2)
    assert len(fused._graphs) == 1


@pytest.fixture()
def emulated_launches(monkeypatch):
    """The batched NMS launch count, restored after the test: the counting
    seams add launches that no kernel made, and other test files check
    that nothing launched on the CPU."""
    monkeypatch.setattr(nms_kernel.nms_keep_batched, "launches", 0)


def test_replays_count_the_captured_kernel_launches(fused, emulated_launches):
    """A capture counts no launch (it runs none); each replay counts the
    launches its capture recorded."""
    fused._graphs = serve_graph.ServeGraphs(CountingCapture())
    images = _uint8(60)
    start = profiling.kernel_launches()["nms_batched"]
    fused.serve(images, device_preprocess=True, **SERVE)
    for calls in range(1, 4):
        fused.serve(images, device_preprocess=True, **SERVE)
        assert profiling.kernel_launches()["nms_batched"] - start == calls


def test_launch_counts_stay_exact_while_another_detector_captures(
        fused, emulated_launches):
    """One detector replays while another captures in a second thread, as
    ``make_sharded_serve_fn``'s replicas on two cards do: each replay
    counts its launch once, the capture counts none, and the capturing
    detector's replays count only its own."""
    fused._graphs = serve_graph.ServeGraphs(CountingCapture())
    other = _detector(seed=4)
    pausing = PausingCapture()
    other._graphs = serve_graph.ServeGraphs(pausing)
    images = _uint8(65)
    for det in (fused, fused, other):
        det.serve(images, device_preprocess=True, **SERVE)

    def launched():
        return profiling.kernel_launches()["nms_batched"] - start

    start = profiling.kernel_launches()["nms_batched"]
    capturing = threading.Thread(target=other.serve, args=(images,),
                                 kwargs=dict(device_preprocess=True,
                                             **SERVE))
    capturing.start()
    try:
        assert pausing.paused.wait(timeout=60)
        for calls in range(1, 4):
            fused.serve(images, device_preprocess=True, **SERVE)
            assert launched() == calls
    finally:
        pausing.resume.set()
        capturing.join(timeout=60)
    assert not capturing.is_alive()
    # the capturing call is then served by the graphs' first replay
    assert launched() == 4
    for calls in range(5, 7):
        other.serve(images, device_preprocess=True, **SERVE)
        assert launched() == calls
    fused.serve(images, device_preprocess=True, **SERVE)
    assert launched() == 7


def test_threads_sharing_one_detector(seamed):
    """More threads than cores serve through one detector's graphs at
    once, as the slices of a card listed twice do: each result is its own
    batch's."""
    batches = [_uint8(70 + i) for i in range(4)]
    want = [_eager(seamed, b) for b in batches]
    for _ in range(2):
        seamed.serve(batches[0], device_preprocess=True, **SERVE)
    errors, done = [], []
    n_threads = (os.cpu_count() or 1) + 4

    def work(t):
        try:
            for i in range(4):
                k = (t + i) % len(batches)
                _assert_equal(seamed.serve(batches[k],
                                           device_preprocess=True, **SERVE),
                              want[k])
            done.append(t)
        except AssertionError as err:
            errors.append(err)

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=work, args=(t,))
                   for t in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
            assert not t.is_alive()
    finally:
        sys.setswitchinterval(interval)
    assert not errors and sorted(done) == list(range(n_threads))


class _Out(NamedTuple):
    y: torch.Tensor


def test_capture_waits_for_the_first_call_to_return():
    """A call that comes while the signature's first call is still under
    way in another thread runs eagerly too: a capture needs the first
    call's set-up done."""
    graphs = serve_graph.ServeGraphs(EagerCapture())
    entered, release = threading.Event(), threading.Event()

    def forward(x):
        if not entered.is_set():
            entered.set()
            release.wait(timeout=60)
        return _Out(x * 2)

    x = torch.arange(4.0)

    def run():
        return graphs.run(
            "key", torch.device("cpu"),
            lambda out: x.clone() if out is None else out.copy_(x),
            lambda: torch.empty(4), (("serve/forward", forward),))

    before = profiling.serve_graph_stats()
    first = threading.Thread(target=run)
    first.start()
    assert entered.wait(timeout=60)
    assert torch.equal(run().y, 2 * x)
    assert _delta(before) == _counts(first_call=2)
    release.set()
    first.join(timeout=60)
    assert not first.is_alive()
    assert torch.equal(run().y, 2 * x)
    assert _delta(before) == _counts(first_call=2, captures=1, replays=1)


# --------------------------------------------------------------- the card

SEED = 0
POOL_CONF = 0.001


@pytest.fixture(scope="module")
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (CUDA graphs capture only there)")
    return torch.device("cuda")


def _card_detector(preset, device, state=None):
    p = PRESETS[preset]
    det = Detector(p["width"], p["depth"], p["csp"], 172,
                   precision="bfloat16", input_size=(640, 640),
                   device=device)
    if state is None:
        det.init(SEED)
        return det.fuse()
    det.load_variables(state)
    return det


@pytest.fixture(scope="module")
def x_state(card):
    """The fused x detector's fp32 fold, on the card."""
    return dict(_card_detector("x", card)._state)


def _card_batch(n, seed, device, uint8=True):
    gen = torch.Generator().manual_seed(seed)
    x = torch.randint(0, 256, (n, 640, 640, 3), generator=gen,
                      dtype=torch.uint8)
    return (x if uint8 else (x.float() / 255.0)).to(device)


def _graph_equals_eager(det, images, device_preprocess, calls=3, **kw):
    """``serve`` ``calls`` times (the first eager, the second capturing,
    the rest replaying), each bit-equal to the eager result; returns the
    counts' change."""
    opts = {**SERVE, "conf_thres": POOL_CONF, **kw}
    want = _eager(det, images, device_preprocess, **opts)
    before = profiling.serve_graph_stats()
    for _ in range(calls):
        _assert_equal(det.serve(images, device_preprocess=device_preprocess,
                                **opts), want)
    torch.cuda.synchronize()
    return _delta(before)


@pytest.mark.card
@pytest.mark.parametrize("uint8", [True, False], ids=["uint8", "float"])
def test_card_x640_b8_graph_equals_eager(card, x_state, uint8):
    det = _card_detector("x", card, x_state)
    images = _card_batch(8, 1, card, uint8)
    assert _graph_equals_eager(det, images, uint8) == _counts(
        first_call=1, captures=1, replays=2)
    # the same signature from the host's pinned memory, as the benchmark
    # hands its batches
    host = images.cpu().pin_memory()
    assert _graph_equals_eager(det, host, uint8, calls=2) == _counts(
        replays=2)


@pytest.mark.card
@pytest.mark.parametrize("option", [dict(merge=True),
                                    dict(class_filter=(0, 5, 171)),
                                    dict(multi_label=True)],
                         ids=["merge", "class_filter", "multi_label"])
def test_card_nms_options_graph_equals_eager(card, option):
    det = _card_detector("n", card)
    assert _graph_equals_eager(det, _card_batch(8, 8, card), True,
                               **option) == _counts(first_call=1, captures=1,
                                                    replays=2)


@pytest.mark.card
def test_card_n640_b64_graph_equals_eager(card):
    det = _card_detector("n", card)
    assert _graph_equals_eager(det, _card_batch(64, 2, card).cpu(), True) \
        == _counts(first_call=1, captures=1, replays=2)


@pytest.mark.card
def test_card_inference_b1_graph_equals_eager(card, x_state):
    det = _card_detector("x", card, x_state)
    image = _card_batch(1, 3, card)[0].cpu().numpy()
    want = det.inference(image, conf_thres=POOL_CONF)
    before = profiling.serve_graph_stats()
    for _ in range(3):
        got = det.inference(image, conf_thres=POOL_CONF)
        assert len(got) == 1 and np.array_equal(got[0], want[0])
    assert _delta(before) == _counts(captures=1, replays=3)


@pytest.mark.card
def test_card_batches_in_flight(card, x_state):
    """Three batches dispatched before any is fetched, each equal to its
    own eager result."""
    det = _card_detector("x", card, x_state)
    batches = [_card_batch(8, 10 + i, card).cpu().pin_memory()
               for i in range(3)]
    opts = {**SERVE, "conf_thres": POOL_CONF}
    want = [_eager(det, b, True, **opts) for b in batches]
    for _ in range(2):
        det.serve(batches[0], device_preprocess=True, **opts)
    results = [det.serve(b, device_preprocess=True, **opts) for b in batches]
    for got, ref in zip(results, want):
        _assert_equal(got, ref)


@pytest.mark.card
@pytest.mark.parametrize("calibrated", [False, True],
                         ids=["dynamic", "static"])
def test_card_int8_graph_equals_eager(card, x_state, calibrated):
    det = _card_detector("x", card, x_state).quantize(stochastic=True)
    images = _card_batch(8, 4, card)
    if calibrated:
        det.calibrate([det._input(images, True)])
    delta = _graph_equals_eager(det, images, True)
    # eager where a capture failed, and counted
    assert delta in (_counts(first_call=1, captures=1, replays=2),
                     _counts(first_call=1, capture_failed=2))


@pytest.mark.card
def test_card_optimized_cls_tower_graph_equals_eager(card, x_state):
    det = _card_detector("x", card, x_state).optimize_for_serving()
    det.model.head.fused_cls_tower = True
    images = _card_batch(8, 5, card)
    start = profiling.kernel_launches()
    assert _graph_equals_eager(det, images, True) == _counts(
        first_call=1, captures=1, replays=2)
    now = profiling.kernel_launches()
    # K1 twice, K5 and K2 once and K6 six times a call: the eager call
    # for the reference and three calls of serve
    assert {k: now[k] - start[k] for k in now if now[k] != start[k]} == {
        "attention": 8, "sppf": 4, "nms_batched": 4, "cls_tower": 24}


@pytest.mark.card
@pytest.mark.parametrize("devices", [["cuda"], ["cuda", "cuda"]],
                         ids=["one", "listed_twice"])
def test_card_sharded_serve_on_side_streams(card, x_state, devices):
    """``make_sharded_serve_fn`` on the card's side streams (a card listed
    twice: two slices through one detector's graphs), each call equal to
    the eager results of its slices."""
    det = _card_detector("x", card, x_state)
    opts = {**SERVE, "conf_thres": POOL_CONF}
    fn = make_sharded_serve_fn(det, devices, device_preprocess=True, **opts)
    images = _card_batch(8, 6, card).cpu()
    parts = images.chunk(len(devices))
    want = [_eager(det, p, True, **opts) for p in parts]
    want = type(want[0])(*(torch.cat(t) for t in zip(*want)))
    before = profiling.serve_graph_stats()
    for _ in range(3):
        _assert_equal(fn(images), want)
    torch.cuda.synchronize()
    delta = _delta(before)
    # a card listed twice: the second slice's first call runs eagerly too
    # where it comes while the first one's is still under way
    assert delta["captures"] == 1 and delta["eager/capture_failed"] == 0
    assert delta["eager/first_call"] in range(1, len(devices) + 1)
    assert delta["eager/first_call"] + delta["replays"] == 3 * len(devices)


class SyncingCapture(serve_graph.CudaCapture):
    """The real capture, with a wait for the stream inside each phase,
    which a capture cannot hold."""

    def session(self, device):
        inner = super().session(device)

        def capture(fn):
            def unsafe():
                torch.cuda.current_stream().synchronize()
                return fn()
            return inner(unsafe)
        return capture


@pytest.mark.card
def test_card_failed_capture_stays_eager_and_the_card_serves_on(card,
                                                               x_state):
    """Last in the file: a capture that fails leaves its signature eager,
    and the process serves on, graphs included."""
    det = _card_detector("x", card, x_state)
    det._graphs = serve_graph.ServeGraphs(SyncingCapture())
    images = _card_batch(8, 7, card)
    with pytest.warns(RuntimeWarning, match="runs eagerly"):
        assert _graph_equals_eager(det, images, True) == _counts(
            first_call=1, capture_failed=2)
    det._graphs = serve_graph.ServeGraphs()
    assert _graph_equals_eager(det, images, True) == _counts(
        first_call=1, captures=1, replays=2)
