"""The readers of the program's own spans (``perfbench/program_spans.py``
and the five metrics bound to them) on hand-written traces, against values
worked out by hand; none reads anything where the spans are absent, and
the spans move no phase of the digest."""

from types import SimpleNamespace

import pytest

from perfbench import core, readers
from perfbench import program_spans as ps
from perfbench import trace as tr

X640 = core.load_json(core.BENCH / "configs" / "x640.json")
PROGRAM = ("serve", "serve/", "train/")


def _x(name, cat, ts, dur, tid=1, **args):
    return {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur,
            "pid": 1, "tid": tid, "args": args}


def _span(name, ts, dur, tid=1):
    return _x(name, "user_annotation", ts, dur, tid=tid)


def _launch(ts, corr, tid=1, name="cudaLaunchKernel"):
    return _x(name, "cuda_runtime", ts, 1, tid=tid, correlation=corr)


def _device(name, ts, dur, corr, cat="kernel"):
    return _x(name, cat, ts, dur, tid=7, correlation=corr)


def serve_trace():
    """Two batches in a 200 µs window. The first: its input (a copy and
    the normalisation), a forward stage, the decode and the NMS; the
    benchmark's ``decode_nms`` span opens at the model's return and closes
    after ``serve``'s. The second: its input and a forward stage.

    Card: copy 15-25, normalise 26-29, conv 40-55, decode 62-66, NMS
    75-85, copy 110-130, conv 150-160. Idle gaps open at 0 (outside
    ``serve``), 25 and 29 (in ``serve/input``), 55, 66, 85 (in ``serve``),
    130 (in ``serve/input``) and 160 (in ``serve``)."""
    return [
        _span(tr.WINDOW, 0, 200),
        _span("serve", 10, 80),
        _span("serve/input", 10, 20),
        _x("aten::copy_", "cpu_op", 11, 17),
        _launch(12, 1, name="cudaMemcpyAsync"),
        _launch(25, 2),
        _span("serve/forward", 30, 30),
        _span("fwd/net.p1_conv", 31, 19),
        _launch(32, 3),
        _span(tr.DECODE_SPAN, 59, 33),
        _span("serve/decode", 60, 10),
        _launch(61, 4),
        _span("serve/nms", 70, 20),
        _launch(71, 5),
        _span("serve", 100, 80),
        _span("serve/input", 100, 40),
        _launch(101, 6, name="cudaMemcpyAsync"),
        _span("serve/forward", 140, 30),
        _span("fwd/net.p1_conv", 140, 25),
        _launch(141, 7),
        _device("Memcpy HtoD (Pinned -> Device)", 15, 10, 1, "gpu_memcpy"),
        _device("elementwise_kernel<float>(int)", 26, 3, 2),
        _device("conv_kernel(int)", 40, 15, 3),
        _device("dfl_kernel(int)", 62, 4, 4),
        _device("nms_sweep_kernel(int)", 75, 10, 5),
        _device("Memcpy HtoD (Pinned -> Device)", 110, 20, 6, "gpu_memcpy"),
        _device("conv_kernel(int)", 150, 10, 7),
    ]


def train_trace():
    """One step in a 100 µs window: the assigner's kernel and another of
    the loss on the main thread, a backward kernel from autograd's thread.
    Card: assign 30-36, loss 40-44, backward 50-70; gaps open at 0 (before
    ``train/step``), 36, 44 and 70 (inside it)."""
    return [
        _span(tr.WINDOW, 0, 100),
        _span(tr.STEP, 0, 100),
        _span("train/step", 5, 90),
        _span("train/forward", 6, 12),
        _span("train/loss", 20, 20),
        _span(tr.LOSS_SPAN, 20, 20),
        _span("train/assign", 22, 8),
        _launch(23, 1),
        _launch(35, 2),
        _span("train/backward", 45, 30),
        _x(tr.BWD_PREFIX + " ConvBackward0", "cpu_op", 48, 10, tid=2),
        _launch(49, 3, tid=2),
        _device("topk_kernel(int)", 30, 6, 1),
        _device("bce_kernel(int)", 40, 4, 2),
        _device("dgrad_kernel(int)", 50, 20, 3),
    ]


def view(events, items, rest):
    return SimpleNamespace(digest=tr.Digest(events, items=items,
                                            images=8 * items, rest=rest),
                           config=X640, mix={"batch": 8})


def metric(name, v):
    return core.metric_reader(name).read(v)


def test_serving_readers():
    v = view(serve_trace(), 2, (10, 80, 0.002))
    # the untraced pace 200 µs a batch, the traced busy 72 µs in 2
    assert readers.idle_pct(v) == pytest.approx(100 * (1 - 36 / 200))
    # copies 10 + 20 and the normalisation 3, over 2 batches
    assert metric("input_device_ms.serve", v) == pytest.approx(33 / 2e3)
    # the host inside serve/input: 20 + 40 µs
    assert metric("input_wait_ms.serve", v) == pytest.approx(60 / 2e3)
    # idle 15 + 1 + 11 + 7 + 9 + 25 + 20 + 40 = 128 µs; in serve and not
    # in its input: 7 + 9 + 25 + 40
    assert sum(b - a for a, b in ps.gaps(v.digest)) == pytest.approx(128)
    assert metric("dispatch_idle_pct.serve", v) == pytest.approx(
        82 * 81 / 128)
    assert metric("dispatch_idle_pct.train", v) is None
    assert metric("assign_device_ms.train", v) is None


def test_training_readers():
    v = view(train_trace(), 1, (10, 80, 0.002))
    assert metric("assign_device_ms.train", v) == pytest.approx(6 / 1e3)
    # idle 30 + 4 + 6 + 30 = 70 µs, 4 + 6 + 30 of it in the step; the
    # untraced idle share 1 − 30 / 200
    assert readers.idle_pct(v) == pytest.approx(85)
    assert metric("dispatch_idle_pct.train", v) == pytest.approx(
        85 * 40 / 70)
    for name in ("input_device_ms.serve", "input_wait_ms.serve",
                 "dispatch_idle_pct.serve"):
        assert metric(name, v) is None


@pytest.mark.parametrize("trace,items", [(serve_trace, 2), (train_trace, 1)])
def test_nothing_to_read_without_the_programs_spans(trace, items):
    parent = [e for e in trace() if not e["name"].startswith(PROGRAM)]
    v = view(parent, items, (10, 80, 0.002))
    for name in ("input_device_ms.serve", "input_wait_ms.serve",
                 "dispatch_idle_pct.serve", "dispatch_idle_pct.train",
                 "assign_device_ms.train"):
        assert metric(name, v) is None, name
    # nor without the untraced rest that the idle share needs
    assert metric("dispatch_idle_pct.serve",
                  view(serve_trace(), 2, (0, 0, 0.0))) is None


@pytest.mark.parametrize("trace,items", [(serve_trace, 2), (train_trace, 1)])
def test_program_spans_move_no_phase(trace, items):
    """The digest files each device event in the same phase with the
    program's spans as without them."""
    parent = [e for e in trace() if not e["name"].startswith(PROGRAM)]
    with_spans = tr.Digest(trace(), items=items, images=8 * items)
    without = tr.Digest(parent, items=items, images=8 * items)
    assert ([e["phase"] for e in with_spans.events]
            == [e["phase"] for e in without.events])
    assert with_spans.busy == without.busy


def replay_trace():
    """One batch served by graph replay in a 100 µs window: the eager input
    (a copy and the normalisation), then one ``cudaGraphLaunch`` in each of
    ``serve/forward``, ``serve/decode`` and ``serve/nms``, whose kernels
    all carry the launch's correlation id; the result's clone is copied
    under ``serve/nms``. No ``fwd/`` span fires in a replay.

    Card: copy 10-14, normalise 15-17, forward conv 20-40, K1 40-50, K5
    50-52, decode 55-58, NMS 60-62 and 62-65, clone 66-67."""
    return [
        _span(tr.WINDOW, 0, 100),
        _span("serve", 5, 70),
        _span("serve/input", 5, 10),
        _launch(6, 1, name="cudaMemcpyAsync"),
        _launch(9, 2),
        _span("serve/forward", 16, 5),
        _launch(17, 3, name="cudaGraphLaunch"),
        _span("serve/decode", 22, 3),
        _launch(23, 4, name="cudaGraphLaunch"),
        _span("serve/nms", 26, 8),
        _launch(27, 5, name="cudaGraphLaunch"),
        _launch(30, 6, name="cudaMemcpyAsync"),
        _device("Memcpy HtoD (Pinned -> Device)", 10, 4, 1, "gpu_memcpy"),
        _device("elementwise_kernel<float>(int)", 15, 2, 2),
        _device("conv_kernel(int)", 20, 20, 3),
        _device("psa_attention_fwd_bf16(int)", 40, 10, 3),
        _device("sppf_pyramid_kernel(int)", 50, 2, 3),
        _device("dfl_kernel(int)", 55, 3, 4),
        _device("nms_mask_kernel(int)", 60, 2, 5),
        _device("nms_sweep_kernel(int)", 62, 3, 5),
        _device("Memcpy DtoD (Device -> Device)", 66, 1, 6, "gpu_memcpy"),
    ]


X4K = core.load_json(core.BENCH / "configs" / "x4k.json")


def test_replayed_kernels_fall_under_their_launchs_span():
    v = SimpleNamespace(digest=tr.Digest(replay_trace(), items=1, images=1),
                        config=X4K, mix={"batch": 1})
    # the three graphs' kernels, each under the span of its launch
    assert metric("fwd_device_ms.serve", v) == pytest.approx(32 / 1e3)
    assert metric("decode_nms_device_ms.serve", v) == pytest.approx(9 / 1e3)
    assert metric("input_device_ms.serve", v) == pytest.approx(6 / 1e3)
    # nothing is filed under the benchmark's own hooks, which a replay
    # does not fire
    assert {e["phase"] for e in v.digest.events} == {"other"}
    assert metric("attention_roofline.serve", v) == pytest.approx(
        100 * 7.755976865520728e-05 / 10e-6)
    k5, k2 = core.kernel("k5_sppf"), core.kernel("k2_nms")
    bound = (7.755976865520728e-05
             + k5.bound_s(**k5.call_shape(X4K, 1))[0]
             + k2.bound_s(**k2.call_shape(X4K, 1))[0])
    assert metric("kernels_roofline.serve", v) == pytest.approx(
        100 * bound / 17e-6)


def test_eager_serving_phases_by_the_programs_spans():
    """The serving traffic installs none of the benchmark's hooks: without
    them the program's spans read what the hooks read in the same batches
    (the hooks' ``decode_nms`` span, which opens inside ``serve/forward``
    and closes after ``serve``, does not nest)."""
    hooks = view(serve_trace(), 2, (10, 80, 0.002))
    v = view([e for e in serve_trace() if e["name"] != tr.DECODE_SPAN
              and not e["name"].startswith(tr.FWD_PREFIX)],
             2, (10, 80, 0.002))
    # the forward's conv launches 15 + 10 µs; the decode 4 and the NMS 10
    assert metric("fwd_device_ms.serve", v) == pytest.approx(25 / 2e3)
    assert metric("decode_nms_device_ms.serve", v) == pytest.approx(14 / 2e3)
    assert metric("fwd_device_ms.serve", v) == pytest.approx(
        readers.phase_ms(hooks, "fwd"))
    assert metric("decode_nms_device_ms.serve", v) == pytest.approx(
        readers.phase_ms(hooks, "decode_nms"))
    assert metric("attention_roofline.serve", v) is None


@pytest.mark.parametrize("name", ["fwd_device_ms.serve",
                                  "decode_nms_device_ms.serve",
                                  "attention_roofline.serve"])
@pytest.mark.parametrize("trace,items", [(serve_trace, 2), (train_trace, 1),
                                         (replay_trace, 1)])
def test_serving_phases_read_nothing_without_their_spans(name, trace, items):
    parent = [e for e in trace() if not e["name"].startswith(PROGRAM)
              and "psa_attention" not in e["name"]]
    assert metric(name, view(parent, items, (10, 80, 0.002))) is None
