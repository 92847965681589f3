"""The benchmark's arithmetic on the CPU: the tail over every batch, the
trace's reduction (busy time, idle share, attribution, gaps), the kernels'
least times against the table of ``PERF.md`` (x/640², B=8), the model's
FLOPs and the result line's keys."""

import io
import json
import sys
from types import SimpleNamespace

import numpy as np
import pytest

from perfbench import core, flops, readers
from perfbench import trace as tr
from perfbench.traffic import serve

X640 = core.load_json(core.BENCH / "configs" / "x640.json")
N640 = core.load_json(core.BENCH / "configs" / "n640.json")


def test_p95_is_over_every_batch():
    lat = [0.010] * 95 + [0.100] * 5
    # linear interpolation between the 95th and 96th order statistics
    assert serve.p95_ms(lat) == pytest.approx(
        np.percentile(np.asarray(lat), 95) * 1e3)
    assert serve.p95_ms(list(range(1, 101))) == pytest.approx(95.05 * 1e3)


def test_check_sample_is_seeded_and_holds_the_last_batch():
    a = serve.check_sample(2 ** 31 + 5, 500, 4)
    assert a == serve.check_sample(2 ** 31 + 5, 500, 4)
    assert len(a) == 4 and a[-1] == 499 and len(set(a)) == 4
    assert serve.check_sample(7, 1, 4) == [0]


def _x(name, cat, ts, dur, tid=1, **args):
    return {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur,
            "pid": 1, "tid": tid, "args": args}


def synthetic_trace():
    """A window of 100 µs on the main thread: a forward span with two
    launches, a decode span with one, a backward op on another thread,
    an optimizer span; device events at known times."""
    ev = [
        _x(tr.WINDOW, "user_annotation", 0, 100),
        _x(tr.STEP, "user_annotation", 0, 100),
        _x("fwd/net.p1_conv", "user_annotation", 1, 20),
        _x("cudaLaunchKernel", "cuda_runtime", 2, 1, correlation=1),
        _x("cudaLaunchKernel", "cuda_runtime", 5, 1, correlation=2),
        _x(tr.DECODE_SPAN, "user_annotation", 25, 10),
        _x("cudaLaunchKernel", "cuda_runtime", 26, 1, correlation=3),
        _x(tr.BWD_PREFIX + " ConvBackward0", "cpu_op", 40, 10, tid=2),
        _x("cudaLaunchKernel", "cuda_runtime", 41, 1, tid=2, correlation=4),
        _x("aten::_foreach_norm", "cpu_op", 60, 5),
        _x("cudaLaunchKernel", "cuda_runtime", 61, 1, correlation=5),
        _x("Optimizer.step#AdamW.step", "user_annotation", 70, 10),
        _x("cudaLaunchKernel", "cuda_runtime", 71, 1, correlation=6),
        # device: fwd 10-20 and 15-30 (overlap), decode 40-50, bwd 55-65,
        # norm 70-75, adam 80-90
        _x("conv_kernel(int)", "kernel", 10, 10, tid=7, correlation=1),
        _x("silu_kernel<float>(int)", "kernel", 15, 15, tid=7,
           correlation=2),
        _x("nms_sweep_kernel(int)", "kernel", 40, 10, tid=7, correlation=3),
        _x("dgrad_kernel(int)", "kernel", 55, 10, tid=7, correlation=4),
        _x("multi_tensor_apply(int)", "kernel", 70, 5, tid=7, correlation=5),
        _x("multi_tensor_apply(int)", "kernel", 80, 10, tid=7,
           correlation=6),
    ]
    return ev


def test_digest_busy_idle_and_phases():
    d = tr.Digest(synthetic_trace(), items=2, images=16,
                  rest=(10, 80, 0.002))
    assert d.window_s == pytest.approx(100e-6)
    # union of [10, 30], [40, 50], [55, 65], [70, 75], [80, 90]
    assert d.busy_s == pytest.approx(55e-6)
    assert d.phase_s("fwd") == pytest.approx(25e-6)
    assert d.phase_s("decode_nms") == pytest.approx(10e-6)
    assert d.phase_s("bwd") == pytest.approx(10e-6)
    # the norm after the backward, and the optimizer's span
    assert d.phase_s("optim") == pytest.approx(15e-6)
    assert d.kernel_s(("nms_sweep_kernel",)) == (pytest.approx(10e-6), 1)
    view = SimpleNamespace(digest=d, config=X640, mix={"batch": 8})
    # untraced pace 0.2 ms an item; traced busy 27.5 µs an item
    assert readers.idle_pct(view) == pytest.approx(100 * (1 - 27.5 / 200))
    assert readers.launches_per_item(view) == 3.0
    assert readers.rest_img_s(view) == pytest.approx(80 / 0.002)
    assert readers.phase_ms(view, "fwd") == pytest.approx(12.5e-3)
    assert readers.phase_ms(view, "loss") is None
    gaps = dict(d.idle_gaps())
    # idle 0-10 and 30-40 under the forward span (the 30-40 gap starts
    # after it ends: the step span), 50-55, 65-70, 75-80, 90-100
    assert sum(gaps.values()) == pytest.approx(45e-6)
    assert {k for k, _ in d.top_ops(2)} == {"silu_kernel",
                                            "multi_tensor_apply"}


def test_reader_without_rest_or_events_returns_nothing():
    d = tr.Digest(synthetic_trace(), items=2, images=16)
    view = SimpleNamespace(digest=d, config=X640, mix={"batch": 8})
    assert readers.idle_pct(view) is None
    assert readers.mfu_pct(view, train=False) is None
    assert readers.rest_img_s(view) is None
    assert readers.roofline_pct(view, ("k1_attention",)) is None


def test_roofline_reader_sums_bounds_over_times():
    d = tr.Digest(synthetic_trace(), items=2, images=16)
    view = SimpleNamespace(digest=d, config=X640, mix={"batch": 8})
    k2 = core.kernel("k2_nms")
    want = k2.bound_s(**k2.call_shape(X640, 8))[0] / 10e-6 * 100
    assert readers.roofline_pct(view, ("k2_nms",)) == pytest.approx(want)


@pytest.mark.parametrize("kernel,table_ms,by", [
    ("k1_attention", 0.00293, "bytes"),
    ("k4_attention_bwd", 0.00440, "bytes"),
    ("k5_sppf", 0.00367, "bytes"),
])
def test_kernel_bounds_match_the_table(kernel, table_ms, by):
    k = core.kernel(kernel)
    seconds, bound_by = k.bound_s(**k.call_shape(X640, 8))
    assert seconds * 1e3 == pytest.approx(table_ms, rel=2e-3)
    assert bound_by == by


def test_nms_bound_from_its_pool_and_kept_pairs():
    k2 = core.kernel("k2_nms")
    shape = k2.call_shape(X640, 8)
    assert shape == {"n": 8, "k": 1024}
    # the bytes alone: each box, its validity and its keep flag once
    assert k2.bound_s(**shape)[0] * 1e3 == pytest.approx(
        8 * 1024 * 18 / 3.35e12 * 1e3)
    # the table's 0.0000463 ms (operations) is 14 operations for each of
    # the pairs the serve pool's kept boxes test
    pairs = round(0.0000463e-3 * 67e12 / 14)
    seconds, by = k2.bound_s(**shape, pairs=pairs)
    assert seconds * 1e3 == pytest.approx(0.0000463, rel=1e-3)
    assert by == "operations"
    k3 = core.kernel("k3_nms_single")
    assert k3.bound_s(**k3.call_shape(X640))[0] == pytest.approx(
        k2.bound_s(**shape)[0] / 8)


def test_other_kernels_have_bounds():
    k6 = core.kernel("k6_cls_tower")
    seconds, _ = k6.bound_s(**k6.call_shape(X640, 8))
    # PERF.md's table: 0.0693 ms by operations at the x serve shape
    assert seconds * 1e3 == pytest.approx(0.0693, rel=0.01)
    k7 = core.kernel("k7_quant")
    n = k7.call_shape(X640)["elements"]
    assert 40e6 < n < 60e6
    assert k7.bound_s(n)[1] == "bytes"


def test_model_flops():
    # counted on the reference: x forward 195.5 GFLOP an image (the
    # count in the port's records), the x train step ~645
    # (torch_multichip_report's
    # 5,163.5 GFLOP at B=8), n forward 7.4
    assert flops.per_image(X640, False) / 1e9 == pytest.approx(195.5,
                                                                rel=0.01)
    assert flops.per_image(X640, True) / 1e9 == pytest.approx(645.4,
                                                               rel=0.01)
    assert flops.per_image(N640, False) / 1e9 == pytest.approx(7.4,
                                                                rel=0.02)


def test_result_line_keys(monkeypatch):
    out, err = io.StringIO(), io.StringIO()
    monkeypatch.setattr(sys, "stdout", out)
    monkeypatch.setattr(sys, "stderr", err)
    compared = [core.compare("gap_mean", 0.03, 0.085),
                core.compare("box_mean", float("nan"), 0.02)]
    assert [c["ok"] for c in compared] == [True, False]
    core.emit({"correct": False, "attempted": 3, "failed": 0,
               "metrics": {"setup_s": core.metric_entry(1.5, "s")},
               "device": {"platform": "gpu", "kind": "k", "count": 1,
                          "memory_peak_bytes": 1}}, compared)
    line = json.loads(out.getvalue().strip().splitlines()[-1])
    assert list(line) == ["correct", "attempted", "failed", "metrics",
                          "device", "compared"]
    assert line["compared"]["gap_mean"] == {"value": 0.03, "limit": 0.085}
    assert err.getvalue().strip().splitlines()[-1].startswith(
        "compared box_mean")
    with pytest.raises(ValueError):
        core.metric_entry(float("inf"), "s")
