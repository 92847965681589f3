"""The cell ``y12x4k-serve-b1``: YOLO12 at scale x on one 4K frame. Its
configuration, mix and metrics found by name; K1's shape and bound as
the area attention calls it; the model's FLOPs; the three readers on a
synthetic trace; and what decides ``correct``, at a 448 × 800 frame on
the CPU (4K's wide aspect; p4's 28 × 50 map in 4 strips of 350 tokens):
a sound run passes, the int8 control fails, and so does each fault
planted underneath a whole run (the NMS faults of ``faults.py``, the
area faults of ``area_faults.py``)."""

import time
from types import SimpleNamespace

import pytest
import torch

from perfbench import core, flops_y12
from perfbench import trace as tr
from perfbench.calibrate_y12 import PLANTED
from perfbench.run import Run
from perfbench.traffic import serve_y12

CELL = "y12x4k-serve-b1"
Y12 = core.load_json(core.BENCH / "configs" / "y12x4k.json")
X4K = core.load_json(core.BENCH / "configs" / "x4k.json")
SERVING = ("idle_pct.serve", "launches_per_batch.serve",
           "fwd_device_ms.serve", "decode_nms_device_ms.serve",
           "input_device_ms.serve", "input_wait_ms.serve",
           "dispatch_idle_pct.serve")
OWN = ("mfu_y12.serve", "area_attention_roofline.serve",
       "area_attention_device_ms.serve")
CPU = torch.device("cpu")


def test_config_is_yolo12x_on_x4ks_frame():
    assert Y12["arch"] == "yolo12"
    assert Y12["width"] == [3, 96, 192, 384, 768, 768]
    assert Y12["depth"] == [2, 2, 4, 4, 2]
    for key in ("input_size", "num_classes", "reg_max", "precision"):
        assert Y12[key] == X4K[key], key
    assert list(Y12["reduced"]) == ["num_classes"]
    assert set(Y12["limits"]) == {"serve_y12"}


def test_cell_resolves_and_reports_what_it_must():
    bench = core.spec()
    resolved = core.cell(CELL, bench)
    assert resolved["cell"]["chips"] == 1
    assert resolved["config"]["name"] == "y12x4k"
    mix = resolved["mix"]
    # serve_b1's parameters, generator apart
    b1 = core.load_json(core.BENCH / "mixes" / "serve_b1.json")
    assert mix == dict(b1, generator="serve_y12")
    assert ({m["name"] for m in resolved["end_to_end"]}
            == {"setup_s", "serve_img_s", "serve_p95_ms"})
    assert {m["name"] for m in resolved["per_layer"]} == set(SERVING + OWN)
    own = [m for m in bench["per_layer"] if m["name"] in OWN]
    assert [m["name"] for m in own] == list(OWN)
    assert all(m["workloads"] == [CELL] for m in own)
    assert core.listing()["kernels"].count("k1_area_attention") == 1


def test_attention_shape_and_bound():
    k = core.kernel("k1_area_attention")
    shape = k.call_shape(Y12, 1)
    # 8 calls over p4's 4 strips and 8 over p5's one: a mean of 2.5 frames'
    # worth of 8,160-token strips a call
    assert shape == {"b": 2.5, "t": 8160, "nh": 12, "dk": 32, "dh": 32,
                     "elem": 2}
    seconds, by = k.bound_s(**shape)
    assert by == "operations"
    # one forward's attention products, 16 calls: 2 · 12 · 8160² · 64 a
    # strip, 40 strips
    products = 40 * 2 * 12 * 8160 ** 2 * 64
    assert 16 * seconds == pytest.approx(products / 989e12, rel=1e-9)
    assert products / 1e9 == pytest.approx(4091.0, rel=1e-4)
    k1 = core.kernel("k1_attention")
    assert seconds == pytest.approx(k1.bound_s(2.5, 8160, 12, 32, 32)[0])


def test_model_flops():
    # a plain sketch of the yaml counts, 172 classes: 7,816.6 GFLOP a
    # 4K frame, 192.5 at 640²; the attention is half of the 4K frame's
    assert flops_y12.per_image(Y12) / 1e9 == pytest.approx(7816.6, rel=1e-4)
    small = dict(Y12, input_size=[640, 640])
    assert flops_y12.per_image(small) / 1e9 == pytest.approx(192.5, rel=1e-3)


def _x(name, cat, ts, dur, tid=1, **args):
    return {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur,
            "pid": 1, "tid": tid, "args": args}


def test_readers_on_a_synthetic_window():
    ev = [_x(tr.WINDOW, "user_annotation", 0, 1000),
          _x("cudaGraphLaunch", "cuda_runtime", 1, 1, correlation=1)]
    # two frames: 16 K1 calls of 20 µs each and one convolution of 100 µs
    for i in range(32):
        ev.append(_x("void psa_attention_fwd_tc<32, 32>(...)", "kernel",
                     10 + 25 * i, 20, tid=7, correlation=1))
    ev.append(_x("cutlass_conv(int)", "kernel", 850, 100, tid=7,
                 correlation=1))
    d = tr.Digest(ev, items=2, images=2, rest=(10, 10, 0.5))
    view = SimpleNamespace(digest=d, config=Y12, mix={"batch": 1})
    read = {name: core.metric_reader(name).read(view) for name in OWN}
    assert read["area_attention_device_ms.serve"] == pytest.approx(0.32)
    k = core.kernel("k1_area_attention")
    bound = k.bound_s(**k.call_shape(Y12, 1))[0]
    assert read["area_attention_roofline.serve"] == pytest.approx(
        100 * 32 * bound / 640e-6)
    # 10 frames in 0.5 s of 7,816.6 GFLOP each against 989 TFLOP/s
    assert read["mfu_y12.serve"] == pytest.approx(
        100 * 20 * flops_y12.per_image(Y12) / 989e12)
    empty = tr.Digest(ev[:1], items=2, images=2)
    view = SimpleNamespace(digest=empty, config=Y12, mix={"batch": 1})
    assert all(core.metric_reader(n).read(view) is None for n in OWN)


def cell():
    cfg = dict(Y12, input_size=[448, 800])
    mix = core.load_json(core.BENCH / "mixes" / "serve_b1_y12.json")
    mix.update(ring=2, warm_batches=2, check_batches=2)
    return {"config": cfg, "mix": mix}


def run(seed, wrap=None):
    r = Run(cell(), seed=seed, seconds=0.05, trace=False, device=CPU,
            t_start=time.time())
    original = serve_y12.build_detector
    if wrap is not None:
        serve_y12.build_detector = wrap(original)
    try:
        out = serve_y12.run(r)
    finally:
        serve_y12.build_detector = original
    return (all(c["ok"] for c in out["compared"]),
            {c["name"]: c["value"] for c in out["compared"]})


@pytest.fixture(autouse=True)
def few_threads():
    threads = torch.get_num_threads()
    torch.set_num_threads(min(threads, 8))
    yield
    torch.set_num_threads(threads)


def test_sound_run_passes():
    ok, numbers = run(2 ** 31 + 11)
    assert ok, numbers


@pytest.mark.parametrize("kind", sorted(PLANTED))
def test_control_and_faults_fail(kind):
    ok, numbers = run(2 ** 31 + 11, PLANTED[kind])
    assert not ok, (kind, numbers)
