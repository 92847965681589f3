"""The cell ``x4k-serve-b1``: its configuration and mix found by name, what
it reports, and the shapes its kernels' least times are taken at (one 4K
frame: 2176 × 3840, the x preset at batch 1). What decides its
``correct`` is held with the other serving cell's in
``test_perfbench_control.py``."""

import pytest

from perfbench import core, flops

CELL = "x4k-serve-b1"
X640 = core.load_json(core.BENCH / "configs" / "x640.json")
X4K = core.load_json(core.BENCH / "configs" / "x4k.json")


def test_config_is_x640_on_a_4k_frame():
    # the same model: only the frame's size, the assumptions, the
    # deployment and the limits differ
    own = {"name", "input_size", "assumed", "deployment", "limits"}
    assert ({k: v for k, v in X4K.items() if k not in own}
            == {k: v for k, v in X640.items() if k not in own})
    h, w = X4K["input_size"]
    assert (h, w) == (2176, 3840) and h % 32 == 0 and w % 32 == 0
    assert h - 2160 == 16
    # gap_mean is not compared: the int8 control reads under three times
    # its sound readings at 4K (PERF.md)
    assert set(X4K["limits"]["serve"]) == {"box_mean", "unmatched_pct",
                                           "nms_overlaps"}


def test_cell_resolves_and_reports_what_it_must():
    bench = core.spec()
    resolved = core.cell(CELL, bench)
    assert resolved["cell"]["chips"] == 1
    assert resolved["config"]["name"] == "x4k"
    mix = resolved["mix"]
    assert mix["generator"] == "serve" and mix["batch"] == 1
    assert (mix["inflight"], mix["ring"], mix["top_k"], mix["max_det"]) == (
        2, 16, 1024, 300)
    e2e = {m["name"] for m in resolved["end_to_end"]}
    assert {"setup_s", "serve_p95_ms"} <= e2e
    per_layer = {m["name"] for m in resolved["per_layer"]}
    assert {"attention_roofline.serve", "fwd_device_ms.serve",
            "decode_nms_device_ms.serve", "kernels_roofline.serve",
            "mfu.serve", "idle_pct.serve"} <= per_layer
    # x640's host-paced rate has no stand-in here: the card sets the pace
    assert "pace_img_s.serve" not in per_layer
    assert not any(m["name"].endswith(".train") for m in
                   resolved["per_layer"])


def test_attention_at_8160_tokens():
    k1 = core.kernel("k1_attention")
    shape = k1.call_shape(X4K, 1)
    assert shape == {"b": 1, "t": 68 * 120, "nh": 6, "dk": 32, "dh": 64,
                     "elem": 2}
    seconds, by = k1.bound_s(**shape)
    # 2 · 6 · 8160² · (32 + 64) = 76.7 GFLOP at 989 TFLOP/s
    assert seconds * 1e3 == pytest.approx(76.7e9 / 989e12 * 1e3, rel=2e-3)
    assert by == "operations"


def test_sppf_and_nms_at_one_4k_frame():
    k5 = core.kernel("k5_sppf")
    shape = k5.call_shape(X4K, 1)
    assert shape == {"b": 1, "c": 384, "h": 68, "w": 120, "elem": 2}
    # PERF.md's table: K5's 4K map, 0.00935 ms by bytes
    assert k5.bound_s(**shape)[0] * 1e3 == pytest.approx(0.00935, rel=2e-3)
    # at batch 1 K2's bound is K3's: one pool of 1024 of 171,360 anchors
    k2, k3 = core.kernel("k2_nms"), core.kernel("k3_nms_single")
    assert k2.call_shape(X4K, 1) == {"n": 1, "k": 1024}
    assert k2.bound_s(**k2.call_shape(X4K, 1)) == k3.bound_s(
        **k3.call_shape(X4K))
    assert sum((2176 // s) * (3840 // s) for s in (8, 16, 32)) == 171360


def test_model_flops_at_4k():
    # the convolutions scale with the pixels (20.4 × x640's 195.9 GFLOP)
    # and the two PSA attentions with their square (2 × 76.7 GFLOP)
    per_frame = flops.per_image(X4K, False)
    pixels = 2176 * 3840 / 640 ** 2
    assert per_frame / 1e12 == pytest.approx(4.1415, rel=1e-3)
    assert per_frame > pixels * flops.per_image(X640, False)

