"""YOLO12 in the port (``Detector(..., arch="yolo12")``) against the
benchmark's plain fp32 reference (``perfbench/reference/yolo12.py``,
written from the ultralytics yaml and blocks), on the CPU in fp32, with
seeded random weights at a width whose attention stages hold two heads
of 32 channels, on frames whose p4 map divides into 4 strips.

The comparison is the largest gap of the raw predictions over their
largest magnitude. Its tolerance is 1e-3: both sides are fp32 and sum
each convolution and attention product in another order (the unfused
port reads 1.0e-4, the fused one 5e-5; the fold itself rounds), while a
fault in the area attention reads over 1e-1."""

import json
import os

import pytest
import torch

from custom_yolo_tpu_torch import Detector
from custom_yolo_tpu_torch.models.backbone import Backbone
from custom_yolo_tpu_torch.models.detector import YoloModel
from custom_yolo_tpu_torch.models.yolo12 import SCALES, Yolo12Backbone
from custom_yolo_tpu_torch.nn.blocks import AAttn
from custom_yolo_tpu_torch.ops.nms import nms_to_lists
from custom_yolo_tpu_torch.utils import profiling
from perfbench import area_faults
from perfbench.reference import yolo12 as ref12
from perfbench.weights import make_state

torch.set_num_threads(2)

WIDTH = (3, 16, 32, 64, 128, 128)
DEPTH = (1, 1, 2, 2, 1)
CSP = (True, True)
NC = 7
TOL = 1e-3
# (H, W): p4 maps of 8×16 and 16×28, both rows of 4 strips
SIZES = ((128, 256), (256, 448))


def gap(a, b):
    return float((a - b).abs().max() / b.abs().max())


@pytest.fixture(scope="module")
def state():
    layout = ref12.state_layout(WIDTH, DEPTH, CSP, NC)
    return make_state(layout, 3, torch.device("cpu"), 0.25)


def detector(state, size=SIZES[0], fused=True):
    det = Detector(WIDTH, DEPTH, CSP, NC, precision="float32",
                   input_size=size, device="cpu", arch="yolo12")
    det.load_variables(state)
    return det.fuse() if fused else det


def images(size, batch=2, seed=1):
    return torch.randn(batch, *size, 3,
                       generator=torch.Generator().manual_seed(seed))


def reference(state, x):
    return ref12.Reference(WIDTH, DEPTH, CSP, NC)(ref12.fold(state), x)


@pytest.mark.parametrize("size", SIZES)
@pytest.mark.parametrize("form", ("unfused", "fused"))
def test_yolo12_matches_reference(state, form, size):
    det = detector(state, size, fused=form == "fused")
    x = images(size)
    preds, anchors, strides = det(x)
    want, want_anchors, want_strides = reference(state, x)
    assert preds.shape == want.shape
    assert gap(preds, want) < TOL
    assert torch.equal(anchors, want_anchors)
    assert torch.equal(strides, want_strides)


@pytest.mark.parametrize("fault", area_faults.AREA)
def test_area_faults_fail_the_comparison(state, fault):
    det = detector(state)
    x = images(SIZES[0])
    want = reference(state, x)[0]
    with area_faults.planted(det.model, fault):
        assert gap(det(x)[0], want) > 100 * TOL
    # the fault is gone once its block ends
    assert gap(det(x)[0], want) < TOL


def test_area_attention_is_four_strip_attentions():
    torch.manual_seed(0)
    attn = AAttn(64, 2, area=4, fused=True).eval()
    for p in attn.parameters():
        p.data.normal_(0, 0.3)
    x = torch.randn(2, 64, 8, 12)
    params = {f"a.{k}": v for k, v in attn.state_dict().items()}
    ref = ref12.Reference(WIDTH, DEPTH, CSP, NC)
    ref.p = params
    # each strip of 2 rows attends alone (the reference's attention core
    # on that strip's 24 tokens); pe and proj see the whole map
    qkv = ref.conv_bn("a.qkv", x, act=False)
    t = qkv.flatten(2).transpose(1, 2).reshape(2, 96, 2, 96)
    out = torch.cat([ref.attend(t[:, 24 * s:24 * (s + 1)])
                     for s in range(4)], dim=1)
    out = out.transpose(1, 2).reshape(2, 64, 8, 12)
    v = t[..., 64:].reshape(2, 96, 64).transpose(1, 2).reshape(2, 64, 8, 12)
    want = ref.conv_bn("a.proj", out + ref.conv_bn("a.pe", v, act=False),
                       act=False)
    with torch.no_grad():
        got = attn(x)
        assert gap(got, want) < 1e-5
        assert torch.allclose(got, ref.area_attention("a", x, 4), atol=1e-5)
        # one strip of the whole map is another function
        attn.area = 1
        assert gap(attn(x), want) > 1e-2


def test_area_attention_refuses_a_map_it_cannot_cut():
    attn = AAttn(64, 2, area=4, fused=True)
    with pytest.raises(ValueError, match="4 strips"):
        attn(torch.zeros(1, 64, 3, 5))


def test_parameter_count_at_x():
    # ultralytics publishes 59.1 M for YOLO12x (80 classes). The yaml's
    # topology, counted with BatchNorm's scale and shift as ultralytics
    # counts, gives 58.13 M here and in a plain sketch of the yaml alike:
    # the 1.7% gap is not this port's, and stays inside 3%
    s = SCALES["x"]
    with torch.device("meta"):
        model = YoloModel(s["width"], s["depth"], s["csp"], 80,
                          arch="yolo12")
    n = sum(p.numel() for p in model.parameters())
    assert n == 58_132_496
    assert abs(n / 59.1e6 - 1) < 0.03
    # 16 attention blocks of 12 heads, 32 channels each
    blocks = [m for m in model.modules() if isinstance(m, AAttn)]
    assert len(blocks) == 16
    assert {(m.num_heads, m.dim_head) for m in blocks} == {(12, 32)}
    assert sorted(m.area for m in blocks) == [1] * 8 + [4] * 8
    assert model.net.p2_conv.conv.groups == 2
    assert model.net.p3_conv.conv.groups == 4


def test_default_arch_is_yolo11_and_yolo12_refuses_what_it_lacks(state):
    det = Detector(WIDTH, (1,) * 6, CSP, NC, device="cpu")
    det.init(0)
    assert type(det.model.net) is Backbone and det.arch == "yolo11"
    y12 = detector(state)
    assert type(y12.model.net) is Yolo12Backbone
    with pytest.raises(ValueError, match="optimize_for_serving"):
        y12.optimize_for_serving()
    with pytest.raises(ValueError, match="unknown architecture"):
        Detector(WIDTH, DEPTH, CSP, NC, device="cpu", arch="yolo13")


def test_fuse_keeps_gamma_and_save_load_round_trips(state, tmp_path):
    det = detector(state)
    for key in ("net.p4_attn.gamma", "net.p5_attn.gamma"):
        assert torch.equal(det.model.state_dict()[key], state[key])
    det.save_weights(str(tmp_path))
    again = Detector(WIDTH, DEPTH, CSP, NC, precision="float32",
                     input_size=SIZES[0], device="cpu", arch="yolo12")
    again.load_weights(str(tmp_path))
    x = images(SIZES[0])
    assert torch.equal(again(x)[0], det(x)[0])


def test_int8_serving_of_yolo12(state):
    # the default skip names YOLO12's stages; p3's 4-group conv is int8
    det = detector(state).quantize()
    assert det._quant_skip == ("p1_conv", "p2_conv", "p2_csp")
    assert det.model.net.p3_conv.conv.weight.dtype == torch.int8
    assert det.model.net.p4_attn.gamma.dtype == torch.float32
    x = images(SIZES[0])
    want = reference(state, x)[0]
    got = det(x)[0]
    # int8 rounding moves the outputs (by ~0.4 of their range at these
    # random, unsettled weights); each int8 route is held to its exact twin
    # in test_torch_quant.py
    assert torch.isfinite(got).all() and gap(got, want) > TOL
    res = det.serve(x, conf_thres=0.001)
    assert len(nms_to_lists(res)) == 2


def test_serve_spans_name_the_new_stages(state, tmp_path):
    det = detector(state)
    frames = torch.randint(0, 256, (1, *SIZES[0], 3), dtype=torch.uint8,
                           generator=torch.Generator().manual_seed(0))
    with profiling.trace(str(tmp_path)):
        det.serve(frames, device_preprocess=True)
    with open(os.path.join(tmp_path, profiling.TRACE_FILE)) as f:
        names = [e["name"] for e in json.load(f)["traceEvents"]
                 if e.get("cat") == "user_annotation"]
    # 8 attention blocks at this depth: 2 pairs at p4 and 2 at p5
    assert names.count("attn/area") == 8
    for stage in ("fwd/net.p4_attn", "fwd/net.p5_attn", "fwd/fpn.h1",
                  "fwd/fpn.h6", "serve/forward"):
        assert names.count(stage) == 1, stage


# --------------------------------------------------------------- the card
# (``python -m pytest --noconftest -m card tests/test_torch_yolo12.py``)

@pytest.fixture(scope="module")
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (K1 and CUDA graphs run only there)")
    return torch.device("cuda")


@pytest.mark.card
def test_card_k1_at_head_size_32(card):
    """K1 as p4's area attention calls it on a 4K frame: 4 strips of 8,160
    tokens, 12 heads, q, k and v 32 wide, against its twin strip by
    strip."""
    from custom_yolo_tpu_torch.ops.attention import (psa_attention,
                                                     psa_attention_reference)

    gen = torch.Generator().manual_seed(7)
    qkv = (torch.randn(4, 8160, 12 * 96, generator=gen) * 1.5).to(
        card, torch.bfloat16)
    out, v = psa_attention(qkv, 12, 32, 32)
    for s in range(4):
        ref_out, ref_v = psa_attention_reference(qkv[s:s + 1], 12, 32, 32)
        assert torch.equal(v[s:s + 1], ref_v)
        assert torch.allclose(out[s:s + 1].float(), ref_out.float(),
                              atol=2e-2, rtol=2e-2)


@pytest.mark.card
def test_card_yolo12_graph_equals_eager(card):
    """``serve`` of YOLO12x in bf16 at 640² (p4's 40×40 map in 4 strips):
    eager on the first call, captured on the second, replayed after,
    each result bit-equal to the eager one."""
    s = SCALES["x"]
    det = Detector(s["width"], s["depth"], s["csp"], 172,
                   input_size=(640, 640), device=card, arch="yolo12")
    det.init(0)
    det.fuse()
    frames = torch.randint(0, 256, (2, 640, 640, 3), dtype=torch.uint8,
                           generator=torch.Generator().manual_seed(3))
    opts = dict(conf_thres=0.001, device_preprocess=True)
    before = profiling.serve_graph_stats()
    results = [det.serve(frames, **opts) for _ in range(4)]
    torch.cuda.synchronize()
    after = profiling.serve_graph_stats()
    # the capturing call counts as a replay
    assert after["captures"] - before["captures"] == 1
    assert after["replays"] - before["replays"] == 3
    for res in results[1:]:
        for field in ("boxes", "scores", "classes", "num_valid"):
            assert torch.equal(getattr(res, field),
                               getattr(results[0], field)), field
