"""The port's int8 serving path against the JAX package, on the CPU.

Weights, scales, static input scales and the int8 contraction's int32
accumulators must be bit-equal to the JAX package's. Stochastic rounding is
held to JAX's through the uniforms: on the CPU the JAX function rounds with
``jax.random``, and the port's ``stochastic_round_given`` gets those same
uniforms; the port's own Philox stream is checked against the generator's
published known answers and for bias. Inputs come from numpy seeds; on the
CPU the K7 wrapper takes its plain twin. Tolerances are stated where they
are used.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from custom_yolo_tpu.models import Detector as JaxDetector
from custom_yolo_tpu.models import YoloModel as JaxYoloModel
from custom_yolo_tpu.models.detector import (fuse_params,
                                             merge_c3k_params as jax_merge)
from custom_yolo_tpu.ops import quant as jq
from custom_yolo_tpu_torch import Detector
from custom_yolo_tpu_torch.models.detector import YoloModel, merge_c3k_params
from custom_yolo_tpu_torch.core.dtypes import resolve_policy
from custom_yolo_tpu_torch.ops import quant, quant_kernel
from custom_yolo_tpu_torch.utils.weights import from_jax_variables

from test_torch_model import perturbed_variables, to_numpy_tree

torch.set_num_threads(2)

# conftest's tiny_model, and a model whose p5 C3Ks are wide enough to merge
TINY = dict(width=(3, 8, 16, 32, 64, 64), depth=(1,) * 6, csp=(False, True))
MERGE = dict(width=(3, 8, 16, 32, 128, 256), depth=(1,) * 6,
             csp=(True, True))
NC, HW = 7, 64


def oihw(hwio):
    return torch.from_numpy(np.ascontiguousarray(
        np.asarray(hwio).transpose(3, 2, 0, 1)))


def nchw(nhwc, dtype=torch.float32):
    return torch.from_numpy(np.ascontiguousarray(nhwc)).to(dtype).permute(
        0, 3, 1, 2).contiguous(memory_format=torch.channels_last)


def as_np(x):
    return np.asarray(jnp.asarray(x, jnp.float32))


def bf16_steps(got, want):
    """|got − want| in units of want's bf16 spacing."""
    spacing = 2.0 ** (np.floor(np.log2(np.maximum(np.abs(want), 1e-30))) - 7)
    return np.abs(got - want) / spacing


# --------------------------------------------------------------- weights
@pytest.mark.parametrize("shape,zero_channel", [
    ((3, 3, 16, 24), False), ((1, 1, 32, 16), False), ((3, 3, 1, 40), False),
    ((3, 3, 8, 16), True)], ids=["dense", "pointwise", "depthwise",
                                 "zero_channel"])
def test_quantize_kernel_int8_matches_jax(shape, zero_channel):
    k = np.random.RandomState(0).randn(*shape).astype(np.float32) * 0.3
    if zero_channel:
        k[..., 5] = 0.0
    q_j, s_j = jq.quantize_kernel_int8(jnp.asarray(k))
    q_t, s_t = quant.quantize_kernel_int8(oihw(k))
    assert q_t.dtype == torch.int8 and s_t.dtype == torch.float32
    np.testing.assert_array_equal(q_t.numpy(), oihw(q_j).numpy())
    np.testing.assert_array_equal(s_t.numpy(), np.asarray(s_j))
    if zero_channel:
        assert s_t[5] == 1.0 and not q_t[5].any()


@pytest.mark.parametrize("dtype,zeros", [
    ("float32", False), ("bfloat16", False), ("float32", True)],
    ids=["fp32", "bf16", "all_zero"])
def test_quantize_act_matches_jax(dtype, zeros):
    x = np.random.RandomState(1).randn(2, 9, 7, 5).astype(np.float32) * 3
    if zeros:
        x[:] = 0.0
    x_j = jnp.asarray(x, dtype)
    x_t = torch.from_numpy(x).to(getattr(torch, dtype))
    q_j, s_j = jq.quantize_act_int8(x_j)
    q_t, s_t = quant.quantize_act_int8(x_t)
    np.testing.assert_array_equal(q_t.numpy(), np.asarray(q_j))
    assert s_t.item() == float(s_j)
    if zeros:
        assert s_t.item() == 1.0
    # a calibrated scale that clips part of the tensor
    scale = np.float32(0.8) * np.float32(s_j)
    np.testing.assert_array_equal(
        quant.quantize_act_static(x_t, torch.tensor(scale)).numpy(),
        np.asarray(jq.quantize_act_static(x_j, jnp.float32(scale))))


# ------------------------------------------------------ stochastic (K7)
@pytest.mark.parametrize("shape,seed", [
    ((3, 3, 4, 8), 0), ((1, 1, 32, 16), 1), ((3, 3, 24, 16), 12345)],
    ids=["3x3-seed0", "1x1-seed1", "3x3-seed12345"])
def test_stochastic_round_given_matches_jax(shape, seed):
    """Fed jax.random's uniforms, the port's rounding is JAX's bit for bit
    (the JAX function takes its jax.random path off a TPU)."""
    k = np.random.RandomState(2).randn(*shape).astype(np.float32)
    k[..., 3] *= 1e-3                                  # a channel near 0
    q_j, s_j = jq.stochastic_quantize_int8(jnp.asarray(k), seed=seed)
    absmax = np.abs(k).max(axis=(0, 1, 2))
    scale = np.where(absmax > 0, absmax / np.float32(127.0), np.float32(1))
    flat = np.clip(k / scale, -127.0, 127.0).reshape(-1, shape[-1])
    u = np.asarray(jax.random.uniform(jax.random.key(seed), flat.shape))
    q_t = quant_kernel.stochastic_round_given(torch.from_numpy(flat),
                                              torch.from_numpy(u))
    np.testing.assert_array_equal(q_t.numpy().reshape(shape),
                                  np.asarray(q_j))
    np.testing.assert_array_equal(scale.astype(np.float32), np.asarray(s_j))
    # the port's own entry point keeps the scale and the nearest-or-next
    # rule, whatever its stream
    q_p, s_p = quant.stochastic_quantize_int8(oihw(k), seed)
    np.testing.assert_array_equal(s_p.numpy(), np.asarray(s_j))
    nearest = quant.quantize_kernel_int8(oihw(k))[0].int()
    assert (q_p.int() - nearest).abs().max() <= 1


# Philox4x32-10 known answers (Random123's kat_vectors): counter, key →
# the four output words
PHILOX_KAT = [
    ((0, 0, 0, 0), (0, 0),
     (0x6627E8D5, 0xE169C58D, 0xBC57AC4C, 0x9B00DBD8)),
    ((0xFFFFFFFF,) * 4, (0xFFFFFFFF, 0xFFFFFFFF),
     (0x408F276D, 0x41C83B0E, 0xA20BC7C6, 0x6D5451FD)),
    ((0x243F6A88, 0x85A308D3, 0x13198A2E, 0x03707344),
     (0xA4093822, 0x299F31D0),
     (0xD16CFE09, 0x94FDCCEB, 0x5001E420, 0x24126EA1)),
]


@pytest.mark.parametrize("counter,key,want", PHILOX_KAT,
                         ids=["zeros", "ones", "pi"])
def test_philox_twin_known_answers(counter, key, want):
    words = quant_kernel.philox4x32_10(
        tuple(torch.tensor([c], dtype=torch.int64) for c in counter), key)
    assert tuple(int(w) for w in words) == want


def test_philox_twin_is_seeded_and_deterministic():
    flat = torch.from_numpy(np.random.RandomState(3).uniform(
        -127, 127, (288, 40)).astype(np.float32))
    a = quant_kernel.stochastic_round_reference(flat, 7)
    assert torch.equal(a, quant_kernel.stochastic_round_reference(flat, 7))
    assert torch.equal(a, quant_kernel.stochastic_round(flat, 7))
    b = quant_kernel.stochastic_round_reference(flat, 8)
    assert (a != b).float().mean() > 0.3                # fractions ~U[0,1)
    assert ((a.int() - torch.floor(flat).int()).abs() <= 1).all()
    u = quant_kernel.philox_uniforms(1 << 16, 2 ** 40 + 5)
    assert 0.0 <= u.min() and u.max() < 1.0
    assert abs(u.mean().item() - 0.5) < 0.01             # 1/sqrt(12n)≈0.0011
    # 127 + u reaches 128 in fp32 for u close to 1: the clip holds ±127
    edge = torch.full((4,), 127.0)
    assert quant_kernel.stochastic_round_given(
        edge, torch.full((4,), 1 - 2.0 ** -24)).max() == 127
    assert quant_kernel.stochastic_round_many.launches == 0


def test_stochastic_twin_is_unbiased():
    """E[q·scale] ≈ k over 64 seeds: the JAX test's bound of 0.45·scale."""
    k = (np.random.RandomState(1).rand(1, 1, 4, 8) * 0.1).astype(np.float32)
    acc = 0.0
    for seed in range(64):
        q, s = quant.stochastic_quantize_int8(oihw(k), seed)
        acc = acc + q.float().numpy() * s.numpy()[:, None, None, None]
    mean = acc / 64
    scale = np.abs(k).max(axis=(0, 1, 2)) / 127.0
    assert np.abs(mean - oihw(k).numpy()).max() < scale.max() * 0.45


def test_stochastic_round_refuses_off_the_cpu():
    with pytest.raises(ValueError, match="unsupported device"):
        quant_kernel.stochastic_round(torch.empty(4, 4, device="meta"), 0)
    with pytest.raises(ValueError, match="64-bit"):
        quant_kernel.stochastic_round(torch.zeros(4, 4), -1)
    assert quant_kernel.stochastic_round_many.launches == 0


def test_grouped_twin_equals_the_twin_of_each_leaf():
    """``stochastic_round_many`` on the CPU: each leaf, whatever its size
    or its neighbours, draws at its own flat indices, so it equals the
    twin of that leaf alone bit for bit."""
    rng = np.random.RandomState(11)
    flats = [torch.from_numpy(rng.uniform(-127, 127, shape).astype(
        np.float32)) for shape in ((1,), (3,), (0, 5), (1023,), (1025,),
                                   (27, 37), (288, 40))]
    for seed in (0, 2 ** 40 + 7):
        got = quant_kernel.stochastic_round_many(flats, seed)
        assert len(got) == len(flats)
        for flat, q in zip(flats, got):
            assert q.shape == flat.shape and q.dtype == torch.int8
            assert torch.equal(q, quant_kernel.stochastic_round_reference(
                flat, seed))
            assert torch.equal(q, quant_kernel.stochastic_round(flat, seed))
    assert quant_kernel.stochastic_round_many.launches == 0


def test_quantize_fused_params_rounds_every_leaf_as_alone():
    """The stochastic state of a whole model, rounded in one group, holds
    for each leaf what ``stochastic_quantize_int8`` gives it alone, in the
    same key order as round to nearest."""
    det = port_detector()
    det.init(seed=2)
    det.fuse()
    state = det._state
    grouped = quant.quantize_fused_params(state, stochastic=True,
                                          skip=quant.DEFAULT_QUANT_SKIP)
    nearest = quant.quantize_fused_params(state,
                                          skip=quant.DEFAULT_QUANT_SKIP)
    assert list(grouped) == list(nearest)
    n = 0
    for prefix in quant.quant_prefixes(grouped):
        q, s = quant.stochastic_quantize_int8(state[f"{prefix}.weight"])
        assert torch.equal(grouped[f"{prefix}.weight"], q)
        assert torch.equal(grouped[f"{prefix}.scale"], s)
        n += 1
    assert n > 10
    assert quant_kernel.stochastic_round_many.launches == 0


# ----------------------------------------------------------- contraction
# kind → (input NHWC shape, kernel HWIO shape, stride, JAX padding pairs,
# groups). The port pads symmetrically; the space-to-depth stem's one row
# and column on top and left are padded before the conv, as its Backbone
# does.
CONVS = {
    "1x1": ((2, 6, 5, 24), (1, 1, 24, 12), 1, ((0, 0), (0, 0)), 1),
    "3x3s1": ((2, 7, 6, 10), (3, 3, 10, 16), 1, ((1, 1), (1, 1)), 1),
    "3x3s2": ((2, 9, 8, 12), (3, 3, 12, 20), 2, ((1, 1), (1, 1)), 1),
    "depthwise": ((2, 7, 5, 16), (3, 3, 1, 16), 1, ((1, 1), (1, 1)), 16),
    "s2d_stem": ((2, 8, 8, 12), (2, 2, 12, 8), 1, ((1, 0), (1, 0)), 1),
}
ROUTES = {"int_mm": quant.int8_contract,
          "float64": quant.int8_contract_reference}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("kind", list(CONVS))
@pytest.mark.parametrize("route", list(ROUTES))
def test_int8_conv_matches_jax(route, kind, dtype):
    """Dynamic and static int8 convs. The int32 accumulators are exact. In
    fp32 an output may differ by one ulp of the product ``acc·scale`` (XLA
    on the CPU fuses ``acc·scale + bias`` into one FMA, measured; the port
    rounds the product first, as the JAX source writes it) plus two ulps of
    the result (each framework's SiLU rounds on its own); in bf16 by one
    bf16 step, the cast of values that differ so."""
    xs, ks, stride, pad, groups = CONVS[kind]
    rng = np.random.RandomState(4)
    x = rng.randn(*xs).astype(np.float32)
    k = rng.randn(*ks).astype(np.float32) * 0.2
    bias = rng.randn(ks[-1]).astype(np.float32) * 0.1
    x_j, x_t = jnp.asarray(x, dtype), nchw(x, getattr(torch, dtype))
    (top, bottom), (left, right) = pad
    if top != bottom:
        x_t = torch.nn.functional.pad(x_t, (left, right, top, bottom))
        port_pad = 0
    else:
        port_pad = top
    qk_j, s_j = jq.quantize_kernel_int8(jnp.asarray(k))
    qk_t, s_t = oihw(qk_j), torch.from_numpy(np.asarray(s_j))
    b_j, b_t = jnp.asarray(bias), torch.from_numpy(bias)
    kw = dict(stride=stride, padding=port_pad, groups=groups,
              contract=ROUTES[route])
    jkw = dict(strides=(stride, stride), padding=pad, groups=groups)

    _, dyn_scale = jq.quantize_act_int8(x_j)
    in_scale = np.float32(0.9) * np.float32(dyn_scale)   # clips a few
    for mode, ascale, act in (("dynamic", dyn_scale, False),
                              ("static", jnp.float32(in_scale), True)):
        qx_j = jq.quantize_act_static(x_j, ascale)
        qx_t = quant.quantize_act_static(x_t, torch.tensor(float(ascale)))
        acc_j = np.asarray(jax.lax.conv_general_dilated(
            qx_j, qk_j, (stride, stride), pad,
            dimension_numbers=("NHWC", "HWIO", "NHWC"),
            feature_group_count=groups, preferred_element_type=jnp.int32))
        acc_t = kw["contract"](qx_t, qk_t, stride, port_pad, groups)
        assert acc_t.dtype == torch.int32
        np.testing.assert_array_equal(acc_t.numpy(), acc_j)
        if mode == "dynamic":
            got = quant.int8_conv(x_t, qk_t, s_t, b_t, act=act, **kw)
            want = jq.int8_conv(x_j, qk_j, s_j, b_j, act=act, **jkw)
        else:
            got = quant.int8_conv_static(x_t, qk_t, s_t, b_t,
                                         torch.tensor(in_scale), act=act,
                                         **kw)
            want = jq.int8_conv_static(x_j, qk_j, s_j, b_j, ascale,
                                       act=act, **jkw)
        assert got.dtype == x_t.dtype
        got = got.float().permute(0, 2, 3, 1).numpy()
        want = as_np(want)
        assert got.shape == want.shape
        if dtype == "float32":
            prod = acc_j.astype(np.float32) * (np.float32(ascale)
                                               * np.asarray(s_j))
            tol = np.spacing(np.abs(prod)) + 2 * np.spacing(np.abs(want))
            assert (np.abs(got - want) <= tol).all(), mode
        else:
            assert bf16_steps(got, want).max() <= 1.0, mode


def test_int8_contract_refuses_grouped_convs():
    # a grouping that does not divide the channels is refused; one that
    # does is a dense product a group, exact (YOLO12's strided 2- and
    # 4-group convs)
    qx = torch.zeros(1, 8, 4, 4, dtype=torch.int8)
    with pytest.raises(ValueError, match="groups=3"):
        quant.int8_contract(qx, torch.zeros(6, 2, 3, 3, dtype=torch.int8),
                            padding=1, groups=3)
    g = torch.Generator().manual_seed(5)
    for groups, stride in ((2, 2), (4, 2), (4, 1)):
        qx = torch.randint(-127, 128, (2, 16, 9, 7), generator=g,
                           dtype=torch.int8)
        qw = torch.randint(-127, 128, (24, 16 // groups, 3, 3), generator=g,
                           dtype=torch.int8)
        got = quant.int8_contract(qx, qw, stride, 1, groups)
        want = quant.int8_contract_reference(qx, qw, stride, 1, groups)
        assert torch.equal(got, want), (groups, stride)


# ------------------------------------------------------ trees and models
def jax_variables(cfg, seed):
    """Unfused JAX variables for ``cfg`` from a numpy seed: the tree's shapes
    from ``jax.eval_shape`` of the flax init (whose op-by-op run takes over
    a minute here), LeCun-normal kernels, perturbed BatchNorm."""
    model = JaxYoloModel(width=cfg["width"], depth=cfg["depth"],
                         csp=cfg["csp"], num_classes=NC)
    shapes = jax.eval_shape(lambda: model.init(
        jax.random.key(0), jnp.zeros((1, HW, HW, 3)), train=False))
    rng = np.random.RandomState(seed)

    def fill(node):
        out = {}
        for key, value in node.items():
            if hasattr(value, "items"):
                out[key] = fill(value)
            elif key == "kernel":
                fan_in = int(np.prod(value.shape[:-1]))
                out[key] = (rng.randn(*value.shape)
                            / np.sqrt(fan_in)).astype(np.float32)
            else:
                out[key] = np.zeros(value.shape, np.float32)
        return out

    return perturbed_variables(fill(shapes), seed)


@pytest.fixture(scope="module")
def jax_tiny():
    """The tiny model of conftest's ``tiny_model`` as a fused JAX Detector,
    with its fused fp32 tree."""
    det = JaxDetector(TINY["width"], TINY["depth"], TINY["csp"], NC,
                      precision="float32", input_size=(HW, HW))
    det.load_variables(jax_variables(TINY, 0))
    det.fuse()
    return det, to_numpy_tree(jax.device_get(det.variables))


def port_model(cfg, quantized=False, quant_skip=()):
    return YoloModel(cfg["width"], cfg["depth"], cfg["csp"], NC,
                     policy=resolve_policy("float32"), fused=True,
                     quantized=quantized, quant_skip=quant_skip)


def assert_states_equal(got, want):
    assert set(got) == set(want)
    for key, value in want.items():
        assert got[key].dtype == value.dtype, key
        assert torch.equal(got[key], value), key


@pytest.mark.parametrize("skip", ["auto", ()], ids=["auto", "none"])
def test_quantize_fused_params_matches_jax(jax_tiny, jax_quantized, skip):
    _, fused = jax_tiny
    if skip == "auto":       # the JAX Detector's quantize() of that tree
        skip, tree = jq.DEFAULT_QUANT_SKIP, jax_quantized["trees"]["dynamic"]
    else:
        tree = {"params": to_numpy_tree(jq.quantize_fused_params(
            fused["params"], skip=skip))}
    state = from_jax_variables(fused, port_model(TINY))
    got = quant.quantize_fused_params(state, skip=skip)
    want = from_jax_variables(tree, port_model(TINY, True, skip))
    assert_states_equal(got, want)
    n_int8 = sum(v.dtype == torch.int8 for v in got.values())
    assert n_int8 == len(quant.quant_prefixes(got)) > 0
    assert all(got[k].dtype == torch.float32 for k in got
               if k.startswith("head.") and "_out." in k)


@pytest.fixture(scope="module")
def jax_quantized(jax_tiny):
    """The JAX tiny detector quantized (skip "auto"), its dynamic tree, its
    output on a calibration batch, then calibrated on that batch."""
    det, _ = jax_tiny
    rng = np.random.RandomState(7)
    cal = rng.randn(2, HW, HW, 3).astype(np.float32)
    unseen = rng.randn(2, HW, HW, 3).astype(np.float32)
    qdet = JaxDetector(TINY["width"], TINY["depth"], TINY["csp"], NC,
                       precision="float32", input_size=(HW, HW))
    qdet.load_variables(det.variables)
    qdet.quantize()
    trees, outputs = {}, {}
    trees["dynamic"] = to_numpy_tree(jax.device_get(qdet.variables))
    outputs["dynamic"] = np.asarray(qdet(jnp.asarray(unseen))[0])
    dyn_cal = np.asarray(qdet(jnp.asarray(cal))[0])
    # the statistics as Detector.calibrate takes them, under jit
    stats = jax.jit(lambda v, x: qdet.module.apply(
        v, x, train=False, mutable=["quant_stats"])[1])(
        qdet.variables, jnp.asarray(cal))
    qdet.calibrate([jnp.asarray(cal)])
    trees["static"] = to_numpy_tree(jax.device_get(qdet.variables))
    outputs["static"] = np.asarray(qdet(jnp.asarray(unseen))[0])
    return dict(trees=trees, outputs=outputs, cal=cal, unseen=unseen,
                dyn_cal=dyn_cal,
                stats=to_numpy_tree(jax.device_get(stats["quant_stats"])))


def flat_stats(tree, path=""):
    """JAX ``quant_stats`` → {conv prefix: in_absmax tensor}."""
    out = {}
    for key, value in tree.items():
        if key == "in_absmax":
            out[path[:-1]] = torch.tensor(np.max(value))
        else:
            out.update(flat_stats(value, f"{path}{key}."))
    return out


def port_detector(cfg=TINY):
    return Detector(cfg["width"], cfg["depth"], cfg["csp"], NC,
                    precision="float32", input_size=(HW, HW), device="cpu")


# Whole quantized forwards, fp32. Every int32 accumulator is exact, but XLA
# on the CPU fuses each dequantization into an FMA where the port rounds the
# product first, so an activation may differ by an ulp; where one lands on a
# rounding boundary of the next conv's quantization, one int8 step flips and
# travels on through every later layer. Measured: 3e-7 of the largest
# prediction where nothing flips, 1.3e-2 (1.6 int8 steps) where one did,
# correlation 0.99998. Limits: four int8 steps of the largest prediction,
# correlation 0.9999.
FORWARD_STEPS = 4


def assert_forward_close(got, want):
    top = np.abs(want).max()
    err = np.abs(got - want).max()
    assert err <= FORWARD_STEPS / 127 * top, (err, top)
    assert np.corrcoef(got.ravel(), want.ravel())[0, 1] >= 0.9999


@pytest.mark.parametrize("mode", ["dynamic", "static"])
def test_jax_quantized_tree_forward_matches(jax_quantized, mode):
    det = port_detector()
    det.load_variables(jax_quantized["trees"][mode])
    assert det._quantized and det._quant_skip == jq.DEFAULT_QUANT_SKIP
    state = det._state
    assert all(state[f"{p}.weight"].dtype == torch.int8
               and state[f"{p}.scale"].dtype == torch.float32
               and state[f"{p}.bias"].dtype == torch.float32
               for p in quant.quant_prefixes(state))
    assert quant.has_static_scales(state) == (mode == "static")
    got = det(jax_quantized["unseen"])[0].numpy()
    assert_forward_close(got, jax_quantized["outputs"][mode])


def test_calibrate_matches_jax(jax_quantized):
    det = port_detector()
    det.load_variables(jax_quantized["trees"]["dynamic"])
    dynamic_state = det._state
    cal = jax_quantized["cal"]
    dyn = det(cal)[0]
    assert_forward_close(dyn.numpy(), jax_quantized["dyn_cal"])
    det.calibrate([cal])
    want = {k: v for k, v in from_jax_variables(
        {"params": jax_quantized["trees"]["static"]["params"]},
        port_model(TINY, True, jq.DEFAULT_QUANT_SKIP)).items()
        if k.endswith(".in_scale")}
    assert want and set(want) == {k for k in det._state
                                  if k.endswith(".in_scale")}
    # from JAX's own statistics, the port bakes JAX's scales bit for bit
    baked = quant.bake_static_scales(dynamic_state,
                                     flat_stats(jax_quantized["stats"]))
    for key, value in want.items():
        assert torch.equal(baked[key], value), key
    # from its own forward, within what the int8 flips of FORWARD_STEPS'
    # note move an activation's absmax: a few int8 steps
    for key, value in want.items():
        torch.testing.assert_close(det._state[key], value, rtol=3e-2,
                                   atol=0)
    assert torch.equal(det(cal)[0], dyn)            # static == dynamic
    with pytest.raises(AssertionError, match="already calibrated"):
        det.calibrate([cal])


def test_merge_c3k_on_quantized_state_matches_jax():
    """A static int8 tree (calibration statistics drawn from a seed, so
    that conv1 and conv2 of a C3K get different input scales) merges as
    the JAX package merges it."""
    params = jq.quantize_fused_params(
        fuse_params(jax_variables(MERGE, 1))["params"])
    rng = np.random.RandomState(8)

    def stats(node):
        return {key: ({"in_absmax": np.float32(rng.uniform(0.5, 4.0))}
                      if jq._is_quant_leaf(value) else stats(value))
                for key, value in node.items() if isinstance(value, dict)}

    params = to_numpy_tree(jq.bake_static_scales(params, stats(params)))
    state = from_jax_variables({"params": params}, port_model(MERGE, True))
    merged = merge_c3k_params(state)
    assert any(".conv12.conv.in_scale" in k for k in merged)
    want = from_jax_variables(
        {"params": to_numpy_tree(jax_merge(params))},
        YoloModel(MERGE["width"], MERGE["depth"], MERGE["csp"], NC,
                  policy=resolve_policy("float32"), fused=True, merged=True,
                  quantized=True))
    assert_states_equal(merged, want)


@pytest.mark.parametrize("first", ["quantize", "optimize"])
def test_optimize_for_serving_composes_with_quantize(jax_tiny, first):
    """quantize ↔ optimize_for_serving in either order gives the state of
    the JAX fuse → optimize_for_tpu → quantize, bit for bit."""
    jdet, fused = jax_tiny
    ref = JaxDetector(TINY["width"], TINY["depth"], TINY["csp"], NC,
                      precision="float32", input_size=(HW, HW))
    ref.load_variables(jdet.variables)
    ref.optimize_for_tpu().quantize(skip=())
    det = port_detector()
    det.load_variables(fused)
    if first == "quantize":
        det.quantize(skip=()).optimize_for_serving()
    else:
        det.optimize_for_serving().quantize(skip=())
    model = YoloModel(TINY["width"], TINY["depth"], TINY["csp"], NC,
                      policy=resolve_policy("float32"), fused=True,
                      s2d_stem=True, quantized=True)
    want = from_jax_variables(
        {"params": to_numpy_tree(jax.device_get(ref.variables["params"]))},
        model)
    assert_states_equal(det._state, want)
    x = np.random.RandomState(9).randn(1, HW, HW, 3).astype(np.float32)
    assert_forward_close(det(x)[0].numpy(), np.asarray(ref(jnp.asarray(x))[0]))


@pytest.mark.parametrize("stochastic", [False, True],
                         ids=["nearest", "stochastic"])
def test_detector_quantize_serves_on_cpu(stochastic):
    det = port_detector()
    det.init(seed=0)
    x = np.random.RandomState(6).rand(2, HW, HW, 3).astype(np.float32)
    det.fuse()
    ref = det(x)[0].numpy().ravel()
    det.quantize(stochastic=stochastic)
    assert det._quantized and det._fused
    res = det.serve(x, conf_thres=0.0, max_det=10)
    assert res.boxes.shape == (2, 10, 4)
    assert torch.isfinite(res.scores).all()
    got = det(x)[0].numpy().ravel()
    assert np.corrcoef(ref, got)[0, 1] > 0.99
    assert quant_kernel.stochastic_round_many.launches == 0


@pytest.mark.parametrize("calibrated", [False, True],
                         ids=["dynamic", "static"])
def test_quantized_state_round_trips_through_load_variables(calibrated):
    det = port_detector()
    det.init(seed=1)
    x = np.random.RandomState(10).randn(2, HW, HW, 3).astype(np.float32)
    det.quantize(skip=("p1_conv", "p5_psa"))
    if calibrated:
        det.calibrate([x])
    again = port_detector()
    again.load_variables(det._state)
    assert again._quant_skip == ("p1_conv", "p5_psa")
    assert torch.equal(again(x)[0], det(x)[0])
    fresh = port_detector()
    fresh.init(seed=0)
    with pytest.raises(AssertionError, match="quantize"):
        fresh.calibrate([x])
