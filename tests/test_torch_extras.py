"""The port's exact-transform serving path against the JAX package, on the
CPU: the twins of the SPPF-pyramid, cls-tower and single-image NMS kernels
against the Pallas kernels in interpret mode, the space-to-depth stem and
merged C3K transforms, and a small model through ``fuse`` and
``optimize_for_serving`` in both orders against the JAX
``fuse().optimize_for_tpu()``.

Inputs come from numpy seeds. On the CPU each kernel wrapper takes its
plain twin. Tolerances are stated where they are used.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from custom_yolo_tpu.core.dtypes import resolve_policy as jax_resolve_policy
from custom_yolo_tpu.models import Detector as JaxDetector
from custom_yolo_tpu.models.backbone import (
    space_to_depth as jax_space_to_depth,
    stem_kernel_to_s2d as jax_stem_kernel_to_s2d)
from custom_yolo_tpu.models.detector import fuse_params
from custom_yolo_tpu.models.head import Head as JaxHead
from custom_yolo_tpu.ops.nms import nms_to_lists as jax_nms_to_lists
from custom_yolo_tpu.ops.pallas.head_kernel import (
    cls_tower_pallas, cls_tower_reference as jax_cls_tower_reference)
from custom_yolo_tpu.ops.pallas.nms_kernel import nms_keep_pallas
from custom_yolo_tpu.ops.pallas.sppf_kernel import sppf_pyramid_pallas
from custom_yolo_tpu_torch import Detector
from custom_yolo_tpu_torch.models import head as head_module
from custom_yolo_tpu_torch.models.backbone import (space_to_depth,
                                                   stem_kernel_to_s2d)
from custom_yolo_tpu_torch.models.detector import (convert_stem_variables,
                                                   merge_c3k_params)
from custom_yolo_tpu_torch.models.head import Head
from custom_yolo_tpu_torch.nn.blocks import MERGE_MIN_HALF, SPPF
from custom_yolo_tpu_torch.ops import head_kernel, nms_kernel, sppf_kernel
from custom_yolo_tpu_torch.ops.nms import nms_to_lists
from custom_yolo_tpu_torch.utils.weights import from_jax_variables

from test_torch_model import (CSP, DEPTH, HW, NC, WIDTH, perturbed_variables,
                              to_numpy_tree)
from test_torch_ops import _nms_pool
from test_torch_serve import _assert_detections_equal

torch.set_num_threads(2)

TOL = dict(atol=1e-4, rtol=1e-4)      # fp32: the frameworks sum in other orders


def nchw(array, dtype=torch.float32):
    """A numpy NHWC array as the port's NCHW tensor in channels_last
    memory."""
    return torch.from_numpy(np.ascontiguousarray(array)).to(dtype).permute(
        0, 3, 1, 2)


def nhwc(tensor):
    return tensor.permute(0, 2, 3, 1).float().numpy()


# ------------------------------------------------------------ SPPF (K5)
@pytest.mark.parametrize("shape,dtype,special", [
    ((2, 20, 20, 24), "float32", None),
    ((2, 20, 20, 24), "bfloat16", None),
    ((3, 13, 7, 10), "float32", None),           # ragged, smaller than 5 wide
    ((2, 9, 11, 8), "bfloat16", "inf"),          # ±inf entries
    ((2, 62, 62, 8), "float32", "inf"),          # past the old fp32 limit
    ((2, 12, 11, 3), "float32", "zeros"),        # zeros of both signs
    ((2, 12, 11, 3), "bfloat16", "zeros"),
], ids=["fp32", "bf16", "ragged", "inf", "62x62", "zeros-fp32",
        "zeros-bf16"])
def test_sppf_twin_matches_jax_kernel_bit_for_bit(shape, dtype, special):
    """Every output's bits. Where a window's maximum is a zero and the
    window holds zeros of both signs, the JAX kernel (``jnp.maximum``)
    gives +0 whatever their order, and so does the twin."""
    rng = np.random.RandomState(4)
    x = rng.randn(*shape).astype(np.float32)
    if special == "inf":
        x[0, 2, 3, 1] = np.inf
        x[1, 0, 0, 5] = -np.inf
        x[1, 4:9, 5:10, 2] = -np.inf               # a whole window of −inf
    if special == "zeros":
        x = -np.abs(x)
        zeros = rng.rand(*shape) < 0.15
        x[zeros] = np.where(rng.rand(int(zeros.sum())) < 0.5, 0.0, -0.0)
        x[0, :, :, 0] = np.where(rng.rand(*shape[1:3]) < 0.5, 0.0, -0.0)
    x_j = jnp.asarray(x, dtype)
    x_t = nchw(x, getattr(torch, dtype))
    assert x_t.is_contiguous(memory_format=torch.channels_last)
    got = sppf_kernel.sppf_pyramid(x_t)
    assert got.dtype == x_t.dtype and got.shape == (
        shape[0], 4 * shape[3], shape[1], shape[2])
    want = np.asarray(sppf_pyramid_pallas(x_j, interpret=True), np.float32)
    if special == "zeros":
        assert (want == 0).sum() > 100 and np.signbit(want[want == 0]).any()
    np.testing.assert_array_equal(nhwc(got).view(np.int32),
                                  want.view(np.int32))    # tolerance: none
    assert sppf_kernel.sppf_pyramid.launches == 0


def test_sppf_propagates_nan_like_the_jax_kernel():
    x = np.random.RandomState(5).randn(1, 8, 8, 4).astype(np.float32)
    x[0, 3, 4, 1] = np.nan
    got = nhwc(sppf_kernel.sppf_pyramid(nchw(x)))
    want = np.asarray(sppf_pyramid_pallas(jnp.asarray(x), interpret=True))
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    np.testing.assert_array_equal(np.nan_to_num(got), np.nan_to_num(want))
    # the third pool reaches 6 pixels each way
    assert np.isnan(got[0, :, :, 3 * 4 + 1]).sum() == 64


def test_sppf_module_routes_by_device_and_gradient(monkeypatch):
    """A training forward keeps the ``max_pool2d`` chain, which autograd
    differentiates; a forward without gradient takes the registered op on
    any device (its twin on the CPU), so that an exported graph holds
    it."""
    calls = []
    monkeypatch.setattr("custom_yolo_tpu_torch.nn.blocks.sppf_pyramid",
                        lambda x: calls.append(x)
                        or sppf_kernel.sppf_pyramid(x))
    block = SPPF(8, 8)
    x = torch.from_numpy(
        np.random.RandomState(6).randn(2, 8, 6, 6).astype(np.float32))
    block(x).sum().backward()
    assert block.cv1.conv.weight.grad.abs().max() > 0
    assert calls == []
    with torch.no_grad():
        block.eval()(x)
    assert len(calls) == 1
    assert calls[0].is_contiguous(memory_format=torch.channels_last)


def test_sppf_module_builds_only_the_kernels_window():
    """No route of the module pools another window than the kernel's."""
    with pytest.raises(ValueError, match="5×5"):
        SPPF(8, 8, k=3)


# ------------------------------------------------------- cls tower (K6)
def _tower_params(cin, mid, nc, seed):
    rng = np.random.RandomState(seed)
    mk = lambda *s: rng.randn(*s).astype(np.float32) * 0.1
    return ((mk(3, 3, cin), mk(cin)), (mk(cin, mid), mk(mid)),
            (mk(3, 3, mid), mk(mid)), (mk(mid, mid), mk(mid)),
            (mk(mid, nc), mk(nc)))


@pytest.mark.parametrize("cin,mid,nc,hw,dtype", [
    (128, 128, 17, 8, "float32"),
    (384, 384, 172, 16, "bfloat16"),     # the x preset's level-0 widths
], ids=["fp32", "bf16"])
def test_cls_tower_twin_matches_jax_kernel_and_reference(cin, mid, nc, hw,
                                                         dtype):
    params = _tower_params(cin, mid, nc, seed=2)
    x = np.random.RandomState(3).randn(2, hw, hw, cin).astype(np.float32)
    t_dtype = getattr(torch, dtype)
    params_t = [tuple(torch.from_numpy(a).to(t_dtype) for a in pair)
                for pair in params]
    params_j = [tuple(jnp.asarray(a, dtype) for a in pair)
                for pair in params]
    got = head_kernel.cls_tower(nchw(x, t_dtype), *params_t)
    assert got.dtype == t_dtype and got.shape == (2, nc, hw, hw)
    got = nhwc(got)
    x_j = jnp.asarray(x, dtype)
    for want in (cls_tower_pallas(x_j, *params_j, interpret=True),
                 jax_cls_tower_reference(x_j, *params_j)):
        want = np.asarray(want, np.float32)
        if dtype == "float32":
            np.testing.assert_allclose(got, want, **TOL)
        else:
            # bf16: the three versions round intermediates at other
            # places; within 3e-2 of the largest logit, the limit the JAX
            # kernel is held to against its own reference
            assert np.abs(got - want).max() < 3e-2 * np.abs(want).max()
    assert head_kernel.cls_tower.launches == 0


@pytest.fixture(scope="module")
def head_pair():
    """A fused JAX head at filters (128, 128, 256) with folded, perturbed
    BatchNorms, and its weights carried into the port's."""
    filters, nc = (128, 128, 256), 11
    policy = jax_resolve_policy("float32")
    rng = np.random.RandomState(8)
    feats = [rng.randn(2, s, s, c).astype(np.float32)
             for s, c in zip((8, 4, 2), filters)]
    unfused = JaxHead(nc, filters, policy=policy)
    variables = unfused.init(jax.random.key(0),
                             [jnp.asarray(f) for f in feats], train=False)
    fused_vars = to_numpy_tree(fuse_params(perturbed_variables(
        to_numpy_tree(jax.device_get(variables)), seed=9)))
    jax_head = JaxHead(nc, filters, policy=policy, fused=True)
    want = jax_head.apply(fused_vars, [jnp.asarray(f) for f in feats],
                          train=False)
    head = Head(nc, filters, fused=True).eval()
    head.load_state_dict(from_jax_variables(fused_vars, head), strict=True)
    return head, feats, want


def test_head_with_fused_cls_tower_matches_chain_and_jax(head_pair,
                                                         monkeypatch):
    head, feats, want = head_pair
    feats_t = [nchw(f) for f in feats]
    calls = []
    real = head_module.cls_tower
    monkeypatch.setattr(head_module, "cls_tower",
                        lambda *a: calls.append(a[0].shape[1]) or real(*a))
    with torch.no_grad():
        chain = head(feats_t)
        assert calls == []
        head.fused_cls_tower = True
        try:
            fused = head(feats_t)
            assert calls == [128, 128, 256]       # every level qualifies
            # a forward that records a gradient keeps the chain, and so
            # does training mode
            with torch.enable_grad():
                head([f.clone().requires_grad_() for f in feats_t])
            head.train()
            head(feats_t)
            head.eval()
            assert len(calls) == 3
        finally:
            head.fused_cls_tower = False
    np.testing.assert_allclose(fused[0].numpy(), chain[0].numpy(), **TOL)
    np.testing.assert_allclose(fused[0].numpy(), np.asarray(want[0]), **TOL)
    np.testing.assert_array_equal(fused[1].numpy(), np.asarray(want[1]))


def test_head_gate_and_weight_packs(head_pair):
    """Levels whose channels are not whole groups of 128 keep the chain;
    the weights are packed when the tower is switched on."""
    head, feats, _ = head_pair
    narrow = Head(7, (32, 64, 128), fused=True).eval()
    assert narrow.cls_ch == 80                     # not a multiple of 128
    narrow.fused_cls_tower = True
    with torch.no_grad():
        narrow([torch.zeros(1, c, s, s) for s, c in
                zip((8, 4, 2), (32, 64, 128))])
    assert narrow._cls_packs == [None, None, None]
    head.fused_cls_tower = True
    try:
        packs = head._cls_packs[0]
        assert packs[0][0].shape == (3, 3, 128)
        assert packs[1][0].shape == (128, 128)
        assert packs[4][0].shape == (128, 11)
        np.testing.assert_array_equal(
            packs[1][0].numpy(),
            head.cls0_pw1.conv.weight.detach()[:, :, 0, 0].T.numpy())
        # packed once when switched on; a later change of the weights is
        # taken up by pack_cls_tower()
        with torch.no_grad():
            head.cls0_out.bias.add_(1.0)
        assert head._cls_packs[0] is packs
        assert not torch.equal(packs[4][1], head.cls0_out.bias)
        head.pack_cls_tower()
        assert torch.equal(head._cls_packs[0][4][1], head.cls0_out.bias)
    finally:
        with torch.no_grad():
            head.cls0_out.bias.sub_(1.0)
        head.fused_cls_tower = False


# ------------------------------------------------- single-image NMS (K3)
@pytest.mark.parametrize("k", [128, 256, 200])
def test_single_image_nms_matches_jax_kernel_exactly(k):
    thres = 0.45
    boxes, valid = _nms_pool(2, k, seed=k, thres=thres)
    boxes, valid = boxes[:1], valid[:1]            # the second is all invalid
    got = nms_kernel.nms_keep(torch.from_numpy(boxes),
                              torch.from_numpy(valid), thres).numpy()
    want = np.asarray(nms_keep_pallas(jnp.asarray(boxes), jnp.asarray(valid),
                                      thres, interpret=True))
    np.testing.assert_array_equal(got, want)               # tolerance: none
    # boundary pairs: only the challenger one ulp above is suppressed
    for slot in range(6):
        if valid[0, 2 * slot] and valid[0, 2 * slot + 1]:
            assert got[0, 2 * slot] and got[0, 2 * slot + 1] == (slot % 3 != 2)
    if k % 64:      # box 60 clears its copies, 64-67 in the next word too
        assert got[0, 60] and not got[0, 61:68].any()
    assert nms_kernel.nms_keep_single.launches == 0


def test_nms_keep_routes_one_image_to_the_single_kernel(monkeypatch):
    seen = []
    monkeypatch.setattr(nms_kernel, "nms_keep_single",
                        lambda b, v, t: seen.append("single") or v)
    monkeypatch.setattr(nms_kernel, "nms_keep_batched",
                        lambda b, v, t: seen.append("batched") or v)
    for n in (1, 2, 8):
        nms_kernel.nms_keep(torch.zeros(n, 4, 4),
                            torch.ones(n, 4, dtype=torch.bool), 0.45)
    assert seen == ["single", "batched", "batched"]


def test_cls_tower_pads_bf16_logits_kernel_to_16_byte_rows():
    """The bf16 kernel copies the logits' weights 16 bytes a row at a time;
    the wrapper pads their columns with zeros to a multiple of 8 (172
    classes → 176) and passes a kernel that already has them as it is."""
    kernel = torch.randn(16, 172).to(torch.bfloat16)
    padded = head_kernel._padded(kernel)
    assert padded.shape == (16, 176) and padded.is_contiguous()
    assert torch.equal(padded[:, :172], kernel)
    assert not padded[:, 172:].any()
    whole = torch.randn(16, 24).to(torch.bfloat16)
    assert head_kernel._padded(whole) is whole


def test_new_wrappers_refuse_instead_of_falling_back():
    """Off the CPU a wrapper launches its kernel or raises; no CUDA device
    is here, so every non-CPU tensor is refused and nothing launches."""
    x = torch.empty(1, 128, 4, 4, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        sppf_kernel.sppf_pyramid(x)
    pair = (torch.empty(1), torch.empty(1))
    with pytest.raises(ValueError, match="unsupported device"):
        head_kernel.cls_tower(x, pair, pair, pair, pair, pair)
    boxes = torch.empty(1, 8, 4, device="meta")
    valid = torch.empty(1, 8, dtype=torch.bool, device="meta")
    with pytest.raises(ValueError, match="CUDA device"):
        nms_kernel.nms_keep_single(boxes, valid, 0.45)
    assert sppf_kernel.sppf_pyramid.launches == 0
    assert head_kernel.cls_tower.launches == 0
    assert nms_kernel.nms_keep_single.launches == 0


# ------------------------------------------------ space-to-depth stem
def test_space_to_depth_matches_jax():
    x = np.random.RandomState(1).randn(2, 8, 12, 3).astype(np.float32)
    got = nhwc(space_to_depth(nchw(x), 2))
    np.testing.assert_array_equal(got, np.asarray(
        jax_space_to_depth(jnp.asarray(x), 2)))


def test_stem_kernel_to_s2d_matches_jax_and_the_plain_stem():
    rng = np.random.RandomState(2)
    kernel = rng.randn(3, 3, 3, 8).astype(np.float32)
    got = stem_kernel_to_s2d(kernel)
    np.testing.assert_array_equal(got, np.asarray(
        jax_stem_kernel_to_s2d(jnp.asarray(kernel))))
    # the converted stem gives the 3×3 stride-2 stem's output (fp32 sums in
    # another order: 1e-5)
    x = nchw(rng.randn(2, 16, 16, 3).astype(np.float32))
    oihw = torch.from_numpy(kernel).permute(3, 2, 0, 1)
    want = torch.nn.functional.conv2d(x, oihw, stride=2, padding=1)
    z = torch.nn.functional.pad(space_to_depth(x, 2), (1, 0, 1, 0))
    out = torch.nn.functional.conv2d(
        z, torch.from_numpy(got).permute(3, 2, 0, 1))
    np.testing.assert_allclose(out.numpy(), want.numpy(), atol=1e-5, rtol=1e-5)


# -------------------------------------- fuse → optimize_for_serving path
@pytest.fixture(scope="module")
def optimized():
    """The JAX detector fused and optimised, its tree as numpy, and the
    unfused variables both packages start from. The widths give merged C3Ks
    (p5 and h6: 64 channels a branch) beside unmerged ones."""
    jax_det = JaxDetector(WIDTH, DEPTH, CSP, num_classes=NC,
                          precision="float32", input_size=(HW, HW))
    jax_det.init(seed=5)
    variables = perturbed_variables(to_numpy_tree(
        jax.device_get(jax_det.variables)), seed=5)
    jax_det.load_variables(variables)
    jax_det.fuse().optimize_for_tpu()
    tree = to_numpy_tree(jax.device_get(jax_det.variables))
    images = np.random.RandomState(13).randint(
        0, 256, (3, HW, HW, 3)).astype(np.uint8)
    return jax_det, tree, variables, images


def _port(variables):
    det = Detector(WIDTH, DEPTH, CSP, NC, precision="float32",
                   input_size=(HW, HW), device="cpu")
    det.load_variables(variables)
    return det


def _assert_serves_like_jax(port, jax_det, images):
    x = np.random.RandomState(14).randn(2, HW, HW, 3).astype(np.float32)
    np.testing.assert_allclose(port(x)[0].numpy(),
                               np.asarray(jax_det(jnp.asarray(x))[0]), **TOL)
    res_j = jax_det.serve(jnp.asarray(images), conf_thres=0.01,
                          device_preprocess=True)
    res_t = port.serve(torch.from_numpy(images), conf_thres=0.01,
                       device_preprocess=True)
    np.testing.assert_array_equal(res_t.num_valid.numpy(),
                                  np.asarray(res_j.num_valid))
    _assert_detections_equal(nms_to_lists(res_t), jax_nms_to_lists(res_j))


@pytest.mark.parametrize("order", ["fuse_first", "optimize_first"])
def test_fuse_and_optimize_compose_like_jax(optimized, order):
    jax_det, tree, variables, images = optimized
    port = _port(variables)
    if order == "fuse_first":
        port.fuse().optimize_for_serving()
    else:
        port.optimize_for_serving()
        assert port.model.net.s2d_stem and not port._merged
        port.fuse()
    state = port.model.state_dict()
    carried = from_jax_variables(tree, port.model)
    assert set(state) == set(carried)                 # key for key
    merged = sorted(k for k in state if ".conv12." in k)
    # weight and bias of one C3K per block of p5_csp and of h6
    assert len(merged) == 2 * (DEPTH[3] + DEPTH[5])
    assert any(".m0.conv1.conv.weight" in k for k in state)   # unmerged C3Ks
    for key, value in state.items():
        # BatchNorm folds in another order of fp32 operations: 1e-6
        np.testing.assert_allclose(value.numpy(), carried[key].numpy(),
                                   atol=1e-6, rtol=1e-6, err_msg=key)
    _assert_serves_like_jax(port, jax_det, images)


def test_load_variables_takes_an_optimized_jax_tree(optimized):
    jax_det, tree, _, images = optimized
    port = _port(tree)
    assert port._fused and port._s2d_stem and port._merged
    assert port.model.net.p1_conv.conv.weight.shape[1:] == (12, 2, 2)
    _assert_serves_like_jax(port, jax_det, images)
    # its own state dict loads back the same way
    again = _port(port.model.state_dict())
    assert again._s2d_stem and again._merged and again._fused
    x = np.random.RandomState(15).randn(1, HW, HW, 3).astype(np.float32)
    assert torch.equal(again(x)[0], port(x)[0])


def test_transforms_preserve_the_output(optimized):
    """``optimize_for_serving`` changes no prediction: fused against fused
    and optimised, and unfused against its space-to-depth form (fp32 sums
    in another order: 1e-4 absolute, 1e-4 relative)."""
    _, _, variables, _ = optimized
    x = np.random.RandomState(16).randn(2, HW, HW, 3).astype(np.float32)
    plain = _port(variables)
    want = plain(x)[0].numpy()
    s2d = _port(variables).optimize_for_serving()
    assert not s2d._fused and not s2d._merged
    np.testing.assert_allclose(s2d(x)[0].numpy(), want, **TOL)
    both = _port(variables).fuse().optimize_for_serving()
    np.testing.assert_allclose(both(x)[0].numpy(), want, **TOL)
    both.model.head.fused_cls_tower = True
    both.optimize_for_serving()                 # a second call changes nothing
    assert both.model.head.fused_cls_tower


def test_state_dict_transforms_on_their_own(optimized):
    _, _, variables, _ = optimized
    port = _port(variables).fuse()
    state = port.model.state_dict()
    merged = merge_c3k_params(state)
    prefix = "net.p5_csp.m0"
    assert merged[f"{prefix}.conv12.conv.weight"].shape[0] == 2 * MERGE_MIN_HALF
    assert torch.equal(merged[f"{prefix}.conv12.conv.bias"], torch.cat(
        [state[f"{prefix}.conv1.conv.bias"],
         state[f"{prefix}.conv2.conv.bias"]]))
    assert f"{prefix}.conv1.conv.weight" not in merged
    assert "net.p4_csp.m0.conv1.conv.weight" in merged     # half 16: kept
    assert "net.p5_csp.conv1.conv.weight" in merged        # a C3K2's own
    with pytest.raises(ValueError, match="fused"):
        merge_c3k_params(_port(variables).model.state_dict())
    stem = convert_stem_variables(state)
    assert stem["net.p1_conv.conv.weight"].shape == (WIDTH[1], 12, 2, 2)
    assert set(stem) == set(state)
