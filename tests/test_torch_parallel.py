"""The port's mesh, sharding rules, collectives and sharded serving against
the JAX package, in one process on the CPU (the small model of
``tests/test_sharding.py``). Two-process runs are in
``tests/test_torch_multiprocess.py``."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P
from torch.distributed.tensor import Replicate, Shard

from custom_yolo_tpu.core.dtypes import resolve_policy as jax_policy
from custom_yolo_tpu.core.mesh import FSDP_AXIS as JAX_FSDP_AXIS
from custom_yolo_tpu.core.mesh import MeshSpec as JaxMeshSpec
from custom_yolo_tpu.core.mesh import create_mesh as jax_create_mesh
from custom_yolo_tpu.models import YoloModel as JaxYoloModel
from custom_yolo_tpu.models import fuse_params as jax_fuse_params
from custom_yolo_tpu.models.detector import \
    decode_raw_predictions as jax_decode
from custom_yolo_tpu.ops.nms import batched_nms as jax_batched_nms
from custom_yolo_tpu.ops.quant import bake_static_scales as jax_bake
from custom_yolo_tpu.ops.quant import \
    quantize_fused_params as jax_quantize_fused_params
from custom_yolo_tpu.parallel.sharding import _fsdp_spec as jax_fsdp_spec
from custom_yolo_tpu.parallel.sharding import \
    param_shardings as jax_param_shardings
from custom_yolo_tpu_torch import Detector
from custom_yolo_tpu_torch.core.mesh import DATA_AXIS, FSDP_AXIS, MeshSpec
from custom_yolo_tpu_torch.eval.metrics import DetectionMetrics
from custom_yolo_tpu_torch.models.detector import create_train_model
from custom_yolo_tpu_torch.parallel import sharding
from custom_yolo_tpu_torch.parallel.collectives import (reduce_metrics,
                                                        reduce_value)
from custom_yolo_tpu_torch.parallel.serve import (make_sharded_serve_fn,
                                                  shard_serve_batch)
from custom_yolo_tpu_torch.utils.weights import _convert
from torch_project import detection_cases, random_jax_variables

torch.set_num_threads(2)

WIDTH = (3, 8, 16, 32, 64, 64)
DEPTH = (1, 1, 1, 1, 1, 1)
CSP = (False, True)
NC = 7
HW = 64
SERVE = dict(conf_thres=0.01, iou_thres=0.45, max_det=32, top_k=128)


@pytest.fixture(scope="module")
def jax_small():
    model = JaxYoloModel(WIDTH, DEPTH, CSP, NC, policy=jax_policy("float32"))
    return model, random_jax_variables(model, HW, seed=0)


@pytest.mark.parametrize("mode", ["single", "dp", "fsdp"])
def test_mesh_spec_for_mode_matches_jax(mode):
    for n in (1, 2, 8):
        want = JaxMeshSpec.for_mode(mode, num_devices=n)
        got = MeshSpec.for_mode(mode, num_devices=n)
        assert (got.data, got.fsdp) == (want.data, want.fsdp)
    # one process: no mesh beyond one device
    assert MeshSpec.for_mode(mode) == MeshSpec()
    assert (DATA_AXIS, FSDP_AXIS) == ("data", JAX_FSDP_AXIS)
    with pytest.raises(ValueError):
        MeshSpec.for_mode("zero3", num_devices=2)


@pytest.mark.parametrize("fsdp", [2, 8])
def test_param_shardings_split_what_jax_splits(jax_small, fsdp):
    """With fsdp_min_weight_size 1024, each parameter is split by the port
    exactly when the JAX package's ``param_shardings`` splits it, and along
    the OIHW axis of the HWIO axis JAX picks (depthwise kernels, small and
    indivisible ones whole)."""
    _, variables = jax_small
    mesh = jax_create_mesh(JaxMeshSpec(fsdp=fsdp))
    specs = jax_param_shardings(variables["params"], mesh,
                                min_weight_size=1024)
    want = {}
    for path, sh in jax.tree_util.tree_flatten_with_path(specs)[0]:
        names = tuple(p.key for p in path)
        shape = np.shape(_leaf(variables["params"], names))
        axes = [i for i, a in enumerate(sh.spec) if a is not None]
        # a leaf that counts up along JAX's split axis, carried into the
        # port's layout: the port's axis is the one it counts along
        marker = np.zeros(shape, np.float32)
        if axes:
            marker += np.arange(shape[axes[0]]).reshape(
                [-1 if i == axes[0] else 1 for i in range(len(shape))])
        key, port = _convert("params", names, marker)
        want[key] = Replicate()
        for dim in range(port.dim()):
            if axes and not torch.equal(port, port.narrow(dim, 0, 1)
                                        .expand_as(port)):
                want[key] = Shard(dim)
    model = create_train_model(WIDTH, DEPTH, CSP, NC, precision="float32",
                               device="cpu")
    got = sharding.param_shardings(model, fsdp, min_weight_size=1024)
    assert got == want
    split = [k for k, v in got.items() if isinstance(v, Shard)]
    assert split and len(split) < len(got)
    # a depthwise kernel above the size limit stays whole, in both
    assert jax_fsdp_spec((3, 3, 1, 2048), fsdp, 1024) == P()
    assert sharding._fsdp_axis((3, 3, 1, 2048), fsdp, 1024) is None


def _leaf(tree, names):
    for name in names:
        tree = tree[name]
    return tree


def test_placements_and_single_process_collectives():
    """``replicate``/``batch_sharding`` over both mesh axes; without a
    process group the collectives return their input and
    ``DetectionMetrics.all_reduce`` leaves the counters as they are."""

    class Mesh2:
        ndim = 2

    assert sharding.replicate(Mesh2) == (Replicate(), Replicate())
    assert sharding.batch_sharding(Mesh2) == (Shard(0), Shard(0))
    assert reduce_value(2.5) == 2.5
    arr = np.arange(3.0)
    assert reduce_value(arr, average=False) is arr
    metrics = {"loss": 1.0, "box": 2.0}
    assert reduce_metrics(metrics) is metrics
    det = DetectionMetrics(NC)
    for preds, targets in detection_cases(3):
        det.update(preds, targets)
    before = det.compute()
    assert det.all_reduce() is det
    assert det.compute() == before and det.true_positives > 0


# ------------------------------------------------------------ sharded serve
def _jax_serve(model, variables, images):
    preds, anchors, strides = model.apply(variables, images, train=False)
    boxes, scores = jax_decode(preds, anchors, strides)
    return jax.device_get(jax_batched_nms(
        boxes, scores.max(axis=-1), scores.argmax(axis=-1).astype(jnp.int32),
        **SERVE))


def _assert_serve_matches(out, ref, box_tol, score_tol):
    """``tests/test_sharding.py``'s comparison of two serving results."""
    np.testing.assert_array_equal(out.num_valid.numpy(),
                                  np.asarray(ref.num_valid))
    np.testing.assert_array_equal(out.valid.numpy(), np.asarray(ref.valid))
    np.testing.assert_array_equal(out.classes.numpy(),
                                  np.asarray(ref.classes))
    v = np.asarray(ref.valid)
    assert v.sum() > 0
    np.testing.assert_allclose(out.boxes.numpy()[v], np.asarray(ref.boxes)[v],
                               **box_tol)
    np.testing.assert_allclose(out.scores.numpy()[v],
                               np.asarray(ref.scores)[v], **score_tol)


def _port_detector(variables):
    det = Detector(WIDTH, DEPTH, CSP, NC, precision="float32",
                   input_size=(HW, HW), device="cpu")
    det.load_variables(variables)
    return det


def test_sharded_serve_matches_jax_single_device(jax_small):
    """fp32: ``make_sharded_serve_fn`` over ``["cpu", "cpu"]`` (two slices
    of four, one thread each) against the single-device JAX serve program:
    ``num_valid``, ``valid`` and ``classes`` exactly, boxes within rtol
    1e-5 / atol 1e-4 and scores within rtol 1e-5 / atol 1e-6, the
    tolerances of ``tests/test_sharding.py``; and bit for bit the port's
    own ``Detector.serve`` of the whole batch."""
    model, variables = jax_small
    images = np.random.RandomState(7).rand(8, HW, HW, 3).astype(np.float32)
    ref = _jax_serve(model, variables, jnp.asarray(images))
    det = _port_detector(variables)
    fn = make_sharded_serve_fn(det, ["cpu", "cpu"], **SERVE)
    out = fn(torch.from_numpy(images))
    _assert_serve_matches(out, ref, dict(rtol=1e-5, atol=1e-4),
                          dict(rtol=1e-5, atol=1e-6))
    whole = det.serve(torch.from_numpy(images), **SERVE)
    for got, want in zip(out, whole):
        assert torch.equal(got, want)
    assert [p.shape[0] for p in shard_serve_batch(images, ["cpu"] * 2)] \
        == [4, 4]
    with pytest.raises(ValueError):
        fn(torch.from_numpy(images[:7]))


def test_sharded_serve_static_int8_matches_jax_single_device(jax_small):
    """Static int8 (JAX's quantize and calibration, loaded by the port)
    over ``["cpu", "cpu"]`` against the same graph in JAX on one device,
    at ``tests/test_sharding.py``'s tolerances; and bit for bit the port's
    ``Detector.serve`` of the whole batch."""
    model, variables = jax_small
    qmodel = model.clone(fused=True, quantized=True)
    qparams = jax_quantize_fused_params(jax_fuse_params(variables)["params"])
    images = np.random.RandomState(9).rand(8, HW, HW, 3).astype(np.float32)
    _, stats = qmodel.apply({"params": qparams}, jnp.asarray(images[:2]),
                            train=False, mutable=["quant_stats"])
    qvars = {"params": jax_bake(qparams,
                                jax.device_get(stats["quant_stats"]))}
    ref = _jax_serve(qmodel, qvars, jnp.asarray(images))
    det = _port_detector(jax.device_get(qvars))
    assert det._quantized
    out = make_sharded_serve_fn(det, ["cpu", "cpu"], **SERVE)(
        torch.from_numpy(images))
    _assert_serve_matches(out, ref, dict(rtol=1e-5, atol=1e-4),
                          dict(rtol=1e-5, atol=1e-6))
    whole = det.serve(torch.from_numpy(images), **SERVE)
    for got, want in zip(out, whole):
        assert torch.equal(got, want)
