"""The port's serving artifacts (``custom_yolo_tpu_torch/export.py``) on the
CPU, against the port's own ``Detector.serve`` and against the JAX
package's artifact (``custom_yolo_tpu/export.py``).

The four JAX tests (``tests/test_export.py``) on the port at the same small
model: the round trip bit-equal to ``serve``, static int8 bit-equal, the
shape guard and the platform guard. Then what is the port's own: the
exported graph holds the kernels' registered ops (one node a launch, not
the twins' arithmetic, so its size does not grow with the NMS pool), the
keep-mask op equals the twin on a dense pool, and the port's artifact
agrees with the JAX artifact made from the same variables.
"""

import json
import os
from collections import Counter

import numpy as np
import pytest
import torch

from custom_yolo_tpu.export import export_serving as jax_export_serving
from custom_yolo_tpu.export import load_exported as jax_load_exported
from custom_yolo_tpu.models import Detector as JaxDetector
from custom_yolo_tpu_torch import Detector
from custom_yolo_tpu_torch.export import export_serving, load_exported
from custom_yolo_tpu_torch.nn.blocks import Attention
from custom_yolo_tpu_torch.ops import attention, nms_kernel, sppf_kernel

from test_torch_model import perturbed_variables
from torch_project import random_jax_variables

torch.set_num_threads(2)

WIDTH = (3, 8, 16, 32, 64, 64)
DEPTH = (1, 1, 1, 1, 1, 1)
CSP = (False, True)
NC = 5
HW = 64
SERVE = dict(conf_thres=0.001, top_k=64, max_det=20)
OP = "custom_yolo_tpu_torch."


def _jax_detector() -> JaxDetector:
    return JaxDetector(WIDTH, DEPTH, CSP, num_classes=NC, precision="float32",
                       input_size=(HW, HW))


@pytest.fixture(scope="module")
def variables():
    """Seeded unfused variables of the JAX model, as numpy, with BatchNorm
    statistics that matter."""
    return perturbed_variables(random_jax_variables(
        _jax_detector().module, HW, seed=0), seed=1)


def _port(variables) -> Detector:
    det = Detector(WIDTH, DEPTH, CSP, NC, precision="float32",
                   input_size=(HW, HW), device="cpu")
    det.load_variables(variables)
    return det


@pytest.fixture(scope="module")
def detector(variables):
    return _port(variables).fuse()


@pytest.fixture(scope="module")
def images():
    return np.random.RandomState(0).randn(2, HW, HW, 3).astype(np.float32)


@pytest.fixture(scope="module")
def artifacts(tmp_path_factory, detector):
    """The fused detector exported at B=2 and at B=1."""
    root = tmp_path_factory.mktemp("artifacts")
    return {batch: export_serving(detector, str(root / f"b{batch}"),
                                  batch_size=batch, **SERVE)
            for batch in (2, 1)}


def _assert_results_equal(got, want):
    for name in got._fields:
        assert torch.equal(getattr(got, name), getattr(want, name)), name


def _op_counts(server) -> Counter:
    return Counter(str(node.target) for node in server.program.graph.nodes
                   if node.op == "call_function")


def test_export_round_trip_matches_serve(artifacts, detector, images):
    server = load_exported(artifacts[2])
    _assert_results_equal(server(images),
                          detector.serve(torch.from_numpy(images), **SERVE))
    one = load_exported(artifacts[1])
    _assert_results_equal(one(images[:1]), detector.serve(
        torch.from_numpy(images[:1]), **SERVE))
    assert server.manifest["num_classes"] == NC
    assert server.manifest["transforms"]["fused"] is True
    assert server.manifest["platforms"] == ["cpu"]
    assert server.manifest["input_dtype"] == "float32"
    assert server.manifest["torch_version"] == torch.__version__


def test_export_quantized_static(tmp_path, variables, images):
    det = _port(variables)
    det.quantize(skip=())
    det.calibrate([images])
    path = export_serving(det, str(tmp_path / "art_q"), batch_size=2,
                          **SERVE)
    server = load_exported(path)
    _assert_results_equal(server(images),
                          det.serve(torch.from_numpy(images), **SERVE))
    assert server.manifest["transforms"]["quantized"] is True
    assert server.manifest["transforms"]["static_quant"] is True


def test_input_shape_guard(artifacts, images):
    server = load_exported(artifacts[2])
    with pytest.raises(ValueError, match="expected input"):
        server(images[:1])


def test_platform_guard(tmp_path, detector):
    path = export_serving(detector, str(tmp_path / "art3"), batch_size=1)
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)
    manifest["platforms"] = ["tpu_v9_imaginary"]
    with open(os.path.join(path, "manifest.json"), "w") as f:
        json.dump(manifest, f)
    with pytest.raises(RuntimeError, match="re-export on the target"):
        load_exported(path)


def test_exported_graph_holds_the_kernels_ops(tmp_path, artifacts, detector,
                                              images):
    """One op node for each launch of the serve path (K1 for every PSA
    attention, K5 once, the batched keep mask at B=2 and the single-image
    one at B=1), none of the twins' own operations (the pooling chain, the
    sweep's triangular mask), and a graph whose size does not depend on
    the NMS pool. Running it on the CPU launches nothing."""
    psa = sum(isinstance(m, Attention) for m in detector.model.modules())
    assert psa >= 1
    counts = {b: _op_counts(load_exported(artifacts[b])) for b in (2, 1)}
    for batch, keep in ((2, "nms_keep_batched"), (1, "nms_keep_single")):
        ops = {k: v for k, v in counts[batch].items() if k.startswith(OP)}
        assert ops == {f"{OP}psa_attention_fwd.default": psa,
                       f"{OP}sppf_pyramid.default": 1,
                       f"{OP}{keep}.default": 1}, ops
        assert not any("max_pool2d" in k or "triu" in k
                       for k in counts[batch])
    narrow, wider = (load_exported(export_serving(
        detector, str(tmp_path / f"k{k}"), batch_size=2,
        **{**SERVE, "top_k": k})) for k in (32, 128))
    assert sum(_op_counts(wider).values()) \
        == sum(_op_counts(narrow).values())
    for wrapper in (attention.psa_attention, sppf_kernel.sppf_pyramid,
                    nms_kernel.nms_keep_batched, nms_kernel.nms_keep_single):
        wrapper.launches = 0
    wider(images)
    assert attention.psa_attention.launches == 0
    assert sppf_kernel.sppf_pyramid.launches == 0
    assert nms_kernel.nms_keep_batched.launches == 0


def test_nms_keep_op_matches_twin_on_a_dense_pool():
    """Random boxes of 20 classes, offset by class, where most of the pool
    survives: the keep mask through the registered ops (batched and single
    image) equals the twin's."""
    rng = np.random.RandomState(5)
    n, k = 3, 256
    xy = rng.uniform(0, 600, (n, k, 2)).astype(np.float32)
    wh = rng.uniform(4, 80, (n, k, 2)).astype(np.float32)
    cls = rng.randint(0, 20, (n, k)).astype(np.float32)
    boxes = np.concatenate([xy, xy + wh], -1) + (cls * 7680.0)[..., None]
    boxes = torch.from_numpy(boxes.astype(np.float32))
    valid = torch.from_numpy(rng.uniform(size=(n, k)) < 0.9)
    want = nms_kernel.nms_keep_reference(boxes, valid, 0.45)
    assert want.sum() > 0.5 * valid.sum()
    assert torch.equal(nms_kernel.nms_keep(boxes, valid, 0.45), want)
    assert torch.equal(torch.ops.custom_yolo_tpu_torch.nms_keep_batched(
        boxes, valid, 0.45), want)
    for i in range(n):
        one = (boxes[i:i + 1].contiguous(), valid[i:i + 1].contiguous())
        assert torch.equal(nms_kernel.nms_keep(*one, 0.45), want[i:i + 1])


def test_export_matches_jax_artifact(tmp_path, variables, detector, images):
    """The same variables through the JAX package's export (CPU) and the
    port's: equal classes, valid and counts, boxes within 1e-3 px and
    scores within 1e-5, as the serve tests hold them."""
    jax_det = _jax_detector()
    jax_det.load_variables(variables)
    jax_det.fuse()
    want = jax_load_exported(jax_export_serving(
        jax_det, str(tmp_path / "jax"), batch_size=2, **SERVE))(images)
    got = load_exported(export_serving(
        detector, str(tmp_path / "port"), batch_size=2, **SERVE))(images)
    np.testing.assert_array_equal(got.valid.numpy(), np.asarray(want.valid))
    np.testing.assert_array_equal(got.num_valid.numpy(),
                                  np.asarray(want.num_valid))
    np.testing.assert_array_equal(got.classes.numpy(),
                                  np.asarray(want.classes))
    np.testing.assert_allclose(got.boxes.numpy(), np.asarray(want.boxes),
                               atol=1e-3)
    np.testing.assert_allclose(got.scores.numpy(), np.asarray(want.scores),
                               atol=1e-5)
    assert got.valid.any()
