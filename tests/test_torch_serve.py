"""The whole serving slice against the JAX package, on the CPU, in fp32:
``Detector.serve`` (uint8 batch, ``device_preprocess=True``, a low
confidence gate so the pools fill), ``Detector.inference`` on one array,
and ``preprocess_image``'s resize."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from custom_yolo_tpu.models import Detector as JaxDetector
from custom_yolo_tpu.models.detector import (
    preprocess_image as jax_preprocess_image)
from custom_yolo_tpu.ops.nms import nms_to_lists as jax_nms_to_lists
from custom_yolo_tpu_torch import Detector
from custom_yolo_tpu_torch.models.detector import preprocess_image
from custom_yolo_tpu_torch.ops.nms import nms_to_lists

from test_torch_model import (CSP, DEPTH, HW, NC, WIDTH, perturbed_variables,
                              to_numpy_tree)

torch.set_num_threads(2)

CONF = 0.01


@pytest.fixture(scope="module")
def pair():
    jax_det = JaxDetector(WIDTH, DEPTH, CSP, num_classes=NC,
                          precision="float32", input_size=(HW, HW))
    jax_det.init(seed=3)
    variables = perturbed_variables(to_numpy_tree(
        jax.device_get(jax_det.variables)), seed=3)
    jax_det.load_variables(variables)
    jax_det.fuse()
    port = Detector(WIDTH, DEPTH, CSP, NC, precision="float32",
                    input_size=(HW, HW), device="cpu")
    port.load_variables(variables)
    port.fuse()
    return jax_det, port


def _assert_detections_equal(port_lists, jax_lists):
    assert len(port_lists) == len(jax_lists)
    for got, want in zip(port_lists, jax_lists):
        assert got.shape == want.shape
        assert len(got) > 0
        np.testing.assert_array_equal(got[:, 5], want[:, 5])      # classes
        np.testing.assert_allclose(got[:, :4], want[:, :4], atol=1e-3)
        np.testing.assert_allclose(got[:, 4], want[:, 4], atol=1e-5)


def test_serve_matches_jax(pair):
    jax_det, port = pair
    images = np.random.RandomState(11).randint(
        0, 256, (3, HW, HW, 3)).astype(np.uint8)
    res_j = jax_det.serve(jnp.asarray(images), conf_thres=CONF,
                          device_preprocess=True)
    res_t = port.serve(torch.from_numpy(images), conf_thres=CONF,
                       device_preprocess=True)
    assert res_t.boxes.shape == (3, 84, 4)
    np.testing.assert_array_equal(res_t.num_valid.numpy(),
                                  np.asarray(res_j.num_valid))
    _assert_detections_equal(nms_to_lists(res_t), jax_nms_to_lists(res_j))


def test_inference_matches_jax(pair):
    jax_det, port = pair
    image = np.random.RandomState(12).randint(
        0, 256, (90, 120, 3)).astype(np.uint8)
    for letterbox in (False, True):
        kw = dict(conf_thres=CONF, letterbox=letterbox, original_coords=True)
        _assert_detections_equal(port.inference(image, **kw),
                                 jax_det.inference(image, **kw))


@pytest.mark.parametrize("src,letterbox", [
    ((100, 90), False), ((30, 20), False), ((50, 70), True),
    ((64, 64), False)], ids=["down", "up", "letterbox", "same"])
def test_preprocess_resize_matches_jax(src, letterbox):
    image = np.random.RandomState(5).rand(*src, 3).astype(np.float32)
    got = preprocess_image(image, (64, 64), letterbox=letterbox,
                           return_geometry=True)
    want = jax_preprocess_image(image, (64, 64), letterbox=letterbox,
                                return_geometry=True)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, np.asarray(w), atol=1e-5, rtol=0)
