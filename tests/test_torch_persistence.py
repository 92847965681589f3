"""``Detector.save_weights`` / ``load_weights`` of the port against the JAX
package's, on the CPU.

The transform flags of the ``transforms.json`` sidecar must equal the JAX
``_transform_flags`` after the same calls; a tree the JAX package saved and
reloaded, carried into the port, saved and reloaded there, must serve as
JAX's reloaded detector does (fp32 within the model-forward tolerance,
int8 within ``test_torch_quant.FORWARD_STEPS``); and the port's own round
trip must serve bit for bit, in bf16 too.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from custom_yolo_tpu.models import Detector as JaxDetector
from custom_yolo_tpu.models import YoloModel as JaxYoloModel
from custom_yolo_tpu_torch import Detector
from custom_yolo_tpu_torch.models.detector import (TRANSFORMS_FILE,
                                                   WEIGHTS_FILE)

from test_torch_model import perturbed_variables, to_numpy_tree
from test_torch_quant import MERGE, NC, HW, assert_forward_close
from test_torch_serve import _assert_detections_equal
from torch_project import random_jax_variables

torch.set_num_threads(2)

SMALL = dict(width=(3, 8, 16, 32, 64, 256), depth=(2, 1, 1, 1, 2, 1),
             csp=(True, True))
CONF = 0.01
# the calls of each transform state, by the port's name (the JAX
# Detector's optimize_for_tpu is the port's optimize_for_serving)
TRANSFORMS = {
    "unfused": (),
    "fused": ("fuse",),
    "s2d": ("optimize",),
    "merged": ("fuse", "optimize"),
    "dynamic_int8": ("quantize",),
    "static_int8": ("quantize", "calibrate"),
}


def _images(seed, n=2):
    return np.random.RandomState(seed).randint(
        0, 256, (n, HW, HW, 3)).astype(np.uint8)


def _calibration():
    return np.random.RandomState(21).randn(2, HW, HW, 3).astype(np.float32)


def apply_jax(det, calls):
    for call in calls:
        if call == "fuse":
            det.fuse()
        elif call == "optimize":
            det.optimize_for_tpu()
        elif call == "quantize":
            det.quantize()
        elif call == "calibrate":
            det.calibrate([jnp.asarray(_calibration())])
    return det


def apply_port(det, calls):
    for call in calls:
        if call == "fuse":
            det.fuse()
        elif call == "optimize":
            det.optimize_for_serving()
        elif call == "quantize":
            det.quantize()
        elif call == "calibrate":
            det.calibrate([_calibration()])
    return det


def port_detector(cfg=MERGE, precision="float32"):
    return Detector(cfg["width"], cfg["depth"], cfg["csp"], NC,
                    precision=precision, input_size=(HW, HW), device="cpu")


@pytest.fixture(scope="module")
def jax_variables():
    """Seeded JAX variables of the MERGE model (its p5 C3Ks merge), with
    perturbed BatchNorm statistics."""
    model = JaxYoloModel(MERGE["width"], MERGE["depth"], MERGE["csp"], NC)
    return perturbed_variables(random_jax_variables(model, HW, seed=4),
                               seed=4)


def jax_detector(variables):
    det = JaxDetector(MERGE["width"], MERGE["depth"], MERGE["csp"], NC,
                      precision="float32", input_size=(HW, HW))
    det.load_variables(variables)
    return det


@pytest.mark.parametrize("name", list(TRANSFORMS))
def test_transform_flags_match_jax(jax_variables, name):
    want = apply_jax(jax_detector(jax_variables),
                     TRANSFORMS[name])._transform_flags()
    port = port_detector()
    port.load_variables(jax_variables)
    got = apply_port(port, TRANSFORMS[name])._transform_flags()
    assert got == want
    assert json.loads(json.dumps(got)) == got


@pytest.mark.parametrize("name", ["merged", "static_int8"])
def test_jax_saved_weights_serve_through_the_port(jax_variables, tmp_path,
                                                  name):
    """JAX ``save_weights`` → JAX ``load_weights`` → its tree carried into
    the port (``from_jax_variables``) → the port's ``save_weights`` →
    ``load_weights`` into a fresh detector: the flags equal the JAX
    sidecar's, and the forward and ``serve`` equal the reloaded JAX
    detector's."""
    apply_jax(jax_detector(jax_variables),
              TRANSFORMS[name]).save_weights(str(tmp_path / "jax"))
    # its template comes from the unfused variables (load_weights would
    # otherwise compile init for one)
    reloaded = jax_detector(jax_variables).load_weights(str(tmp_path / "jax"))
    carried = port_detector()
    carried.load_variables(to_numpy_tree(jax.device_get(reloaded.variables)))
    carried.save_weights(str(tmp_path / "port"))
    port = port_detector().load_weights(str(tmp_path / "port"))
    with open(tmp_path / "jax" / TRANSFORMS_FILE) as f:
        assert port._transform_flags() == json.load(f)

    x = np.random.RandomState(22).randn(2, HW, HW, 3).astype(np.float32)
    got = port(x)[0].numpy()
    want = np.asarray(reloaded(jnp.asarray(x))[0])
    if name == "static_int8":
        assert_forward_close(got, want)
        return
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=1e-4)
    images = _images(23)
    res_t = port.serve(torch.from_numpy(images), conf_thres=CONF,
                       device_preprocess=True)
    res_j = reloaded.serve(jnp.asarray(images), conf_thres=CONF,
                           device_preprocess=True)
    from custom_yolo_tpu.ops.nms import nms_to_lists as jax_nms_to_lists
    from custom_yolo_tpu_torch.ops.nms import nms_to_lists
    _assert_detections_equal(nms_to_lists(res_t), jax_nms_to_lists(res_j))


@pytest.mark.parametrize("precision,name", [
    ("bfloat16", n) for n in TRANSFORMS] + [("float32", "static_int8")])
def test_round_trip_serves_bit_for_bit(tmp_path, precision, name):
    """The port's ``save_weights`` then ``load_weights`` into a fresh
    detector: the same flags, the same kept fp32 state and the same
    ``serve`` output, bit for bit; the fused cls tower is off after the
    load."""
    det = port_detector(SMALL, precision)
    det.init(seed=5)
    apply_port(det, TRANSFORMS[name])
    if det._fused:
        det.model.head.fused_cls_tower = True
    det.save_weights(str(tmp_path))
    saved = torch.load(tmp_path / WEIGHTS_FILE, weights_only=True)
    assert all(v.dtype in (torch.float32, torch.int8, torch.int64)
               for v in saved.values())
    new = port_detector(SMALL, precision)
    new.init(seed=6)
    new.load_weights(str(tmp_path))
    assert new._transform_flags() == det._transform_flags()
    assert not new.model.head.fused_cls_tower
    state = det._transform_state()
    assert new._transform_state().keys() == state.keys()
    for key, value in new._transform_state().items():
        assert torch.equal(value, state[key]), key
    det.model.head.fused_cls_tower = False
    images = torch.from_numpy(_images(24))
    for a, b in zip(det.serve(images, conf_thres=CONF,
                              device_preprocess=True),
                    new.serve(images, conf_thres=CONF,
                              device_preprocess=True)):
        assert torch.equal(a, b)


def test_reloaded_bf16_detector_quantizes_as_the_original(tmp_path):
    """A fused bf16 detector saves its fp32 fold: ``quantize`` on the
    reloaded detector gives the original's int8 state exactly (saving the
    bf16 convs would round the fold first)."""
    det = port_detector(SMALL, "bfloat16")
    det.init(seed=7)
    det.fuse().save_weights(str(tmp_path))
    new = port_detector(SMALL, "bfloat16").load_weights(str(tmp_path))
    det.quantize()
    new.quantize()
    for key, value in det._state.items():
        assert torch.equal(new._state[key], value), key


def test_weights_without_a_sidecar_load_as_unfused(tmp_path):
    det = port_detector(SMALL)
    det.init(seed=8)
    det.save_weights(str(tmp_path))
    (tmp_path / TRANSFORMS_FILE).unlink()
    new = port_detector(SMALL).load_weights(str(tmp_path))
    assert new._transform_flags() == det._transform_flags()
    x = np.random.RandomState(25).randn(1, HW, HW, 3).astype(np.float32)
    assert torch.equal(new(x)[0], det(x)[0])
    # a sidecar that claims static scales the state does not hold
    det.fuse().quantize().save_weights(str(tmp_path / "int8"))
    flags = det._transform_flags()
    flags["static_quant"] = True
    (tmp_path / "int8" / TRANSFORMS_FILE).write_text(json.dumps(flags))
    with pytest.raises(ValueError, match="static_quant"):
        port_detector(SMALL).load_weights(str(tmp_path / "int8"))
