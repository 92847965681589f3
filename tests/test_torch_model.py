"""The port's model against the JAX package's, on the CPU, in fp32.

A JAX ``Detector`` makes the variables (with perturbed BatchNorm
statistics, so folding is exercised); ``from_jax_variables`` carries them
into the port; both forwards then see the same numpy-seeded images.
Tolerances are atol/rtol 1e-4: the two frameworks sum each convolution in
another order.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from custom_yolo_tpu.models import Detector as JaxDetector
from custom_yolo_tpu.models.detector import fuse_params
from custom_yolo_tpu_torch import Detector, PRESETS, YoloModel
from custom_yolo_tpu_torch.core.dtypes import resolve_policy
from custom_yolo_tpu_torch.models.detector import fuse_state_dict
from custom_yolo_tpu_torch.utils.weights import from_jax_variables

torch.set_num_threads(2)

# covers r=4 and r=2 C3K2 stages, C3K chains, depth-2 stages, a 2-head PSA,
# SPPF and the three-level head
WIDTH = (3, 8, 16, 32, 64, 256)
DEPTH = (2, 1, 1, 1, 2, 1)
CSP = (True, True)
NC = 7
HW = 64
TOL = dict(atol=1e-4, rtol=1e-4)


def to_numpy_tree(tree):
    """A flax variable tree → nested plain dicts of numpy arrays."""
    if hasattr(tree, "items"):
        return {k: to_numpy_tree(v) for k, v in tree.items()}
    return np.asarray(tree)


def perturbed_variables(variables, seed=0):
    """Non-trivial BatchNorm scale/bias/statistics, so that folding and
    normalisation both matter."""
    rng = np.random.RandomState(seed)

    def walk(node, path):
        out = {}
        for key, value in node.items():
            if isinstance(value, dict):
                out[key] = walk(value, path + (key,))
            elif path[-1:] == ("bn",) and key in ("scale", "var"):
                out[key] = rng.uniform(0.5, 1.5, value.shape).astype(
                    np.float32)
            elif path[-1:] == ("bn",) and key in ("bias", "mean"):
                out[key] = (0.1 * rng.randn(*value.shape)).astype(np.float32)
            else:
                out[key] = value
        return out

    return walk(variables, ())


@pytest.fixture(scope="module")
def carried():
    det = JaxDetector(WIDTH, DEPTH, CSP, num_classes=NC, precision="float32",
                      input_size=(HW, HW))
    det.init()
    variables = perturbed_variables(to_numpy_tree(
        jax.device_get(det.variables)))
    det.load_variables(variables)
    return det, variables


@pytest.fixture(scope="module")
def images():
    return np.random.RandomState(7).randn(2, HW, HW, 3).astype(np.float32)


def _port(variables):
    det = Detector(WIDTH, DEPTH, CSP, NC, precision="float32",
                   input_size=(HW, HW), device="cpu")
    det.load_variables(variables)
    return det


def _assert_forward_equal(port_out, jax_out):
    preds_t, anchors_t, strides_t = (t.numpy() for t in port_out)
    preds_j, anchors_j, strides_j = (np.asarray(a) for a in jax_out)
    np.testing.assert_array_equal(anchors_t, anchors_j)
    np.testing.assert_array_equal(strides_t, strides_j)
    assert preds_t.shape == preds_j.shape == (2, 84, 4 * 16 + NC)
    np.testing.assert_allclose(preds_t, preds_j, **TOL)


def test_weights_load_strictly_and_fold_like_jax(carried):
    jax_det, variables = carried
    model = YoloModel(WIDTH, DEPTH, CSP, NC, policy=resolve_policy("float32"))
    state = from_jax_variables(variables, model)
    model.load_state_dict(state, strict=True)
    kernel = variables["params"]["net"]["p1_conv"]["conv"]["kernel"]
    assert torch.equal(model.net.p1_conv.conv.weight,
                       torch.from_numpy(kernel.transpose(3, 2, 0, 1).copy()))

    fused_jax = to_numpy_tree(fuse_params(variables))
    fused_model = YoloModel(WIDTH, DEPTH, CSP, NC, fused=True)
    carried_fused = from_jax_variables(fused_jax, fused_model)
    folded = fuse_state_dict(model.state_dict())
    assert set(folded) == set(carried_fused)
    for key, value in folded.items():
        np.testing.assert_allclose(value.numpy(), carried_fused[key].numpy(),
                                   atol=1e-6, rtol=1e-6, err_msg=key)


def test_weights_reject_missing_extra_and_misshaped(carried):
    _, variables = carried
    model = YoloModel(WIDTH, DEPTH, CSP, NC)
    missing = {"params": dict(variables["params"]),
               "batch_stats": variables["batch_stats"]}
    del missing["params"]["fpn"]
    with pytest.raises(ValueError, match="missing"):
        from_jax_variables(missing, model)
    extra = {"params": {**variables["params"],
                        "stray": {"kernel": np.zeros((1, 1, 3, 3))}},
             "batch_stats": variables["batch_stats"]}
    with pytest.raises(ValueError, match="extra"):
        from_jax_variables(extra, model)
    wrong = YoloModel(WIDTH, DEPTH, CSP, NC + 1)
    with pytest.raises(ValueError, match="shape mismatches"):
        from_jax_variables(variables, wrong)


def test_forward_matches_jax_unfused(carried, images):
    jax_det, variables = carried
    _assert_forward_equal(_port(variables)(images),
                          jax_det(jnp.asarray(images)))


def test_forward_matches_jax_fused(carried, images):
    jax_det, variables = carried
    fused_vars = to_numpy_tree(fuse_params(variables))
    jax_fused = JaxDetector(WIDTH, DEPTH, CSP, num_classes=NC,
                            precision="float32", input_size=(HW, HW))
    jax_fused.init()
    jax_fused.fuse()
    jax_fused.load_variables(fused_vars)
    jax_out = jax_fused(jnp.asarray(images))
    # the carried fused tree, and the port's own fuse() of the unfused one
    _assert_forward_equal(_port(fused_vars)(images), jax_out)
    _assert_forward_equal(_port(variables).fuse()(images), jax_out)


def test_x_preset_forward_matches_jax():
    """The flagship's widths and depths (172 classes) at 128²."""
    p = PRESETS["x"]
    jax_det = JaxDetector(p["width"], p["depth"], p["csp"], num_classes=172,
                          precision="float32", input_size=(128, 128))
    jax_det.init()
    variables = perturbed_variables(to_numpy_tree(
        jax.device_get(jax_det.variables)), seed=1)
    jax_det.load_variables(variables)
    x = np.random.RandomState(2).randn(1, 128, 128, 3).astype(np.float32)
    port = Detector(p["width"], p["depth"], p["csp"], 172,
                    precision="float32", input_size=(128, 128), device="cpu")
    port.load_variables(variables)
    preds_t = port(x)[0].numpy()
    preds_j = np.asarray(jax_det(jnp.asarray(x))[0])
    assert preds_t.shape == preds_j.shape == (1, 336, 64 + 172)
    np.testing.assert_allclose(preds_t, preds_j, **TOL)
