"""Guards for what could make the port learn less than the JAX package
(the n quality gate's miss): the port's own initialisation against
flax's ``model.init`` at the n preset's layout, and the augmentation
draws of ``make_device_batch`` against JAX's, as distributions. (The
bf16 train step is held to JAX's in ``tests/test_torch_train.py``, case
``tal-n-layout-bf16``.) Every tolerance is stated where it is used."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from custom_yolo_tpu.data import transforms as jt
from custom_yolo_tpu.models import YoloModel as JaxYoloModel
from custom_yolo_tpu_torch import PRESETS
from custom_yolo_tpu_torch.data import transforms as pt
from custom_yolo_tpu_torch.models.detector import YoloModel, init_weights
from custom_yolo_tpu_torch.models.head import CLS_BIAS
from custom_yolo_tpu_torch.utils.weights import from_jax_variables

torch.set_num_threads(2)

N_PRESET = PRESETS["n"]
NC = 8
HW = 64
# flax's lecun_normal: a normal truncated at ±2 of its own σ, scaled so
# that the variance is 1/fan_in (the σ before truncation is
# sqrt(1/fan_in) / 0.8796)
TRUNCATION = 2.0 / 0.87962566103423978


def _flax_init(s2d_stem: bool):
    model = JaxYoloModel(N_PRESET["width"], N_PRESET["depth"],
                         N_PRESET["csp"], NC, s2d_stem=s2d_stem)
    variables = jax.jit(functools.partial(model.init, train=False))(
        jax.random.key(3), jnp.zeros((1, HW, HW, 3)))
    return jax.tree.map(np.asarray, variables)


def _port_init(s2d_stem: bool, seed: int):
    model = YoloModel(N_PRESET["width"], N_PRESET["depth"], N_PRESET["csp"],
                      NC, s2d_stem=s2d_stem)
    init_weights(model, seed)
    return model


@pytest.mark.parametrize("s2d_stem", [False, True], ids=["n", "n-s2d-stem"])
def test_init_weights_matches_flax_init(s2d_stem):
    """Every conv kernel of the port's ``init_weights`` and of flax's
    ``init`` (carried into the port's names and OIHW layout) against the
    distribution both should draw from: zero mean and variance 1/fan_in
    with flax's fan-in (kh·kw·in/groups of the HWIO kernel), truncated at
    ±2σ. For leaves of ≥ 1k elements the sample std is held to that σ
    within 5 standard errors of a sample std (5/sqrt(2N); the truncated
    normal's kurtosis of 2.6 makes the true error smaller) and the mean
    to 5σ/sqrt(N); every leaf stays inside the truncation. The depthwise
    convs (fan-in 9), the PSA block's qkv/projection/positional convs and
    the stem (a 2×2 kernel on 12 channels with the space-to-depth stem)
    are among them. Biases: the class logits' prior ``CLS_BIAS`` on both
    sides, zero on the box branch; BatchNorm at identity."""
    flax_vars = _flax_init(s2d_stem)
    ours = _port_init(s2d_stem, seed=11)
    theirs = from_jax_variables(flax_vars, ours)
    state = ours.state_dict()
    assert theirs.keys() == state.keys()
    kernels = 0
    checked = set()
    for key, value in state.items():
        got = value.double().numpy()
        want = theirs[key].double().numpy()
        assert got.shape == want.shape, key
        if key.endswith(".weight") and value.dim() == 4:
            o, i, kh, kw = value.shape
            sigma = (1.0 / (i * kh * kw)) ** 0.5
            for name, w in (("port", got), ("flax", want)):
                assert np.abs(w).max() <= TRUNCATION * sigma * (1 + 1e-6), \
                    (name, key)
                if w.size >= 1000:
                    assert abs(w.std() / sigma - 1) <= 5 / (2 * w.size) \
                        ** 0.5, (name, key, w.std(), sigma)
                    assert abs(w.mean()) <= 5 * sigma / w.size ** 0.5, \
                        (name, key)
            kernels += 1
            if i == 1 and kh == 3:
                checked.add("depthwise")
            if ".attn." in key:
                checked.add("psa")
            if key == "net.p1_conv.conv.weight":
                checked.add("stem")
                assert (kh, i) == ((2, 12) if s2d_stem else (3, 3))
        elif key.endswith("_out.bias"):
            prior = ".cls" in key
            np.testing.assert_array_equal(
                got, np.float32(CLS_BIAS) if prior else 0.0)
            np.testing.assert_array_equal(want, got, err_msg=key)
            checked.add("cls bias" if prior else "box bias")
        elif ".bn." in key and not key.endswith("num_batches_tracked"):
            one = key.endswith(("bn.weight", "running_var"))
            np.testing.assert_array_equal(got, 1.0 if one else 0.0)
            np.testing.assert_array_equal(want, got, err_msg=key)
    assert kernels == sum(1 for m in ours.modules()
                          if isinstance(m, torch.nn.Conv2d))
    assert checked == {"depthwise", "psa", "stem", "cls bias", "box bias"}


def test_init_weights_is_seeded():
    a = _port_init(False, seed=4).state_dict()
    b = _port_init(False, seed=4).state_dict()
    c = _port_init(False, seed=5).state_dict()
    key = "head.cls0_pw1.conv.weight"
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(a[key], c[key])


# ------------------------------------------------------- augmentation draws
DRAWS = 4000
# the two-sample Kolmogorov–Smirnov statistic's critical value at
# α ≈ 1e-4 for 4000 against 4000 samples: 2.23·sqrt(2/4000)
KS_LIMIT = 0.05


def _ks(a: np.ndarray, b: np.ndarray) -> float:
    grid = np.sort(np.concatenate([a, b]))
    cdf_a = np.searchsorted(np.sort(a), grid, side="right") / len(a)
    cdf_b = np.searchsorted(np.sort(b), grid, side="right") / len(b)
    return float(np.abs(cdf_a - cdf_b).max())


def _host_batch(gray: bool = False):
    """DRAWS 2×2 images of seeded colours (or all mid-grey), each with two
    boxes of one label, the second slot of every other image masked."""
    rng = np.random.RandomState(21)
    boxes = np.zeros((DRAWS, 2, 4), np.float32)
    boxes[:, :, :2] = rng.uniform(0.3, 1.7, (DRAWS, 2, 2))
    boxes[:, :, 2:] = rng.uniform(0.2, 0.6, (DRAWS, 2, 2))
    mask = np.ones((DRAWS, 2), bool)
    mask[::2, 1] = False
    images = rng.randint(0, 256, (DRAWS, 2, 2, 3)).astype(np.uint8)
    if gray:
        images[:] = GRAY
    return {"image": images,
            "gt_boxes": boxes,
            "gt_labels": rng.randint(0, 3, (DRAWS, 2)).astype(np.int32),
            "gt_mask": mask}


GRAY = 128


@pytest.mark.parametrize("mosaic,mixup,gray", [
    (0.0, 0.0, False), (0.0, 0.0, True), (0.5, 0.15, False)],
    ids=["flip-jitter", "flip-jitter-grey", "mosaic-mixup-flip-jitter"])
def test_make_device_batch_draws_match_jax(mosaic, mixup, gray):
    """The same host batch of 4000 images through the port's
    ``make_device_batch`` (draws from a seeded ``torch.Generator``) and
    JAX's (draws from a key): every normalised pixel value, the first box
    slot's centre and size, and the labels, are distributed alike (the
    two-sample KS statistic under ``KS_LIMIT``); the share of flipped
    first boxes within 4 standard errors of ½ on both sides (the flip is
    seen in x where a box does not move in y). With mosaic and mixup
    (the ablation's combo cell), the same for their mixtures. On grey
    images contrast, saturation and hue leave a pixel alone, so its value
    over 128/255 is the brightness factor: both sides' factors span the
    same range, their extremes within 1e-3 (4000 uniform draws over 0.4
    leave ~1e-4 at each end). The deterministic cores are held to JAX
    exactly in ``tests/test_torch_transforms.py``: this compares the
    draws."""
    host = _host_batch(gray)
    gen = torch.Generator().manual_seed(31)
    got = pt.make_device_batch(host, gen, "cpu", train=True,
                               mosaic_prob=mosaic, mixup_prob=mixup,
                               pin_memory=False)
    want = jt.make_device_batch({k: np.array(v) for k, v in host.items()},
                                jax.random.key(31), train=True,
                                mosaic_prob=mosaic, mixup_prob=mixup)
    got = {k: v.numpy() for k, v in got.items()}
    want = {k: np.asarray(v) for k, v in want.items()}
    images_g = got["images"].reshape(DRAWS, -1)
    images_w = want["images"].reshape(DRAWS, -1)
    worst = max(_ks(images_g[:, j], images_w[:, j])
                for j in range(images_g.shape[1]))
    assert worst < KS_LIMIT, worst
    for j in range(4):
        stat = _ks(got["gt_boxes"][:, 0, j], want["gt_boxes"][:, 0, j])
        assert stat < KS_LIMIT, (j, stat)
    assert _ks(got["gt_labels"][:, 0], want["gt_labels"][:, 0]) < KS_LIMIT
    assert _ks(got["gt_mask"].sum(1), want["gt_mask"].sum(1)) < KS_LIMIT
    if gray:
        mean, std = pt.IMAGENET_MEAN[0], pt.IMAGENET_STD[0]
        factors = [side["images"][:, 0, 0, 0] * std + mean
                   for side in (got, want)]
        factors = [f / (GRAY / 255.0) for f in factors]
        assert abs(factors[0].min() - factors[1].min()) <= 1e-3
        assert abs(factors[0].max() - factors[1].max()) <= 1e-3
        assert 0.8 - 1e-5 <= factors[1].min() < factors[1].max() <= 1.2 + 1e-5
    if mosaic == mixup == 0.0:
        # a flip moves x to 2 − x and leaves y alone
        se = 4 * (0.25 / DRAWS) ** 0.5
        for side in (got, want):
            flipped = np.isclose(side["gt_boxes"][:, 0, 0],
                                 2.0 - host["gt_boxes"][:, 0, 0])
            assert np.array_equal(side["gt_boxes"][:, 0, 1],
                                  host["gt_boxes"][:, 0, 1])
            assert abs(flipped.mean() - 0.5) <= se
