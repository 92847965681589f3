"""The port's on-device augmentation against the JAX package, on the CPU.

The deterministic cores take the same numpy-seeded inputs in both packages
and, for the random functions, JAX's own draws (the keys split as
``custom_yolo_tpu/data/transforms.py`` splits them). The port's own draws,
from ``torch.Generator``s, are held by their distributions. Every tolerance
is stated where it is used.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from custom_yolo_tpu.data import transforms as jt
from custom_yolo_tpu_torch.data import transforms as pt

torch.set_num_threads(2)

N, H, W, G = 4, 48, 64, 6


def _labelled_batch(seed, n=N, h=H, w=W, g=G):
    """uint8 images and padded centre-xywh boxes, some slots masked off."""
    rng = np.random.RandomState(seed)
    images = rng.randint(0, 256, (n, h, w, 3)).astype(np.uint8)
    xy = rng.rand(n, g, 2) * [w, h]
    wh = rng.rand(n, g, 2) * [w / 2, h / 2] + 1.0
    boxes = np.concatenate([xy, wh], -1).astype(np.float32)
    labels = rng.randint(0, 9, (n, g)).astype(np.int32)
    mask = rng.rand(n, g) < 0.7
    boxes[~mask] = 0.0
    return images, boxes, labels, mask


def _jax_draws(key, n, h, w, mosaic_prob=0.0, mixup_prob=0.0,
               augment=True):
    """JAX's draws for ``batch_augment`` (``augment``) or
    ``batch_preprocess``, as the port's :class:`AugmentDraws`."""
    if augment:
        km, kx, kf, kj = jax.random.split(key, 4)
    else:
        kf, kj = jax.random.split(key)
    mosaic_d = mixup_d = None
    if augment and mosaic_prob > 0:
        kp, k1, k2, k3, k4, k5 = jax.random.split(km, 6)
        src = jnp.stack([jnp.arange(n), jax.random.permutation(k1, n),
                         jax.random.permutation(k2, n),
                         jax.random.permutation(k3, n)], axis=1)
        oy = jax.random.randint(k4, (n,), 0, h + 1)
        ox = jax.random.randint(k5, (n,), 0, w + 1)
        apply = jax.random.bernoulli(kp, mosaic_prob, (n,))
        mosaic_d = pt.MosaicDraws(*(torch.from_numpy(np.array(a)).long()
                                    for a in (src, ox, oy)),
                                  torch.from_numpy(np.array(apply)))
    if augment and mixup_prob > 0:
        kp, kperm, klam = jax.random.split(kx, 3)
        perm = jax.random.permutation(kperm, n)
        lam = jax.random.beta(klam, 32.0, 32.0, (n,)).astype(jnp.float32)
        apply = jax.random.bernoulli(kp, mixup_prob, (n,))
        mixup_d = pt.MixupDraws(torch.from_numpy(np.array(perm)).long(),
                                torch.from_numpy(np.array(lam)),
                                torch.from_numpy(np.array(apply)))
    flip = jax.random.bernoulli(kf, 0.5, (n,))
    return pt.AugmentDraws(torch.from_numpy(np.array(flip)),
                           _jax_jitter(kj, n), mosaic_d, mixup_d)


def _jax_jitter(key, n):
    """The four factors of ``color_jitter`` (:55-62), split as it splits."""
    kb, kc, ks, kh = jax.random.split(key, 4)
    fb = jax.random.uniform(kb, (n,), minval=0.8, maxval=1.2)
    fc = jax.random.uniform(kc, (n,), minval=0.8, maxval=1.2)
    fs = jax.random.uniform(ks, (n,), minval=0.8, maxval=1.2)
    fh = jax.random.uniform(kh, (n,), minval=-0.1, maxval=0.1) * 2 * jnp.pi
    return pt.JitterDraws(*(torch.from_numpy(np.array(f))
                            for f in (fb, fc, fs, fh)))


# Colour-jittered images are held to 1e-6 in [0, 1] units, the jitter's own
# output. Normalisation then divides by the ImageNet std (≥ 0.224), so a
# normalised image is held to 1e-6 / 0.224. A tighter limit would test JAX
# against itself: its jitted batch program (÷255 as a multiply by the
# reciprocal, FMA contractions) differs from the same ops run one by one by
# 1.43e-6 after normalisation on these inputs.
NORMALISED_ATOL = 1e-6 / 0.224


def _t(*arrays):
    return [torch.from_numpy(np.array(a)) for a in arrays]


# ------------------------------------------------------- deterministic cores
MOSAIC_CASES = {
    # offsets at both ends of [0, H] and [0, W], and inside
    "corners": ([[0, 1, 2, 3], [1, 1, 0, 2], [3, 2, 1, 0], [2, 0, 3, 1]],
                [0, W, 0, 17], [0, H, 31, H]),
    "inside": ([[0, 3, 3, 3], [1, 0, 2, 2], [2, 1, 0, 0], [3, 2, 1, 0]],
               [5, 40, 63, 1], [12, 1, 47, 24]),
}


@pytest.mark.parametrize("case", sorted(MOSAIC_CASES))
def test_mosaic_compose_matches_jax_exactly(case):
    images_u8, boxes, labels, mask = _labelled_batch(3)
    # a box whose window cut leaves 1.5 px: dropped (sides ≤ 2 px)
    boxes[0, 0] = [W - 0.75, 20.0, 3.0, 10.0]
    mask[0, 0] = True
    images = images_u8.astype(np.float32) / 255.0
    src, ox, oy = (np.asarray(a) for a in MOSAIC_CASES[case])
    want = jt.mosaic_compose(*(jnp.asarray(a) for a in (
        images, boxes, labels, mask)), jnp.asarray(src, jnp.int32),
        jnp.asarray(ox, jnp.int32), jnp.asarray(oy, jnp.int32))
    got = pt.mosaic_compose(*_t(images, boxes, labels, mask),
                            *(torch.from_numpy(a).long()
                              for a in (src, ox, oy)))
    for name, g, w in zip(("image", "boxes", "labels", "mask"), got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w),
                                      err_msg=name)
    assert got[3].sum() > 0
    if case == "corners":
        # image 0 keeps its own top-left quadrant; the thin box is gone
        np.testing.assert_array_equal(got[0][0].numpy(), images[0])
        assert not any(np.allclose(b, [W - 0.375, 20.0, 0.75, 10.0])
                       for b in got[1][0].numpy())


def test_mixup_compose_matches_jax():
    """Boxes, labels and mask bit for bit; the blend within 1 fp32 ulp."""
    images_u8, boxes, labels, mask = _labelled_batch(4)
    images = images_u8.astype(np.float32) / 255.0
    perm = np.asarray([2, 0, 3, 1])
    lam = np.asarray([0.5, 0.31, 0.77, 0.0625], np.float32)
    want = jt.mixup_compose(*(jnp.asarray(a) for a in (
        images, boxes, labels, mask)), jnp.asarray(perm), jnp.asarray(lam))
    got = pt.mixup_compose(*_t(images, boxes, labels, mask),
                           torch.from_numpy(perm), torch.from_numpy(lam))
    for name, g, w in zip(("boxes", "labels", "mask"), got[1:], want[1:]):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w),
                                      err_msg=name)
    w_img = np.asarray(want[0])
    ulp = np.spacing(np.abs(w_img).astype(np.float32))
    assert np.all(np.abs(got[0].numpy() - w_img) <= ulp)


def test_horizontal_flip_matches_jax_exactly():
    images_u8, boxes, _, _ = _labelled_batch(5)
    images = images_u8.astype(np.float32) / 255.0
    # JAX draws its mask inside, from the key as given
    key = jax.random.key(1)
    flip = np.asarray(jax.random.bernoulli(key, 0.5, (N,)))
    assert flip.any() and not flip.all()
    want = jt.horizontal_flip(jnp.asarray(images), jnp.asarray(boxes), key)
    got = pt.horizontal_flip(*_t(images, boxes, flip))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_color_jitter_matches_jax():
    """The apply given JAX's factors, within 1e-6 (JAX forms the hue
    matrices and the mean grey in fp32, the port in float64)."""
    images = np.random.RandomState(6).rand(N, H, W, 3).astype(np.float32)
    key = jax.random.key(7)
    want = jt.color_jitter(jnp.asarray(images), key)
    got = pt.color_jitter(torch.from_numpy(images), _jax_jitter(key, N))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6,
                               rtol=0)


def test_hue_rotation_matches_jax():
    theta = np.linspace(-0.2 * math.pi, 0.2 * math.pi, 9).astype(np.float32)
    want = jax.vmap(jt._hue_rotation_matrix)(jnp.asarray(theta))
    got = pt.hue_rotation_matrices(torch.from_numpy(theta),
                                   pt.constants(torch.device("cpu")).hue_basis)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=5e-7,
                               rtol=0)


@pytest.mark.parametrize("train", [True, False], ids=["train", "eval"])
def test_batch_preprocess_matches_jax(train):
    """Fed JAX's draws: images within ``NORMALISED_ATOL``; the boxes
    (flipped or not) exactly."""
    images, boxes, _, _ = _labelled_batch(8)
    key = jax.random.key(9)
    want = jt.batch_preprocess(jnp.asarray(images), jnp.asarray(boxes), key,
                               train=train)
    draws = _jax_draws(key, N, H, W, augment=False) if train else None
    got = pt.batch_preprocess(*_t(images, boxes), train=train, draws=draws)
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]),
                               atol=NORMALISED_ATOL, rtol=0)
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    if not train:
        # ÷255 exactly as the serving path's normalize_uint8
        from custom_yolo_tpu_torch.models.detector import (IMAGENET_MEAN,
                                                           IMAGENET_STD,
                                                           normalize_uint8)
        assert torch.equal(got[0], normalize_uint8(
            torch.from_numpy(images), torch.from_numpy(IMAGENET_MEAN),
            torch.from_numpy(IMAGENET_STD)))


def test_batch_augment_matches_jax():
    """mosaic = mixup = 1, fed JAX's draws: boxes, labels and mask exactly,
    images within ``NORMALISED_ATOL``."""
    images, boxes, labels, mask = _labelled_batch(10)
    key = jax.random.key(11)
    want = jt.batch_augment(*(jnp.asarray(a) for a in (
        images, boxes, labels, mask)), key, train=True, mosaic_prob=1.0,
        mixup_prob=1.0)
    draws = _jax_draws(key, N, H, W, 1.0, 1.0)
    assert draws.mosaic.apply.all() and draws.mixup.apply.all()
    got = pt.batch_augment(*_t(images, boxes, labels, mask), draws=draws)
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]),
                               atol=NORMALISED_ATOL, rtol=0)
    for name, g, w in zip(("boxes", "labels", "mask"), got[1:], want[1:]):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w),
                                      err_msg=name)


@pytest.mark.parametrize("src", [(30, 20), (100, 90)], ids=["up", "down"])
def test_letterbox_resize_matches_jax(src):
    """Within 1e-5, the tolerance of the serving path's resize
    (tests/test_torch_serve.py::test_preprocess_resize_matches_jax)."""
    image = np.random.RandomState(12).rand(*src, 3).astype(np.float32)
    want, scale_j, pad_j = jt.letterbox_resize(jnp.asarray(image), (64, 64))
    got, scale, pad = pt.letterbox_resize(torch.from_numpy(image), (64, 64))
    assert scale == scale_j and pad == tuple(int(p) for p in pad_j)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                               rtol=0)


# ----------------------------------------------------------- the port's draws
def test_draws_follow_their_distributions():
    """Over many draws from one generator: flip rate ½, jitter factors in
    their ranges, hue within ±0.1·2π; permutations valid, crop offsets in
    [0, H] and [0, W] reaching both ends; Beta(32, 32) mean ½ and variance
    1/260; apply rates at their probability. Limits are ~5 standard
    errors."""
    gen = torch.Generator().manual_seed(13)
    n = 20000
    flip = pt.draw_flip(n, gen).float()
    assert abs(flip.mean().item() - 0.5) < 0.02
    jit = pt.draw_color_jitter(n, gen)
    for f in jit[:3]:
        assert 0.8 <= f.min().item() and f.max().item() < 1.2
        assert abs(f.mean().item() - 1.0) < 0.005
    assert jit.hue.abs().max().item() <= 0.1 * 2 * math.pi
    assert jit.hue.min().item() < -0.6 and jit.hue.max().item() > 0.6
    mos = pt.draw_mosaic(8, 10, 12, 0.3, gen)
    for j in range(1, 4):
        assert torch.equal(mos.src_idx[:, j].sort().values, torch.arange(8))
    assert torch.equal(mos.src_idx[:, 0], torch.arange(8))
    offsets = [pt.draw_mosaic(64, 10, 12, 0.3, gen) for _ in range(20)]
    oy = torch.cat([m.oy for m in offsets])
    ox = torch.cat([m.ox for m in offsets])
    assert oy.min() == 0 and oy.max() == 10 and ox.min() == 0 \
        and ox.max() == 12
    applied = torch.cat([m.apply for m in offsets]).float().mean().item()
    assert abs(applied - 0.3) < 0.03
    lam = pt.draw_beta(32.0, 32.0, n, gen).double()
    assert abs(lam.mean().item() - 0.5) < 0.01
    assert abs(lam.var().item() - 1 / 260) < 0.1 / 260
    mix = pt.draw_mixup(n, 0.25, gen)
    assert torch.equal(mix.perm.sort().values, torch.arange(n))
    assert abs(mix.apply.float().mean().item() - 0.25) < 0.02
    with pytest.raises(ValueError, match="alpha"):
        pt.draw_beta(0.5, 0.5, 4, gen)


def test_same_seed_gives_the_same_batch():
    images, boxes, labels, mask = _labelled_batch(14)
    host = {"image": images, "gt_boxes": boxes, "gt_labels": labels,
            "gt_mask": mask}
    cpu = torch.device("cpu")
    runs = [pt.make_device_batch(host, torch.Generator().manual_seed(15),
                                 cpu, train=True, mosaic_prob=0.5,
                                 mixup_prob=0.5) for _ in range(2)]
    assert set(runs[0]) == {"images", "gt_boxes", "gt_labels", "gt_mask"}
    for key in runs[0]:
        assert torch.equal(runs[0][key], runs[1][key]), key
    other = pt.make_device_batch(host, torch.Generator().manual_seed(16),
                                 cpu, train=True, mosaic_prob=0.5,
                                 mixup_prob=0.5)
    assert not torch.equal(runs[0]["images"], other["images"])
    assert runs[0]["images"].dtype == torch.float32
    assert runs[0]["gt_labels"].dtype == torch.int32
    # without mosaic and mixup the labels and mask pass through
    plain = pt.make_device_batch(host, torch.Generator().manual_seed(15),
                                 cpu, train=True)
    np.testing.assert_array_equal(plain["gt_mask"].numpy(), mask)
    evaluation = pt.make_device_batch(host, None, cpu, train=False)
    np.testing.assert_array_equal(evaluation["gt_boxes"].numpy(), boxes)
