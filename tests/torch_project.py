"""A tiny COCO-style project on disk for the port's data and trainer tests:
seeded random JPEGs, their annotations, and the parquet the JAX package's
ETL writes from them (the layout ``tests/test_e2e.py`` builds)."""

import json

import numpy as np


def make_project(root, sizes, boxes_per_image=2, seed=1):
    """JPEGs of the given ``(w, h)`` sizes under ``root/images`` and their
    parquet under ``root/parquet/val``; three categories."""
    from PIL import Image

    from custom_yolo_tpu.data.preprocess import DataPreprocess

    ann_dir = root / "annotations"
    img_dir = root / "images"
    ann_dir.mkdir()
    img_dir.mkdir()
    rng = np.random.RandomState(seed)
    images, annotations = [], []
    for i, (w, h) in enumerate(sizes):
        name = f"img_{i:03d}.jpg"
        Image.fromarray((rng.rand(h, w, 3) * 255).astype(np.uint8)).save(
            img_dir / name)
        images.append({"id": i + 1, "file_name": name, "height": h,
                       "width": w})
        for _ in range(boxes_per_image):
            bw = float(rng.randint(w // 6, w // 2))
            bh = float(rng.randint(h // 6, h // 2))
            x = float(rng.randint(0, w - int(bw)))
            y = float(rng.randint(0, h - int(bh)))
            annotations.append({
                "id": len(annotations) + 1, "image_id": i + 1,
                "category_id": int(rng.choice([1, 2, 3])),
                "bbox": [x, y, bw, bh], "area": bw * bh, "iscrowd": 0,
                "segmentation": [[x, y, x + bw, y, x + bw, y + bh]]})
    categories = [{"id": k, "name": n, "supercategory": "s"}
                  for k, n in ((1, "a"), (2, "b"), (3, "c"))]
    with open(ann_dir / "instances_val2017.json", "w") as f:
        json.dump({"images": images, "annotations": annotations,
                   "categories": categories}, f)
    DataPreprocess.create_parquet_data(
        annotations_dir=str(ann_dir), output_dir=str(root / "parquet"),
        output_folder="val", file_names=["instances_val2017.json"],
        keys=["images", "annotations", "categories"],
        columns=[["id", "file_name", "height", "width"],
                 ["id", "image_id", "category_id", "bbox", "area",
                  "iscrowd", "segmentation"],
                 ["id", "name", "supercategory"]],
        chunk_sizes=[100, 100, 100], is_test=False)
    return root


def random_jax_variables(model, hw, seed):
    """Seeded numpy weights in the variable tree of a JAX ``YoloModel``,
    from its shapes alone (``jax.eval_shape`` traces ``init`` without
    compiling it): LeCun-normal kernels, zero biases but the class logits'
    prior, identity BatchNorm."""
    import functools

    import jax
    import jax.numpy as jnp

    from custom_yolo_tpu_torch.models.head import CLS_BIAS

    shapes = jax.eval_shape(functools.partial(model.init, train=False),
                            jax.random.key(0), jnp.zeros((1, hw, hw, 3)))
    rng = np.random.RandomState(seed)

    def fill(path, leaf):
        parent, name = (p.key for p in path[-2:])
        shape = leaf.shape
        if name == "kernel":
            fan_in = int(np.prod(shape[:-1]))
            return (rng.randn(*shape) / np.sqrt(fan_in)).astype(np.float32)
        if name in ("scale", "var"):
            return np.ones(shape, np.float32)
        prior = name == "bias" and parent.startswith("cls") \
            and parent.endswith("_out")
        return np.full(shape, CLS_BIAS if prior else 0.0, np.float32)

    return jax.tree_util.tree_map_with_path(fill, dict(shapes))


def load_script(name, folder="scripts"):
    """The module of ``{folder}/{name}.py``, imported without running its
    ``main`` (a fresh module object on each call, registered in
    ``sys.modules`` so that worker processes can unpickle its functions)."""
    import importlib.util
    import os
    import sys

    path = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), folder, f"{name}.py")
    spec = importlib.util.spec_from_file_location(f"{folder}_{name}", path)
    module = importlib.util.module_from_spec(spec)
    sys.modules[spec.name] = module
    spec.loader.exec_module(module)
    return module


def detection_cases(seed, n=8, num_classes=7):
    """``n`` seeded ``(predictions, targets)`` pairs for
    ``DetectionMetrics.update``, both (k, 5) centre-xywh + class: the
    targets, some of them found again (jittered, a few with another
    class), and some spurious predictions."""
    rng = np.random.RandomState(seed)
    cases = []
    for _ in range(n):
        m = rng.randint(0, 6)
        targets = np.concatenate(
            [rng.uniform(20, 60, (m, 2)), rng.uniform(8, 30, (m, 2)),
             rng.randint(0, num_classes, (m, 1))], axis=1)
        found = targets[rng.rand(m) < 0.7].copy()
        found[:, :4] += rng.normal(0, 2, found[:, :4].shape)
        flip = rng.rand(len(found)) < 0.2
        found[flip, 4] = (found[flip, 4] + 1) % num_classes
        k = rng.randint(0, 3)
        spurious = np.concatenate(
            [rng.uniform(0, 80, (k, 4)), rng.randint(0, num_classes,
                                                      (k, 1))], axis=1)
        cases.append((np.concatenate([found, spurious]).astype(np.float32),
                      targets.astype(np.float32)))
    return cases
