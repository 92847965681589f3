"""The port's offline ETL against the JAX package's, on the CPU: RLE
decoding, the streamed JSON reader, ``DataPreprocess.create_parquet_data``
(polygons, compressed and uncompressed RLE, crowd rows, a two-file merge,
sharding by ``images_per_shard``), ``category_mapping``, and the fixture
and preprocessing scripts. The same COCO JSON goes through both packages;
their Parquet must be equal frame for frame."""

import glob
import json
import os
import subprocess
import sys

import numpy as np
import pandas as pd
import pytest
import torch

from custom_yolo_tpu.data import coco_rle as jax_rle
from custom_yolo_tpu.data import preprocess as jax_pre
from custom_yolo_tpu_torch.config import Config
from custom_yolo_tpu_torch.data import coco_rle, preprocess

from test_data import (_compress_counts, _rle_encode_counts, _vmhwm_mb_of,
                       _write_synthetic_coco)

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
KEYS = ["images", "annotations", "categories"]
COLUMNS = [["id", "file_name", "height", "width"],
           ["id", "image_id", "category_id", "bbox", "area", "iscrowd",
            "segmentation"],
           ["id", "name", "supercategory"]]


def _blob_mask(rng, h, w):
    """A mask of one or two filled rectangles (contours of a known shape)."""
    mask = np.zeros((h, w), np.uint8)
    for _ in range(int(rng.randint(1, 3))):
        y0, x0 = int(rng.randint(0, h - 6)), int(rng.randint(0, w - 6))
        dy, dx = int(rng.randint(3, 7)), int(rng.randint(3, 7))
        mask[y0:y0 + dy, x0:x0 + dx] = 1
    return mask


def coco_doc(n_images, seed, cat_ids=(7, 11, 42), names=("zebra", "apple",
                                                          "car")):
    """A COCO document whose annotations cycle through a polygon, an
    uncompressed RLE, a compressed RLE and a crowd RLE, with an
    annotation of an unknown image and a repeated image entry."""
    rng = np.random.RandomState(seed)
    images, annotations = [], []
    for i in range(n_images):
        h, w = int(rng.randint(24, 40)), int(rng.randint(24, 40))
        images.append({"id": i + 1, "file_name": f"img_{i:03d}.jpg",
                       "height": h, "width": w})
        for k in range(int(rng.randint(1, 5))):
            kind = (i + k) % 4
            mask = _blob_mask(rng, h, w)
            counts = _rle_encode_counts(mask.T.flatten())
            if kind == 0:
                seg = [[float(v) for v in rng.randint(0, 20, 8)]]
            elif kind == 1:
                seg = {"counts": counts, "size": [h, w]}
            else:
                seg = {"counts": _compress_counts(counts), "size": [h, w]}
            x, y = float(rng.randint(0, w // 2)), float(rng.randint(0, h // 2))
            annotations.append({
                "id": len(annotations) + 1, "image_id": i + 1,
                "category_id": int(rng.choice(cat_ids)),
                "bbox": [x, y, float(rng.randint(2, w // 2)),
                         float(rng.randint(2, h // 2))],
                "area": float(mask.sum()), "iscrowd": int(kind == 3),
                "segmentation": seg})
    images.append(dict(images[0]))
    annotations.append({"id": 10_000, "image_id": 9_999, "category_id":
                        cat_ids[0], "bbox": [0.0, 0.0, 1.0, 1.0],
                        "area": 1.0, "iscrowd": 0,
                        "segmentation": [[0.0, 0.0, 1.0, 1.0, 1.0, 0.0]]})
    categories = [{"id": c, "name": n, "supercategory": f"s{c}"}
                  for c, n in zip(cat_ids, names)]
    return {"info": {}, "images": images, "annotations": annotations,
            "categories": categories}


def _etl(module, ann_dir, out_dir, file_names, **kw):
    module.DataPreprocess.create_parquet_data(
        annotations_dir=str(ann_dir), output_dir=str(out_dir),
        output_folder="val", file_names=file_names, keys=KEYS,
        columns=COLUMNS, chunk_sizes=[5, 7, 2], is_test=False, **kw)
    return sorted(glob.glob(str(out_dir / "val" / "*.parquet")))


def assert_parquet_equal(got_files, want_files):
    assert [os.path.basename(f) for f in got_files] == \
        [os.path.basename(f) for f in want_files]
    assert want_files
    for got, want in zip(got_files, want_files):
        pd.testing.assert_frame_equal(pd.read_parquet(got),
                                      pd.read_parquet(want))


# ------------------------------------------------------------------ RLE
@pytest.mark.parametrize("compressed", [False, True],
                         ids=["uncompressed", "compressed"])
def test_rle_decode_matches_jax(compressed):
    rng = np.random.RandomState(3)
    mask = (rng.rand(23, 17) > 0.6).astype(np.uint8)
    counts = _rle_encode_counts(mask.T.flatten())
    rle = {"counts": _compress_counts(counts) if compressed else counts,
           "size": [23, 17]}
    got = coco_rle.rle_decode(rle)
    np.testing.assert_array_equal(got, mask)
    np.testing.assert_array_equal(got, jax_rle.rle_decode(rle))
    assert coco_rle.decode_rle_counts(rle["counts"]) == \
        jax_rle.decode_rle_counts(rle["counts"])


def test_rle_to_polygons_matches_jax():
    mask = _blob_mask(np.random.RandomState(4), 30, 30)
    rle = {"counts": _rle_encode_counts(mask.T.flatten()), "size": [30, 30]}
    got = coco_rle.rle_to_polygons(rle)
    assert got and got == jax_rle.rle_to_polygons(rle)


# --------------------------------------------------------- JSON stream
@pytest.mark.parametrize("key,buf_size", [("images", 7), ("annotations", 5),
                                          ("categories", 1 << 22)])
def test_stream_json_items_matches_jax_with_a_tiny_buffer(tmp_path, key,
                                                          buf_size):
    doc = coco_doc(6, seed=5)
    path = tmp_path / "doc.json"
    path.write_text(json.dumps(doc, indent=1))
    got = list(preprocess.stream_json_items(str(path), key,
                                            buf_size=buf_size))
    assert got == doc[key]
    assert got == list(jax_pre.stream_json_items(str(path), key,
                                                 buf_size=buf_size))
    limited = list(preprocess.stream_json_items(str(path), key,
                                                is_test=True, test_limit=2))
    assert limited == doc[key][:3]


# ----------------------------------------------------------------- ETL
def test_parquet_matches_jax_with_rle_and_crowd_rows(tmp_path):
    ann = tmp_path / "ann"
    ann.mkdir()
    (ann / "instances_val2017.json").write_text(json.dumps(coco_doc(9, 6)))
    files = ["instances_val2017.json"]
    got = _etl(preprocess, ann, tmp_path / "port", files)
    want = _etl(jax_pre, ann, tmp_path / "jax", files)
    assert_parquet_equal(got, want)
    df = pd.read_parquet(got[0])
    assert len(df) == 9
    assert list(df.columns) == preprocess.PARQUET_SCHEMA.names
    segs = [s for row in df["segmentation"] for s in row]
    crowd = [c for row in df["iscrowd"] for c in row]
    # RLE rows became polygons, crowd rows empty lists
    assert any(len(s) for s, c in zip(segs, crowd) if c == 0)
    assert all(len(s) == 0 for s, c in zip(segs, crowd) if c == 1)
    assert 1 in crowd


def test_parquet_matches_jax_on_a_two_file_merge(tmp_path):
    ann = tmp_path / "ann"
    ann.mkdir()
    (ann / "instances_val2017.json").write_text(json.dumps(coco_doc(5, 7)))
    (ann / "stuff_val2017.json").write_text(json.dumps(coco_doc(
        5, 8, cat_ids=(93, 94), names=("grass", "wall"))))
    files = ["instances_val2017.json", "stuff_val2017.json"]
    got = _etl(preprocess, ann, tmp_path / "port", files)
    assert_parquet_equal(got, _etl(jax_pre, ann, tmp_path / "jax", files))
    names = {n: c for _, row in pd.read_parquet(got[0]).iterrows()
             for n, c in zip(row["name"], row["category_id"])}
    assert names == {"apple": 0, "car": 1, "grass": 2, "wall": 3,
                     "zebra": 4}
    pd.testing.assert_frame_equal(
        preprocess.DataPreprocess.category_mapping(str(ann), files),
        jax_pre.DataPreprocess.category_mapping(str(ann), files))


def test_sharded_parquet_matches_jax(tmp_path):
    ann = tmp_path / "ann"
    ann.mkdir()
    (ann / "instances_val2017.json").write_text(json.dumps(coco_doc(23, 9)))
    files = ["instances_val2017.json"]
    got = _etl(preprocess, ann, tmp_path / "port", files,
               images_per_shard=6)
    assert len(got) == 4                                   # ceil(23 / 6)
    assert_parquet_equal(got, _etl(jax_pre, ann, tmp_path / "jax", files,
                                   images_per_shard=6))
    assert not os.path.exists(tmp_path / "port" / "val" / "_spill")
    single = _etl(preprocess, ann, tmp_path / "one", files)
    pd.testing.assert_frame_equal(
        pd.concat(map(pd.read_parquet, got)).sort_values(
            "id", ignore_index=True),
        pd.read_parquet(single[0]).sort_values("id", ignore_index=True))


# ------------------------------------------------------------- scripts
def test_fixture_script_matches_jax_byte_for_byte(tmp_path):
    """``torch_make_fixture.py`` and ``make_fixture.py`` at one seed write
    the same images and annotation JSON; the port's Parquet equals the JAX
    ETL's frame for frame."""
    args = ["--images", "5", "--size", "64", "--seed", "2", "--classes", "3"]
    env = {**os.environ, "JAX_PLATFORMS": "cpu", "OMP_NUM_THREADS": "2"}
    for script, root in (("make_fixture.py", "jax"),
                         ("torch_make_fixture.py", "port")):
        r = subprocess.run(
            [sys.executable, os.path.join(REPO, "scripts", script),
             "--root", str(tmp_path / root)] + args,
            capture_output=True, text=True, env=env, timeout=300)
        assert r.returncode == 0, r.stderr[-3000:]
    jax_raw = tmp_path / "jax" / "raw"
    raw = sorted(os.path.relpath(p, jax_raw) for p in glob.glob(
        str(jax_raw / "**" / "*"), recursive=True) if os.path.isfile(p))
    assert len(raw) == 5 + 4 + 4       # train and val JPEGs, four JSONs
    for rel in raw:
        assert (tmp_path / "port" / "raw" / rel).read_bytes() == \
            (tmp_path / "jax" / "raw" / rel).read_bytes(), rel
    for split in ("train", "val"):
        assert_parquet_equal(
            sorted(glob.glob(str(tmp_path / "port" / "processed" / "parquet"
                                 / split / "*.parquet"))),
            sorted(glob.glob(str(tmp_path / "jax" / "processed" / "parquet"
                                 / split / "*.parquet"))))


def test_data_preprocess_script_writes_the_jax_parquet(tmp_path):
    """``torch_data_preprocess.py --mode val`` reads the config's
    annotation directory (instances + stuff) and writes what the JAX
    package's ETL writes from it."""
    ann = tmp_path / "ann"
    ann.mkdir()
    (ann / "instances_val2017.json").write_text(json.dumps(coco_doc(4, 10)))
    (ann / "stuff_val2017.json").write_text(json.dumps(
        {"images": [], "annotations": [], "categories": []}))
    cfg = Config()
    cfg.data.annotations_dir = str(ann)
    cfg.data.processed_dir = str(tmp_path / "port")
    cfg.save(str(tmp_path / "cfg.yaml"))
    r = subprocess.run(
        [sys.executable, os.path.join(REPO, "scripts",
                                      "torch_data_preprocess.py"),
         "--mode", "val", "--config", str(tmp_path / "cfg.yaml")],
        capture_output=True, text=True, timeout=300,
        env={**os.environ, "OMP_NUM_THREADS": "2"})
    assert r.returncode == 0, r.stderr[-3000:]
    jax_pre.DataPreprocess.create_parquet_data(
        annotations_dir=str(ann), output_dir=str(tmp_path / "jax"),
        output_folder="val",
        file_names=["instances_val2017.json", "stuff_val2017.json"],
        keys=KEYS, columns=COLUMNS, chunk_sizes=[10_000, 50_000, 1_000],
        is_test=False)
    assert_parquet_equal(
        sorted(glob.glob(str(tmp_path / "port" / "val" / "*.parquet"))),
        sorted(glob.glob(str(tmp_path / "jax" / "val" / "*.parquet"))))


def test_port_etl_imports_no_jax():
    """The ETL modules, the new utilities and the four scripts import with
    JAX, flax and the JAX package unavailable, and with pandas, pyarrow,
    cv2 and matplotlib unavailable until a function needs them."""
    code = (
        "import importlib.util, sys\n"
        "for name in ('jax', 'flax', 'custom_yolo_tpu', 'pandas', 'pyarrow',\n"
        "             'cv2', 'matplotlib'):\n"
        "    sys.modules[name] = None\n"
        "for name in ('data.preprocess', 'data.coco_rle', 'utils.profiling',\n"
        "             'utils.visualization', 'utils.checkpoint'):\n"
        "    importlib.import_module('custom_yolo_tpu_torch.' + name)\n"
        "sys.modules['pandas'] = sys.modules['pyarrow'] = None\n"
        "for script in ('torch_make_fixture', 'torch_evaluate',\n"
        "               'torch_serve'):\n"
        "    spec = importlib.util.spec_from_file_location(\n"
        "        script, f'scripts/{script}.py')\n"
        "    spec.loader.exec_module(importlib.util.module_from_spec(spec))\n"
        "print('ok')\n")
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr[-3000:]
    assert r.stdout.strip() == "ok"


def test_etl_memory_bounded_at_scale(tmp_path):
    """The port's counterpart of ``tests/test_data.py::
    test_etl_memory_bounded_at_scale``: ~150k annotations through
    ``create_parquet_data`` in a fresh interpreter, whose peak resident
    memory (VmHWM) over a control interpreter that only does the imports
    stays under the JAX test's bound, 120 MB + twice the JSON's size; six
    shards of 5,000 images hold all 30,000 rows."""
    ann = tmp_path / "ann"
    ann.mkdir()
    n = _write_synthetic_coco(str(ann / "instances_val2017.json"),
                              30_000, 5)
    assert n == 150_000
    json_mb = os.path.getsize(ann / "instances_val2017.json") / 1e6
    imports = f"""
import sys
sys.path.insert(0, {REPO!r})
from custom_yolo_tpu_torch.data.preprocess import DataPreprocess
import pandas, pyarrow, pyarrow.parquet
"""
    work = imports + f"""
DataPreprocess.create_parquet_data(
    annotations_dir={str(ann)!r}, output_dir={str(tmp_path / 'out')!r},
    output_folder="val", file_names=["instances_val2017.json"],
    keys={KEYS!r}, columns={COLUMNS!r},
    chunk_sizes=[10000, 10000, 10000], is_test=False,
    images_per_shard=5000)
"""
    control_mb = _vmhwm_mb_of(imports)
    work_mb = _vmhwm_mb_of(work)
    assert work_mb - control_mb < 120 + 2 * json_mb, (work_mb, control_mb,
                                                      json_mb)
    shards = glob.glob(str(tmp_path / "out" / "val" / "*.parquet"))
    assert len(shards) == 6
    assert sum(len(pd.read_parquet(s)) for s in shards) == 30_000
