"""``scripts/torch_soak.py`` against ``scripts/soak.py`` on the CPU, each
phase run in-process at a small size: ``gen`` writes the same JSON and
JPEG bytes, ``etl`` the same parquet rows, ``eval`` the same COCO mAP
(within 1e-4: both evaluators run the same numpy protocol); ``loader``
and ``train`` run the port's loader and trainer on that data; two
``fit_chunk`` runs on a copy of ``configs/soak_coco_scale.yaml`` (the n
preset at 64², batches of 4, its data and checkpoint paths moved) resume
one another. No peak-RSS bound here: the parallel test run's memory
load would make it flaky."""

import filecmp
import json
import math
import os

import jax
import pandas as pd
import pytest
import torch
import yaml

from custom_yolo_tpu.eval import coco_map as jax_coco_map
from custom_yolo_tpu_torch import PRESETS
from custom_yolo_tpu_torch.eval import coco_map

from torch_project import load_script

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TRAIN_IMAGES, VAL_IMAGES, WORKERS = 12, 4, 2
EVAL_IMAGES = 200
HW = 64
TRAIN_KEYS = {"steps", "batch", "wall_s", "img_per_s", "losses_per_100",
              "peak_rss_mb"}


@pytest.fixture(scope="module")
def soak():
    return load_script("torch_soak")


@pytest.fixture(scope="module")
def jax_soak():
    return load_script("soak")


@pytest.fixture(scope="module")
def roots(tmp_path_factory, soak, jax_soak):
    """The port's and the JAX script's ``gen`` then ``etl`` output."""
    port = tmp_path_factory.mktemp("soak_port")
    ref = tmp_path_factory.mktemp("soak_jax")
    stats = {"gen": soak.phase_gen(str(port), TRAIN_IMAGES, VAL_IMAGES,
                                   WORKERS),
             "etl": soak.phase_etl(str(port))}
    jax_stats = {"gen": jax_soak.phase_gen(str(ref), TRAIN_IMAGES,
                                           VAL_IMAGES, WORKERS)}
    jax_soak.phase_etl(str(ref))
    return port, ref, stats, jax_stats


def test_gen_writes_the_jax_scripts_files(roots):
    port, ref, stats, jax_stats = roots
    for split, n in (("train", TRAIN_IMAGES), ("val", VAL_IMAGES)):
        assert stats["gen"][split]["images"] == n
        assert stats["gen"][split]["annotations"] == \
            jax_stats["gen"][split]["annotations"] > n
    names = []
    for folder in ("raw/annotations", "raw/images/train", "raw/images/val"):
        files = sorted(os.listdir(port / folder))
        assert files == sorted(os.listdir(ref / folder)) and files
        names += [os.path.join(folder, f) for f in files]
    assert len(names) == 4 + TRAIN_IMAGES + VAL_IMAGES
    match, mismatch, errors = filecmp.cmpfiles(port, ref, names,
                                               shallow=False)
    assert not mismatch and not errors and len(match) == len(names)


def test_etl_writes_the_jax_scripts_parquet(roots):
    port, ref, stats, _ = roots
    assert set(stats["etl"]) == {"train", "val"}
    for split in ("train", "val"):
        folder = os.path.join("processed", "parquet", split)
        files = sorted(os.listdir(port / folder))
        assert files == sorted(os.listdir(ref / folder)) == [
            f"{split}-0.parquet"]
        got = pd.read_parquet(port / folder / files[0])
        want = pd.read_parquet(ref / folder / files[0])
        assert len(got) == (TRAIN_IMAGES if split == "train"
                            else VAL_IMAGES)
        pd.testing.assert_frame_equal(got, want)


def test_eval_matches_the_jax_scripts_map(soak, jax_soak, monkeypatch):
    """The JAX phase scores 5,000 images; its evaluator keeps the first
    200 here, the images the port's phase draws at ``n_images=200``."""
    scores = {}

    class FirstImages(jax_coco_map.COCOmAP):
        def update(self, *args, **kwargs):
            self.seen = getattr(self, "seen", 0) + 1
            if self.seen <= EVAL_IMAGES:
                super().update(*args, **kwargs)

        def compute(self):
            scores["jax"] = super().compute()
            return scores["jax"]

    compute = coco_map.COCOmAP.compute

    def port_compute(self):
        scores["port"] = compute(self)
        return scores["port"]

    cache_dir = jax.config.jax_compilation_cache_dir
    monkeypatch.setattr(jax_coco_map, "COCOmAP", FirstImages)
    monkeypatch.setattr(coco_map.COCOmAP, "compute", port_compute)
    try:
        jax_soak.phase_eval("unused", 16, WORKERS)
    finally:
        jax.config.update("jax_compilation_cache_dir", cache_dir)
    got = soak.phase_eval("unused", 16, WORKERS, n_images=EVAL_IMAGES)
    assert got["images"] == EVAL_IMAGES and got["classes"] == 172
    assert 0 < scores["port"]["mAP_50_95"] < 1
    assert abs(scores["port"]["mAP_50_95"]
               - scores["jax"]["mAP_50_95"]) <= 1e-4
    assert got["map_50_95"] == round(float(scores["port"]["mAP_50_95"]), 4)


def test_loader_and_train_run_on_the_generated_data(roots, soak, capsys):
    port = str(roots[0])
    loader = soak.phase_loader(port, 4, WORKERS, n_batches=4, input_size=HW)
    assert loader["images"] == 16 and loader["dataset_len"] == TRAIN_IMAGES
    # 12 images make 3 batches of 4: the fourth step restarts the loader
    stats = soak.phase_train(port, 4, WORKERS, 4, preset="n",
                             input_size=HW, device="cpu")
    assert set(stats) == TRAIN_KEYS
    assert stats["steps"] == 4 and stats["losses_per_100"] == []
    assert stats["img_per_s"] > 0
    assert "[train] {" in capsys.readouterr().out


def fit_config(tmp_path, root):
    with open(os.path.join(REPO, "configs", "soak_coco_scale.yaml")) as f:
        raw = yaml.safe_load(f)
    assert raw["project"]["device"] == "tpu"
    assert raw["model"]["pallas_attention"] is True
    n = PRESETS["n"]
    raw["model"]["config"] = {k: n[k] for k in ("csp", "depth", "width")}
    raw["model"]["input_size"] = [HW, HW]
    raw["training"]["batch_size"] = 4
    raw["data"].update(
        processed_dir=os.path.join(root, "processed", "parquet"),
        train_images=os.path.join(root, "raw", "images", "train"),
        val_images=os.path.join(root, "raw", "images", "val"),
        num_workers=WORKERS)
    raw["checkpoint"]["checkpoint_dir"] = str(tmp_path / "ckpt")
    path = tmp_path / "soak.yaml"
    path.write_text(yaml.safe_dump(raw))
    return str(path)


def test_fit_chunks_resume_each_other(roots, soak, tmp_path, capsys):
    cfg = fit_config(tmp_path, str(roots[0]))
    first = soak.phase_fit_chunk(2, cfg, device="cpu")
    second = soak.phase_fit_chunk(2, cfg, device="cpu")
    assert (first["chunk"], first["global_step"]) == (0, 2)
    assert (second["chunk"], second["global_step"]) == (1, 4)
    assert second["images_seen"] == 4 * second["batch"] == 16
    assert all(math.isfinite(s["final_loss"]) for s in (first, second))
    assert "[fit] resumed chunk 0 (global step 2)" in \
        capsys.readouterr().out
    assert sorted(os.listdir(tmp_path / "ckpt")) == [
        "model_epoch_0", "model_epoch_1"]


def test_main_resumes_its_results(roots, soak, tmp_path):
    """``main`` adds each phase's stats to the ``--out`` JSON it finds."""
    out = tmp_path / "stats.json"
    out.write_text(json.dumps({"gen": {"kept": True}}))
    results = soak.main(["--root", str(roots[0]), "--phases", "etl",
                         "--out", str(out), "--device", "cpu"])
    assert results["gen"] == {"kept": True} and set(results["etl"]) == {
        "train", "val"}
    assert json.loads(out.read_text()) == results
