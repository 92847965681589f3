"""The port's configuration, dataset, loader and native decoder against the
JAX package, on the CPU: every shipped YAML parses to the same dict, the
same invalid configs raise, and both loaders yield the same batches bit for
bit over one fixture."""

import glob
import os

import numpy as np
import pytest
import torch

from custom_yolo_tpu import config as jax_config
from custom_yolo_tpu.data.dataset import DetectionDataset as JaxDataset
from custom_yolo_tpu.data.loader import DataLoader as JaxLoader
from custom_yolo_tpu_torch import config as port_config
from custom_yolo_tpu_torch.data.dataset import DetectionDataset
from custom_yolo_tpu_torch.data.loader import DataLoader
from torch_project import make_project

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIGS = sorted(glob.glob(os.path.join(REPO, "configs", "*.yaml")))
# seven images of mixed aspect (letterbox pads them differently), batches
# of 3: two full batches and a ragged one
SIZES = [(96, 96), (120, 80), (80, 120), (64, 96), (100, 70), (96, 96),
         (72, 90)]
BATCH = 3
INPUT = (64, 64)


@pytest.fixture(scope="module")
def project(tmp_path_factory):
    return make_project(tmp_path_factory.mktemp("proj"), SIZES)


# ------------------------------------------------------------------ config
@pytest.mark.parametrize("path", CONFIGS, ids=os.path.basename)
def test_config_from_yaml_matches_jax(path):
    port = port_config.Config.from_yaml(path)
    want = jax_config.Config.from_yaml(path).to_dict()
    assert port.to_dict() == want


def test_config_save_round_trip(tmp_path):
    cfg = port_config.Config.from_dict({
        "project": {"seed": 3, "distributed": False,
                    "mixed_precision": False},
        "model": {"config": {"csp": [False, True],
                             "depth": [1, 1, 1, 1, 1, 1],
                             "width": [3, 8, 16, 32, 64, 64]}},
        "training": {"ddp": {"precision": "bfloat16"},
                     "weights": {"cls_loss": 2.0, "bbox_loss": 3.0}},
        "legacy_section": {"x": 1}})
    path = tmp_path / "cfg.yaml"
    cfg.save(str(path))
    again = port_config.Config.from_yaml(str(path))
    # YAML has no tuples: input_size comes back a list, as in the JAX package
    assert again.model.input_size == [640, 640]
    again.model.input_size = tuple(again.model.input_size)
    assert again.to_dict() == cfg.to_dict()
    assert cfg.training.sharding.mode == "single"
    assert cfg.training.sharding.precision == "float32"
    assert cfg.training.lambda_box == 3.0
    assert port_config.load_config(str(path))["project"]["seed"] == 3
    assert port_config.Config.from_yaml(str(path)).to_dict() == \
        jax_config.Config.from_yaml(str(path)).to_dict()


INVALID = {
    "width": {"model": {"width": [3, 8, 16, 32, 64]}},
    "depth": {"model": {"depth": [1, 1]}},
    "csp": {"model": {"csp": [True]}},
    "mode": {"training": {"sharding": {"mode": "tp"}}},
    "assigner": {"training": {"assigner": "simota"}},
    "best_model_mode": {"checkpoint": {"best_model_mode": "median"}},
}


@pytest.mark.parametrize("case", sorted(INVALID))
def test_config_validate_raises_as_jax(case):
    raw = INVALID[case]
    with pytest.raises(ValueError) as want:
        jax_config.Config.from_dict(raw)
    with pytest.raises(ValueError) as got:
        port_config.Config.from_dict(raw)
    assert str(got.value) == str(want.value)


# ---------------------------------------------------------- dataset, loader
def _assert_batches_equal(port_loader, jax_loader):
    got, want = list(port_loader), list(jax_loader)
    assert len(got) == len(want) == len(port_loader) == len(jax_loader)
    for b_got, b_want in zip(got, want):
        assert set(b_got) == set(b_want)
        for key in b_want:
            assert b_got[key].dtype == b_want[key].dtype, key
            np.testing.assert_array_equal(b_got[key], b_want[key],
                                          err_msg=key)
    return got


@pytest.mark.parametrize("letterbox", [False, True],
                         ids=["squash", "letterbox"])
def test_loader_batches_equal_jax(project, letterbox):
    """PIL decode, both geometries: shuffled with drop_last over two
    epochs, then in order without drop_last, padded to a multiple of 3
    (the padding flagged in ``sample_pad``). Every key bit for bit."""
    args = (str(project / "parquet" / "val"), str(project / "images"))
    kw = dict(input_size=INPUT, max_gt=4, letterbox=letterbox)
    port_ds, jax_ds = DetectionDataset(*args, **kw), JaxDataset(*args, **kw)
    assert len(port_ds) == len(jax_ds) == len(SIZES)
    shuffled = dict(shuffle=True, drop_last=True, num_workers=2, seed=5,
                    use_native=False)
    port_l = DataLoader(port_ds, BATCH, **shuffled)
    jax_l = JaxLoader(jax_ds, BATCH, **shuffled)
    orders = []
    for epoch in (0, 1):
        port_l.set_epoch(epoch)
        jax_l.set_epoch(epoch)
        batches = _assert_batches_equal(port_l, jax_l)
        assert len(batches) == len(SIZES) // BATCH
        orders.append(np.concatenate([b["image_id"] for b in batches]))
    assert not np.array_equal(orders[0], orders[1])
    ordered = dict(shuffle=False, drop_last=False, num_workers=2,
                   use_native=False, pad_to_multiple=3)
    batches = _assert_batches_equal(
        DataLoader(port_ds, 2, **ordered), JaxLoader(jax_ds, 2, **ordered))
    last = batches[-1]
    assert len(last["image"]) == 3 and last["sample_pad"].tolist() == [
        False, True, True]
    assert last["image"].dtype == np.uint8 and last["gt_mask"].any()


def test_native_decoder_matches_jax_and_pil(project):
    """The port's own build of the native decoder gives the JAX package's
    decoder's pixels bit for bit, and PIL's within one level (the limit
    of tests/test_e2e.py::test_native_loader_matches_pil); the loaders
    over it yield the same batches."""
    from custom_yolo_tpu.runtime import NativeDecoder as JaxDecoder
    from custom_yolo_tpu.runtime import native_available as jax_native
    from custom_yolo_tpu_torch.runtime import (_LIB, NativeDecoder,
                                               native_available)

    if not jax_native():
        pytest.skip("no g++ or jpeglib.h here: neither package's native "
                    "decoder builds")
    assert native_available() and os.path.dirname(_LIB).endswith(
        os.path.join("custom_yolo_tpu_torch", "runtime", "_build"))
    paths = sorted(glob.glob(str(project / "images" / "*.jpg")))
    got, sizes, failures = NativeDecoder(2).decode_batch(paths, *INPUT)
    want, want_sizes, _ = JaxDecoder(2).decode_batch(paths, *INPUT)
    assert failures == 0
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(sizes, want_sizes)
    args = (str(project / "parquet" / "val"), str(project / "images"))
    ds = DetectionDataset(*args, input_size=INPUT, max_gt=4)
    kw = dict(shuffle=False, drop_last=False, num_workers=2)
    native = _assert_batches_equal(
        DataLoader(ds, BATCH, use_native=True, **kw),
        JaxLoader(JaxDataset(*args, input_size=INPUT, max_gt=4), BATCH,
                  use_native=True, **kw))
    pil = list(DataLoader(ds, BATCH, use_native=False, **kw))
    for bn, bp in zip(native, pil):
        diff = np.abs(bn["image"].astype(int) - bp["image"].astype(int))
        assert diff.max() <= 1
        for key in bp:
            if key != "image":
                np.testing.assert_array_equal(bn[key], bp[key])


def test_port_imports_optional_host_packages_only_where_used():
    """Every module of the port imports with yaml, pandas, pyarrow, PIL,
    tensorboardX and wandb unavailable: they are imported only inside the
    functions that need them."""
    import subprocess
    import sys

    code = (
        "import importlib, pkgutil, sys\n"
        "for name in ('yaml', 'pandas', 'pyarrow', 'PIL', 'tensorboardX',\n"
        "             'wandb'):\n"
        "    sys.modules[name] = None\n"
        "import custom_yolo_tpu_torch as pkg\n"
        "names = [m.name for m in pkgutil.walk_packages(pkg.__path__,\n"
        "                                               'custom_yolo_tpu_torch.')]\n"
        "for name in names:\n"
        "    importlib.import_module(name)\n"
        "assert 'custom_yolo_tpu_torch.train.trainer' in names\n"
        "assert 'custom_yolo_tpu_torch.data.loader' in names\n"
        "print(len(names))\n")
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr[-3000:]
    assert int(r.stdout) >= 40


def test_host_helpers_match_jax(tmp_path, monkeypatch):
    """``utils.common`` against the JAX package's: worker and thread
    counts from the environment, the newest checkpoint in a folder."""
    from custom_yolo_tpu.utils import common as jax_common
    from custom_yolo_tpu_torch.utils import common

    for env in ({"SLURM_CPUS_PER_TASK": "3"}, {"SLURM_CPUS_PER_GPU": "99"},
                {"SLURM_CPUS_PER_TASK": "many"}, {}):
        for var in ("SLURM_CPUS_PER_TASK", "SLURM_CPUS_PER_GPU"):
            monkeypatch.delenv(var, raising=False)
        for var, value in env.items():
            monkeypatch.setenv(var, value)
        assert common.get_num_workers() == jax_common.get_num_workers()
        assert common.get_num_threads(2) == jax_common.get_num_threads(2)
    assert common.find_latest_checkpoint(str(tmp_path / "none")) is None
    for i, name in enumerate(("model_epoch_0", "model_config.json",
                              "model_epoch_1")):
        (tmp_path / name).mkdir()
        os.utime(tmp_path / name, (i, i))
    assert common.find_latest_checkpoint(str(tmp_path)) == \
        jax_common.find_latest_checkpoint(str(tmp_path)) == \
        str(tmp_path / "model_epoch_1")
