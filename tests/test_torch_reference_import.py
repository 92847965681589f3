"""The port's reference-checkpoint importer
(``custom_yolo_tpu_torch/utils/torch_port.py``,
``scripts/torch_import_torch.py``) against the JAX package's
(``custom_yolo_tpu/utils/torch_port.py``), on the CPU.

The reference checkout is not needed: JAX's ``to_torch_state_dict`` writes
a reference-format state dict from seeded JAX variables (the small model,
and the ``n`` preset with 172 classes), and the port's import of it must
equal ``from_jax_variables`` of the same variables bit for bit and key for
key; the port's export must equal JAX's. Then the checkpoint files a
reference user has (``module.``/``_orig_mod.`` prefixes, the trainer's
``{"model_state": …}`` wrapper), the four kinds of error, and the CLI as a
child process, whose directory ``Detector.load_weights`` reads and serves
as the JAX detector does.
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch
import yaml

from custom_yolo_tpu.models import Detector as JaxDetector
from custom_yolo_tpu.utils import torch_port as jax_torch_port
from custom_yolo_tpu_torch import PRESETS, Detector
from custom_yolo_tpu_torch.ops.nms import nms_to_lists
from custom_yolo_tpu_torch.utils import torch_port
from custom_yolo_tpu_torch.utils.weights import from_jax_variables

from test_torch_model import perturbed_variables
from torch_project import random_jax_variables

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMALL = dict(width=(3, 8, 16, 32, 64, 64), depth=(1, 1, 1, 1, 1, 1),
             csp=(False, True), num_classes=5)
N172 = dict(PRESETS["n"], num_classes=172)
HW = 64
MODELS = {"small": SMALL, "n172": N172}


def _arch(cfg):
    return cfg["width"], cfg["depth"], cfg["csp"]


def _jax_detector(cfg) -> JaxDetector:
    return JaxDetector(*_arch(cfg), num_classes=cfg["num_classes"],
                       precision="float32", input_size=(HW, HW))


def _port(cfg) -> Detector:
    return Detector(*_arch(cfg), cfg["num_classes"], precision="float32",
                    input_size=(HW, HW), device="cpu")


@pytest.fixture(scope="module", params=list(MODELS))
def case(request):
    """(config, seeded JAX variables as numpy, the reference state dict
    JAX writes from them, an unfused port detector)."""
    cfg = MODELS[request.param]
    variables = perturbed_variables(random_jax_variables(
        _jax_detector(cfg).module, HW, seed=4), seed=5)
    ref = jax_torch_port.to_torch_state_dict(variables)
    port = _port(cfg)
    port.init(0)
    return cfg, variables, ref, port


def _assert_same_state(got, want):
    assert set(got) == set(want)
    for key, value in want.items():
        assert got[key].dtype == value.dtype, key
        assert torch.equal(got[key], value), key


def test_import_equals_from_jax_variables(case):
    cfg, variables, ref, port = case
    got = torch_port.from_torch_state_dict(ref, port.model.state_dict())
    _assert_same_state(got, from_jax_variables(variables, port.model))


def test_export_equals_jax_to_torch_state_dict(case):
    cfg, variables, ref, port = case
    state = from_jax_variables(variables, port.model)
    got = torch_port.to_torch_state_dict(state)
    assert set(got) == set(ref)
    for key, value in ref.items():
        want = torch.from_numpy(np.asarray(value))
        assert got[key].dtype == want.dtype, key
        assert torch.equal(got[key], want), key
    assert got["head.dfl.conv.weight"].shape == (1, 16, 1, 1)
    assert all(int(v) == 0 for k, v in got.items()
               if k.endswith("num_batches_tracked"))


@pytest.mark.parametrize("prefix,wrapped", [
    ("module.", True), ("_orig_mod.", False), ("", True)],
    ids=["ddp-wrapped", "compiled-bare", "plain-wrapped"])
def test_checkpoint_files_load(tmp_path, case, prefix, wrapped):
    """A real ``torch.save`` file with the wrapper prefixes and with or
    without the trainer's ``{"model_state": …}`` dict loads, and
    ``import_torch_weights`` fills the detector with the variables."""
    cfg, variables, ref, _ = case
    sd = {prefix + k: torch.from_numpy(np.asarray(v)) for k, v in ref.items()}
    path = tmp_path / "ref.pt"
    torch.save({"model_state": sd, "epoch": 3} if wrapped else sd, path)
    loaded = torch_port.load_torch_checkpoint(str(path))
    assert set(loaded) == set(ref)
    det = _port(cfg)
    torch_port.import_torch_weights(det, str(path))
    _assert_same_state(det.model.state_dict(),
                       from_jax_variables(variables, det.model))


def _broken(ref, kind):
    sd = {k: np.asarray(v).copy() for k, v in ref.items()}
    if kind == "missing":
        del sd["net.p1.0.conv.weight"]
    elif kind == "unconsumed":
        sd["net.extra.conv.weight"] = np.zeros((1, 1, 1, 1), np.float32)
    elif kind == "shape":
        sd["head.cls.0.4.bias"] = np.zeros(3, np.float32)
    else:
        sd["head.dfl.conv.weight"] = sd["head.dfl.conv.weight"] * 2.0
    return sd


@pytest.mark.parametrize("kind,words", [
    ("missing", "missing from state dict"),
    ("unconsumed", "unconsumed torch keys"),
    ("shape", "shape mismatches"),
    ("dfl", "not the frozen arange DFL projection")])
def test_errors_are_jaxs(case, kind, words):
    """Each kind of mismatch raises ``ValueError`` with the JAX package's
    words, in the port and in JAX alike."""
    cfg, variables, ref, port = case
    sd = _broken(ref, kind)
    with pytest.raises(ValueError, match=words):
        torch_port.from_torch_state_dict(sd, port.model.state_dict())
    with pytest.raises(ValueError, match=words):
        jax_torch_port.from_torch_state_dict(sd, variables)


def test_transformed_states_are_refused(case):
    cfg, variables, ref, port = case
    fused = _port(cfg)
    fused.init(0)
    fused.fuse()
    with pytest.raises(ValueError, match="looks fused/transformed"):
        torch_port.from_torch_state_dict(ref, fused.model.state_dict())
    with pytest.raises(ValueError, match="unfused tree"):
        torch_port.to_torch_state_dict(fused.model.state_dict())


def test_cli_writes_weights_that_serve_as_jax(tmp_path):
    """``scripts/torch_import_torch.py --fuse`` as a child process: its
    directory loads with ``Detector.load_weights`` and serves on the CPU as
    the JAX detector with the same variables does (classes and counts
    equal, boxes within 1e-3 px, scores within 1e-5)."""
    cfg = SMALL
    variables = perturbed_variables(random_jax_variables(
        _jax_detector(cfg).module, HW, seed=6), seed=7)
    sd = {"module." + k: torch.from_numpy(np.asarray(v)) for k, v in
          jax_torch_port.to_torch_state_dict(variables).items()}
    ckpt = tmp_path / "ref.pt"
    torch.save({"model_state": sd}, ckpt)
    config = tmp_path / "model.yaml"
    config.write_text(yaml.safe_dump({"model": {
        "input_size": [HW, HW], "num_classes": cfg["num_classes"],
        "width": list(cfg["width"]), "depth": list(cfg["depth"]),
        "csp": list(cfg["csp"])}}))
    out = tmp_path / "imported"
    run = subprocess.run(
        [sys.executable, os.path.join(REPO, "scripts",
                                      "torch_import_torch.py"),
         "--torch_checkpoint", str(ckpt), "--output", str(out),
         "--config", str(config), "--fuse", "--device", "cpu"],
        capture_output=True, text=True, cwd=str(tmp_path), timeout=300,
        env={**os.environ, "OMP_NUM_THREADS": "2"})
    assert run.returncode == 0, run.stderr
    assert "fused=True" in run.stdout

    det = _port(cfg).load_weights(str(out))
    assert det._transform_flags()["fused"] is True
    jax_det = _jax_detector(cfg)
    jax_det.load_variables(variables)
    jax_det.fuse()
    images = np.random.RandomState(8).randn(2, HW, HW, 3).astype(np.float32)
    got = nms_to_lists(det.serve(torch.from_numpy(images), conf_thres=0.01))
    from custom_yolo_tpu.ops.nms import nms_to_lists as jax_nms_to_lists
    want = jax_nms_to_lists(jax_det.serve(images, conf_thres=0.01))
    assert sum(len(g) for g in got) > 0
    for g, w in zip(got, want):
        assert g.shape == w.shape
        np.testing.assert_array_equal(g[:, 5], w[:, 5])
        np.testing.assert_allclose(g[:, :4], w[:, :4], atol=1e-3)
        np.testing.assert_allclose(g[:, 4], w[:, 4], atol=1e-5)
