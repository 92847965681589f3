"""``scripts/torch_train.py``, the port's training entry point, on the CPU
over a fixture: one epoch, then a resume from its checkpoint."""

import json
import os
import subprocess
import sys

import pytest

from custom_yolo_tpu_torch import config as port_config
from custom_yolo_tpu_torch.utils.checkpoint import load_sidecar
from test_torch_trainer import _raw_config
from torch_project import load_script, make_project

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def project(tmp_path_factory):
    return make_project(tmp_path_factory.mktemp("proj"), [(96, 96)] * 8)


def test_train_cli_on_the_cpu(project, tmp_path, monkeypatch):
    """``scripts/torch_train.py --device cpu --mode single --epochs 1``
    exits 0 and writes ``model_epoch_0/`` and the sidecar; a second run
    with ``--load_from_checkpoint`` resumes from it for a second epoch.
    ``scripts/extract_epochs.py`` reads the two runs' console log: one
    row for each epoch line."""
    raw = _raw_config()
    raw["data"].update(processed_dir=str(project / "parquet"),
                       train_parquet="val", val_parquet="val",
                       train_images=str(project / "images"),
                       val_images=str(project / "images"))
    ckpt_dir = tmp_path / "ck"
    raw["checkpoint"] = {"checkpoint_dir": str(ckpt_dir)}
    raw["project"]["log_dir"] = str(tmp_path / "logs")
    path = tmp_path / "cfg.yaml"
    port_config.Config.from_dict(raw).save(str(path))
    env = {**os.environ, "OMP_NUM_THREADS": "2", "SLURM_CPUS_PER_TASK": "2"}
    cmd = [sys.executable, os.path.join(REPO, "scripts", "torch_train.py"),
           "--config", str(path), "--device", "cpu", "--mode", "single"]
    first = subprocess.run(cmd + ["--epochs", "1"], capture_output=True,
                           text=True, env=env, cwd=tmp_path, timeout=300)
    assert first.returncode == 0, first.stderr[-3000:]
    assert (ckpt_dir / "model_epoch_0" / "state.pt").exists()
    assert load_sidecar(str(ckpt_dir))["precision"] == "float32"
    second = subprocess.run(
        cmd + ["--epochs", "2", "--load_from_checkpoint", str(ckpt_dir)],
        capture_output=True, text=True, env=env, cwd=tmp_path, timeout=300)
    assert second.returncode == 0, second.stderr[-3000:]
    assert "resumed from epoch 1" in second.stderr
    assert (ckpt_dir / "model_epoch_1" / "state.pt").exists()
    log = tmp_path / "console.log"
    log.write_text(first.stderr + second.stderr)
    out = tmp_path / "epochs.json"
    monkeypatch.setattr(sys, "argv", ["extract_epochs.py", "--log",
                                      str(log), "--out", str(out)])
    load_script("extract_epochs").main()
    rows = json.loads(out.read_text())["rows"]
    assert [row["epoch"] for row in rows] == [1, 2]
    assert all(row["train_loss"] > 0 and row["lr"] > 0 for row in rows)
