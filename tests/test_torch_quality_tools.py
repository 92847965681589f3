"""The port's quality-diagnosis scripts against the JAX package's, on the
CPU: ``scripts/torch_sweep_eval.py`` against ``scripts/sweep_eval.py`` and
``scripts/torch_rank_diag.py`` against ``scripts/rank_diag.py``, each run
in-process over one fixture with the same fp32 weights (saved by each
package's ``Detector.save_weights`` as ``model_epoch_N`` directories);
the sweep's rows against ``scripts/torch_evaluate.py`` at the same
threshold; ``scripts/torch_ablate_quality.py``'s cell configs against
the JAX script's, its metric parser on the evaluate CLI's output, and
its resumable loop.

Tolerances: counts exact; metrics within 1e-4 (both sides run the same
fp32 forward on the CPU, whose outputs agree to ~1e-6,
``tests/test_torch_eval_cli.py``); numbers the JAX rank diagnostic only
prints, within 1e-4 plus the printing's half step."""

import json
import os
import re
import sys

import numpy as np
import pytest
import torch

from custom_yolo_tpu.eval import coco_map as jax_coco_map
from custom_yolo_tpu.models import Detector as JaxDetector
from custom_yolo_tpu.models import YoloModel as JaxYoloModel
from custom_yolo_tpu_torch import Detector
from custom_yolo_tpu_torch.eval.decode import decode_predictions

from test_torch_eval_cli import (CSP, DEPTH, HW, NC, SIZES, WIDTH,
                                 confident_boxes, write_config)
from test_torch_model import perturbed_variables
from torch_project import load_script, make_project, random_jax_variables

torch.set_num_threads(2)

TOL = 1e-4
PRINTED = 5e-5
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EPOCHS = (0, 3)
THRESHOLDS = "0.001,0.1,0.25,0.3,0.5"


@pytest.fixture(scope="module")
def project(tmp_path_factory):
    return make_project(tmp_path_factory.mktemp("qualityproj"), SIZES,
                        boxes_per_image=3, seed=2)


@pytest.fixture(scope="module")
def checkpoints(tmp_path_factory):
    """Two epochs of fp32 weights, each saved by the JAX package under
    ``jax/model_epoch_N`` and carried into the port under
    ``port/model_epoch_N``."""
    root = tmp_path_factory.mktemp("quality_ckpt")
    for epoch in EPOCHS:
        variables = confident_boxes(perturbed_variables(random_jax_variables(
            JaxYoloModel(WIDTH, DEPTH, CSP, NC), HW, seed=10 + epoch),
            seed=10 + epoch))
        jax_det = JaxDetector(WIDTH, DEPTH, CSP, NC, precision="float32",
                              input_size=(HW, HW))
        jax_det.load_variables(variables)
        jax_det.save_weights(str(root / "jax" / f"model_epoch_{epoch}"))
        port = Detector(WIDTH, DEPTH, CSP, NC, precision="float32",
                        input_size=(HW, HW), device="cpu")
        port.load_variables(variables)
        port.save_weights(str(root / "port" / f"model_epoch_{epoch}"))
    return root


def run_jax_script(monkeypatch, name, argv):
    """``scripts/{name}.py``'s ``main`` on the CPU with ``argv`` (the JAX
    scripts read ``sys.argv``)."""
    monkeypatch.setenv("JAX_PLATFORMS", "cpu")
    monkeypatch.setattr(sys, "argv", [f"{name}.py"] + argv)
    load_script(name).main()


def assert_close(got: dict, want: dict, label: str, tol: float = TOL):
    assert got.keys() == want.keys(), label
    for key, value in want.items():
        if key.startswith(("true_", "false_", "total_")):     # counts
            assert got[key] == value, (label, key)
        else:
            assert abs(got[key] - value) <= tol, (label, key, got[key],
                                                  value)


def test_sweep_matches_jax_sweep(project, checkpoints, tmp_path,
                                 monkeypatch):
    """Every (epoch, threshold) cell of the port's sweep equals the JAX
    sweep's on the same weights: counts exact, metrics within 1e-4, the
    same printed rows."""
    cfg = write_config(tmp_path, project)
    common = ["--config", cfg, "--device", "cpu", "--epochs", "all",
              "--thresholds", THRESHOLDS]
    got = load_script("torch_sweep_eval").main(common + [
        "--checkpoint", str(checkpoints / "port"),
        "--out", str(tmp_path / "port.json")])
    with open(tmp_path / "port.json") as f:
        assert json.load(f) == got
    run_jax_script(monkeypatch, "sweep_eval", common + [
        "--checkpoint", str(checkpoints / "jax"),
        "--out", str(tmp_path / "jax.json")])
    with open(tmp_path / "jax.json") as f:
        want = json.load(f)
    assert list(got) == [str(e) for e in EPOCHS] == list(want)
    for epoch, rows in want.items():
        assert list(got[epoch]) == list(rows) == THRESHOLDS.split(",")
        for thr, row in rows.items():
            assert_close(got[epoch][thr], row, f"epoch {epoch} conf {thr}")
    # a comparison of zeros would prove nothing
    assert got["0"]["0.25"]["true_positives"] > 0
    assert got["0"]["0.25"]["mAP_50"] > 0
    assert got["3"]["0.001"]["total_predictions"] > \
        got["3"]["0.5"]["total_predictions"]


def test_sweep_rows_equal_the_evaluate_cli(project, checkpoints, tmp_path,
                                           capsys):
    """A threshold's row of the sweep (one forward at 5e-4, gated after)
    equals ``torch_evaluate.py --conf_threshold t`` (gated in the decode):
    the greedy metrics and COCO mAP (``--model_coords``: the sweep scores
    in model-input pixels) exactly, at 0.25 and at another threshold."""
    cfg = write_config(tmp_path, project)
    sweep = load_script("torch_sweep_eval").main(
        ["--config", cfg, "--device", "cpu", "--checkpoint",
         str(checkpoints / "port"), "--epochs", "3", "--thresholds",
         "0.1,0.25"])
    evaluate = load_script("torch_evaluate")
    for thr in ("0.1", "0.25"):
        res = evaluate.main(["--config", cfg, "--device", "cpu",
                             "--checkpoint",
                             str(checkpoints / "port" / "model_epoch_3"),
                             "--conf_threshold", thr, "--coco_map",
                             "--model_coords"])
        row = sweep["3"][thr]
        assert {k: row[k] for k in res["metrics"]} == res["metrics"]
        assert {k: row[k] for k in res["coco"]} == res["coco"]
        assert res["metrics"]["true_positives"] > 0
    out = capsys.readouterr().out
    assert "[epoch   3] conf=0.25  P=" in out
    assert "raw preds at gate 0.0005" in out


@pytest.mark.parametrize("k", [5, 40])
def test_gating_after_the_top_k_equals_gating_before(k):
    """What makes the sweep exact: the decode's top-k orders by score
    (equal scores lower index first), so decoding at the sweep's gate and
    keeping the scores ≥ t gives the boxes, scores and classes, in order,
    of decoding at t, also when the top-k binds and scores tie."""
    rng = np.random.RandomState(7)
    n, m, nc, reg_max = 3, 60, 4, 16
    logits = rng.randn(n, m, nc).astype(np.float32) * 2 - 1
    logits[:, 10:20] = logits[:, 30:40]     # tied scores at other anchors
    preds = torch.from_numpy(np.concatenate(
        [rng.randn(n, m, 4 * reg_max).astype(np.float32), logits], -1))
    anchors = torch.from_numpy(rng.rand(m, 2).astype(np.float32) * 16)
    strides = torch.full((m, 1), 8.0)
    base = decode_predictions(preds, anchors, strides, conf_threshold=5e-4,
                              top_k=k)
    for thr in (0.05, 0.25, 0.4, 0.6):
        gated = decode_predictions(preds, anchors, strides,
                                   conf_threshold=thr, top_k=k)
        for i in range(n):
            keep = base.valid[i] & (base.scores[i] >= thr)
            assert int(gated.valid[i].sum()) == int(keep.sum()) > 0
            for field in ("boxes_xywh", "scores", "classes"):
                assert torch.equal(getattr(gated, field)[i][gated.valid[i]],
                                   getattr(base, field)[i][keep]), field


def test_rank_diag_matches_jax_rank_diag(project, checkpoints, tmp_path,
                                         monkeypatch, capsys):
    """As-is and oracle COCO mAP within 1e-4 of the JAX diagnostic's; the
    coverage, its share at IoU ≥ 0.5 and the Spearman correlation within
    1e-4 of what it prints (four decimals; the share three); the same
    counts."""
    cfg = write_config(tmp_path, project)
    common = ["--config", cfg, "--device", "cpu", "--epoch", "3"]
    got = load_script("torch_rank_diag").main(
        common + ["--checkpoint", str(checkpoints / "port")])
    port_out = capsys.readouterr().out
    recorded = []

    def compute(self, _orig=jax_coco_map.COCOmAP.compute):
        recorded.append(_orig(self))
        return recorded[-1]
    monkeypatch.setattr(jax_coco_map.COCOmAP, "compute", compute)
    run_jax_script(monkeypatch, "rank_diag",
                   common + ["--checkpoint", str(checkpoints / "jax")])
    jax_out = capsys.readouterr().out
    assert len(recorded) == 2
    assert_close(got["as_is"], {k: float(v) for k, v in
                                recorded[0].items()}, "as-is")
    assert_close(got["oracle"], {k: float(v) for k, v in
                                 recorded[1].items()}, "oracle")
    head = re.compile(r"\[diag\] epoch 3: .*")
    assert head.search(port_out).group(0) == head.search(jax_out).group(0)
    printed = dict(
        mean_best_iou=r"mean best-IoU over GT\s+= ([-\d.]+)",
        share=r"GT with IoU>=0.5: ([-\d.]+)",
        spearman=r"spearman\(conf, best-IoU\) = ([-\d.]+)")
    values = {k: float(re.search(p, jax_out).group(1))
              for k, p in printed.items()}
    assert abs(got["mean_best_iou"] - values["mean_best_iou"]) <= \
        TOL + PRINTED
    # printed at three decimals
    assert abs(got["gt_iou_ge_0.5"] - values["share"]) <= TOL + 10 * PRINTED
    assert abs(got["spearman"] - values["spearman"]) <= TOL + PRINTED
    # a perfect ranking cannot score below the model's own, and the
    # fixture gives both something to rank
    assert got["oracle"]["mAP_50_95"] >= got["as_is"]["mAP_50_95"] > 0
    assert got["images"] == len(SIZES) and got["preds"] > 0


def test_ablation_cell_configs_match_jax(tmp_path):
    """``write_cell_config`` writes every cell's YAML as the JAX script
    does, up to the checkpoint path, and leaves the base alone."""
    port = load_script("torch_ablate_quality")
    jax_script = load_script("ablate_quality")
    assert port.CELLS == jax_script.CELLS
    base = os.path.join(REPO, "configs", "ablate_gen2_n.yaml")
    before = open(base).read()
    for cell, overrides in port.CELLS.items():
        paths = {}
        for name, module in (("port", port), ("jax", jax_script)):
            out = tmp_path / name
            out.mkdir(exist_ok=True)
            paths[name] = module.write_cell_config(base, cell, overrides, 7,
                                                   str(out))
            assert paths[name] == str(out / f"{cell.replace('+', '_')}"
                                      ".yaml")
        got = open(paths["port"]).read().replace(str(tmp_path / "port"),
                                                 "OUT")
        want = open(paths["jax"]).read().replace(str(tmp_path / "jax"),
                                                 "OUT")
        assert got == want, cell
        assert "  epochs: 7\n" in got
        assert f'checkpoint_dir: "OUT/ckpt_{cell.replace("+", "_")}"' in got
    assert open(base).read() == before


def test_ablation_metric_parser_reads_the_evaluate_cli(project, checkpoints,
                                                       tmp_path, capsys):
    """The parser reads the greedy precision and recall, every COCO mAP
    and the ARs at 1, 10 and 100 detections (the JAX script's pattern)
    from ``torch_evaluate.py --coco_map``'s lines (the COCO numbers
    printed at four decimals)."""
    cfg = write_config(tmp_path, project)
    res = load_script("torch_evaluate").main(
        ["--config", cfg, "--device", "cpu", "--checkpoint",
         str(checkpoints / "port" / "model_epoch_0"), "--conf_threshold",
         "0.25", "--coco_map"])
    parsed = load_script("torch_ablate_quality").parse_metrics(
        capsys.readouterr().out)
    want = {"precision": res["metrics"]["precision"],
            "recall": res["metrics"]["recall"],
            **{k: v for k, v in res["coco"].items()
               if re.fullmatch(r"mAP_\w+|AR_\d+", k)}}
    assert parsed.keys() == want.keys()
    assert {"mAP_50_95", "mAP_50", "mAP_75", "AR_100"} <= parsed.keys()
    for key, value in want.items():
        assert abs(parsed[key] - value) <= PRINTED, key
    assert parsed["mAP_50"] > 0


def test_ablation_runs_each_cell_once(tmp_path, monkeypatch, capsys):
    """Cells already in ``ablation.json`` are not run again; each new one
    is written there as it finishes, and the table lists the cells asked
    for."""
    port = load_script("torch_ablate_quality")
    out = tmp_path / "ablate"
    out.mkdir()
    (out / "ablation.json").write_text(json.dumps(
        {"tal": {"mAP_50_95": 0.5, "mAP_50": 0.6, "mAP_75": 0.55}}))
    ran = []

    def run_cell(cfg_path, log_path, device):
        ran.append((cfg_path, device))
        return {"mAP_50_95": 0.25, "mAP_50": 0.5, "mAP_75": 0.125}
    monkeypatch.setattr(port, "run_cell", run_cell)
    results = port.main(["--base", os.path.join(REPO, "configs", "ablate_gen2_n.yaml"), "--out",
                         str(out), "--cells", "tal,tal+ema", "--epochs",
                         "2", "--device", "cpu"])
    assert ran == [(str(out / "tal_ema.yaml"), "cpu")]
    with open(out / "ablation.json") as f:
        assert json.load(f) == results
    assert results["tal"]["mAP_50_95"] == 0.5
    table = capsys.readouterr().out
    assert "| tal | 0.5000 | 0.6000 | 0.5500 |" in table
    assert "| tal+ema | 0.2500 | 0.5000 | 0.1250 |" in table
