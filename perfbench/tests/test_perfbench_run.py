"""``perfbench/run.py`` as a check starts it: no result without a card
(here), from a directory that holds only the benchmark, and, on a card,
one short run of every cell with a result line that holds what the
benchmark asks for."""

import json
import shutil
import subprocess
import sys

import pytest
import torch

from perfbench import core


def start(root, workload, seconds=2, trace=0, seed=2 ** 31 + 3):
    return subprocess.run(
        [sys.executable, "perfbench/run.py", "--workload", workload,
         "--seed", str(seed), "--seconds", str(seconds), "--trace",
         str(trace)], cwd=root, capture_output=True, text=True, timeout=360)


def result_line(stdout):
    lines = [ln for ln in stdout.splitlines() if ln.startswith("{")]
    return json.loads(lines[-1]) if lines else None


def test_no_result_without_enough_cards():
    if torch.cuda.is_available():
        pytest.skip("a card is here")
    done = start(core.ROOT, "x640-serve-b8")
    assert done.returncode != 0
    assert result_line(done.stdout) is None


def test_no_result_from_the_benchmark_alone(tmp_path):
    shutil.copy(core.ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(core.BENCH, tmp_path / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    done = start(tmp_path, "n640-serve-b64")
    assert done.returncode != 0
    assert result_line(done.stdout) is None


@pytest.mark.card
@pytest.mark.parametrize("workload", [w["name"] for w in
                                      core.spec()["workloads"]])
@pytest.mark.parametrize("trace", [0, 1])
def test_short_run_on_the_card(workload, trace):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    done = start(core.ROOT, workload, seconds=3, trace=trace)
    assert done.returncode == 0, done.stderr[-3000:]
    line = result_line(done.stdout)
    assert line["correct"], done.stderr[-3000:]
    assert list(line)[-1] == "compared"
    resolved = core.cell(workload)
    want = resolved["per_layer"] if trace else resolved["end_to_end"]
    assert set(line["metrics"]) <= {m["name"] for m in want}
    assert line["device"]["platform"] == "gpu"
    if trace:
        assert line["device"]["busy_s"] > 0
        assert set(line["breakdown"]) == {"device_ops", "idle_gaps"}
    else:
        assert set(line["metrics"]) == {m["name"] for m in want}
