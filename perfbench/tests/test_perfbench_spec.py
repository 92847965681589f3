"""``BENCHMARK.json`` against the benchmark's rules, and every file a cell
names found by its name, also files that a later change adds."""

import json
import re
import shutil

import pytest

from perfbench import core

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
TOP = {"command", "paths", "run_seconds", "configs", "workloads",
       "end_to_end", "per_layer"}


@pytest.fixture(scope="module")
def bench():
    return core.spec()


def test_top_level_keys_and_paths(bench):
    assert set(bench) == TOP
    assert bench["command"] == ["python3", "perfbench/run.py"]
    assert bench["paths"] == ["perfbench"]
    assert 1 <= bench["run_seconds"] <= 51
    assert len(json.dumps(bench)) < 64 * 1024


def test_names_units_and_entry_keys(bench):
    names = []
    for c in bench["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert (core.ROOT / c["file"]).is_file()
        assert c["file"].startswith("perfbench/")
        names.append(c["name"])
    for w in bench["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] in (1, 4) and len(w["why"]) <= 200
        names += [w["name"], w["traffic"]]
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        names.append(m["name"])
    for m in bench["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound",
                                          "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in bench["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source",
                                          "layer", "moves"}
    assert all(NAME.match(n) for n in names), names
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        assert len({x["name"] for x in bench[group]}) == len(bench[group])


def test_every_cell_reports_what_it_must(bench):
    e2e = {m["name"]: m for m in bench["end_to_end"]}
    assert "setup_s" in e2e and "workloads" not in e2e["setup_s"]
    for w in bench["workloads"]:
        resolved = core.cell(w["name"], bench)
        reported = {m["name"] for m in resolved["end_to_end"]}
        assert "setup_s" in reported and len(reported) >= 2
        assert resolved["per_layer"], w["name"]
        for m in resolved["per_layer"]:
            assert m["moves"] in reported, (w["name"], m["name"])
        assert resolved["config"]["limits"][resolved["mix"]["generator"]]


def test_each_metric_and_mix_has_its_file(bench):
    listed = core.listing()
    for m in bench["per_layer"]:
        assert m["name"] in listed["metrics"]
        assert callable(core.metric_reader(m["name"]).read)
    for w in bench["workloads"]:
        assert w["traffic"] in listed["mixes"]
    for k in listed["kernels"]:
        mod = core.kernel(k)
        assert mod.TRACE_NAMES and mod.CALL_NAME and callable(mod.bound_s)


def test_added_files_are_found_by_name(tmp_path, monkeypatch):
    """A later change adds a mix and a metric as files, and a cell as an
    entry; nothing that is there is edited."""
    copy = tmp_path / "perfbench"
    shutil.copytree(core.BENCH, copy, ignore=shutil.ignore_patterns(
        "__pycache__"))
    (copy / "mixes" / "dummy_mix.json").write_text(json.dumps(
        {"generator": "serve", "batch": 2}))
    (copy / "metrics" / "dummy_metric.serve.py").write_text(
        "def read(view):\n    return 42.0\n")
    bench = core.spec()
    bench["workloads"].append({"name": "x640-dummy", "config": "x640",
                               "traffic": "dummy_mix", "chips": 1,
                               "why": "a cell added by files alone"})
    bench["per_layer"].append({
        "name": "dummy_metric.serve", "unit": "%", "better": "higher",
        "source": "device_trace", "layer": "Device",
        "moves": "serve_img_s", "workloads": ["x640-dummy"]})
    monkeypatch.setattr(core, "BENCH", copy)
    listed = core.listing()
    assert "dummy_mix" in listed["mixes"]
    assert "dummy_metric.serve" in listed["metrics"]
    resolved = core.cell("x640-dummy", bench)
    assert resolved["mix"]["batch"] == 2
    assert [m["name"] for m in resolved["per_layer"]] == [
        "dummy_metric.serve"]
    assert core.metric_reader("dummy_metric.serve").read(None) == 42.0
