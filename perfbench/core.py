"""What every run shares: the benchmark's files found by name, the cache
directories, the guards, the device record and the result line.

Everything belonging to one configuration, traffic mix, per-layer metric
or kernel is a file of its own, found by its name:

* ``BENCHMARK.json`` at the root: cells, metrics, run length;
* ``perfbench/configs/<config>.json`` (the file a configuration names);
* ``perfbench/mixes/<traffic>.json``: ``generator`` (a module of
  ``perfbench/traffic/``) and its parameters;
* ``perfbench/metrics/<metric>.py``: ``read(view) -> float | None``;
* ``perfbench/kernels/<kernel>.py``: trace names and least times.
"""

from __future__ import annotations

import importlib.util
import json
import math
import os
import sys
import time
from pathlib import Path
from types import ModuleType
from typing import Any, Dict, List, Optional

ROOT = Path(__file__).resolve().parents[1]
BENCH = ROOT / "perfbench"
# top-level module names that may not be loaded in a run: the JAX stack and
# the JAX package (compared whole: the port's name begins with it)
FORBIDDEN = ("jax", "jaxlib", "flax", "custom_yolo_tpu")
# build and kernel caches of the program and of PyTorch, at fixed paths
# inside the checkout, so that only a checkout's first run builds
CACHE = ROOT / ".perfbench_cache"
CACHE_ENV = {"TRITON_CACHE_DIR": "triton",
             "TORCH_EXTENSIONS_DIR": "torch_extensions",
             "PYTORCH_KERNEL_CACHE_PATH": "torch_kernels",
             "CUDA_CACHE_PATH": "cuda"}


def process_start_time() -> float:
    """``time.time()`` at which this process was started, from
    ``/proc/self/stat``; the import time of this module where that cannot
    be read."""
    try:
        with open("/proc/self/stat") as f:
            fields = f.read().rsplit(")", 1)[1].split()
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        started = int(fields[19]) / os.sysconf("SC_CLK_TCK")
        return time.time() - (uptime - started)
    except (OSError, ValueError, IndexError):
        return _IMPORTED


_IMPORTED = time.time()


def set_cache_env() -> None:
    for var, sub in CACHE_ENV.items():
        path = CACHE / sub
        path.mkdir(parents=True, exist_ok=True)
        os.environ[var] = str(path)


def load_json(path: Path) -> Any:
    with open(path) as f:
        return json.load(f)


def spec() -> Dict[str, Any]:
    return load_json(ROOT / "BENCHMARK.json")


def cell(name: str, bench: Optional[Dict[str, Any]] = None
         ) -> Dict[str, Any]:
    """The workload ``name`` with its configuration and mix resolved:
    ``{"cell", "config", "mix", "end_to_end", "per_layer"}``, the last two
    the metric entries that the cell reports."""
    bench = bench or spec()
    found = [w for w in bench["workloads"] if w["name"] == name]
    if not found:
        raise SystemExit(f"unknown workload {name!r}; known: "
                         f"{[w['name'] for w in bench['workloads']]}")
    w = found[0]
    conf = next(c for c in bench["configs"] if c["name"] == w["config"])
    return {"cell": w,
            "config": load_json(ROOT / conf["file"]),
            "mix": load_json(BENCH / "mixes" / f"{w['traffic']}.json"),
            "end_to_end": reported(bench["end_to_end"], name),
            "per_layer": reported(bench["per_layer"], name)}


def reported(metrics: List[Dict[str, Any]], workload: str
             ) -> List[Dict[str, Any]]:
    return [m for m in metrics
            if "workloads" not in m or workload in m["workloads"]]


def load_file_module(path: Path) -> ModuleType:
    """A module from a file whose name need not be an identifier
    (``metrics/idle_pct.serve.py``)."""
    name = "perfbench_" + "_".join(path.relative_to(BENCH).with_suffix(
        "").parts).replace(".", "_").replace("-", "_")
    module_spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(module_spec)
    module_spec.loader.exec_module(module)
    return module


def metric_reader(name: str) -> ModuleType:
    return load_file_module(BENCH / "metrics" / f"{name}.py")


def kernel(name: str) -> ModuleType:
    return load_file_module(BENCH / "kernels" / f"{name}.py")


def listing() -> Dict[str, List[str]]:
    """The mixes, metrics and kernels the folder holds, by file name."""
    return {"mixes": sorted(p.stem for p in (BENCH / "mixes").glob("*.json")),
            "metrics": sorted(p.name[:-3] for p in
                              (BENCH / "metrics").glob("*.py")),
            "kernels": sorted(p.stem for p in
                              (BENCH / "kernels").glob("*.py")
                              if not p.stem.startswith("_"))}


def forbidden_modules() -> List[str]:
    """Loaded modules whose top-level name is one of :data:`FORBIDDEN`."""
    return sorted({m for m in list(sys.modules)
                   if m.split(".", 1)[0] in FORBIDDEN})


def device_record(torch, count: int) -> Dict[str, Any]:
    """``device`` of the result line: the fullest card's peak, allocated
    and reserved. The reserved peak also counts memory the allocator holds
    for tensors that no allocation reports, such as a CUDA graph's private
    pool."""
    peak = max(torch.cuda.max_memory_allocated(i) for i in range(count))
    reserved = max(torch.cuda.max_memory_reserved(i) for i in range(count))
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": count, "memory_peak_bytes": int(peak),
            "memory_reserved_bytes": int(reserved)}


def metric_entry(value: float, unit: str) -> Dict[str, Any]:
    if not math.isfinite(value):
        raise ValueError(f"metric value {value!r} is not finite")
    return {"value": float(value), "unit": unit}


def emit(result: Dict[str, Any], compared: List[Dict[str, Any]]) -> None:
    """The numbers compared as the last lines on standard error, then the
    result as the last line on standard output, ``compared`` its last
    key."""
    for c in compared:
        print(f"compared {c['name']} = {c['value']!r} (limit "
              f"{c['limit']!r}, {'ok' if c['ok'] else 'FAILED'})",
              file=sys.stderr)
    sys.stderr.flush()
    line = dict(result)
    line["compared"] = {c["name"]: {"value": c["value"], "limit": c["limit"]}
                        for c in compared}
    print(json.dumps(line), flush=True)


def compare(name: str, value: float, limit: float) -> Dict[str, Any]:
    """One number held to its limit: it passes where it is finite and no
    larger."""
    return {"name": name, "value": float(value), "limit": float(limit),
            "ok": bool(math.isfinite(value) and value <= limit)}
