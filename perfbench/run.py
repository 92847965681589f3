#!/usr/bin/env python3
"""Run one benchmark cell once, on the machine this is started on.

    python3 perfbench/run.py --workload <name> --seed <n> --seconds <s> \\
        --trace <0|1>

The cell (``BENCHMARK.json``) names a configuration and a traffic mix;
the mix names its generator (``perfbench/traffic/<generator>.py``),
which builds the program's serving or training object from seeded weights,
warms up the cell's shapes (set-up, ``setup_s``), runs the window for
``--seconds`` and compares what the window produced with the plain
reference. With ``--trace 1`` a part of the window is traced, and the
cell's per-layer metrics are read from the trace
(``perfbench/metrics/<name>.py``) instead of the end-to-end ones.

The last line on standard output is the result as one JSON object; the
numbers compared, each beside its limit, are the last lines on standard
error. Exits non-zero, printing no result, without enough CUDA devices,
if the program cannot be imported, or if a module of the JAX stack or of
the JAX package is loaded when the window has closed.
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from perfbench import core  # noqa: E402

T_START = core.process_start_time()


class Run:
    """What a traffic generator is handed: the cell's configuration and mix, the
    run's arguments, the device, and the few calls that differ between
    the card and a CPU test."""

    def __init__(self, resolved, seed: int, seconds: float, trace: bool,
                 device, t_start: float):
        import torch

        self.torch = torch
        self.config, self.mix = resolved["config"], resolved["mix"]
        self.seed, self.seconds, self.trace = seed, seconds, trace
        self.device = device
        self.t_start = t_start
        self.limits = self.config.get("limits", {}).get(self.mix["generator"], {})
        self.marks = []

    def mark(self, label: str) -> None:
        """A point of the set-up, in seconds from the process start."""
        import time

        self.marks.append((label, round(time.time() - self.t_start, 3)))

    def sync(self) -> None:
        if self.device.type == "cuda":
            self.torch.cuda.synchronize()

    def reset_peak(self) -> None:
        if self.device.type == "cuda":
            self.torch.cuda.reset_peak_memory_stats()

    def free(self) -> None:
        if self.device.type == "cuda":
            self.torch.cuda.empty_cache()

    def exact_fp32(self) -> None:
        """TF32 off for the reference's fp32 products."""
        self.torch.backends.cuda.matmul.allow_tf32 = False
        self.torch.backends.cudnn.allow_tf32 = False

    def device_record(self):
        if self.device.type != "cuda":
            return {"platform": "cpu", "kind": "cpu", "count": 0,
                    "memory_peak_bytes": 0, "memory_reserved_bytes": 0}
        return core.device_record(self.torch, 1)

    def compare(self, name: str, value: float):
        return core.compare(name, value, self.limits[name])

    @staticmethod
    def note(message: str) -> None:
        print(message, file=sys.stderr, flush=True)


def per_layer(resolved, out):
    """The per-layer metrics the trace holds, by their readers."""
    view = View(out["digest"], resolved)
    metrics = {}
    for m in resolved["per_layer"]:
        value = core.metric_reader(m["name"]).read(view)
        if value is not None:
            metrics[m["name"]] = core.metric_entry(value, m["unit"])
    return metrics


class View:
    """What a metric reader sees: the digest of the traced window, the
    configuration and the mix."""

    def __init__(self, digest, resolved):
        self.digest = digest
        self.config = resolved["config"]
        self.mix = resolved["mix"]


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)

    core.set_cache_env()
    bench = core.spec()
    resolved = core.cell(args.workload, bench)
    chips = resolved["cell"]["chips"]

    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"this cell needs {chips} CUDA device(s); "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}"
              " available", file=sys.stderr)
        return 3
    import importlib

    # one process, one thread of host work besides the program's launches
    torch.set_num_threads(1)
    generator = importlib.import_module(
        f"perfbench.traffic.{resolved['mix']['generator']}")
    run = Run(resolved, args.seed, args.seconds, bool(args.trace),
              torch.device("cuda", 0), T_START)
    out = generator.run(run)
    run.note(f"set-up by phase (s from the process start): {run.marks}")

    found = core.forbidden_modules()
    if found:
        print(f"modules of the JAX stack or package are loaded: {found}",
              file=sys.stderr)
        return 4
    if args.trace:
        d = out["digest"]
        metrics = per_layer(resolved, out)
        device = dict(out["device"], busy_s=d.busy_s, window_s=d.window_s)
    else:
        wanted = [m for m in resolved["end_to_end"] if m["name"] != "setup_s"]
        metrics = {m["name"]: core.metric_entry(out["end_to_end"][m["name"]],
                                                m["unit"]) for m in wanted}
        metrics["setup_s"] = core.metric_entry(out["setup_s"], "s")
        device = out["device"]
    compared = out["compared"]
    result = {"correct": all(c["ok"] for c in compared),
              "attempted": out["attempted"], "failed": out["failed"],
              "metrics": metrics, "device": device}
    if args.trace:
        result["breakdown"] = {"device_ops": d.top_ops(),
                               "idle_gaps": d.idle_gaps()}
    core.emit(result, compared)
    return 0


if __name__ == "__main__":
    sys.exit(main())
