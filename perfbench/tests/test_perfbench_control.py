"""What decides ``correct``, held at a size a CPU test run can hold, with
each cell's own limits (``configs/*.json``):

* a sound run of the program passes;
* the control fails: for serving the program's own int8 path, for
  training the reference in fp8 in the program's place;
* each fault that a cell can have, planted in the program underneath an
  otherwise whole run (the harness's look for a card skipped), makes
  ``correct`` come out false.

The same controls, the half-batch fault and the two NMS faults (none
suppressed, too few kept) are read on the card at the cells' own sizes
by ``perfbench/calibrate.py``."""

import time

import pytest
import torch

from perfbench import calibrate, core, faults
from perfbench.run import Run
from perfbench.traffic import serve, train

CPU = torch.device("cpu")


def serve_cell(name):
    """A serving cell's configuration, mix and limits at a size a CPU test
    can hold, with more anchors than the pool of 1024 takes (at 160² the
    pool takes every anchor and NMS's ties read three times as often):
    n640-serve-b64 at a batch of 2; x4k-serve-b1 at batch 1 on a 448 × 800
    frame, 4K's wide aspect. On a 256 × 448 frame the x preset's sound runs
    already read as far from the reference as the limits (gap 0.045-0.077,
    unmatched 1.3-5.2% on four seeds, against 0.032-0.043 and 0-0.9% here):
    its deepest maps have too few pixels for settled statistics."""
    if name == "n640":
        cfg = core.load_json(core.BENCH / "configs" / "n640.json")
        mix = core.load_json(core.BENCH / "mixes" / "serve_b64.json")
        mix.update(batch=2, ring=3, warm_batches=2, check_batches=2)
    else:
        cfg = core.load_json(core.BENCH / "configs" / "x4k.json")
        cfg["input_size"] = [448, 800]
        mix = core.load_json(core.BENCH / "mixes" / "serve_b1.json")
        mix.update(ring=2, warm_batches=2, check_batches=2)
    return {"config": cfg, "mix": mix}


SERVE_CELLS = ("n640", "x4k")


def train_cell():
    cfg = core.load_json(core.BENCH / "configs" / "x640.json")
    cfg["input_size"] = [160, 160]
    mix = core.load_json(core.BENCH / "mixes" / "train_b16.json")
    mix.update(batch=4, slots=16)
    return {"config": cfg, "mix": mix}


def run(generator, cell, seed, attr=None, wrap=None):
    """One run of ``generator`` on the CPU, with ``attr`` of the generator
    replaced by ``wrap(attr)`` underneath; returns (correct, numbers)."""
    r = Run(cell, seed=seed, seconds=0.05, trace=False, device=CPU,
            t_start=time.time())
    original = getattr(generator, attr) if attr else None
    if attr:
        setattr(generator, attr, wrap(original))
    try:
        out = generator.run(r)
    finally:
        if attr:
            setattr(generator, attr, original)
    numbers = {c["name"]: c["value"] for c in out["compared"]}
    return all(c["ok"] for c in out["compared"]), numbers


@pytest.fixture(autouse=True)
def few_threads():
    threads = torch.get_num_threads()
    torch.set_num_threads(min(threads, 8))
    yield
    torch.set_num_threads(threads)


@pytest.mark.parametrize("cell", SERVE_CELLS)
def test_serving_sound_run_passes(cell):
    ok, numbers = run(serve, serve_cell(cell), 2 ** 31 + 11)
    assert ok, numbers


@pytest.mark.parametrize("cell", SERVE_CELLS)
def test_serving_control_int8_fails(cell):
    ok, numbers = run(serve, serve_cell(cell), 2 ** 31 + 11,
                      "build_detector", calibrate.int8_detector)
    assert not ok, numbers


@pytest.mark.parametrize("cell", SERVE_CELLS)
@pytest.mark.parametrize("fault", sorted(faults.SERVE))
def test_serving_fault_fails(fault, cell):
    ok, numbers = run(serve, serve_cell(cell), 2 ** 31 + 11,
                      "build_detector",
                      lambda original: faults.serving(original, fault))
    assert not ok, (fault, numbers)


def test_training_sound_run_passes():
    ok, numbers = run(train, train_cell(), 2 ** 31 + 12)
    assert ok, numbers


def test_training_control_fp8_fails():
    cell = train_cell()
    r = Run(cell, seed=2 ** 31 + 12, seconds=0.05, trace=False, device=CPU,
            t_start=time.time())
    numbers = calibrate.train_control(cell, 2 ** 31 + 12, CPU)
    compared = [r.compare(name, numbers[name]) for name in r.limits]
    assert not all(c["ok"] for c in compared), numbers


@pytest.mark.parametrize("fault", faults.TRAIN)
def test_training_fault_fails(fault):
    ok, numbers = run(train, train_cell(), 2 ** 31 + 12, "build_step",
                      lambda original: faults.training(original, fault))
    assert not ok, (fault, numbers)
