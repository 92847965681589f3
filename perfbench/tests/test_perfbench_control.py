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


def serve_cell():
    # the cell's own frames at a small batch: at 160² the pool of 1024
    # takes every anchor and NMS's ties read three times as often
    cfg = core.load_json(core.BENCH / "configs" / "n640.json")
    mix = core.load_json(core.BENCH / "mixes" / "serve_b64.json")
    mix.update(batch=2, ring=3, warm_batches=2, check_batches=2)
    return {"config": cfg, "mix": mix}


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


def test_serving_sound_run_passes():
    ok, numbers = run(serve, serve_cell(), 2 ** 31 + 11)
    assert ok, numbers


def test_serving_control_int8_fails():
    ok, numbers = run(serve, serve_cell(), 2 ** 31 + 11, "build_detector",
                      calibrate.int8_detector)
    assert not ok, numbers


@pytest.mark.parametrize("fault", sorted(faults.SERVE))
def test_serving_fault_fails(fault):
    ok, numbers = run(serve, serve_cell(), 2 ** 31 + 11, "build_detector",
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
