"""Probe of the port's SPPF pyramid (K5) and grouped stochastic rounding
(K7) on one NVIDIA GPU.

    python3 scripts/torch_sppf_probe.py                  # check and time
    python3 scripts/torch_sppf_probe.py --ablate         # where K5's time goes
    python3 scripts/torch_sppf_probe.py --baseline DIR   # beside older kernels
    python3 scripts/torch_sppf_probe.py --sass PATH      # K5's and K7's SASS

Builds the ``sppf`` and ``quant`` libraries and prints their ``ptxas``
report, runs the K5 checks of ``chip_smoke.py`` phase 4c (every case equal
to the twin, with ±inf, signed zeros and a NaN), checks the grouped K7
against its twin on every ConvBN leaf of the ``x`` preset in one launch,
then times K5 at ``chip_smoke.SPPF_TIMED`` (device time, a profiler trace
of 20 calls back to back, and one call's CUDA events, beside the
``max_pool2d`` chain and the bound) and K7 over the leaves of one
``quantize()`` and on the largest leaf, and one whole
``Detector.quantize(stochastic=True)`` by events.

``--baseline DIR`` takes a ``csrc/`` directory of an earlier commit whose
``sppf.cu`` exports ``sppf_pyramid(x, out, b, h, w, c, ch, elem_size,
stream)`` and ``quant.cu`` ``stochastic_round_int8(x, out, n, k0, k1,
stream)`` (the untiled K5 and the per-leaf K7; unpack the commit with
``git archive`` into a git-ignored directory), builds those two into a
directory of its own and times them in turns with the port's (baseline,
port, port, baseline) at the same inputs, after holding them to the
twins: K5 where it takes the map, K7 one launch a leaf, and the whole
``quantize()`` with the per-leaf launches put in place of the grouped
one. ``--ablate`` builds ``sppf.cu`` as it is and copies of it with one
part left out (ABLATIONS: the neighbours' loads, the row pass, the column
pass, the stores; results then are wrong, only their time is read) and
times each at the ``SPPF_TIMED`` shapes. ``--sass PATH`` writes the SASS
of both libraries (``cuobjdump -sass``) to PATH. Exits non-zero if a check
fails.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import shutil
import statistics
import subprocess
import sys
import tempfile
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import chip_smoke  # noqa: E402
from custom_yolo_tpu_torch import PRESETS, Detector  # noqa: E402
from custom_yolo_tpu_torch.ops import (quant, quant_kernel,  # noqa: E402
                                       sppf_kernel)
from custom_yolo_tpu_torch.ops.cuda import build  # noqa: E402

# the parts of sppf.cu that --ablate leaves out, each as the lines of its
# copy of the source that change: the neighbours' loads (the centre stands
# in), the row pass (each row maximum is the centre), the column pass, and
# the stores (kept in a branch that never runs, so the passes stay)
ABLATIONS = {
    "loads": (("row[(size_t)(gx - d) * nv]", "centre"),
              ("row[(size_t)(gx + d) * nv]", "centre")),
    "row_pass": (("auto widen = [&](V& m, int d) {",
                  "auto widen = [&](V& m, int d) { return;"),),
    "column_pass": (("for (int d = 1; d <= HALO; ++d) {",
                     "for (int d = 1; d <= 0; ++d) {"),),
    "stores": (("if (gy >= y0 && gy < y0 + th)", "if (h < 0)"),
               ("V* o = yout + ((size_t)gy * w + gx) * 4 * nv + cv;",
                "V* o = yout + cv; if (h >= 0) continue;")),
}
# the untiled K5 wrapper's channel chunks, widest first
OLD_CHUNKS = (16, 8)


def compile_to(tmp: str, names_sources) -> dict:
    """Build each (name, source), all at once; the loaded libraries by
    name."""
    procs = []
    for name, source in names_sources:
        lib = Path(tmp) / f"{name}.so"
        procs.append((name, lib, subprocess.Popen(
            [build._nvcc(), *build.FLAGS, "-o", str(lib), str(source)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    libs = {}
    for name, lib, proc in procs:
        log, _ = proc.communicate()
        if proc.returncode:
            chip_smoke.fail(f"{name}: nvcc failed\n{log}")
        libs[name] = ctypes.CDLL(str(lib))
    return libs


def ablated_sources(tmp: str) -> list:
    """(name, path) of sppf.cu as it is and of a copy for each of
    ABLATIONS, written to ``tmp``."""
    source = (build.CSRC / "sppf.cu").read_text()
    out = [("none", build.CSRC / "sppf.cu")]
    for name, edits in ABLATIONS.items():
        text = source
        for old, new in edits:
            if text.count(old) != 1:
                chip_smoke.fail(f"ablation {name}: {old!r} is not in "
                                "sppf.cu once")
            text = text.replace(old, new)
        path = Path(tmp) / f"sppf_{name}.cu"
        path.write_text(text)
        out.append((name, path))
    return out


def c_function(lib, name, argtypes):
    fn = getattr(lib, name)
    fn.argtypes, fn.restype = argtypes + [ctypes.c_void_p], ctypes.c_int
    return fn


def new_sppf_caller(lib):
    """K5 of ``lib`` (a build of the port's sppf.cu) on a channels_last
    tensor, launched as the wrapper launches it."""
    fn = c_function(lib, "sppf_pyramid", [ctypes.c_void_p] * 2
                    + [ctypes.c_int] * 9)

    def call(x):
        b, c, h, w = x.shape
        out = torch.empty((b, 4 * c, h, w), dtype=x.dtype, device=x.device,
                          memory_format=torch.channels_last)
        vec, th, tw, cvb = sppf_kernel.launch_shape(
            b, c, h, w, x.element_size(), sppf_kernel._sm_count(x.device),
            x.data_ptr(), out.data_ptr())
        if fn(x.data_ptr(), out.data_ptr(), b, h, w, c // vec,
              x.element_size(), vec, th, tw, cvb,
              torch.cuda.current_stream().cuda_stream):
            chip_smoke.fail("sppf launch failed")
        return out
    return call


def old_callers(libs):
    """K5 and K7 of the baseline's libraries, launched as its wrappers
    launched them; K5 returns None for a map it does not take."""
    sppf = c_function(libs["sppf"], "sppf_pyramid", [ctypes.c_void_p] * 2
                      + [ctypes.c_int] * 6)
    k7 = c_function(libs["quant"], "stochastic_round_int8",
                    [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong,
                     ctypes.c_uint32, ctypes.c_uint32])

    def old_sppf(x):
        b, c, h, w = x.shape
        tile = 2 * h * w * x.element_size()
        chunk = next((ch for ch in OLD_CHUNKS
                      if tile * ch <= build.SMEM_LIMIT), None)
        if chunk is None:
            return None
        out = torch.empty((b, 4 * c, h, w), dtype=x.dtype, device=x.device,
                          memory_format=torch.channels_last)
        if sppf(x.data_ptr(), out.data_ptr(), b, h, w, c, chunk,
                x.element_size(), torch.cuda.current_stream().cuda_stream):
            chip_smoke.fail("baseline sppf launch failed")
        return out

    def old_round_many(flats, seed):
        outs = []
        for flat in flats:
            out = torch.empty(flat.shape, dtype=torch.int8,
                              device=flat.device)
            if flat.numel() and k7(flat.data_ptr(), out.data_ptr(),
                                   flat.numel(), seed & 0xFFFFFFFF,
                                   seed >> 32,
                                   torch.cuda.current_stream().cuda_stream):
                chip_smoke.fail("baseline K7 launch failed")
            outs.append(out)
        return outs
    return old_sppf, old_round_many


def x_detector():
    p = PRESETS["x"]
    det = Detector(p["width"], p["depth"], p["csp"], chip_smoke.NUM_CLASSES,
                   precision="bfloat16", input_size=(chip_smoke.HW,) * 2,
                   device="cuda")
    det.init(chip_smoke.SEED)
    return det.fuse()


def quantize_ms(round_many) -> float:
    """Median over three fresh fused x detectors of one
    ``quantize(stochastic=True)`` by events, K7's group call being
    ``round_many``."""
    times = []
    saved = quant.stochastic_round_many
    quant.stochastic_round_many = round_many
    try:
        for _ in range(3):
            det = x_detector()
            torch.cuda.synchronize()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            det.quantize(stochastic=True)
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end))
            del det
    finally:
        quant.stochastic_round_many = saved
    return statistics.median(times)


def main() -> None:
    parser = argparse.ArgumentParser()
    parser.add_argument("--ablate", action="store_true")
    parser.add_argument("--baseline", help="a csrc/ directory of an earlier "
                        "commit, timed beside the port's kernels")
    parser.add_argument("--sass", help="write the libraries' SASS here")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        chip_smoke.fail("no CUDA device: this probe runs on the GPU")
    dev = torch.device("cuda")
    card = chip_smoke.card_line()
    print(f"device: {torch.cuda.get_device_name(0)} | {card}", flush=True)
    for name, log in build.build(["sppf", "quant"]).items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line or "entry" in line:
                print(f"  {name}: {line.strip()}", flush=True)
    if args.sass:
        cuobjdump = (shutil.which("cuobjdump")
                     or "/usr/local/cuda/bin/cuobjdump")
        Path(args.sass).write_text("".join(subprocess.run(
            [cuobjdump, "-sass", str(build.library_path(name))],
            capture_output=True, text=True, check=True).stdout
            for name in ("sppf", "quant")))
    gen = torch.Generator().manual_seed(chip_smoke.SEED)
    chip_smoke.sppf_checks(gen, dev)

    det = x_detector()
    kernels = [det._state[key] for key in det._state
               if key.endswith(".conv.weight")
               and not any(part in quant.DEFAULT_QUANT_SKIP
                           for part in key.split("."))]
    path = [quant.stochastic_operand(kernel)[0] for kernel in kernels]
    # the eager passes quantize() makes before K7: each leaf's scale, divide
    # and clip (stochastic_operand), by events
    operand_ms = chip_smoke.time_ms(
        lambda: [quant.stochastic_operand(kernel) for kernel in kernels],
        reps=5, warmup=1)
    print(f"quantize()'s operand passes over {len(kernels)} leaves: "
          f"{operand_ms} ms by events", flush=True)
    del det, kernels
    largest = max(path, key=lambda flat: flat.numel())
    got = quant_kernel.stochastic_round_many(path, 0)
    for flat, q in zip(path, got):
        if not torch.equal(q, quant_kernel.stochastic_round_reference(flat,
                                                                      0)):
            chip_smoke.fail(f"K7 differs from its twin on a leaf of "
                            f"{tuple(flat.shape)}")
    print(f"K7 on the {len(path)} leaves of one quantize() in one launch: "
          f"each equal to its twin", flush=True)

    ops = chip_smoke.k7_sass_per_element()
    n = sum(flat.numel() for flat in path)
    print(f"K7 per element from the SASS: {ops}; bound per quantize() "
          f"{chip_smoke.k7_bound_of(n, ops)}, largest leaf "
          f"{chip_smoke.k7_bound_of(largest.numel(), ops)}; SM clock "
          f"{chip_smoke.sm_clock_hz() / 1e6} MHz", flush=True)

    with tempfile.TemporaryDirectory() as tmp:
        old_sppf = None
        if args.baseline:
            csrc = Path(args.baseline)
            libs = compile_to(tmp, [(name, csrc / f"{name}.cu")
                                    for name in ("sppf", "quant")])
            old_sppf, old_round_many = old_callers(libs)
            for flat, q in zip(path, old_round_many(path, 0)):
                if not torch.equal(q, quant_kernel.stochastic_round_reference(
                        flat, 0)):
                    chip_smoke.fail("baseline K7 differs from the twin")
        turns = (("baseline", "port", "port", "baseline") if old_sppf
                 else ("port",))
        for shape, dtype in chip_smoke.SPPF_TIMED:
            x = chip_smoke.channels_last(shape, dtype, gen, dev)
            rows = []
            for name in turns:
                kernel = sppf_kernel.sppf_pyramid
                if name == "baseline":
                    kernel, out = old_sppf, old_sppf(x)
                    if out is None:
                        rows.append({"kernel": name, "refused": True})
                        continue
                    if not torch.equal(
                            out, sppf_kernel.sppf_pyramid_reference(x)):
                        chip_smoke.fail("baseline K5 differs from the twin")
                rows.append({"kernel": name,
                             **chip_smoke.sppf_times(x, kernel)})
            print(json.dumps({"k5": rows, "card": card}), flush=True)

        k7_rows = []
        for name in turns:
            round_many = (old_round_many if name == "baseline"
                          else quant_kernel.stochastic_round_many)
            k7_rows.append({
                "kernel": name, "leaves": len(path), "weights": n,
                "quantize_device_ms": chip_smoke.device_ms(
                    lambda: round_many(path, 0), reps=10),
                "quantize_events_ms": chip_smoke.time_ms(
                    lambda: round_many(path, 0), reps=10),
                "largest_leaf_device_ms": chip_smoke.device_ms(
                    lambda: round_many([largest], 0)),
                "largest_leaf_events_ms": chip_smoke.time_ms(
                    lambda: round_many([largest], 0)),
                "detector_quantize_events_ms": quantize_ms(round_many)})
            print(json.dumps({"k7": k7_rows[-1], "card": card}), flush=True)

        if args.ablate:
            libs = compile_to(tmp, ablated_sources(tmp))
            for shape, dtype in chip_smoke.SPPF_TIMED:
                x = chip_smoke.channels_last(shape, dtype, gen, dev)
                times = {name: chip_smoke.device_ms(
                    lambda call=new_sppf_caller(lib): call(x))
                    for name, lib in libs.items()}
                print(f"K5 device ms {shape} {dtype}, with nothing / one "
                      f"part left out: {json.dumps(times)}", flush=True)
    print(card)
    print(json.dumps({"ok": True}))


if __name__ == "__main__":
    main()
