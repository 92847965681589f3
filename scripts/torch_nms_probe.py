"""Probe of the port's greedy-NMS kernels (K2, K3) on one NVIDIA GPU.

    python3 scripts/torch_nms_probe.py            # check and time
    python3 scripts/torch_nms_probe.py --ablate   # where the sweep's time goes
    python3 scripts/torch_nms_probe.py --ablate --sass nms.sass

Builds the NMS library, prints its ``ptxas`` report, runs the NMS checks
of ``chip_smoke.py`` phase 4 (K2 and K3 against the twin, keep-sets
exactly equal: K = 1024, 300, 1, 64, 65, 1000 and 10240, clusters across
the 64-box words, the removed words in global memory, two calls
bit-equal), then times ``nms_keep_batched`` on eight images and
``nms_keep_single`` on one, on a dense pool (random boxes of 20 classes,
nearly all kept) at K = 1024 and on a pool of K = 10240: device time (a
profiler trace of 20 calls back to back) split by kernel (the bit matrix,
the sweep), and one call's CUDA events. The serve pool of the x preset is
timed by ``chip_smoke.py`` phase 7. With ``--ablate`` it also builds
``nms.cu`` in a directory of its own with nothing, or one of
``-DNMS_ABLATE_LOADS`` / ``-DNMS_ABLATE_SETTLE`` / ``-DNMS_ABLATE_PUSH``
(that part of the sweep left out; results then are wrong, only their
time is read), times the sweep kernel of each on the dense pool, prints
the cycles a tile of each phase of the sweep (``-DNMS_PROFILE``, block 0,
a thread of warps 0 and 1), and with ``--sass PATH`` writes the SASS of
the library (``cuobjdump -sass``) to PATH. Exits non-zero if a check
fails.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import shutil
import subprocess
import sys
import tempfile
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import chip_smoke  # noqa: E402
from custom_yolo_tpu_torch.ops import nms_kernel  # noqa: E402
from custom_yolo_tpu_torch.ops.cuda import build  # noqa: E402


ABLATIONS = ("none", "NMS_ABLATE_LOADS", "NMS_ABLATE_SETTLE",
             "NMS_ABLATE_PUSH", "NMS_PROFILE")
PHASES = ("barrier", "loads", "settle", "ORs", "settle rounds", "loop",
          "set-up")


def ablate(dev, sass_path) -> None:
    boxes, valid = chip_smoke.nms_pool(2, 1024, 0.45, np.random.RandomState(
        chip_smoke.SEED + 4))
    with tempfile.TemporaryDirectory() as tmp:
        procs = []
        for name in ABLATIONS:
            lib = Path(tmp) / f"{name}.so"
            flags = [] if name == "none" else [f"-D{name}"]
            procs.append((name, lib, subprocess.Popen(
                [build._nvcc(), *build.FLAGS, *build.SOURCES["nms"][1],
                 *flags, "-o", str(lib), str(build.CSRC / "nms.cu")],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
        libs = []
        for name, lib, proc in procs:
            log, _ = proc.communicate()
            if proc.returncode:
                sys.exit(f"{name}: nvcc failed\n{log}")
            libs.append((name, ctypes.CDLL(str(lib))))
            if name == "none" and sass_path:
                cuobjdump = (shutil.which("cuobjdump")
                             or "/usr/local/cuda/bin/cuobjdump")
                Path(sass_path).write_text(subprocess.run(
                    [cuobjdump, "-sass", str(lib)], capture_output=True,
                    text=True, check=True).stdout)
        stream = torch.cuda.current_stream().cuda_stream
        for n in (1, 8):
            bx = torch.from_numpy(boxes[:1]).to(dev).expand(n, -1, -1)
            bx = bx.contiguous()
            vd = torch.from_numpy(valid[:1]).to(dev).expand(n, -1)
            vd = vd.contiguous()
            k, words = 1024, 16
            keep = torch.empty(n, k, dtype=torch.bool, device=dev)
            scratch = torch.empty(n * (words * (k + 1) + k),
                                  dtype=torch.int64, device=dev)
            times = []
            for name, lib in libs:
                fn = lib.nms_keep_bitmask
                fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 2 + [
                    ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
                fn.restype = ctypes.c_int

                def call(fn=fn, name=name):
                    if fn(bx.data_ptr(), vd.data_ptr(), keep.data_ptr(),
                          scratch.data_ptr(), n, k, 0.45,
                          nms_kernel.SHARED_REMOVED_WORDS, stream):
                        sys.exit(f"{name}: launch failed")

                split = chip_smoke.split_ms(call)["by_kernel_ms"]
                times.append(f"{name} {split.get('nms_sweep_kernel', 0.0)}")
            print(f"sweep device ms, dense K=1024, {n} image(s), with nothing "
                  f"/ one part left out: " + "; ".join(times), flush=True)
            counters = (ctypes.c_longlong * 16)()
            lib = dict(libs)["NMS_PROFILE"]
            call(lib.nms_keep_bitmask, "NMS_PROFILE")
            torch.cuda.synchronize()
            if lib.nms_profile_read(ctypes.byref(counters)):
                sys.exit("nms_profile_read failed")
            for thread, at in (("warp 0", 0), ("warp 1", 8)):
                tiles = max(counters[at + 7], 1)
                print(f"  {thread}, block 0, {counters[at + 7]} tiles, cycles "
                      f"a tile: " + ", ".join(
                          f"{name} {counters[at + i] / tiles:.1f}"
                          for i, name in enumerate(PHASES[:6]))
                      + f"; set-up {counters[at + 6]}", flush=True)


def main() -> None:
    parser = argparse.ArgumentParser()
    parser.add_argument("--ablate", action="store_true")
    parser.add_argument("--sass", help="with --ablate: write the SASS of "
                        "the library here")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        chip_smoke.fail("no CUDA device: this probe runs on the GPU")
    dev = torch.device("cuda")
    card = chip_smoke.card_line()
    print(f"device: {torch.cuda.get_device_name(0)} | {card}", flush=True)
    for line in build.build(["nms"]).get("nms", "").splitlines():
        if "registers" in line or "spill" in line or "entry" in line:
            print(f"  nms: {line.strip()}", flush=True)
    chip_smoke.nms_checks(dev)

    rows = []
    for k, seed in ((1024, chip_smoke.SEED + 4), (10240, chip_smoke.SEED)):
        boxes, valid = chip_smoke.nms_pool(2, k, 0.45,
                                           np.random.RandomState(seed))
        one_boxes = torch.from_numpy(boxes[:1]).to(dev)
        one_valid = torch.from_numpy(valid[:1]).to(dev)
        eight_boxes = one_boxes.expand(8, -1, -1).contiguous()
        eight_valid = one_valid.expand(8, -1).contiguous()
        kept = int(nms_kernel.nms_keep_single(one_boxes, one_valid,
                                              0.45).sum())
        for name, fn, bx, vd in (
                ("K2 (8 images)", nms_kernel.nms_keep_batched, eight_boxes,
                 eight_valid),
                ("K3 (1 image)", nms_kernel.nms_keep_single, one_boxes,
                 one_valid)):
            def call(fn=fn, bx=bx, vd=vd):
                return fn(bx, vd, 0.45)

            row = {"pool": f"dense K={k}", "kernel": name,
                   "kept_per_image": kept, **chip_smoke.split_ms(call),
                   "events_ms": chip_smoke.time_ms(call)}
            rows.append(row)
            print(json.dumps(row), flush=True)
    if args.ablate:
        ablate(dev, args.sass)
    print(card)
    print(json.dumps({"ok": True, "rows": len(rows)}))


if __name__ == "__main__":
    main()
