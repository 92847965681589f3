#!/usr/bin/env python3
"""Readings that ``y12x4k-serve-b1``'s correctness limits are set from, in
one process on the card, as ``calibrate.py`` reads the other serving
cells: the program over many seeds, the int8 control (``quantize()``,
dynamic activation scales) and the NMS faults of ``faults.py`` over a
few, and the area-attention faults of ``area_faults.py`` (p4 attending
over the whole map; each strip with the keys of the one before).

    python3 perfbench/calibrate_y12.py --seeds 1001-1012 \\
        --control 2001-2003 --faults 3001-3003 --seconds 2 \\
        --out out/calibrate_y12x4k-serve-b1.json

The benchmark's own runs never run this.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from perfbench import area_faults, calibrate, core, faults  # noqa: E402

WORKLOAD = "y12x4k-serve-b1"
PLANTED = {"control": calibrate.int8_detector,
           **{name: (lambda original, name=name:
                     faults.serving(original, name))
              for name in ("no_suppression", "truncated_keep")},
           **{name: (lambda original, name=name:
                     area_faults.serving(original, name))
              for name in area_faults.AREA}}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--seeds", default="")
    p.add_argument("--control", default="")
    p.add_argument("--faults", default="")
    p.add_argument("--seconds", type=float, default=2.0)
    p.add_argument("--out", required=True)
    args = p.parse_args(argv)
    core.set_cache_env()
    resolved = core.cell(WORKLOAD)

    import torch

    from perfbench.traffic import serve_y12 as generator

    device = torch.device("cuda", 0)
    rows = []
    clock = [time.time()]

    def record(kind, seed, wrap=None):
        original = generator.build_detector
        if wrap is not None:
            generator.build_detector = wrap(original)
        try:
            values = calibrate.program_readings(generator, resolved, seed,
                                                args.seconds, device)
        finally:
            generator.build_detector = original
        now = time.time()
        row = {"kind": kind, "seed": seed, **values,
               "seconds": round(now - clock[0], 1)}
        clock[0] = now
        rows.append(row)
        print(json.dumps(row), flush=True)
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        with open(args.out, "w") as f:
            json.dump({"workload": WORKLOAD,
                       "device": torch.cuda.get_device_name(0),
                       "rows": rows}, f, indent=1)

    for s in calibrate.seeds(args.seeds):
        record("program", s)
    for s in calibrate.seeds(args.control):
        record("control", s, PLANTED["control"])
    for s in calibrate.seeds(args.faults):
        for kind in ("no_suppression", "truncated_keep", *area_faults.AREA):
            record(kind, s, PLANTED[kind])
    return 0


if __name__ == "__main__":
    sys.exit(main())
