"""Probe of the port's fused cls-tower kernel (K6) on one NVIDIA GPU.

    python3 scripts/torch_head_probe.py            # check and time
    python3 scripts/torch_head_probe.py --ablate   # where K6's time goes

The first form builds the head library, prints its ``ptxas`` report,
holds the kernel to its plain twin (the limits of ``chip_smoke.py`` phase
4d: fp32 atol/rtol 1e-4; bf16 within 1e-2 of the largest logit and 1e-4 of
it on average) at the x preset's three head levels at batch 8 (C = 384 /
768 / 768 input channels at 80² / 40² / 20², M = 384, 172 classes) and at
small shapes that take the other pass widths, checks that two runs are
equal, and prints device times (profiler, 20 calls back to back) of K6, of
each of its two stage launches, and of the cuDNN chain it replaces
(depthwise and 1x1 convs with bias and SiLU in bf16, as the fused head
runs them), per level and for the three levels together.
The second builds ``head.cu`` four times in a directory of its own, with
nothing, or one of ``-DK6_ABLATE_COPIES`` / ``-DK6_ABLATE_DEPTHWISE`` /
``-DK6_ABLATE_PRODUCTS`` (that part of the bf16 kernel's step left out;
results then are wrong, only their time is read), and times each at the
x levels. Exits non-zero if a check fails.
"""

from __future__ import annotations

import argparse
import ctypes
import os
import subprocess
import sys
import tempfile
from pathlib import Path

import torch
import torch.nn.functional as F

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
from custom_yolo_tpu_torch.ops import head_kernel  # noqa: E402
from custom_yolo_tpu_torch.ops.cuda import build  # noqa: E402

B, MID, NC = 8, 384, 172
LEVELS = ((B, 384, 80, 80), (B, 768, 40, 40), (B, 768, 20, 20))
# (x shape, middle channels, classes): the x levels, then a ragged map
# with an odd class count, and the 256- and 512-channel pass widths
CASES = [(s, MID, NC) for s in LEVELS] + [((2, 128, 13, 7), 128, 17),
                                          ((2, 256, 9, 11), 256, 40),
                                          ((1, 96, 16, 8), 512, 200)]
ABLATIONS = ("none", "K6_ABLATE_COPIES", "K6_ABLATE_DEPTHWISE",
             "K6_ABLATE_PRODUCTS")


def device_ms(fn, reps: int = 20) -> float:
    """Kernel time of one call: the device time of ``reps`` calls back to
    back in a profiler trace, over ``reps``."""
    fn()
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    return sum(e.device_time_total for e in prof.key_averages()) / reps / 1e3


def inputs(shape, mid, nc, dtype, gen, dev):
    """A seeded channels_last map and cls-tower weights as ``cls_tower``
    takes them."""
    def mk(*s):
        return (torch.randn(*s, generator=gen) * 0.1).to(dev, dtype)
    cin = shape[1]
    x = torch.randn(shape, generator=gen).to(dev, dtype).contiguous(
        memory_format=torch.channels_last)
    return x, ((mk(3, 3, cin), mk(cin)), (mk(cin, mid), mk(mid)),
               (mk(3, 3, mid), mk(mid)), (mk(mid, mid), mk(mid)),
               (mk(mid, nc), mk(nc)))


def chain(x, params):
    """The conv chain a fused head runs for its cls tower, in x's dtype
    (cuDNN): depthwise, 1x1, depthwise, 1x1 with bias and SiLU, then the
    1x1 logits."""
    (dk1, db1), (pk1, pb1), (dk2, db2), (pk2, pb2), (ok, ob) = params
    y = F.silu(F.conv2d(x, dk1.permute(2, 0, 1)[:, None], db1, padding=1,
                        groups=x.shape[1]))
    y = F.silu(F.conv2d(y, pk1.t()[:, :, None, None], pb1))
    y = F.silu(F.conv2d(y, dk2.permute(2, 0, 1)[:, None], db2, padding=1,
                        groups=y.shape[1]))
    y = F.silu(F.conv2d(y, pk2.t()[:, :, None, None], pb2))
    return F.conv2d(y, ok.t()[:, :, None, None], ob)


def check(gen, dev) -> bool:
    ok = True
    for shape, mid, nc in CASES:
        for dtype in (torch.bfloat16, torch.float32):
            x, params = inputs(shape, mid, nc, dtype, gen, dev)
            got = head_kernel.cls_tower(x, *params)
            again = head_kernel.cls_tower(x, *params)
            ref = head_kernel.cls_tower_reference(x, *params)
            g, r = got.float(), ref.float()
            err = (g - r).abs().max().item()
            mean = (g - r).abs().mean().item()
            top = r.abs().max().item()
            if dtype == torch.float32:
                good = torch.allclose(g, r, atol=1e-4, rtol=1e-4)
            else:
                good = err < 1e-2 * top and mean < 1e-4 * top
            good = good and bool(torch.isfinite(g).all()) \
                and torch.equal(got, again)
            ok &= good
            print(f"{shape} mid {mid} nc {nc} {dtype}: max abs err {err}, "
                  f"mean {mean}, largest logit {top}, two runs equal "
                  f"{torch.equal(got, again)}: {'ok' if good else 'BAD'}",
                  flush=True)
    return ok


def timings(gen, dev) -> None:
    total = {"K6": 0.0, "chain": 0.0}
    with torch.inference_mode():
        for shape in LEVELS:
            x, params = inputs(shape, MID, NC, torch.bfloat16, gen, dev)
            dw1, pw1, dw2, pw2, (ok, ob) = params
            z = head_kernel._stage(x, dw1, pw1, None)
            out = (head_kernel._padded(ok), ob)
            k6 = device_ms(lambda: head_kernel.cls_tower(x, *params))
            stage1 = device_ms(lambda: head_kernel._stage(x, dw1, pw1, None))
            stage2 = device_ms(lambda: head_kernel._stage(z, dw2, pw2, out))
            lib = device_ms(lambda: chain(x, params))
            total["K6"] += k6
            total["chain"] += lib
            print(f"level {shape}: K6 {k6:.5f} device ms (stage 1 "
                  f"{stage1:.5f}, stage 2 with the logits {stage2:.5f}), "
                  f"cuDNN chain {lib:.5f}", flush=True)
    print(f"three levels: K6 {total['K6']:.5f} device ms, cuDNN chain "
          f"{total['chain']:.5f}", flush=True)


def ablate(gen, dev) -> None:
    with tempfile.TemporaryDirectory() as tmp:
        procs = []
        for name in ABLATIONS:
            lib = Path(tmp) / f"{name}.so"
            flags = [] if name == "none" else [f"-D{name}"]
            procs.append((name, lib, subprocess.Popen(
                [build._nvcc(), *build.FLAGS, *flags, "-o", str(lib),
                 str(build.CSRC / "head.cu")],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
        libs = []
        for name, lib, proc in procs:
            log, _ = proc.communicate()
            if proc.returncode:
                sys.exit(f"{name}: nvcc failed\n{log}")
            libs.append((name, ctypes.CDLL(str(lib))))
        stream = torch.cuda.current_stream().cuda_stream
        for shape in LEVELS:
            x, params = inputs(shape, MID, NC, torch.bfloat16, gen, dev)
            b, c, h, w = x.shape
            (dk1, db1), (pk1, pb1), (dk2, db2), (pk2, pb2), (ok, ob) = params
            ok = head_kernel._padded(ok)     # as the wrapper hands it over
            z = torch.empty((b, MID, h, w), dtype=x.dtype, device=dev,
                            memory_format=torch.channels_last)
            logits = torch.empty((b, NC, h, w), dtype=x.dtype, device=dev,
                                 memory_format=torch.channels_last)
            times = []
            for name, lib in libs:
                fn = lib.cls_stage
                fn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 9 + [
                    ctypes.c_void_p]
                fn.restype = ctypes.c_int

                def tower():
                    s1 = fn(x.data_ptr(), dk1.data_ptr(), db1.data_ptr(),
                            pk1.data_ptr(), pb1.data_ptr(), ok.data_ptr(),
                            ob.data_ptr(), z.data_ptr(), b, h, w, c, MID, MID,
                            MID, 0, 2, stream)
                    s2 = fn(z.data_ptr(), dk2.data_ptr(), db2.data_ptr(),
                            pk2.data_ptr(), pb2.data_ptr(), ok.data_ptr(),
                            ob.data_ptr(), logits.data_ptr(), b, h, w, MID,
                            MID, NC, ok.shape[1], 1, 2, stream)
                    if s1 or s2:
                        sys.exit(f"{name}: launch failed ({s1}, {s2})")

                times.append(f"{name} {device_ms(tower):.5f}")
            print(f"K6 level {shape}, device ms with nothing / one part left "
                  f"out: " + "; ".join(times), flush=True)


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--ablate", action="store_true")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        sys.exit("no CUDA device")
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    gen = torch.Generator().manual_seed(0)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    print(f"card: {card}; torch {torch.__version__}", flush=True)
    if args.ablate:
        ablate(gen, dev)
        return
    for name, log in build.build(["head"]).items():
        for line in log.splitlines():
            if "Compiling entry" in line or "registers" in line \
                    or "spill" in line:
                print(f"{name}: {line.strip()}")
    ok = check(gen, dev)
    timings(gen, dev)
    sys.exit(0 if ok else 1)


if __name__ == "__main__":
    os.environ.setdefault("PYTHONUNBUFFERED", "1")
    main()
