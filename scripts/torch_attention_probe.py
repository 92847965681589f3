"""Probe of the port's PSA attention kernels (K1 forward, K4 backward) on
one NVIDIA GPU.

    python3 scripts/torch_attention_probe.py            # check and time
    python3 scripts/torch_attention_probe.py --ablate   # where K1's time goes

The first form builds the two attention libraries, prints their ``ptxas``
report, holds both kernels to their plain twins on the shapes of
``chip_smoke.py`` phases 3 and 4b (plus dk=64, dh=128) in bf16 and fp32,
and prints device times (profiler, 20 calls back to back) of K1, K4 and
``scaled_dot_product_attention`` forward and backward at the x preset's
shape (B=8, T=400, nh=6, dk=32, dh=64), K1 at B=1 and at T=1024. The second
builds variants of ``attention.cu``, each with one part of a tile step left
out (results then are wrong; only their time is read), and times them at
the same shapes. Exits non-zero if a check fails.
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
from custom_yolo_tpu_torch.ops import attention  # noqa: E402
from custom_yolo_tpu_torch.ops.cuda import build  # noqa: E402

X = (8, 400, 6, 32, 64)
SHAPES = (X, (3, 37, 2, 8, 16), (2, 1024, 6, 32, 64), (2, 65, 6, 32, 64),
          (1, 400, 2, 16, 32), (2, 70, 3, 12, 20), (1, 130, 2, 64, 128))
# one part of the forward's tile step each, left out of a copy of
# attention.cu: (name, its text there, what replaces it)
ABLATIONS = (
    ("pass 1", "      psa::softmax_stats_tile<DKP>(m, l, qf, kt, key0, seq, "
     "c_log2, lane);", "      m[0] = m[1] = 0.f; l[0] = l[1] = 1.f;"),
    ("copy issue", "    stage(s + psa::STAGES - 1);", ""),
    ("wait and barrier", "    psa::cp_async_wait<psa::STAGES - 2>();\n"
     "    __syncthreads();", ""),
    ("P·V products", "        psa::accumulate16<DHP>(acc, pa, vt, 16 * c, "
     "lane);", "        acc[c][0] += __uint_as_float(pa[0]);"),
    ("pass-2 softmax", "            sc[n][i] = psa::softmax_p(sc[n][i], "
     "c_log2, m[i >> 1], l[i >> 1]);", "            sc[n][i] *= l[i >> 1];"),
)


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


def check(gen, dev) -> bool:
    ok = True
    for b, t, nh, dk, dh in SHAPES:
        qkv32 = torch.randn(b, t, nh * (2 * dk + dh), generator=gen).to(dev)
        do32 = torch.randn(b, t, nh * dh, generator=gen).to(dev)
        dv32 = torch.randn(b, t, nh * dh, generator=gen).to(dev)
        for dtype in (torch.bfloat16, torch.float32):
            if dtype == torch.float32 and t > 500:
                continue  # beyond the fp32 route's shared-memory bound
            qkv = qkv32.to(dtype)
            out, v = attention.psa_attention(qkv, nh, dk, dh)
            ref_out, ref_v = attention.psa_attention_reference(qkv, nh, dk, dh)
            fwd_err = (out.float() - ref_out.float()).abs().max().item()
            args = (qkv, do32.to(dtype), dv32.to(dtype), nh, dk, dh)
            got, again = (attention.psa_attention_bwd(*args) for _ in "12")
            g = got.float()
            r = attention.psa_attention_bwd_reference(*args).float()
            bwd_err = (g - r).abs().max().item()
            cos = float((g * r).sum() / (g.norm() * r.norm()))
            if dtype == torch.bfloat16:
                good = fwd_err <= 2e-2 and torch.allclose(
                    g, r, atol=0.15, rtol=0.15) and cos > 0.999
            else:
                good = fwd_err <= 1e-5 and bwd_err <= 1e-4
            good = good and torch.equal(v, ref_v) and torch.equal(got, again)
            ok &= good
            print(f"{(b, t, nh, dk, dh)} {dtype}: out err {fwd_err}, dqkv "
                  f"err {bwd_err}, cosine {cos:.7f}, {'ok' if good else 'BAD'}",
                  flush=True)
    return ok


def timings(gen, dev) -> None:
    b, t, nh, dk, dh = X
    qkv = torch.randn(b, t, nh * (2 * dk + dh), generator=gen).to(
        dev, torch.bfloat16)
    do = torch.randn(b, t, nh * dh, generator=gen).to(dev, torch.bfloat16)
    q4 = qkv.view(b, t, nh, 2 * dk + dh).transpose(1, 2)
    q, k, v = (x.detach().clone().requires_grad_()
               for x in (q4[..., :dk], q4[..., dk:2 * dk], q4[..., 2 * dk:]))
    out = F.scaled_dot_product_attention(q, k, v)
    do4 = do.view(b, t, nh, dh).transpose(1, 2)
    one = qkv[:1].contiguous()
    long = torch.randn(2, 1024, nh * (2 * dk + dh), generator=gen).to(
        dev, torch.bfloat16)
    rows = {
        "K1 bf16": lambda: attention.psa_attention(qkv, nh, dk, dh),
        "SDPA": lambda: F.scaled_dot_product_attention(q, k, v),
        "K4 bf16": lambda: attention.psa_attention_bwd(qkv, do, do, nh, dk,
                                                       dh),
        "SDPA backward": lambda: torch.autograd.grad(out, (q, k, v), do4,
                                                     retain_graph=True),
        "K1 bf16 B=1": lambda: attention.psa_attention(one, nh, dk, dh),
        "K1 bf16 B=2 T=1024": lambda: attention.psa_attention(long, nh, dk,
                                                              dh),
    }
    for name, fn in rows.items():
        print(f"{name}: {device_ms(fn):.5f} device ms", flush=True)


def ablate(gen, dev) -> None:
    source = (build.CSRC / "attention.cu").read_text()
    with tempfile.TemporaryDirectory() as tmp:
        variants = [("none", source)]
        for name, text, repl in ABLATIONS:
            if source.count(text) != 1:
                sys.exit(f"ablation {name!r}: its text is not in attention.cu")
            variants.append((name, source.replace(text, repl)))
        (Path(tmp) / "attention_tiles.cuh").write_text(
            (build.CSRC / "attention_tiles.cuh").read_text())
        procs = []
        for i, (name, text) in enumerate(variants):
            src = Path(tmp) / f"v{i}.cu"
            src.write_text(text)
            lib = Path(tmp) / f"v{i}.so"
            procs.append((name, lib, subprocess.Popen(
                [build._nvcc(), *build.FLAGS, "-o", str(lib), str(src)],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
        libs = []
        for name, lib, proc in procs:
            log, _ = proc.communicate()
            if proc.returncode:
                sys.exit(f"{name}: nvcc failed\n{log}")
            libs.append((name, ctypes.CDLL(str(lib))))
        nh, dk, dh = 6, 32, 64
        for b, t in ((8, 400), (1, 400), (2, 1024)):
            qkv = torch.randn(b, t, nh * (2 * dk + dh), generator=gen).to(
                dev, torch.bfloat16)
            out = torch.empty(b, t, nh * dh, dtype=qkv.dtype, device=dev)
            v = torch.empty_like(out)
            times = []
            for name, lib in libs:
                fn = lib.psa_attention_fwd
                fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 5 + [
                    ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
                call = (qkv.data_ptr(), out.data_ptr(), v.data_ptr(), b, t,
                        nh, dk, dh, dk ** -0.5, 1,
                        torch.cuda.current_stream().cuda_stream)
                times.append(f"{name} {device_ms(lambda: fn(*call)):.5f}")
            print(f"K1 B={b} T={t}, device ms with nothing / one part left "
                  f"out: " + "; ".join(times), flush=True)


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--ablate", action="store_true")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        sys.exit("no CUDA device")
    dev = torch.device("cuda")
    gen = torch.Generator().manual_seed(0)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    print(f"card: {card}; torch {torch.__version__}", flush=True)
    if args.ablate:
        ablate(gen, dev)
        return
    for name, log in build.build(["attention", "attention_bwd"]).items():
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
