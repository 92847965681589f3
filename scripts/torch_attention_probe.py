"""Probe of the port's PSA attention kernels (K1 forward, K4 backward) on
one NVIDIA GPU.

    python3 scripts/torch_attention_probe.py                 # check and time
    python3 scripts/torch_attention_probe.py --baseline DIR  # and an older K1
    python3 scripts/torch_attention_probe.py --ablate        # where K1's time goes
    python3 scripts/torch_attention_probe.py --faults        # K1's check fails them

The first form builds the two attention libraries, prints their ``ptxas``
report, holds both kernels to their plain twins on ``chip_smoke.py``'s
``ATTN_CASES`` (phases 3 and 4b, inputs from ``chip_smoke.attn_qkv``),
dk=64, dh=128 in bf16 and fp32, and dk=64, dh=32 in bf16, and prints
device times (profiler, 20 calls back to back) of K1 at the shapes the
benchmark's cells call it with (``TIMED``: x640's B=8 and B=1 and n640's
B=64 at T=400, T=1024, x4k's PSA and YOLO12's two area calls at T=8,160),
the
4K frames' K1 time, K4 and ``scaled_dot_product_attention`` forward and
backward at x640's shape, K1 and K4 on fp32 tensors there, and the device
symbol of each K1 kernel the trace saw.

``--baseline DIR`` takes the ``csrc/`` directory of an earlier commit
whose ``attention.cu`` exports the same ``psa_attention_fwd`` (unpack the
commit with ``git archive`` into a git-ignored directory), builds it into
a directory of its own, prints its largest error against the twin beside
the port's on every bf16 case, and times the two in turns (baseline,
port, port, baseline) at ``TIMED``. ``--ablate`` builds copies of
``attention.cu``, each with one part of a key-tile step left out
(``ABLATIONS``; results then are wrong, only their time is read), and
times them at the 4K shapes. ``--faults`` builds copies of
``attention.cu`` with a planted fault each (``FAULTS``) and holds them,
and the port, to phase 3's check on the two 4K cases, with q and k at
gain 1 and at the case's ``chip_smoke.ATTN_GAIN``: each fault has to fail
it at the gain. Exits non-zero if a check fails.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import subprocess
import sys
import tempfile
from pathlib import Path

import torch
import torch.nn.functional as F

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import chip_smoke  # noqa: E402
from custom_yolo_tpu_torch.ops import attention  # noqa: E402
from custom_yolo_tpu_torch.ops.cuda import build  # noqa: E402

X = (8, 400, 6, 32, 64)
X4K = (1, 8160, 6, 32, 64)
Y12_P4, Y12_P5 = (4, 8160, 12, 32, 32), (1, 8160, 12, 32, 32)
N640 = (64, 400, 2, 32, 64)
CASES = chip_smoke.ATTN_CASES + (((1, 130, 2, 64, 128), chip_smoke.BOTH),
                                 ((2, 130, 2, 64, 32), (torch.bfloat16,)))
TIMED = (X, (1, 400, 6, 32, 64), N640, (2, 1024, 6, 32, 64), X4K, Y12_P4,
         Y12_P5)
# K1 calls of one 4K frame: x's PSA twice; YOLO12's area attention 8 times
# over p4's 4 strips and 8 times over p5's one
FRAMES = {"x4k": ((X4K, 2),), "y12x4k": ((Y12_P4, 8), (Y12_P5, 8))}
# one part of the key-tile step each, left out of a copy of
# attention.cu: (name, its text there, what replaces it)
ABLATIONS = (
    ("exponentials", "          const float p = psa::exp2_approx(\n"
     "              __fmaf_rn(sc[mb][n][i], c_log2, -m[mb][i >> 1]));",
     "          const float p = __fmaf_rn(sc[mb][n][i], c_log2, "
     "-m[mb][i >> 1]);"),
    ("Q·Kᵀ products", "        psa::mma(sc[mb][2 * c], qf[mb][kk], kb[0], "
     "kb[1]);\n        psa::mma(sc[mb][2 * c + 1], qf[mb][kk], kb[2], "
     "kb[3]);", "        sc[mb][2 * c][0] += __uint_as_float(qf[mb][kk][0] "
     "^ kb[0]);"),
    ("P·V products", "        psa::mma(acc[mb][2 * n], pa[mb], vb[0], "
     "vb[1]);\n        psa::mma(acc[mb][2 * n + 1], pa[mb], vb[2], "
     "vb[3]);", "        acc[mb][2 * n][0] += __uint_as_float(pa[mb][0] "
     "^ vb[0]);"),
    ("rescale", "  if (__any_sync(0xffffffffu, grew)) {", "  if (key0 == 0) {"),
    ("copy issue", "    stage(s + psa::STAGES - 1);", ""),
    ("wait and barrier", "    psa::cp_async_wait<psa::STAGES - 2>();\n"
     "    __syncthreads();", ""),
)
# faults the check has to catch, each planted in a copy of attention.cu:
# (name, its text there, what replaces it)
FAULTS = (
    ("scale +2%", "scale * 1.4426950408889634f;",
     "scale * 1.4426950408889634f * 1.02f;"),
    ("output +5%", "const float inv_l[2] = {1.f / psa::reduce_quad_sum(",
     "const float inv_l[2] = {1.05f / psa::reduce_quad_sum("),
    ("first key tile dropped", "    if (s + 1 < tiles)\n      attend_tile",
     "    if (s == 0) {\n    } else if (s + 1 < tiles)\n      attend_tile"),
    ("keys shifted by a tile", "k_stream.copy(kt, key0, seq, c_qkv);",
     "k_stream.copy(kt, (s + 1) % tiles * TILE, seq, c_qkv);"),
)


def copies(tmp: str, edits) -> list:
    """(name, source) of attention.cu and of a copy of it for each (name,
    text, replacement) of ``edits``, the copies written into ``tmp``."""
    source = (build.CSRC / "attention.cu").read_text()
    (Path(tmp) / "attention_tiles.cuh").write_text(
        (build.CSRC / "attention_tiles.cuh").read_text())
    sources = [("none", build.CSRC / "attention.cu")]
    for i, (name, text, repl) in enumerate(edits):
        if source.count(text) != 1:
            chip_smoke.fail(f"{name!r}: its text is not in attention.cu")
        path = Path(tmp) / f"edited{i}.cu"
        path.write_text(source.replace(text, repl))
        sources.append((name, path))
    return sources


def qkv_of(shape, gen, dev, dtype=torch.bfloat16):
    b, t, nh, dk, dh = shape
    return torch.randn(b, t, nh * (2 * dk + dh), generator=gen).to(dev, dtype)


def compile_to(tmp: str, names_sources) -> dict:
    """Build each (name, source), all at once; the loaded libraries by
    name. A source's headers are found beside it."""
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


def k1_of(lib):
    """K1 of a built ``attention.cu``, launched as the wrapper launches it
    (outputs allocated per call)."""
    fn = lib.psa_attention_fwd
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 5 + [
        ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int

    def call(qkv, nh, dk, dh):
        b, t, _ = qkv.shape
        out = torch.empty(b, t, nh * dh, dtype=qkv.dtype, device=qkv.device)
        v = torch.empty_like(out)
        err = fn(qkv.data_ptr(), out.data_ptr(), v.data_ptr(), b, t, nh, dk,
                 dh, dk ** -0.5, int(qkv.dtype == torch.bfloat16),
                 torch.cuda.current_stream().cuda_stream)
        chip_smoke.check(err == 0, f"K1 launch failed: {err}")
        return out, v
    return call


def check(gen, dev, old) -> bool:
    ok = True
    for shape, dtypes in CASES:
        b, t, nh, dk, dh = shape
        qkv32 = chip_smoke.attn_qkv(shape, gen).to(dev)
        do32 = torch.randn(b, t, nh * dh, generator=gen).to(dev)
        dv32 = torch.randn(b, t, nh * dh, generator=gen).to(dev)
        for dtype in dtypes:
            qkv = qkv32.to(dtype)
            ref_out, ref_v = chip_smoke.by_item(
                attention.psa_attention_reference, qkv, nh, dk, dh)
            out, v = attention.psa_attention(qkv, nh, dk, dh)
            fwd_err = (out.float() - ref_out.float()).abs().max().item()
            share = chip_smoke.tol_share(out, ref_out,
                                         chip_smoke.ATTN_TOL[dtype])
            v_exact = torch.equal(v, ref_v)
            good = v_exact
            tol = chip_smoke.ATTN_TOL[dtype]
            good &= torch.allclose(out.float(), ref_out.float(), atol=tol,
                                   rtol=tol)
            note = ""
            if dtype == torch.bfloat16:
                # against the float64 attention: the twin, the port and,
                # with --baseline, the earlier kernel
                outs = {"twin": ref_out, "port": out}
                if old:
                    old_out, old_v = old(qkv, nh, dk, dh)
                    old_err = (old_out.float() - ref_out.float()).abs().max()
                    note = f" (baseline {old_err.item()})"
                    good &= torch.equal(old_v, ref_v)
                    outs["baseline"] = old_out
                far = dict.fromkeys(outs, 0.0)
                for i in range(b):
                    want = exact(qkv[i:i + 1], nh, dk, dh)
                    for name, o in outs.items():
                        far[name] = max(far[name], (want - o[i:i + 1].double())
                                        .abs().max().item())
                note += f"; against float64 {far}"
            del ref_out, ref_v
            args = (qkv, do32.to(dtype), dv32.to(dtype), nh, dk, dh)
            got, again = (attention.psa_attention_bwd(*args) for _ in "12")
            g = got.float()
            r = chip_smoke.by_item(attention.psa_attention_bwd_reference,
                                   *args).float()
            bwd_err = (g - r).abs().max().item()
            cos = chip_smoke.cosine(g, r)
            if dtype == torch.bfloat16:
                good &= torch.allclose(g, r, atol=0.15, rtol=0.15) \
                    and cos > 0.999
            else:
                good &= bwd_err <= 1e-4
            good &= torch.equal(got, again)
            ok &= bool(good)
            print(f"{shape} {dtype}: out max abs err {fwd_err}{note} "
                  f"(tolerance {tol}, {share:.4f} of it), v exact {v_exact}, "
                  f"dqkv err {bwd_err}, cosine {cos:.7f}, "
                  f"{'ok' if good else 'BAD'}", flush=True)
            del g, r, got, again
    return ok


def k1_names(qkv, nh, dk, dh) -> list:
    """The device symbols of the kernels one K1 call launches, as a
    trace names them."""
    acts = [torch.profiler.ProfilerActivity.CUDA]
    with tempfile.TemporaryDirectory() as tmp:
        with torch.profiler.profile(activities=acts) as prof:
            attention.psa_attention(qkv, nh, dk, dh)
            torch.cuda.synchronize()
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    return sorted({e["name"] for e in events if e.get("cat") == "kernel"})


def exact(qkv, nh, dk, dh) -> torch.Tensor:
    """The attention in float64 from the bf16 inputs, p not rounded: what
    every bf16 route approximates."""
    b, t, _ = qkv.shape
    x = qkv.double().reshape(b, t, nh, 2 * dk + dh)
    s = torch.einsum("bqhd,bkhd->bhqk", x[..., :dk], x[..., dk:2 * dk])
    p = torch.softmax(s * dk ** -0.5, dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", p, x[..., 2 * dk:]).reshape(
        b, t, nh * dh)


def timings(gen, dev, old, card) -> None:
    rows = {}
    for shape in TIMED:
        _, _, nh, dk, dh = shape
        qkv = qkv_of(shape, gen, dev)
        turns = ("baseline", "port", "port", "baseline") if old else ("port",)
        for side in turns:
            call = old if side == "baseline" else attention.psa_attention
            rows.setdefault(side, {}).setdefault(str(shape), []).append(
                chip_smoke.device_ms(lambda: call(qkv, nh, dk, dh)))
        print(json.dumps({"k1": str(shape), "device_ms": {
            side: rows[side][str(shape)] for side in rows}, "card": card,
            "symbols": k1_names(qkv, nh, dk, dh)}), flush=True)
    for frame, calls in FRAMES.items():
        for side in rows:
            ms = sum(n * min(rows[side][str(shape)]) for shape, n in calls)
            print(f"{frame}: K1 {ms:.4f} device ms a frame ({side})",
                  flush=True)
    b, t, nh, dk, dh = X
    qkv = qkv_of(X, gen, dev)
    do = torch.randn(b, t, nh * dh, generator=gen).to(dev, torch.bfloat16)
    q4 = qkv.view(b, t, nh, 2 * dk + dh).transpose(1, 2)
    q, k, v = (x.detach().clone().requires_grad_()
               for x in (q4[..., :dk], q4[..., dk:2 * dk], q4[..., 2 * dk:]))
    out = F.scaled_dot_product_attention(q, k, v)
    do4 = do.view(b, t, nh, dh).transpose(1, 2)
    qkv32, do32 = qkv.float(), do.float()
    others = {
        "SDPA": lambda: F.scaled_dot_product_attention(q, k, v),
        "K4 bf16": lambda: attention.psa_attention_bwd(qkv, do, do, nh, dk,
                                                       dh),
        "SDPA backward": lambda: torch.autograd.grad(out, (q, k, v), do4,
                                                     retain_graph=True),
        "K1 fp32": lambda: attention.psa_attention(qkv32, nh, dk, dh),
        "K4 fp32": lambda: attention.psa_attention_bwd(qkv32, do32, do32, nh,
                                                       dk, dh),
    }
    for name, fn in others.items():
        print(f"{name} {X}: {chip_smoke.device_ms(fn):.5f} device ms",
              flush=True)


def ablate(gen, dev, tmp) -> None:
    libs = compile_to(tmp, copies(tmp, ABLATIONS))
    for shape in (X4K, Y12_P4, Y12_P5):
        _, _, nh, dk, dh = shape
        qkv = qkv_of(shape, gen, dev)
        times = {name: round(chip_smoke.device_ms(
            lambda call=k1_of(lib): call(qkv, nh, dk, dh)), 5)
            for name, lib in libs.items()}
        print(json.dumps({"k1": str(shape), "device_ms_without": times}),
              flush=True)


def faults(gen, dev, tmp) -> bool:
    """Phase 3's check (``ATTN_TOL`` as atol and rtol against the twin) on
    the port and each planted fault, at the 4K cases, with q and k at gain
    1 and at the case's gain; each result's share of the limit (> 1
    fails). True where the port passes and every fault fails at the
    gain."""
    libs = compile_to(tmp, copies(tmp, FAULTS))
    tol = chip_smoke.ATTN_TOL[torch.bfloat16]
    ok = True
    for shape, gain in chip_smoke.ATTN_GAIN.items():
        _, _, nh, dk, dh = shape
        for g in (1.0, gain):
            qkv = chip_smoke.attn_qkv(shape, gen, g).to(dev, torch.bfloat16)
            ref, _ = chip_smoke.by_item(attention.psa_attention_reference,
                                        qkv, nh, dk, dh)
            shares = {name: round(chip_smoke.tol_share(
                k1_of(lib)(qkv, nh, dk, dh)[0], ref, tol), 4)
                for name, lib in libs.items()}
            if g == gain:
                ok &= shares["none"] <= 1 and min(
                    v for name, v in shares.items() if name != "none") > 1
            print(json.dumps({"k1": str(shape), "gain": g, "ref_abs_max": ref
                              .float().abs().max().item(),
                              "share_of_tolerance": shares}), flush=True)
            del ref
    return ok


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--ablate", action="store_true")
    parser.add_argument("--faults", action="store_true")
    parser.add_argument("--baseline", help="a csrc/ directory of an earlier "
                        "commit, whose K1 is checked and timed beside the "
                        "port's")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        chip_smoke.fail("no CUDA device: this probe runs on the GPU")
    dev = torch.device("cuda")
    gen = torch.Generator().manual_seed(0)
    card = chip_smoke.card_line()
    print(f"card: {card}; torch {torch.__version__}", flush=True)
    for name, log in build.build(["attention", "attention_bwd"]).items():
        for line in log.splitlines():
            if "Compiling entry" in line or "registers" in line \
                    or "spill" in line:
                print(f"{name}: {line.strip()}", flush=True)
    with tempfile.TemporaryDirectory() as tmp:
        if args.ablate:
            ablate(gen, dev, tmp)
            return
        if args.faults:
            sys.exit(0 if faults(gen, dev, tmp) else 1)
        old = None
        if args.baseline:
            lib = compile_to(tmp, [("baseline", Path(args.baseline)
                                    / "attention.cu")])["baseline"]
            old = k1_of(lib)
        ok = check(gen, dev, old)
        timings(gen, dev, old, card)
    sys.exit(0 if ok else 1)


if __name__ == "__main__":
    os.environ.setdefault("PYTHONUNBUFFERED", "1")
    main()
