#!/usr/bin/env python
"""Digest of a ``scripts/torch_profile.py`` trace (counterpart of
``scripts/analyze_profile.py``): the train step's time per phase, per
phase and layer, per kernel family and per kernel.

Reads the Chrome trace that ``utils/profiling.trace`` writes
(``<dir>/trace.json``, or the newest ``*.json``/``*.json.gz`` there, or
the file ``--dir`` names). Durations are the device time of the trace's
GPU ``kernel``, ``gpu_memcpy`` and ``gpu_memset`` events, divided by the
number of profiled steps. Each device event is attributed by its
``correlation`` id to the runtime call that launched it, and through that
call to the CPU ops and annotations that enclose it on its thread:

* phase: ``bwd`` under an ``autograd::engine::evaluate_function:`` op,
  ``optimizer`` under torch.optim's ``Optimizer.step#…`` annotation or
  the step's ``train/clip``, ``train/optimizer`` and ``train/ema`` spans
  (the global norm and its clipping, AdamW, the EMA), ``loss`` under the
  step's ``train/loss`` span, ``fwd`` under a model stage's span
  (``fwd/<layer>``), ``other`` elsewhere (``zero_grad``, the batch's
  copies); the spans are the port's own (``utils.profiling.span``);
* layer: the stage's span for ``fwd`` (``net.<stage>``, ``fpn.<stage>``,
  ``head``); for ``bwd`` the span of the forward op with the backward
  op's autograd sequence number;
* family: by kernel name, the port's hand-written kernels (K1-K7, by
  their ``csrc`` names) first.

A trace without device events (a CPU capture) falls back to the CPU ops'
self time, as the JAX script falls back to ``/host:CPU``. The TFLOP/s
column comes from the profiler's ``flops`` (``with_flops``: convolutions
and matrix products of the forward), each op's counted once, on the
longest event it launched, over the row's time. The GB/s column prints
``-``: the torch trace records no bytes accessed per kernel, which XLA's
op metadata gives the JAX script.
The header gives the capture's wall ms per step beside the device ms per
step, so the idle share follows.

Usage:
  python scripts/torch_analyze_profile.py [--dir ./dataset/experiments/profiles]
      [--steps 3] [--top 25]
"""

import argparse
import collections
import glob
import gzip
import json
import os

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")
HOST_CATS = ("cpu_op", "user_annotation")
# the port's spans of the step and the model's stages
FWD_PREFIX = "fwd/"
LOSS_SPAN = "train/loss"
OPTIMIZER_SPANS = ("train/clip", "train/optimizer", "train/ema")
BWD_PREFIX = "autograd::engine::evaluate_function:"
OPTIMIZER_PREFIX = "Optimizer.step#"
PORT_FAMILY = "port kernels (K1-K7)"
# the port's kernels by their csrc names (ops/cuda/csrc/*.cu)
PORT_KERNELS = (
    ("K1 psa_attention_fwd", ("psa_attention_fwd",)),
    ("K4 psa_attention_bwd", ("psa_attention_bwd",)),
    ("K2/K3 nms", ("nms_mask_kernel", "nms_sweep_kernel")),
    ("K5 sppf_pyramid", ("sppf_pyramid_kernel",)),
    ("K6 cls_stage", ("cls_stage_kernel",)),
    ("K7 stochastic_round", ("stochastic_round",)),
)
# kernel families, matched in this order on the kernel's name
FAMILIES = (
    ("BatchNorm", ("batch_norm", "batchnorm", "BatchNorm", "bn_fw",
                   "bn_bw")),
    ("cuDNN convolution", ("conv", "fprop", "dgrad", "wgrad", "cudnn",
                           "implicit")),
    ("GEMM", ("gemm", "cutlass", "cublas", "Kernel2", "nvjet")),
    ("multi-tensor (optimizer, norm, clip)", ("multi_tensor",)),
    ("reduction", ("reduce_kernel", "Reduce", "welford", "Welford")),
    ("copy/memset", ("copy", "Copy", "memcpy", "memset", "Memset",
                     "CatArray")),
    ("pooling", ("pool",)),
    ("sort/select/index", ("sort", "Sort", "radix", "scan", "gather",
                           "scatter", "index", "topk")),
    ("elementwise", ("elementwise", "vectorized", "unrolled")),
)


def load_events(path):
    """The ``traceEvents`` of the Chrome trace at ``path``: the file, or
    ``trace.json`` under the directory, else the directory's newest
    ``*.json``/``*.json.gz``."""
    if os.path.isdir(path):
        found = os.path.join(path, "trace.json")
        if not os.path.exists(found):
            names = (glob.glob(os.path.join(path, "*.json"))
                     + glob.glob(os.path.join(path, "*.json.gz")))
            if not names:
                raise SystemExit(f"no Chrome trace under {path}")
            found = max(names, key=os.path.getmtime)
        path = found
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "rt") as f:
        return json.load(f)["traceEvents"]


def _end(e):
    return float(e["ts"]) + float(e.get("dur", 0))


def host_contexts(events):
    """Sweep each thread's host events in start order. Returns (the host
    events enclosing each launch, by correlation id; each host op's
    enclosing host events, itself included, by ``id`` of the event; each
    CPU op's self time in µs, by ``id``)."""
    threads = collections.defaultdict(list)
    for e in events:
        if e.get("ph") == "X" and e.get("cat") in HOST_CATS + LAUNCH_CATS:
            threads[e.get("pid"), e.get("tid")].append(e)
    launches, ops, self_us = {}, {}, {}
    for evs in threads.values():
        evs.sort(key=lambda e: (float(e["ts"]), -float(e.get("dur", 0))))
        stack = []
        for e in evs:
            ts = float(e["ts"])
            while stack and _end(stack[-1]) <= ts:
                stack.pop()
            if e["cat"] in LAUNCH_CATS:
                corr = (e.get("args") or {}).get("correlation")
                if corr is not None:
                    launches[corr] = tuple(stack)
                continue
            if e["cat"] == "cpu_op":
                self_us[id(e)] = float(e.get("dur", 0))
                parent = next((p for p in reversed(stack)
                               if p["cat"] == "cpu_op"), None)
                if parent is not None:
                    self_us[id(parent)] -= float(e.get("dur", 0))
            stack.append(e)
            ops[id(e)] = tuple(stack)
    return launches, ops, self_us


def phase_of(stack):
    names = [e["name"] for e in stack]
    if any(n.startswith(BWD_PREFIX) for n in names):
        return "bwd"
    if any(n.startswith(OPTIMIZER_PREFIX) or n in OPTIMIZER_SPANS
           for n in names):
        return "optimizer"
    if LOSS_SPAN in names:
        return "loss"
    if any(n.startswith(FWD_PREFIX) for n in names):
        return "fwd"
    return "other"


def fwd_layer(stack):
    for e in reversed(stack):
        if e["cat"] == "user_annotation" and e["name"].startswith(FWD_PREFIX):
            return e["name"][len(FWD_PREFIX):]
    return None


def sequence_layers(events, ops):
    """The forward layer of each autograd sequence number: the ``fwd/``
    span around the forward op that carries it."""
    layers = {}
    for e in events:
        seq = (e.get("args") or {}).get("Sequence number")
        if e.get("cat") != "cpu_op" or seq is None \
                or e["name"].startswith(BWD_PREFIX):
            continue
        layer = fwd_layer(ops.get(id(e), ()))
        if layer is not None:
            layers.setdefault(seq, layer)
    return layers


def layer_of(phase, stack, seq_layers):
    if phase == "fwd":
        return fwd_layer(stack) or "-"
    if phase == "bwd":
        for e in stack:
            if e["name"].startswith(BWD_PREFIX):
                seq = (e.get("args") or {}).get("Sequence number")
                return seq_layers.get(seq, "-")
    return "-"


def port_kernel(name):
    return next((label for label, keys in PORT_KERNELS
                 if any(k in name for k in keys)), None)


def family_of(e):
    if e.get("cat") in ("gpu_memcpy", "gpu_memset"):
        return "copy/memset"
    if port_kernel(e["name"]) is not None:
        return PORT_FAMILY
    return next((family for family, keys in FAMILIES
                 if any(k in e["name"] for k in keys)), "other")


def digest(events):
    """Every timed event with its phase, layer, family, name, µs and
    flops: the device events where the trace has any, else the CPU ops
    (by self time). Returns (rows, on the device?)."""
    launches, ops, self_us = host_contexts(events)
    seq_layers = sequence_layers(events, ops)
    device = [e for e in events if e.get("ph") == "X"
              and e.get("cat") in DEVICE_CATS and "dur" in e]
    rows = []
    # each op's FLOPs go to the longest of the events it accounts for
    # (a convolution's kernel, not the copy or memset launched before it)
    longest = {}

    def add(phase, stack, family, name, us):
        rows.append({"phase": phase,
                     "layer": layer_of(phase, stack, seq_layers),
                     "family": family, "name": name, "us": us,
                     "flops": 0.0})
        op = next((e for e in reversed(stack)
                   if (e.get("args") or {}).get("flops")), None)
        if op is not None and (id(op) not in longest
                               or us > rows[longest[id(op)][1]]["us"]):
            longest[id(op)] = (op, len(rows) - 1)

    if device:
        for e in device:
            stack = launches.get((e.get("args") or {}).get("correlation"),
                                 ())
            add(phase_of(stack), stack, family_of(e), e["name"],
                float(e["dur"]))
    else:
        for e in events:
            if e.get("cat") == "cpu_op" and id(e) in self_us:
                stack = ops[id(e)]
                add(phase_of(stack), stack, "cpu op", e["name"],
                    self_us[id(e)])
    for op, row in longest.values():
        rows[row]["flops"] = float(op["args"]["flops"])
    return rows, bool(device)


def aggregate(rows, keyfn, steps, top=None):
    """[key, ms per step, % of the total, TFLOP/s or None, events]
    rows, the longest first."""
    total = sum(r["us"] for r in rows)
    agg = collections.defaultdict(lambda: [0.0, 0.0, 0])
    for r in rows:
        a = agg[keyfn(r)]
        a[0] += r["us"]
        a[1] += r["flops"]
        a[2] += 1
    out = []
    for key, (us, flops, n) in sorted(agg.items(), key=lambda kv: -kv[1][0]):
        out.append([key, us / 1e3 / steps,
                    100 * us / total if total else 0.0,
                    flops / (us / 1e6) / 1e12 if flops and us else None, n])
    return out[:top] if top else out


def print_table(title, table, steps):
    print(f"\n## {title} (per step, {steps}-step capture)")
    print(f"{'key':46s} {'ms':>8s} {'%':>6s} {'TFLOP/s':>8s} "
          f"{'GB/s':>8s} {'ops':>6s}")
    for key, ms, pct, tflops, n in table:
        tf = f"{tflops:8.1f}" if tflops is not None else f"{'-':>8s}"
        print(f"{str(key)[:46]:46s} {ms:8.2f} {pct:6.1f} {tf} "
              f"{'-':>8s} {n:6d}")


def main(argv=None):
    """Print the tables; returns them with the totals per step."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--dir", default="./dataset/experiments/profiles")
    ap.add_argument("--steps", type=int, default=3,
                    help="steps the capture spans (torch_profile.py "
                         "--steps)")
    ap.add_argument("--top", type=int, default=25)
    args = ap.parse_args(argv)

    events = load_events(args.dir)
    rows, on_device = digest(events)
    steps = args.steps
    timed = [e for e in events if e.get("ph") == "X" and "dur" in e]
    wall_ms = ((max(_end(e) for e in timed)
                - min(float(e["ts"]) for e in timed)) / 1e3 / steps
               if timed else 0.0)
    total_ms = sum(r["us"] for r in rows) / 1e3 / steps
    port = collections.Counter(port_kernel(r["name"]) for r in rows
                               if on_device and port_kernel(r["name"]))
    where = "device" if on_device else "CPU op self"
    print(f"total {where} time/step: {total_ms:.2f} ms ({len(rows)} "
          f"{'kernel and copy' if on_device else 'op'} events); capture "
          f"wall/step: {wall_ms:.2f} ms")
    if on_device:
        print(f"port kernels in the capture: {dict(port)}")
    result = {
        "steps": steps, "on_device": on_device, "total_ms": total_ms,
        "wall_ms": wall_ms, "events": len(rows), "port_kernels": dict(port),
        "phase": aggregate(rows, lambda r: r["phase"], steps),
        "phase_layer": aggregate(rows, lambda r: (r["phase"], r["layer"]),
                                 steps, top=args.top),
        "family": aggregate(rows, lambda r: r["family"], steps, top=15),
        "hottest": aggregate(rows, lambda r: r["name"][:46], steps,
                             top=args.top),
    }
    print_table("phase", result["phase"], steps)
    print_table("phase × layer", [[f"{p} {layer}", *rest] for (p, layer),
                                  *rest in result["phase_layer"]], steps)
    print_table("kernel family" if on_device else "op family",
                result["family"], steps)
    print_table("hottest kernels" if on_device else "hottest ops",
                result["hottest"], steps)
    return result


if __name__ == "__main__":
    main()
