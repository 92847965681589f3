#!/usr/bin/env python
"""Multi-card report (counterpart of ``scripts/multichip_report.py``): run
the port's sharded train step on a ``data × fsdp`` mesh of ``--devices``
ranks, count every collective it issues and its bytes from a
``torch.profiler`` trace, hold each count to the one that the model's
modules predict, and price the step with the H100 SXM's published
figures. Writes ``docs/MULTICHIP_TORCH.md`` (never ``docs/MULTICHIP.md``,
the JAX script's).

The mesh, model and batch are the JAX script's: ``MeshSpec(data=2,
fsdp=n//2)`` for an even n (else ``(1, n)``), the toy model or
``--preset``, bf16, a global batch of ``max(n, 8)`` seeded images
(``RandomState(0)``), the nearest assigner, ``TrainingConfig()``'s AdamW
and ``min_weight_size=1024``. The script starts its own ``--devices``
ranks (child processes of one process group), as the JAX script makes its
own virtual devices. Each rank takes one warm-up step, then one counted
step under the profiler (``record_shapes``). A mesh with
an fsdp axis of 1 is DDP; otherwise FSDP2 splits the large parameters
along ``fsdp`` and, with a ``data`` axis above 1, replicates them along it
(hybrid sharding).

Each ``c10d::*`` op of the counted step is put down to the code that
issued it, from the ops and spans that enclose it:

* ``batch_norm``: the global-batch BatchNorm's float64 ``all_reduce``
  (``torch.distributed.nn``'s autograd function ``_AllReduce``), one in
  each training ConvBN forward and one in its backward;
* ``loss``: ``DetectionLoss._global_sum`` (span ``collective/loss``);
* ``average_gradients``: the train step's average of the parameters
  FSDP2 leaves whole (``collective/average_gradients``);
* ``grad_norm``: ``train.optim.global_norm`` over the fsdp axis
  (``collective/grad_norm``);
* ``fsdp_all_gather`` (forward, and in backward for every group that
  reshards after its forward, which the root does not),
  ``fsdp_reduce_scatter`` and ``fsdp_all_reduce`` (the data axis of the
  hybrid mesh): FSDP2, one of each a group;
* ``ddp_bucket``: DDP's bucketed gradient ``all_reduce``, issued by its
  C++ reducer, one a bucket (the buckets that
  ``_compute_bucket_assignment_by_size`` packs from the parameters in
  backward order);
* ``ddp_rebuild``: DDP's two broadcasts of its rebuilt bucket order from
  rank 0, once, in the forward of its second step (the counted one);
* ``other``: anything else (predicted: none).

A collective's bytes are those of its larger tensor (an all-gather's
output, a reduce-scatter's input), from the trace's ``Input Dims`` and
``Input type``.

Usage:
  python scripts/torch_multichip_report.py --devices 4 --device cpu
  python scripts/torch_multichip_report.py --preset x --input_size 640 \\
      --devices 4 --device cuda [--trace_out rank0_trace.json]

On the card the ranks use NCCL, one card each, when there are enough
cards; otherwise (or with ``--backend gloo``) they share the cards over
gloo, and the report says so. The last line of the output is
``[INFO] results: {json}``.
"""

import argparse
import collections
import json
import math
import os
import socket
import subprocess
import sys
import time

STARTED = time.perf_counter()
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# the repository root in place of this script's directory, whose
# profile.py would shadow the standard library's (torch imports it)
if sys.path and os.path.abspath(sys.path[0] or ".") == os.path.join(
        REPO, "scripts"):
    sys.path[0] = REPO
elif REPO not in sys.path:
    sys.path.insert(0, REPO)

# H100 SXM per-card figures, published (NVIDIA H100 datasheet): dense bf16
# tensor-core rate, HBM3 bandwidth, NVLink 4 bandwidth in one direction
H100_BF16_TFLOPS = 989.0
H100_HBM_GBS = 3350.0
H100_NVLINK_GBS = 450.0

TOY = dict(width=(3, 16, 32, 64, 128, 128), depth=(1, 1, 1, 1, 1, 1),
           csp=(False, True))
MIN_WEIGHT_SIZE = 1024
MAX_GT = 8
RESULTS_LINE = "[INFO] results: "

SOURCES = ("batch_norm", "loss", "average_gradients", "grad_norm",
           "fsdp_all_gather", "fsdp_reduce_scatter", "fsdp_all_reduce",
           "ddp_bucket", "ddp_rebuild", "other")
# the trace's dtype names
_TYPE_BYTES = {"float": 4, "double": 8, "c10::BFloat16": 2, "c10::Half": 2,
               "int": 4, "long int": 8, "signed char": 1,
               "unsigned char": 1, "bool": 1}


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--devices", type=int, default=8,
                   help="ranks (the mesh's size)")
    p.add_argument("--out", default="docs/MULTICHIP_TORCH.md")
    p.add_argument("--preset", default=None,
                   help="model preset (default: the toy model)")
    p.add_argument("--input_size", type=int, default=64)
    p.add_argument("--num_classes", type=int, default=16)
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    p.add_argument("--backend", default=None, choices=["nccl", "gloo"],
                   help="process-group backend (nccl when every rank has "
                        "a card of its own, else gloo)")
    p.add_argument("--trace_out", default=None,
                   help="also write rank 0's Chrome trace of the counted "
                        "step here")
    # one rank of the run, started by the script itself
    p.add_argument("--rank", type=int, default=None, help=argparse.SUPPRESS)
    p.add_argument("--addr", default=None, help=argparse.SUPPRESS)
    p.add_argument("--result", default=None, help=argparse.SUPPRESS)
    args = p.parse_args(argv)
    if args.devices < 2:
        p.error("--devices must be at least 2")
    return args


def mesh_shape(n: int) -> tuple:
    """(data, fsdp): the JAX script's mesh for ``n`` devices."""
    return (2, n // 2) if n % 2 == 0 else (1, n)


def synthetic_batch(n: int, input_size: int, num_classes: int) -> dict:
    """The JAX script's global batch, as numpy."""
    import numpy as np

    rng = np.random.RandomState(0)
    return {
        "images": rng.rand(n, input_size, input_size, 3).astype(np.float32),
        "gt_boxes": (rng.rand(n, MAX_GT, 4).astype(np.float32)
                     * (input_size / 2) + 8),
        "gt_labels": rng.randint(0, num_classes, (n, MAX_GT)).astype(
            np.int32),
        "gt_mask": rng.rand(n, MAX_GT) > 0.5,
    }


def widths(preset):
    if preset is None:
        return TOY
    from custom_yolo_tpu_torch.models.presets import PRESETS
    return {k: PRESETS[preset][k] for k in ("width", "depth", "csp")}


def build_step(args, device, global_batch: bool,
               precision: str = "bfloat16"):
    """The port's model (seed 0), state and loss: ``TrainingConfig()``'s
    AdamW and the nearest assigner, bf16 unless ``precision`` says
    otherwise."""
    import torch

    from custom_yolo_tpu_torch.config import TrainingConfig
    from custom_yolo_tpu_torch.models.detector import create_train_model
    from custom_yolo_tpu_torch.train.losses import DetectionLoss, LossConfig
    from custom_yolo_tpu_torch.train.optim import build_optimizer
    from custom_yolo_tpu_torch.train.train_state import TrainState

    w = widths(args.preset)
    model = create_train_model(w["width"], w["depth"], w["csp"],
                               args.num_classes, precision=precision,
                               device=device, seed=0)
    optimizer = build_optimizer(model.parameters(), TrainingConfig())
    state = TrainState.create(model, optimizer, torch.Generator())
    loss_fn = DetectionLoss(LossConfig(num_classes=args.num_classes,
                                       assigner="nearest"),
                            global_batch=global_batch)
    return model, state, loss_fn


# ------------------------------------------------------------ one rank
def _arguments(args: dict) -> list:
    """(dims, dtype) of each tensor argument in a trace event's ``args``; a
    tensor list's first tensor with dtype ``None``, which the trace does
    not record."""
    out = []
    for dims, dtype in zip(args.get("Input Dims") or (),
                           args.get("Input type") or ()):
        if dtype == "TensorList":
            if dims and isinstance(dims[0], list):
                out.append((tuple(dims[0]), None))
        elif dtype and dtype != "Scalar" and isinstance(dims, list):
            out.append((tuple(dims), dtype))
    return out


def _nbytes(args: dict, dtypes: dict) -> int:
    """The bytes of the larger tensor argument of a collective op; a tensor
    list's type is the backend's record of the same dims."""
    best = 0
    for dims, dtype in _arguments(args):
        dtype = dtype or dtypes.get(dims)
        best = max(best, math.prod(dims) * _TYPE_BYTES.get(dtype, 0))
    return best


def classify(name: str, chain: list, ddp: bool) -> tuple:
    """(source, pass) of a ``c10d::*`` op of the counted step; ``chain``
    names the ops and spans that enclose it, innermost first."""
    text = " | ".join(chain)
    backward = "autograd::engine" in text
    if "FSDP::all_gather" in text:
        return "fsdp_all_gather", "backward" if (
            "FSDP::pre_backward" in text or "backward_prefetch" in text
        ) else "forward"
    if "FSDP::post_backward_reduce" in text:
        if name.startswith("c10d::_reduce_scatter"):
            return "fsdp_reduce_scatter", "backward"
        return "fsdp_all_reduce", "backward"
    # global-batch BatchNorm reduces through torch.distributed.nn's
    # autograd function _AllReduce, and nothing else of the port does
    if "_AllReduceBackward" in text:
        return "batch_norm", "backward"
    if "_AllReduce" in chain:
        return "batch_norm", "forward"
    for source in ("loss", "average_gradients", "grad_norm"):
        if f"collective/{source}" in chain:
            return source, "forward" if source == "loss" else "step"
    if ddp and name.startswith("c10d::allreduce") and backward:
        return "ddp_bucket", "backward"
    if ddp and name.startswith("c10d::broadcast") and \
            "DistributedDataParallel.forward" in text:
        return "ddp_rebuild", "forward"
    return "other", "backward" if backward else "forward"


def count_collectives(trace_path: str, ddp: bool) -> tuple:
    """{(source, pass, op): [count, bytes]} over the ``c10d::*`` ops of a
    Chrome trace, and the host milliseconds they took. Each op's
    enclosing spans come from its thread's nesting; a tensor list's type,
    which the trace leaves out, from the backend's own records of its
    collectives (``gloo:*``, ``nccl:*``) with the same dims."""
    with open(trace_path) as f:
        events = json.load(f)["traceEvents"]
    threads = collections.defaultdict(list)
    dtypes = {}
    for e in events:
        if e.get("ph") != "X" or "dur" not in e:
            continue
        threads[e.get("pid"), e.get("tid")].append(e)
        if e.get("name", "").startswith(("gloo:", "nccl:")):
            for dims, dtype in _arguments(e.get("args") or {}):
                if dtype is not None:
                    dtypes[dims] = (dtype if dtypes.get(dims, dtype) == dtype
                                    else None)
    stats = collections.defaultdict(lambda: [0, 0])
    host_us = 0.0
    for spans in threads.values():
        spans.sort(key=lambda e: (e["ts"], -e["dur"]))
        open_spans = []
        for e in spans:
            while open_spans and (open_spans[-1]["ts"] + open_spans[-1]["dur"]
                                  <= e["ts"]):
                open_spans.pop()
            if e["name"].startswith("c10d::"):
                chain = [e["name"]] + [o["name"] for o in open_spans[::-1]]
                source, pas = classify(e["name"], chain, ddp)
                key = (source, pas, e["name"])
                stats[key][0] += 1
                stats[key][1] += _nbytes(e.get("args") or {}, dtypes)
                host_us += e["dur"]
            open_spans.append(e)
    return stats, host_us / 1e3


def ddp_bucket_count(params, cap_bytes: int) -> int:
    """The buckets DDP packs ``params`` into when it rebuilds them: its
    first bucket of ``dist._DEFAULT_FIRST_BUCKET_BYTES``, then buckets of
    ``cap_bytes``, filled in the order the gradients come (backward: the
    parameters' order reversed)."""
    import torch.distributed as dist

    buckets, _ = dist._compute_bucket_assignment_by_size(
        list(reversed(params)),
        [dist._DEFAULT_FIRST_BUCKET_BYTES, cap_bytes])
    return len(buckets)


def predict(plain_model, placements, spec: tuple, n_metrics: int,
            ddp_buckets: int) -> dict:
    """Each source's count and bytes for one step, from the model's modules
    and the parameters' placements (``parallel.sharding.param_shardings``
    of a plain copy): {source: [count, bytes]}."""
    from torch.distributed.tensor import Shard

    from custom_yolo_tpu_torch.nn.blocks import ConvBN

    data, fsdp = spec
    convbns = [m for m in plain_model.modules()
               if isinstance(m, ConvBN) and m.bn is not None]
    out = {s: [0, 0] for s in SOURCES}
    out["batch_norm"] = [2 * len(convbns), 2 * sum(
        (2 * m.bn.num_features + 1) * 8 for m in convbns)]
    # the nearest assigner: the rank's image count, then the metrics
    out["loss"] = [2, 4 * (1 + n_metrics)]
    params = dict(plain_model.named_parameters())
    if fsdp == 1:
        out["ddp_bucket"] = [ddp_buckets, sum(
            p.numel() * p.element_size() for p in params.values())]
        # int32: every parameter's index and the bucket count, then each
        # bucket's size
        out["ddp_rebuild"] = [2, 4 * (len(params) + 1) + 4 * ddp_buckets]
        return out
    split = {k for k, pl in placements.items() if isinstance(pl, Shard)}
    whole = set(params) - split
    if whole:
        out["average_gradients"] = [1, sum(
            params[k].numel() * params[k].element_size() for k in whole)]
    out["grad_norm"] = [1, 4]
    # FSDP2's groups: each ConvBN that holds a split parameter, and the root
    # with the split parameters outside them (parallel.sharding._fully_shard)
    groups, grouped = [], set()
    for name, m in plain_model.named_modules():
        if isinstance(m, ConvBN):
            mine = {f"{name}.{k}" for k, _ in m.named_parameters()} & split
            if mine:
                groups.append(mine)
                grouped |= mine
    root = split - grouped
    nbytes = {k: params[k].numel() * params[k].element_size()
              for k in split}
    gathered = sum(nbytes.values())
    again = sum(nbytes[k] for g in groups for k in g)
    out["fsdp_all_gather"] = [len(groups) * 2 + bool(root),
                              gathered + again]
    out["fsdp_reduce_scatter"] = [len(groups) + bool(root), gathered]
    if data > 1:
        out["fsdp_all_reduce"] = [len(groups) + bool(root),
                                  gathered // fsdp]
    return out


def count_flops(model, loss_fn, batch) -> int:
    """The FLOPs of convolutions and matrix products in one forward and
    backward of ``model`` (a plain copy, no collective) on ``batch``, by
    ``FlopCounterMode``. Not over the sharded step itself: under a
    dispatch mode bf16 ops round otherwise (the step's gradient norm moved
    by 0.2% on the CPU)."""
    from torch.utils.flop_counter import FlopCounterMode

    from custom_yolo_tpu_torch.train.losses import DetectionLoss

    counter = FlopCounterMode(display=False)
    with counter:
        preds, anchors, strides = model(batch["images"])
        loss, _ = DetectionLoss(loss_fn.cfg)(
            preds, anchors, strides, batch["gt_boxes"], batch["gt_labels"],
            batch["gt_mask"])
        loss.backward()
    model.zero_grad(set_to_none=True)
    return counter.get_total_flops()


def run_rank(args) -> None:
    """One rank: join the group, shard, take a warm-up step and a counted
    step under the profiler, then (rank 0) count one step's FLOPs on a
    plain copy of the model; write the results to ``args.result``."""
    import copy
    import faulthandler

    import torch
    from torch.distributed.tensor import DTensor, Shard
    from torch.nn.parallel import DistributedDataParallel
    from torch.profiler import ProfilerActivity, profile

    from custom_yolo_tpu_torch.core.mesh import (MeshSpec, create_mesh,
                                                 initialize_distributed)
    from custom_yolo_tpu_torch.parallel.multihost import build_kernels
    from custom_yolo_tpu_torch.parallel.sharding import (param_shardings,
                                                         shard_batch,
                                                         shard_train_state)
    from custom_yolo_tpu_torch.train.train_step import make_train_step
    from custom_yolo_tpu_torch.utils.profiling import kernel_launches

    faulthandler.enable()
    world, rank = args.devices, args.rank
    if args.device == "cpu":
        torch.set_num_threads(1)
    dev = initialize_distributed(args.addr, world, rank, device=args.device,
                                 backend=args.backend)
    if dev.type == "cuda":
        build_kernels()
    spec = mesh_shape(world)
    mesh = create_mesh(MeshSpec(*spec), device_type=dev.type)
    model, state, loss_fn = build_step(args, dev, global_batch=True)
    plain = copy.deepcopy(model)
    placements = param_shardings(plain, spec[1], MIN_WEIGHT_SIZE)
    state = shard_train_state(state, mesh, min_weight_size=MIN_WEIGHT_SIZE)
    ddp = isinstance(state.module, DistributedDataParallel)
    step = make_train_step(state.module or model, loss_fn, state.optimizer)
    n = max(world, 8) // world
    data = synthetic_batch(max(world, 8), args.input_size, args.num_classes)
    batch = shard_batch({k: v[rank * n:(rank + 1) * n]
                         for k, v in data.items()}, dev)

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    metrics = []
    setup_s = time.perf_counter() - STARTED
    t0 = time.perf_counter()
    state, m = step(state, batch)
    sync()
    warmup_ms = (time.perf_counter() - t0) * 1e3
    metrics.append({k: float(v) for k, v in m.items()})
    acts = [ProfilerActivity.CPU]
    if dev.type == "cuda" and rank == 0 and args.trace_out:
        acts.append(ProfilerActivity.CUDA)
    with profile(activities=acts, record_shapes=True) as p:
        t0 = time.perf_counter()
        state, m = step(state, batch)
        sync()
        counted_ms = (time.perf_counter() - t0) * 1e3
    metrics.append({k: float(v) for k, v in m.items()})
    launches = kernel_launches()
    flops = count_flops(plain, loss_fn, batch) if rank == 0 else 0
    t0 = time.perf_counter()
    trace = args.result + ".trace.json"
    if rank == 0 and args.trace_out:
        trace = os.path.abspath(args.trace_out)
        os.makedirs(os.path.dirname(trace), exist_ok=True)
    p.export_chrome_trace(trace)
    stats, host_ms = count_collectives(trace, ddp)
    trace_s = time.perf_counter() - t0
    buckets = ddp_bucket_count(
        list(plain.parameters()),
        state.module._get_ddp_logging_data()["bucket_cap_bytes"]) \
        if ddp else 0
    prediction = predict(plain, placements, spec, len(metrics[-1]) - 1,
                         buckets)
    split_bytes = sum(q.numel() * q.element_size()
                      for k, q in plain.named_parameters()
                      if isinstance(placements[k], Shard))
    result = {
        "rank": rank, "device": str(dev), "mesh": list(spec),
        "backend": torch.distributed.get_backend(),
        "collectives": [[s, ps, op, c, b] for (s, ps, op), (c, b)
                        in sorted(stats.items())],
        "prediction": prediction,
        "sharded_params": sum(isinstance(q, DTensor)
                              for q in model.parameters()),
        "whole_params": sum(not isinstance(q, DTensor)
                            for q in model.parameters()),
        "params": sum(q.numel() for q in plain.parameters()),
        "split_param_bytes": split_bytes,
        "ddp_buckets": buckets,
        "metrics": metrics, "flops": flops,
        "images_a_rank": n, "warmup_ms": warmup_ms, "setup_s": setup_s,
        "trace_s": trace_s,
        "cards": torch.cuda.device_count() if dev.type == "cuda" else 0,
        "counted_ms": counted_ms, "collective_host_ms": host_ms,
        "launches": launches,
    }
    with open(args.result, "w") as f:
        json.dump(result, f)
    torch.distributed.destroy_process_group()


# -------------------------------------------------------------- the run
def spawn(args, argv, work: str, timeout: float = 900) -> list:
    """Start ``args.devices`` ranks of this script on a free port; returns
    each rank's results. A rank's failure raises with its output."""
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    procs = []
    for rank in range(args.devices):
        cmd = [sys.executable, os.path.abspath(__file__), *argv,
               "--rank", str(rank), "--addr", f"localhost:{port}",
               "--result", os.path.join(work, f"rank{rank}.json")]
        procs.append(subprocess.Popen(
            cmd, cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True))
    try:
        outs = [p.communicate(timeout=timeout)[0] for p in procs]
    finally:
        for p in procs:
            p.kill()
    for rank, (p, out) in enumerate(zip(procs, outs)):
        if p.returncode != 0:
            raise RuntimeError(f"rank {rank} exited with {p.returncode}:\n"
                               f"{out[-6000:]}")
    results = []
    for rank in range(args.devices):
        with open(os.path.join(work, f"rank{rank}.json")) as f:
            results.append(json.load(f))
    return results


def card_line() -> str:
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            check=True).stdout.strip().splitlines()[0]
    except (OSError, subprocess.CalledProcessError, IndexError):
        return "no nvidia-smi"


def summarise(results: list) -> dict:
    """Rank 0's counts by source, each against its prediction, and whether
    every rank counted the same."""
    r0 = results[0]
    by_source = {s: {"count": 0, "bytes": 0, "ops": {}} for s in SOURCES}
    for source, pas, op, count, nbytes in r0["collectives"]:
        entry = by_source[source]
        entry["count"] += count
        entry["bytes"] += nbytes
        key = f"{op} ({pas})"
        c, b = entry["ops"].get(key, (0, 0))
        entry["ops"][key] = (c + count, b + nbytes)
    for s in SOURCES:
        pc, pb = r0["prediction"][s]
        by_source[s].update(predicted_count=pc, predicted_bytes=pb,
                            match=by_source[s]["count"] == pc
                            and by_source[s]["bytes"] == pb)
    return {"by_source": by_source,
            "ranks_agree": all(r["collectives"] == r0["collectives"]
                               for r in results[1:]),
            "all_match": all(v["match"] for v in by_source.values())}


# the group each source's collective runs over: (axis, size of the group)
def _group(source: str, spec: tuple) -> tuple:
    data, fsdp = spec
    return {"grad_norm": ("fsdp", fsdp), "fsdp_all_gather": ("fsdp", fsdp),
            "fsdp_reduce_scatter": ("fsdp", fsdp),
            "fsdp_all_reduce": ("data", data)}.get(
                source, ("data × fsdp", data * fsdp))


def _link_ms(source: str, nbytes: int, spec: tuple) -> float:
    """Time on one card's NVLink for a ring collective of ``nbytes`` over
    its group: 2(n−1)/n of the payload for an all-reduce, (n−1)/n for an
    all-gather or a reduce-scatter."""
    n = _group(source, spec)[1]
    if n <= 1:
        return 0.0
    factor = (n - 1) / n * (1 if source in ("fsdp_all_gather",
                                            "fsdp_reduce_scatter") else 2)
    return nbytes * factor / (H100_NVLINK_GBS * 1e9) * 1e3


ISSUED_IN = {
    "batch_norm": "`nn/blocks.py` `ConvBN._global_batch_norm` (forward) "
                  "and its `all_reduce`'s backward",
    "loss": "`train/losses.py` `DetectionLoss._global_sum`",
    "average_gradients": "`train/train_step.py` `_average_gradients`",
    "grad_norm": "`train/optim.py` `global_norm`",
    "fsdp_all_gather": "FSDP2, each group's parameters (forward; again "
                       "in backward where the group resharded)",
    "fsdp_reduce_scatter": "FSDP2, each group's gradients",
    "fsdp_all_reduce": "FSDP2 (hybrid), each group's gradient shards "
                       "over `data`",
    "ddp_bucket": "DDP's reducer, one a gradient bucket",
    "ddp_rebuild": "DDP's one-time bucket rebuild (the forward of its "
                   "second step)",
    "other": "none of the above",
}


def write_report(args, argv, results: list, summary: dict, card: str,
                 seconds: float) -> None:
    r0 = results[0]
    spec = tuple(r0["mesh"])
    world = args.devices
    if r0["device"].startswith("cuda"):
        shared = ("NCCL, one card a rank" if r0["backend"] == "nccl" else
                  f"sharing {r0['cards']} card(s) over gloo, which stages "
                  "CUDA tensors through the host")
    else:
        shared = "gloo on the host's CPU"
    flops = r0["flops"] * world
    measured = f"(measured; {card})" if args.device == "cuda" \
        else "(measured on the host's CPU)"
    mode = "DDP" if spec[1] == 1 else (
        "FSDP2, hybrid: split along `fsdp`, replicated along `data`"
        if spec[0] > 1 else "FSDP2")
    # the flags that shape the run (not where its files go)
    shown, skip = [], False
    for a in argv:
        if skip or a in ("--out", "--trace_out"):
            skip = not skip
            continue
        shown.append(a)
    lines = [
        "# Multi-card report (the PyTorch port's collectives)",
        "",
        f"Generated by `scripts/torch_multichip_report.py "
        f"{' '.join(shown)}`: the port's train step on {world} ranks, "
        "every collective counted from a `torch.profiler` trace of one "
        "step after a warm-up step, and held to the count that the "
        "model's modules predict. The JAX package's counterpart, from "
        "compiled HLO, is `docs/MULTICHIP.md`.",
        "",
        f"- probe: preset `{args.preset or 'toy'}`, input "
        f"{args.input_size}², {args.num_classes} classes, bf16, "
        f"{r0['params']:,} parameters",
        f"- mesh: `{{'data': {spec[0]}, 'fsdp': {spec[1]}}}` ({mode}); "
        f"{r0['sharded_params']} parameters split, {r0['whole_params']} "
        "whole (`min_weight_size` 1024)",
        f"- ranks: {world} on `{r0['device'].split(':')[0]}`, "
        f"{shared}; global batch {r0['images_a_rank'] * world} "
        f"({r0['images_a_rank']} a rank), nearest assigner, AdamW",
        f"- device: {card if args.device == 'cuda' else 'CPU'}",
        f"- every rank counted the same collectives: "
        f"**{'yes' if summary['ranks_agree'] else 'NO'}**; every count and "
        f"byte total equals its prediction: "
        f"**{'yes' if summary['all_match'] else 'NO'}**",
        "",
        "## Collectives of one step, by what issued them (each rank)",
        "",
        f"Counted in this run {measured}.",
        "",
        "Bytes are those of a collective's larger tensor (an all-gather's "
        "output, a reduce-scatter's input).",
        "",
        "| source | issued in | group | ops | predicted count | counted "
        "| predicted bytes | counted bytes | equal |",
        "|---|---|---|---|---|---|---|---|---|",
    ]
    for s in SOURCES:
        v = summary["by_source"][s]
        if not (v["count"] or v["predicted_count"]):
            continue
        axis, size = _group(s, spec)
        ops = "; ".join(f"`{k}` ×{c}" for k, (c, _) in
                        sorted(v["ops"].items()))
        lines.append(
            f"| {s} | {ISSUED_IN[s]} | {axis} ({size}) | {ops} | "
            f"{v['predicted_count']} | {v['count']} | "
            f"{v['predicted_bytes']:,} | {v['bytes']:,} | "
            f"{'yes' if v['match'] else 'NO'} |")
    total_count = sum(v["count"] for v in summary["by_source"].values())
    total_bytes = sum(v["bytes"] for v in summary["by_source"].values())
    link_ms = sum(_link_ms(s, v["bytes"], spec)
                  for s, v in summary["by_source"].items())
    compute_ms = flops / world / (H100_BF16_TFLOPS * 1e12) * 1e3
    # AdamW reads a parameter, its gradient and two moments and writes
    # three, fp32, for each element a rank holds
    local = r0["params"] - r0["split_param_bytes"] // 4 * (
        spec[1] - 1) // spec[1]
    adam_ms = 7 * 4 * local / (H100_HBM_GBS * 1e9) * 1e3
    lines += [
        "",
        f"Total: **{total_count}** collectives, **{total_bytes:,} bytes** "
        "a rank a step.",
        "",
        "## A model of one step on H100 SXM cards, from published figures",
        "",
        "Not a measurement. The constants are the H100 SXM's published "
        f"figures: bf16 dense {H100_BF16_TFLOPS:g} TFLOP/s, HBM3 "
        f"{H100_HBM_GBS / 1e3:g} TB/s, NVLink 4 "
        f"{H100_NVLINK_GBS:g} GB/s each way.",
        "",
        f"- **compute**: {flops / 1e9:,.1f} GFLOP a step (convolutions and "
        "matrix products, forward and backward, counted with "
        "`torch.utils.flop_counter.FlopCounterMode` over one forward and "
        "backward of rank 0's rows on a plain copy of the model, times "
        f"{world} ranks) → {compute_ms:.3f} ms a card at the full bf16 "
        "rate;",
        f"- **links**: the counted bytes as ring collectives over each "
        "source's group (2(n−1)/n of the payload for an all-reduce, "
        f"(n−1)/n for an all-gather or a reduce-scatter) → "
        f"{link_ms:.3f} ms a card at the NVLink rate, before any overlap "
        "with compute; each of the "
        f"{total_count} collectives also pays a launch latency that this "
        "model does not price;",
        f"- **optimizer**: AdamW over the {local:,} fp32 elements a card "
        f"holds (7 × 4 bytes each) → {adam_ms:.3f} ms at the HBM rate.",
        "",
        "## Measured in this run",
        "",
        f"Transport: {shared}. These times are of that transport, not of "
        "NVLink. The counted step ran under the profiler (shapes "
        "recorded), which slows its host side.",
        "",
        f"- rank 0 from its start to its first step (imports, group, "
        f"model, sharding): {r0['setup_s']:.1f} s {measured}",
        f"- warm-up step, rank 0: "
        f"{r0['warmup_ms']:.1f} ms {measured}",
        f"- counted step, each rank: "
        f"{', '.join(f'{r['counted_ms']:.1f}' for r in results)} ms "
        f"{measured}",
        f"- host time in `c10d::*` ops of the counted step, rank 0: "
        f"{r0['collective_host_ms']:.1f} ms {measured}",
        f"- writing and reading the trace, rank 0: {r0['trace_s']:.1f} s "
        f"{measured}",
        f"- step `total_loss` / `grad_norm` (warm-up, counted): "
        f"{', '.join(str(m['total_loss']) for m in r0['metrics'])} / "
        f"{', '.join(str(m['grad_norm']) for m in r0['metrics'])} "
        f"{measured}",
        f"- the whole run, ranks' start-up included: {seconds:.1f} s "
        f"{measured}",
    ]
    out = os.path.join(REPO, args.out) if not os.path.isabs(args.out) \
        else args.out
    os.makedirs(os.path.dirname(out), exist_ok=True)
    with open(out, "w") as f:
        f.write("\n".join(lines) + "\n")


def main(argv=None) -> dict:
    argv = list(sys.argv[1:] if argv is None else argv)
    args = parse_args(argv)
    if args.rank is not None:
        run_rank(args)
        return {}
    import tempfile

    if args.device == "cuda" and args.backend is None:
        import torch

        if not torch.cuda.is_available():
            raise SystemExit("--device cuda needs a CUDA device")
        args.backend = ("nccl" if torch.cuda.device_count() >= args.devices
                        else "gloo")
    rank_argv = [a for a in argv]
    if args.backend and "--backend" not in rank_argv:
        rank_argv += ["--backend", args.backend]
    card = card_line() if args.device == "cuda" else "CPU"
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as work:
        results = spawn(args, rank_argv, work)
    seconds = time.perf_counter() - t0
    summary = summarise(results)
    write_report(args, argv, results, summary, card, seconds)
    r0 = results[0]
    launches = collections.Counter()
    for r in results:
        launches.update(r["launches"])
    out = {"out": args.out, "mesh": {"data": r0["mesh"][0],
                                     "fsdp": r0["mesh"][1]},
           "backend": r0["backend"], "device": r0["device"], "card": card,
           "ranks_agree": summary["ranks_agree"],
           "all_match": summary["all_match"],
           "by_source": summary["by_source"],
           "split_param_bytes": r0["split_param_bytes"],
           "sharded_params": r0["sharded_params"],
           "whole_params": r0["whole_params"],
           "ddp_buckets": r0["ddp_buckets"],
           "metrics": r0["metrics"], "flops": r0["flops"] * args.devices,
           "launches": dict(launches), "seconds": seconds,
           "counted_ms": [r["counted_ms"] for r in results]}
    print(f"wrote {args.out}")
    for s, v in out["by_source"].items():
        print(f"{s:20s} {v['count']:5d} {v['bytes']:>14,} B  predicted "
              f"{v['predicted_count']:5d} {v['predicted_bytes']:>14,} B")
    print(RESULTS_LINE + json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
