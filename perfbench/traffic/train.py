"""Training traffic: the step that ``make_train_step`` returns, back to
back on device-resident batches made from the seed, the host reading the
step's metrics every ``log_interval`` steps.

Mix parameters: ``batch``, ``ring`` (distinct batches, trained in turn),
``slots`` (ground-truth slots an image), ``boxes_mean`` (boxes an image:
Poisson(boxes_mean − 1) + 1), ``texture`` (the amplitude of the per-pixel
noise over each image, in 0-255 levels), ``log_interval``, ``checked_steps`` (the
first steps, run in set-up through the window's own call and compared
with the reference), ``trace_skip`` and ``trace_steps`` (the traced part
of a ``--trace 1`` window, whole multiples of ``log_interval``), and the
optimizer's settings: ``lr``, ``weight_decay``, ``grad_clip``,
``ema_decay``, ``ema_tau``, ``assigner``.

One object, the train state with its model and optimizer, is built, run
through the checked steps and handed to the window. The comparison holds
each checked step's loss, the gradient the optimizer received at the
first step (from its first moment: ``m₁ = (1 − β₁)·g``), and the change
of every parameter and EMA leaf over the checked steps, leaf by leaf.
It holds one step of the window as well, the last as far as the pace
foretells it: the state is copied before it and read after it, outside
the timing, and the reference takes that one step from the copy on the
same batch (it follows the program from the program's own state there;
the checked steps hold the start).
"""

from __future__ import annotations

import gc
import time
from typing import Any, Dict, List

import torch

from perfbench import trace as tr
from perfbench.reference import loss as rl
from perfbench.reference.model import Reference, state_layout
from perfbench.weights import make_state, scene_batches

BETA1 = 0.9


class SpannedLoss:
    """The program's loss, called inside a ``loss/assign`` span."""

    def __init__(self, inner):
        self.inner = inner

    def __call__(self, *args):
        with torch.profiler.record_function(tr.LOSS_SPAN):
            return self.inner(*args)


# batches or steps after the traced part of a window, at the least
REST_ITEMS = 20


def build_step(cfg: Dict[str, Any], mix: Dict[str, Any], state_dict, dev):
    """The program's train state and step, on the seeded weights, and the
    loss the step calls."""
    from custom_yolo_tpu_torch.config import TrainingConfig
    from custom_yolo_tpu_torch.models.detector import create_train_model
    from custom_yolo_tpu_torch.train.losses import DetectionLoss, LossConfig
    from custom_yolo_tpu_torch.train.optim import build_optimizer
    from custom_yolo_tpu_torch.train.train_state import TrainState
    from custom_yolo_tpu_torch.train.train_step import make_train_step

    model = create_train_model(cfg["width"], cfg["depth"], cfg["csp"],
                               cfg["num_classes"], cfg["reg_max"],
                               precision=cfg["precision"], device=dev)
    model.load_state_dict(state_dict, strict=True)
    opt = build_optimizer(model.parameters(), TrainingConfig(
        learning_rate=mix["lr"], weight_decay=mix["weight_decay"],
        grad_clip=mix["grad_clip"]))
    state = TrainState.create(model, opt, torch.Generator(), ema=True)
    loss = SpannedLoss(DetectionLoss(LossConfig(
        num_classes=cfg["num_classes"], reg_max=cfg["reg_max"],
        assigner=mix["assigner"])))
    step = make_train_step(model, loss, opt, ema_decay=mix["ema_decay"],
                           ema_tau=mix["ema_tau"])
    return model, opt, state, step, loss


def before_step(r, model, opt, state, names) -> Dict[str, Any]:
    """The train state as the compared window step starts: parameters,
    BatchNorm statistics, AdamW's moments and step count, the EMA and its
    step. Returns once the copies are made."""
    with torch.no_grad():
        params = dict(model.named_parameters())
        moments = [opt.state.get(params[k], {}) for k in names]
        snap = {
            "params": {k: params[k].detach().clone() for k in names},
            "running": {k: v.detach().clone()
                        for k, v in model.state_dict().items()
                        if ".running_" in k},
            "m": {k: m["exp_avg"].clone() for k, m in zip(names, moments)
                  if "exp_avg" in m},
            "v": {k: m["exp_avg_sq"].clone() for k, m in zip(names, moments)
                  if "exp_avg_sq" in m},
            "t": int(moments[0]["step"]) if "step" in moments[0] else 0,
            "ema": {k: v.clone() for k, v in state.ema.items()},
            "ema_step": state.step}
    r.sync()
    return snap


def after_step(model, opt, state, names, before, metrics
               ) -> Dict[str, Any]:
    """The compared window step's readings: its loss, the clipped gradient
    AdamW received (``(m − β₁·m_before) / (1 − β₁)``) and the change of
    every parameter and EMA leaf, by leaf norms."""
    with torch.no_grad():
        params = dict(model.named_parameters())
        grad = {}
        for k in names:
            m = opt.state.get(params[k], {}).get("exp_avg")
            m0 = before["m"].get(k)
            if m is None:
                grad[k] = torch.zeros_like(params[k])
            else:
                grad[k] = (m - BETA1 * m0 if m0 is not None else m) / (
                    1 - BETA1)
        out = {"loss": [float(metrics["total_loss"])],
               "grad": rl.leaf_norms(grad)}
        out["delta"] = rl.leaf_norms({k: params[k].detach()
                                      - before["params"][k] for k in names})
        out["delta"].update(rl.leaf_norms({
            f"ema.{k}": v - before["ema"][k] for k, v in state.ema.items()}))
    return out


def run(r) -> Dict[str, Any]:
    cfg, mix, seed = r.config, r.mix, r.seed
    dev = r.device
    layout = state_layout(cfg["width"], cfg["depth"], cfg["csp"],
                          cfg["num_classes"], cfg["reg_max"])
    batches = scene_batches(seed, mix["ring"], mix["batch"],
                            tuple(cfg["input_size"]), cfg["num_classes"],
                            mix["slots"], mix["boxes_mean"], dev,
                            texture=mix["texture"])
    r.mark("imports, layout and batches")
    model, opt, state, step, _ = build_step(cfg, mix, make_state(layout, seed, dev,
                                                              mix["bn_gain"]), dev)
    r.mark("train state built")
    spans = None
    if r.trace:
        spans = tr.Spans(tr.model_stages(model))
        tr.warm_profiler()

    def one(i):
        with torch.profiler.record_function(tr.STEP):
            return step(state, batches[i % mix["ring"]])[1]

    # the checked steps, which also warm every shape of the step up; the
    # first step's head output is kept as the forward hands it to the loss
    names = [k for k, _ in model.named_parameters()]
    params = dict(model.named_parameters())
    losses, seen = [], {}
    def keep_preds(module, inputs, output):
        seen.setdefault("preds1", output[0].detach().float())

    hook = model.register_forward_hook(keep_preds)
    for i in range(mix["checked_steps"]):
        losses.append(one(i)["total_loss"].detach().clone())
        if i == 0:
            hook.remove()
            # a first moment the optimizer never made reads as zero
            first = {k: opt.state.get(params[k], {}).get(
                "exp_avg", torch.zeros_like(params[k])) / (1 - BETA1)
                for k in names}
            seen["grad"] = rl.leaf_norms(first)
            del first
    start = make_state(layout, seed, dev, mix["bn_gain"])
    seen["delta"] = rl.leaf_norms({k: params[k].detach() - start[k]
                                   for k in names})
    seen["delta"].update(rl.leaf_norms({
        f"ema.{k}": v - start[k] for k, v in state.ema.items()}))
    seen["loss"] = [float(x) for x in losses]
    seen["preds1"] = seen["preds1"].cpu()
    del start
    r.sync()
    r.reset_peak()
    r.mark("checked steps run")

    log = mix["log_interval"]
    first = mix["checked_steps"]
    trace_from = mix["trace_skip"] if r.trace else -1
    # a traced run ends with an untraced rest, whose pace the idle share
    # and the utilisation read
    rest = REST_ITEMS if r.trace else 0
    trace_to = trace_from + mix["trace_steps"] if r.trace else -1
    prof = window = t_rest = None
    window_step = None     # the step of the window that is compared
    paused = 0.0           # the snapshots around it, outside the timing
    gc.collect()
    gc.disable()           # no collector pauses inside the window
    setup_s = time.time() - r.t_start
    t0 = time.perf_counter()
    n = 0
    while (time.perf_counter() - t0 - paused < r.seconds
           or n < trace_to + rest or window_step is None):
        if n == trace_from:
            prof = tr.profiler()
            prof.start()
            window = torch.profiler.record_function(tr.WINDOW)
            window.__enter__()
        timed = time.perf_counter() - t0 - paused
        # the last step, as far as the pace so far foretells it
        if window_step is None and not trace_from <= n < trace_to and (
                timed + 1.5 * timed / max(n, 1) >= r.seconds):
            r.sync()
            t_pause = time.perf_counter()
            window_step = before_step(r, model, opt, state, names)
            paused += time.perf_counter() - t_pause
            metrics = one(first + n)
            r.sync()
            t_pause = time.perf_counter()
            seen["window"] = after_step(model, opt, state, names,
                                        window_step, metrics)
            window_step["batch"] = (first + n) % mix["ring"]
            paused += time.perf_counter() - t_pause
        else:
            metrics = one(first + n)
        n += 1
        if n % log == 0:
            float(metrics["total_loss"])       # the host reads the metrics
        if n == trace_to:
            window.__exit__(None, None, None)
            prof.stop()
            t_rest = time.perf_counter() - paused
    r.sync()
    t_end = time.perf_counter() - paused
    gc.enable()
    elapsed = t_end - t0
    out: Dict[str, Any] = {
        "setup_s": setup_s, "attempted": n, "failed": 0,
        "device": r.device_record(),
        "end_to_end": {"train_img_s": n * mix["batch"] / elapsed}}
    if spans is not None:
        spans.remove()
        rest = n - trace_to
        out["digest"] = tr.Digest(tr.export_events(prof), mix["trace_steps"],
                                  mix["trace_steps"] * mix["batch"],
                                  rest=(rest, rest * mix["batch"],
                                        t_end - t_rest))
        del prof
    del model, opt, state, step, params, metrics
    r.free()
    out["compared"] = check(r, batches, seen, window_step)
    return out


def reference_readings(cfg, mix, seed, batches, quant=None
                       ) -> Dict[str, Any]:
    """The reference's (or, with ``quant``, the control's) readings of the
    checked steps: losses, the clipped first gradient's leaf norms, the
    leaves' change (parameters and EMA)."""
    dev = batches[0]["images"].device
    layout = state_layout(cfg["width"], cfg["depth"], cfg["csp"],
                          cfg["num_classes"], cfg["reg_max"])
    start = make_state(layout, seed, dev, mix["bn_gain"])
    ref = Reference(cfg["width"], cfg["depth"], cfg["csp"],
                    cfg["num_classes"], cfg["reg_max"], mode="train",
                    quant=quant)
    names = [k for k in layout if ".running_" not in k
             and not k.endswith("num_batches_tracked")]
    stats = [k for k in layout if ".running_" in k]
    params = {k: start[k].clone().requires_grad_(True) for k in names}
    running = {k: start[k].clone() for k in stats}
    ema = {k: start[k].clone() for k in names + stats}
    opt = rl.AdamW(params, mix["lr"], mix["weight_decay"], mix["grad_clip"])
    out: Dict[str, Any] = {"loss": []}
    for i in range(mix["checked_steps"]):
        batch = batches[i % mix["ring"]]
        preds, anchors, strides = ref({**params, **running},
                                      batch["images"])
        total = rl.tal_loss(preds, anchors, strides, batch["gt_boxes"],
                            batch["gt_labels"], batch["gt_mask"],
                            cfg["num_classes"], cfg["reg_max"])
        grads = dict(zip(names, torch.autograd.grad(
            total, [params[k] for k in names], allow_unused=True)))
        grads = {k: (g if g is not None else torch.zeros_like(params[k]))
                 for k, g in grads.items()}
        out["loss"].append(float(total.detach()))
        if i == 0:
            out["preds1"] = preds.detach()
        del preds, total
        clipped = opt.step(params, grads)
        if i == 0:
            out["grad"] = rl.leaf_norms(clipped)
        running.update(ref.new_stats)
        with torch.no_grad():
            rl.ema_update(ema, {**params, **running}, mix["ema_decay"],
                          mix["ema_tau"], i)
    with torch.no_grad():
        out["delta"] = rl.leaf_norms({k: params[k] - start[k]
                                      for k in names})
        out["delta"].update(rl.leaf_norms({
            f"ema.{k}": ema[k] - start[k] for k in names + stats}))
    return out


def reference_window_step(cfg, mix, snap, batch) -> Dict[str, Any]:
    """The reference's readings of one step taken from the program's state
    as the compared window step started (``before_step``), on that step's
    batch: its loss, the clipped gradient and the leaves' change."""
    ref = Reference(cfg["width"], cfg["depth"], cfg["csp"],
                    cfg["num_classes"], cfg["reg_max"], mode="train")
    names = list(snap["params"])
    params = {k: v.clone().requires_grad_(True)
              for k, v in snap["params"].items()}
    running = {k: v.clone() for k, v in snap["running"].items()}
    preds, anchors, strides = ref({**params, **running}, batch["images"])
    total = rl.tal_loss(preds, anchors, strides, batch["gt_boxes"],
                        batch["gt_labels"], batch["gt_mask"],
                        cfg["num_classes"], cfg["reg_max"])
    grads = dict(zip(names, torch.autograd.grad(
        total, [params[k] for k in names], allow_unused=True)))
    grads = {k: (g if g is not None else torch.zeros_like(params[k]))
             for k, g in grads.items()}
    loss = float(total.detach())
    del preds, total
    opt = rl.AdamW(params, mix["lr"], mix["weight_decay"], mix["grad_clip"])
    opt.m.update({k: v.clone() for k, v in snap["m"].items()})
    opt.v.update({k: v.clone() for k, v in snap["v"].items()})
    opt.t = snap["t"]
    clipped = opt.step(params, grads)
    running.update(ref.new_stats)
    ema = {k: v.clone() for k, v in snap["ema"].items()}
    with torch.no_grad():
        rl.ema_update(ema, {**params, **running}, mix["ema_decay"],
                      mix["ema_tau"], snap["ema_step"])
        delta = rl.leaf_norms({k: params[k] - snap["params"][k]
                               for k in names})
        delta.update(rl.leaf_norms({f"ema.{k}": v - snap["ema"][k]
                                    for k, v in ema.items()}))
    return {"loss": [loss], "grad": rl.leaf_norms(clipped), "delta": delta}


def gaps(seen: Dict[str, Any], ref: Dict[str, Any],
         window: Dict[str, Any] = None, ref_window: Dict[str, Any] = None
         ) -> Dict[str, Any]:
    """The numbers a cell may compare, with the leaves that set the worst
    ones: the gradient's and the change's gaps are the worst over the
    checked steps and, where given, the compared window step; the loss's
    is the checked steps' (the window step's, ``window_loss_gap``, is
    reported and not compared: bf16 alone moves it by up to 1.2%, and no
    fault reads ten times that).
    Leaves whose reference gradient is under a thousandth of the median
    leaf's move by round-off alone and are left out of the change."""
    steps = [(seen, ref)] + ([(window, ref_window)] if window else [])
    loss = max(abs(a - b) / abs(b) for a, b in zip(seen["loss"],
                                                   ref["loss"]))
    grad, grad_leaf, delta, delta_leaf, left_out = 0.0, "", 0.0, "", set()
    for p, q in steps:
        names = list(q["grad"])
        g, g_leaf = rl.worst_leaf_gap(p["grad"], q["grad"], names)
        norms = sorted(q["grad"].values())
        floor = norms[len(norms) // 2] * 1e-3
        moved = [k for k in names if q["grad"][k] >= floor]
        left_out |= set(names) - set(moved)
        d, d_leaf = rl.worst_leaf_gap(p["delta"], q["delta"], moved)
        ema_keys = [k for k in q["delta"] if k.startswith("ema.")
                    and (k[4:] not in q["grad"] or k[4:] in moved)]
        e, e_leaf = rl.worst_leaf_gap(p["delta"], q["delta"], ema_keys)
        if g > grad:
            grad, grad_leaf = g, g_leaf
        if max(d, e) > delta:
            delta, delta_leaf = max(d, e), (d_leaf if d >= e else e_leaf)
    ref1 = ref["preds1"]
    seen1 = seen["preds1"].to(ref1.device)
    ref1 = ref1[:seen1.shape[0]]
    return {"loss_gap": loss, "grad_gap": grad, "delta_gap": delta,
            "preds1_gap": robust_gap(seen1, ref1),
            "grad_median_gap": median_leaf_gap(seen["grad"], ref["grad"],
                                               list(ref["grad"])),
            "window_loss_gap": (abs(window["loss"][0] - ref_window["loss"][0])
                                / abs(ref_window["loss"][0]) if window
                                else None),
            "grad_leaf": grad_leaf, "delta_leaf": delta_leaf,
            "left_out": sorted(left_out)}


def robust_gap(program: torch.Tensor, reference: torch.Tensor) -> float:
    """The median element's |program − reference| over the median
    element's |reference|: the typical element's relative error, which a
    few far-off elements cannot move."""
    d = (program.float() - reference.float()).abs().flatten()
    return float(d.median() / reference.float().abs().flatten().median()
                 .clamp_min(1e-30))


def median_leaf_gap(program, reference, keys) -> float:
    """The median over ``keys`` of each leaf's |program − reference| ÷
    reference."""
    gaps = sorted(abs(program[k] - reference[k]) / max(reference[k], 1e-30)
                  for k in keys)
    return gaps[len(gaps) // 2]


# the numbers a cell may compare (its configuration's limits name them)
CANDIDATES = ("loss_gap", "grad_gap", "delta_gap", "preds1_gap",
              "grad_median_gap")


def check(r, batches, seen, window_step) -> List[Dict[str, Any]]:
    r.exact_fp32()
    ref = reference_readings(r.config, r.mix, r.seed, batches)
    ref_window = reference_window_step(r.config, r.mix, window_step,
                                       batches[window_step["batch"]])
    g = gaps(seen, ref, seen["window"], ref_window)
    r.note(f"losses program {seen['loss']} reference {ref['loss']}; window "
           f"step program {seen['window']['loss']} reference "
           f"{ref_window['loss']} (gap {g['window_loss_gap']:.5f}, not "
           f"compared); worst gradient leaf {g['grad_leaf']}, "
           f"worst change leaf {g['delta_leaf']}; left out of the change: "
           f"{len(g['left_out'])} leaves; numbers "
           f"{({k: g[k] for k in CANDIDATES})}")
    return [r.compare(name, g[name]) for name in r.limits]
