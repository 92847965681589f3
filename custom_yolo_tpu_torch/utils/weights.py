"""Carry the JAX package's variables and train state into the port.

The port names its submodules exactly as the flax modules are named, so a
variable tree maps onto a state dict by a walk: the path of a leaf joined
with dots is the key of its tensor, and only the leaf names change.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping, Optional, Tuple

import numpy as np
import torch
from torch import nn

from custom_yolo_tpu_torch.train.optim import PlateauState, set_learning_rate
from custom_yolo_tpu_torch.train.train_state import TrainState

# (collection, leaf) → state-dict leaf
_LEAF = {
    ("params", "kernel"): "weight",
    ("params", "bias"): "bias",
    ("params", "scale"): "weight",
    ("batch_stats", "mean"): "running_mean",
    ("batch_stats", "var"): "running_var",
}


def _is_quant_leaf(node: Mapping[str, Any]) -> bool:
    """An int8 conv leaf ``{kernel (int8), scale, bias[, in_scale]}``, told
    from a BatchNorm's ``{scale, bias}`` by its int8 kernel."""
    return ("kernel" in node and "scale" in node
            and np.asarray(node["kernel"]).dtype == np.int8)


def _convert(collection: str, path: Tuple[str, ...], value: Any,
             quant: bool = False):
    """One leaf → (state-dict key, tensor). Kernels go HWIO → OIHW; an int8
    conv leaf (``quant``) keeps its int8 kernel and its own leaf names."""
    leaf = path[-1]
    name = "weight" if leaf == "kernel" else (
        leaf if quant else _LEAF.get((collection, leaf), leaf))
    array = np.asarray(value)
    if not (quant and leaf == "kernel"):
        array = array.astype(np.float32)
    if collection == "params" and leaf == "kernel":
        # HWIO (kh, kw, cin/g, cout) → OIHW (cout, cin/g, kh, kw)
        array = array.transpose(3, 2, 0, 1)
    return ".".join(path[:-1] + (name,)), torch.tensor(array)


def _flatten(collection: str, tree: Mapping[str, Any]
             ) -> Dict[str, torch.Tensor]:
    """One collection of a JAX variable tree → tensors by state-dict key."""
    state: Dict[str, torch.Tensor] = {}

    def walk(node: Mapping[str, Any], path: Tuple[str, ...]) -> None:
        quant = collection == "params" and _is_quant_leaf(node)
        for name, value in node.items():
            if isinstance(value, Mapping):
                walk(value, path + (name,))
            else:
                key, tensor = _convert(collection, path + (name,), value,
                                       quant)
                state[key] = tensor

    walk(tree, ())
    return state


def from_jax_variables(tree: Mapping[str, Any],
                       model: nn.Module) -> Dict[str, torch.Tensor]:
    """A JAX variable tree as nested dicts of numpy arrays —
    ``{"params", "batch_stats"}`` unfused or ``{"params"}`` fused, int8
    conv leaves of a quantized tree included — → the state dict of
    ``model`` (which ``load_state_dict(strict=True)``
    accepts). Raises ``ValueError`` on a missing, extra or mis-shaped
    entry."""
    state: Dict[str, torch.Tensor] = {}
    for collection in ("params", "batch_stats"):
        if collection in tree:
            state.update(_flatten(collection, tree[collection]))
    unknown = set(tree) - {"params", "batch_stats"}

    expected = model.state_dict()
    for key, value in expected.items():
        if key.endswith(".num_batches_tracked"):
            state[key] = torch.zeros_like(value)
    # a calibrated int8 conv's input scale, which the module takes on load
    in_scales = {k for k in state if k.endswith(".conv.in_scale")
                 and f"{k[:-len('in_scale')]}scale" in expected}
    missing = sorted(set(expected) - set(state))
    extra = sorted(set(state) - set(expected) - in_scales)
    mismatched = [f"{k}: {tuple(state[k].shape)} vs {tuple(expected[k].shape)}"
                  for k in sorted(set(state) & set(expected))
                  if state[k].shape != expected[k].shape]
    problems = []
    if unknown:
        problems.append(f"unknown collections: {sorted(unknown)}")
    for label, keys in (("missing", missing), ("extra", extra)):
        if keys:
            problems.append(f"{label}: {keys[:8]}"
                            f"{' …' if len(keys) > 8 else ''}")
    if mismatched:
        problems.append("shape mismatches: " + "; ".join(mismatched[:8]))
    if problems:
        raise ValueError("JAX variables do not match this model — "
                         + " | ".join(problems))
    return state


def train_state_from_jax(jax_state: Mapping[str, Any], model: nn.Module,
                         optimizer: torch.optim.Optimizer,
                         rng: Optional[torch.Generator] = None
                         ) -> TrainState:
    """Carry a JAX ``TrainState``, given as plain numpy, into the port's
    :class:`~custom_yolo_tpu_torch.train.train_state.TrainState`, so that
    both packages can go on from the same mid-training state.

    ``jax_state`` holds ``params`` and ``batch_stats`` (variable trees);
    ``mu``, ``nu`` (AdamW moment trees shaped as ``params``) and ``count``
    (AdamW's step count); ``learning_rate`` (the injected hyperparameter);
    ``step``, ``epoch``; ``plateau`` (``scale``, ``best``, ``bad_epochs``);
    and ``ema_params`` / ``ema_batch_stats`` (trees, or None). The values
    are loaded into ``model`` and ``optimizer`` (built on ``model``'s
    parameters), on the device the model lies on. The JAX PRNG key has no
    counterpart: ``rng`` is a generator of the caller's."""
    variables = {"params": jax_state["params"],
                 "batch_stats": jax_state["batch_stats"]}
    model.load_state_dict(from_jax_variables(variables, model), strict=True)
    named = dict(model.named_parameters())
    moments = {name: _flatten("params", jax_state[name])
               for name in ("mu", "nu")}
    if set(moments["mu"]) != set(named) or set(moments["nu"]) != set(named):
        raise ValueError("AdamW moments do not match the model's parameters")
    for key, param in named.items():
        optimizer.state[param] = {
            "step": torch.tensor(float(jax_state["count"])),
            "exp_avg": moments["mu"][key].to(param.device),
            "exp_avg_sq": moments["nu"][key].to(param.device),
        }
    set_learning_rate(optimizer, float(jax_state["learning_rate"]))

    plateau = jax_state["plateau"]
    state = TrainState.create(
        model, optimizer,
        rng if rng is not None else torch.Generator().manual_seed(0),
        ema=jax_state.get("ema_params") is not None)
    state.step = int(jax_state["step"])
    state.epoch = int(jax_state["epoch"])
    state.plateau = PlateauState(
        scale=torch.tensor(float(plateau["scale"]), dtype=torch.float32),
        best=torch.tensor(float(plateau["best"]), dtype=torch.float32),
        bad_epochs=torch.tensor(int(plateau["bad_epochs"]),
                                dtype=torch.int32))
    if state.ema is not None:
        carried = {**_flatten("params", jax_state["ema_params"]),
                   **_flatten("batch_stats", jax_state["ema_batch_stats"])}
        if set(carried) != set(state.ema):
            raise ValueError("EMA trees do not match the model")
        for key, value in carried.items():
            state.ema[key].copy_(value)
    return state
