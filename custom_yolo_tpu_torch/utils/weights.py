"""Carry the JAX package's variables into the port.

The port names its submodules exactly as the flax modules are named, so a
variable tree maps onto a state dict by a walk: the path of a leaf joined
with dots is the key of its tensor, and only the leaf names change.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping, Tuple

import numpy as np
import torch
from torch import nn

# (collection, leaf) → state-dict leaf
_LEAF = {
    ("params", "kernel"): "weight",
    ("params", "bias"): "bias",
    ("params", "scale"): "weight",
    ("batch_stats", "mean"): "running_mean",
    ("batch_stats", "var"): "running_var",
}


def _convert(collection: str, path: Tuple[str, ...], value: Any):
    key = ".".join(path[:-1] + (_LEAF.get((collection, path[-1]),
                                          path[-1]),))
    array = np.asarray(value, dtype=np.float32)
    if collection == "params" and path[-1] == "kernel":
        # HWIO (kh, kw, cin/g, cout) → OIHW (cout, cin/g, kh, kw)
        array = array.transpose(3, 2, 0, 1)
    return key, torch.tensor(array)


def from_jax_variables(tree: Mapping[str, Any],
                       model: nn.Module) -> Dict[str, torch.Tensor]:
    """A JAX variable tree as nested dicts of numpy arrays —
    ``{"params", "batch_stats"}`` unfused or ``{"params"}`` fused — → the
    state dict of ``model`` (which ``load_state_dict(strict=True)``
    accepts). Raises ``ValueError`` on a missing, extra or mis-shaped
    entry."""
    state: Dict[str, torch.Tensor] = {}

    def walk(collection: str, node: Mapping[str, Any],
             path: Tuple[str, ...]) -> None:
        for name, value in node.items():
            if isinstance(value, Mapping):
                walk(collection, value, path + (name,))
            else:
                key, tensor = _convert(collection, path + (name,), value)
                state[key] = tensor

    for collection in ("params", "batch_stats"):
        if collection in tree:
            walk(collection, tree[collection], ())
    unknown = set(tree) - {"params", "batch_stats"}

    expected = model.state_dict()
    for key, value in expected.items():
        if key.endswith(".num_batches_tracked"):
            state[key] = torch.zeros_like(value)
    missing = sorted(set(expected) - set(state))
    extra = sorted(set(state) - set(expected))
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
