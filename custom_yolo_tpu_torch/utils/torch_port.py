"""Reference PyTorch checkpoints in and out of the port (counterpart of
``custom_yolo_tpu/utils/torch_port.py``).

The reference trainer saves ``torch.save({"model_state":
model.state_dict(), ...})``; its modules are ``nn.Sequential`` slots
(``net.p2.1.res_m.0.conv1.conv.weight``), where the port names its
submodules as the flax modules are named (``net.p2_csp.m0.conv1.conv.
weight``). This module maps one key set onto the other, exactly and both
ways, with its own copy of the JAX package's name map:

* conv weights are OIHW on both sides, so nothing is transposed;
* the reference's ``Conv.norm`` (``BatchNorm2d``) is the port's ConvBN
  ``bn``: ``weight``, ``bias``, ``running_mean``, ``running_var``;
  ``num_batches_tracked`` is ignored on import (the port's counters start
  at 0, as ``from_jax_variables`` sets them) and written as 0 on export;
* the reference's frozen DFL conv (weights pinned to ``arange(reg_max)``)
  has no parameters in the port (``ops/dfl.py``): it is checked on import
  and made up on export.

Import fills the standard unfused state (what ``Detector.init`` builds);
fused, optimised and int8 states come from it through the usual
transforms (``Detector.fuse()`` and the rest).
"""

from __future__ import annotations

import re
from typing import Any, Dict, List, Mapping, Tuple

import torch

# Backbone stage -> reference nn.Sequential slot (src/model/backbone.py:37-52)
_STAGE = {
    "p1_conv": ("p1", "0"),
    "p2_conv": ("p2", "0"), "p2_csp": ("p2", "1"),
    "p3_conv": ("p3", "0"), "p3_csp": ("p3", "1"),
    "p4_conv": ("p4", "0"), "p4_csp": ("p4", "1"),
    "p5_conv": ("p5", "0"), "p5_csp": ("p5", "1"),
    "p5_sppf": ("p5", "2"), "p5_psa": ("p5", "3"),
}

# PSABlock / Attention sub-module names (src/model/model_blocks.py:200-224,
# :158-198): reference PSABlock.conv1 IS the Attention module, conv2 is the
# two-conv MLP Sequential; reference Attention.conv1/conv2 are the depthwise
# positional conv and the output projection.
_INNER = {
    "attn": ("conv1",),
    "ffn1": ("conv2", "0"),
    "ffn2": ("conv2", "1"),
    "pe": ("conv1",),
    "proj": ("conv2",),
}

# Head tower slots (src/model/head.py:45-61): box = Sequential(Conv, Conv,
# Conv2d); cls = Sequential(Conv dw, Conv pw, Conv dw, Conv pw, Conv2d).
_HEAD_RE = re.compile(r"^(box|cls)(\d+)_(\w+)$")
_HEAD_SLOT = {
    "box": {"conv1": "0", "conv2": "1", "out": "2"},
    "cls": {"dw1": "0", "pw1": "1", "dw2": "2", "pw2": "3", "out": "4"},
}

_SEQ_RE = re.compile(r"^(?:m|res)(\d+)$")  # C3K2/PSA m{i}, C3K res{i}

# the port's ConvBN BatchNorm leaves → the reference's Conv.norm leaves
_NORM = ("weight", "bias", "running_mean", "running_var")


def _torch_segments(name: str, path: Tuple[str, ...]) -> Tuple[str, ...]:
    """Port module name → reference state_dict key segment(s)."""
    if len(path) == 1 and path[0] == "net" and name in _STAGE:
        return _STAGE[name]
    if len(path) == 1 and path[0] == "head":
        m = _HEAD_RE.match(name)
        if m:
            tower, level, part = m.groups()
            return (tower, level, _HEAD_SLOT[tower][part])
    m = _SEQ_RE.match(name)
    if m:
        return ("res_m", m.group(1))
    if name in _INNER:
        return _INNER[name]
    # conv1/conv2/conv3/cv1/cv2/qkv, fpn h1..h6: same name on both sides
    return (name,)


Entry = Tuple[str, str]  # (port state-dict key, reference key)


def _nested(keys) -> Dict[str, Any]:
    """Dotted state-dict keys → a tree of dicts whose leaves are the keys."""
    tree: Dict[str, Any] = {}
    for key in keys:
        node = tree
        *path, leaf = key.split(".")
        for part in path:
            node = node.setdefault(part, {})
        node[leaf] = key
    return tree


def _leaf_entries(keys) -> List[Entry]:
    """Every weight of the standard (unfused) state with its reference
    key. Raises on a state that has been transformed (fused, merged,
    quantized): import and export work on the init-shaped state."""
    entries: List[Entry] = []

    def walk(node: Dict[str, Any], path: Tuple[str, ...],
             torch_path: Tuple[str, ...]) -> None:
        port, ref = ".".join(path), ".".join(torch_path)
        if isinstance(node.get("conv"), dict) and "weight" in node["conv"]:
            if "bias" in node["conv"] or "bn" not in node:
                raise ValueError(
                    f"{port} looks fused/transformed — torch interop needs "
                    "the standard unfused tree (Detector.init / pre-fuse "
                    "checkpoint)")
            entries.append((f"{port}.conv.weight", f"{ref}.conv.weight"))
            entries.extend((f"{port}.bn.{leaf}", f"{ref}.norm.{leaf}")
                           for leaf in _NORM)
            return
        if "weight" in node:  # plain conv with bias (head 1x1 finals)
            entries.append((f"{port}.weight", f"{ref}.weight"))
            entries.append((f"{port}.bias", f"{ref}.bias"))
            return
        for name in node:
            if not isinstance(node[name], dict):
                raise ValueError(
                    f"unexpected leaf {'.'.join(path + (name,))} — "
                    "transformed trees (quantized/merged) are not "
                    "importable; convert the standard tree instead")
            walk(node[name], path + (name,),
                 torch_path + _torch_segments(name, path))

    walk(_nested(keys), (), ())
    return entries


def normalize_state_dict(state_dict: Mapping[str, Any]
                         ) -> Dict[str, torch.Tensor]:
    """Values → CPU tensors; strip the DDP/compile wrappers (``module.``,
    ``_orig_mod.``) the way reference users meet them."""
    out = {}
    for key, value in state_dict.items():
        for prefix in ("module.", "_orig_mod."):
            if key.startswith(prefix):
                key = key[len(prefix):]
        out[key] = torch.as_tensor(value).detach().cpu()
    return out


def from_torch_state_dict(state_dict: Mapping[str, Any],
                          template: Mapping[str, torch.Tensor]
                          ) -> Dict[str, torch.Tensor]:
    """Reference ``model.state_dict()`` → the port's state dict matching
    ``template`` (an unfused model's ``state_dict()``, as
    ``Detector.init`` returns it: the expected keys, shapes and dtypes).
    Every template weight must be in the state dict and every state-dict
    weight must be consumed (the frozen DFL conv and the
    ``num_batches_tracked`` counters excepted): silent partial loads are
    how migrations go wrong."""
    sd = normalize_state_dict(state_dict)
    entries = _leaf_entries(k for k in template
                            if not k.endswith(".num_batches_tracked"))

    out: Dict[str, torch.Tensor] = {}
    missing, mismatched = [], []
    consumed = set()
    for port_key, torch_key in entries:
        if torch_key not in sd:
            missing.append(torch_key)
            continue
        consumed.add(torch_key)
        value, ref = sd[torch_key], template[port_key]
        if tuple(value.shape) != tuple(ref.shape):
            mismatched.append(
                f"{torch_key}: torch {tuple(value.shape)} vs "
                f"expected {tuple(ref.shape)}")
            continue
        out[port_key] = value.to(ref.dtype).clone()

    extra = [k for k in sd if k not in consumed
             and not k.endswith("num_batches_tracked")
             and not k.startswith("dfl.") and ".dfl." not in k]
    problems = []
    if missing:
        problems.append(f"missing from state dict: {sorted(missing)[:8]}"
                        f"{' …' if len(missing) > 8 else ''}")
    if extra:
        problems.append(f"unconsumed torch keys: {sorted(extra)[:8]}"
                        f"{' …' if len(extra) > 8 else ''}")
    if mismatched:
        problems.append("shape mismatches: " + "; ".join(mismatched[:8]))
    if problems:
        raise ValueError("torch checkpoint does not match this model "
                         "configuration — " + " | ".join(problems))
    # frozen DFL sanity: if present it must be the arange projection
    for key, value in sd.items():
        if key.endswith("dfl.conv.weight"):
            expect = torch.arange(value.shape[1], dtype=torch.float32
                                  ).reshape(value.shape)
            if not torch.allclose(value.float(), expect):
                raise ValueError(
                    f"{key} is not the frozen arange DFL projection — "
                    "this checkpoint is not from the reference architecture")
    for key, value in template.items():
        if key.endswith(".num_batches_tracked"):
            out[key] = torch.zeros_like(value, device="cpu")
    return out


def to_torch_state_dict(state: Mapping[str, torch.Tensor],
                        reg_max: int = 16) -> Dict[str, torch.Tensor]:
    """Inverse of :func:`from_torch_state_dict`: the port's unfused state
    dict → a CPU state dict the reference model loads with
    ``load_state_dict(strict=True)`` (the frozen DFL weight and zeroed
    ``num_batches_tracked`` counters are made up)."""
    if not any(".bn." in key for key in state):
        raise ValueError("export needs the unfused tree "
                         "(params + batch_stats)")
    out: Dict[str, torch.Tensor] = {}
    for port_key, torch_key in _leaf_entries(
            k for k in state if not k.endswith(".num_batches_tracked")):
        out[torch_key] = state[port_key].detach().to(
            "cpu", torch.float32).clone()
        if torch_key.endswith(".norm.running_var"):
            out[torch_key.replace("running_var", "num_batches_tracked")] = \
                torch.tensor(0, dtype=torch.int64)
    out["head.dfl.conv.weight"] = torch.arange(
        reg_max, dtype=torch.float32).reshape(1, reg_max, 1, 1)
    return out


def load_torch_checkpoint(path: str) -> Dict[str, torch.Tensor]:
    """Read a reference checkpoint file (either a bare ``state_dict`` or the
    trainer's ``{"model_state": ...}`` wrapper, utils_train.py:50-56) into
    a CPU state dict."""
    checkpoint = torch.load(path, map_location="cpu", weights_only=True)
    if isinstance(checkpoint, dict) and "model_state" in checkpoint:
        checkpoint = checkpoint["model_state"]
    return normalize_state_dict(checkpoint)


def import_torch_weights(detector, path: str):
    """Load a reference torch checkpoint into a :class:`Detector` (the
    migration entry point; see ``scripts/torch_import_torch.py``). The
    detector holds the unfused model afterwards."""
    if detector.model is None:
        detector.init()
    state = from_torch_state_dict(load_torch_checkpoint(path),
                                  detector.model.state_dict())
    detector.load_variables(state)
    return detector
