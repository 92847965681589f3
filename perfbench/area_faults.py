"""Faults planted in YOLO12's area attention underneath a run, for the
checks that each one fails the comparison with the reference (the port's
CPU tests, ``perfbench/tests/test_perfbench_y12x4k.py``) and for reading
their numbers on the card (``calibrate_y12.py``). Each acts on the
attention blocks with more than one strip (p4's); nothing here runs in
the benchmark's own runs.

* ``whole_map``: the blocks attend over the whole map instead of their
  strips;
* ``shifted_keys``: each strip attends with the keys of the strip before
  it (the first with the last's), its own queries and values."""

from __future__ import annotations

import contextlib
from typing import Iterator

import torch

AREA = ("whole_map", "shifted_keys")


def _strip_blocks(model):
    return [m for m in model.modules()
            if type(m).__name__ == "AAttn" and m.area > 1]


def _shifted(module):
    """``module.forward`` with the keys of its strips rolled by one."""
    from custom_yolo_tpu_torch.nn import blocks

    forward, area = module.forward, module.area

    def shifted(x):
        inner = blocks.psa_attention

        def rolled(qkv, num_heads, dim_key, dim_head):
            t = qkv.view(-1, area, qkv.shape[1], num_heads,
                         2 * dim_key + dim_head)
            t = torch.cat([t[..., :dim_key],
                           t[..., dim_key:2 * dim_key].roll(1, dims=1),
                           t[..., 2 * dim_key:]], dim=-1)
            return inner(t.reshape(qkv.shape).contiguous(), num_heads,
                         dim_key, dim_head)

        blocks.psa_attention = rolled
        try:
            return forward(x)
        finally:
            blocks.psa_attention = inner
    return shifted


@contextlib.contextmanager
def planted(model, name: str) -> Iterator[None]:
    """The fault ``name`` in the YOLO12 ``model`` for the duration."""
    found = _strip_blocks(model)
    if not found:
        raise ValueError("no attention block with more than one strip")
    areas = [m.area for m in found]
    try:
        for m in found:
            if name == "whole_map":
                m.area = 1
            elif name == "shifted_keys":
                m.forward = _shifted(m)
            else:
                raise ValueError(name)
        yield
    finally:
        for m, area in zip(found, areas):
            m.area = area
            m.__dict__.pop("forward", None)


class _Planted:
    """A detector whose ``serve`` runs with the fault planted (a CUDA
    graph captured then holds it)."""

    def __init__(self, det, name):
        self.det, self.name, self.model = det, name, det.model

    def serve(self, images, **kw):
        with planted(self.det.model, self.name):
            return self.det.serve(images, **kw)


def serving(original, name):
    """A generator's ``build_detector`` with the fault ``name`` planted."""
    def build(cfg, state, device):
        return _Planted(original(cfg, state, device), name)
    return build
