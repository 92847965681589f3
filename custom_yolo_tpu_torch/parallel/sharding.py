"""The dp and fsdp modes (counterpart of
``custom_yolo_tpu/parallel/sharding.py``: ``replicate`` :37-38,
``batch_sharding`` :41-45, ``_fsdp_spec`` :57-77, ``param_shardings``
:80-90, ``shard_train_state`` :93-141, ``shard_batch`` :144-156).

Both modes keep the JAX package's meaning (its docstring, :1-21):

* **dp**: parameters replicated, the model wrapped in
  ``DistributedDataParallel``, which averages the gradients;
* **fsdp**: parameters of at least ``min_weight_size`` elements that are
  not depthwise kernels are split, with their AdamW moments and their EMA,
  along the axis ``_fsdp_spec`` picks (FSDP2 ``fully_shard``); the others
  stay whole on every rank;
* in both, every rank holds its own rows of the global batch, BatchNorm
  normalises with the global batch's statistics
  (``nn.blocks.ConvBN.global_batch``), and the loss is the global batch's
  (``DetectionLoss(global_batch=True)``). Clipping, warm-up, EMA and the
  plateau state stay the port's own, in the train step.

FSDP2 splits every parameter of a group it manages; it cannot leave one
whole inside a group. The parameters that stay whole are therefore given
to it as ``ignored_params``: they are ordinary tensors on every rank, and
the train step averages their gradients itself
(``TrainState.replicated``).
"""

from __future__ import annotations

import copy
import dataclasses
import inspect
from typing import Any, Dict, Tuple

import numpy as np
import torch
from torch import nn
from torch.distributed.tensor import Placement, Replicate, Shard
from torch.nn.parallel import DistributedDataParallel

from custom_yolo_tpu_torch.core.mesh import DATA_AXIS, FSDP_AXIS
from custom_yolo_tpu_torch.nn.blocks import ConvBN
from custom_yolo_tpu_torch.train.optim import Optimizer
from custom_yolo_tpu_torch.train.train_state import TrainState

# a port parameter's axis for each axis of its JAX counterpart: kernels are
# HWIO there and OIHW here
_OIHW_OF_HWIO = (2, 3, 1, 0)


def replicate(mesh) -> Tuple[Placement, ...]:
    """Whole on every rank of ``mesh``."""
    return (Replicate(),) * mesh.ndim


def batch_sharding(mesh) -> Tuple[Placement, ...]:
    """The batch dim split over every axis of ``mesh``: under fsdp the
    ``fsdp`` axis is a data-parallel axis too (each rank its own rows, in
    the role of a ``DistributedSampler``)."""
    return (Shard(0),) * mesh.ndim


def _fsdp_size(mesh) -> int:
    return mesh[FSDP_AXIS].size()


def _fsdp_axis(jax_shape, fsdp_size: int, min_size: int):
    """``_fsdp_spec``'s choice on a JAX-layout shape: the largest axis that
    the fsdp size divides (the later one among equals), or None for a
    parameter kept whole (too small, depthwise, or no axis divides)."""
    if fsdp_size <= 1 or int(np.prod(jax_shape)) < min_size:
        return None
    if len(jax_shape) == 4 and jax_shape[2] == 1:
        return None       # depthwise kernel: replicated in JAX as well
    order = sorted(range(len(jax_shape)), key=lambda i: (jax_shape[i], i),
                   reverse=True)
    for axis in order:
        if jax_shape[axis] % fsdp_size == 0 and jax_shape[axis] >= fsdp_size:
            return axis
    return None


def param_shardings(model: nn.Module, mesh,
                    min_weight_size: int = 2 ** 16
                    ) -> Dict[str, Placement]:
    """Each parameter's placement on the ``fsdp`` axis, by name:
    ``Shard(dim)`` in the port's OIHW layout along the axis that
    ``_fsdp_spec`` shards in JAX's HWIO layout, or ``Replicate()``.
    ``mesh`` is a mesh of :func:`core.mesh.create_mesh` or the size of its
    ``fsdp`` axis."""
    fsdp_size = mesh if isinstance(mesh, int) else _fsdp_size(mesh)
    out = {}
    for name, p in model.named_parameters():
        shape = tuple(p.shape)
        jax_shape = tuple(shape[i] for i in _OIHW_OF_HWIO) \
            if len(shape) == 4 else shape
        axis = _fsdp_axis(jax_shape, fsdp_size, min_weight_size)
        if axis is None:
            out[name] = Replicate()
        else:
            out[name] = Shard(_OIHW_OF_HWIO[axis] if len(shape) == 4
                              else axis)
    return out


def _fully_shard(model: nn.Module, mesh, placements: Dict[str, Placement]
                 ) -> list:
    """FSDP2 over ``model``: one group for each ConvBN that holds a split
    parameter (its all-gather comes just before its forward), the rest of
    the split parameters in the root's group. Returns the parameters left
    whole."""
    from torch.distributed.fsdp import fully_shard

    sub = mesh[FSDP_AXIS] if mesh[DATA_AXIS].size() == 1 else mesh
    by_param = {p: placements[name] for name, p in model.named_parameters()}
    whole = {p for p, pl in by_param.items() if not isinstance(pl, Shard)}

    def placement(p: nn.Parameter) -> Shard:
        return by_param[p]

    # FSDP2 takes contiguous parameters only (the model keeps its kernels
    # channels_last); the all-gathered kernels are then NCHW
    with torch.no_grad():
        for p in by_param:
            if not p.is_contiguous():
                p.data = p.data.contiguous()
    for module in model.modules():
        if isinstance(module, ConvBN) and any(
                p not in whole for p in module.parameters()):
            fully_shard(module, mesh=sub, shard_placement_fn=placement,
                        ignored_params=whole)
    fully_shard(model, mesh=sub, shard_placement_fn=placement,
                ignored_params=whole)
    return [p for p in model.parameters() if p in whole]


def shard_train_state(state: TrainState, mesh,
                      min_weight_size: int = 2 ** 16) -> TrainState:
    """The state's model made data parallel over ``mesh`` (every rank of
    the default group), as a new state around the same model. Every rank
    must hold the same state (one seed, or one checkpoint).

    * dp (an ``fsdp`` axis of 1): the model is wrapped in DDP, which
      broadcasts rank 0's values; optimizer and EMA stay as they are;
    * fsdp: FSDP2 splits the parameters that :func:`param_shardings`
      splits, the optimizer is rebuilt on the sharded parameters with the
      same hyper-parameters, and the old state's values (moments, EMA,
      counters, plateau, generator) are carried into the new layout; a
      plain replica of the model is kept for the eval forward.

    ConvBN switches to the global batch's statistics either way."""
    model = state.model
    if _fsdp_size(mesh) == 1:
        device = next(model.parameters()).device
        _global_batch_norm(model)
        module = DistributedDataParallel(
            model, device_ids=[device] if device.type == "cuda" else None,
            broadcast_buffers=False)
        return dataclasses.replace(state, module=module)
    payload = state.state_dict()
    eval_model = copy.deepcopy(model)
    _global_batch_norm(model)
    replicated = _fully_shard(
        model, mesh, param_shardings(model, mesh, min_weight_size))
    # one param group holds split and whole parameters, which a foreach
    # kernel may not mix: the update goes parameter by parameter
    optimizer = _rebuilt(state.optimizer, model.parameters(), foreach=False)
    new = TrainState.create(model, optimizer, state.rng,
                            ema=state.ema is not None)
    new.load_state_dict(payload)
    new.module, new.eval_model, new.replicated = (model, eval_model,
                                                  tuple(replicated))
    return new


def _rebuilt(old: torch.optim.Optimizer, params,
             **overrides) -> torch.optim.Optimizer:
    """An optimizer of ``old``'s class over ``params``, with no state and
    the hyper-parameters of ``old``'s one param group (those its class's
    constructor names, ``overrides`` over them) and its ``grad_clip``."""
    if len(old.param_groups) != 1:
        raise ValueError("shard_train_state rebuilds optimizers of one "
                         "param group")
    group = old.param_groups[0]
    # the constructor that names the hyper-parameters (Optimizer passes
    # them on to AdamW's)
    for cls in type(old).__mro__:
        sig = inspect.signature(cls.__init__).parameters
        if not any(p.kind == p.VAR_KEYWORD for p in sig.values()):
            break
    kwargs = {k: group[k] for k in sig if k in group and k != "params"}
    kwargs.update(overrides)
    if isinstance(old, Optimizer):
        return Optimizer(params, old.grad_clip, **kwargs)
    new = type(old)(params, **kwargs)
    if hasattr(old, "grad_clip"):
        new.grad_clip = old.grad_clip
    return new


def _global_batch_norm(model: nn.Module) -> None:
    for m in model.modules():
        if isinstance(m, ConvBN):
            m.global_batch = True


def shard_batch(batch: Dict[str, Any], device: torch.device
                ) -> Dict[str, torch.Tensor]:
    """This rank's rows (its loader's batch) on its card: each process
    loads its own share of the global batch, so no array spans
    processes."""
    return {k: torch.as_tensor(v).to(device, non_blocking=True)
            for k, v in batch.items()}
