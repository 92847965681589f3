"""Train state (counterpart of ``custom_yolo_tpu/train/train_state.py``):
the model with its parameters and BatchNorm buffers, the optimizer with its
moments and learning rate, step and epoch counters, a random generator,
the plateau scheduler's state and, optionally, an exponential moving
average of the parameters *and* the BatchNorm statistics — everything a
resume needs.

Where the JAX state is an immutable pytree that each step replaces, this
one owns mutable objects and the train step updates them in place.

Under fsdp (``parallel.sharding.shard_train_state``) the large parameters,
their moments and their EMA are ``DTensor``s, each rank holding a shard.
:meth:`TrainState.state_dict` gathers them (a collective: every rank calls
it) and :meth:`TrainState.load_state_dict` takes each rank's shard of the
full values, so a checkpoint has one layout whatever the mode that wrote
it, and any mode restores it.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Sequence

import torch
import torch.distributed as dist
from torch import nn
from torch.distributed.tensor import DTensor, Shard

from custom_yolo_tpu_torch.train.optim import PlateauState, plateau_init


# param-group keys that choose an optimizer's implementation, not its
# arithmetic
_IMPLEMENTATION = ("foreach", "fused", "capturable", "differentiable")


def _is_statistic(name: str) -> bool:
    """BatchNorm running statistics among a model's buffers."""
    return name.endswith(("running_mean", "running_var"))


def full_tensor(t: torch.Tensor) -> torch.Tensor:
    """The whole value of a ``DTensor`` (gathered over its mesh: every rank
    calls this), or ``t`` itself. The shards are even (``parallel.
    sharding`` splits only axes the mesh divides) and are gathered with
    ``dist.all_gather``: ``DTensor.full_tensor``'s functional collective
    crashes under gloo with CUDA tensors (torch 2.11, an H100)."""
    if not isinstance(t, DTensor):
        return t
    full = t.to_local()
    mesh = t.device_mesh
    for mesh_dim, placement in enumerate(t.placements):
        if isinstance(placement, Shard):
            parts = [torch.empty_like(full)
                     for _ in range(mesh.size(mesh_dim))]
            dist.all_gather(parts, full.contiguous(),
                            group=mesh.get_group(mesh_dim))
            full = torch.cat(parts, dim=placement.dim)
    return full


def _shard_of(full: torch.Tensor, like: DTensor) -> torch.Tensor:
    """This rank's shard of ``full`` as ``like`` lays it out (the chunks
    of ``torch.chunk`` along each sharded dim)."""
    mesh = like.device_mesh
    for mesh_dim, placement in enumerate(like.placements):
        if isinstance(placement, Shard):
            full = full.chunk(mesh.size(mesh_dim), dim=placement.dim)[
                mesh.get_local_rank(mesh_dim)]
    return full


def _copy_full(dst: torch.Tensor, value: torch.Tensor) -> None:
    """Copy the whole ``value`` into ``dst``, or into this rank's shard of
    it for a ``DTensor``."""
    if isinstance(dst, DTensor):
        dst.to_local().copy_(_shard_of(value, dst))
    else:
        dst.copy_(value)


@dataclasses.dataclass
class TrainState:
    model: nn.Module
    optimizer: torch.optim.Optimizer
    step: int
    epoch: int
    rng: torch.Generator
    plateau: PlateauState
    # EMA of parameters and BatchNorm statistics, keyed as the state dict
    # (None when disabled). EMA weights paired with the live statistics
    # would be inconsistent, so both are averaged, and evaluation and
    # serving read both from here.
    ema: Optional[Dict[str, torch.Tensor]] = None
    # set by parallel.sharding.shard_train_state: the module the train step
    # calls (the DDP wrapper under dp), a plain replica of the model for
    # the eval forward (fsdp), and the parameters FSDP2 leaves whole, whose
    # gradients the step averages over the ranks itself. None, None, ()
    # on one device: the model is all three.
    module: Optional[nn.Module] = None
    eval_model: Optional[nn.Module] = None
    replicated: Sequence[nn.Parameter] = ()

    @classmethod
    def create(cls, model: nn.Module, optimizer: torch.optim.Optimizer,
               rng: torch.Generator, ema: bool = False) -> "TrainState":
        return cls(model=model, optimizer=optimizer, step=0, epoch=0,
                   rng=rng, plateau=plateau_init(),
                   ema=({k: v.detach().clone()
                         for k, v in cls._tracked(model).items()}
                        if ema else None))

    @staticmethod
    def _tracked(model: nn.Module) -> Dict[str, torch.Tensor]:
        """Parameters and BatchNorm statistics, by state-dict key."""
        out = dict(model.named_parameters())
        out.update((k, v) for k, v in model.named_buffers()
                   if _is_statistic(k))
        return out

    @property
    def variables(self) -> Dict[str, torch.Tensor]:
        """The live parameters and BatchNorm statistics."""
        return {k: v.detach() for k, v in self._tracked(self.model).items()}

    @property
    def eval_variables(self) -> Dict[str, torch.Tensor]:
        """What validation and serving read: the EMA when it is tracked
        (parameters and statistics), else the live values."""
        return self.ema if self.ema is not None else self.variables

    def state_dict(self) -> Dict[str, Any]:
        """Everything a resume needs, as tensors and plain values: the model
        (parameters and buffers), the optimizer (moments, step counts,
        learning rate), step, epoch, plateau, EMA and the generator's
        state. The tensors are the live ones, not copies, except where a
        ``DTensor`` is gathered into its whole value."""
        optimizer = self.optimizer.state_dict()
        optimizer["state"] = {
            i: {k: full_tensor(v) for k, v in moments.items()}
            for i, moments in optimizer["state"].items()}
        return {"model": {k: full_tensor(v)
                          for k, v in self.model.state_dict().items()},
                "optimizer": optimizer,
                "step": self.step, "epoch": self.epoch,
                "plateau": self.plateau._asdict(),
                "ema": (None if self.ema is None else
                        {k: full_tensor(v) for k, v in self.ema.items()}),
                "rng": self.rng.get_state()}

    def load_state_dict(self, state: Dict[str, Any]) -> None:
        """Load :meth:`state_dict`'s output into this state's own objects,
        on their devices and, for ``DTensor``s, into this rank's shards."""
        if (state["ema"] is None) != (self.ema is None):
            raise ValueError("the checkpoint and this state disagree on "
                             "whether an EMA is kept")
        self._load_model(state["model"])
        # how the update runs (foreach, fused) stays this optimizer's own
        kernels = [{k: g[k] for k in _IMPLEMENTATION if k in g}
                   for g in self.optimizer.param_groups]
        self.optimizer.load_state_dict(state["optimizer"])
        for group, own in zip(self.optimizer.param_groups, kernels):
            group.update(own)
        for group in self.optimizer.param_groups:
            for p in group["params"]:
                if isinstance(p, DTensor):
                    moments = self.optimizer.state.get(p, {})
                    for k, v in moments.items():
                        if isinstance(v, torch.Tensor) and \
                                v.shape == p.shape:
                            moments[k] = DTensor.from_local(
                                _shard_of(v, p).clone(), p.device_mesh,
                                p.placements)
        self.step = int(state["step"])
        self.epoch = int(state["epoch"])
        self.plateau = PlateauState(**state["plateau"])
        if self.ema is not None:
            if set(state["ema"]) != set(self.ema):
                raise ValueError("the checkpoint's EMA does not match the "
                                 "model")
            for key, value in state["ema"].items():
                _copy_full(self.ema[key], value.to(self.ema[key].device))
        self.rng.set_state(state["rng"])

    def _load_model(self, values: Dict[str, torch.Tensor]) -> None:
        """``load_state_dict(strict=True)``, also into sharded
        parameters."""
        own = self.model.state_dict()
        if not any(isinstance(v, DTensor) for v in own.values()):
            self.model.load_state_dict(values, strict=True)
            return
        if set(values) != set(own):
            raise RuntimeError(
                f"state dict keys differ: missing "
                f"{sorted(set(own) - set(values))}, unexpected "
                f"{sorted(set(values) - set(own))}")
        with torch.no_grad():
            for key, value in values.items():
                _copy_full(own[key], value.to(own[key].device))
