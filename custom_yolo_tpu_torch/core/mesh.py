"""Process groups and the device mesh (counterpart of
``custom_yolo_tpu/core/mesh.py``: ``DATA_AXIS``/``FSDP_AXIS`` :25-26,
``MeshSpec.for_mode`` :37-52, ``create_mesh`` :55-63,
``initialize_distributed`` :66-78).

The mesh has the JAX package's two axes, ``data`` and ``fsdp``:

* ``dp``   — every rank on the ``data`` axis (DDP);
* ``fsdp`` — every rank on the ``fsdp`` axis: the batch *and* the large
             parameters with their optimizer state are split over it
             (FSDP2);
* both axes above 1 for hybrid sharding.

In PyTorch one process drives one card, so a mesh's size is the number of
processes (``torch.distributed``'s world), not the number of devices one
process sees: a lone process that sees several cards trains on one of
them (JAX drives every local device from one process). On the card a
process group uses NCCL, one card per rank (``cuda:LOCAL_RANK``); on the
CPU, which the caller asks for, gloo.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Optional

import torch
import torch.distributed as dist

DATA_AXIS = "data"
FSDP_AXIS = "fsdp"


def world_size() -> int:
    """The number of processes of the default group, 1 without one."""
    return dist.get_world_size() if dist.is_initialized() else 1


def rank() -> int:
    """This process's rank in the default group, 0 without one."""
    return dist.get_rank() if dist.is_initialized() else 0


def local_rank() -> int:
    """This process's rank among the processes of its node (torchrun's
    ``LOCAL_RANK``; the global rank where that is not set)."""
    return int(os.environ.get("LOCAL_RANK", rank()))


@dataclasses.dataclass(frozen=True)
class MeshSpec:
    """Logical mesh shape. Axes of size 1 are kept so that every mode has
    both axes."""
    data: int = 1
    fsdp: int = 1

    @classmethod
    def for_mode(cls, mode: str, num_devices: Optional[int] = None
                 ) -> "MeshSpec":
        n = num_devices if num_devices is not None else world_size()
        if mode == "single":
            return cls(data=1, fsdp=1)
        if mode == "dp":
            return cls(data=n, fsdp=1)
        if mode == "fsdp":
            return cls(data=1, fsdp=n)
        raise ValueError(f"unknown sharding mode {mode!r}")


def create_mesh(spec: MeshSpec, device_type: Optional[str] = None):
    """A ``DeviceMesh`` of shape ``(data, fsdp)`` over the ranks of the
    default group, named ``("data", "fsdp")``. It must cover every rank:
    the batch is split over all of them. ``device_type`` is where the
    ranks' tensors lie (FSDP2 moves a model it shards there); it defaults
    to that of the default group's backend (``cuda`` for NCCL, ``cpu`` for
    gloo), so ranks that share a card over gloo must name ``cuda``."""
    from torch.distributed.device_mesh import init_device_mesh

    n = spec.data * spec.fsdp
    if n != world_size():
        raise ValueError(f"mesh {spec} needs {n} processes, the world has "
                         f"{world_size()}")
    if device_type is None:
        device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
    return init_device_mesh(device_type, (spec.data, spec.fsdp),
                            mesh_dim_names=(DATA_AXIS, FSDP_AXIS))


def initialize_distributed(coordinator_address: Optional[str] = None,
                           num_processes: Optional[int] = None,
                           process_id: Optional[int] = None,
                           device: str = "cuda",
                           backend: Optional[str] = None) -> torch.device:
    """Join the process group and return this rank's device.

    The arguments, or else torchrun's environment (``WORLD_SIZE``,
    ``RANK``, ``LOCAL_RANK``, ``MASTER_ADDR``/``MASTER_PORT``), give the
    world. ``coordinator_address`` is ``host:port`` of rank 0. With
    ``device="cuda"`` the group uses NCCL and this rank drives
    ``cuda:LOCAL_RANK``; with ``device="cpu"``, gloo. ``backend`` names
    another backend outright (gloo with CUDA tensors, for ranks that share
    one card). A world of one process joins no group: the device is
    ``cuda`` (the current card) or ``cpu``."""
    if num_processes is None:
        num_processes = int(os.environ.get("WORLD_SIZE", 1))
    if process_id is None:
        process_id = int(os.environ.get("RANK", 0))
    if num_processes <= 1:
        return torch.device(device)
    if coordinator_address is None:
        coordinator_address = (f"{os.environ['MASTER_ADDR']}:"
                               f"{os.environ['MASTER_PORT']}")
    if device == "cuda":
        # the local rank: torchrun's, else the rank on a one-node world
        index = int(os.environ.get("LOCAL_RANK", process_id))
        dev = torch.device("cuda", index % torch.cuda.device_count())
        torch.cuda.set_device(dev)
    else:
        dev = torch.device(device)
    if not dist.is_initialized():
        dist.init_process_group(
            backend or ("nccl" if dev.type == "cuda" else "gloo"),
            init_method=f"tcp://{coordinator_address}",
            world_size=num_processes, rank=process_id)
    return dev
