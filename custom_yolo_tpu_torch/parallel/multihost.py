"""Rank alignment before the first collective (counterpart of
``custom_yolo_tpu/parallel/multihost.py``: ``barrier`` :98-110 and the
role of ``AlignedJit`` :113-145).

In JAX a cold compile of the train step takes minutes and skews across
processes, so ``AlignedJit`` compiles ahead, meets the others at a
coordination-service barrier, and only then runs the first collective.
The port's cold start is the build of its CUDA libraries (``nvcc``, ~50 s
when one library after the other is built at its first launch). The
libraries are built to a temporary file and renamed, so builds from
several ranks at once are safe, but each would compile the same sources.
:func:`build_kernels` therefore lets local rank 0 build, and every rank
waits at a store barrier until it has.

The JAX module's other functions have no work here. ``globalize_batch``
and ``put_global`` assemble one global array from the processes' rows and
place host values onto cross-process shardings; ``local_rows`` and
``fetch_local`` read a process's rows back. In PyTorch each rank holds only
its own rows as ordinary tensors on its own card, and DDP and FSDP
broadcast rank 0's weights when they wrap the model, so there is nothing
to assemble or read back.
"""

from __future__ import annotations

import datetime
from typing import Callable, Optional

import torch.distributed as dist

from custom_yolo_tpu_torch.core.mesh import local_rank, world_size


def barrier(name: str, timeout_s: float = 3600.0) -> None:
    """A barrier through the default group's key-value store: no device
    collective runs, so it may come before any collective has set up its
    communicator. ``name`` must be unique to this meeting. Nothing in a
    single process."""
    if world_size() == 1:
        return
    store = dist.distributed_c10d._get_default_store()
    key = f"custom_yolo_tpu_torch/barrier/{name}"
    if store.add(key, 1) == world_size():
        store.set(f"{key}/open", "1")
    store.wait([f"{key}/open"], datetime.timedelta(seconds=timeout_s))


def build_kernels(build: Optional[Callable[[], object]] = None) -> None:
    """Build the CUDA libraries once per node before any rank launches a
    kernel: local rank 0 builds, then every rank passes the barrier, then
    the other ranks call ``build`` too, which finds the libraries built
    and only checks them. ``build`` defaults to ``ops.cuda.build.build``."""
    if build is None:
        from custom_yolo_tpu_torch.ops.cuda import build as cuda_build
        build = cuda_build.build
    if local_rank() == 0:
        build()
    barrier("kernels_built")
    if local_rank() != 0:
        build()
