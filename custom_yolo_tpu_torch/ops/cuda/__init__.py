"""The hand-written CUDA kernels (``csrc/``), their build (``build.py``)
and the library of the ``torch.library`` ops that wrap the serving
kernels (``torch.ops.custom_yolo_tpu_torch.*``).

Each op module adds to :data:`LIB` its op's schema, a CPU implementation
(the plain twin), a CUDA implementation (the launch, which counts it) and
a fake implementation (output shapes and dtypes, for ``torch.export``).
The implementations are registered with ``Library.impl``, which the
dispatcher calls directly; ``torch.library.custom_op`` would wrap each
call in more Python."""

import torch

OPS = "custom_yolo_tpu_torch"
LIB = torch.library.Library(OPS, "DEF")


def define(schema: str, cpu, cuda, fake):
    """Define ``OPS::<schema>`` with its three implementations; returns
    the op's default overload, the callable the wrappers use."""
    LIB.define(schema)
    name = schema.split("(", 1)[0]
    LIB.impl(name, cpu, "CPU")
    LIB.impl(name, cuda, "CUDA")
    torch.library.register_fake(f"{OPS}::{name}", fake, lib=LIB)
    return getattr(getattr(torch.ops, OPS), name).default
