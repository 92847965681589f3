"""Mixed-precision policy (counterpart of ``custom_yolo_tpu/core/dtypes.py``).

Parameters and BatchNorm statistics stay float32; activations run in the
compute dtype (bfloat16 by default). Weights are folded and kept in
float32 and cast to the compute dtype where they are used.
"""

from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass(frozen=True)
class DTypePolicy:
    param_dtype: torch.dtype = torch.float32
    compute_dtype: torch.dtype = torch.bfloat16
    norm_stat_dtype: torch.dtype = torch.float32
    loss_dtype: torch.dtype = torch.float32


_POLICIES = {
    "bfloat16": DTypePolicy(compute_dtype=torch.bfloat16),
    "float32": DTypePolicy(compute_dtype=torch.float32),
    # accepted for config parity with the reference; mapped to bf16 as the
    # JAX package does (bf16 needs no loss scaling)
    "float16": DTypePolicy(compute_dtype=torch.bfloat16),
}


def resolve_policy(precision: str) -> DTypePolicy:
    try:
        return _POLICIES[precision]
    except KeyError:
        raise ValueError(
            f"precision must be one of {sorted(_POLICIES)}, got {precision!r}")
