from custom_yolo_tpu_torch.core.dtypes import (  # noqa: F401
    DTypePolicy, resolve_policy)
