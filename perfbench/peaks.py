"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet; dense
rates, no sparsity; at the full 700 W power limit): the yardstick of every
roofline and utilisation share."""

HBM_BYTES_S = 3.35e12
BF16_FLOPS = 989e12
FP8_FLOPS = 1979e12
INT8_OPS = 1979e12
TF32_FLOPS = 495e12
FP32_FLOPS = 67e12


def roofline(n_bytes: float, ops: float, peak_ops: float):
    """(least seconds, what bounds it) for this many bytes and
    operations."""
    t_bytes = n_bytes / HBM_BYTES_S
    t_ops = ops / peak_ops
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                 else "operations")
