"""K6, the fused cls tower (``ops/cuda/csrc/head.cu``; two launches a
level, opt-in with ``Head.fused_cls_tower``): the level's map and the
logits once, each weight once; the 1×1 products on the tensor cores
(bf16) and the depthwise taps on the CUDA cores. Not read by a metric
yet: no cell switches it on."""

from perfbench import peaks

TRACE_NAMES = ("cls_stage_kernel",)
CALL_NAME = "cls_stage_kernel"


def bound_s(levels, mid, ncls, elem=2):
    """``levels``: (pixels, input channels) of each level's map."""
    dw = mm = nbytes = 0
    for n_pix, cin in levels:
        dw += 2 * n_pix * 9 * (cin + mid)
        mm += 2 * n_pix * (cin * mid + mid * mid + mid * ncls)
        nbytes += elem * (n_pix * (cin + ncls) + 10 * (cin + mid)
                          + cin * mid + mid * mid + 2 * mid + mid * ncls
                          + ncls)
    if elem == 2:
        t_ops = mm / peaks.BF16_FLOPS + dw / peaks.FP32_FLOPS
    else:
        t_ops = (mm + dw) / peaks.FP32_FLOPS
    t_bytes = nbytes / peaks.HBM_BYTES_S
    return max(t_ops, t_bytes), ("operations" if t_ops > t_bytes
                                 else "bytes")


def call_shape(config, batch):
    h, w = config["input_size"]
    wd = config["width"]
    levels = [(batch * (h // s) * (w // s), c)
              for s, c in zip((8, 16, 32), (wd[3], wd[4], wd[5]))]
    return {"levels": levels,
            "mid": max(80, wd[3], config["num_classes"]),
            "ncls": config["num_classes"],
            "elem": 2 if config["precision"] == "bfloat16" else 4}
