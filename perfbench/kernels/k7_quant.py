"""K7, seeded stochastic rounding of every int8 leaf in one launch
(``ops/cuda/csrc/quant.cu``; ``Detector.quantize(stochastic=True)``):
4 bytes read and 1 written an element. Its instruction count needs the
SASS, which a trace does not give, so the bound here is the bytes'. Not
read by a metric yet: no cell quantizes."""

from perfbench import peaks

TRACE_NAMES = ("stochastic_round",)
CALL_NAME = "stochastic_round"


def bound_s(elements):
    return peaks.roofline(5 * elements, 0, peaks.FP32_FLOPS)


# the backbone stages that ``quantize(skip="auto")`` keeps float
SKIP = ("p1_conv", "p2_conv", "p2_csp")


def call_shape(config, batch=0, skip=SKIP):
    """Elements of the int8 leaves: every folded ConvBN kernel outside the
    skipped stages (the head's logit projections stay float)."""
    from perfbench.reference.model import state_layout

    layout = state_layout(config["width"], config["depth"], config["csp"],
                          config["num_classes"], config["reg_max"])
    n = 0
    for key, shape in layout.items():
        if not key.endswith(".conv.weight"):
            continue
        if any(key.startswith(f"net.{stage}.") for stage in skip):
            continue
        size = 1
        for d in shape:
            size *= d
        n += size
    return {"elements": n}
