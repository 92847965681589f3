"""K1 (``ops/cuda/csrc/attention.cu``) as YOLO12's area attention calls it:
per head q, k and v 32 wide, the strips of a frame as the batch. The
bound is :mod:`k1_attention`'s: each input byte read once, each output
byte written once, the products at the dtype's peak."""

from perfbench import core

TRACE_NAMES = ("psa_attention_fwd",)
CALL_NAME = "psa_attention_fwd"
HEAD_DIM = 32
# strips of the attention at p4 and p5 (reference/yolo12.py)
AREA = (4, 1)


def bound_s(b, t, nh, dk, dh, elem=2):
    return core.kernel("k1_attention").bound_s(b, t, nh, dk, dh, elem)


def call_shape(config, batch):
    """The shape whose bound, times the calls of one forward, is their
    sum: p4's calls take ``batch·4`` strips and p5's ``batch``, of
    ``H·W/1024`` tokens at both levels (a p4 map's ``H·W/256`` over 4
    strips, a p5 map's ``H·W/1024``), so the bound, linear in the batch at
    a fixed T, sums as that of the mean batch (2.5·batch at equal
    depths)."""
    h, w = config["input_size"]
    width, depth = config["width"], config["depth"]
    heads = {width[4] // 2 // HEAD_DIM, width[5] // 2 // HEAD_DIM}
    if len(heads) != 1:
        raise ValueError(f"p4 and p5 attend with {sorted(heads)} heads")
    calls = 2 * depth[2] + 2 * depth[3]
    strips = 2 * depth[2] * AREA[0] + 2 * depth[3] * AREA[1]
    return {"b": batch * strips / calls, "t": (h // 32) * (w // 32),
            "nh": heads.pop(), "dk": HEAD_DIM, "dh": HEAD_DIM,
            "elem": 2 if config["precision"] == "bfloat16" else 4}
