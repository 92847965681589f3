"""Model scale presets (copy of ``custom_yolo_tpu/models/presets.py``)."""

PRESETS = {
    "n": {"csp": [False, True], "depth": [1, 1, 1, 1, 1, 1],
          "width": [3, 16, 32, 64, 128, 256]},
    "s": {"csp": [False, True], "depth": [1, 1, 1, 1, 1, 1],
          "width": [3, 32, 64, 128, 256, 512]},
    "m": {"csp": [True, True], "depth": [1, 1, 1, 1, 1, 1],
          "width": [3, 64, 128, 256, 512, 512]},
    "l": {"csp": [True, True], "depth": [2, 2, 2, 2, 2, 2],
          "width": [3, 64, 128, 256, 512, 512]},
    # the active reference configuration
    "x": {"csp": [True, True], "depth": [2, 2, 2, 2, 2, 2],
          "width": [3, 96, 192, 384, 768, 768]},
    # opt-in, not weight-compatible with 'x': Residual CSP at p2/p3
    "x-tpu": {"csp": [False, True], "depth": [2, 2, 2, 2, 2, 2],
              "width": [3, 96, 192, 384, 768, 768]},
}
