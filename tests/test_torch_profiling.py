"""The port's ``utils/profiling.py`` and ``utils/visualization.py`` against
the JAX package's, on the CPU: ``time_fn`` returns the same keys, ``trace``
writes a Chrome trace (and nothing without a directory), the launch
counts name every kernel, and the plots render the same pixels."""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from custom_yolo_tpu.utils import profiling as jax_profiling
from custom_yolo_tpu.utils import visualization as jax_visualization
from custom_yolo_tpu_torch.utils import profiling, visualization

torch.set_num_threads(2)


def test_time_fn_keys_match_jax():
    x = torch.randn(64, 64)
    got = profiling.time_fn(torch.matmul, x, x, iters=3, warmup=1)
    want = jax_profiling.time_fn(jax.jit(jnp.matmul), jnp.ones((64, 64)),
                                 jnp.ones((64, 64)), iters=3, warmup=1)
    assert got.keys() == want.keys()
    assert got["iters"] == 3 and got["total_s"] > 0
    assert got["mean_s"] == pytest.approx(got["total_s"] / 3)
    # no warm-up call: the first timed call's result decides the clock
    assert profiling.time_fn(lambda: {"y": x + 1}, iters=2,
                             warmup=0)["iters"] == 2


def test_trace_writes_a_chrome_trace(tmp_path):
    with profiling.trace(str(tmp_path / "prof")):
        torch.randn(32, 32) @ torch.randn(32, 32)
    with open(tmp_path / "prof" / profiling.TRACE_FILE) as f:
        events = json.load(f)["traceEvents"]
    assert any("mm" in e.get("name", "") for e in events)
    with profiling.trace(None):
        pass
    with profiling.trace(""):
        pass
    assert os.listdir(tmp_path) == ["prof"]


def test_kernel_launches_name_every_kernel():
    counts = profiling.kernel_launches()
    assert set(counts) == {"attention", "attention_bwd", "nms_batched",
                           "nms_single", "sppf", "cls_tower",
                           "stochastic_round"}
    assert all(isinstance(v, int) and v >= 0 for v in counts.values())


def _pixels(fig):
    fig.canvas.draw()
    return np.asarray(fig.canvas.buffer_rgba()).copy()


@pytest.mark.parametrize("normalised", [False, True],
                         ids=["uint8", "normalised"])
def test_plots_render_as_jax(tmp_path, normalised):
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    rng = np.random.RandomState(1)
    image = rng.randint(0, 256, (48, 64, 3)).astype(np.uint8)
    if normalised:
        image = ((image / 255.0 - np.array([0.485, 0.456, 0.406]))
                 / np.array([0.229, 0.224, 0.225])).astype(np.float32)
    gt = np.array([[20.0, 20, 10, 12], [40, 30, 8, 6]])
    pred = gt + 1.5
    names = {0: "a", 1: "b"}
    figs = []
    for module, img in ((visualization, torch.from_numpy(image)),
                        (jax_visualization, image)):
        fig = module.visualize_comparison(
            img, gt, [0, 1], pred, [1, 0], [0.9, 0.4], class_names=names,
            save_path=str(tmp_path / f"{module.__name__}.png"))
        figs.append(_pixels(fig))
        plt.close(fig)
    np.testing.assert_array_equal(figs[0], figs[1])
    assert len(list(tmp_path.glob("*.png"))) == 2
