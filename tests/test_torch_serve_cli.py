"""``scripts/torch_serve.py`` against ``scripts/serve.py``, both run
in-process on the CPU over the image folder of ``tests/test_serve_cli.py``
(five JPEGs and a PNG, batches of four, so the tail batch is padded).

Both scripts serve bf16 by default, which XLA:CPU and torch sum
differently, so each script's ``build_detector`` is replaced here by one
that returns an fp32 detector holding the same weights; and both round
the JSON's numbers, so ``round`` is shadowed in each module to compare
the unrounded values. Detections must match per image: the same count,
boxes within 1e-3 px, scores within 1e-5. The port's own paths (PIL where
the native decoder is absent, ``--fast_decode`` refused there, a
``save_weights`` directory through ``--config``, static int8) are checked
against ``Detector.serve`` called directly."""

import json
import re

import numpy as np
import pytest
import torch
import yaml

from custom_yolo_tpu.models import Detector as JaxDetector
from custom_yolo_tpu.models import YoloModel as JaxYoloModel
from custom_yolo_tpu_torch import Detector
from custom_yolo_tpu_torch import runtime
from custom_yolo_tpu_torch.ops.nms import nms_to_lists

from test_torch_eval_cli import confident_boxes
from test_torch_model import perturbed_variables
from torch_project import load_script, random_jax_variables

torch.set_num_threads(2)

WIDTH = (3, 8, 16, 32, 64, 256)
DEPTH = (2, 1, 1, 1, 2, 1)
CSP = (True, True)
NC = 3
HW = 64
CONF = 0.3
ARGS = ["--num_classes", str(NC), "--input_size", str(HW), "--batch_size",
        "4", "--inflight", "2", "--conf", str(CONF)]


@pytest.fixture(scope="module")
def image_dir(tmp_path_factory):
    """``tests/test_serve_cli.py``'s folder: five JPEGs and a PNG."""
    from PIL import Image
    d = tmp_path_factory.mktemp("serve_imgs")
    rng = np.random.RandomState(0)
    for i in range(5):
        arr = (rng.rand(96, 128, 3) * 255).astype(np.uint8)
        Image.fromarray(arr).save(d / f"img_{i}.jpg", quality=90)
    Image.fromarray((rng.rand(50, 70, 3) * 255).astype(np.uint8)).save(
        d / "extra.png")
    return d


@pytest.fixture(scope="module")
def variables():
    return confident_boxes(perturbed_variables(random_jax_variables(
        JaxYoloModel(WIDTH, DEPTH, CSP, NC), HW, seed=9), seed=9))


def port_detector(variables):
    det = Detector(WIDTH, DEPTH, CSP, NC, precision="float32",
                   input_size=(HW, HW), device="cpu")
    det.load_variables(variables)
    return det


def run(script, argv, monkeypatch=None, build=None):
    """``main`` of ``scripts/{script}.py`` with ``round`` shadowed, and
    ``build_detector`` replaced where ``build`` is given; returns the
    written detections."""
    module = load_script(script)
    module.round = lambda value, ndigits=None: value
    if build is not None:
        module.build_detector = lambda args: (build(), (HW, HW))
    if monkeypatch is not None:      # the JAX script reads sys.argv
        monkeypatch.setattr("sys.argv", [f"{script}.py"] + argv)
        module.main()
    else:
        module.main(argv)
    output = argv[argv.index("--output") + 1]
    with open(output) as f:
        return json.load(f)


def assert_same_detections(got, want, box_tol=1e-3, score_tol=1e-5):
    assert [r["image"] for r in got] == [r["image"] for r in want]
    assert any(r["detections"] for r in want)
    for g, w in zip(got, want):
        assert (g["width"], g["height"]) == (w["width"], w["height"])
        assert len(g["detections"]) == len(w["detections"]), g["image"]
        if not w["detections"]:
            continue
        a, b = np.asarray(g["detections"]), np.asarray(w["detections"])
        np.testing.assert_array_equal(a[:, 5], b[:, 5])
        np.testing.assert_allclose(a[:, :4], b[:, :4], atol=box_tol, rtol=0)
        np.testing.assert_allclose(a[:, 4], b[:, 4], atol=score_tol, rtol=0)


def test_serve_cli_matches_jax(image_dir, variables, tmp_path, monkeypatch):
    def jax_build():
        det = JaxDetector(WIDTH, DEPTH, CSP, NC, precision="float32",
                          input_size=(HW, HW))
        det.load_variables(variables)
        return det

    got = run("torch_serve", ["--images", str(image_dir), "--device", "cpu",
                              "--output", str(tmp_path / "port.json")]
              + ARGS, build=lambda: port_detector(variables))
    want = run("serve", ["--images", str(image_dir), "--output",
                         str(tmp_path / "jax.json")] + ARGS,
               monkeypatch=monkeypatch, build=jax_build)
    # six images (the PNG through PIL), the tail batch's pad rows dropped
    assert len(got) == 6 and "extra.png" in {r["image"] for r in got}
    assert_same_detections(got, want)
    for rec in got:
        for x1, y1, x2, y2, conf, cls in rec["detections"]:
            assert 0 <= x1 <= x2 <= rec["width"]
            assert 0 <= y1 <= y2 <= rec["height"]
            assert conf >= CONF and 0 <= cls < NC


def direct_serve(det, paths):
    """``Detector.serve`` on PIL-decoded batches of four (the tail padded
    with its last image), boxes mapped to the original pixels and clipped:
    what the CLI computes, written out."""
    from PIL import Image
    out = []
    for i in range(0, len(paths), 4):
        chunk = paths[i:i + 4]
        padded = chunk + [chunk[-1]] * (4 - len(chunk))
        images, sizes = [], []
        for path in padded:
            with Image.open(path) as im:
                im = im.convert("RGB")
                sizes.append(im.size)
                images.append(np.asarray(im.resize((HW, HW),
                                                   Image.BILINEAR)))
        lists = nms_to_lists(det.serve(torch.from_numpy(np.stack(images)),
                                       conf_thres=CONF,
                                       device_preprocess=True))
        for path, (w, h), dets in zip(chunk, sizes, lists):
            b = dets[:, :4].astype(np.float64)
            b[:, [0, 2]] = (b[:, [0, 2]] * (w / HW)).clip(0, w)
            b[:, [1, 3]] = (b[:, [1, 3]] * (h / HW)).clip(0, h)
            out.append({"image": path.name, "width": w, "height": h,
                        "detections": [list(b[k]) + [float(dets[k, 4]),
                                                     int(dets[k, 5])]
                                       for k in range(len(dets))]})
    return out


def test_serve_cli_decodes_with_pil_without_the_native_decoder(
        image_dir, variables, tmp_path, monkeypatch, capsys):
    """Where the native decoder does not build, every batch is decoded with
    PIL and the detections are ``Detector.serve``'s on those batches; a
    ``save_weights`` directory is read through ``--config``;
    ``--fast_decode`` is refused."""
    monkeypatch.setattr(runtime, "native_available", lambda: False)
    det = port_detector(variables)
    det.fuse().save_weights(str(tmp_path / "w"))
    cfg = tmp_path / "cfg.yaml"
    cfg.write_text(yaml.safe_dump({
        "project": {"num_classes": NC},
        "model": {"num_classes": NC, "input_size": [HW, HW],
                  "config": {"csp": list(CSP), "depth": list(DEPTH),
                             "width": list(WIDTH)}}}))
    argv = ["--images", str(image_dir), "--device", "cpu", "--config",
            str(cfg), "--checkpoint", str(tmp_path / "w"), "--output",
            str(tmp_path / "pil.json")] + ARGS
    got = run("torch_serve", argv)
    assert "decoder: PIL" in capsys.readouterr().out
    # the CLI's detector is bf16, as the JAX script's is
    bf16 = Detector(WIDTH, DEPTH, CSP, NC, input_size=(HW, HW),
                    device="cpu").load_weights(str(tmp_path / "w"))
    want = direct_serve(bf16, sorted(image_dir.iterdir()))
    assert_same_detections(got, want, box_tol=0, score_tol=0)
    with pytest.raises(SystemExit, match="fast_decode"):
        load_script("torch_serve").main(argv + ["--fast_decode"])


def test_serve_cli_static_int8(image_dir, variables, tmp_path, capsys):
    """``--quantize static`` calibrates on the first batch and serves every
    image."""
    got = run("torch_serve", ["--images", str(image_dir), "--device", "cpu",
                              "--quantize", "static", "--calib_batches",
                              "1", "--output", str(tmp_path / "q.json")]
              + ARGS, build=lambda: port_detector(variables))
    out = capsys.readouterr().out
    assert "calibrated on 1 batches" in out and "kernel launches" in out
    assert len(got) == 6
    assert all(np.isfinite(d).all() for r in got for d in r["detections"])


def test_serve_cli_times_the_warm_up_apart(image_dir, variables, tmp_path,
                                           capsys):
    """The first batch is timed apart from the rest (4 of the 6 images at
    batch 4), the producer's decode time is printed, and a
    ``--profile_dir`` trace marks the first fetch, where the steady-state
    window opens."""
    prof = tmp_path / "prof"
    got = run("torch_serve", ["--images", str(image_dir), "--device", "cpu",
                              "--profile_dir", str(prof), "--output",
                              str(tmp_path / "p.json")] + ARGS,
              build=lambda: port_detector(variables))
    out = capsys.readouterr().out
    assert len(got) == 6
    assert re.search(r"first batch fetched after [\d.]+ s; the other 2 "
                     r"images in [\d.]+ s \([\d.]+ img/s\); decode on the "
                     r"producer thread [\d.]+ s \([\d.]+ ms/img\)", out), out
    with open(prof / "trace.json") as f:
        events = json.load(f)["traceEvents"]
    assert sum(e.get("name") == "serve_cli.first_fetch"
               and e.get("cat") == "user_annotation"
               for e in events) == 1


def test_a_native_library_that_does_not_load_is_unavailable(tmp_path,
                                                            monkeypatch):
    """A decoder library that is there but does not load (built on another
    machine, against a libjpeg this one lacks) counts as no native
    decoder: the serve CLI and the loader then decode with PIL."""
    bogus = tmp_path / "libyolo_runtime.so"
    bogus.write_bytes(b"not a shared library")
    monkeypatch.setattr(runtime, "_lib_handle", None)
    monkeypatch.setattr(runtime, "build_native",
                        lambda force=False: str(bogus))
    assert not runtime.native_available()
