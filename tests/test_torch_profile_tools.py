"""``scripts/torch_analyze_profile.py`` on a hand-written Chrome trace
(GPU kernels, a copy and a memset, ``cudaLaunchKernel`` and
``cuLaunchKernel`` launches on two host threads, CPU ops with autograd
sequence numbers, the port's spans of the step and the model's stages and
torch.optim's annotation): its per-step tables exactly; and
``scripts/torch_profile.py`` on the CPU at n/64² B=2, whose trace (the
port's own spans, no hooks) the digest splits into the train step's
phases."""

import json
import os
import re

import pytest
import torch
import yaml

from perfbench.kernels import k1_area_attention, k1_attention
from torch_project import load_script

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
STEPS = 2


def host(name, ts, dur, tid=1, cat="cpu_op", **args):
    return {"ph": "X", "cat": cat, "name": name, "pid": 7, "tid": tid,
            "ts": ts, "dur": dur, "args": args}


def launch(ts, corr, tid=1, cat="cuda_runtime", name="cudaLaunchKernel"):
    return host(name, ts, 2, tid=tid, cat=cat, correlation=corr)


def device(name, ts, dur, corr, cat="kernel"):
    return {"ph": "X", "cat": cat, "name": name, "pid": 0, "tid": 7,
            "ts": ts, "dur": dur, "args": {"correlation": corr}}


def annotation(name, ts, dur, tid=1):
    return host(name, ts, dur, tid=tid, cat="user_annotation")


EVALUATE = "autograd::engine::evaluate_function: "
TRACE = [
    {"ph": "M", "name": "process_name", "pid": 7, "args": {"name": "x"}},
    # forward: a convolution in the stem's span, an attention in the head's
    annotation("fwd/net.p1_conv", 0, 100),
    host("aten::conv2d", 10, 50, **{"Sequence number": 5,
                                    "flops": 2_000_000_000}),
    host("aten::cudnn_convolution", 15, 40),
    launch(17, 10, name="cudaMemsetAsync"),
    launch(20, 1),
    annotation("fwd/head", 100, 50),
    host("custom_yolo_tpu_torch::psa_attention_fwd", 110, 10,
         **{"Sequence number": 6}),
    launch(112, 2),
    # the loss
    annotation("train/loss", 150, 50),
    host("aten::topk", 160, 20, **{"Sequence number": 7}),
    launch(165, 3),
    # a copy outside every span
    host("aten::copy_", 205, 10),
    launch(207, 4, name="cudaMemcpyAsync"),
    # the backward, on the autograd thread
    host(EVALUATE + "ConvolutionBackward0", 250, 100, tid=2,
         **{"Sequence number": 5}),
    host("ConvolutionBackward0", 251, 90, tid=2, **{"Sequence number": 5}),
    launch(260, 5, tid=2),
    launch(270, 8, tid=2),
    host(EVALUATE + "PsaAttentionBackward", 360, 20, tid=2,
         **{"Sequence number": 6}),
    launch(365, 6, tid=2),
    host(EVALUATE + "TopkBackward0", 385, 10, tid=2,
         **{"Sequence number": 7}),
    launch(387, 9, tid=2),
    # the gradient's norm, in the step's clip span
    annotation("train/clip", 396, 4),
    host("aten::_foreach_norm", 396, 3),
    launch(397, 11),
    # the optimizer, one kernel through cuLaunchKernel
    annotation("Optimizer.step#Optimizer.step", 400, 100),
    host("aten::_foreach_add_", 410, 20),
    launch(415, 7, cat="cuda_driver", name="cuLaunchKernel"),
    # the card
    device("Memset (Device)", 25, 2, 10, cat="gpu_memset"),
    device("sm90_xmma_fprop_implicit_gemm_bf16bf16_f32", 30, 40, 1),
    device("void psa_attention_fwd_tc<64, 32>(bf16 const*)", 120, 10, 2),
    device("void at::native::sbtopk::gatherTopK<float>()", 170, 20, 3),
    device("Memcpy HtoD (Pageable -> Device)", 210, 5, 4,
           cat="gpu_memcpy"),
    device("sm90_xmma_wgrad_implicit_gemm_bf16", 300, 30, 5),
    device("void at::native::batch_norm_backward_kernel<float>()", 340, 6,
           8),
    device("void psa_attention_bwd_dq_tc<64>(bf16 const*)", 370, 8, 6),
    device("void at::native::vectorized_elementwise_kernel<4>()", 390, 4,
           9),
    device("void at::native::reduce_kernel<512, 1>()", 395, 3, 11),
    device("void at::native::multi_tensor_apply_kernel<>()", 450, 7, 7),
]


def ms(us):
    return us / 1e3 / STEPS


def rows(table):
    return {key: (round(t_ms, 9), n) for key, t_ms, _, _, n in table}


def test_digest_of_a_hand_written_trace(tmp_path, capsys):
    (tmp_path / "trace.json").write_text(json.dumps({"traceEvents": TRACE}))
    got = load_script("torch_analyze_profile").main(
        ["--dir", str(tmp_path), "--steps", str(STEPS)])
    total = 2 + 40 + 10 + 20 + 5 + 30 + 6 + 8 + 4 + 3 + 7
    assert got["on_device"] and got["events"] == 11
    assert got["total_ms"] == pytest.approx(ms(total), abs=1e-12)
    assert got["wall_ms"] == pytest.approx(ms(500), abs=1e-12)
    assert rows(got["phase"]) == {
        "fwd": (ms(52), 3), "bwd": (ms(48), 4), "loss": (ms(20), 1),
        "optimizer": (ms(10), 2), "other": (ms(5), 1)}
    assert sum(r[1] for r in got["phase"]) == pytest.approx(
        got["total_ms"], abs=1e-12)
    assert rows(got["phase_layer"]) == {
        ("fwd", "net.p1_conv"): (ms(42), 2), ("fwd", "head"): (ms(10), 1),
        ("bwd", "net.p1_conv"): (ms(36), 2), ("bwd", "head"): (ms(8), 1),
        ("bwd", "-"): (ms(4), 1), ("loss", "-"): (ms(20), 1),
        ("optimizer", "-"): (ms(10), 2), ("other", "-"): (ms(5), 1)}
    assert rows(got["family"]) == {
        "cuDNN convolution": (ms(70), 2), "port kernels (K1-K7)": (ms(18), 2),
        "sort/select/index": (ms(20), 1), "copy/memset": (ms(7), 2),
        "BatchNorm": (ms(6), 1), "reduction": (ms(3), 1),
        "multi-tensor (optimizer, norm, clip)": (ms(7), 1),
        "elementwise": (ms(4), 1)}
    assert got["port_kernels"] == {"K1 psa_attention_fwd": 1,
                                   "K4 psa_attention_bwd": 1}
    # the convolution's FLOPs, once, on its kernel (not on the memset it
    # launched first), over the fwd phase's 52 µs and the family's 70 µs
    fwd = next(r for r in got["phase"] if r[0] == "fwd")
    assert fwd[3] == pytest.approx(2e9 / 52e-6 / 1e12)
    assert all(r[3] is None for r in got["phase"] if r[0] != "fwd")
    families = {r[0]: r[3] for r in got["family"]}
    assert families["cuDNN convolution"] == pytest.approx(2e9 / 70e-6 / 1e12)
    assert families["copy/memset"] is None
    assert got["hottest"][0][:2] == [
        "sm90_xmma_fprop_implicit_gemm_bf16bf16_f32", ms(40)]
    out = capsys.readouterr().out
    for title in ("## phase (", "## phase × layer", "## kernel family",
                  "## hottest kernels"):
        assert title in out
    assert f"total device time/step: {ms(total):.2f} ms" in out


# K1's bf16 kernel as torch.profiler's trace names it on the H100
K1_SYMBOL = ("void (anonymous namespace)::psa_attention_fwd_tc<32, 32>("
             "__nv_bfloat16 const*, __nv_bfloat16*, __nv_bfloat16*, int, "
             "int, int, int, float, int, int)")
CSRC = os.path.join(REPO, "custom_yolo_tpu_torch", "ops", "cuda", "csrc")
KERNEL = re.compile(r"__global__\s+void\s+(?:__launch_bounds__\([^)]*\)\s*)?"
                    r"(\w+)\s*\(")


def test_digest_attributes_k1s_device_symbol(tmp_path):
    trace = [dict(e, name=K1_SYMBOL) if "psa_attention_fwd" in e["name"]
             else e for e in TRACE]
    (tmp_path / "trace.json").write_text(json.dumps({"traceEvents": trace}))
    got = load_script("torch_analyze_profile").main(
        ["--dir", str(tmp_path), "--steps", str(STEPS)])
    assert got["port_kernels"] == {"K1 psa_attention_fwd": 1,
                                   "K4 psa_attention_bwd": 1}
    assert rows(got["family"])["port kernels (K1-K7)"] == (ms(18), 2)


def test_only_the_forward_kernels_carry_k1s_name():
    """The digest and the benchmark's K1 readers count K1 as the device
    events whose name holds ``psa_attention_fwd``: each kernel of
    ``attention.cu`` holds it, and no kernel of another source does, so a
    call counts as one launch and its time is never left out."""
    assert {k1_attention.CALL_NAME, k1_area_attention.CALL_NAME,
            *k1_attention.TRACE_NAMES, *k1_area_attention.TRACE_NAMES} \
        == {"psa_attention_fwd"}
    assert load_script("torch_analyze_profile").port_kernel(K1_SYMBOL) \
        == "K1 psa_attention_fwd"
    kernels = {}
    for name in sorted(os.listdir(CSRC)):
        if name.endswith(".cu"):
            with open(os.path.join(CSRC, name)) as f:
                kernels[name] = KERNEL.findall(f.read())
    assert all(kernels.values()), kernels  # the pattern finds every kernel
    assert all("psa_attention_fwd" in k for k in kernels["attention.cu"])
    assert all("psa_attention_fwd" not in kernel
               for name, found in kernels.items() if name != "attention.cu"
               for kernel in found)


def test_profile_on_the_cpu_splits_the_step(tmp_path):
    """n/64² B=2, two steps: the trace carries FLOPs, and ≥ 90% of the
    ops' self time falls in fwd, bwd, loss and optimizer, and the layers
    are the port's stage spans."""
    with open(os.path.join(REPO, "configs", "config.yaml")) as f:
        raw = yaml.safe_load(f)
    raw["model"]["input_size"] = [64, 64]
    raw["project"]["profile_dir"] = str(tmp_path / "prof")
    raw["training"]["sharding"]["precision"] = "float32"
    cfg = tmp_path / "cfg.yaml"
    cfg.write_text(yaml.safe_dump(raw))
    result = load_script("torch_profile").main(
        ["--config", str(cfg), "--preset", "n", "--batch_size", "2",
         "--steps", "2", "--assigner", "tal", "--max_gt", "16",
         "--device", "cpu"])
    assert result["profile_dir"] == str(tmp_path / "prof")
    got = load_script("torch_analyze_profile").main(
        ["--dir", result["profile_dir"], "--steps", "2"])
    assert not got["on_device"]
    phases = {key: t_ms for key, t_ms, *_ in got["phase"]}
    assert set(phases) == {"fwd", "bwd", "loss", "optimizer", "other"}
    assert (sum(phases.values()) - phases["other"]) >= 0.9 * got["total_ms"]
    assert all(phases[p] > 0 for p in ("fwd", "bwd", "loss", "optimizer"))
    layers = {key for key, *_ in got["phase_layer"]}
    assert ("fwd", "head") in layers and ("bwd", "head") in layers
    assert {layer.split(".")[0] for phase, layer in layers
            if phase == "fwd"} == {"net", "fpn", "head"}
    assert next(r[3] for r in got["phase"] if r[0] == "fwd") > 0
