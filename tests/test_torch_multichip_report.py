"""``scripts/torch_multichip_report.py`` on the CPU: the toy model at 64²
on gloo ranks that the script starts itself. Every source's collectives,
counted from the profiler trace, equal the count and bytes that the
modules predict, and the totals that matter are held here to numbers this
test takes from the model itself: two BatchNorm reductions for each
ConvBN, FSDP2's forward all-gathers carrying exactly the parameters that
``param_shardings`` splits, and DDP's buckets carrying every gradient."""

import pytest
import torch

from custom_yolo_tpu_torch.models.detector import create_train_model
from custom_yolo_tpu_torch.nn.blocks import ConvBN
from custom_yolo_tpu_torch.parallel.sharding import param_shardings
from torch.distributed.tensor import Shard
from torch_project import load_script

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def report():
    return load_script("torch_multichip_report")


@pytest.fixture(scope="module")
def toy(report):
    """The report's toy model, built here: its ConvBNs and its parameters'
    bytes (fp32), split and all."""
    w = report.TOY
    model = create_train_model(w["width"], w["depth"], w["csp"], 16,
                               device="cpu")
    convbns = [m for m in model.modules()
               if isinstance(m, ConvBN) and m.bn is not None]
    placements = param_shardings(model, 2, report.MIN_WEIGHT_SIZE)
    params = dict(model.named_parameters())
    split = sum(params[k].numel() * 4 for k, pl in placements.items()
                if isinstance(pl, Shard))
    return {"convbns": len(convbns),
            "bn_bytes": sum((2 * m.bn.num_features + 1) * 8
                            for m in convbns),
            "param_bytes": sum(p.numel() * 4 for p in params.values()),
            "split_bytes": split}


def run(report, tmp_path, devices: int):
    out = tmp_path / "MULTICHIP_TORCH.md"
    res = report.main(["--devices", str(devices), "--device", "cpu",
                       "--out", str(out)])
    return res, out.read_text()


def held_to_prediction(res):
    assert res["ranks_agree"]
    for source, v in res["by_source"].items():
        assert (v["count"], v["bytes"]) == (
            v["predicted_count"], v["predicted_bytes"]), source
    assert res["all_match"]
    assert res["by_source"]["other"]["count"] == 0


def test_hybrid_mesh_collectives_equal_their_prediction(report, toy,
                                                        tmp_path):
    """Four ranks, ``{data: 2, fsdp: 2}``: FSDP2 in hybrid mode. Each
    forward all-gathers every split parameter once, each backward
    reduce-scatters its gradient once and all-reduces the shards over
    ``data``; the whole parameters' gradients take one all-reduce and the
    norm one over ``fsdp``."""
    res, doc = run(report, tmp_path, 4)
    assert res["mesh"] == {"data": 2, "fsdp": 2}
    held_to_prediction(res)
    src = res["by_source"]
    assert res["split_param_bytes"] == toy["split_bytes"] > 0
    assert res["sharded_params"] > 0 and res["whole_params"] > 0
    assert src["batch_norm"]["count"] == 2 * toy["convbns"]
    assert src["batch_norm"]["bytes"] == 2 * toy["bn_bytes"]
    forward = src["fsdp_all_gather"]["ops"][
        "c10d::_allgather_base_ (forward)"]
    assert forward[1] == toy["split_bytes"]
    assert src["fsdp_reduce_scatter"]["bytes"] == toy["split_bytes"]
    assert src["fsdp_all_reduce"]["bytes"] == toy["split_bytes"] // 2
    assert src["average_gradients"]["bytes"] == (
        toy["param_bytes"] - toy["split_bytes"])
    assert (src["grad_norm"]["count"], src["ddp_bucket"]["count"]) == (1, 0)
    assert res["launches"]["attention"] == 0    # the CPU takes the twin
    assert "| batch_norm |" in doc and "published figures" in doc


def test_two_ranks_are_ddp_whose_buckets_carry_every_gradient(
        report, toy, tmp_path):
    """Two ranks, ``{data: 2, fsdp: 1}``: DDP. Its buckets add up to every
    parameter's gradient; nothing of FSDP2 runs."""
    res, _ = run(report, tmp_path, 2)
    assert res["mesh"] == {"data": 2, "fsdp": 1}
    held_to_prediction(res)
    src = res["by_source"]
    assert src["ddp_bucket"]["bytes"] == toy["param_bytes"]
    assert src["ddp_bucket"]["count"] == res["ddp_buckets"] >= 1
    assert src["batch_norm"]["count"] == 2 * toy["convbns"]
    for source in ("fsdp_all_gather", "fsdp_reduce_scatter",
                   "average_gradients", "grad_norm"):
        assert src[source]["count"] == 0, source
