"""The port's distributed training on the CPU: two processes that join one
gloo group (``core.mesh.initialize_distributed``), spawned as
``tests/test_multiprocess.py`` spawns the JAX package's.

Each worker runs one job of ``WORKER`` and writes its results to a file;
the test holds them to the JAX package (one SGD step on its 2-device
mesh), to the port in one process (global-batch BatchNorm, ``Trainer.fit``
over the same global batches, metrics counters) and to the checkpoint
that one mode writes and another restores. Every tolerance is stated where
it is used.
"""

import json
import os
import socket
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from custom_yolo_tpu.core.dtypes import resolve_policy as jax_policy
from custom_yolo_tpu.core.mesh import MeshSpec as JaxMeshSpec
from custom_yolo_tpu.core.mesh import create_mesh as jax_create_mesh
from custom_yolo_tpu.models import YoloModel as JaxYoloModel
from custom_yolo_tpu.parallel.sharding import shard_batch as jax_shard_batch
from custom_yolo_tpu.parallel.sharding import \
    shard_train_state as jax_shard_train_state
from custom_yolo_tpu.train.losses import DetectionLoss as JaxDetectionLoss
from custom_yolo_tpu.train.losses import LossConfig as JaxLossConfig
from custom_yolo_tpu.train.train_state import TrainState as JaxTrainState
from custom_yolo_tpu.train.train_step import \
    make_train_step as jax_make_train_step
from custom_yolo_tpu_torch import config as port_config
from custom_yolo_tpu_torch.data.dataset import DetectionDataset
from custom_yolo_tpu_torch.data.loader import DataLoader
from custom_yolo_tpu_torch.eval.metrics import DetectionMetrics
from custom_yolo_tpu_torch.models.detector import create_train_model
from custom_yolo_tpu_torch.nn.blocks import ConvBN
from custom_yolo_tpu_torch.train.trainer import Trainer
from custom_yolo_tpu_torch.utils.checkpoint import CheckpointManager
from custom_yolo_tpu_torch.utils.weights import from_jax_variables
from torch_project import (detection_cases, make_project,
                           random_jax_variables)

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TESTS = os.path.join(REPO, "tests")
WIDTH = (3, 8, 16, 32, 64, 64)
DEPTH = (1, 1, 1, 1, 1, 1)
CSP = (False, True)
NC = 7
HW = 64

WORKER = r"""
import json, os, sys, time
import numpy as np
import torch
torch.set_num_threads(1)

from custom_yolo_tpu_torch.core.mesh import initialize_distributed, rank

job, coord, pid, args_path = (sys.argv[1], sys.argv[2], int(sys.argv[3]),
                              sys.argv[4])
with open(args_path) as f:
    args = json.load(f)
world = args["world"]
out_path = f"{args['out']}.{pid}"


def save(**arrays):
    np.savez(out_path + ".npz", **arrays)


if job == "collectives":
    # build_kernels before the group exists would be a bug; join first
    initialize_distributed(coord, world, pid, device="cpu")
    from custom_yolo_tpu_torch.eval.metrics import DetectionMetrics
    from custom_yolo_tpu_torch.parallel.collectives import (reduce_metrics,
                                                            reduce_value)
    from custom_yolo_tpu_torch.parallel.multihost import build_kernels
    from torch_project import detection_cases
    events = []

    def stub_build():
        events.append(["build", time.time()])
        if rank() == 0:
            time.sleep(1.0)     # a slow build: the other rank must wait
        events.append(["built", time.time()])

    build_kernels(stub_build)
    events.append(["passed", time.time()])
    det = DetectionMetrics(args["num_classes"])
    for preds, targets in detection_cases(args["seed"])[pid::2]:
        det.update(preds, targets)
    det.all_reduce()
    result = {
        "events": events,
        "avg": float(reduce_value(float(pid + 1))),
        "total": float(reduce_value(float(pid + 1), average=False)),
        "metrics": reduce_metrics({"loss": 10.0 * (pid + 1),
                                   "box": float(pid)}),
        "det": {k: np.asarray(getattr(det, k)).tolist() for k in (
            "total_predictions", "total_ground_truths", "true_positives",
            "false_positives", "false_negatives", "class_tp", "class_fp",
            "class_fn", "class_gt_count")}}
    with open(out_path + ".json", "w") as f:
        json.dump(result, f)

elif job == "convbn":
    initialize_distributed(coord, world, pid, device="cpu")
    from custom_yolo_tpu_torch.nn.blocks import ConvBN
    data = np.load(args["data"])
    rows = slice(pid * 4, (pid + 1) * 4)
    m = ConvBN(4, 8, 3, padding=1)
    m.load_state_dict({k: torch.from_numpy(data[k]) for k in
                       m.state_dict() if k in data.files}, strict=False)
    m.global_batch = True
    m.train()
    x = torch.from_numpy(data["x"][rows]).requires_grad_()
    y = m(x)
    (y * torch.from_numpy(data["w"][rows])).sum().backward()
    save(y=y.detach().numpy(), dx=x.grad.numpy(),
         dweight=m.conv.weight.grad.numpy(), dscale=m.bn.weight.grad.numpy(),
         dbias=m.bn.bias.grad.numpy(),
         running_mean=m.bn.running_mean.numpy(),
         running_var=m.bn.running_var.numpy())

elif job == "step":
    initialize_distributed(coord, world, pid, device="cpu")
    from torch.distributed.tensor import DTensor
    from custom_yolo_tpu_torch.core.mesh import MeshSpec, create_mesh
    from custom_yolo_tpu_torch.models.detector import create_train_model
    from custom_yolo_tpu_torch.parallel.sharding import (shard_batch,
                                                         shard_train_state)
    from custom_yolo_tpu_torch.train.losses import DetectionLoss, LossConfig
    from custom_yolo_tpu_torch.train.train_state import TrainState
    from custom_yolo_tpu_torch.train.train_step import make_train_step
    variables = torch.load(args["variables"], weights_only=False)
    model = create_train_model(args["width"], args["depth"], args["csp"],
                               args["num_classes"], precision="float32",
                               device="cpu", variables=variables)
    # plain SGD, as the JAX test: no clipping (a factor of exactly 1)
    optimizer = torch.optim.SGD(model.parameters(), lr=args["lr"])
    optimizer.grad_clip = 1e30
    state = TrainState.create(model, optimizer, torch.Generator())
    mesh = create_mesh(MeshSpec(*args["mesh"]))
    state = shard_train_state(state, mesh, min_weight_size=1024)
    loss_fn = DetectionLoss(LossConfig(num_classes=args["num_classes"],
                                       assigner="tal"), global_batch=True)
    step = make_train_step(state.module, loss_fn, state.optimizer)
    data = np.load(args["batch"])
    n = data["images"].shape[0] // world
    batch = shard_batch({k: data[k][pid * n:(pid + 1) * n]
                         for k in data.files}, torch.device("cpu"))
    state, metrics = step(state, batch)
    n_sharded = sum(isinstance(p, DTensor) for p in model.parameters())
    n_whole = sum(not isinstance(p, DTensor) for p in model.parameters())
    full = state.state_dict()["model"]
    save(total_loss=metrics["total_loss"].numpy(), n_sharded=n_sharded,
         n_whole=n_whole, **{k: v.numpy() for k, v in full.items()})

elif job == "fit":
    initialize_distributed(coord, world, pid, device="cpu")
    from torch.distributed.tensor import DTensor
    from custom_yolo_tpu_torch.config import Config
    from custom_yolo_tpu_torch.data.dataset import DetectionDataset
    from custom_yolo_tpu_torch.data.loader import DataLoader
    from custom_yolo_tpu_torch.models.detector import create_train_model
    from custom_yolo_tpu_torch.train.trainer import Trainer
    from custom_yolo_tpu_torch.utils.checkpoint import CheckpointManager
    cfg = Config.from_dict(args["config"])
    model = create_train_model(cfg.model.width, cfg.model.depth,
                               cfg.model.csp, cfg.model.num_classes,
                               precision="float32", device="cpu", seed=0)
    ckpt = CheckpointManager(args["ckpt"]) if pid == 0 else None
    trainer = Trainer(cfg, model, checkpoint_manager=ckpt)
    ds = DetectionDataset(args["parquet"], args["images"],
                          input_size=(args["hw"], args["hw"]), max_gt=8)
    b = cfg.training.batch_size
    loaders = [DataLoader(ds, b, shuffle=shuffle, drop_last=shuffle,
                          num_workers=1, seed=0, use_native=False,
                          process_index=pid, process_count=2)
               for shuffle in (True, False)]
    history = trainer.fit(*loaders)["history"]
    n_sharded = sum(isinstance(p, DTensor) for p in model.parameters())
    full = trainer.state.state_dict()
    torch.save(full, out_path + ".pt")
    # the written checkpoint back into a new trainer of this mode, on
    # another model: its gathered state equals the one written
    from custom_yolo_tpu_torch.parallel.multihost import barrier
    barrier("written")
    again = Trainer(cfg, create_train_model(
        cfg.model.width, cfg.model.depth, cfg.model.csp,
        cfg.model.num_classes, precision="float32", device="cpu", seed=9))
    CheckpointManager(args["ckpt"]).restore(again.state)
    reloaded = again.state.state_dict()
    same = all(torch.equal(reloaded[part][k], full[part][k])
               for part in ("model", "ema") for k in full[part])
    same &= all(torch.equal(reloaded["optimizer"]["state"][i][k], v)
                for i, moments in full["optimizer"]["state"].items()
                for k, v in moments.items())
    with open(out_path + ".json", "w") as f:
        json.dump({"history": history, "n_sharded": n_sharded,
                   "reloaded_equal": bool(same)}, f)

torch.distributed.destroy_process_group()
print("DONE", pid, flush=True)
"""


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _env():
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [REPO, TESTS, env.get("PYTHONPATH", "")])
    env["OMP_NUM_THREADS"] = "1"
    return env


def _spawn(tmp_path, job, timeout=300, world=2, **args):
    """Run ``job`` of ``WORKER`` in ``world`` processes of one gloo group;
    returns the path prefix of their output files
    (``<prefix>.<rank>.*``)."""
    script = tmp_path / "torch_worker.py"
    script.write_text(WORKER)
    args["out"] = str(tmp_path / job)
    args["world"] = world
    args_path = tmp_path / f"{job}_args.json"
    args_path.write_text(json.dumps(args))
    coord = f"localhost:{_free_port()}"
    procs = [subprocess.Popen(
        [sys.executable, str(script), job, coord, str(pid), str(args_path)],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        env=_env(), cwd=REPO) for pid in range(world)]
    try:
        for p in procs:
            out, err = p.communicate(timeout=timeout)
            assert p.returncode == 0, f"worker failed:\n{out}\n{err}"
    finally:
        for p in procs:
            p.kill()
    return args["out"]


# ---------------------------------------------------------------- collectives
def test_two_process_collectives_and_aligned_build(tmp_path):
    """``reduce_value``/``reduce_metrics`` give the numbers of the JAX
    package's ``test_two_process_reduce``; ``DetectionMetrics.all_reduce``
    equals one process's counters over both halves of the cases; under
    ``build_kernels`` rank 0 builds first, and rank 1 passes the barrier
    and starts its own (checking) build only after rank 0's returned."""
    out = _spawn(tmp_path, "collectives", timeout=120, seed=3,
                 num_classes=NC)
    results = [json.loads(open(f"{out}.{pid}.json").read())
               for pid in (0, 1)]
    want = DetectionMetrics(NC)
    for preds, targets in detection_cases(3):
        want.update(preds, targets)
    for r in results:
        assert r["avg"] == pytest.approx(1.5, abs=1e-12)
        assert r["total"] == pytest.approx(3.0, abs=1e-12)
        assert r["metrics"] == {"box": 0.5, "loss": 15.0}
        for key, value in r["det"].items():
            assert np.array_equal(np.asarray(value),
                                  np.asarray(getattr(want, key))), key
    assert want.true_positives > 0 and want.false_positives > 0
    events = [dict((name, t) for name, t in r["events"]) for r in results]
    built_0 = events[0]["built"]
    assert events[0]["build"] <= built_0 <= events[0]["passed"]
    assert events[1]["passed"] >= built_0
    assert events[1]["build"] >= built_0


# ------------------------------------------------------ global-batch ConvBN
def test_global_batch_convbn_matches_one_process(tmp_path):
    """Two ranks with four rows each against one process with all eight:
    output and input gradient row by row, the weight gradients summed over
    the ranks, the running statistics on each rank, each within 1e-6 of
    its largest magnitude. That is a few fp32 ulps: the ranks sum their
    halves and then add the halves, an order other than one sum over all
    rows (measured: 2.2e-7 of the largest for the output, 3.7e-7 for the
    kernel's gradient)."""
    rng = np.random.RandomState(11)
    data = {"x": rng.randn(8, 4, 6, 6).astype(np.float32),
            "w": rng.randn(8, 8, 6, 6).astype(np.float32),
            "conv.weight": (0.3 * rng.randn(8, 4, 3, 3)).astype(np.float32),
            "bn.weight": rng.uniform(0.5, 1.5, 8).astype(np.float32),
            "bn.bias": (0.1 * rng.randn(8)).astype(np.float32)}
    np.savez(tmp_path / "convbn.npz", **data)
    out = _spawn(tmp_path, "convbn", timeout=120,
                 data=str(tmp_path / "convbn.npz"))
    got = [np.load(f"{out}.{pid}.npz") for pid in (0, 1)]

    m = ConvBN(4, 8, 3, padding=1)
    m.load_state_dict({k: torch.from_numpy(v) for k, v in data.items()
                       if k not in ("x", "w")}, strict=False)
    m.train()
    x = torch.from_numpy(data["x"]).requires_grad_()
    y = m(x)
    (y * torch.from_numpy(data["w"])).sum().backward()
    def close(got_value, want, key):
        want = want.detach().numpy()
        np.testing.assert_allclose(got_value, want, rtol=0, err_msg=key,
                                   atol=1e-6 * np.abs(want).max())

    close(np.concatenate([g["y"] for g in got]), y, "y")
    close(np.concatenate([g["dx"] for g in got]), x.grad, "dx")
    for key, want in (("dweight", m.conv.weight.grad),
                      ("dscale", m.bn.weight.grad),
                      ("dbias", m.bn.bias.grad)):
        close(got[0][key] + got[1][key], want, key)
    for g in got:
        close(g["running_mean"], m.bn.running_mean, "running_mean")
        close(g["running_var"], m.bn.running_var, "running_var")


# ------------------------------------------------ one SGD step against JAX
@pytest.fixture(scope="module")
def jax_small():
    model = JaxYoloModel(WIDTH, DEPTH, CSP, NC, policy=jax_policy("float32"))
    return model, random_jax_variables(model, HW, seed=0)


def _sgd_batch(n=8, g=4):
    rng = np.random.RandomState(3)
    return {"images": rng.rand(n, HW, HW, 3).astype(np.float32),
            "gt_boxes": (rng.rand(n, g, 4) * 24 + 8).astype(np.float32),
            "gt_labels": rng.randint(0, NC, (n, g)).astype(np.int32),
            "gt_mask": np.ones((n, g), bool)}


# mode -> (data, fsdp) of both meshes; the data x fsdp case runs on four
# ranks (hybrid sharding: FSDP2 splits along fsdp and replicates along data)
SGD_MESHES = {"dp": (2, 1), "fsdp": (1, 2), "data2xfsdp2": (2, 2)}


@pytest.mark.parametrize("mode", list(SGD_MESHES))
def test_two_rank_sgd_step_matches_jax_mesh(tmp_path, jax_small, mode):
    """One SGD step (lr 1e-3, TAL, so that ``score_sum`` crosses the ranks)
    of the port on two ranks (four for ``data2xfsdp2``) against the JAX
    package's step on a mesh of the same shape (``MeshSpec(data=2)``,
    ``MeshSpec(fsdp=2)``, ``MeshSpec(data=2, fsdp=2)``;
    fsdp_min_weight_size 1024 in both). A mesh with an fsdp axis splits
    some parameters and leaves others whole, dp splits none.

    Loss within 1e-5 relative, every parameter and BatchNorm statistic
    within atol 1e-6 / rtol 1e-4: the tolerances of
    ``tests/test_sharding.py``, which the JAX mesh step itself meets
    against its single-device step on this model at 0.90 (dp) and 0.96
    (fsdp) of the limit. Measured here: 0.81 of it at most (the first
    stage's kernel, whose gradient sums the most terms); 0.44 in the
    four-rank case."""
    model, variables = jax_small
    data_size, fsdp_size = SGD_MESHES[mode]
    world = data_size * fsdp_size
    batch = _sgd_batch()
    tx = optax.inject_hyperparams(
        lambda learning_rate: optax.sgd(learning_rate))(learning_rate=1e-3)
    state = JaxTrainState.create(jax.tree.map(jnp.asarray, variables), tx,
                                 jax.random.key(1))
    step = jax_make_train_step(
        model, JaxDetectionLoss(JaxLossConfig(num_classes=NC,
                                              assigner="tal")),
        tx, donate=False)
    mesh = jax_create_mesh(JaxMeshSpec(data=data_size, fsdp=fsdp_size))
    with jax.sharding.set_mesh(mesh):
        state = jax_shard_train_state(state, mesh, min_weight_size=1024)
        state, metrics = step(state, jax_shard_batch(
            {k: jnp.asarray(v) for k, v in batch.items()}, mesh))
        loss_j = float(metrics["total_loss"])
        after = jax.device_get({"params": state.params,
                                "batch_stats": state.batch_stats})

    torch.save(variables, tmp_path / "variables.pt")
    np.savez(tmp_path / "batch.npz", **batch)
    out = _spawn(tmp_path, "step", timeout=240, world=world,
                 mesh=[data_size, fsdp_size], lr=1e-3,
                 width=WIDTH, depth=DEPTH, csp=CSP, num_classes=NC,
                 variables=str(tmp_path / "variables.pt"),
                 batch=str(tmp_path / "batch.npz"))
    got = [np.load(f"{out}.{pid}.npz") for pid in range(world)]
    template = create_train_model(WIDTH, DEPTH, CSP, NC,
                                  precision="float32", device="cpu")
    want = from_jax_variables(after, template)
    for g in got:
        assert (int(g["n_sharded"]) > 0) == (fsdp_size > 1)
        assert int(g["n_whole"]) > 0
        np.testing.assert_allclose(float(g["total_loss"]), loss_j,
                                   rtol=1e-5)
        for key, value in want.items():
            if key.endswith("num_batches_tracked"):
                continue
            np.testing.assert_allclose(g[key], value.numpy(), atol=1e-6,
                                       rtol=1e-4, err_msg=key)


# ------------------------------------------------------------ Trainer.fit
FIT_COUNTERS = ("val/true_positives", "val/false_positives",
                "val/false_negatives", "val/total_ground_truths",
                "val/total_predictions")


def _fit_config(mode, batch_size, root):
    return {
        "project": {"num_classes": 3, "seed": 0,
                    "log_dir": str(root / "logs")},
        "model": {"num_classes": 3, "input_size": [HW, HW],
                  "config": {"csp": list(CSP), "depth": list(DEPTH),
                             "width": list(WIDTH)}},
        "data": {"augment": False, "pin_memory": False, "num_workers": 1,
                 "processed_dir": str(root / "parquet"),
                 "train_parquet": "val", "val_parquet": "val",
                 "train_images": str(root / "images"),
                 "val_images": str(root / "images")},
        "training": {"batch_size": batch_size, "epochs": 1,
                     "log_interval": 1, "learning_rate": 1e-3,
                     "ema_decay": 0.99, "ema_tau": 30.0, "warmup_steps": 4,
                     "assigner": "tal",
                     "sharding": {"mode": mode, "precision": "float32",
                                  "fsdp_min_weight_size": 1024}},
        "checkpoint": {"save_interval": 1},
    }


@pytest.fixture(scope="module")
def fit_project(tmp_path_factory):
    return make_project(tmp_path_factory.mktemp("mp_fit"), [(96, 96)] * 8)


@pytest.fixture(scope="module")
def fit_oracle(fit_project):
    """One process, batch 4, over the same global batches: the two ranks'
    loaders stride one shuffled order, so each global batch holds the
    same four images as this loader's batch of that step."""
    cfg = port_config.Config.from_dict(_fit_config("single", 4,
                                                   fit_project))
    trainer = Trainer(cfg, create_train_model(
        WIDTH, DEPTH, CSP, 3, precision="float32", device="cpu", seed=0))
    ds = DetectionDataset(str(fit_project / "parquet" / "val"),
                          str(fit_project / "images"), input_size=(HW, HW),
                          max_gt=8)
    loaders = [DataLoader(ds, 4, shuffle=shuffle, drop_last=shuffle,
                          num_workers=1, seed=0, use_native=False)
               for shuffle in (True, False)]
    return trainer.fit(*loaders)["history"][-1]


@pytest.mark.parametrize("mode", ["dp", "fsdp"])
def test_two_rank_fit_matches_one_process(fit_project, fit_oracle, tmp_path,
                                          mode):
    """``Trainer.fit`` for one epoch (TAL, EMA, warm-up) on two ranks with
    two images each against one process with four: the validation counters
    all-reduced over the ranks equal the oracle's exactly, the train and
    validation losses within 2e-3 relative (the limit of
    ``tests/test_multiprocess.py``, which reassociation across ranks and
    AdamW's renormalisation of near-zero gradients stay far inside; a
    missing reduction moves them by O(1)). Both ranks report the same
    record. Then the checkpoint rank 0 wrote: into a new trainer of the
    same mode it restores every value of the gathered state bit for bit,
    and under fsdp also into a ``single`` trainer."""
    ckpt_dir = tmp_path / "ck"
    out = _spawn(tmp_path, "fit", timeout=300,
                 config=_fit_config(mode, 2, fit_project),
                 parquet=str(fit_project / "parquet" / "val"),
                 images=str(fit_project / "images"), hw=HW,
                 ckpt=str(ckpt_dir))
    results = [json.loads(open(f"{out}.{pid}.json").read())
               for pid in (0, 1)]
    records = [r["history"][-1] for r in results]
    assert records[0] == pytest.approx(
        {k: v for k, v in records[1].items() if k != "epoch_time_s"}
        | {"epoch_time_s": records[0]["epoch_time_s"]})
    for key in FIT_COUNTERS:
        assert records[0][key] == fit_oracle[key], key
    for key in ("train/total_loss", "val/total_loss"):
        assert records[0][key] == pytest.approx(fit_oracle[key], rel=2e-3)
    for r in results:
        assert (r["n_sharded"] > 0) == (mode == "fsdp")
        assert r["reloaded_equal"]
    if mode != "fsdp":
        return
    written = torch.load(f"{out}.0.pt", weights_only=False)
    cfg = port_config.Config.from_dict(_fit_config("single", 4,
                                                   fit_project))
    single = Trainer(cfg, create_train_model(
        WIDTH, DEPTH, CSP, 3, precision="float32", device="cpu", seed=4))
    CheckpointManager(str(ckpt_dir)).restore(single.state)
    restored = single.state.state_dict()
    for part in ("model", "ema"):
        for key, value in written[part].items():
            assert torch.equal(restored[part][key], value), (part, key)
    for i, moments in written["optimizer"]["state"].items():
        for key, value in moments.items():
            assert torch.equal(restored["optimizer"]["state"][i][key],
                               value), (i, key)
    assert (single.state.step, single.state.epoch) == (written["step"],
                                                       written["epoch"])


# ------------------------------------------------------------- train CLI
def test_train_cli_under_torchrun(fit_project, tmp_path):
    """``python -m torch.distributed.run --nproc_per_node 2
    scripts/torch_train.py --mode dp --device cpu`` finishes one epoch:
    rank 0 writes the checkpoint and the sidecar and prints the epoch's
    record; each rank prints its launch counts."""
    raw = _fit_config("dp", 2, fit_project)
    raw["checkpoint"]["checkpoint_dir"] = str(tmp_path / "ck")
    path = tmp_path / "cfg.yaml"
    port_config.Config.from_dict(raw).save(str(path))
    env = {**_env(), "SLURM_CPUS_PER_TASK": "1"}
    r = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--nproc_per_node",
         "2", "--master_port", str(_free_port()),
         os.path.join(REPO, "scripts", "torch_train.py"), "--config",
         str(path), "--device", "cpu", "--mode", "ddp", "--epochs", "1"],
        capture_output=True, text=True, env=env, cwd=tmp_path, timeout=300)
    assert r.returncode == 0, r.stdout[-3000:] + r.stderr[-3000:]
    assert (tmp_path / "ck" / "model_epoch_0" / "state.pt").exists()
    lines = r.stdout.splitlines()
    history = [json.loads(line.split(": ", 1)[1]) for line in lines
               if line.startswith("[INFO] history: ")]
    assert len(history) == 1 and np.isfinite(history[0]["val/total_loss"])
    assert sum(line.startswith("[INFO] kernel launches: ")
               for line in lines) == 2
    assert "rank 0 of 2" in r.stderr
