"""The port's slurm jobs (``slurm/*_torch.sbatch``): each passes ``bash -n``
and, run with stand-ins for ``srun``, ``torchrun``, ``scontrol`` and
``python`` that record their arguments, starts the port's CLI with the
job's variables. The training jobs' ``scripts/torch_train.py`` arguments
parse with that script's own parser."""

import os
import subprocess

import pytest
import torch

from torch_project import load_script

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# srun runs its command, as the real one does on each task; the others
# only record theirs (scontrol names two hosts)
STUBS = {
    "srun": 'exec "$@"',
    "torchrun": "",
    "python": "",
    "scontrol": 'printf "node-a\\nnode-b\\n"',
}
VARIABLES = {"MODE": "fsdp", "PRECISION": "float32", "BATCH_SIZE": "6",
             "DATASET_PERCENT": "0.25", "RESUME": "ck/model_epoch_3",
             "WORLD_SIZE": "4", "SLURM_CPUS_PER_TASK": "8",
             "SLURM_NNODES": "2", "SLURM_JOB_ID": "77",
             "SLURM_JOB_NODELIST": "node-[a-b]", "GPUS_PER_NODE": "8"}


def run_job(tmp_path, job: str, **overrides) -> dict:
    """``bash slurm/<job>`` from ``tmp_path`` with the stand-ins first on
    ``PATH`` and ``VARIABLES`` (``overrides`` over them) in the
    environment; returns each stand-in's argv lists, in call order."""
    bin_dir = tmp_path / "bin"
    bin_dir.mkdir()
    log = tmp_path / "calls"
    for name, body in STUBS.items():
        stub = bin_dir / name
        stub.write_text(f'#!/bin/bash\nprintf "{name}" >> {log}\n'
                        f'printf "\\t%s" "$@" >> {log}\necho >> {log}\n'
                        f"{body}\n")
        stub.chmod(0o755)
    env = {**os.environ, **VARIABLES, **overrides,
           "PATH": f"{bin_dir}{os.pathsep}{os.environ['PATH']}",
           "SLURM_SUBMIT_DIR": str(tmp_path)}
    r = subprocess.run(["bash", os.path.join(REPO, "slurm", job)],
                       env=env, cwd=tmp_path, capture_output=True,
                       text=True, timeout=60)
    assert r.returncode == 0, r.stderr
    calls = {}
    for line in log.read_text().splitlines():
        name, *argv = line.split("\t")
        calls.setdefault(name, []).append(argv)
    return calls


def train_args(argv: list):
    """The arguments after ``scripts/torch_train.py``, parsed by it."""
    i = argv.index("scripts/torch_train.py")
    return load_script("torch_train").parse_args(argv[i + 1:])


JOBS = ["distributed_training_gpu_torch.sbatch",
        "distributed_training_cpu_torch.sbatch",
        "data_preprocess_torch.sbatch"]


@pytest.mark.parametrize("job", JOBS)
def test_job_passes_bash_n(job):
    r = subprocess.run(["bash", "-n", os.path.join(REPO, "slurm", job)],
                       capture_output=True, text=True)
    assert r.returncode == 0, r.stderr


def test_gpu_job_starts_torchrun_a_card_with_the_head_as_rendezvous(
        tmp_path):
    calls = run_job(tmp_path, JOBS[0])
    assert calls["scontrol"] == [["show", "hostnames", "node-[a-b]"]]
    (srun,), (torchrun,) = calls["srun"], calls["torchrun"]
    assert srun[0] == "torchrun" and srun[1:] == torchrun
    flags = dict(zip(torchrun[:10:2], torchrun[1:10:2]))
    assert flags == {"--nnodes": "2", "--nproc_per_node": "8",
                     "--rdzv_id": "77", "--rdzv_backend": "c10d",
                     "--rdzv_endpoint": "node-a:29500"}
    args = train_args(torchrun)
    assert (args.mode, args.device, args.precision, args.batch_size,
            args.dataset_percent, args.load_from_checkpoint) == (
        "fsdp", "cuda", "float32", 6, 0.25, "ck/model_epoch_3")
    assert (tmp_path / "logs").is_dir()


def test_cpu_job_starts_world_size_gloo_ranks(tmp_path):
    calls = run_job(tmp_path, JOBS[1])
    (torchrun,) = calls["torchrun"]
    assert torchrun[:3] == ["--standalone", "--nproc_per_node", "4"]
    args = train_args(torchrun)
    assert (args.mode, args.device, args.precision, args.batch_size,
            args.dataset_percent, args.load_from_checkpoint) == (
        "fsdp", "cpu", "float32", 6, 0.25, "ck/model_epoch_3")
    assert "scontrol" not in calls


def test_preprocess_job_runs_the_ports_etl(tmp_path):
    calls = run_job(tmp_path, JOBS[2], MODE="val")
    assert calls["srun"] == [["python", "scripts/torch_data_preprocess.py",
                              "--mode", "val"]]
    assert calls["python"] == [["scripts/torch_data_preprocess.py",
                                "--mode", "val"]]
