"""Build and load the port's hand-written CUDA kernels.

Each ``csrc/*.cu`` file exposes a plain C interface and is compiled on its
own by ``nvcc`` for ``sm_90a`` into a shared library that ``ctypes`` loads.
Libraries go to ``_build/`` beside this file (git-ignored), named by a hash
of the source, the headers under ``csrc/`` (``*.cuh``, hashed into every
library) and the flags, so an edited source or header is rebuilt at its
next use and an unchanged one is reused. :func:`build` starts one ``nvcc``
per missing library, all at once, and waits for every one of them.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict, Iterable, Optional

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "_build"

FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
         "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v")
# name → (source, extra flags). nms.cu must not contract the IoU's
# multiply-add into an FMA: keep-sets are compared bit-exactly with the
# JAX package.
SOURCES = {
    "attention": ("attention.cu", ()),
    "attention_bwd": ("attention_bwd.cu", ()),
    "nms": ("nms.cu", ("-fmad=false",)),
    "sppf": ("sppf.cu", ()),
    "head": ("head.cu", ()),
    "quant": ("quant.cu", ()),
}

# dynamic shared memory one block may opt into on Hopper (sm_90)
SMEM_LIMIT = 232_448

_loaded: Dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found on PATH or in /usr/local/cuda/bin; "
                           "the CUDA kernels are built from source at first "
                           "use")
    return path


def _flags(name: str):
    return FLAGS + SOURCES[name][1]


def library_path(name: str) -> Path:
    source = (CSRC / SOURCES[name][0]).read_bytes() + b"".join(
        header.read_bytes() for header in sorted(CSRC.glob("*.cuh")))
    digest = hashlib.sha256(
        source + " ".join(_flags(name)).encode()).hexdigest()[:16]
    return BUILD_DIR / f"{name}-{digest}.so"


def build(names: Optional[Iterable[str]] = None) -> Dict[str, str]:
    """Compile every named library that is not built yet, one ``nvcc`` per
    source, all started together. Returns each fresh build's compiler log
    (``ptxas`` register and shared-memory report); raises with the log of
    any build that failed."""
    names = list(SOURCES) if names is None else list(names)
    running = {}
    for name in names:
        out = library_path(name)
        if out.exists():
            continue
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = out.with_name(f"{out.stem}.{os.getpid()}.tmp")
        cmd = [_nvcc(), *_flags(name), "-o", str(tmp),
               str(CSRC / SOURCES[name][0])]
        running[name] = (subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True), tmp, out)
    logs, failures = {}, []
    for name, (proc, tmp, out) in running.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            failures.append(f"{name}: nvcc exited {proc.returncode}\n{log}")
            continue
        os.replace(tmp, out)
        logs[name] = log
    if failures:
        raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(failures))
    return logs


def load(name: str) -> ctypes.CDLL:
    """The loaded library of kernel ``name``, built first if needed."""
    lib = _loaded.get(name)
    if lib is None:
        if not torch.cuda.is_available():
            raise RuntimeError(f"kernel {name!r} needs a CUDA device and "
                               "none is available")
        build([name])
        lib = _loaded[name] = ctypes.CDLL(str(library_path(name)))
    return lib


def check(lib: ctypes.CDLL, status: int, what: str) -> None:
    """Raise if a C entry point of ``lib`` returned a CUDA error code."""
    if status != 0:
        fn = lib.cuda_error_string
        fn.argtypes, fn.restype = [ctypes.c_int], ctypes.c_char_p
        raise RuntimeError(f"{what}: CUDA error {status} "
                           f"({fn(status).decode()})")
