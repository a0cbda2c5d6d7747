"""Build and load the package's hand-written CUDA kernels.

Each kernel is one `csrc/<name>.cu` with a plain C entry point. It is
compiled with nvcc for sm_90a into `build/kernels/lib<name>.so` at the
repository root on first use, rebuilt when its source is newer, and loaded
with ctypes. A failed build raises; nothing falls back.

The constant tables the kernels and their plain versions read (DCT
matrices, filter taps, QP tables) stay in hevc/tables.py and friends;
`table` puts each on a device once.
"""
from __future__ import annotations

import ctypes
import os
import shutil
import subprocess

import numpy as np
import torch

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_PKG), "build", "kernels")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v"]

_LIBS = {}
# name -> ptxas's report of the last build (registers, shared memory,
# spills per kernel)
PTXAS = {}
_TABLES = {}  # (id(array), device) -> (array, int32 tensor)


def _nvcc() -> str:
    path = shutil.which("nvcc")
    if path:
        return path
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = os.path.join(home, "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA "
                           "toolkit (PATH or CUDA_HOME)")
    return path


def build(name: str, force: bool = False) -> str:
    """Compile csrc/<name>.cu if its library is missing or stale (or
    always, with force); returns the library's path."""
    src = os.path.join(CSRC, f"{name}.cu")
    so = os.path.join(BUILD_DIR, f"lib{name}.so")
    if (not force and os.path.exists(so)
            and os.path.getmtime(so) >= os.path.getmtime(src)):
        return so
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{so}.{os.getpid()}.tmp"
    cmd = [_nvcc()] + NVCC_FLAGS + ["-o", tmp, src]
    r = subprocess.run(cmd, capture_output=True, text=True)
    if r.returncode != 0:
        raise RuntimeError(f"nvcc failed for {src}:\n{r.stdout}{r.stderr}")
    PTXAS[name] = [ln.strip() for ln in r.stderr.splitlines()
                   if "spill" in ln or ("ptxas info" in ln and (
                       "Compiling" in ln or "Used" in ln))]
    os.replace(tmp, so)
    return so


def table(array: np.ndarray, device) -> torch.Tensor:
    """A module-level constant table as an int32 tensor on `device`,
    uploaded once (the entry keeps the array, so its id stays valid)."""
    dev = torch.device(device)
    ent = _TABLES.get((id(array), dev))
    if ent is None:
        ent = _TABLES[(id(array), dev)] = (array, torch.as_tensor(
            np.asarray(array, np.int32), device=dev))
    return ent[1]


def load(name: str) -> ctypes.CDLL:
    """The loaded library of csrc/<name>.cu, built first if needed."""
    lib = _LIBS.get(name)
    if lib is None:
        lib = _LIBS[name] = ctypes.CDLL(build(name))
    return lib
