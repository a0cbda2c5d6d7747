"""Build and load the package's hand-written CUDA kernels.

Each kernel is one `csrc/<name>.cu` with a plain C entry point. It is
compiled with nvcc for sm_90a into `build/kernels/lib<name>.so` at the
repository root on first use, rebuilt when its source is newer, and loaded
with ctypes. A failed build raises; nothing falls back.

The constant tables the kernels and their plain versions read (DCT
matrices, filter taps, QP tables) stay in hevc/tables.py and friends;
`table` puts each on a device once, and `_tables` compiles into a kernel
the tables it reads as immediates (the DCT coefficients of the residual
kernel and of the forward transform, and the forward DST: from the
kernel's parameters they cost it a constant-cache miss each; the luma
filter taps of the all-phase interpolation and of the subpel planes,
which held registers; the intra angles and filter thresholds of the
rank-SATD tables; the beta, tc and chroma QP tables of the deblocking
filter; the SAO edge directions and sign remap).
"""
from __future__ import annotations

import contextlib
import ctypes
import os
import shutil
import subprocess

import numpy as np
import torch

from turingcodec_tpu_torch.utils.profiler import TRACE

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


def _tables(name: str) -> list:
    """nvcc flags that compile into a kernel the constant tables it takes
    at compile time, made from hevc/tables.py so that each table lives
    there alone: a generated header of #defines, pre-included (nvcc splits
    a -D value at its commas)."""
    from turingcodec_tpu_torch.decode.deblock import BETA_TABLE, TC_TABLE
    from turingcodec_tpu_torch.decode.reconstruct import _HVD_THRES
    from turingcodec_tpu_torch.hevc.tables import (CHROMA_QP_TABLE_420, DST4,
                                                   INTRA_INV_ANGLE,
                                                   INTRA_PRED_ANGLE,
                                                   LUMA_FILTER, dct2_matrix)
    from turingcodec_tpu_torch.ops.sao import _EO_A, _REMAP
    tables = {"TC_DCT32_HALF": np.asarray(dct2_matrix(32))[:, :16],
              "TC_DST4": np.asarray(DST4),
              "TC_LUMA_FILTER": np.asarray(LUMA_FILTER),
              "TC_INTRA_PRED_ANGLE": np.asarray(INTRA_PRED_ANGLE),
              "TC_INTRA_INV_ANGLE": np.asarray(INTRA_INV_ANGLE),
              "TC_HVD_THRES": np.asarray([_HVD_THRES[n] for n in (8, 16, 32)]),
              "TC_BETA_TABLE": np.asarray(BETA_TABLE),
              "TC_TC_TABLE": np.asarray(TC_TABLE),
              "TC_CHROMA_QP_TABLE": np.asarray(CHROMA_QP_TABLE_420),
              "TC_SAO_EO_A": np.asarray(_EO_A),
              "TC_SAO_REMAP": np.asarray(_REMAP)}
    wanted = {"dequant_idct": ("TC_DCT32_HALF",),
              "fwd_transform": ("TC_DCT32_HALF", "TC_DST4"),
              "interp_all_phases": ("TC_LUMA_FILTER",),
              "subpel_planes": ("TC_LUMA_FILTER",),
              "rank_satd": ("TC_INTRA_PRED_ANGLE", "TC_INTRA_INV_ANGLE",
                            "TC_HVD_THRES"),
              "deblock": ("TC_BETA_TABLE", "TC_TC_TABLE",
                          "TC_CHROMA_QP_TABLE"),
              "sao": ("TC_SAO_EO_A", "TC_SAO_REMAP")}.get(name)
    if not wanted:
        return []
    header = os.path.join(BUILD_DIR, f"{name}_tables.h")
    tmp = f"{header}.{os.getpid()}.tmp"
    with open(tmp, "w") as f:
        f.write("// generated by ops/kernel_build.py from hevc/tables.py\n")
        for key in wanted:
            vals = ", ".join(map(str, tables[key].ravel().tolist()))
            f.write(f"#define {key} {vals}\n")
    os.replace(tmp, header)
    return ["--pre-include", header]


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
    cmd = [_nvcc()] + NVCC_FLAGS + _tables(name) + ["-o", tmp, src]
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


def upload_packed(arrays, device, span=None) -> list:
    """Host arrays as tensors on `device` by one copy: packed at 16-byte
    offsets into one host buffer, pinned for a card (so the copy runs
    asynchronously from page-locked memory), each returned tensor a view of
    its part of the device buffer with the array's type and shape. The
    caching host allocator keeps the pinned buffer from reuse until the
    copy is done. `span` names the copy in the port's trace: a span of
    that name, its bytes counted as `<span>.pinned_bytes` (or
    `.pageable_bytes`) of the caller's picture."""
    device = torch.device(device)
    arrays = [np.ascontiguousarray(a) for a in arrays]
    offsets, total = [], 0
    for a in arrays:
        offsets.append(total)
        total += -(-a.nbytes // 16) * 16
    pinned = device.type == "cuda"
    with TRACE.span(span) if span else contextlib.nullcontext():
        if span:
            TRACE.count(f"{span}.{'pinned' if pinned else 'pageable'}_bytes",
                        total)
        host = torch.empty(total, dtype=torch.uint8, pin_memory=pinned)
        buf = host.numpy()
        for a, o in zip(arrays, offsets):
            buf[o:o + a.nbytes] = a.reshape(-1).view(np.uint8)
        dev = host.to(device, non_blocking=True)
    return [dev[o:o + a.nbytes].view(torch.from_numpy(a[:0].reshape(-1))
                                     .dtype).view(a.shape)
            for a, o in zip(arrays, offsets)]


def load(name: str) -> ctypes.CDLL:
    """The loaded library of csrc/<name>.cu, built first if needed."""
    lib = _LIBS.get(name)
    if lib is None:
        lib = _LIBS[name] = ctypes.CDLL(build(name))
    return lib
