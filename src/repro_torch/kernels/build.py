"""Builds a CUDA source of ``repro_torch/csrc`` into a shared library.

nvcc compiles the source for ``sm_90a`` with ``--fmad=false`` (every fused
multiply-add in the kernels is an explicit intrinsic) into
``build/repro_torch/<stem>-<hash>.so``, where the hash covers the source
and the flags; an existing build of the same hash is reused. The library
has a plain C interface and is loaded with ``ctypes``.
"""

from __future__ import annotations

import hashlib
import os
import shutil
import subprocess
from pathlib import Path

__all__ = ["CSRC", "BUILD_DIR", "NVCC_FLAGS", "build_library",
           "check_hopper"]

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "--fmad=false", "-shared", "-Xcompiler", "-fPIC")


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    for cand in (os.path.join(home, "bin", "nvcc"), shutil.which("nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernel needs the CUDA toolkit")


def build_library(source: Path, stem: str) -> Path:
    """Compile ``source`` unless a build of this exact source and these
    flags exists; returns the shared library's path."""
    digest = hashlib.sha256(source.read_bytes() + " ".join(NVCC_FLAGS).encode())
    out = BUILD_DIR / f"{stem}-{digest.hexdigest()[:16]}.so"
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(source)]
    res = subprocess.run(cmd, capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError(f"nvcc failed ({res.returncode}):\n{res.stderr}")
    os.replace(tmp, out)
    return out


def check_hopper(device, kernel: str) -> None:
    """Raise unless ``device`` is an sm_90 card, the kernels' one target."""
    import torch

    if torch.cuda.get_device_capability(device) != (9, 0):
        raise RuntimeError(
            f"the {kernel} kernel is built for sm_90a (Hopper); "
            f"{torch.cuda.get_device_name(device)} is not sm_90")
