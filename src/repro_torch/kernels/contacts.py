"""The fused pairwise-contact sweep: a hand-written CUDA kernel for Hopper
and its plain PyTorch version.

Replaces the TPU Pallas kernel ``repro/kernels/contacts.py::
pairwise_contacts`` (body ``_kernel``). Per batch item and row ``i`` it
computes, against all N columns,

* ``closew`` ``(B, N, ceil(N/32))`` int32 words: bit ``j`` of row ``i`` is
  ``d² <= r_tx² and (zw_i & zw_j) != 0 and i != j`` (LSB-first, pad bits
  zero) — the next slot's ``prev_close``;
* ``best_j`` ``(B, N)`` int32: the first-minimum argmin of d² over the
  candidates ``close and not prev and elig_i and elig_j``, or -1;
* ``has`` ``(B, N)`` bool: whether row ``i`` has a candidate.

d² is ``fma(dx, dx, dy*dy)`` everywhere — ``__fmaf_rn`` in the kernel, a
float64 emulation in the plain version (:func:`repro_torch.numerics.
fma32`) — because that is how jitted XLA rounds the reference's
``dx*dx + dy*dy``.

Dispatch: a CPU tensor gets the plain version; a CUDA tensor gets the
kernel (source ``csrc/contacts.cu``, built with nvcc for ``sm_90a`` on
first use into ``build/repro_torch/`` and loaded with ``ctypes``) or an
error. Nothing falls back.

Bound on the H100: the sweep reads each input once and writes each output
once, ``18·B·N + 8·B·N·ceil(N/32)`` bytes, and does 5 float32 operations
per pair; at the paper's N = 200 both bounds are a few nanoseconds, so
the launch itself dominates. The design (one warp per
row, columns staged through shared memory, ``__ballot_sync`` packing one
word per 32 columns, a warp-shuffle argmin) keeps every intermediate out
of device memory, as the TPU kernel keeps it in VMEM.
"""

from __future__ import annotations

import ctypes
import functools
from pathlib import Path

import torch

from repro_torch.kernels import build as _build
from repro_torch.numerics import fma32

__all__ = [
    "zone_words", "apply_access", "pairwise_close_ref", "candidate_best_ref",
    "pairwise_contacts_ref", "pairwise_contacts", "build_library",
    "SOURCE", "BUILD_DIR",
]

SOURCE = _build.CSRC / "contacts.cu"
BUILD_DIR = _build.BUILD_DIR


def zone_words(member: torch.Tensor) -> torch.Tensor:
    """``(..., N)`` int32 zone words from ``(..., N, K)`` bool membership
    (bit ``z`` = member of zone ``z``); two nodes may exchange iff their
    words intersect."""
    from repro_torch.sim.compute import pack_mask

    if member.shape[-1] > 32:
        raise ValueError("zone membership words support at most 32 zones")
    return pack_mask(member)[..., 0]


def apply_access(zw: torch.Tensor, access) -> torch.Tensor:
    """Zero the zone word of inaccessible nodes (``access=None``: all on)."""
    if access is None:
        return zw
    return torch.where(access, zw, torch.zeros_like(zw))


def pairwise_close_ref(x, y, zw, r_tx2):
    """Shared stage: ``(closew, d2)`` — the packed contact matrix and the
    ``(B, N, N)`` float32 squared distances it was thresholded from."""
    # the word layout lives with the simulator's other word ops
    from repro_torch.sim.compute import pack_mask

    n = x.shape[-1]
    dx = x[..., :, None] - x[..., None, :]
    dy = y[..., :, None] - y[..., None, :]
    d2 = fma32(dx, dx, dy * dy)
    eye = torch.eye(n, dtype=torch.bool, device=x.device)
    close = ((d2 <= r_tx2) & ((zw[..., :, None] & zw[..., None, :]) != 0)
             & ~eye)
    return pack_mask(close), d2


def candidate_best_ref(d2, closew, prevw, elig):
    """Per-run stage: the first-minimum candidate per row.

    ``cand = close and not prev and elig_i and elig_j``; ``best_j`` is the
    argmin of ``where(cand, d2, inf)`` (torch returns the first index on
    ties), -1 where no candidate exists."""
    from repro_torch.sim.compute import unpack_mask

    n = d2.shape[-1]
    cand = (unpack_mask(closew & ~prevw, n) & elig[..., :, None]
            & elig[..., None, :])
    scores = torch.where(cand, d2, torch.full_like(d2, float("inf")))
    has = cand.any(-1)
    best = torch.where(has, scores.argmin(-1).to(torch.int32), -1)
    return best, has


def pairwise_contacts_ref(x, y, zw, elig, prevw, r_tx2):
    """Plain PyTorch version of the kernel: ``(closew, best_j, has)``."""
    closew, d2 = pairwise_close_ref(x, y, zw, r_tx2)
    best, has = candidate_best_ref(d2, closew, prevw, elig)
    return closew, best, has


def build_library() -> Path:
    """Compile ``csrc/contacts.cu`` for sm_90a unless a build of this exact
    source exists; returns the shared library's path."""
    return _build.build_library(SOURCE, "contacts")


@functools.lru_cache(maxsize=None)
def _library():
    lib = ctypes.CDLL(str(build_library()))
    fn = lib.pairwise_contacts_launch
    fn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 3 + [
        ctypes.c_float, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return lib


def _check_inputs(x, y, zw, elig, prevw):
    b, n = x.shape
    nw = (n + 31) // 32
    want = ((x, (b, n), torch.float32), (y, (b, n), torch.float32),
            (zw, (b, n), torch.int32), (elig, (b, n), torch.bool),
            (prevw, (b, n, nw), torch.int32))
    for name, (t, shape, dtype) in zip(("x", "y", "zw", "elig", "prevw"), want):
        if t.device != x.device:
            raise ValueError(f"{name} is on {t.device}, x on {x.device}")
        if tuple(t.shape) != shape or t.dtype != dtype:
            raise ValueError(f"{name}: want {shape} {dtype}, got "
                             f"{tuple(t.shape)} {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    _build.check_hopper(x.device, "pairwise_contacts")
    return b, n, nw


def pairwise_contacts(x, y, zw, elig, prevw, r_tx2):
    """The fused sweep: the CUDA kernel on a CUDA tensor, the plain version
    on a CPU tensor. Inputs are ``(B, N)`` x, y (float32), zone words
    (int32), elig (bool) and the ``(B, N, ceil(N/32))`` int32 ``prevw``."""
    if x.device.type == "cpu":
        return pairwise_contacts_ref(x, y, zw, elig, prevw, r_tx2)
    if x.device.type != "cuda":
        raise ValueError(f"pairwise_contacts: unsupported device {x.device}")
    b, n, nw = _check_inputs(x, y, zw, elig, prevw)
    closew = torch.empty((b, n, nw), dtype=torch.int32, device=x.device)
    best = torch.empty((b, n), dtype=torch.int32, device=x.device)
    has = torch.empty((b, n), dtype=torch.bool, device=x.device)
    with torch.cuda.device(x.device):
        err = _library().pairwise_contacts_launch(
            x.data_ptr(), y.data_ptr(), zw.data_ptr(), elig.data_ptr(),
            prevw.data_ptr(), closew.data_ptr(), best.data_ptr(),
            has.data_ptr(), b, n, nw, r_tx2,
            torch.cuda.current_stream(x.device).cuda_stream,
        )
    if err != 0:
        raise RuntimeError(f"pairwise_contacts launch failed: CUDA error {err}")
    pairwise_contacts.launches += 1
    return closew, best, has


#: Kernel launches since the last reset (the plain version never counts).
pairwise_contacts.launches = 0
