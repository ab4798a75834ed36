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

What bounds it on the H100: the launch. The sweep reads each input once
and writes each output once, ``18·B·N + 8·B·N·ceil(N/32)`` bytes, and
does 5 float32 operations per pair; at the paper's N = 200 both bounds are
a few nanoseconds, far below the card's floor for starting and retiring a
kernel. What a launch costs beyond that floor is the chain of dependent
memory round trips inside it. The first design (one warp a row, 8 rows a
block, columns staged in chunks of 256) waited on one global load of a
``prevw`` word per 32 columns, in turn, and ran 25 blocks at N = 200. This
one, still one warp a row, issues every global read of the row (its own
node, its first 32 ``prevw`` words, lane ``k`` holding word ``k``) and of
the columns (13 bytes a node, staged once into shared memory behind one
barrier) before it computes; past 1024 columns each segment of 1024 loads
the next one's ``prevw`` words before its own work. It takes the words 8
at a time, unrolled, each word's prev bits by a shuffle from the lane that
holds them and its ``__ballot_sync`` kept by that lane, so ``closew``
leaves in one coalesced store a segment; and merges the lanes' first
minima by (d², j). The launch geometry, :func:`contact_geometry`, takes 4
rows a block (50 blocks at N = 200; a batch of 16 runs 800) and chunks
the columns only beyond 16384 of them (213 KB of shared memory). Nothing
intermediate reaches device memory, as the TPU kernel keeps it in VMEM.

The module also holds the cell-list backend's kernel,
:func:`cell_close_words` (source ``csrc/cells.cu``; it replaces the TPU
Pallas kernel ``repro/kernels/contacts.py::cell_close_words``, body
``_cell_kernel``), with the padded-grid layout helpers it shares with
``repro_torch.sim.cells`` and its plain version.
"""

from __future__ import annotations

import ctypes
import functools
from pathlib import Path
from typing import NamedTuple

import torch

from repro_torch.kernels import build as _build
from repro_torch.numerics import fma32

__all__ = [
    "zone_words", "apply_access", "pairwise_close_ref", "candidate_best_ref",
    "pairwise_contacts_ref", "pairwise_contacts", "contact_geometry",
    "ContactGeometry", "build_library",
    "SOURCE", "BUILD_DIR", "padded_cell_id", "cell_neighborhood_offsets",
    "interior_cell_ids", "cell_close_words_ref", "cell_close_words",
    "build_cell_library", "CELL_SOURCE",
]

SOURCE = _build.CSRC / "contacts.cu"
CELL_SOURCE = _build.CSRC / "cells.cu"
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


#: ``pairwise_contacts``' geometry: rows (warps) a block, as ``kRows`` in
#: ``csrc/contacts.cu``; columns staged in shared memory at once, as
#: ``kMaxChunk``; bytes staged a column (x, y and the zone word, 4 each;
#: elig, 1).
ROWS = 4
MAX_CHUNK = 16384
STAGE_BYTES = 13


class ContactGeometry(NamedTuple):
    """``pairwise_contacts``' launch: ``rows`` warps a block, one row each;
    ``chunk`` columns staged into ``smem`` bytes of shared memory at once."""
    rows: int
    chunk: int
    smem: int


def contact_geometry(n: int) -> ContactGeometry:
    """The launch geometry of the sweep over items of ``n`` nodes.

    A block takes ``ROWS`` = 4 rows at every size (50 blocks at N = 200,
    200 at N = 800, 800 at B = 16 and N = 200). Every column is staged at
    once up to ``MAX_CHUNK`` (13 bytes a node, 213 KB at 16384 of the 227
    KB a block may hold); beyond it the kernel passes over the row in
    chunks of ``MAX_CHUNK``. The grid, (row tiles, B), is the kernel's."""
    if n < 1:
        raise ValueError(f"contact_geometry: need n >= 1, got {n}")
    chunk = min(n, MAX_CHUNK)
    return ContactGeometry(rows=ROWS, chunk=chunk,
                           smem=-(-STAGE_BYTES * chunk // 16) * 16)


def build_library() -> Path:
    """Compile ``csrc/contacts.cu`` for sm_90a unless a build of this exact
    source exists; returns the shared library's path."""
    return _build.build_library(SOURCE, "contacts")


@functools.lru_cache(maxsize=None)
def _library():
    lib = ctypes.CDLL(str(build_library()))
    fn = lib.pairwise_contacts_launch
    fn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 3 + [
        ctypes.c_float] + [ctypes.c_int] * 2 + [ctypes.c_void_p]
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
    if b == 0 or n == 0:
        return closew, best, has
    geo = contact_geometry(n)
    with torch.cuda.device(x.device):
        err = _library().pairwise_contacts_launch(
            x.data_ptr(), y.data_ptr(), zw.data_ptr(), elig.data_ptr(),
            prevw.data_ptr(), closew.data_ptr(), best.data_ptr(),
            has.data_ptr(), b, n, nw, r_tx2, geo.chunk, geo.smem,
            torch.cuda.current_stream(x.device).cuda_stream,
        )
    if err != 0:
        raise RuntimeError(f"pairwise_contacts launch failed: CUDA error {err}")
    pairwise_contacts.launches += 1
    return closew, best, has


#: Kernel launches since the last reset (the plain version never counts).
pairwise_contacts.launches = 0


# ---------------------------------------------------------------- cell lists
#
# The padded-grid layout (a border ring of empty cells one wide, the
# interior row-major with stride ncy + 2) is defined once here, as in
# ``repro``; ``repro_torch.sim.cells`` and the kernel derive their indexing
# from these helpers.

#: Cells in the 3×3 neighbourhood of a cell.
NEIGHBORHOOD = 9


def padded_cell_id(cx, cy, ncy: int):
    """Flattened padded-grid id of interior cell ``(cx, cy)``."""
    return (cx + 1) * (ncy + 2) + (cy + 1)


def cell_neighborhood_offsets(ncy: int, device=None) -> torch.Tensor:
    """The 3×3 neighbourhood as ``(9,)`` int64 flattened padded-grid
    offsets, made on ``device`` (no copy from the host, so a CUDA graph
    can capture it)."""
    d = torch.arange(-1, 2, dtype=torch.int64, device=device)
    return (d[:, None] * (ncy + 2) + d[None, :]).reshape(-1)


def interior_cell_ids(ncx: int, ncy: int, device=None) -> torch.Tensor:
    """``(ncx * ncy,)`` int64 padded-grid ids of the interior cells,
    row-major."""
    cxy = torch.arange(ncx * ncy, dtype=torch.int64, device=device)
    return padded_cell_id(cxy // ncy, cxy % ncy, ncy)


def cell_close_words_ref(xc, yc, zc, idc, ncx: int, ncy: int, r_tx2):
    """Plain PyTorch version of the cell kernel.

    The planes are ``(B, n_pad_cells, cap)``: x and y (float32), the zone
    word (int32 bits) and the node id (int32, -1 empty). Returns
    ``(B, ncx * ncy, cap, ceil(9 cap / 32))`` int32 words: bit ``c`` of row
    slot ``i`` of an interior cell is candidate ``c`` of its 3×3
    neighbourhood (cell ``c // cap`` in :func:`cell_neighborhood_offsets`
    order, slot ``c % cap``) with ``d² <= r_tx² and (z_i & z_c) != 0 and
    id_i != id_c and id_c >= 0``; d² is ``fma(dx, dx, dy*dy)`` with ``dx``
    the row's x minus the candidate's.

    A row slot whose zone word is 0 shares no zone with any candidate, so
    its words are 0; only the other rows are computed (``torch.nonzero``,
    which waits for the device)."""
    from repro_torch.sim.compute import pack_mask

    b, _, cap = xc.shape
    ncand = NEIGHBORHOOD * cap
    pids = interior_cell_ids(ncx, ncy, xc.device)
    nbrp = pids[:, None] + cell_neighborhood_offsets(ncy, xc.device)  # (C, 9)
    bi, ci, si = torch.nonzero(zc[:, pids] != 0, as_tuple=True)
    row = (bi, pids[ci], si)                                       # (R,)
    cand = (bi[:, None, None], nbrp[ci][..., None],
            torch.arange(cap, device=xc.device))                  # (R, 9, cap)

    def rows(plane):
        return plane[row][:, None]                                 # (R, 1)

    def cands(plane):
        return plane[cand].reshape(-1, ncand)                      # (R, 9 cap)

    dx = rows(xc) - cands(xc)
    dy = rows(yc) - cands(yc)
    d2 = fma32(dx, dx, dy * dy)
    ij = cands(idc)
    close = ((d2 <= r_tx2) & ((rows(zc) & cands(zc)) != 0)
             & (rows(idc) != ij) & (ij >= 0))
    out = torch.zeros((b, ncx * ncy, cap, (ncand + 31) // 32),
                      dtype=torch.int32, device=xc.device)
    out[bi, ci, si] = pack_mask(close)
    return out


def build_cell_library() -> Path:
    """Compile ``csrc/cells.cu`` for sm_90a unless a build of this exact
    source exists; returns the shared library's path."""
    return _build.build_library(CELL_SOURCE, "cells")


@functools.lru_cache(maxsize=None)
def _cell_library():
    lib = ctypes.CDLL(str(build_cell_library()))
    fn = lib.cell_close_words_launch
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 5 + [
        ctypes.c_float, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return lib


def _check_cell_inputs(xc, yc, zc, idc, ncx: int, ncy: int):
    if xc.dim() != 3:
        raise ValueError(f"xc: want (B, n_pad_cells, cap), got {tuple(xc.shape)}")
    b, n_pad, cap = xc.shape
    if n_pad != (ncx + 2) * (ncy + 2) or ncx < 1 or ncy < 1 or cap < 1:
        raise ValueError(f"planes of {n_pad} cells x {cap} slots do not fit "
                         f"a padded {ncx} x {ncy} grid")
    want = ((xc, torch.float32), (yc, torch.float32), (zc, torch.int32),
            (idc, torch.int32))
    for name, (t, dtype) in zip(("xc", "yc", "zc", "idc"), want):
        if t.device != xc.device:
            raise ValueError(f"{name} is on {t.device}, xc on {xc.device}")
        if tuple(t.shape) != (b, n_pad, cap) or t.dtype != dtype:
            raise ValueError(f"{name}: want {(b, n_pad, cap)} {dtype}, got "
                             f"{tuple(t.shape)} {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    return b, cap, (NEIGHBORHOOD * cap + 31) // 32


def cell_close_words(xc, yc, zc, idc, ncx: int, ncy: int, r_tx2):
    """The 3×3-cell close pass: the CUDA kernel on a CUDA tensor, the plain
    version (:func:`cell_close_words_ref`) on a CPU tensor. The kernel's
    input contract (shapes, dtypes, contiguous planes) is checked on both."""
    b, cap, nwords = _check_cell_inputs(xc, yc, zc, idc, ncx, ncy)
    if xc.device.type == "cpu":
        return cell_close_words_ref(xc, yc, zc, idc, ncx, ncy, r_tx2)
    if xc.device.type != "cuda":
        raise ValueError(f"cell_close_words: unsupported device {xc.device}")
    _build.check_hopper(xc.device, "cell_close_words")
    out = torch.empty((b, ncx * ncy, cap, nwords), dtype=torch.int32,
                      device=xc.device)
    with torch.cuda.device(xc.device):
        err = _cell_library().cell_close_words_launch(
            xc.data_ptr(), yc.data_ptr(), zc.data_ptr(), idc.data_ptr(),
            out.data_ptr(), b, ncx, ncy, cap, nwords, r_tx2,
            torch.cuda.current_stream(xc.device).cuda_stream,
        )
    if err != 0:
        raise RuntimeError(f"cell_close_words launch failed: CUDA error {err}")
    cell_close_words.launches += 1
    return out


#: Kernel launches since the last reset (the plain version never counts).
cell_close_words.launches = 0
