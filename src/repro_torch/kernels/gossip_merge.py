"""Gossip merges: hand-written CUDA kernels for Hopper and their plain
PyTorch versions.

Replace the TPU Pallas kernels of ``repro/kernels/gossip_merge.py``:
``gossip_merge`` (body ``_kernel``, wrapper ``_merge_pallas``), and the
row-wise ``gossip_merge_rows`` (body ``_rows_kernel``) and
``gossip_merge_rows_scaled`` (body ``_rows_scaled_kernel``).

* ``gossip_merge``: over ``own`` and ``peer`` of one shape, float32 or
  bfloat16, with one float32 ``w`` and one bool ``success``:
  ``success ? w*own + (1-w)*peer : own``, computed in float32 and rounded
  once (to nearest even) to the leaves' dtype. The gossip round
  (:mod:`repro_torch.core.gossip`) merges every replica through it, leaf
  by leaf (or the round's segment of each leaf).

Over ``own`` and ``peer`` ``(..., D)`` float32 with per-row ``w``
(float32), ``s`` (bool) and, scaled, ``scale`` (float32), all ``(...)``:

* ``gossip_merge_rows``:        ``s ? w*own + (1-w)*peer : own``;
* ``gossip_merge_rows_scaled``: ``s ? w*own + (1-w)*(scale*peer) : own``.

Each is one multiply-add in the operand order that ``repro``'s jitted
callers contract the merge into: ``fma(1-w, peer, w*own)`` (inside the
jitted gossip round, for whole float32 and bfloat16 leaves, and inside the
simulator), and for the scaled merge the same with the rounded
``scale*peer`` as the peer (the other order rounds differently on about a
third of the inputs). XLA's choice depends on what it fuses the merge
with: inside the jitted round, float32 leaves of one element and the
segmented round's float32 segments contract ``fma(w, own, (1-w)*peer)``,
which ``gossip_merge`` takes with ``own_first=True``; the scaled reference
jitted on its own contracts
``fma(w, own, (1-w)*(scale*peer))`` instead, and with the uniform policy's
constant ``w = 0.5`` the simulator folds the weight into the scale,
``fma((1-w)*scale, peer, w*own)``; the scaled merge takes that order with
``fold=True``. ``repro``'s ``gossip_merge`` called eagerly, outside
``jit``, rounds the two products apart; the port follows the jitted round.
The kernels write ``__fmaf_rn`` in these orders; the plain versions
emulate the FMA in float64 (:func:`repro_torch.numerics.fma32`). An
unselected element is ``own`` bit for bit, whatever ``peer`` holds.

Dispatch: a CPU tensor gets the plain version; a CUDA tensor gets the
kernel (source ``csrc/gossip_merge.cu``, built by nvcc for ``sm_90a`` on
first use into ``build/repro_torch/`` and loaded with ``ctypes``) or an
error. Nothing falls back. ``gossip_merge`` checks its inputs on either
device.

Bound on the H100: bytes. ``gossip_merge`` reads ``own`` and writes the
output, and reads ``peer`` only on ``success``: 3 or 2 accesses an element
(6 or 4 bytes in bfloat16). The row merges read ``own`` and write the
output in full, ``s`` on every row; ``peer``, ``w`` and ``scale`` are
needed only on the k selected rows: ``8·R·D + 4·k·D + R + 4·k`` bytes
(``+ 4·k`` scaled). At the simulator's R = 200 rows of D = 34 that is at
most some 25 ns at 3.35 TB/s, far below the card's floor for a launch, so
the row merges are built for that floor: ``gossip_merge_rows`` issues its
four loads (own, peer, w, s) together and selects with ``s`` (so it also
reads the unselected rows' peer, and drops what it computes from them),
with a 32-bit index below 2^31 elements; ``gossip_merge_rows_scaled``
still loads ``s`` first and the rest only on a selected row.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import build as _build
from repro_torch.numerics import fma32

__all__ = ["gossip_merge", "gossip_merge_ref", "gossip_merge_rows",
           "gossip_merge_rows_scaled", "gossip_merge_rows_ref",
           "gossip_merge_rows_scaled_ref", "build_library", "SOURCE"]

SOURCE = _build.CSRC / "gossip_merge.cu"
#: The leaf dtypes of ``gossip_merge`` and their codes in the library.
FLAT_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def gossip_merge_ref(own, peer, w_own, success, own_first=False):
    """Plain version: ``where(success, fma(1-w, peer, w*own), own)`` in
    float32, or with ``own_first`` ``where(success, fma(w, own,
    (1-w)*peer), own)``, the merged value rounded once to ``own``'s
    dtype."""
    o, p, w_peer = own.float(), peer.float(), 1.0 - w_own
    merged = (fma32(w_own, o, w_peer * p) if own_first
              else fma32(w_peer, p, w_own * o))
    return torch.where(success, merged.to(own.dtype), own)


def gossip_merge_rows_ref(own, peer, w, s):
    """Plain version: ``where(s, fma(1-w, peer, w*own), own)`` per row."""
    w = w[..., None]
    merged = fma32(1.0 - w, peer, w * own)
    return torch.where(s[..., None], merged, own)


def gossip_merge_rows_scaled_ref(own, peer, w, scale, s, fold=False):
    """Plain version: ``where(s, fma(1-w, scale*peer, w*own), own)``, or
    with ``fold`` ``where(s, fma((1-w)*scale, peer, w*own), own)``."""
    if not fold:
        return gossip_merge_rows_ref(own, scale[..., None] * peer, w, s)
    w, scale = w[..., None], scale[..., None]
    merged = fma32((1.0 - w) * scale, peer, w * own)
    return torch.where(s[..., None], merged, own)


def build_library():
    """Compile ``csrc/gossip_merge.cu`` for sm_90a unless a build of this
    exact source exists; returns the shared library's path."""
    return _build.build_library(SOURCE, "gossip_merge")


@functools.lru_cache(maxsize=None)
def _library():
    lib = ctypes.CDLL(str(build_library()))
    ptr, i64, i32 = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
    lib.gossip_merge_rows_launch.argtypes = [ptr] * 5 + [i64, i32, ptr]
    lib.gossip_merge_rows_scaled_launch.argtypes = [ptr] * 6 + [i64, i32,
                                                                i32, ptr]
    lib.gossip_merge_launch.argtypes = [ptr] * 5 + [i64, i32, i32, i32, ptr]
    lib.gossip_merge_rows_launch.restype = ctypes.c_int
    lib.gossip_merge_launch.restype = ctypes.c_int
    lib.gossip_merge_rows_scaled_launch.restype = ctypes.c_int
    return lib


def _check(name: str, own, peer, rows_f32, s):
    lead, d = tuple(own.shape[:-1]), own.shape[-1]
    want = [("own", own, (*lead, d), torch.float32),
            ("peer", peer, (*lead, d), torch.float32),
            ("s", s, lead, torch.bool)]
    want += [(k, t, lead, torch.float32) for k, t in rows_f32]
    for key, t, shape, dtype in want:
        if t.device != own.device:
            raise ValueError(f"{name}: {key} is on {t.device}, own on "
                             f"{own.device}")
        if tuple(t.shape) != shape or t.dtype != dtype:
            raise ValueError(f"{name}: {key} wants {shape} {dtype}, got "
                             f"{tuple(t.shape)} {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: {key} must be contiguous")
    _build.check_hopper(own.device, name)
    return own.numel() // max(d, 1), d


def _launch(name: str, own, inputs, rows: int, d: int, *flags) -> torch.Tensor:
    out = torch.empty_like(own)
    with torch.cuda.device(own.device):
        err = getattr(_library(), f"{name}_launch")(
            own.data_ptr(), *(t.data_ptr() for t in inputs),
            out.data_ptr(), rows, d, *flags,
            torch.cuda.current_stream(own.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"{name} launch failed: CUDA error {err}")
    return out


def _check_flat(own, peer, w_own, success, out):
    """``gossip_merge``'s input contract, on either device."""
    if own.dtype not in FLAT_DTYPES:
        raise ValueError(f"gossip_merge: leaves must be float32 or bfloat16, "
                         f"got {own.dtype}")
    want = [("peer", peer, tuple(own.shape), own.dtype),
            ("w_own", w_own, (), torch.float32),
            ("success", success, (), torch.bool)]
    if out is not None:
        want.append(("out", out, tuple(own.shape), own.dtype))
    for key, t, shape, dtype in want:
        if not torch.is_tensor(t):
            raise ValueError(f"gossip_merge: {key} must be a tensor")
        if t.device != own.device:
            raise ValueError(f"gossip_merge: {key} is on {t.device}, own on "
                             f"{own.device}")
        if tuple(t.shape) != shape or t.dtype != dtype:
            raise ValueError(f"gossip_merge: {key} wants {shape} {dtype}, "
                             f"got {tuple(t.shape)} {t.dtype}")
    for key, t in (("own", own), ("peer", peer), ("out", out)):
        if t is not None and not t.is_contiguous():
            raise ValueError(f"gossip_merge: {key} must be contiguous")


def gossip_merge(own, peer, w_own, success, out=None, own_first=False):
    """``success ? w_own*own + (1-w_own)*peer : own`` over a whole leaf,
    computed in float32 as ``fma(1-w, peer, w*own)``, or with ``own_first``
    as ``fma(w, own, (1-w)*peer)``: the CUDA kernel on a CUDA tensor, the
    plain version on a CPU tensor. ``own``, ``peer``: one shape, float32 or
    bfloat16, contiguous; ``w_own`` (float32) and ``success`` (bool):
    0-d tensors on ``own``'s device, read there (no value waits for the
    host). ``out``, when given, is a contiguous tensor like ``own`` (a view
    of a larger buffer, say) that receives the result; it must not overlap
    ``peer``. Returns the result; an empty leaf launches nothing."""
    _check_flat(own, peer, w_own, success, out)
    if own.device.type == "cpu":
        merged = gossip_merge_ref(own, peer, w_own, success, own_first)
        return merged if out is None else out.copy_(merged)
    if own.device.type != "cuda":
        raise ValueError(f"gossip_merge: unsupported device {own.device}")
    _build.check_hopper(own.device, "gossip_merge")
    out = torch.empty_like(own) if out is None else out
    if own.numel() == 0:
        return out
    vec = all(t.data_ptr() % 16 == 0 for t in (own, peer, out))
    with torch.cuda.device(own.device):
        err = _library().gossip_merge_launch(
            own.data_ptr(), peer.data_ptr(), w_own.data_ptr(),
            success.data_ptr(), out.data_ptr(), own.numel(),
            FLAT_DTYPES[own.dtype], int(vec), int(bool(own_first)),
            torch.cuda.current_stream(own.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"gossip_merge launch failed: CUDA error {err}")
    gossip_merge.launches += 1
    return out


def gossip_merge_rows(own, peer, w, s):
    """``s ? w*own + (1-w)*peer : own`` per row: the CUDA kernel on a CUDA
    tensor, the plain version on a CPU tensor. ``own``, ``peer``: ``(...,
    D)`` float32; ``w`` ``(...)`` float32; ``s`` ``(...)`` bool."""
    if own.device.type == "cpu":
        return gossip_merge_rows_ref(own, peer, w, s)
    if own.device.type != "cuda":
        raise ValueError(f"gossip_merge_rows: unsupported device {own.device}")
    rows, d = _check("gossip_merge_rows", own, peer, [("w", w)], s)
    out = _launch("gossip_merge_rows", own, (peer, w, s), rows, d)
    gossip_merge_rows.launches += 1
    return out


def gossip_merge_rows_scaled(own, peer, w, scale, s, fold=False):
    """``s ? w*own + (1-w)*(scale*peer) : own`` per row (the norm-clipped
    merge): the CUDA kernel on a CUDA tensor, the plain version on a CPU
    tensor. Shapes as :func:`gossip_merge_rows`, ``scale`` like ``w``.
    ``fold`` contracts ``(1-w)*scale`` into one factor, the simulator's
    order under a constant weight (the uniform policy)."""
    if own.device.type == "cpu":
        return gossip_merge_rows_scaled_ref(own, peer, w, scale, s, fold)
    if own.device.type != "cuda":
        raise ValueError(
            f"gossip_merge_rows_scaled: unsupported device {own.device}")
    rows, d = _check("gossip_merge_rows_scaled", own, peer,
                     [("w", w), ("scale", scale)], s)
    out = _launch("gossip_merge_rows_scaled", own, (peer, w, scale, s), rows,
                  d, int(bool(fold)))
    gossip_merge_rows_scaled.launches += 1
    return out


#: Kernel launches since the last reset (the plain versions never count).
gossip_merge.launches = 0
gossip_merge_rows.launches = 0
gossip_merge_rows_scaled.launches = 0
