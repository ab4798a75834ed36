"""Flash attention: hand-written CUDA kernels for Hopper and their plain
PyTorch version.

Replaces the TPU Pallas kernel of ``repro/kernels/flash_attention.py``
(body ``_kernel``, wrapper ``flash_attention``, ``pallas_call``), which
``repro``'s ``kernels/ops.attention_op`` calls after repeating the KV
heads. Over q ``(B, Sq, H, D)`` and k, v ``(B, Skv, Hkv, D)`` of float32
or bfloat16, ``H`` a multiple of ``Hkv`` (query head ``h`` reads KV head
``h // G``, ``G = H // Hkv``), it computes softmax attention with:

* scores ``(float(q) * scale) · float(k)``, ``scale = float32(D ** -0.5)``;
* q right-aligned: query ``i`` sits at position ``i + Skv - Sq``;
* ``causal``: a key at a later position is masked; ``window``: a key
  ``window`` or more positions back is masked (strict);
* masked scores ``-1e30``, the softmax in float32, the output divided by
  ``max(l, 1e-30)`` and cast to the input dtype.

Every query row must see a key: ``causal`` with ``Sq > Skv`` raises.

Dispatch: a CPU tensor gets the plain version; a CUDA tensor gets a
kernel (source ``csrc/flash_attention.cu``, built by nvcc for ``sm_90a``
on first use into ``build/repro_torch/`` and loaded with ``ctypes``) or an
error. Nothing falls back. The inputs are checked on either device. The
kernels read q, k and v through their strides (the last dim contiguous),
so a view of a KV cache needs no copy.

Three forms of the kernel, chosen by :func:`_form` from the shape and
dtype alone (never by a failure), each replacing the same TPU kernel:

* ``"mma"`` (``flash_mma_kernel``), bfloat16 with ``Sq > 1``: the
  prefill, bound by operations on the H100 (h2o-danube-3-4b's 8192-token
  prefill: 3.87e11, 0.391 ms at the bf16 tensor-core peak). Both products
  on the tensor cores (``wgmma``, float32 accumulators), 128 query rows a
  block (the G heads of a position together), K/V tiles of 64 keys in a
  2-stage ``cp.async`` ring, only the tiles of the causal and window band
  visited. The probabilities are rounded to bfloat16 before ``P·V``, the
  one rounding the TPU kernel does not do.
* ``"decode"`` (``flash_decode_kernel``), float32 or bfloat16 with ``Sq ==
  1``: bound by bytes (8 requests over 128 cached slots: 4.06 MB, 1.21 µs
  at 3.35 TB/s). A block per (batch, KV head); its 8 warps take
  contiguous slices of the keys and a log-sum-exp merge in shared memory
  ends the launch.
* ``"simt"`` (``flash_kernel``), float32 with ``Sq > 1``: float32 on the
  CUDA cores (the float32 tolerance leaves no room for TF32).

``flash_attention.launches`` counts launches, ``flash_attention.forms``
launches by form; the plain version counts nothing. The source's note
gives each form's design.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from repro_torch.kernels import build as _build

__all__ = ["flash_attention", "flash_attention_ref", "build_library",
           "SOURCE", "NEG_INF", "FORMS"]

SOURCE = _build.CSRC / "flash_attention.cu"
#: The input dtypes and their codes in the library.
DTYPES = {torch.float32: 0, torch.bfloat16: 1}
#: The kernel's forms and their codes in the library.
FORMS = {"simt": 0, "mma": 1, "decode": 2}
#: Query rows (G heads x positions) one block of the simt form holds; the
#: mma form holds twice as many.
BLOCK_ROWS = 64
MMA_ROWS = 128
MAX_HEAD_DIM = 128
NEG_INF = -1e30


def _scale(d: int) -> float:
    """``D ** -0.5`` rounded to float32, as JAX rounds the Python number."""
    return float(np.float32(d ** -0.5))


def flash_attention_ref(q, k, v, *, causal: bool = True,
                        window: int | None = None, block: int = 1024):
    """Plain version, on the kernel's layout: the KV heads repeated, the
    masked scores in float32 and a softmax over whole rows, ``block``
    query rows at a time (rows are independent; the block bounds the
    score tensor's memory)."""
    _check(q, k, v, causal, window)
    B, Sq, H, D = q.shape
    Skv, Hkv = k.shape[1], k.shape[2]
    G = H // Hkv
    kr = k.repeat_interleave(G, dim=2).float()
    vr = v.repeat_interleave(G, dim=2).float()
    k_pos = torch.arange(Skv, device=q.device)
    out = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    for s0 in range(0, Sq, block):
        s1 = min(Sq, s0 + block)
        q32 = q[:, s0:s1].float() * _scale(D)
        s = torch.einsum("bqhd,bkhd->bhqk", q32, kr)
        q_pos = torch.arange(s0, s1, device=q.device) + (Skv - Sq)
        mask = torch.ones((s1 - s0, Skv), dtype=torch.bool, device=q.device)
        if causal:
            mask &= q_pos[:, None] >= k_pos[None, :]
        if window is not None:
            mask &= q_pos[:, None] - k_pos[None, :] < window
        s = torch.where(mask, s, NEG_INF)
        p = torch.exp(s - s.amax(dim=-1, keepdim=True))
        l = p.sum(dim=-1, keepdim=True).clamp_min(1e-30)
        o = torch.einsum("bhqk,bkhd->bqhd", p, vr)
        out[:, s0:s1] = (o / l.permute(0, 2, 1, 3)).to(q.dtype)
    return out


def _check(q, k, v, causal: bool, window) -> None:
    """The kernel's input contract, on either device."""
    for key, t in (("q", q), ("k", k), ("v", v)):
        if not torch.is_tensor(t) or t.dim() != 4:
            raise ValueError(f"flash_attention: {key} must be a 4-d tensor")
        if t.dtype not in DTYPES:
            raise ValueError(f"flash_attention: {key} must be float32 or "
                             f"bfloat16, got {t.dtype}")
        if t.dtype != q.dtype or t.device != q.device:
            raise ValueError(f"flash_attention: {key} is {t.dtype} on "
                             f"{t.device}, q {q.dtype} on {q.device}")
        if t.shape[-1] > 1 and t.stride(-1) != 1:
            raise ValueError(f"flash_attention: {key}'s last dim must be "
                             f"contiguous")
    B, Sq, H, D = q.shape
    if tuple(k.shape) != tuple(v.shape) or k.shape[0] != B or k.shape[3] != D:
        raise ValueError(f"flash_attention: k {tuple(k.shape)} and v "
                         f"{tuple(v.shape)} do not fit q {tuple(q.shape)}")
    Skv, Hkv = k.shape[1], k.shape[2]
    if Hkv < 1 or H % Hkv != 0 or H // Hkv > BLOCK_ROWS:
        raise ValueError(f"flash_attention: {H} query heads over {Hkv} KV "
                         f"heads (G must be a whole number <= {BLOCK_ROWS})")
    if not 1 <= D <= MAX_HEAD_DIM:
        raise ValueError(f"flash_attention: head dim {D} not in "
                         f"[1, {MAX_HEAD_DIM}]")
    if Skv < 1:
        raise ValueError("flash_attention: no keys")
    if causal and Sq > Skv:
        raise ValueError(f"flash_attention: causal with Sq={Sq} > Skv={Skv} "
                         f"leaves query rows without a key")
    if window is not None and window < 1:
        raise ValueError(f"flash_attention: window {window} < 1")


def build_library():
    """Compile ``csrc/flash_attention.cu`` for sm_90a unless a build of this
    exact source exists; returns the shared library's path."""
    return _build.build_library(SOURCE, "flash_attention")


@functools.lru_cache(maxsize=None)
def _library():
    lib = ctypes.CDLL(str(build_library()))
    ptr, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.flash_attention_launch.argtypes = (
        [ptr] * 4 + [i32] * 9 + [i64] * 9 + [i32] * 3 + [ctypes.c_float, ptr])
    lib.flash_attention_launch.restype = ctypes.c_int
    return lib


def _form(q) -> str:
    """The kernel form a call on the card gets, from q's shape and dtype
    alone (k and v share q's dtype; their layout picks 16-byte or single
    loads inside a form, never the form): ``"decode"`` for one query
    position, else ``"mma"`` in bfloat16 (the tensor cores) and ``"simt"``
    in float32."""
    if q.shape[1] == 1:
        return "decode"
    return "mma" if q.dtype == torch.bfloat16 else "simt"


def flash_attention(q, k, v, *, causal: bool = True,
                    window: int | None = None):
    """Attention over q ``(B, Sq, H, D)`` and k, v ``(B, Skv, Hkv, D)``:
    the CUDA kernel of :func:`_form`'s form on a CUDA tensor, the plain
    version on a CPU tensor. Returns ``(B, Sq, H, D)`` in q's dtype,
    contiguous."""
    _check(q, k, v, causal, window)
    if q.device.type == "cpu":
        return flash_attention_ref(q, k, v, causal=causal, window=window)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention: unsupported device {q.device}")
    _build.check_hopper(q.device, "flash_attention")
    B, Sq, H, D = q.shape
    Skv, Hkv = k.shape[1], k.shape[2]
    out = torch.empty((B, Sq, H, D), dtype=q.dtype, device=q.device)
    if out.numel() == 0:
        return out
    form = _form(q)
    rows = MMA_ROWS if form == "mma" else BLOCK_ROWS
    bq = max(1, rows // (H // Hkv))
    n = 16 // q.element_size()             # values in 16 bytes
    vec = D % n == 0 and all(t.data_ptr() % 16 == 0 and all(
        st % n == 0 for st in t.stride()[:3]) for t in (q, k, v))
    with torch.cuda.device(q.device):
        err = _library().flash_attention_launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            FORMS[form], DTYPES[q.dtype], B, Sq, Skv, H, Hkv, D, bq,
            *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
            int(bool(causal)), 0 if window is None else int(window),
            int(vec), _scale(D),
            torch.cuda.current_stream(q.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"flash_attention launch failed: CUDA error {err}")
    flash_attention.launches += 1
    flash_attention.forms[form] = flash_attention.forms.get(form, 0) + 1
    return out


#: Kernel launches since the last reset (the plain version never counts),
#: in all and by form (only the forms launched have a key).
flash_attention.launches = 0
flash_attention.forms = {}
