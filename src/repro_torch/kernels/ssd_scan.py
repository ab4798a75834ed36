"""The Mamba-2 SSD chunked scan: a hand-written CUDA kernel for Hopper and
its plain PyTorch version.

Replaces the TPU Pallas kernel of ``repro/kernels/ssd_scan.py`` (body
``_kernel``, wrapper ``ssd_scan``), which ``repro``'s ``kernels/ops.ssd_op``
calls. Over x ``(B, S, H, P)`` and B_, C_ ``(B, S, G, N)`` of float32 or
bfloat16, dt ``(B, S, H)`` and A, D ``(H,)`` of float32, head ``h``
reading group ``h // (H // G)`` of B_ and C_, it computes for every chunk
of ``Q = min(chunk, S)`` tokens, in float32, with the state ``St (N, P)``
carried from chunk to chunk (zero at the start):

* ``csum = cumsum(dt * A)`` over the chunk;
* ``y = ((C Bᵀ) ∘ L)(dt·x) + exp(-csum) ∘ (C St) + D·x`` with ``L_ij =
  exp(-(csum_i - csum_j))`` for ``i >= j`` and 0 above the diagonal
  (masked before the exp, as ``repro`` does);
* ``St ← exp(-csum_Q)·St + (exp(-(csum_Q - csum))·dt·B)ᵀ x``.

A is positive and the decay is ``exp(-csum)``, as ``repro``'s code has it.
y comes back in x's dtype; the final state ``(B, H, N, P)`` in float32 on
request. A last chunk shorter than Q is masked (the TPU wrapper pads it
with zeros, which come to the same).

Dispatch: a CPU tensor gets the plain version; a CUDA tensor gets the
kernel (source ``csrc/ssd_scan.cu``, built by nvcc for ``sm_90a`` on first
use into ``build/repro_torch/`` and loaded with ``ctypes``) or an error.
Nothing falls back. The inputs are checked on either device. The kernel
reads x, dt, B_ and C_ through their strides (the last dim of x, B_ and
C_ contiguous), so the slices of a Mamba layer's ``xBC`` buffer need no
copy: in 16-byte chunks where the pointers and strides allow, else one
value at a time.

Two forms of the kernel, chosen by :func:`_form` from x's dtype alone
(never by a failure), each replacing the same TPU kernel:

* ``"simt"`` (``ssd_kernel``), float32: float32 on the CUDA cores, one
  block per (batch, head, 16 of the P columns) walking the chunks in
  series, the chunk's C Bᵀ scores recomputed by each block of a head;
* ``"mma"``, bfloat16: three launches on the current stream. Pass 1 runs
  over (batch, chunk, 3 heads of a group) at once and writes each chunk's
  csum, ``exp(-csum_Q)`` and own state contribution ``(w∘B)ᵀ x`` (``w =
  exp(-(csum_Q - csum))·dt``, with ``w·x`` split into a bf16 high and low
  part, two tensor-core products) to float32 scratch; pass 2 turns the
  contributions, in float32, into the state entering each chunk (the
  scan's only serial part), writes that rounded to bf16 and the final
  state in float32; pass 3, again over all chunks at once (6 heads a
  block), computes C Bᵀ once a block on the tensor cores and, for each
  head, ``y = scores·x + exp(-csum)∘(C·St_in) + D·x`` with the masked,
  decayed scores and ``St_in`` each rounded once to bf16 (the TPU's MXU
  rounds its operands so at default precision) and y once. The scratch,
  allocated here with ``torch.empty``, is ``(B, H, chunks, N, P rounded
  up to 64)`` in float32 and again in bf16, 75.5 MB at mamba2-130m's
  prefill, and the csum ``(B, H, chunks, 128)``.

``ssd_scan.launches`` counts calls that launched (the mma form's three
passes count once), ``ssd_scan.forms`` the same by form; the plain
version counts nothing.

Bound on the H100 at mamba2-130m's prefill: the bytes, by a hair over the
operations at the bf16 tensor-core peak (the source's note gives both).
The simt form runs on the CUDA cores far above it; the mma form's floor
is its scratch's round trip through device memory (the source's note).
"""

from __future__ import annotations

import ctypes
import functools

import torch
import torch.nn.functional as F

from repro_torch.kernels import build as _build

__all__ = ["ssd_scan", "ssd_scan_ref", "build_library", "SOURCE"]

SOURCE = _build.CSRC / "ssd_scan.cu"
#: The dtypes of x, B_ and C_, and their codes in the library.
DTYPES = {torch.float32: 0, torch.bfloat16: 1}
#: The kernel's forms, by the dtype of x, B_ and C_.
FORMS = {torch.float32: "simt", torch.bfloat16: "mma"}
#: The kernel's limits on the chunk and the state size.
MAX_CHUNK = 128
MAX_STATE = 128
#: P columns a tile of the mma form: its scratch pads P up to a multiple.
MMA_COLUMNS = 64


def _check(x, dt, A, B_, C_, D, chunk: int) -> None:
    """The kernel's input contract, on either device."""
    for key, t, dims in (("x", x, 4), ("dt", dt, 3), ("A", A, 1),
                         ("B_", B_, 4), ("C_", C_, 4), ("D", D, 1)):
        if not torch.is_tensor(t) or t.dim() != dims:
            raise ValueError(f"ssd_scan: {key} must be a {dims}-d tensor")
        if t.device != x.device:
            raise ValueError(f"ssd_scan: {key} is on {t.device}, x on "
                             f"{x.device}")
    if x.dtype not in DTYPES:
        raise ValueError(f"ssd_scan: x must be float32 or bfloat16, got "
                         f"{x.dtype}")
    for key, t in (("B_", B_), ("C_", C_)):
        if t.dtype != x.dtype:
            raise ValueError(f"ssd_scan: {key} is {t.dtype}, x {x.dtype}")
    for key, t in (("dt", dt), ("A", A), ("D", D)):
        if t.dtype != torch.float32:
            raise ValueError(f"ssd_scan: {key} must be float32, got "
                             f"{t.dtype}")
    for key, t in (("x", x), ("B_", B_), ("C_", C_)):
        if t.shape[-1] > 1 and t.stride(-1) != 1:
            raise ValueError(f"ssd_scan: {key}'s last dim must be "
                             f"contiguous")
    Bb, S, H, P = x.shape
    G, N = B_.shape[2], B_.shape[3]
    if tuple(B_.shape) != tuple(C_.shape) or B_.shape[:2] != x.shape[:2]:
        raise ValueError(f"ssd_scan: B_ {tuple(B_.shape)} and C_ "
                         f"{tuple(C_.shape)} do not fit x {tuple(x.shape)}")
    if tuple(dt.shape) != (Bb, S, H) or tuple(A.shape) != (H,) or tuple(
            D.shape) != (H,):
        raise ValueError(f"ssd_scan: dt {tuple(dt.shape)}, A "
                         f"{tuple(A.shape)}, D {tuple(D.shape)} do not fit "
                         f"x {tuple(x.shape)}")
    if G < 1 or H % G != 0:
        raise ValueError(f"ssd_scan: {H} heads over {G} groups")
    if min(Bb, S, P, N) < 1:
        raise ValueError(f"ssd_scan: empty input x {tuple(x.shape)}, "
                         f"B_ {tuple(B_.shape)}")
    if N > MAX_STATE:
        raise ValueError(f"ssd_scan: state size {N} > {MAX_STATE}")
    if not 1 <= min(chunk, S) <= MAX_CHUNK:
        raise ValueError(f"ssd_scan: chunk min({chunk}, {S}) not in "
                         f"[1, {MAX_CHUNK}]")


def ssd_scan_ref(x, dt, A, B_, C_, D, chunk: int = 128):
    """Plain version: ``repro``'s ``models/mamba._ssd_chunked`` in torch,
    the per-chunk math in float32 over zero-padded chunks. Returns ``(y,
    final_state)``: y ``(B, S, H, P)`` in float32 (the kernel rounds it to
    x's dtype), the state ``(B, H, N, P)`` float32."""
    _check(x, dt, A, B_, C_, D, chunk)
    Bb, S, H, P = x.shape
    G, N = B_.shape[2], B_.shape[3]
    Q = min(chunk, S)
    n_chunks = -(-S // Q)
    pad = n_chunks * Q - S
    if pad:
        x = F.pad(x, (0, 0, 0, 0, 0, pad))
        dt = F.pad(dt, (0, 0, 0, pad))
        B_ = F.pad(B_, (0, 0, 0, 0, 0, pad))
        C_ = F.pad(C_, (0, 0, 0, 0, 0, pad))
    rep = H // G
    xc = x.reshape(Bb, n_chunks, Q, H, P).float()
    dtc = dt.reshape(Bb, n_chunks, Q, H).float()
    Bh = B_.reshape(Bb, n_chunks, Q, G, N).float().repeat_interleave(rep, 3)
    Ch = C_.reshape(Bb, n_chunks, Q, G, N).float().repeat_interleave(rep, 3)
    mask = torch.tril(torch.ones((Q, Q), dtype=torch.bool,
                                 device=x.device))[None, :, :, None]
    st = torch.zeros((Bb, H, N, P), dtype=torch.float32, device=x.device)
    ys = []
    for c in range(n_chunks):
        x_c, dt_c, B_c, C_c = xc[:, c], dtc[:, c], Bh[:, c], Ch[:, c]
        csum = torch.cumsum(dt_c * A, dim=1)                   # (B, Q, H)
        Lmat = csum[:, :, None, :] - csum[:, None, :, :]       # (B, Q, Q, H)
        Ldecay = torch.where(mask, torch.exp(-torch.where(mask, Lmat, 80.0)),
                             0.0)
        scores = torch.einsum("bqhn,bkhn->bqkh", C_c, B_c)
        y = torch.einsum("bqkh,bkh,bkhp->bqhp", scores * Ldecay, dt_c, x_c)
        y = y + torch.einsum("bqhn,bhnp,bqh->bqhp", C_c, st,
                             torch.exp(-csum))
        dec_end = torch.exp(-(csum[:, -1:, :] - csum))         # (B, Q, H)
        st_new = torch.einsum("bqh,bqh,bqhn,bqhp->bhnp", dec_end, dt_c, B_c,
                              x_c)
        st = st_new + torch.exp(-csum[:, -1, :])[:, :, None, None] * st
        ys.append(y)
    y = torch.stack(ys, dim=1) + D[None, None, None, :, None] * xc
    return y.reshape(Bb, n_chunks * Q, H, P)[:, :S], st


def build_library():
    """Compile ``csrc/ssd_scan.cu`` for sm_90a unless a build of this exact
    source exists; returns the shared library's path."""
    return _build.build_library(SOURCE, "ssd_scan")


@functools.lru_cache(maxsize=None)
def _library():
    lib = ctypes.CDLL(str(build_library()))
    ptr, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.ssd_scan_launch.argtypes = (
        [ptr] * 8 + [i32] * 8 + [i64] * 12 + [i32, ptr])
    lib.ssd_scan_launch.restype = ctypes.c_int
    lib.ssd_scan_mma_launch.argtypes = (
        [ptr] * 12 + [i32] * 7 + [i64] * 12 + [i32, ptr])
    lib.ssd_scan_mma_launch.restype = ctypes.c_int
    return lib


def _form(x) -> str:
    """The kernel form a call on the card gets, from x's dtype alone (its
    layout picks 16-byte or single loads inside a form, never the form):
    ``"simt"`` for float32, ``"mma"`` for bfloat16."""
    return FORMS[x.dtype]


def _launch(form: str, x, dt, A, B_, C_, D, chunk: int,
            return_state: bool):
    """Launches ``form`` of the kernel on CUDA inputs that passed
    :func:`_check`; returns ``(y, final state or None)``. The simt form
    takes either dtype (the wrapper gives it float32 only); the mma form
    bfloat16."""
    Bb, S, H, P = x.shape
    G, N = B_.shape[2], B_.shape[3]
    y = torch.empty((Bb, S, H, P), dtype=x.dtype, device=x.device)
    st = (torch.empty((Bb, H, N, P), dtype=torch.float32, device=x.device)
          if return_state else None)
    A, D = A.contiguous(), D.contiguous()
    n = 16 // x.element_size()             # values in 16 bytes
    vec = N % n == 0 and P % n == 0 and all(
        t.data_ptr() % 16 == 0 and all(sd % n == 0 for sd in t.stride()[:3])
        for t in (x, B_, C_))
    q = min(chunk, S)
    args = [x.data_ptr(), dt.data_ptr(), A.data_ptr(), B_.data_ptr(),
            C_.data_ptr(), D.data_ptr(), y.data_ptr(),
            None if st is None else st.data_ptr()]
    if form == "mma":
        if x.dtype != torch.bfloat16:
            raise ValueError(f"ssd_scan: the mma form takes bfloat16, not "
                             f"{x.dtype}")
        n_chunks = -(-S // q)
        pp = -(-P // MMA_COLUMNS) * MMA_COLUMNS
        ns = torch.empty((Bb, H, n_chunks, N, pp), dtype=torch.float32,
                         device=x.device)
        st_in = torch.empty((Bb, H, n_chunks, N, pp), dtype=torch.bfloat16,
                            device=x.device)
        decay = torch.empty((Bb, H, n_chunks), dtype=torch.float32,
                            device=x.device)
        cum = torch.empty((Bb, H, n_chunks, MAX_CHUNK), dtype=torch.float32,
                          device=x.device)
        args += [ns.data_ptr(), st_in.data_ptr(), decay.data_ptr(),
                 cum.data_ptr()]
    else:
        args.append(DTYPES[x.dtype])
    with torch.cuda.device(x.device):
        lib = _library()
        launch = (lib.ssd_scan_mma_launch if form == "mma"
                  else lib.ssd_scan_launch)
        err = launch(
            *args, Bb, S, H, G, N, P, q, *x.stride()[:3], *dt.stride(),
            *B_.stride()[:3], *C_.stride()[:3], int(vec),
            torch.cuda.current_stream(x.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"ssd_scan launch failed ({form} form): CUDA "
                           f"error {err}")
    return y, st


def ssd_scan(x, dt, A, B_, C_, D, *, chunk: int = 128,
             return_state: bool = False):
    """The SSD scan: the CUDA kernel on a CUDA tensor, in the form
    :func:`_form` gives, the plain version on a CPU tensor. Returns y
    ``(B, S, H, P)`` in x's dtype, contiguous, and with ``return_state``
    also the final state ``(B, H, N, P)`` float32."""
    _check(x, dt, A, B_, C_, D, chunk)
    if x.device.type == "cpu":
        y, st = ssd_scan_ref(x, dt, A, B_, C_, D, chunk)
        y = y.to(x.dtype)
        return (y, st) if return_state else y
    if x.device.type != "cuda":
        raise ValueError(f"ssd_scan: unsupported device {x.device}")
    _build.check_hopper(x.device, "ssd_scan")
    form = _form(x)
    y, st = _launch(form, x, dt, A, B_, C_, D, chunk, return_state)
    ssd_scan.launches += 1
    ssd_scan.forms[form] = ssd_scan.forms.get(form, 0) + 1
    return (y, st) if return_state else y


#: Kernel launches since the last reset (the plain version never counts),
#: in all and by form (only the forms launched have a key).
ssd_scan.launches = 0
ssd_scan.forms = {}
