"""The port's SSD scan against ``repro``'s on the CPU: the plain version
(what ``ssd_scan`` and ``ops.ssd_op`` run on a CPU tensor) against
``repro.kernels.ops.ssd_op`` (the Pallas kernel in interpret mode) and the
sequential oracle ``ref.ssd_ref``, and its final state against ``repro``'s
``models/mamba._ssd_chunked``.

Tolerances are ``tests/test_kernels.py``'s for this kernel: 1e-4 in
float32 (sums in other orders; ``exp`` amplifies the order of the
cumulative sums, which reach 10² here); 5e-2 in bfloat16, where y is
rounded once to bfloat16 and the oracle rounds its own. Beside them, the
relative L2 limit ``REL`` that ``chip_smoke.py`` holds the kernel to
(``SSD_REL``). Inputs are made with numpy from a seed and cross to both
sides as the same bits.

The kernel runs only on the card (``chip_smoke.py`` holds it to the plain
version there). Its bfloat16 form's arithmetic (the mma form: w·x split
into bf16 high and low parts, the scores and the state entering a chunk
each rounded once to bf16) is written out here in plain torch and held to
``repro``, and two faulty scans show that the slow-decay inputs, which the
card check also uses, can fail a wrong state hand-off within ``REL``.
"""

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.kernels.ops import ssd_op as r_ssd_op
from repro.kernels.ref import ssd_ref
from repro.models.mamba import _ssd_chunked as r_ssd_chunked
from repro_torch.kernels import ssd_scan as ks
from repro_torch.kernels.ops import ssd_op
from repro_torch.models import mamba

TOL = {"float32": dict(rtol=1e-4, atol=1e-4),
       "bfloat16": dict(rtol=5e-2, atol=5e-2)}
#: tests/test_kernels.py:43-47's cases, then ragged S (100 over chunks of
#: 32), S below the chunk, and G = 2 groups over 4 heads.
CASES = [(1, 64, 2, 1, 16, 16, 16), (2, 96, 4, 2, 32, 32, 32),
         (1, 128, 2, 1, 64, 64, 128), (2, 100, 4, 1, 16, 24, 32),
         (1, 20, 2, 1, 8, 8, 32), (1, 48, 4, 2, 16, 16, 16)]
#: Slow decay (``_inputs``'s ``slow``): 8 chunks of 64 whose state shows.
SLOW_CASES = [(1, 512, 4, 1, 32, 32, 64)]
#: chip_smoke.py's SSD_REL: the largest relative L2 difference of y (and
#: of the final state, in float32) that the card check passes.
REL = {"float32": 1e-4, "bfloat16": 1e-2}


@pytest.fixture(autouse=True)
def one_torch_thread():
    """The suite runs several test processes on the machine's cores; torch's
    intra-op threads in each would contend for them (the results do not
    depend on the thread count)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _inputs(B, S, H, G, N, P, seed=1, slow=False):
    """float32 numpy arrays: x, dt, A, B_, C_, D (test_kernels' scales).
    With ``slow``, dt = softplus(0.5·randn - 5) (about 0.007, so that
    exp(-csum_Q) over 128 steps is 0.2-0.65 rather than e^-47 or less) and
    D = 0 (D·x would otherwise be most of y): the state carried between
    chunks then shows in y."""
    rng = np.random.default_rng(seed)
    f = np.float32
    x = (rng.standard_normal((B, S, H, P)) * 0.5).astype(f)
    dt = np.log1p(np.exp(rng.standard_normal((B, S, H)) * 0.5
                         - (5.0 if slow else 0.0))).astype(f)
    A = np.linspace(0.5, 2.0, H).astype(f)
    B_ = (rng.standard_normal((B, S, G, N)) * 0.3).astype(f)
    C_ = (rng.standard_normal((B, S, G, N)) * 0.3).astype(f)
    D = np.linspace(0.1, 1.0, H).astype(f) * (0.0 if slow else 1.0)
    return x, dt, A, B_, C_, D


def _cast(a: np.ndarray, dtype: str) -> np.ndarray:
    return a.astype(ml_dtypes.bfloat16) if dtype == "bfloat16" else a


def _torch(a: np.ndarray) -> torch.Tensor:
    if a.dtype == ml_dtypes.bfloat16:
        return torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
    return torch.from_numpy(a.copy())


def _np(x) -> np.ndarray:
    if torch.is_tensor(x):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _rel(got, want) -> float:
    """The relative L2 difference ||got - want|| / ||want||."""
    g, w = (np.asarray(_np(t), np.float64) for t in (got, want))
    return float(np.linalg.norm(g - w) / max(np.linalg.norm(w), 1e-30))


def _sides(case, dtype, seed=1, slow=None):
    """numpy arrays and torch tensors of one case's inputs; slow decay for
    the cases in ``SLOW_CASES`` unless ``slow`` says."""
    B, S, H, G, N, P, chunk = case
    if slow is None:
        slow = case in SLOW_CASES
    x, dt, A, B_, C_, D = _inputs(B, S, H, G, N, P, seed, slow)
    x, B_, C_ = (_cast(a, dtype) for a in (x, B_, C_))
    arrays = (x, dt, A, B_, C_, D)
    return arrays, [_torch(a) for a in arrays], chunk


def _repro_kernel(arrays, chunk):
    return r_ssd_op(*(jnp.asarray(a) for a in arrays), chunk=chunk,
                    interpret=True)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", CASES + SLOW_CASES)
def test_plain_scan_matches_repro_kernel_and_oracle(case, dtype):
    arrays, t, chunk = _sides(case, dtype)
    got = ssd_op(*t, chunk=chunk)
    assert got.dtype == t[0].dtype and tuple(got.shape) == t[0].shape
    want = _repro_kernel(arrays, chunk)
    np.testing.assert_allclose(_np(got), _np(want), **TOL[dtype])
    assert _rel(got, want) <= REL[dtype]
    x, dt, A, B_, C_, D = (jnp.asarray(a) for a in arrays)
    rep = x.shape[2] // B_.shape[2]
    oracle = ssd_ref(x, dt, A, jnp.repeat(B_, rep, axis=2),
                     jnp.repeat(C_, rep, axis=2), D)
    np.testing.assert_allclose(_np(got), _np(oracle), **TOL[dtype])
    assert _rel(got, oracle) <= REL[dtype]


@pytest.mark.parametrize("offset", [0, 1])
def test_strided_views_of_one_buffer(offset):
    """x, B_ and C_ cut from one (B, S, H·P + 2·G·N) buffer, as the model
    cuts them from xBC, at an element offset of 0 and 1 (the kernel reads
    them through their strides; the plain version must give the same)."""
    B, S, H, G, N, P, chunk = 2, 100, 4, 2, 16, 8, 32
    x, dt, A, B_, C_, D = _inputs(B, S, H, G, N, P, seed=5)
    width = H * P + 2 * G * N
    buf = np.zeros((B, S, width + offset), np.float32)
    buf[..., offset:offset + H * P] = x.reshape(B, S, H * P)
    buf[..., offset + H * P:offset + H * P + G * N] = B_.reshape(B, S, G * N)
    buf[..., offset + H * P + G * N:] = C_.reshape(B, S, G * N)
    tb = torch.from_numpy(buf)[..., offset:]
    tx, tB, tC = torch.split(tb, [H * P, G * N, G * N], dim=-1)
    tx = tx.reshape(B, S, H, P)
    tB, tC = tB.reshape(B, S, G, N), tC.reshape(B, S, G, N)
    assert not tx.is_contiguous() and tx.stride(-1) == 1
    got = ssd_op(tx, torch.from_numpy(dt), torch.from_numpy(A), tB, tC,
                 torch.from_numpy(D), chunk=chunk)
    want = r_ssd_op(*(jnp.asarray(a) for a in (x, dt, A, B_, C_, D)),
                    chunk=chunk, interpret=True)
    np.testing.assert_allclose(_np(got), _np(want), **TOL["float32"])


@pytest.mark.parametrize("case", [CASES[1], CASES[3], CASES[5]])
def test_final_state_matches_repro_chunked_scan(case):
    arrays, t, chunk = _sides(case, "float32")
    y, st = ssd_op(*t, chunk=chunk, return_state=True)
    want_y, want_st = r_ssd_chunked(*(jnp.asarray(a) for a in arrays), chunk)
    assert st.dtype == torch.float32
    assert tuple(st.shape) == want_st.shape
    np.testing.assert_allclose(_np(st), _np(want_st), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(_np(y), _np(want_y), rtol=1e-4, atol=1e-4)
    ref_y, ref_st = mamba._ssd_chunked(*t, chunk)
    assert ref_y.dtype == torch.float32
    np.testing.assert_array_equal(_np(ref_st), _np(st))


def test_the_cpu_path_launches_no_kernel():
    ks.ssd_scan.launches = 0
    ks.ssd_scan.forms.clear()
    for dtype in ("bfloat16", "float32"):
        _, t, chunk = _sides(CASES[0], dtype)
        ssd_op(*t, chunk=chunk)
        ks.ssd_scan(*t, chunk=chunk, return_state=True)
    assert ks.ssd_scan.launches == 0
    assert ks.ssd_scan.forms == {}


#: (dtype, layout) -> the form the card takes: float32 the CUDA cores,
#: bfloat16 the tensor cores; the layout (16-byte or single loads) does not
#: decide it.
FORM_CASES = [(dt, lay) for dt in ("float32", "bfloat16")
              for lay in ("contiguous", "view", "offset")]


@pytest.mark.parametrize("dtype,layout", FORM_CASES)
def test_form_is_chosen_by_dtype(dtype, layout):
    """x contiguous, a view of an xBC-like buffer, or one element off its
    allocation (no 16-byte loads): the form follows the dtype alone."""
    tdt = getattr(torch, dtype)
    B, S, H, P = 1, 40, 4, 16
    if layout == "contiguous":
        x = torch.zeros((B, S, H, P), dtype=tdt)
    else:
        off = 1 if layout == "offset" else 0
        buf = torch.zeros((B, S, off + H * P + 2 * 32), dtype=tdt)
        x = buf[..., off:off + H * P].reshape(B, S, H, P)
        assert not x.is_contiguous()
    assert ks._form(x) == ("mma" if dtype == "bfloat16" else "simt")
    assert set(ks.FORMS.values()) == {"simt", "mma"}


def scan_arithmetic(x, dt, A, B_, C_, D, chunk, *, form="plain",
                    fault=None):
    """A chunked scan in plain torch, float32, returning ``(y float32,
    final state)``. ``form="plain"`` is ``ssd_scan_ref``'s arithmetic;
    ``form="mma"`` the card's bfloat16 form: the chunk's state contribution
    from w·x (w = exp(-(csum_Q - csum))·dt) split into a bf16 high and low
    part, the state entering a chunk rounded to bf16 before C·St, the
    masked, decayed scores rounded to bf16 before scores·x (the card takes
    their exp as exp2 of the difference times log2(e), some 2^-22 off,
    which that rounding swamps); the carried state stays float32.
    ``fault`` breaks the hand-off: ``"late"`` gives
    each chunk the state that entered the chunk before it, ``"double"``
    applies each chunk's decay twice."""
    Bb, S, H, P = x.shape
    G, N = B_.shape[2], B_.shape[3]
    Q = min(chunk, S)
    nc = -(-S // Q)
    pad = nc * Q - S

    def chunks(t):
        t = torch.nn.functional.pad(t.float(), (0, 0) * (t.dim() - 2) +
                                    (0, pad))
        return t.reshape(Bb, nc, Q, *t.shape[2:])

    def bf(t):
        return t.to(torch.bfloat16).float() if form == "mma" else t

    xc, dtc = chunks(x), chunks(dt)
    Bh = chunks(B_).repeat_interleave(H // G, 3)
    Ch = chunks(C_).repeat_interleave(H // G, 3)
    mask = torch.tril(torch.ones((Q, Q), dtype=torch.bool))[None, :, :, None]
    st = torch.zeros((Bb, H, N, P))
    before = st
    ys = []
    for c in range(nc):
        x_c, dt_c, B_c, C_c = xc[:, c], dtc[:, c], Bh[:, c], Ch[:, c]
        csum = torch.cumsum(dt_c * A, dim=1)                   # (B, Q, H)
        w = torch.exp(-(csum[:, -1:] - csum)) * dt_c
        if form == "mma":
            xw = w[..., None] * x_c
            hi = bf(xw)
            ns = (torch.einsum("bqhn,bqhp->bhnp", B_c, hi)
                  + torch.einsum("bqhn,bqhp->bhnp", B_c, bf(xw - hi)))
        else:
            ns = torch.einsum("bqh,bqhn,bqhp->bhnp", w, B_c, x_c)
        st_in = before if fault == "late" else st
        L = csum[:, :, None, :] - csum[:, None, :, :]
        decay = torch.where(mask, torch.exp(-torch.where(mask, L, 80.0)), 0.0)
        scores = torch.einsum("bqhn,bkhn->bqkh", C_c, B_c) * decay
        y = torch.einsum("bqkh,bkhp->bqhp", bf(scores * dt_c[:, None]), x_c)
        y = y + torch.exp(-csum)[..., None] * torch.einsum(
            "bqhn,bhnp->bqhp", C_c, bf(st_in))
        ys.append(y + D[:, None] * x_c)
        dec = torch.exp(-csum[:, -1])[:, :, None, None]
        if fault == "double":
            dec = dec * dec
        before, st = st, ns + dec * st
    y = torch.stack(ys, dim=1).reshape(Bb, nc * Q, H, P)[:, :S]
    return y, st


@pytest.mark.parametrize("case", [CASES[1], CASES[3], CASES[5]] + SLOW_CASES)
def test_plain_arithmetic_is_the_plain_version(case):
    """``scan_arithmetic``'s plain form is ``ssd_scan_ref``, so that its
    faults and its mma form differ from the port's scan in only that."""
    _, t, chunk = _sides(case, "float32")
    y, st = scan_arithmetic(*t, chunk)
    want_y, want_st = ks.ssd_scan_ref(*t, chunk)
    torch.testing.assert_close(y, want_y, rtol=1e-6, atol=1e-6)
    torch.testing.assert_close(st, want_st, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("case", CASES + SLOW_CASES)
def test_mma_form_arithmetic_matches_repro_kernel(case):
    """The card's bfloat16 form rounds the scores and the incoming state
    to bf16, which the TPU kernel at float32 does not: held to ``repro``'s
    Pallas kernel and its chunked scan within the bf16 tolerance and
    ``REL``, its float32 state within the float32 ones."""
    arrays, t, chunk = _sides(case, "bfloat16")
    y, st = scan_arithmetic(*t, chunk, form="mma")
    y = y.to(torch.bfloat16)
    want = _repro_kernel(arrays, chunk)
    np.testing.assert_allclose(_np(y), _np(want), **TOL["bfloat16"])
    assert _rel(y, want) <= REL["bfloat16"]
    f32 = [a.astype(np.float32) for a in arrays]
    _, want_st = r_ssd_chunked(*(jnp.asarray(a) for a in f32), chunk)
    np.testing.assert_allclose(_np(st), _np(want_st), **TOL["float32"])
    assert _rel(st, want_st) <= REL["float32"]


#: The faults' case: 8 chunks of 128, the length the model runs.
FAULT_CASE = (1, 1024, 4, 1, 32, 32, 128)


@pytest.mark.parametrize("fault", ["late", "double"])
def test_slow_decay_fails_a_wrong_hand_off(fault):
    """On the slow-decay, D = 0 inputs a state carried a chunk late, or a
    chunk's decay applied twice, moves y by far more than bf16 ``REL``; on
    the fast-decay inputs of the other cases the doubled decay leaves y as
    it is, so those cases cannot fail it."""
    _, t, chunk = _sides(FAULT_CASE, "float32", slow=True)
    want, _ = scan_arithmetic(*t, chunk)
    got, _ = scan_arithmetic(*t, chunk, fault=fault)
    assert _rel(got, want) > 10 * REL["bfloat16"]
    _, t, chunk = _sides(FAULT_CASE, "float32", slow=False)
    want, _ = scan_arithmetic(*t, chunk)
    got, _ = scan_arithmetic(*t, chunk, fault="double")
    assert torch.equal(got, want)


def _bad_inputs():
    _, (x, dt, A, B_, C_, D), _ = _sides((1, 8, 4, 2, 4, 4, 4), "float32")
    yield "float16", (x.half(), dt, A, B_.half(), C_.half(), D), {}
    yield "groups", (x, dt, A, B_[:, :, :1].expand(1, 8, 3, 4),
                     C_[:, :, :1].expand(1, 8, 3, 4), D), {}
    yield "B_ dtype", (x, dt, A, B_.to(torch.bfloat16), C_, D), {}
    yield "dt dtype", (x, dt.double(), A, B_, C_, D), {}
    yield "dt shape", (x, dt[:, :7], A, B_, C_, D), {}
    yield "C_ shape", (x, dt, A, B_, C_[..., :3], D), {}
    yield "A shape", (x, dt, A[:3], B_, C_, D), {}
    yield "last dim", (x.transpose(2, 3), dt, A, B_, C_, D), {}
    yield "state", (x, dt, A, torch.zeros((1, 8, 2, 129)),
                    torch.zeros((1, 8, 2, 129)), D), {}
    yield "chunk", (x.expand(1, 8, 4, 4).repeat(1, 20, 1, 1),
                    dt.repeat(1, 20, 1), A, B_.repeat(1, 20, 1, 1),
                    C_.repeat(1, 20, 1, 1), D), dict(chunk=160)
    yield "empty", (x[:, :0], dt[:, :0], A, B_[:, :0], C_[:, :0], D), {}


@pytest.mark.parametrize("name,args,kw", list(_bad_inputs()),
                         ids=[b[0] for b in _bad_inputs()])
def test_bad_inputs_raise_on_the_cpu(name, args, kw):
    with pytest.raises(ValueError):
        ssd_op(*args, **kw)
    with pytest.raises(ValueError):
        ks.ssd_scan_ref(*args, **kw)
