"""The port's SSD scan against ``repro``'s on the CPU: the plain version
(what ``ssd_scan`` and ``ops.ssd_op`` run on a CPU tensor) against
``repro.kernels.ops.ssd_op`` (the Pallas kernel in interpret mode) and the
sequential oracle ``ref.ssd_ref``, and its final state against ``repro``'s
``models/mamba._ssd_chunked``.

Tolerances are ``tests/test_kernels.py``'s for this kernel: 1e-4 in
float32 (sums in other orders; ``exp`` amplifies the order of the
cumulative sums, which reach 10² here); 5e-2 in bfloat16, where y is
rounded once to bfloat16 and the oracle rounds its own. Inputs are made
with numpy from a seed and cross to both sides as the same bits.
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


@pytest.fixture(autouse=True)
def one_torch_thread():
    """The suite runs several test processes on the machine's cores; torch's
    intra-op threads in each would contend for them (the results do not
    depend on the thread count)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _inputs(B, S, H, G, N, P, seed=1):
    """float32 numpy arrays: x, dt, A, B_, C_, D (test_kernels' scales)."""
    rng = np.random.default_rng(seed)
    f = np.float32
    x = (rng.standard_normal((B, S, H, P)) * 0.5).astype(f)
    dt = np.log1p(np.exp(rng.standard_normal((B, S, H)) * 0.5)).astype(f)
    A = np.linspace(0.5, 2.0, H).astype(f)
    B_ = (rng.standard_normal((B, S, G, N)) * 0.3).astype(f)
    C_ = (rng.standard_normal((B, S, G, N)) * 0.3).astype(f)
    D = np.linspace(0.1, 1.0, H).astype(f)
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


def _sides(case, dtype, seed=1):
    B, S, H, G, N, P, chunk = case
    x, dt, A, B_, C_, D = _inputs(B, S, H, G, N, P, seed)
    x, B_, C_ = (_cast(a, dtype) for a in (x, B_, C_))
    arrays = (x, dt, A, B_, C_, D)
    return arrays, [_torch(a) for a in arrays], chunk


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", CASES)
def test_plain_scan_matches_repro_kernel_and_oracle(case, dtype):
    arrays, t, chunk = _sides(case, dtype)
    got = ssd_op(*t, chunk=chunk)
    assert got.dtype == t[0].dtype and tuple(got.shape) == t[0].shape
    want = r_ssd_op(*(jnp.asarray(a) for a in arrays), chunk=chunk,
                    interpret=True)
    np.testing.assert_allclose(_np(got), _np(want), **TOL[dtype])
    x, dt, A, B_, C_, D = (jnp.asarray(a) for a in arrays)
    rep = x.shape[2] // B_.shape[2]
    oracle = ssd_ref(x, dt, A, jnp.repeat(B_, rep, axis=2),
                     jnp.repeat(C_, rep, axis=2), D)
    np.testing.assert_allclose(_np(got), _np(oracle), **TOL[dtype])


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
    _, t, chunk = _sides(CASES[0], "bfloat16")
    ks.ssd_scan.launches = 0
    ssd_op(*t, chunk=chunk)
    ks.ssd_scan(*t, chunk=chunk, return_state=True)
    assert ks.ssd_scan.launches == 0


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
