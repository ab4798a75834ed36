"""The port's attention against ``repro``'s, on the CPU: the plain version
of the ``flash_attention`` kernel, ``attention_op``'s dispatch and checks,
``blockwise_attention``, the layers' forward functions and the GQA
forward and decode with carried-over weights.

Inputs come from numpy seeds and go to both frameworks as the same values.
Tolerances, by reason:

* ``TOL`` (float32 rtol = atol = 2e-5; bfloat16 2e-2), the tolerances of
  ``tests/test_kernels.py``: both sides compute in float32 and sum in
  other orders; in bfloat16 the rounding of the output can then differ by
  one ulp (2^-8 relative).
* ``F32`` (rtol = atol = 1e-5) for the float32 model functions: matrix
  products summed in other orders by XLA and torch, and cos, sin, pow
  that may differ by an ulp; measured differences stay below 1e-6.

The kernels themselves run only on the card: ``chip_smoke.py`` holds
them against the same plain version there. Here the arithmetic of the
card's two newer forms is written out in plain torch (the mma form's bf16
products in tiles of 64 keys with P rounded to bf16, the decode form's
log-sum-exp merge of 8 key slices) and held to ``repro``'s Pallas kernel
within ``TOL``: the tolerance the card check uses is wide enough for the
design.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.ops import attention_op as r_attention_op
from repro.kernels.ref import attention_ref as r_attention_ref
from repro.models import attention as r_attn
from repro.models import layers as r_layers
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels.ops import attention_op
from repro_torch.models import attention as attn
from repro_torch.models import layers
from repro_torch.models.transformer import params_from_numpy

TOL = {"float32": dict(rtol=2e-5, atol=2e-5),
       "bfloat16": dict(rtol=2e-2, atol=2e-2)}
F32 = dict(rtol=1e-5, atol=1e-5)
DT = {"float32": (jnp.float32, torch.float32),
      "bfloat16": (jnp.bfloat16, torch.bfloat16)}


@pytest.fixture(autouse=True)
def one_torch_thread():
    """The suite runs several test processes on the machine's cores; torch's
    intra-op threads in each would contend for them (the results do not
    depend on the thread count)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _pair(rng, shape, dtype: str, scale: float = 0.5):
    """The same values as a JAX array and a torch tensor of ``dtype``."""
    x = (rng.normal(size=shape) * scale).astype(np.float32)
    jdt, tdt = DT[dtype]
    return jnp.asarray(x).astype(jdt), torch.from_numpy(x).to(tdt)


def _np(x) -> np.ndarray:
    if torch.is_tensor(x):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


#: (B, Sq, Skv, H, Hkv, D): ``tests/test_kernels.py``'s grid, then the
#: serving shapes' features: D = 120, Sq < Skv (right-aligned q), Sq = 1
#: (decode) over one key and over a ragged length.
SHAPES = [
    (1, 128, 128, 4, 4, 64),
    (2, 200, 200, 4, 2, 64),
    (1, 512, 512, 2, 1, 128),
    (2, 150, 150, 8, 2, 120),
    (1, 37, 200, 4, 1, 120),
    (2, 1, 1, 8, 2, 120),
    (3, 1, 129, 4, 4, 64),
]
MASKS = [(True, None), (False, None), (True, 96)]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
@pytest.mark.parametrize("causal,window", MASKS)
def test_plain_version_matches_repro_kernel_and_ref(shape, causal, window,
                                                    dtype):
    """``flash_attention_ref`` against ``repro``'s Pallas kernel in
    interpret mode (through ``repro.kernels.ops.attention_op``, as
    ``tests/test_kernels.py`` runs it) and against ``ref.attention_ref``
    on repeated KV heads."""
    B, Sq, Skv, H, Hkv, D = shape
    rng = np.random.default_rng(sum(shape))
    jq, q = _pair(rng, (B, Sq, H, D), dtype)
    jk, k = _pair(rng, (B, Skv, Hkv, D), dtype)
    jv, v = _pair(rng, (B, Skv, Hkv, D), dtype)
    got = fa.flash_attention_ref(q, k, v, causal=causal, window=window)
    assert got.dtype == q.dtype and tuple(got.shape) == (B, Sq, H, D)
    kernel = r_attention_op(jq, jk, jv, causal=causal, window=window,
                            blk_q=64, blk_k=64, interpret=True)
    np.testing.assert_allclose(_np(got), _np(kernel), **TOL[dtype])
    rep = H // Hkv
    ref = r_attention_ref(jq, jnp.repeat(jk, rep, axis=2),
                          jnp.repeat(jv, rep, axis=2), causal=causal,
                          window=window)
    np.testing.assert_allclose(_np(got), _np(ref), **TOL[dtype])


def test_plain_version_blocks_rows_exactly():
    """The plain version's row blocks change nothing: rows are
    independent."""
    rng = np.random.default_rng(3)
    q, k, v = (torch.from_numpy(rng.normal(size=s).astype(np.float32))
               for s in ((2, 70, 4, 64), (2, 90, 2, 64), (2, 90, 2, 64)))
    whole = fa.flash_attention_ref(q, k, v, causal=True, window=30)
    blocked = fa.flash_attention_ref(q, k, v, causal=True, window=30,
                                     block=16)
    assert torch.equal(whole, blocked)


def test_attention_op_on_cpu_is_the_plain_version_and_counts_nothing():
    rng = np.random.default_rng(4)
    _, q = _pair(rng, (2, 33, 8, 120), "bfloat16")
    _, k = _pair(rng, (2, 40, 2, 120), "bfloat16")
    _, v = _pair(rng, (2, 40, 2, 120), "bfloat16")
    fa.flash_attention.launches = 0
    for causal, window in MASKS:
        want = fa.flash_attention_ref(q, k, v, causal=causal, window=window)
        assert torch.equal(attention_op(q, k, v, causal=causal,
                                        window=window), want)
        assert torch.equal(fa.flash_attention(q, k, v, causal=causal,
                                              window=window), want)
    view = torch.zeros((2, 64, 2, 120), dtype=torch.bfloat16)
    view[:, :40] = k
    got = attention_op(q, view[:, :40], v, causal=False)
    assert torch.equal(got, fa.flash_attention_ref(q, k, v, causal=False))
    assert fa.flash_attention.launches == 0


#: (dtype, Sq, layout) -> the form the card takes: one query position
#: takes the decode form, else bf16 the tensor cores and float32 the CUDA
#: cores; the layout (16-byte copies or single values) does not decide it.
FORM_CASES = [(dt, sq, lay) for dt in ("float32", "bfloat16")
              for sq in (1, 9) for lay in ("contiguous", "strided", "offset",
                                           "odd_dim")]


def _laid_out(dtype: str, sq: int, layout: str):
    """q of (2, sq, 8, D) as a CPU tensor in ``layout``: contiguous; a view
    of every other head of a wider tensor (strided); one element off its
    allocation (no 16-byte copies); or D = 67 (no whole chunks)."""
    tdt = DT[dtype][1]
    d = 67 if layout == "odd_dim" else 120
    shape = (2, sq, 8, d)
    if layout == "offset":
        return torch.zeros(int(np.prod(shape)) + 1, dtype=tdt)[1:].view(shape)
    if layout == "strided":
        q = torch.zeros((2, sq, 16, d), dtype=tdt)[:, :, ::2]
        assert not q.is_contiguous()
        return q
    return torch.zeros(shape, dtype=tdt)


@pytest.mark.parametrize("dtype,sq,layout", FORM_CASES)
def test_form_is_chosen_by_shape_and_dtype(dtype, sq, layout):
    q = _laid_out(dtype, sq, layout)
    want = ("decode" if sq == 1 else
            "mma" if dtype == "bfloat16" else "simt")
    assert fa._form(q) == want
    assert set(fa.FORMS) == {"simt", "mma", "decode"}


def test_cpu_calls_count_no_launch_and_no_form():
    rng = np.random.default_rng(12)
    fa.flash_attention.launches = 0
    fa.flash_attention.forms.clear()
    for dtype, sq in (("bfloat16", 9), ("float32", 9), ("bfloat16", 1),
                      ("float32", 1)):
        _, q = _pair(rng, (2, sq, 8, 64), dtype)
        _, k = _pair(rng, (2, 12, 2, 64), dtype)
        _, v = _pair(rng, (2, 12, 2, 64), dtype)
        got = fa.flash_attention(q, k, v, causal=True, window=8)
        assert torch.equal(got, fa.flash_attention_ref(q, k, v, causal=True,
                                                       window=8))
    assert fa.flash_attention.launches == 0
    assert fa.flash_attention.forms == {}


def _masked(scores, q_pos, k_pos, causal: bool, window):
    """``scores`` (..., Sq, n) with the kernel's mask: ``-1e30`` where a key
    is past Skv's end, later than the query (causal) or ``window`` or more
    back."""
    ok = torch.ones(scores.shape[-2:], dtype=torch.bool)
    if causal:
        ok &= q_pos[:, None] >= k_pos[None, :]
    if window is not None:
        ok &= q_pos[:, None] - k_pos[None, :] < window
    return torch.where(ok, scores, fa.NEG_INF)


def _heads_first(q, k, v):
    """q as (B, H, Sq, D) and k, v repeated to H heads as (B, H, Skv, D),
    all float32."""
    G = q.shape[2] // k.shape[2]
    return (q.float().permute(0, 2, 1, 3),
            *(t.float().repeat_interleave(G, dim=2).permute(0, 2, 1, 3)
              for t in (k, v)))


def mma_form_arithmetic(q, k, v, causal: bool, window):
    """The mma form's arithmetic in plain torch, on bf16 inputs: the bf16
    products summed in float32, ``scale * log2(e)`` (a float32 product)
    applied to the float32 scores after the product, ``exp2`` and the
    online rescale over tiles of 64 keys, P rounded to bf16 before P·V,
    ``l`` summed from the unrounded P."""
    B, Sq, H, D = q.shape
    Skv = k.shape[1]
    qf, kf, vf = _heads_first(q, k, v)
    sl2 = float(np.float32(fa._scale(D)) * np.float32(np.log2(np.e)))
    q_pos = torch.arange(Sq) + Skv - Sq
    m = torch.full((B, H, Sq, 1), fa.NEG_INF)
    l = torch.zeros((B, H, Sq, 1))
    acc = torch.zeros((B, H, Sq, D))
    for k0 in range(0, Skv, 64):
        k1 = min(Skv, k0 + 64)
        s = (qf @ kf[:, :, k0:k1].transpose(-1, -2)) * sl2
        s = _masked(s, q_pos, torch.arange(k0, k1), causal, window)
        m_new = torch.maximum(m, s.amax(dim=-1, keepdim=True))
        p = torch.exp2(s - m_new)
        corr = torch.exp2(m - m_new)
        l = l * corr + p.sum(dim=-1, keepdim=True)
        acc = acc * corr + p.to(torch.bfloat16).float() @ vf[:, :, k0:k1]
        m = m_new
    return (acc / l.clamp_min(1e-30)).to(q.dtype).permute(0, 2, 1, 3)


def decode_form_arithmetic(q, k, v, causal: bool, window,
                           prune: bool = True, slices: int = 8):
    """The decode form's arithmetic in plain torch (Sq = 1): the keys from
    the window's first (``prune``; else from 0, masked) to Skv split into
    ``slices`` contiguous slices of ``ceil(n / slices)``, each with its own
    max, sum and accumulator (an empty slice: -1e30, 0, 0), merged by
    log-sum-exp. Returns the output and the numbers of empty and of wholly
    masked slices."""
    B, _, H, D = q.shape
    Skv = k.shape[1]
    qf, kf, vf = _heads_first(q, k, v)
    s = (qf * fa._scale(D)) @ kf.transpose(-1, -2)           # (B, H, 1, Skv)
    s = _masked(s, torch.tensor([Skv - 1]), torch.arange(Skv), causal,
                window)
    lo = max(0, Skv - window) if prune and window is not None else 0
    per = -(-(Skv - lo) // slices)
    ms, ls, accs, empty, masked = [], [], [], 0, 0
    for w in range(slices):
        j0 = lo + w * per
        j1 = min(Skv, j0 + per)
        if j0 >= j1:
            empty += 1
            ms.append(torch.full((B, H, 1, 1), fa.NEG_INF))
            ls.append(torch.zeros((B, H, 1, 1)))
            accs.append(torch.zeros((B, H, 1, D)))
            continue
        sw = s[..., j0:j1]
        masked += int(bool((sw == fa.NEG_INF).all()))
        mw = sw.amax(dim=-1, keepdim=True)
        p = torch.exp(sw - mw)
        ms.append(mw)
        ls.append(p.sum(dim=-1, keepdim=True))
        accs.append(p @ vf[:, :, j0:j1])
    mm = torch.stack(ms).amax(dim=0)
    wts = [torch.exp(mw - mm) for mw in ms]
    l = sum(lw * wt for lw, wt in zip(ls, wts))
    acc = sum(aw * wt for aw, wt in zip(accs, wts))
    out = (acc / l.clamp_min(1e-30)).to(q.dtype).permute(0, 2, 1, 3)
    return out, empty, masked


def _repro_kernel(jq, jk, jv, causal, window):
    return r_attention_op(jq, jk, jv, causal=causal, window=window,
                          blk_q=64, blk_k=64, interpret=True)


@pytest.mark.parametrize("shape", [s for s in SHAPES if s[1] > 1],
                         ids=lambda s: "x".join(map(str, s)))
@pytest.mark.parametrize("causal,window", MASKS)
def test_mma_form_arithmetic_matches_repro_kernel(shape, causal, window):
    """The mma form rounds P to bf16, which the TPU kernel does not: held
    to ``repro``'s Pallas kernel within the bf16 tolerance the card check
    uses."""
    B, Sq, Skv, H, Hkv, D = shape
    rng = np.random.default_rng(sum(shape) + 1)
    jq, q = _pair(rng, (B, Sq, H, D), "bfloat16")
    jk, k = _pair(rng, (B, Skv, Hkv, D), "bfloat16")
    jv, v = _pair(rng, (B, Skv, Hkv, D), "bfloat16")
    got = mma_form_arithmetic(q, k, v, causal, window)
    assert got.dtype == torch.bfloat16 and tuple(got.shape) == (B, Sq, H, D)
    np.testing.assert_allclose(
        _np(got), _np(_repro_kernel(jq, jk, jv, causal, window)),
        **TOL["bfloat16"])


#: (B, Skv, H, Hkv, D) at Sq = 1: one key (7 empty slices), five (3
#: empty), a slice length that does not divide Skv, and 300 keys (with
#: window 96 and no pruning, the first slices are wholly masked).
DECODE_SHAPES = [(2, 1, 8, 2, 120), (2, 5, 8, 2, 64), (3, 129, 4, 4, 64),
                 (2, 300, 8, 2, 120)]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", DECODE_SHAPES,
                         ids=lambda s: "x".join(map(str, s)))
@pytest.mark.parametrize("causal,window", MASKS)
@pytest.mark.parametrize("prune", [True, False], ids=["band", "all-keys"])
def test_decode_form_merge_matches_repro_kernel(shape, causal, window,
                                                prune, dtype):
    """The decode form's 8-slice log-sum-exp merge, empty and wholly
    masked slices wiped by their weight exp(-1e30 - m) = 0."""
    B, Skv, H, Hkv, D = shape
    rng = np.random.default_rng(sum(shape) + 2)
    jq, q = _pair(rng, (B, 1, H, D), dtype)
    jk, k = _pair(rng, (B, Skv, Hkv, D), dtype)
    jv, v = _pair(rng, (B, Skv, Hkv, D), dtype)
    got, empty, masked = decode_form_arithmetic(q, k, v, causal, window,
                                                prune)
    if Skv < 8:
        assert empty == 8 - Skv
    if Skv == 300 and window == 96:
        assert masked == (0 if prune else 5)
    np.testing.assert_allclose(
        _np(got), _np(_repro_kernel(jq, jk, jv, causal, window)),
        **TOL[dtype])


def _bad_inputs(case: str):
    q = torch.zeros((1, 8, 4, 64))
    k = torch.zeros((1, 8, 2, 64))
    if case == "float16":
        return q.half(), k.half(), k.half(), {}
    if case == "head_dim_129":
        q, k = torch.zeros((1, 8, 4, 129)), torch.zeros((1, 8, 2, 129))
        return q, k, k, {}
    if case == "causal_sq_above_skv":
        return q, k[:, :4], k[:, :4], dict(causal=True)
    if case == "heads_not_a_multiple":
        return torch.zeros((1, 8, 3, 64)), k, k, {}
    if case == "strided_last_dim":
        return q, torch.zeros((1, 8, 2, 128))[..., ::2], k, {}
    if case == "window_0":
        return q, k, k, dict(window=0)
    if case == "mixed_dtypes":
        return q, k.to(torch.bfloat16), k, {}
    if case == "kv_shapes_differ":
        return q, k, k[:, :7], {}
    raise AssertionError(case)


@pytest.mark.parametrize("case", [
    "float16", "head_dim_129", "causal_sq_above_skv", "heads_not_a_multiple",
    "strided_last_dim", "window_0", "mixed_dtypes", "kv_shapes_differ"])
def test_kernel_contract_is_checked_on_the_cpu_too(case):
    q, k, v, kw = _bad_inputs(case)
    with pytest.raises(ValueError, match="flash_attention"):
        fa.flash_attention(q, k, v, **kw)


#: (B, Sq, Skv, Hkv, G, D, causal, window, q_offset, chunk, valid_len)
BLOCKWISE = [
    (2, 100, 100, 2, 2, 32, True, None, 0, 48, None),   # chunk ∤ Skv
    (1, 64, 64, 2, 1, 64, True, 17, 0, 32, None),       # sliding window
    (2, 1, 40, 2, 4, 16, False, None, 0, 16, 23),       # decode: valid_len
    (1, 10, 30, 1, 2, 32, True, 8, 20, 7, None),        # q_offset
]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", BLOCKWISE, ids=[
    "chunk-ragged", "window", "valid-len", "q-offset"])
def test_blockwise_attention_matches_repro(case, dtype):
    B, Sq, Skv, Hkv, G, D, causal, window, q_offset, chunk, valid = case
    rng = np.random.default_rng(Skv + D)
    jq, q = _pair(rng, (B, Sq, Hkv, G, D), dtype)
    jk, k = _pair(rng, (B, Skv, Hkv, D), dtype)
    jv, v = _pair(rng, (B, Skv, Hkv, D), dtype)
    kw = dict(causal=causal, window=window, q_offset=q_offset, chunk=chunk,
              valid_len=valid)
    got = attn.blockwise_attention(q, k, v, **kw)
    want = r_attn.blockwise_attention(jq, jk, jv, **kw)
    assert got.dtype == q.dtype
    np.testing.assert_allclose(_np(got), _np(want), **TOL[dtype])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rmsnorm_matches_repro(dtype):
    rng = np.random.default_rng(5)
    jx, x = _pair(rng, (3, 7, 96), dtype, scale=3.0)
    js, s = _pair(rng, (96,), dtype)
    got = layers.rmsnorm(x, s, 1e-5)
    want = r_layers.rmsnorm(jx, js, 1e-5)
    assert got.dtype == x.dtype
    np.testing.assert_allclose(_np(got), _np(want), **TOL[dtype])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("theta", [10000.0, 500000.0])
def test_rope_and_rope_at_match_repro(dtype, theta):
    """Positions up to 300, so the angles reach a few hundred radians."""
    rng = np.random.default_rng(6)
    jx, x = _pair(rng, (2, 50, 3, 120), dtype, scale=2.0)
    pos = rng.integers(0, 300, (2, 50)).astype(np.int32)
    got = layers.rope(x, torch.from_numpy(pos), theta)
    want = r_layers.rope(jx, jnp.asarray(pos), theta)
    assert got.dtype == x.dtype
    np.testing.assert_allclose(_np(got), _np(want), **TOL[dtype])
    got = layers.rope_at(x[:, :1], 277, theta)
    want = r_layers.rope_at(jx[:, :1], 277, theta)
    np.testing.assert_allclose(_np(got), _np(want), **TOL[dtype])


@pytest.mark.parametrize("act", ["swiglu", "gelu"])
def test_ffn_apply_matches_repro(act):
    rng = np.random.default_rng(7)
    jx, x = _pair(rng, (2, 9, 64), "float32")
    names = ("wi", "wg", "wo") if act == "swiglu" else ("wi", "wo")
    shapes = dict(wi=(64, 128), wg=(64, 128), wo=(128, 64))
    pairs = {n: _pair(rng, shapes[n], "float32", scale=0.1) for n in names}
    got = layers.ffn_apply({n: t for n, (_, t) in pairs.items()}, x, act)
    want = r_layers.ffn_apply({n: j for n, (j, _) in pairs.items()}, jx, act)
    np.testing.assert_allclose(_np(got), _np(want), **F32)


class _Cfg:
    """The attention fields of an ArchConfig."""
    d_model, n_heads, n_kv_heads, hd, rope_theta = 96, 8, 2, 40, 10000.0


def _gqa_params(seed: int):
    rng = np.random.default_rng(seed)
    d, H, Hkv, hd = _Cfg.d_model, _Cfg.n_heads, _Cfg.n_kv_heads, _Cfg.hd
    shapes = dict(wq=(d, H * hd), wk=(d, Hkv * hd), wv=(d, Hkv * hd),
                  wo=(H * hd, d))
    tree = {n: (rng.normal(size=s) * s[0] ** -0.5).astype(np.float32)
            for n, s in shapes.items()}
    return ({n: jnp.asarray(a) for n, a in tree.items()},
            params_from_numpy(tree, device="cpu"))


@pytest.mark.parametrize("window", [None, 16])
def test_gqa_forward_matches_repro(window):
    jp, p = _gqa_params(8)
    rng = np.random.default_rng(9)
    jx, x = _pair(rng, (2, 40, _Cfg.d_model), "float32", scale=1.0)
    got = attn.gqa_forward(p, _Cfg, x, causal=True, window=window, chunk=16)
    want = r_attn.gqa_forward(jp, _Cfg, jx, causal=True, window=window,
                              chunk=16)
    np.testing.assert_allclose(_np(got), _np(want), **F32)


@pytest.mark.parametrize("max_len,window", [(16, None), (32, 8)])
def test_gqa_decode_matches_repro_over_a_ring(max_len, window):
    """12 decode steps; with ``window`` 8 the ring wraps after 8. The port
    writes its cache in place; ``repro`` returns a new one: both hold the
    same values after every step."""
    jp, p = _gqa_params(10)
    rng = np.random.default_rng(11)
    cache = attn.init_kv_cache(_Cfg, 2, max_len, window=window,
                               dtype=torch.float32, device="cpu")
    jcache, _ = r_attn.init_kv_cache(_Cfg, 2, max_len, window=window,
                                     dtype=jnp.float32)
    assert tuple(cache["k"].shape) == jcache["k"].shape
    for index in range(12):
        jx, x = _pair(rng, (2, 1, _Cfg.d_model), "float32", scale=1.0)
        got, cache = attn.gqa_decode(p, _Cfg, x, cache, index, chunk=8)
        want, jcache = r_attn.gqa_decode(jp, _Cfg, jx, jcache, index,
                                         chunk=8)
        np.testing.assert_allclose(_np(got), _np(want), **F32)
        for name in ("k", "v"):
            np.testing.assert_allclose(_np(cache[name]), _np(jcache[name]),
                                       **F32)


def test_cross_attention_waits_for_the_model_zoo_slice():
    with pytest.raises(NotImplementedError, match="model-zoo"):
        attn.gqa_forward({}, _Cfg, torch.zeros((1, 2, 96)),
                         kv_src=torch.zeros((1, 3, 96)))
    with pytest.raises(NotImplementedError, match="model-zoo"):
        attn.cross_prefill({}, _Cfg, torch.zeros((1, 3, 96)))
    with pytest.raises(NotImplementedError, match="model-zoo"):
        attn.cross_decode({}, _Cfg, torch.zeros((1, 1, 96)), {})
