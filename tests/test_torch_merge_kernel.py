"""The plain versions of the port's gossip-merge kernels against the
jitted ``repro`` references, bit for bit.

``gossip_merge_rows`` and ``gossip_merge_rows_scaled`` run on the CPU here
(a CUDA tensor would launch the kernel; ``chip_smoke.py`` holds the kernel
against these plain versions on the card). Jitted XLA contracts the merge
into one FMA: ``fma(1-w, peer, w*own)``. ``repro``'s simulator computes the
norm-clipped merge as that same merge of the rounded ``c*peer``
(``tests/test_torch_learn.py`` pins both orders inside the simulator), so
the scaled plain version is held against the jitted plain reference fed
``c*peer``; the scaled reference jitted on its own contracts the other
product, which the port does not follow. Under a constant weight (the
uniform policy) XLA folds ``1-w`` into the scale; the scaled merge's
``fold`` order is held against the jitted scaled reference with ``w``
fixed at 0.5. Each order test also shows that another order disagrees with
the reference, so a wrong-order mutant fails.
"""

import jax
import numpy as np
import pytest
import torch

from repro.kernels.ref import gossip_merge_rows_ref as r_rows
from repro.kernels.ref import gossip_merge_rows_scaled_ref as r_scaled
from repro_torch.kernels import gossip_merge as gm
from repro_torch.numerics import fma32

SHAPES = [(1, 1), (7, 34), (200, 34), (33, 306), (5, 1000), (4097, 3)]


def _inputs(n, d, seed, w_kind="random", s_kind="mixed"):
    rng = np.random.default_rng(seed)
    own = rng.normal(size=(n, d)).astype(np.float32)
    peer = (rng.normal(size=(n, d)) * 3).astype(np.float32)
    w = {"random": rng.uniform(0, 1, n), "zero": np.zeros(n),
         "one": np.ones(n)}[w_kind].astype(np.float32)
    s = {"mixed": rng.random(n) < 0.6, "all": np.ones(n, bool),
         "none": np.zeros(n, bool)}[s_kind]
    scale = np.where(rng.random(n) < 0.5, 1.0,
                     rng.uniform(0.01, 1.0, n)).astype(np.float32)
    return own, peer, w, s, scale


def _t(*arrays):
    return [torch.from_numpy(np.array(a)) for a in arrays]


def _bits(a) -> np.ndarray:
    return np.asarray(a, np.float32).view(np.int32)


@pytest.mark.parametrize("n,d", SHAPES)
@pytest.mark.parametrize("w_kind", ["random", "zero", "one"])
@pytest.mark.parametrize("s_kind", ["mixed", "all", "none"])
def test_rows_plain_equals_jitted_reference(n, d, w_kind, s_kind):
    own, peer, w, s, _ = _inputs(n, d, n * 31 + d, w_kind, s_kind)
    want = np.asarray(jax.jit(r_rows)(own, peer, w, s))
    got = gm.gossip_merge_rows(*_t(own, peer, w, s)).numpy()
    np.testing.assert_array_equal(_bits(got), _bits(want))


def _scaled_want(own, peer, w, scale, s):
    """The simulator's norm-clipped merge: the jitted plain merge of the
    float32 product ``c*peer`` (numpy rounds it once, as the kernel does)."""
    return np.asarray(jax.jit(r_rows)(own, scale[:, None] * peer, w, s))


@pytest.mark.parametrize("n,d", SHAPES)
@pytest.mark.parametrize("w_kind", ["random", "zero", "one"])
@pytest.mark.parametrize("s_kind", ["mixed", "all", "none"])
def test_scaled_plain_equals_jitted_reference(n, d, w_kind, s_kind):
    own, peer, w, s, scale = _inputs(n, d, n * 17 + d, w_kind, s_kind)
    got = gm.gossip_merge_rows_scaled(*_t(own, peer, w, scale, s)).numpy()
    np.testing.assert_array_equal(_bits(got),
                                  _bits(_scaled_want(own, peer, w, scale, s)))


def _constant_weight_scaled(own, peer, scale, s):
    """The jitted scaled reference with the uniform policy's ``w = 0.5`` a
    constant of the program, as in the simulator."""
    half = jax.jit(lambda o, p, c, m: r_scaled(
        o, p, jax.numpy.full((o.shape[0],), 0.5, "float32"), c, m))
    return np.asarray(half(own, peer, scale, s))


@pytest.mark.parametrize("n,d", SHAPES)
@pytest.mark.parametrize("s_kind", ["mixed", "all", "none"])
def test_scaled_fold_equals_jitted_reference_under_a_constant_weight(
        n, d, s_kind):
    own, peer, _, s, scale = _inputs(n, d, n * 13 + d, "random", s_kind)
    w = np.full(n, 0.5, np.float32)
    got = gm.gossip_merge_rows_scaled(*_t(own, peer, w, scale, s),
                                      fold=True).numpy()
    np.testing.assert_array_equal(
        _bits(got), _bits(_constant_weight_scaled(own, peer, scale, s)))


def test_the_other_fma_orders_round_differently():
    """A plain merge written ``fma(w, own, (1-w)*peer)`` or unfused, or a
    scaled one in the standalone reference's ``fma(w, own, (1-w)*(c*peer))``,
    misses the reference on a share of these inputs, so the two tests above
    catch each mutant."""
    own, peer, w, s, scale = _inputs(200, 34, 5, "random", "all")
    t_own, t_peer, t_w, t_scale = _t(own, peer, w[:, None], scale[:, None])
    wrong_rows = fma32(t_w, t_own, (1.0 - t_w) * t_peer).numpy()
    want_rows = np.asarray(jax.jit(r_rows)(own, peer, w, s))
    assert 0.05 < np.mean(_bits(wrong_rows) != _bits(want_rows)) < 0.9
    plain = (t_w * t_own + (1.0 - t_w) * t_peer).numpy()
    assert np.any(_bits(plain) != _bits(want_rows))
    standalone = np.asarray(jax.jit(r_scaled)(own, peer, w, scale, s))
    mutant = fma32(t_w, t_own, (1.0 - t_w) * (t_scale * t_peer)).numpy()
    np.testing.assert_array_equal(_bits(mutant), _bits(standalone))
    want_scaled = _scaled_want(own, peer, w, scale, s)
    assert 0.05 < np.mean(_bits(mutant) != _bits(want_scaled)) < 0.9
    half = np.full_like(w, 0.5)
    unfolded = gm.gossip_merge_rows_scaled(
        *_t(own, peer, half, scale, s)).numpy()
    assert np.any(_bits(unfolded)
                  != _bits(_constant_weight_scaled(own, peer, scale, s)))


@pytest.mark.parametrize("bad", [np.nan, np.inf, -np.inf])
def test_unselected_rows_return_own_whatever_peer_holds(bad):
    own, peer, w, s, scale = _inputs(64, 34, 9)
    peer[~s] = bad
    got = gm.gossip_merge_rows(*_t(own, peer, w, s)).numpy()
    np.testing.assert_array_equal(_bits(got[~s]), _bits(own[~s]))
    assert np.all(np.isfinite(got[s]))
    for fold in (False, True):
        got = gm.gossip_merge_rows_scaled(*_t(own, peer, w, scale, s),
                                          fold=fold).numpy()
        np.testing.assert_array_equal(_bits(got[~s]), _bits(own[~s]))


def test_leading_batch_axis_is_rows_of_rows():
    own, peer, w, s, scale = _inputs(3 * 40, 34, 2)
    flat = gm.gossip_merge_rows_scaled(*_t(own, peer, w, scale, s))
    batched = gm.gossip_merge_rows_scaled(
        *_t(own.reshape(3, 40, 34), peer.reshape(3, 40, 34),
            w.reshape(3, 40), scale.reshape(3, 40), s.reshape(3, 40)))
    assert torch.equal(batched.reshape(120, 34), flat)


def test_scale_one_is_the_plain_merge():
    own, peer, w, s, _ = _inputs(200, 34, 4, "random", "mixed")
    ones = np.ones_like(w)
    got = gm.gossip_merge_rows_scaled(*_t(own, peer, w, ones, s)).numpy()
    np.testing.assert_array_equal(
        _bits(got), _bits(np.asarray(jax.jit(r_rows)(own, peer, w, s))))


def test_cpu_tensors_take_the_plain_version_and_count_nothing():
    own, peer, w, s, scale = _inputs(8, 34, 1)
    before = (gm.gossip_merge_rows.launches,
              gm.gossip_merge_rows_scaled.launches)
    gm.gossip_merge_rows(*_t(own, peer, w, s))
    gm.gossip_merge_rows_scaled(*_t(own, peer, w, scale, s))
    assert (gm.gossip_merge_rows.launches,
            gm.gossip_merge_rows_scaled.launches) == before


def test_other_devices_raise():
    own, peer, w, s, scale = (t.to("meta") for t in _t(*_inputs(4, 3, 0)))
    with pytest.raises(ValueError, match="unsupported device"):
        gm.gossip_merge_rows(own, peer, w, s)
    with pytest.raises(ValueError, match="unsupported device"):
        gm.gossip_merge_rows_scaled(own, peer, w, scale, s)


def test_kernel_source_writes_the_reference_orders():
    """The CUDA source spells the two orders the plain versions pin."""
    src = gm.SOURCE.read_text()
    assert "__fmaf_rn(__fsub_rn(1.f, wr), peer[k], __fmul_rn(wr, o))" in src
    scaled = src[src.index("merge_rows_scaled_kernel(const float*"):]
    scaled = scaled[:scaled.index("\n}\n")]
    assert ("Fold ? __fmaf_rn(__fmul_rn(__fsub_rn(1.f, wr), c), p, "
            "__fmul_rn(wr, o))") in scaled
    assert (": __fmaf_rn(__fsub_rn(1.f, wr), __fmul_rn(c, p), "
            "__fmul_rn(wr, o))") in scaled
    # Every load before the select, the row by the reciprocal, no branch
    # on s: an unselected row is own's bits by the select alone.
    for load in ("own[k]", "peer[k]", "w[r]", "scale[r]", "s[r] != 0"):
        assert load in scaled, load
    assert "r = row_of(k, magic);" in scaled
    assert "out[k] = sel ? m : o;" in scaled
    assert "if (!s[r])" not in scaled and "return;\n  }" not in scaled
    assert "template <bool Wide, bool Fold>" in src


def _row_magic(d: int) -> int:
    """``csrc/gossip_merge.cu::row_magic``: ceil(2^64 / d), 0 for d = 1."""
    return 0 if d == 1 else (2**64 - 1) // d + 1


@pytest.mark.parametrize("d", [1, 2, 3, 7, 34, 306, 1000, 4097, 65537,
                               2**31 - 1])
def test_the_kernels_row_index_by_reciprocal_is_exact(d):
    """``gossip_merge_rows`` finds an element's row by one 64-bit high
    multiply, ``(k * row_magic(d)) >> 64``, on 32-bit indices below 2^31 -
    256 (a 64-bit instance divides above): exact for every k < 2^32."""
    rng = np.random.default_rng(d)
    ks = np.concatenate([[0, 1, d - 1, d, d + 1, 2**31 - 257, 2**32 - 1],
                         rng.integers(0, 2**31, 500)]).astype(object)
    m = _row_magic(d)
    for k in ks:
        k = int(k)
        assert (k if m == 0 else (k * m) >> 64) == k // d
    src = gm.SOURCE.read_text()
    assert "~0ull / static_cast<unsigned>(d) + 1" in src
    assert "if (total <= INT32_MAX - kThreads)" in src
