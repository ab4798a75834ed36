"""``repro_torch.random`` reproduces jitted ``jax.random`` bit for bit
(threefry2x32, partitionable mode): keys, splits, fold-ins, raw bits,
float32 uniforms and normals over odd and multi-dimensional shapes."""

import math

import jax
import numpy as np
import pytest
import torch

from repro_torch import random as tr

SEEDS = [0, 1, 42, 123456, 2**31 - 1]


def _key(seed):
    return jax.random.PRNGKey(seed), tr.PRNGKey(seed)


def _u32(t: torch.Tensor) -> np.ndarray:
    return t.numpy().astype(np.uint32)


def test_jax_runs_partitionable_threefry():
    """The mode the port reproduces is the one the reference runs."""
    assert jax.config.jax_threefry_partitionable
    assert jax.config.jax_default_prng_impl == "threefry2x32"


@pytest.mark.parametrize("seed", SEEDS)
def test_prngkey(seed):
    k, kt = _key(seed)
    np.testing.assert_array_equal(np.asarray(k), _u32(kt))


@pytest.mark.parametrize("num", [2, 3, 5])
@pytest.mark.parametrize("seed", SEEDS)
def test_split(seed, num):
    k, kt = _key(seed)
    want = jax.jit(lambda k: jax.random.split(k, num))(k)
    np.testing.assert_array_equal(np.asarray(want), _u32(tr.split(kt, num)))


@pytest.mark.parametrize("data", [0, 1, 12345, 2654435761, 2**32 - 1])
def test_fold_in(data):
    k, kt = _key(7)
    want = jax.jit(jax.random.fold_in)(k, np.uint32(data))
    np.testing.assert_array_equal(np.asarray(want), _u32(tr.fold_in(kt, data)))


def test_fold_in_over_a_data_vector_matches_vmap():
    data = np.random.default_rng(0).integers(0, 2**32, 50, dtype=np.uint32)
    k, kt = _key(0)
    want = jax.jit(jax.vmap(jax.random.fold_in, in_axes=(None, 0)))(k, data)
    got = tr.fold_in(kt, torch.from_numpy(data.astype(np.int64)))
    np.testing.assert_array_equal(np.asarray(want), _u32(got))


@pytest.mark.parametrize("shape", [(), (7,), (200, 2), (3, 5, 7)])
def test_bits(shape):
    k, kt = _key(3)
    want = jax.jit(lambda k: jax.random.bits(k, shape))(k)
    np.testing.assert_array_equal(np.asarray(want), _u32(tr.bits(kt, shape)))


@pytest.mark.parametrize("maxval", [1.0, 200.0, 2 * math.pi])
@pytest.mark.parametrize("shape", [(), (7,), (200, 2), (3, 5, 7)])
@pytest.mark.parametrize("seed", [0, 11])
def test_uniform(seed, shape, maxval):
    k, kt = _key(seed)
    want = np.asarray(jax.jit(
        lambda k: jax.random.uniform(k, shape, maxval=maxval))(k))
    got = tr.uniform(kt, shape, maxval=maxval).numpy()
    assert got.dtype == np.float32 and got.shape == want.shape
    np.testing.assert_array_equal(want.view(np.uint32), got.view(np.uint32))


@pytest.mark.parametrize("minval,maxval", [(-3.0, 5.5), (0.1, 0.7),
                                           (10.0, 200.0)])
def test_uniform_scale_is_one_fma(minval, maxval):
    """``f * (max - min) + min`` with a nonzero ``min``: the port rounds it
    once, as the jitted draw does."""
    k, kt = _key(5)
    want = np.asarray(jax.jit(lambda k: jax.random.uniform(
        k, (4096,), minval=minval, maxval=maxval))(k))
    got = tr.uniform(kt, (4096,), minval=minval, maxval=maxval).numpy()
    np.testing.assert_array_equal(want.view(np.uint32), got.view(np.uint32))


def test_batched_keys_match_vmap():
    keys = jax.random.split(jax.random.PRNGKey(3), 4)
    keys_t = torch.from_numpy(np.asarray(keys).astype(np.int64))
    want = jax.jit(jax.vmap(lambda k: jax.random.uniform(k, (5, 3))))(keys)
    np.testing.assert_array_equal(np.asarray(want),
                                  tr.uniform(keys_t, (5, 3)).numpy())
    want = jax.jit(jax.vmap(lambda k: jax.random.split(k, 5)))(keys)
    np.testing.assert_array_equal(np.asarray(want), _u32(tr.split(keys_t, 5)))


@pytest.mark.parametrize("shape", [(), (7,), (200, 8, 16), (3, 5, 7),
                                   (300_000,)])
@pytest.mark.parametrize("seed", [0, 11, 2**31 - 1])
def test_normal(seed, shape):
    """``normal`` = ``sqrt(2) * erf_inv(u)`` with XLA's float32 ``erf_inv``
    and ``log1p`` written out: bit for bit, also in the far tails."""
    k, kt = _key(seed)
    want = np.asarray(jax.jit(lambda k: jax.random.normal(k, shape))(k))
    got = tr.normal(kt, shape).numpy()
    assert got.dtype == np.float32 and got.shape == want.shape
    np.testing.assert_array_equal(want.view(np.uint32), got.view(np.uint32))


def test_normal_batched_keys_match_vmap():
    keys = jax.random.split(jax.random.PRNGKey(9), 6)
    keys_t = torch.from_numpy(np.asarray(keys).astype(np.int64))
    want = jax.jit(jax.vmap(lambda k: jax.random.normal(k, (40, 3))))(keys)
    np.testing.assert_array_equal(np.asarray(want).view(np.uint32),
                                  tr.normal(keys_t, (40, 3)).numpy()
                                  .view(np.uint32))


def _grid():
    rng = np.random.default_rng(0)
    u = rng.uniform(-1, 1, 400_000).astype(np.float32)
    edge = np.nextafter(np.float32(1), np.float32(0)) - np.arange(
        2000, dtype=np.float32) * np.float32(2**-24)
    return np.concatenate([u, edge, -edge, np.float32([0.0, -0.0])])


def test_log1p32_and_erfinv32_equal_jitted_xla():
    from repro_torch.numerics import erfinv32, log1p32

    u = _grid()
    arg = -(u * u)
    wide = np.random.default_rng(1).uniform(-0.999, 60, 200_000).astype(
        np.float32)
    for x in (arg, wide):
        want = np.asarray(jax.jit(jax.numpy.log1p)(x))
        got = log1p32(torch.from_numpy(x)).numpy()
        np.testing.assert_array_equal(want.view(np.uint32),
                                      got.view(np.uint32))
    want = np.asarray(jax.jit(jax.lax.erf_inv)(u))
    got = erfinv32(torch.from_numpy(u)).numpy()
    np.testing.assert_array_equal(want.view(np.uint32), got.view(np.uint32))
    # torch's own erfinv is another approximation: it would not do
    own = torch.erfinv(torch.from_numpy(u)).numpy()
    assert np.mean(own.view(np.uint32) == want.view(np.uint32)) < 0.6
