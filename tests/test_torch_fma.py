"""``repro_torch.numerics.fma32`` against jitted JAX ``a*b + c``, which XLA
contracts into one fused multiply-add, bit for bit (tolerance: none).

A float64 add rounded to float32 rounds twice, and lands one float32 ulp
off where the float64 sum falls exactly halfway between two float32 values
while the exact sum does not. ``fma32`` rounds the float64 sum to odd
first, so it rounds once. The halfway-prone inputs below are built to hit
that case: ``a`` and ``b`` with 13 significant bits, whose product has 25
and so sits on a float32 midpoint, and ``|c| < 2**-60``, below half a
float64 ulp of the product. Results below the smallest normal float32 are
left out: XLA's CPU code flushes them to zero, torch keeps them.
"""

import jax
import numpy as np
import pytest
import torch

from repro_torch.numerics import fma32


@pytest.fixture(autouse=True)
def one_torch_thread():
    """The suite runs several test processes on the machine's cores; torch's
    intra-op threads in each would contend for them (the results do not
    depend on the thread count)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


_JIT_FMA = jax.jit(lambda a, b, c: a * b + c)


def _halfway_prone(n: int, seed: int):
    rng = np.random.default_rng(seed)

    def mant13():
        return (rng.integers(1 << 12, 1 << 13, n).astype(np.float32)
                / np.float32(1 << 12))

    sign = np.where(rng.random(n) < 0.5, -1, 1).astype(np.float32)
    a = mant13() * np.float32(2.0) ** rng.integers(-4, 5, n).astype(
        np.float32) * sign
    b = mant13()
    c = (rng.uniform(-1, 1, n) * 2.0 ** -60).astype(np.float32)
    return a, b, c


def _fma(a, b, c) -> np.ndarray:
    return fma32(*(torch.from_numpy(x) for x in (a, b, c))).numpy()


def _bits(x) -> np.ndarray:
    return np.asarray(x, np.float32).view(np.int32)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_halfway_prone_inputs_round_once(seed):
    a, b, c = _halfway_prone(200_000, seed)
    want = np.asarray(_JIT_FMA(a, b, c))
    np.testing.assert_array_equal(_bits(_fma(a, b, c)), _bits(want))
    # rounding the float64 sum directly misses on a large share of them
    twice = (a.astype(np.float64) * b + c).astype(np.float32)
    assert np.mean(_bits(twice) != _bits(want)) > 0.05


def test_the_recorded_case():
    """``a = b = 1 + 2**-12``, ``c = 2**-80``: the exact FMA is
    ``0x1.002002p+0``; rounding twice gave ``0x1.002p+0``."""
    a = np.array([1 + 2.0 ** -12], np.float32)
    c = np.array([2.0 ** -80], np.float32)
    got = float(_fma(a, a, c)[0])
    assert got.hex() == "0x1.0020020000000p+0"
    assert got == float(np.asarray(_JIT_FMA(a, a, c))[0])


@pytest.mark.parametrize("seed", [0, 1])
def test_squared_distance_inputs(seed):
    """d²-shaped inputs, ``fma(dx, dx, dy*dy)``: positions in a 200 m
    square, ``dy`` also scaled down by 1e-3."""
    rng = np.random.default_rng(seed)
    n = 500_000
    p = rng.uniform(0, 200, (4, n)).astype(np.float32)
    dx = p[0] - p[1]
    dy = (p[2] - p[3]) * np.float32(1e-3 if seed else 1.0)
    want = np.asarray(jax.jit(lambda x, y: x * x + y * y)(dx, dy))
    np.testing.assert_array_equal(_bits(_fma(dx, dx, dy * dy)), _bits(want))


def test_special_values_and_python_scalars():
    vals = np.array([0, -0.0, np.inf, -np.inf, np.nan, 3e38, -3e38, 1e20,
                     1.0, -1.0, 0.5, 2e-20, 1.5e-19, -7e-20, 1.2e-38, 1e-30],
                    np.float32)
    a, b, c = (x.ravel().copy() for x in np.meshgrid(vals, vals, vals,
                                                     indexing="ij"))
    want = np.asarray(_JIT_FMA(a, b, c))
    got = _fma(a, b, c)
    tiny = np.finfo(np.float32).tiny
    subnormal = ((got != 0) & (np.abs(got) < tiny)) | (
        (want != 0) & (np.abs(want) < tiny))
    keep = ~subnormal & ~np.isnan(want)
    assert np.isnan(got[np.isnan(want)]).all()
    np.testing.assert_array_equal(_bits(got[keep]), _bits(want[keep]))
    assert keep.sum() > 3000
    t = torch.from_numpy(a)
    np.testing.assert_array_equal(
        _bits(fma32(t, 0.5, 1.0).numpy()),
        _bits(np.asarray(_JIT_FMA(a, np.float32(0.5), np.float32(1.0)))))
