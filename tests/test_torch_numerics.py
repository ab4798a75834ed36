"""``repro_torch.numerics.linspace32`` and ``log32`` against JAX, bit for bit
(tolerance: none). ``init_mamba`` sets ``A_log = log(linspace(1, 16, H))``
in float32, where ``torch.linspace`` and ``torch.log`` each differ from
JAX on some entries.

``log32`` is held to jitted ``jnp.log`` over 2,000,000 float32 inputs
spanning every normal exponent. Subnormal inputs are left out: XLA's CPU
code flushes them to zero (``log`` gives -inf), torch keeps them.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro_torch.numerics import linspace32, log32


@pytest.fixture(autouse=True)
def one_torch_thread():
    """The suite runs several test processes on the machine's cores; torch's
    intra-op threads in each would contend for them (the results do not
    depend on the thread count)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _bits(x) -> np.ndarray:
    return np.asarray(x, np.float32).view(np.int32)


@pytest.mark.parametrize("start,stop", [(1.0, 16.0), (0.5, 2.0)])
@pytest.mark.parametrize("n", [4, 16, 24, 48, 128])
def test_linspace32_equals_jnp_linspace(start, stop, n):
    got = linspace32(start, stop, n)
    assert got.dtype == torch.float32 and tuple(got.shape) == (n,)
    np.testing.assert_array_equal(_bits(got.numpy()),
                                  _bits(jnp.linspace(start, stop, n)))


def test_linspace32_short_and_where_torch_differs():
    for n in (0, 1, 2):
        np.testing.assert_array_equal(_bits(linspace32(1.0, 16.0, n).numpy()),
                                      _bits(jnp.linspace(1.0, 16.0, n)))
    want = np.asarray(jnp.linspace(1.0, 16.0, 24))
    assert not np.array_equal(_bits(torch.linspace(1, 16, 24).numpy()),
                              _bits(want))


@pytest.mark.parametrize("n", [4, 16, 24, 48, 128])
def test_log32_of_the_mamba_decay_grid(n):
    """``A_log`` as ``init_mamba`` computes it."""
    got = log32(linspace32(1.0, 16.0, n)).numpy()
    want = jnp.log(jnp.linspace(1.0, 16.0, n))
    np.testing.assert_array_equal(_bits(got), _bits(want))


@pytest.mark.parametrize("seed", [0, 1])
def test_log32_over_normal_inputs(seed):
    """2,000,000 inputs (1,000,000 a seed): every positive normal exponent,
    uniform mantissas; ``torch.log`` differs on about 0.7% of them."""
    rng = np.random.default_rng(seed)
    x = rng.integers(0x00800000, 0x7F800000, 1_000_000,
                     dtype=np.int64).astype(np.int32).view(np.float32)
    want = jax.jit(jnp.log)(x)
    np.testing.assert_array_equal(_bits(log32(torch.from_numpy(x)).numpy()),
                                  _bits(want))


def test_log32_special_values():
    x = np.array([0.0, -0.0, -1.0, 1.0, np.inf, np.float32(1.1754944e-38),
                  np.float32(3.4028235e38)], np.float32)
    got = log32(torch.from_numpy(x)).numpy()
    want = np.asarray(jax.jit(jnp.log)(x))
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    keep = ~np.isnan(want)
    np.testing.assert_array_equal(_bits(got[keep]), _bits(want[keep]))
