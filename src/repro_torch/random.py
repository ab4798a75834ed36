"""Bit-exact port of the ``jax.random`` draws the simulator makes.

JAX's default PRNG is threefry2x32 in *partitionable* mode: every draw
hashes a 64-bit counter (the flat element index, split into a high and a
low uint32 word) under the key, so a draw of any shape is one vectorized
hash and no sequential state exists. This module reproduces that scheme
bit for bit:

* ``PRNGKey(seed)``      -> ``(..., 2)`` key ``[seed >> 32, seed & 0xFFFFFFFF]``;
* ``split(key, n)``      -> the hash of counters ``(0, i)``, ``i < n``;
* ``fold_in(key, data)`` -> the hash of counter ``(0, data)``;
* ``bits(key, shape)``   -> the XOR of the two hash words at each counter;
* ``uniform``            -> ``bits >> 9`` as the mantissa of ``[1, 2)``,
  minus 1, scaled into ``[minval, maxval)``;
* ``bernoulli``          -> ``uniform(key, shape) < p``, ``p`` in float32;
* ``randint``            -> two 32-bit draws (from a split of the key)
  folded into ``[minval, maxval)`` by JAX's modular recipe;
* ``normal``             -> ``sqrt(2) * erf_inv(u)`` of a uniform ``u`` in
  ``(-1, 1)``, with XLA's float32 ``erf_inv`` and ``log1p`` written out
  (:mod:`repro_torch.numerics`).

Keys are int64 tensors holding uint32 values in their trailing axis of 2;
any leading axes are a batch of keys, and every function maps over them
(a draw of ``shape`` from keys ``(B, 2)`` has shape ``(B, *shape)``).
int64 keeps the 32-bit wraparound explicit (``& 0xFFFFFFFF``) on every
device: torch has no unsigned 32-bit arithmetic on the CPU.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from repro_torch.numerics import erfinv32

__all__ = ["PRNGKey", "split", "fold_in", "bits", "uniform", "bernoulli",
           "randint", "normal", "erf_inv_draw", "SQRT2"]

_MASK = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))


def _rotl(x: torch.Tensor, r: int) -> torch.Tensor:
    return ((x << r) & _MASK) | (x >> (32 - r))


def threefry2x32(k0, k1, x0, x1):
    """The Threefry-2x32 hash (20 rounds) of counter words ``(x0, x1)``
    under key words ``(k0, k1)``; all int64 holding uint32, broadcast."""
    ks = (k0, k1, k0 ^ k1 ^ 0x1BD11BDA)
    x0 = (x0 + ks[0]) & _MASK
    x1 = (x1 + ks[1]) & _MASK
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = (x0 + x1) & _MASK
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & _MASK
        x1 = (x1 + ks[(i + 2) % 3] + (i + 1)) & _MASK
    return x0, x1


def PRNGKey(seed: int, device=None) -> torch.Tensor:
    """``jax.random.PRNGKey(seed)`` as a ``(2,)`` int64 key."""
    seed = int(seed)
    return torch.tensor([(seed >> 32) & _MASK, seed & _MASK],
                        dtype=torch.int64, device=device)


def _hash_counts(key: torch.Tensor, lo: torch.Tensor):
    """Hash counters ``(0, lo)`` under every key: ``(*key.shape[:-1],
    *lo.shape)`` pairs of words."""
    shape = (*key.shape[:-1], *([1] * lo.dim()))
    k0 = key[..., 0].reshape(shape)
    k1 = key[..., 1].reshape(shape)
    return threefry2x32(k0, k1, torch.zeros_like(lo), lo)


def split(key: torch.Tensor, num: int = 2) -> torch.Tensor:
    """``jax.random.split``: ``(..., num, 2)`` new keys."""
    lo = torch.arange(num, dtype=torch.int64, device=key.device)
    b0, b1 = _hash_counts(key, lo)
    return torch.stack([b0, b1], dim=-1)


def fold_in(key: torch.Tensor, data) -> torch.Tensor:
    """``jax.random.fold_in``: mix the uint32 ``data`` into the key.

    ``data`` may be a tensor: the result then has the keys' leading axes
    followed by ``data``'s (``jax.vmap`` over data)."""
    data = torch.as_tensor(data, device=key.device).to(torch.int64) & _MASK
    b0, b1 = _hash_counts(key, data)
    return torch.stack([b0, b1], dim=-1)


def bits(key: torch.Tensor, shape=()) -> torch.Tensor:
    """The raw 32-bit draw (``jax.random.bits``) as int64 in [0, 2³²)."""
    shape = tuple(shape)
    n = math.prod(shape)
    lo = torch.arange(n, dtype=torch.int64, device=key.device).reshape(shape)
    b0, b1 = _hash_counts(key, lo)
    return b0 ^ b1


def uniform(key: torch.Tensor, shape=(), minval: float = 0.0,
            maxval: float = 1.0) -> torch.Tensor:
    """``jax.random.uniform`` in float32.

    The scale ``f * (max - min) + min`` is one fused multiply-add, as the
    jitted JAX draw computes it: the float32 product is exact in float64,
    so adding and rounding once to float32 reproduces the FMA (double
    rounding could differ only when the float64 sum lands exactly halfway
    between two float32 values; with ``minval = 0`` the product alone is
    rounded and the two forms are identical)."""
    mant = (bits(key, shape) >> 9) | 0x3F800000        # [1, 2) bit pattern
    f = mant.to(torch.int32).view(torch.float32) - 1.0
    lo = float(np.float32(minval))
    span = float(np.float32(np.float32(maxval) - np.float32(lo)))
    out = (f.double() * span + lo).float()
    return torch.clamp(out, min=lo)


def bernoulli(key: torch.Tensor, p: float = 0.5, shape=()) -> torch.Tensor:
    """``jax.random.bernoulli`` (its default ``mode="low"``): a float32
    uniform draw below ``p``, the probability rounded to float32."""
    return uniform(key, shape) < float(np.float32(p))


_I32_MIN, _I32_MAX = -2**31, 2**31 - 1


def _mul32(a: torch.Tensor, m: int) -> torch.Tensor:
    """``(a * m) mod 2³²`` for ``a`` and ``m`` below 2³², in int64 halves
    that never overflow."""
    lo = a * (m & 0xFFFF)
    hi = ((a * (m >> 16)) & 0xFFFF) << 16
    return (lo + hi) & _MASK


def randint(key: torch.Tensor, shape, minval: int, maxval: int) -> torch.Tensor:
    """``jax.random.randint`` into int32, for scalar int32 bounds.

    JAX splits the key in two and draws 32 bits from each (``hi``, then
    ``lo``). With ``span = maxval - minval`` as uint32 (1 where ``maxval
    <= minval``) and ``mult = (2¹⁶ % span)² % span`` it returns ``minval +
    ((hi % span) * mult + lo % span) % span``, every product and sum
    wrapping as uint32 does (so ``mult`` is 0 for every span above 2¹⁶),
    and the sum with ``minval`` as int32 does.
    Computed in int64 and masked back to 32 bits."""
    shape = tuple(shape)
    minval, maxval = int(minval), int(maxval)
    if not (_I32_MIN <= minval <= _I32_MAX and _I32_MIN <= maxval <= _I32_MAX):
        raise ValueError(f"randint: bounds ({minval}, {maxval}) outside int32")
    span = 1 if maxval <= minval else (maxval - minval) & _MASK
    mult = ((2**16 % span) ** 2 & _MASK) % span
    k1, k2 = split(key, 2).unbind(-2)
    offset = (_mul32(bits(k1, shape) % span, mult)
              + bits(k2, shape) % span) & _MASK
    offset = offset % span
    out = (offset + minval - _I32_MIN) % 2**32 + _I32_MIN    # int32 wrap
    return out.to(torch.int32)


_NORMAL_LO = float(np.nextafter(np.float32(-1.0), np.float32(0.0)))
#: float32 sqrt(2), the last factor of :func:`normal`.
SQRT2 = float(np.float32(np.sqrt(2.0)))


def erf_inv_draw(key: torch.Tensor, shape=()) -> torch.Tensor:
    """:func:`normal`'s draw before its product with ``SQRT2``: float32
    ``erf_inv(u)``, ``u`` uniform in ``[nextafter(-1, 0), 1)``. Jitted XLA
    folds a constant factor ``c`` of a normal draw into that product, so
    there ``c * normal(key)`` is ``(c * SQRT2) * erf_inv_draw(key)``."""
    return erfinv32(uniform(key, shape, minval=_NORMAL_LO))


def normal(key: torch.Tensor, shape=()) -> torch.Tensor:
    """``jax.random.normal`` in float32: ``sqrt(2) * erf_inv(u)`` with ``u``
    uniform in ``[nextafter(-1, 0), 1)``."""
    return SQRT2 * erf_inv_draw(key, shape)
