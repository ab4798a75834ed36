"""Float32 arithmetic written out the way jitted XLA computes it.

XLA contracts ``a*b + c`` into one fused multiply-add under ``jit``, and
plain torch does not, so the two round differently on a share of inputs
(about 1 in 6 squared distances). Every multiply-add on the simulator's
discrete paths is therefore written as :func:`fma32`, in the operand
order the reference contracts it.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["fma32", "log32", "log1p32", "erfinv32", "row_sum32", "mean32",
           "linspace32", "sqrt32"]


def fma32(a: torch.Tensor, b, c) -> torch.Tensor:
    """``a * b + c`` rounded once to float32, from float32 operands.

    The product of two float32 values is exact in float64. The float64
    sum ``s = p + c`` is rounded to odd before it is narrowed: where the
    sum was inexact (its TwoSum error ``e`` is not 0) and its last mantissa
    bit is 0, it steps one float64 ulp toward ``e``. A float64 value
    rounded to odd keeps enough bits that rounding it to float32 gives the
    correctly rounded exact sum, so the result is a true FMA; a plain
    float64 add would round twice, and land one float32 ulp off where the
    sum falls exactly halfway between two float32 values."""
    a = a.double() if torch.is_tensor(a) else float(a)
    b = b.double() if torch.is_tensor(b) else float(b)
    c = c.double() if torch.is_tensor(c) else float(c)
    p = a * b
    s = p + c
    bp = s - p
    e = (p - (s - bp)) + (c - bp)
    even = (s.view(torch.int64) & 1) == 0
    step = (e != 0) & even & torch.isfinite(s)
    toward = torch.where(e > 0, float("inf"), float("-inf"))
    return torch.where(step, torch.nextafter(s, toward), s).float()


def _f32(v: float) -> float:
    return float(np.float32(v))


# XLA's CPU ``log`` (a Cephes-style polynomial on the mantissa in
# [sqrt(1/2), sqrt(2)), as float32 constants) and ``log1p``'s rational
# approximation for small arguments, in the order its fused loop evaluates
# them.
_LOG_Q = tuple(_f32(v) for v in (
    0.07037683576345444, -0.11514610052108765, -0.12420140951871872,
    0.14249323308467865, 0.2000071406364441, -0.24999994039535522,
    0.11676998436450958, -0.16668057441711426, 0.3333333134651184))
_LOG_C1, _LOG_C2 = _f32(-0.00021219444170128554), 0.693359375
_SQRT_HALF = _f32(0.7071067690849304)
_LOG1P_SMALL = _f32(0.4142135679721832)        # sqrt(2) - 1
_LOG1P_DEN = tuple(_f32(v) for v in (
    15.062909126281738, 83.04756927490234, 221.7624053955078,
    309.0987243652344, 216.42788696289062, 60.11865997314453))
_LOG1P_NUM = tuple(_f32(v) for v in (
    4.527000055531971e-05, 0.4985410273075104, 6.578732490539551,
    29.91191864013672, 60.949668884277344, 57.11296463012695,
    20.039552688598633))
_FLT_MIN = _f32(1.17549435e-38)


def log32(a: torch.Tensor) -> torch.Tensor:
    """float32 ``log(a)`` bit for bit as jitted (or eager) ``jnp.log``
    computes it on the CPU (``torch.log`` differs on about 0.7% of normal
    inputs). Written in float32 and :func:`fma32`, so the card computes
    the same bits."""
    m = torch.clamp(a, min=_FLT_MIN)
    bits = m.view(torch.int32)
    mant = ((bits & 0x7FFFFF) | 0x3F000000).view(torch.float32)
    e = ((bits >> 23) - 127).float() + 1.0
    lt = mant < _SQRT_HALF
    e = e - lt.float()
    r = (mant - 1.0) + torch.where(lt, mant, 0.0)
    z = r * r
    r3 = z * r
    q = _LOG_Q
    y0 = fma32(fma32(r, q[0], q[1]), r, q[6])
    y1 = fma32(fma32(r, q[2], q[3]), r, q[7])
    y2 = fma32(fma32(r, q[4], q[5]), r, q[8])
    y = fma32(fma32(y0, r3, y1), r3, y2)
    y = fma32(y, r3, e * _LOG_C1)
    out = fma32(e, _LOG_C2, fma32(-z, 0.5, r) + y)
    out = torch.where(a < 0, float("nan"), out)
    out = torch.where(a == 0, float("-inf"), out)
    return torch.where(a == float("inf"), float("inf"), out)


def log1p32(x: torch.Tensor) -> torch.Tensor:
    """float32 ``log1p(x)`` bit for bit as jitted XLA computes it on the
    CPU: a rational approximation for ``|x| < sqrt(2) - 1``, else
    ``log(1 + x)``, each multiply-add contracted as XLA's loop does."""
    big = log32(x + 1.0)
    x2 = x * x
    den = x + _LOG1P_DEN[0]
    for c in _LOG1P_DEN[1:]:
        den = fma32(den, x, c)
    num = fma32(x, _LOG1P_NUM[0], _LOG1P_NUM[1])
    for c in _LOG1P_NUM[2:]:
        num = fma32(num, x, c)
    small = x + fma32(x2, -0.5, (x * x2) * (num / den))
    return torch.where(x.abs() < _LOG1P_SMALL, small, big)


# XLA's ErfInv32 (Giles' single-precision approximation): two 9-term
# Horner polynomials in w = -log1p(-x²), split at w < 5.
_ERFINV_LT5 = tuple(_f32(v) for v in (
    2.81022636e-08, 3.43273939e-07, -3.5233877e-06, -4.39150654e-06,
    0.00021858087, -0.00125372503, -0.00417768164, 0.246640727,
    1.50140941))
_ERFINV_GE5 = tuple(_f32(v) for v in (
    -0.000200214257, 0.000100950558, 0.00134934322, -0.00367342844,
    0.00573950773, -0.0076224613, 0.00943887047, 1.00167406, 2.83297682))


def erfinv32(x: torch.Tensor) -> torch.Tensor:
    """float32 ``erf_inv(x)`` bit for bit as jitted XLA computes it on the
    CPU (``torch.erfinv`` is another approximation and agrees on fewer
    than half of the inputs)."""
    w = -log1p32(-(x * x))
    lt = w < 5.0
    dev = x.device
    lo = torch.tensor(_ERFINV_LT5, dtype=torch.float32, device=dev)
    hi = torch.tensor(_ERFINV_GE5, dtype=torch.float32, device=dev)
    coef = torch.where(lt[..., None], lo, hi)
    # torch's vectorized float32 sqrt on the CPU is off by an ulp on some
    # inputs; the float64 root rounded to float32 is correctly rounded
    w = torch.where(lt, w - 2.5, torch.sqrt(w.double()).float() - 3.0)
    p = coef[..., 0]
    for i in range(1, len(_ERFINV_LT5)):
        p = fma32(p, w, coef[..., i])
    return torch.where(x.abs() == 1.0, x * float("inf"), p * x)


def _sequential_sum(x: torch.Tensor) -> torch.Tensor:
    acc = x[..., 0]
    for d in range(1, x.shape[-1]):
        acc = acc + x[..., d]
    return acc


def row_sum32(x: torch.Tensor, window: int = 32) -> torch.Tensor:
    """float32 sum over the last axis in jitted XLA's CPU order.

    XLA rewrites a reduction longer than ``window`` into a reduce-window
    over zero-padded windows of ``window`` elements (the padding split
    evenly, the odd one high), each summed in order, then reduces the
    window sums the same way. Sums of at most ``window`` elements are
    taken in order here; XLA's own loop for those may contract a fused
    product into the sum, so only lengths above ``window`` are pinned."""
    d = x.shape[-1]
    if d <= window:
        return _sequential_sum(x)
    k = -(-d // window)
    lo = (k * window - d) // 2
    padded = torch.nn.functional.pad(x, (lo, k * window - d - lo))
    return row_sum32(
        _sequential_sum(padded.reshape(*x.shape[:-1], k, window)), window)


def mean32(x: torch.Tensor) -> torch.Tensor:
    """Mean over the last axis as jitted XLA takes it: the sum times the
    float32-rounded ``1/n`` (not the sum divided by ``n``)."""
    return x.sum(-1) * float(np.float32(1.0 / x.shape[-1]))


def linspace32(start: float, stop: float, n: int,
               device=None) -> torch.Tensor:
    """float32 ``jnp.linspace(start, stop, n)`` as JAX computes it when
    called (``start`` and ``stop`` traced into its jitted body): with
    ``r = float32(1 / (n - 1))``, element ``i < n - 1`` is ``fma(i, stop *
    r, start * (1 - i * r))``, each product rounded to float32, and the
    last is ``stop``. ``torch.linspace`` differs at n = 16 and 24. Pinned
    for n <= 352: above that XLA's CPU loop contracts ``1 - i * r`` too,
    on some lengths."""
    start, stop = _f32(start), _f32(stop)
    if n <= 1:
        return torch.full((max(n, 0),), start, dtype=torch.float32,
                          device=device)
    r = _f32(np.float32(1.0) / np.float32(n - 1))
    i = torch.arange(n - 1, dtype=torch.float32, device=device)
    head = fma32(i, _f32(np.float32(stop) * np.float32(r)),
                 (1.0 - i * r) * start)
    return torch.cat([head, torch.full((1,), stop, dtype=torch.float32,
                                       device=device)])


def sqrt32(x: torch.Tensor) -> torch.Tensor:
    """The correctly rounded float32 square root on either device: the
    float64 root rounded to float32 (the CPU's vectorized float32 root is
    an ulp off on some inputs, the scalar one is not)."""
    return torch.sqrt(x.double()).float()
