"""Float32 arithmetic written out the way jitted XLA computes it.

XLA contracts ``a*b + c`` into one fused multiply-add under ``jit``, and
plain torch does not, so the two round differently on a share of inputs
(about 1 in 6 squared distances). Every multiply-add on the simulator's
discrete paths is therefore written as :func:`fma32`, in the operand
order the reference contracts it.
"""

from __future__ import annotations

import torch

__all__ = ["fma32"]


def fma32(a: torch.Tensor, b, c) -> torch.Tensor:
    """``a * b + c`` rounded once to float32, from float32 operands.

    The product of two float32 values is exact in float64, so one float64
    add and one rounding to float32 give the FMA. Double rounding can
    differ from a true FMA only when the float64 sum lands exactly halfway
    between two float32 values while the exact sum does not; the tests
    comparing against the reference would show such a case."""
    a = a.double() if torch.is_tensor(a) else float(a)
    b = b.double() if torch.is_tensor(b) else float(b)
    c = c.double() if torch.is_tensor(c) else float(c)
    return (a * b + c).float()
