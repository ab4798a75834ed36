"""The Floating Gossip system parameters (``FGParams``).

Only the parameter record is ported in this slice; the Lemma 1-3 fixed
point and its solvers come with the analytics.
"""

from __future__ import annotations

import dataclasses
from typing import Any

from repro_torch.core.zones import ZoneSet

__all__ = ["FGParams"]


@dataclasses.dataclass(frozen=True)
class FGParams:
    """Static parameters of a Floating Gossip system (paper §III-C)."""

    N: float            # mean nodes in RZ
    alpha: float        # RZ entry/exit rate [1/s]
    lam: float          # per-model observation rate λ [1/s]
    Lam: float          # simultaneous observers Λ (1 <= Λ <= W)
    M: int              # number of models
    W: int              # per-node model cap
    T_T: float          # training service time [s]
    T_M: float          # merging service time [s]
    t0: float           # connection setup time [s]
    L: float            # model size [bits]
    C: float            # D2D channel rate [bits/s]
    k: float            # coefficients-per-bit constant (capacity L/k)
    tau_l: float        # observation lifetime [s]
    zones: ZoneSet | None = None   # optional multi-zone RZ geometry
    faults: Any = None             # optional fault configuration

    @property
    def w(self) -> float:
        return min(self.W / self.M, 1.0)

    @property
    def T_L(self) -> float:
        # Bidirectional exchange of one instance (paper: 10 kb @ 10 Mb/s = 2 ms).
        return 2.0 * self.L / self.C

    @property
    def sojourn(self) -> float:
        """Mean RZ sojourn time t* = N / alpha (Little's law)."""
        return self.N / self.alpha

    def replace(self, **kw) -> "FGParams":
        return dataclasses.replace(self, **kw)
