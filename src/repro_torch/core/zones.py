"""Replication-Zone geometry: the ``ZoneSet`` record.

A ``ZoneSet`` describes ``k`` disc Replication Zones with per-zone centers
and radii plus an optional per-zone drift velocity. A node is a member of
every zone whose disc contains it; protocol state is dropped when a node
leaves the union of all zones; two nodes may exchange only if they share
a zone. Plain tuples keep the record hashable. The inter-zone migration
analytics come with the analytics slice.
"""

from __future__ import annotations

import dataclasses

import numpy as np

__all__ = ["ZoneSet", "single_zone", "MAX_ZONES"]

#: Zone membership words are one uint32 bit per zone.
MAX_ZONES = 32


@dataclasses.dataclass(frozen=True)
class ZoneSet:
    """``k`` disc Replication Zones, optionally drifting."""

    centers: tuple[tuple[float, float], ...]   # (k, 2) disc centers [m]
    radii: tuple[float, ...]                   # (k,) disc radii [m]
    drift: tuple[tuple[float, float], ...] = ()  # (k, 2) velocities [m/s]

    def __post_init__(self):
        k = len(self.centers)
        if not 1 <= k <= MAX_ZONES:
            raise ValueError(f"need 1..{MAX_ZONES} zones, got {k}")
        if len(self.radii) != k:
            raise ValueError("centers and radii length mismatch")
        if self.drift and len(self.drift) != k:
            raise ValueError("drift must be empty or match the zone count")
        if any(r <= 0 for r in self.radii):
            raise ValueError("zone radii must be positive")

    @property
    def k(self) -> int:
        return len(self.centers)

    @property
    def moving(self) -> bool:
        """True iff any zone has a nonzero drift velocity."""
        return any(vx != 0.0 or vy != 0.0 for vx, vy in self.drift)

    def drift_speeds(self) -> np.ndarray:
        """(k,) drift speed magnitudes [m/s] (zeros when static)."""
        if not self.drift:
            return np.zeros(self.k)
        return np.hypot(*np.asarray(self.drift, dtype=np.float64).T)

    def centers_at(self, t: float, area_side: float) -> np.ndarray:
        """(k, 2) zone centers at time ``t``, reflected into the area
        (static sets return their centers verbatim)."""
        c = np.asarray(self.centers, dtype=np.float64)
        if not self.moving:
            return c
        u = np.asarray(self.drift, dtype=np.float64)
        m = np.mod(c + u * float(t), 2.0 * area_side)
        return area_side - np.abs(area_side - m)


def single_zone(center: tuple[float, float], radius: float) -> ZoneSet:
    """The paper's geometry: one static disc."""
    return ZoneSet(centers=(tuple(center),), radii=(float(radius),))
