"""Replication-Zone geometry (port of ``repro.core.zones``): the
``ZoneSet`` record and the migration-rate matrix that couples the per-zone
mean-field models.

A ``ZoneSet`` describes ``k`` disc Replication Zones with per-zone centers
and radii plus an optional per-zone drift velocity. A node is a member of
every zone whose disc contains it; protocol state is dropped when a node
leaves the union of all zones (crossing from one zone into another
transfers it); two nodes may exchange only if they share a zone. Plain
tuples keep the record hashable.

:func:`migration_rate_matrix` derives the coupling from the paper's
boundary-flux argument (``alpha = D v P / pi``): off the diagonal, ``R[z,
z'] = D v_eff / pi`` times the length of zone ``z``'s boundary arc that
lies inside zone ``z'`` (the movers that stay members of ``z'``); on it,
the total exit rate ``2 D v_eff r_z``. A drifting zone sees nodes at the
mean relative speed ``E|v - u|`` (:func:`mean_relative_speed`); the
overlaps are measured at the zone positions of time ``t``. Everything here
is float64 numpy and ``math``, the reference's arithmetic in its order.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np

__all__ = [
    "ZoneSet",
    "single_zone",
    "mean_relative_speed",
    "migration_rate_matrix",
    "lens_area",
    "union_area",
]

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


def mean_relative_speed(v: float, u: float, n_theta: int = 720) -> float:
    """``E|v - u|`` for node speed ``v`` with isotropic heading against a
    frame translating at speed ``u``: ``(1/2pi) int sqrt(v^2 + u^2 - 2 v u
    cos t) dt`` by the midpoint rule (exactly ``v`` at ``u = 0``)."""
    if u == 0.0:
        return float(v)
    theta = (np.arange(n_theta) + 0.5) * (2.0 * math.pi / n_theta)
    return float(
        np.mean(np.sqrt(v * v + u * u - 2.0 * v * u * np.cos(theta)))
    )


def lens_area(c1, r1, c2, r2) -> float:
    """Intersection area of two discs (0 when disjoint)."""
    d = math.hypot(c1[0] - c2[0], c1[1] - c2[1])
    if d >= r1 + r2:
        return 0.0
    if d <= abs(r1 - r2):
        rm = min(r1, r2)
        return math.pi * rm * rm
    a1 = math.acos((d * d + r1 * r1 - r2 * r2) / (2 * d * r1))
    a2 = math.acos((d * d + r2 * r2 - r1 * r1) / (2 * d * r2))
    return (r1 * r1 * (a1 - math.sin(2 * a1) / 2)
            + r2 * r2 * (a2 - math.sin(2 * a2) / 2))


def union_area(centers: np.ndarray, radii: np.ndarray) -> float:
    """Area of the union of discs by pairwise inclusion-exclusion (triple
    overlaps are ignored: a lower bound on the union)."""
    area = float(np.sum(np.pi * np.asarray(radii) ** 2))
    for i in range(len(radii)):
        for j in range(i + 1, len(radii)):
            area -= lens_area(centers[i], radii[i], centers[j], radii[j])
    return area


def _arc_inside(c_z, r_z, c_o, r_o) -> float:
    """Length of the boundary arc of disc ``z`` lying inside disc ``o``."""
    d = math.hypot(c_z[0] - c_o[0], c_z[1] - c_o[1])
    if d >= r_z + r_o:                       # disjoint (touching = measure 0)
        return 0.0
    if d + r_z <= r_o:                       # z contained in o
        return 2.0 * math.pi * r_z
    if d + r_o <= r_z:                       # o contained in z: boundary of z
        return 0.0                           # is entirely outside o
    cos_t = (d * d + r_z * r_z - r_o * r_o) / (2.0 * d * r_z)
    theta = math.acos(min(1.0, max(-1.0, cos_t)))
    return 2.0 * theta * r_z


def migration_rate_matrix(
    zones: ZoneSet,
    *,
    density: float,
    speed: float,
    t: float = 0.0,
    area_side: float | None = None,
) -> np.ndarray:
    """(k, k) inter-zone migration and exit rate matrix [nodes/s].

    Off the diagonal ``R[z, z']``: the rate of nodes crossing out of zone
    ``z`` through the part of its boundary covered by zone ``z'`` (they
    stay members of ``z'``: their state transfers). On the diagonal the
    total exit rate of zone ``z``. ``t`` and ``area_side`` place drifting
    zones before the overlaps are measured (ignored for static sets)."""
    k = zones.k
    centers = (
        zones.centers_at(t, area_side)
        if zones.moving and area_side is not None
        else np.asarray(zones.centers, dtype=np.float64)
    )
    radii = np.asarray(zones.radii, dtype=np.float64)
    v_eff = np.asarray(
        [mean_relative_speed(speed, u) for u in zones.drift_speeds()]
    )
    R = np.zeros((k, k))
    for z in range(k):
        flux = density * v_eff[z] / math.pi          # per unit arc length
        R[z, z] = flux * 2.0 * math.pi * radii[z]    # = 2 D v_eff r_z
        for o in range(k):
            if o != z:
                R[z, o] = flux * _arc_inside(
                    centers[z], radii[z], centers[o], radii[o]
                )
    return R
