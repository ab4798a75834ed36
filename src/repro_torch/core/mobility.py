"""Analytic contact statistics per mobility model (port of
``repro.core.mobility``).

The Floating Gossip analysis (Lemma 1) takes two mobility inputs: ``g``,
the mean contact rate each node observes, and ``f(t_c)``, the pdf of a
contact's duration. :class:`ContactModel` holds both, discretized, as
float32 tensors on one device; the solvers of
:mod:`repro_torch.core.meanfield` and :mod:`repro_torch.core.dde` compute
on that device.

``rdm`` — Random Direction with reflections (the paper's §VI model): two
nodes of speed ``v`` with independent uniform headings meet at mean
relative speed ``E|v_rel| = 4 v / pi`` (or by quadrature over U(lo, hi)
speeds), so ``g = 2 r_tx E|v_rel| D``; a contact crosses a chord of the
``r_tx`` disc with a uniform impact parameter at ``E|v_rel|``.

``rwp`` — Random Waypoint: the center-peaked stationary density raises the
pairwise meeting rate by ``RWP_DENSITY_FACTOR`` over rdm's; with a
waypoint pause the contacts mix move-move pairs (at ``4 v / pi``) and
move-pause pairs (at ``v``), weighted by the moving fraction of a leg of
mean length ``RWP_MEAN_LEG_FACTOR * area_side``.

``manhattan`` — movement on a street grid of spacing ``s``: head-on passes
on a shared street (linear density ``eta``; a point mass at ``r_tx / v``)
and crossings at intersections (the chord law at ``sqrt(2) v``).

The float32 steps are the reference's eager ones: its Python-float
factors meet float32 masses as float32 scalars, so every twin equals
``repro``'s arrays bit for bit on the CPU, apart from ``speed_range``'s
quadrature (in float64 here).

Device: the builders take ``device=None``, meaning ``cuda``; without a
card that raises, as :func:`repro_torch.sim.simulate` does, unless the
caller passes ``device="cpu"``.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.numerics import linspace32, row_sum32, sqrt32

__all__ = ["ContactModel", "rdm_contact_model", "rwp_contact_model",
           "manhattan_contact_model", "CONTACT_MODELS", "contact_model_for",
           "mean_relative_speed_uniform", "RWP_DENSITY_FACTOR",
           "RWP_MEAN_LEG_FACTOR"]

#: Pair-concentration factor of the RWP stationary density: a^2 ∫ f^2 with
#: the normalized polynomial approximation f = (36/a^6) x(a-x) y(a-y).
RWP_DENSITY_FACTOR = 1.44

#: Mean leg length between two uniform waypoints in a unit square (0.5214
#: a for side a): the mean move time of a leg is 0.5214 a / v.
RWP_MEAN_LEG_FACTOR = 0.5214


@dataclasses.dataclass(frozen=True)
class ContactModel:
    """Discretized contact-duration distribution plus the contact rate ``g``.

    ``t_grid`` are the centers of ``nt`` bins covering the support of
    ``f(t_c)``; ``pdf`` the densities there and ``weights`` the bin widths,
    so ``sum(pdf * weights) == 1``. All four are float32 tensors on one
    device (``g`` 0-d)."""

    g: torch.Tensor           # mean per-node contact rate [1/s]
    t_grid: torch.Tensor      # (nt,) contact durations [s]
    pdf: torch.Tensor         # (nt,) density values
    weights: torch.Tensor     # (nt,) quadrature weights [s]

    @property
    def device(self) -> torch.device:
        return self.t_grid.device

    @property
    def mean_duration(self) -> torch.Tensor:
        return row_sum32(self.t_grid * self.pdf * self.weights)

    def expect(self, fn) -> torch.Tensor:
        """E[fn(t_c)] under the discretized contact-duration pdf."""
        return row_sum32(fn(self.t_grid) * self.pdf * self.weights)


def _chord_cdf(t, v_rel: float, r_tx: float):
    """P(t_c <= t) for a chord crossed at speed ``v_rel`` with uniform
    impact parameter: 1 - sqrt(1 - (v_rel t / (2 r_tx))^2)."""
    x = torch.clamp(t * v_rel / (2.0 * r_tx), 0.0, 1.0)
    return 1.0 - sqrt32(torch.clamp(1.0 - x * x, 0.0, 1.0))


def _chord_bins(v_rel: float, r_tx: float, nt: int, device,
                t_max: float | None = None):
    """Bin (centers, widths, masses) of the chord-duration distribution.
    The density is integrable but unbounded at ``t_max``, so bins carry
    exact CDF masses rather than midpoint densities."""
    t_max = 2.0 * r_tx / v_rel if t_max is None else t_max
    edges = linspace32(0.0, t_max, nt + 1, device=device)
    centers = 0.5 * (edges[:-1] + edges[1:])
    widths = edges[1:] - edges[:-1]
    mass = (_chord_cdf(edges[1:], v_rel, r_tx)
            - _chord_cdf(edges[:-1], v_rel, r_tx))
    mass = mass / row_sum32(mass)
    return centers, widths, mass


def mean_relative_speed_uniform(lo: float, hi: float, nv: int = 96,
                                nth: int = 256) -> float:
    """E|v_rel| for two nodes with independent U(lo, hi) speeds and
    independent uniform headings, by midpoint quadrature over θ uniform
    on (0, π): ``|v_rel| = sqrt(v1² + v2² - 2 v1 v2 cos θ)``. At ``lo ==
    hi == v`` it converges to ``4 v / π``. A host number, computed in
    float64 (the reference's float32 mean of 2.4M terms rounds
    differently, in the seventh digit)."""
    v = (lo + (np.arange(nv) + 0.5) * (hi - lo) / nv if hi > lo
         else np.asarray([lo], np.float64))
    th = (np.arange(nth) + 0.5) * (math.pi / nth)
    v1, v2 = v[:, None, None], v[None, :, None]
    vr = np.sqrt(np.maximum(v1**2 + v2**2 - 2.0 * v1 * v2 * np.cos(th), 0.0))
    return float(vr.mean())


def rdm_contact_model(*, speed: float, r_tx: float, density: float,
                      speed_range: tuple | None = None, nt: int = 512,
                      device=None, **_geometry) -> ContactModel:
    """Analytic contact model for Random Direction mobility.

    Args:
      speed:   node speed ``v`` [m/s] (all nodes share it, as in the paper).
      r_tx:    transmission radius [m] (5 m in the paper's evaluation).
      density: node density ``D`` [nodes/m^2].
      speed_range: ``(lo, hi)``: per-node speeds i.i.d. U(lo, hi); the mean
        relative speed is then :func:`mean_relative_speed_uniform`'s.
      nt:      number of quadrature bins for ``f(t_c)``.
      device:  where the tensors live (default ``cuda``).
    """
    device = resolve_device(device, "rdm_contact_model")
    if speed_range is not None:
        v_rel = mean_relative_speed_uniform(*speed_range)
    else:
        v_rel = 4.0 * speed / math.pi
    g = 2.0 * r_tx * v_rel * density
    centers, widths, mass = _chord_bins(v_rel, r_tx, nt, device)
    return ContactModel(
        g=torch.tensor(g, dtype=torch.float32, device=device),
        t_grid=centers, pdf=mass / widths, weights=widths)


def _f32(v: float) -> float:
    return float(np.float32(v))


def _model(g: float, centers, widths, mass) -> ContactModel:
    return ContactModel(
        g=torch.tensor(g, dtype=torch.float32, device=centers.device),
        t_grid=centers, pdf=mass / widths, weights=widths)


def rwp_contact_model(*, speed: float, r_tx: float, density: float,
                      pause_s: float = 0.0, area_side: float | None = None,
                      nt: int = 512, device=None, **_geometry) -> ContactModel:
    """Analytic contact model for Random Waypoint mobility, with pause.

    With ``pause_s = 0``: rdm's chord law at ``4 v / pi`` and its rate
    times ``RWP_DENSITY_FACTOR``. With a constant waypoint pause each node
    moves a fraction ``p_m = T_move / (T_move + pause_s)`` of the time,
    ``T_move = RWP_MEAN_LEG_FACTOR * area_side / v`` (so ``area_side`` is
    required; ``ValueError`` without it): move-move pairs meet at rate
    ``p_m² RWP_DENSITY_FACTOR 2 r_tx (4v/pi) D``, move-pause pairs at
    ``2 p_m (1 - p_m) 2 r_tx v D`` (pauses sit at uniform waypoints), and
    the duration pdf is the rate-weighted mixture of the two chord laws,
    binned on the slower one's wider support. ``device`` as
    :func:`rdm_contact_model`'s."""
    device = resolve_device(device, "rwp_contact_model")
    v_mm = 4.0 * speed / math.pi
    if pause_s <= 0.0:
        g = RWP_DENSITY_FACTOR * 2.0 * r_tx * v_mm * density
        return _model(g, *_chord_bins(v_mm, r_tx, nt, device))
    if area_side is None:
        raise ValueError(
            "rwp_contact_model with pause_s > 0 needs area_side (the mean "
            "leg length sets the move/pause duty cycle)")
    t_move = RWP_MEAN_LEG_FACTOR * area_side / speed
    p_m = t_move / (t_move + pause_s)
    rate_mm = p_m**2 * RWP_DENSITY_FACTOR * 2.0 * r_tx * v_mm * density
    rate_mp = 2.0 * p_m * (1.0 - p_m) * 2.0 * r_tx * speed * density
    g = rate_mm + rate_mp
    w_mm = rate_mm / g
    t_max = 2.0 * r_tx / speed
    centers, widths, mass_mm = _chord_bins(v_mm, r_tx, nt, device,
                                           t_max=t_max)
    _, _, mass_mp = _chord_bins(speed, r_tx, nt, device, t_max=t_max)
    # the weights are Python floats meeting float32 masses: float32 scalars
    mass = _f32(w_mm) * mass_mm + _f32(1.0 - w_mm) * mass_mp
    return _model(g, centers, widths, mass)


def manhattan_contact_model(*, speed: float, r_tx: float, density: float,
                            street_spacing: float = 25.0,
                            area_side: float | None = None, nt: int = 512,
                            device=None, **_geometry) -> ContactModel:
    """Analytic contact model for Manhattan-grid mobility.

    Same-street encounters at rate ``eta v``, each a head-on pass of
    duration ``r_tx / v`` (a point mass, added to the bin whose upper edge
    first reaches it, clipped to the last bin); perpendicular crossings at
    rate ``sqrt(2) r_tx D v`` with the chord law at ``sqrt(2) v``. ``eta``
    is ``D area_side / (2 n_s)`` on the finite grid of ``n_s =
    round(area_side / s) + 1`` streets a direction when ``area_side`` is
    given, else ``D s / 2``. As in ``repro``, ``sqrt(2)`` is a float32
    constant, so ``g`` and the two weights are float32 sums and quotients.
    Assumes ``street_spacing > 2 sqrt(2) r_tx``."""
    device = resolve_device(device, "manhattan_contact_model")
    f32 = np.float32
    s = street_spacing
    if area_side is not None:
        n_streets = round(area_side / s) + 1
        eta = density * area_side / (2.0 * n_streets)
    else:
        eta = density * s / 2.0
    sqrt2 = f32(np.sqrt(f32(2.0)))
    rate_par = eta * speed
    rate_perp = f32(f32(density * speed) * sqrt2) * f32(r_tx)
    g = f32(rate_par) + rate_perp
    w_par = f32(rate_par) / g
    w_perp = rate_perp / g
    v_cross = float(sqrt2 * f32(speed))
    # the perpendicular chord's support, 2 r / v_cross = sqrt(2) r / v,
    # holds the head-on duration r / v
    centers, widths, mass = _chord_bins(v_cross, r_tx, nt, device)
    mass = float(w_perp) * mass
    upper = centers + 0.5 * widths
    t_head_on = torch.tensor([r_tx / speed], dtype=torch.float32,
                             device=device)
    head_bin = torch.searchsorted(upper, t_head_on).clamp(0, nt - 1)
    mass = mass.index_add(0, head_bin, torch.full(
        (1,), float(w_par), dtype=torch.float32, device=device))
    return _model(float(g), centers, widths, mass)


#: name -> analytic builder; the same names key the simulation mobility
#: registry ``repro_torch.sim.mobility.MOBILITY_MODELS``.
CONTACT_MODELS = {
    "rdm": rdm_contact_model,
    "rwp": rwp_contact_model,
    "manhattan": manhattan_contact_model,
}


def contact_model_for(name: str, **kwargs) -> ContactModel:
    """Build the analytic ContactModel paired with mobility model ``name``.
    Geometry kwargs a model does not use are accepted and ignored."""
    try:
        builder = CONTACT_MODELS[name]
    except KeyError:
        raise ValueError(
            f"unknown mobility model {name!r}; known: {sorted(CONTACT_MODELS)}"
        ) from None
    return builder(**kwargs)
