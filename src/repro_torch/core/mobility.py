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

``rwp`` and ``manhattan`` (the reference's other twins) come with their
simulation models (ROADMAP queue 1, item 5); :func:`contact_model_for`
raises for them.

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

__all__ = ["ContactModel", "rdm_contact_model", "CONTACT_MODELS",
           "contact_model_for", "mean_relative_speed_uniform"]


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


def _not_ported(name: str):
    def builder(**_kwargs):
        raise NotImplementedError(
            f"the {name!r} contact model comes with the {name} mobility "
            "model (ROADMAP queue 1, item 5); the port has 'rdm'")
    return builder


#: name -> analytic builder; the same names key the simulation mobility
#: registry in ``repro_torch.sim.mobility``.
CONTACT_MODELS = {
    "rdm": rdm_contact_model,
    "rwp": _not_ported("rwp"),
    "manhattan": _not_ported("manhattan"),
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
