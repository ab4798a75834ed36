"""Model-staleness lower bound, Theorem 2, Eq. 7 (port of
``repro.core.staleness``).

With γ_i = Σ_{k<=i} ξ_k, ξ_k i.i.d. Exp(λ) (i.e. γ_i ~ Erlang(i, λ)), the mean
staleness F of a model is lower bounded by

          δ Σ_i i E[o(γ_i) | γ_i <= τ_l] Π_{j<i} (1 - E[o(γ_j) | γ_i <= τ_l])
    F >= ------------------------------------------------------------------
             Σ_i E[o(γ_i)] Π_{j<i} (1 - E[o(γ_j) | γ_i <= τ_l])

with δ = 1/λ (the inter-arrival mean). The expectations integrate the DDE
solution o(τ) against truncated Erlang densities on the solver's τ grid:
one ``(..., i_max, nt)`` tensor of densities on the device of o, float32.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.dde import DDESolution
from repro_torch.core.meanfield import FGParams
from repro_torch.numerics import row_sum32

__all__ = ["staleness_lower_bound", "staleness_lower_bound_batch",
           "erlang_weighted_o"]


def _erlang_weighted_core(tau, o, dt, lam, tau_l, i_max: int):
    """E[o(γ_i) | γ_i <= τ_l] and P(γ_i <= τ_l) on the grid, for i =
    1..i_max: ``(..., i_max)`` each, for o ``(..., nt)`` and ``lam``,
    ``tau_l`` of shape ``(...)``."""
    lam = torch.as_tensor(lam, dtype=torch.float32, device=o.device)[..., None]
    tau_l = torch.as_tensor(tau_l, dtype=torch.float32,
                            device=o.device)[..., None]
    mask = (tau <= tau_l) & (tau > 0.0)                       # (..., nt)
    log_tau = torch.where(
        mask, torch.log(torch.where(tau > 0, tau, 1.0)), float("-inf"))
    i = torch.arange(1, i_max + 1, dtype=torch.float32, device=o.device)
    i = i[:, None]                                            # (i_max, 1)
    # Erlang(i, λ) log-pdf: i logλ + (i-1) logτ - λτ - log((i-1)!)
    logpdf = (i * torch.log(lam)[..., None, :]
              + (i - 1.0) * log_tau[..., None, :]
              - (lam * tau)[..., None, :] - torch.lgamma(i))
    pdf = torch.where(mask[..., None, :], torch.exp(logpdf), 0.0)
    z = row_sum32(pdf) * dt               # P(γ_i <= τ_l) on the grid
    num = row_sum32(pdf * o[..., None, :]) * dt
    return torch.where(z > 1e-30, num / z, 0.0), z


def erlang_weighted_o(dde: DDESolution, lam: float, tau_l: float,
                      i_max: int) -> torch.Tensor:
    """E[o(γ_i) | γ_i <= τ_l] for i = 1..i_max on the DDE τ grid."""
    return _erlang_weighted_core(dde.tau, dde.o, dde.dt, lam, tau_l, i_max)


def _staleness_core(tau, o, dt, lam, tau_l, i_max: int):
    """Theorem 2's bound for o ``(..., nt)``: ``(...)``."""
    e_cond, z = _erlang_weighted_core(tau, o, dt, lam, tau_l, i_max)
    # unconditional E[o(γ_i)] = E[o|γ_i<=τ_l] P(γ_i<=τ_l): observations
    # older than τ_l are discarded
    e_unc = e_cond * z
    one_minus = torch.clamp(1.0 - e_cond, 0.0, 1.0)
    # Π_{j<i}: an exclusive cumulative product, through logs
    cumlog = torch.cumsum(torch.log(torch.clamp_min(one_minus, 1e-30)), -1)
    prod_excl = torch.cat([torch.ones_like(cumlog[..., :1]),
                           torch.exp(cumlog[..., :-1])], -1)
    i_idx = torch.arange(1, i_max + 1, dtype=torch.float32, device=o.device)
    lam = torch.as_tensor(lam, dtype=torch.float32, device=o.device)
    num = row_sum32(i_idx * e_cond * prod_excl) / lam  # δ = 1/λ
    den = row_sum32(e_unc * prod_excl)
    return torch.where(den > 1e-30, num / den, float("inf"))


def _default_i_max(lam: float, tau_l: float) -> int:
    # Erlang(i, λ) mass within τ_l is negligible beyond λτ_l + 10 sqrt(λτ_l)
    # (the reference's float32 arithmetic, so both pick the same i_max)
    f32 = np.float32
    mean_events = f32(lam * tau_l)
    i_max = int(mean_events + f32(10.0) * np.sqrt(f32(lam * tau_l + 1.0))
                + f32(20))
    return min(max(i_max, 8), 4096)


def staleness_lower_bound(p: FGParams, dde: DDESolution, *,
                          i_max: int | None = None) -> torch.Tensor:
    """Theorem 2 lower bound on the mean model staleness F [s]."""
    if i_max is None:
        i_max = _default_i_max(p.lam, p.tau_l)
    return _staleness_core(dde.tau, dde.o, dde.dt, p.lam, p.tau_l, i_max)


def staleness_lower_bound_batch(ps: list[FGParams], dde: DDESolution, *,
                                i_max: int | None = None) -> torch.Tensor:
    """Theorem 2 bound for a whole grid against a *batched* DDE solution:
    ``(P,)``. ``i_max`` is shared across the batch (the largest per-point
    default); the extra Erlang orders of low-λ points carry negligible
    mass inside τ_l."""
    if i_max is None:
        i_max = max(_default_i_max(p.lam, p.tau_l) for p in ps)
    return _staleness_core(dde.tau, dde.o, dde.dt, [p.lam for p in ps],
                           [p.tau_l for p in ps], i_max)


