"""Node stored information (Lemma 4) and FG learning capacity (Problem 1)
(port of ``repro.core.capacity``).

* ``node_stored_information``: Lemma 4, ``M w a min(L/k, λ ∫_0^{τ_l} o dτ)``
  (an upper bound; real models degrade instead of FIFO-dropping).
* ``learning_capacity``: Definition 9 / Problem 1 objective,
  ``w a min(L/(λ k), ∫_0^{τ_l} o dτ)`` (node stored information over the
  total observation arrival rate M λ).
* ``solve_learning_capacity``: Problem 1. By Proposition 1 the optimum sits
  at the minimum model size ``L* = L_m``, so the problem reduces to a sweep
  over the number of models M under the Eq. (3) stability constraint, the
  greedy the paper prescribes.

float32 tensors on the device of the solutions they are given.
"""

from __future__ import annotations

import dataclasses

import torch

from repro_torch.core.dde import solve_observation_availability
from repro_torch.core.meanfield import (FGParams, MeanFieldSolution,
                                        solve_fixed_point)
from repro_torch.core.mobility import ContactModel

__all__ = ["node_stored_information", "learning_capacity",
           "learning_capacity_batch", "CapacityPoint",
           "solve_learning_capacity"]


def node_stored_information(p: FGParams, sol: MeanFieldSolution,
                            o_integral: torch.Tensor) -> torch.Tensor:
    """Lemma 4 (observations stored per node, ages <= τ_l)."""
    stored_per_model = torch.clamp_max(p.lam * o_integral, p.L / p.k)
    return p.M * p.w * sol.a * torch.where(sol.stable, stored_per_model, 0.0)


def _capacity_core(*, w, a, stable, L, lam, k, o_integral):
    """Definition 9's objective (shared by the scalar and batched forms)."""
    cap = w * a * torch.minimum(L / (lam * k), o_integral)
    return torch.where(stable, cap, 0.0)


def _f32(v, like: torch.Tensor) -> torch.Tensor:
    return torch.tensor(v, dtype=torch.float32, device=like.device)


def learning_capacity(p: FGParams, sol: MeanFieldSolution,
                      o_integral: torch.Tensor) -> torch.Tensor:
    """Problem 1 objective: stored information per unit total arrival rate."""
    return _capacity_core(w=p.w, a=sol.a, stable=sol.stable,
                          L=_f32(p.L, sol.a), lam=_f32(p.lam, sol.a),
                          k=_f32(p.k, sol.a), o_integral=o_integral)


def learning_capacity_batch(ps: list[FGParams], sols: MeanFieldSolution,
                            o_integrals: torch.Tensor) -> torch.Tensor:
    """Definition 9 objective for a whole grid: ``sols`` is a batched
    mean-field solution and ``o_integrals`` the matching (P,) Lemma 4
    integrals (``DDESolution.integral`` of a batched DDE solve)."""
    a = sols.a
    return _capacity_core(
        w=_f32([p.w for p in ps], a), a=a, stable=sols.stable,
        L=_f32([p.L for p in ps], a), lam=_f32([p.lam for p in ps], a),
        k=_f32([p.k for p in ps], a), o_integral=o_integrals)


@dataclasses.dataclass(frozen=True)
class CapacityPoint:
    M: int
    L: float
    capacity: torch.Tensor
    stored: torch.Tensor
    sol: MeanFieldSolution


def solve_learning_capacity(p: FGParams, contact: ContactModel, *,
                            L_m: float, M_max: int = 64,
                            dt: float = 0.05) -> CapacityPoint:
    """Problem 1: maximize capacity over (M, L) with L >= L_m, M >= 1.

    Proposition 1 pins L* = L_m; the sweep runs M = 1..M_max and stops at
    the first unstable point (the stability LHS grows with M; the
    objective is 0 there by convention), on the contact model's device."""
    best: CapacityPoint | None = None
    for M in range(1, M_max + 1):
        pm = p.replace(M=M, L=L_m)
        sol = solve_fixed_point(pm, contact)
        if not bool(sol.stable):
            break
        dde = solve_observation_availability(pm, sol, dt=dt)
        o_int = dde.integral(pm.tau_l)
        cap = learning_capacity(pm, sol, o_int)
        stored = node_stored_information(pm, sol, o_int)
        point = CapacityPoint(M=M, L=L_m, capacity=cap, stored=stored,
                              sol=sol)
        if best is None or float(cap) > float(best.capacity):
            best = point
    if best is None:  # unstable even at M = 1
        pm = p.replace(M=1, L=L_m)
        sol = solve_fixed_point(pm, contact)
        z = torch.zeros((), dtype=torch.float32, device=contact.device)
        best = CapacityPoint(M=1, L=L_m, capacity=z, stored=z, sol=sol)
    return best
