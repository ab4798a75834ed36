"""Mean-field limit model of Floating Gossip, Lemmas 1-3 (port of
``repro.core.meanfield``).

* the Lemma 1 fixed point for the steady-state model availability ``a``
  and node busy probability ``b``, coupled through the transfer-success
  probability ``S(a)`` and the mean exchange duration ``T_S(a)``;
* the Lemma 2 merging-task arrival rate ``r = M a S w^2 g (1-b)^2``;
* the Lemma 3 M/D/1 priority-queue delays ``d_M`` (merging) and ``d_I``
  (incorporation by training) and the stability condition, Eq. (3).

Notation follows the paper (see :class:`FGParams`); ``T_L = 2 L / C`` is
the bidirectional exchange of one instance and ``gamma = 2 M w^2 a`` the
mean number of instances a contact moves.

Arithmetic: float32 tensors on the device of the
:class:`~repro_torch.core.mobility.ContactModel` (by default ``cuda``).
Every parameter enters as a float32 tensor (a Python value rounded once,
as the reference's ``jnp.asarray`` rounds it), every operation is
elementwise or a :func:`~repro_torch.numerics.row_sum32` over the contact
grid, and every square root is the correctly rounded float32 root (taken
in float64). So a batched solve (a leading point axis) computes each
point with the same operations as the scalar solve, and its rows equal
the scalar solutions bit for bit, on either device. The reference's
jitted program contracts some products into fused multiply-adds and sums
in its own order, so the two agree to float32 rounding, not bit for bit.

The fault layer's analytic twin, :func:`solve_fixed_point_classes`,
solves the class-structured fixed point of a single Replication Zone (one
lane per fault class; at a disabled fault configuration it delegates to
:func:`solve_fixed_point`). The multi-zone and contamination solvers of
the reference come with the slices that need them (ROADMAP queue 1, items
4 and 5).
"""

from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch

from repro_torch.core.mobility import ContactModel
from repro_torch.core.zones import ZoneSet
from repro_torch.numerics import row_sum32, sqrt32

__all__ = ["FGParams", "MeanFieldSolution", "ClassSolution", "transfer_stats",
           "solve_fixed_point", "solve_fixed_point_batch",
           "solve_fixed_point_classes", "merge_arrival_rate",
           "queueing_delays", "stability_lhs"]

_EPS = 1e-12
#: The parameter fields the solvers read, as float32 tensors.
_FIELDS = ("N", "alpha", "lam", "Lam", "M", "w", "T_T", "T_M", "t0", "T_L")


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


@dataclasses.dataclass(frozen=True)
class MeanFieldSolution:
    """Steady-state mean-field operating point (output of Lemmas 1-3):
    0-d float32 tensors, or ``(P,)`` from :func:`solve_fixed_point_batch`."""

    a: torch.Tensor        # model availability
    b: torch.Tensor        # busy probability
    S: torch.Tensor        # transfer success probability S(a)
    T_S: torch.Tensor      # mean exchange time T_S(a) [s]
    r: torch.Tensor        # merging-task arrival rate [1/s]
    d_M: torch.Tensor      # mean merge delay [s]
    d_I: torch.Tensor      # mean incorporation delay [s]
    stability: torch.Tensor  # LHS of Eq. (3); stable iff <= 1
    rho: torch.Tensor      # compute utilization r*T_M + (Mwλ Λ/N)*T_T
    # the post-loop residual |body(a) - a| of the damped iteration and its
    # verdict residual <= tol
    converged: Any = None
    residual: Any = None

    @property
    def stable(self) -> torch.Tensor:
        return self.stability <= 1.0

    def point(self, i: int) -> "MeanFieldSolution":
        """Scalar slice of a batched solution."""
        return MeanFieldSolution(**{
            f.name: (None if getattr(self, f.name) is None
                     else getattr(self, f.name)[i])
            for f in dataclasses.fields(self)})


def _param_tensors(ps: list[FGParams], device, batched: bool) -> dict:
    """The solver's parameters as float32 tensors on ``device``: ``(P,)``
    over ``ps`` when ``batched``, else 0-d from the one point."""
    out = {}
    for name in _FIELDS:
        vals = [float(getattr(p, name)) for p in ps]
        out[name] = torch.tensor(vals if batched else vals[0],
                                 dtype=torch.float32, device=device)
    return out


def _transfer_stats_core(a, *, M, w, t0, T_L, t_grid, pdf, weights,
                         fail_rate=None):
    """Lemma 1's integrals ``(S(a), T_S(a))`` over the contact grid, for
    ``a`` and the parameters of shape ``(...)``.

    A contact of duration t_c succeeds for a given instance with
    probability min(1, floor((t_c - t0)/T_L) / gamma) and occupies the
    pair for min(t_c, gamma*T_L + t0). ``fail_rate`` (the per-link-end
    failure rate [1/s]; None = the paper's formulas) folds mid-transfer
    link failure at ``mu = 2*fail_rate`` into both: the success integrand
    ``exp(-mu t0) (1 - exp(-mu T_L m_eff)) / (mu T_L gamma)`` with ``m_eff
    = min(n_transferable, gamma)``, the occupation ``(1 - exp(-mu occ)) /
    mu``. Both sums run over one stacked ``(..., 2, nt)`` tensor."""
    gamma = torch.clamp_min(2.0 * M * w * w * a, _EPS)[..., None]
    t0, T_L = torch.as_tensor(t0)[..., None], torch.as_tensor(T_L)[..., None]
    n_transferable = torch.floor(torch.clamp_min(t_grid - t0, 0.0) / T_L)
    occupied = torch.minimum(t_grid, gamma * T_L + t0)
    if fail_rate is None:
        s_integrand = torch.clamp_max(n_transferable / gamma, 1.0)
        t_integrand = occupied
    else:
        mu = 2.0 * fail_rate
        m_eff = torch.minimum(n_transferable, gamma)
        s_integrand = (torch.exp(-mu * t0)
                       * -torch.expm1(-mu * T_L * m_eff) / (mu * T_L * gamma))
        t_integrand = -torch.expm1(-mu * occupied) / mu
    s_term = torch.where(t_grid > t0, s_integrand, 0.0) * pdf * weights
    t_term = t_integrand * pdf * weights
    sums = row_sum32(torch.stack(torch.broadcast_tensors(s_term, t_term), -2))
    return sums[..., 0], sums[..., 1]


def transfer_stats(a, p: FGParams, contact: ContactModel, *,
                   fail_rate=None) -> tuple[torch.Tensor, torch.Tensor]:
    """``S(a)`` and ``T_S(a)`` from Lemma 1 (see :func:`_transfer_stats_core`)."""
    pd = _param_tensors([p], contact.device, batched=False)
    a = torch.as_tensor(a, dtype=torch.float32, device=contact.device)
    return _transfer_stats_core(
        a, M=pd["M"], w=pd["w"], t0=pd["t0"], T_L=pd["T_L"],
        t_grid=contact.t_grid, pdf=contact.pdf, weights=contact.weights,
        fail_rate=fail_rate)


def _check_finite_inputs(p: FGParams, contact: ContactModel | None = None):
    """Reject a NaN or inf parameter up front, naming the field: the damped
    iteration would otherwise converge to NaN without a word."""
    bad = [f.name for f in dataclasses.fields(p)
           if isinstance(getattr(p, f.name), (int, float))
           and not np.isfinite(getattr(p, f.name))]
    if contact is not None and not bool(torch.isfinite(contact.g).all()):
        bad.append("contact.g")
    if bad:
        raise ValueError(f"non-finite mean-field solver inputs: {bad}")


def _busy_core(T_S, *, g, alpha, N):
    """Lemma 1's busy probability b = K - sqrt(K^2 - 1), K = 1 + 1/(4 g
    T_S) + alpha/(2 g N). ``T_S`` must already be clamped away from 0."""
    K = 1.0 + 1.0 / (4.0 * g * T_S) + alpha / (2.0 * g * N)
    return K - sqrt32(torch.clamp_min(K * K - 1.0, 0.0))


def _fixed_point_iterate(a0, pd: dict, t_grid, pdf, weights, g, iters: int):
    """Damped fixed-point iteration on Eq. (1), ``iters`` steps from
    ``a0``. Returns ``(a, b, S, T_S, residual)``; the residual is the size
    of one further damped step, ``|body(a) - a|``, so an exit at the
    iteration cap that has not contracted shows."""
    N, alpha, lam, Lam, w = pd["N"], pd["alpha"], pd["lam"], pd["Lam"], pd["w"]

    def stats(a):
        S, T_S = _transfer_stats_core(
            a, M=pd["M"], w=w, t0=pd["t0"], T_L=pd["T_L"], t_grid=t_grid,
            pdf=pdf, weights=weights)
        return torch.clamp_min(S, _EPS), torch.clamp_min(T_S, _EPS)

    def busy(T_S):
        return torch.clamp_min(_busy_core(T_S, g=g, alpha=alpha, N=N), _EPS)

    def body(a):
        S, T_S = stats(a)
        denom = busy(T_S) * N * S * w
        H = 1.0 - T_S * (alpha + lam * Lam) / denom
        a_new = 0.5 * (H + sqrt32(H * H + 4.0 * T_S * lam * Lam / denom))
        a_new = torch.clamp(a_new, _EPS, 1.0)
        return 0.5 * a + 0.5 * a_new  # damping for robustness

    a = a0
    for _ in range(iters):
        a = body(a)
    residual = torch.abs(body(a) - a)
    S, T_S = stats(a)
    return a, busy(T_S), S, T_S, residual


def _strict_check(converged, residual, *, what: str, iters: int, tol: float):
    conv = np.asarray(converged.cpu())
    if not bool(np.all(conv)):
        res = np.asarray(residual.cpu())
        raise RuntimeError(
            f"{what} did not converge: max residual {float(np.max(res)):.3e}"
            f" > tol {tol:.1e} after {iters} damped iterations "
            f"({int(np.sum(~conv))} of {res.size} point(s)); raise iters= or "
            "loosen tol=")


def _merge_rate(a, b, S, *, M, w, g):
    """Lemma 2: r = M a S w^2 g (1 - b)^2."""
    omb = 1.0 - b
    return M * a * S * w * w * g * (omb * omb)


def _delays(r, *, M, w, lam, Lam, N, T_T, T_M):
    """Eq. (4), +inf outside the stability region."""
    lam_t = M * w * lam * Lam / N  # training-task arrival rate
    rho_m = r * T_M
    rho_t = lam_t * T_T
    ok = (rho_m < 1.0) & (rho_t < 1.0)
    safe_m = torch.where(ok, 1.0 - rho_m, 1.0)
    safe_t = torch.where(ok, 1.0 - rho_t, 1.0)
    d_M = T_M + r * (T_M * T_M) / (2.0 * safe_m) + lam_t * (T_T * T_T)
    d_I = (r * (T_M * T_M) / (2.0 * safe_m) + T_T
           + lam_t * (T_T * T_T) / (2.0 * safe_t)) / safe_m
    return (torch.where(ok, d_M, float("inf")),
            torch.where(ok, d_I, float("inf")))


def _stability(r, *, M, w, lam, Lam, N, alpha, T_T, T_M):
    """Eq. (3)'s LHS (+inf outside the stability region) and the
    utilization rho."""
    lam_t = M * w * lam * Lam / N
    rho = r * T_M + lam_t * T_T
    rho_m = r * T_M
    rho_t = lam_t * T_T
    ok = (rho_m < 1.0) & (rho_t < 1.0)
    safe_m = torch.where(ok, 1.0 - rho_m, 1.0)
    safe_t = torch.where(ok, 1.0 - rho_t, 1.0)
    sojourn = N / alpha
    term2 = (1.0 / (sojourn * 2.0 * safe_m)
             * (r * (T_M * T_M) / safe_m + T_T * (2.0 - rho_t) / safe_t))
    lhs = torch.maximum(rho, term2)
    return torch.where(ok, lhs, float("inf")), rho


def _solution(a, b, S, T_S, residual, pd: dict, g, *, tol: float,
              strict: bool, what: str, iters: int) -> MeanFieldSolution:
    """Lemmas 2-3 at the fixed point, shared by the scalar and batched
    solvers."""
    converged = residual <= tol
    if strict:
        _strict_check(converged, residual, what=what, iters=iters, tol=tol)
    kw = dict(M=pd["M"], w=pd["w"], lam=pd["lam"], Lam=pd["Lam"], N=pd["N"],
              T_T=pd["T_T"], T_M=pd["T_M"])
    r = _merge_rate(a, b, S, M=pd["M"], w=pd["w"], g=g)
    d_M, d_I = _delays(r, **kw)
    lhs, rho = _stability(r, alpha=pd["alpha"], **kw)
    return MeanFieldSolution(a=a, b=b, S=S, T_S=T_S, r=r, d_M=d_M, d_I=d_I,
                             stability=lhs, rho=rho, converged=converged,
                             residual=residual)


def solve_fixed_point(p: FGParams, contact: ContactModel, *, iters: int = 200,
                      tol: float = 1e-6, strict: bool = False
                      ) -> MeanFieldSolution:
    """Solve the Lemma 1 fixed point and derive Lemma 2-3 quantities, on
    the contact model's device.

    Every trajectory converges to the unique solution (Lemma 1), so damped
    iteration from a = 0.5 suffices. The solution carries ``converged``
    (post-loop residual <= ``tol``) and ``residual``; ``strict=True``
    raises instead of returning an unconverged point. Non-finite inputs
    raise ``ValueError`` naming the field."""
    _check_finite_inputs(p, contact)
    pd = _param_tensors([p], contact.device, batched=False)
    a0 = torch.tensor(0.5, dtype=torch.float32, device=contact.device)
    a, b, S, T_S, residual = _fixed_point_iterate(
        a0, pd, contact.t_grid, contact.pdf, contact.weights, contact.g,
        iters)
    return _solution(a, b, S, T_S, residual, pd, contact.g, tol=tol,
                     strict=strict, what="solve_fixed_point", iters=iters)


def solve_fixed_point_batch(ps: list[FGParams], contact: ContactModel, *,
                            iters: int = 200, tol: float = 1e-6,
                            strict: bool = False) -> MeanFieldSolution:
    """Solve Lemmas 1-3 for a whole scenario grid at once: every field of
    the result carries a leading axis of ``len(ps)``, and row i equals
    ``solve_fixed_point(ps[i], contact)`` bit for bit. The points share
    the contact model; every ``FGParams`` field may vary, ``M`` included
    (here it is arithmetic only)."""
    for p in ps:
        _check_finite_inputs(p)
    _check_finite_inputs(ps[0], contact)
    pd = _param_tensors(ps, contact.device, batched=True)
    a0 = torch.full((len(ps),), 0.5, dtype=torch.float32,
                    device=contact.device)
    a, b, S, T_S, residual = _fixed_point_iterate(
        a0, pd, contact.t_grid, contact.pdf, contact.weights, contact.g,
        iters)
    return _solution(a, b, S, T_S, residual, pd, contact.g, tol=tol,
                     strict=strict, what="solve_fixed_point_batch",
                     iters=iters)


def merge_arrival_rate(a, b, S, p: FGParams,
                       contact: ContactModel) -> torch.Tensor:
    """Lemma 2: r = M a S w^2 g (1 - b)^2."""
    pd = _param_tensors([p], contact.device, batched=False)
    return _merge_rate(a, b, S, M=pd["M"], w=pd["w"], g=contact.g)


def queueing_delays(r: torch.Tensor, p: FGParams
                    ) -> tuple[torch.Tensor, torch.Tensor]:
    """Eq. (4): mean delays of the two-class non-preemptive priority M/D/1
    (merging first: rate r, service T_M; training: rate M w λ Λ / N,
    service T_T), as printed; +inf outside the stability region."""
    pd = _param_tensors([p], r.device, batched=False)
    return _delays(r, M=pd["M"], w=pd["w"], lam=pd["lam"], Lam=pd["Lam"],
                   N=pd["N"], T_T=pd["T_T"], T_M=pd["T_M"])


def stability_lhs(r: torch.Tensor, d_M, d_I, p: FGParams
                  ) -> tuple[torch.Tensor, torch.Tensor]:
    """LHS of the stability condition, Eq. (3) (stable iff <= 1; +inf
    outside the region), and the utilization. Eq. (3) is ``max(utilization,
    sojourn-delay term)``; the training rate carries the subscription
    factor w as in Lemma 3's proof. ``d_M`` and ``d_I`` are accepted for
    the reference's signature; the formula recomputes them."""
    pd = _param_tensors([p], r.device, batched=False)
    return _stability(r, M=pd["M"], w=pd["w"], lam=pd["lam"], Lam=pd["Lam"],
                      N=pd["N"], alpha=pd["alpha"], T_T=pd["T_T"],
                      T_M=pd["T_M"])


@dataclasses.dataclass(frozen=True)
class ClassSolution:
    """Class-structured (class × zone) mean-field operating point, the
    fault layer's analytic twin: ``a[c, z]`` is the steady-state model
    availability among class-``c`` members of zone ``z`` (the simulator's
    ``availability_c``); ``a_serve`` the duty-weighted availability of
    accessible, serving nodes. The port solves one zone (``K = 1``)."""

    a: torch.Tensor          # (C, K) per-class per-zone availability
    a_serve: torch.Tensor    # (K,) duty-weighted serving availability
    q: torch.Tensor          # (C,) stationary accessible (duty) fraction
    q_bar: torch.Tensor      # () population mean accessible fraction
    fracs: torch.Tensor      # (C,) class population fractions
    b: torch.Tensor          # (K,) busy probability
    S: torch.Tensor          # (K,) corrected transfer success probability
    T_S: torch.Tensor        # (K,) corrected mean exchange time [s]
    N_z: torch.Tensor        # (K,) mean nodes per zone
    alpha_z: torch.Tensor    # (K,) zone exit rate [nodes/s]
    Lam_z: torch.Tensor      # (K,) mean simultaneous observers per zone
    r: Any = None            # (K,) effective merge arrival rate [1/s]
    d_M: Any = None          # (K,) mean merge delay [s]
    d_I: Any = None          # (K,) mean incorporation delay [s]
    converged: Any = None
    residual: Any = None
    base: Any = None         # the delegated MeanFieldSolution at a
                             # disabled fault configuration

    @property
    def a_mean(self) -> torch.Tensor:
        """(K,) population-weighted availability ``sum_c f_c a[c, z]``."""
        return (self.fracs[:, None] * self.a).sum(0)


def _class_vectors(fc):
    """``(fracs, duty, serves)`` float64 vectors of a FaultConfig."""
    fracs = np.asarray([c.frac for c in fc.classes], np.float64)
    q = np.asarray([c.duty for c in fc.classes], np.float64)
    serves = np.asarray([0.0 if c.free_rider else 1.0 for c in fc.classes],
                        np.float64)
    return fracs, q, serves


def solve_fixed_point_classes(p: FGParams, contact: ContactModel,
                              faults=None, zones: ZoneSet | None = None, *,
                              iters: int = 200, tol: float = 1e-4,
                              strict: bool = False) -> ClassSolution:
    """Class-structured coupled Lemma 1-3 fixed point of one Replication
    Zone, on the contact model's device (``faults`` defaults to
    ``p.faults``). Per class ``c``

        G_c * a_serve * (1 - a_c) + lt_c * (1 - a_c) - alpha_c * a_c = 0

    with ``q_c`` the class's duty and ``q_bar = sum_c f_c q_c`` (the
    gossiping population is ``N q_bar``); ``a_serve = sum_c f_c q_c (1 -
    fr_c) a_c / q_bar`` (a partner serves only if on and not a
    free-rider); ``G_c = q_c b (N q_bar) S w / T_S``, with ``S`` and
    ``T_S`` corrected for link failure (``_transfer_stats_core``'s
    ``fail_rate``) and the contact rate derated by the abort probability;
    ``lt_c = lam Lam q_c / q_bar`` (observers are accessible members);
    ``alpha_c = alpha + crash_rate N`` (a crash loses state like an exit).

    At a disabled (or absent) fault configuration it delegates to
    :func:`solve_fixed_point`, bit for bit, the solution riding along as
    ``.base``. A ``ZoneSet`` (``zones`` or ``p.zones``) raises
    ``NotImplementedError``: the multi-zone slice ports it."""
    fc = faults if faults is not None else getattr(p, "faults", None)
    if zones is not None or p.zones is not None:
        raise NotImplementedError(
            "repro_torch's solve_fixed_point_classes solves a single "
            "Replication Zone; ZoneSets come with the multi-zone slice "
            "(ROADMAP queue 1, item 5)")
    dev = contact.device
    pd = _param_tensors([p], dev, batched=False)
    ones = torch.ones((1,), dtype=torch.float32, device=dev)
    if fc is None or not fc.enabled:
        base = solve_fixed_point(p, contact, iters=iters, tol=tol,
                                 strict=strict)
        return ClassSolution(
            a=base.a.reshape(1, 1), a_serve=base.a.reshape(1), q=ones,
            q_bar=torch.ones((), dtype=torch.float32, device=dev),
            fracs=ones, b=base.b.reshape(1), S=base.S.reshape(1),
            T_S=base.T_S.reshape(1), N_z=pd["N"].reshape(1),
            alpha_z=pd["alpha"].reshape(1), Lam_z=pd["Lam"].reshape(1),
            r=base.r.reshape(1), d_M=base.d_M.reshape(1),
            d_I=base.d_I.reshape(1), converged=base.converged,
            residual=base.residual, base=base)

    _check_finite_inputs(p, contact)
    fracs, q, serves = _class_vectors(fc)
    q_bar = max(float(np.sum(fracs * q)), _EPS)
    fail_rate = fc.link_fail_rate if fc.link_fail_rate > 0.0 else None
    g_eff = contact.g * (1.0 - fc.p_abort)

    def f32(v):
        return torch.tensor(v, dtype=torch.float32, device=dev)

    f_t, q_t, sv_t = f32(fracs), f32(q), f32(serves)
    N_z, alpha_z, Lam_z = (pd[k].reshape(1) for k in ("N", "alpha", "Lam"))
    w, lam = pd["w"], pd["lam"]
    N_eff = N_z * q_bar
    alpha_c = alpha_z[None, :] + fc.crash_rate * N_z[None, :]
    serve_w = (f_t * q_t * sv_t)[:, None]

    def stats(a_serve):
        S, T_S = _transfer_stats_core(
            a_serve, M=pd["M"], w=w, t0=pd["t0"], T_L=pd["T_L"],
            t_grid=contact.t_grid, pdf=contact.pdf, weights=contact.weights,
            fail_rate=fail_rate)
        return torch.clamp_min(S, _EPS), torch.clamp_min(T_S, _EPS)

    def serve_avail(a):
        return (serve_w * a).sum(0) / q_bar

    def busy(T_S):
        return torch.clamp_min(
            _busy_core(T_S, g=g_eff, alpha=alpha_z, N=N_eff), _EPS)

    def body(a):
        a_serve = torch.clamp_min(serve_avail(a), _EPS)          # (K,)
        S, T_S = stats(a_serve)
        G = q_t[:, None] * (busy(T_S) * N_eff * S * w / T_S)[None, :]
        lt = lam * Lam_z[None, :] * q_t[:, None] / q_bar
        gain = G * a_serve[None, :] + lt
        a_new = gain / (gain + alpha_c)
        return 0.5 * a + 0.5 * torch.clamp(a_new, _EPS, 1.0)

    a = torch.full((len(fracs), 1), 0.5, dtype=torch.float32, device=dev)
    for _ in range(iters):
        a = body(a)
    residual = torch.abs(body(a) - a).max()
    converged = residual <= tol
    if strict:
        _strict_check(converged, residual, what="solve_fixed_point_classes",
                      iters=iters, tol=tol)
    a_serve = torch.clamp_min(serve_avail(a), _EPS)
    S, T_S = stats(a_serve)
    b = busy(T_S)
    r = _merge_rate(a_serve, b, S, M=pd["M"], w=w, g=g_eff)
    d_M, d_I = _delays(r, M=pd["M"], w=w, lam=lam, Lam=Lam_z, N=N_eff,
                       T_T=pd["T_T"], T_M=pd["T_M"])
    return ClassSolution(
        a=a, a_serve=a_serve, q=q_t, q_bar=f32(q_bar), fracs=f_t, b=b, S=S,
        T_S=T_S, N_z=N_z, alpha_z=alpha_z, Lam_z=Lam_z, r=r, d_M=d_M,
        d_I=d_I, converged=converged, residual=residual)
