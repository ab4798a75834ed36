"""Observation-availability delay differential equation, Theorem 1 (port
of ``repro.core.dde``).

Solves, at the mean-field limit and in the substable regime,

    do(τ)/dτ = (b S(a) w^2 / T_S(a)) [ (1-a) o(τ)
               + a o(τ-d_M) (1 - o(τ-d_M)) ] - (α w / N) o(τ)        (5)

with the paper's initial condition

    o(τ) = 0                      τ < d_I
    o(τ) = Λ / ceil(a N)          d_I <= τ <= d_I + d_M              (6)

The incorporation rate is R(τ) = λ o(τ).

The delay term is handled with a fixed-step explicit Euler scheme and a
ring buffer of ``round(d_M / dt)`` past samples. The scan is serial: at
the paper's τ_l = 300 s and dt = 0.05 it is 6000 steps of a dozen small
elementwise operations, each a kernel launch on the card (the host's
launch rate sets its time there).

:func:`solve_observation_availability_batch` solves a scenario grid in one
scan: every ring buffer is padded to the largest delay of the batch and
each point reads its own delayed sample at an offset (an index table made
once on the host, since each point's step count is known in advance);
the pre-``d_I`` zero region and the Eq. (6) plateau are step-index gates.
Each point's arithmetic is the scalar solver's, operation for operation,
so each row equals the scalar solve on the same grid bit for bit.

:func:`solve_observation_availability_multizone` integrates one lane a
zone of a multi-zone operating point with the migration exchange term
``sum_z' couple[z, z'] (o_z' - o_z)`` added (the same scan, ``couple``).

:func:`solve_observation_availability_classes` is the fault layer's
twin: one lane per fault class, with the class fixed point's corrected
coefficients, integrated by the same batched scan (at a disabled fault
configuration it delegates to the scalar solve).

:func:`solve_contamination_transient` is the Byzantine layer's: the
poisoned-replica fraction's Euler trace toward
``core.meanfield.solve_contamination_classes``' steady state, one lane a
class.

Arithmetic: float32 on the device of the mean-field solution's tensors.
The reference's jitted scan contracts products into fused multiply-adds,
so the two agree to float32 rounding, not bit for bit; the contamination
transient writes its four contractions as ``fma32`` and equals the
reference bit for bit.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any

import numpy as np
import torch

from repro_torch.core.meanfield import (FGParams, MeanFieldSolution,
                                        MultizoneSolution,
                                        _poison_intensity)
from repro_torch.numerics import fma32, row_sum32

__all__ = ["DDESolution", "solve_observation_availability",
           "solve_observation_availability_batch",
           "solve_observation_availability_classes",
           "solve_observation_availability_multizone",
           "solve_contamination_transient"]


def _check_finite_coeffs(**named) -> None:
    """Reject NaN or inf mean-field coefficients before they poison the
    scan (infinite *delays* are the unstable operating point and are
    handled before this: o == 0)."""
    bad = [name for name, v in named.items()
           if v is not None and not bool(torch.isfinite(
               torch.as_tensor(v, dtype=torch.float32)).all())]
    if bad:
        raise ValueError(
            "non-finite DDE coefficient input(s): " + ", ".join(sorted(bad))
            + " — check the mean-field solution for NaN/Inf")


def _trace_diag(o: torch.Tensor, dt: float):
    """(converged, residual) of an integrated trace: finite everywhere,
    and the size of the final Euler step as a settling measure."""
    converged = torch.isfinite(o).all()
    if o.shape[-1] >= 2:
        residual = torch.abs(o[..., -1] - o[..., -2]).max() / dt
    else:
        residual = torch.zeros((), dtype=torch.float32, device=o.device)
    return converged, residual


def _strict_trace(converged, *, what: str) -> None:
    if not bool(converged):
        raise RuntimeError(
            f"{what}: Euler trace contains non-finite samples — the "
            "mean-field operating point is likely unstable or the step dt= "
            "too large")


@dataclasses.dataclass(frozen=True)
class DDESolution:
    tau: torch.Tensor       # (nt,) age grid [s], starting at 0
    o: torch.Tensor         # (nt,), or (P, nt) batched, or (C, K, nt)
    dt: float
    weights: Any = None     # (C,) class weights of a class-structured solve
    converged: Any = None   # every sample finite
    residual: Any = None    # max |do/dtau| at the final step [1/s]

    def integral(self, tau_l) -> torch.Tensor:
        """∫_0^{tau_l} o(τ) dτ, the Lemma 4 incorporation integral.
        ``tau_l`` may be a scalar, or a (P,) tensor against a batched
        solution (per-point lifetimes)."""
        tau_l = torch.as_tensor(tau_l, dtype=torch.float32,
                                device=self.o.device)
        mask = self.tau <= tau_l[..., None]
        return row_sum32(torch.where(mask, self.o, 0.0)) * self.dt

    def incorporation_rate(self, lam: float) -> torch.Tensor:
        """Theorem 1: R(τ) = λ o(τ)."""
        return lam * self.o

    def point(self, i: int) -> "DDESolution":
        """Scalar slice of a batched solution."""
        return DDESolution(tau=self.tau, o=self.o[i], dt=self.dt)

    def weighted(self) -> "DDESolution":
        """The class axis of a class-structured solve collapsed with the
        accessible-observer weights ``f_c q_c / q_bar``: the Theorem-1
        availability a uniformly random accessible observer sees."""
        if self.weights is None:
            return self
        w = self.weights.reshape(-1, *([1] * (self.o.dim() - 1)))
        return DDESolution(tau=self.tau, o=(w * self.o).sum(0), dt=self.dt,
                           converged=self.converged, residual=self.residual)


def _euler_step(o, o_delayed, coeff, a, leak, dt: float, exchange=None):
    """One step of Eq. (5): the same operations for one point and for a
    batch, so the two round alike. ``exchange`` is the multi-zone
    coupling's term, added to the derivative."""
    do = coeff * ((1.0 - a) * o + a * o_delayed * (1.0 - o_delayed)) \
        - leak * o
    if exchange is not None:
        do = do + exchange
    return torch.clamp(o + dt * do, 0.0, 1.0)


def _integrate(coeff, a, leak, o0, n_steps: int, n_delay: int,
               dt: float) -> torch.Tensor:
    """Euler integration from τ = d_I + d_M onward. The history on [d_I,
    d_I + d_M] is the plateau o0, which seeds the ring buffer of the last
    ``n_delay`` values; o(τ - d_M) is its oldest entry."""
    buf = o0.expand(n_delay).clone()
    trace = torch.empty((n_steps,), dtype=torch.float32, device=o0.device)
    o = o0
    for i in range(n_steps):
        head = i % n_delay            # the entry written n_delay steps ago
        o_new = _euler_step(o, buf[head], coeff, a, leak, dt)
        buf[head] = o
        trace[i] = o_new
        o = o_new
    return trace


def _grid(tau_max: float, dt: float, device):
    n_total = max(int(round(tau_max / dt)) + 1, 2)
    return n_total, torch.arange(n_total, dtype=torch.float32,
                                 device=device) * dt


def solve_observation_availability(p: FGParams, sol: MeanFieldSolution, *,
                                   dt: float = 0.05,
                                   tau_max: float | None = None,
                                   strict: bool = False) -> DDESolution:
    """Solve Eq. (5)-(6) on τ ∈ [0, tau_max] (default: the lifetime τ_l),
    on the device of ``sol``. ``strict=True`` raises if the Euler trace
    picks up non-finite samples; the solution always carries
    ``converged`` and ``residual``."""
    device = sol.a.device
    n_total, tau = _grid(float(tau_max if tau_max is not None else p.tau_l),
                         dt, device)
    d_I, d_M = float(sol.d_I), float(sol.d_M)
    if not (math.isfinite(d_I) and math.isfinite(d_M)):
        # Unstable operating point: observations are never incorporated.
        return DDESolution(
            tau=tau, o=torch.zeros_like(tau), dt=dt,
            converged=torch.ones((), dtype=torch.bool, device=device),
            residual=torch.zeros((), dtype=torch.float32, device=device))
    _check_finite_coeffs(a=sol.a, b=sol.b, S=sol.S, T_S=sol.T_S, Lam=p.Lam,
                         N=p.N, alpha=p.alpha, w=p.w)

    def f32(v):
        return torch.tensor(v, dtype=torch.float32, device=device)

    o0 = f32(p.Lam) / torch.ceil(torch.clamp_min(sol.a * f32(p.N), 1.0))
    n_pre = min(int(round(d_I / dt)), n_total)                 # o = 0
    n_plateau = min(int(round(d_M / dt)) + 1, n_total - n_pre)  # o = o0
    n_delay = max(int(round(d_M / dt)), 1)
    n_steps = n_total - n_pre - n_plateau

    parts = [torch.zeros((n_pre,), dtype=torch.float32, device=device),
             o0.expand(n_plateau)]
    if n_steps > 0:
        w = f32(p.w)
        coeff = sol.b * sol.S * w * w / torch.clamp_min(sol.T_S, 1e-12)
        leak = f32(p.alpha * p.w / p.N)
        parts.append(_integrate(coeff, sol.a, leak, o0, n_steps, n_delay,
                                dt))
    o = torch.cat(parts)[:n_total]
    converged, residual = _trace_diag(o, dt)
    if strict:
        _strict_trace(converged, what="solve_observation_availability")
    return DDESolution(tau=tau, o=o, dt=dt, converged=converged,
                       residual=residual)


def _integrate_batch(coeff, a, leak, o0, start: np.ndarray,
                     n_pre: np.ndarray, n_delay: np.ndarray, n_total: int,
                     buf_len: int, dt: float, couple=None) -> torch.Tensor:
    """One scan over the shared τ grid for every point at once: ``(P,
    n_total)``.

    Point i integrates from step ``start[i] = n_pre + n_plateau``; its
    k-th integration step (k = t - start) reads the sample written
    ``n_delay[i]`` steps earlier from a ring padded to ``buf_len``
    (entries not yet written hold the plateau o0, the Eq. (6) history)
    and writes its current value at k mod ``buf_len``. Before ``start`` a
    point's o stays o0 and its writes land on entry 0, which holds o0
    already. Points with ``start >= n_total`` never integrate.

    ``couple`` (a zero-diagonal ``(P, P)`` matrix, the multi-zone solver's)
    adds ``sum_j couple[i, j] (o_j(τ) - o_i(τ))`` to point i's derivative,
    ``o_j`` being point j's emitted value: 0 before its ``d_I``, its
    plateau until it integrates."""
    device = o0.device
    p_count = o0.shape[0]
    t = np.arange(n_total)[:, None]
    k = np.maximum(t - start[None, :], 0)
    active = t >= start[None, :]
    read = torch.from_numpy((k - n_delay[None, :]) % buf_len).to(device)
    write = torch.from_numpy(k % buf_len).to(device)
    active_t = torch.from_numpy(active).to(device)
    pre = torch.from_numpy(t < n_pre[None, :]).to(device)
    if couple is not None:
        couple_out = couple.sum(1)
    buf = o0[:, None].expand(p_count, buf_len).contiguous()
    out = torch.empty((n_total, p_count), dtype=torch.float32, device=device)
    o = o0
    for step in range(n_total):
        o_delayed = buf.gather(1, read[step, :, None])[:, 0]
        exchange = None
        if couple is not None:
            cur = torch.where(pre[step], 0.0,
                              torch.where(active_t[step], o, o0))
            exchange = couple @ cur - couple_out * o
        o_new = _euler_step(o, o_delayed, coeff, a, leak, dt, exchange)
        buf.scatter_(1, write[step, :, None], o[:, None])
        o = torch.where(active_t[step], o_new, o)
        out[step] = o
    return torch.where(pre, 0.0, torch.where(active_t, out, o0)).T


def solve_observation_availability_batch(ps: list[FGParams],
                                         sols: MeanFieldSolution, *,
                                         dt: float = 0.05,
                                         tau_max: float | None = None,
                                         strict: bool = False
                                         ) -> DDESolution:
    """Solve Eq. (5)-(6) for a scenario grid in one scan.

    ``sols`` is the batched output of ``solve_fixed_point_batch``
    (leading axis ``len(ps)``). The shared τ grid spans the largest
    per-point ``tau_max`` (default: each point's τ_l); each point's region
    boundaries and delay are its own. Unstable points (infinite ``d_I`` or
    ``d_M``) give o ≡ 0. Row i equals the scalar solver's output on the
    same grid bit for bit."""
    device = sols.a.device
    tau_maxes = [float(tau_max if tau_max is not None else p.tau_l)
                 for p in ps]
    n_total, tau = _grid(max(tau_maxes), dt, device)

    # the scalar solver's region arithmetic, vectorized
    finite, start, n_pre, n_delay, buf_len = _regions(
        sols.d_I.double().cpu().numpy(), sols.d_M.double().cpu().numpy(),
        n_total, dt)

    def f32(vals):
        return torch.tensor(vals, dtype=torch.float32, device=device)

    a = sols.a
    o0 = f32([p.Lam for p in ps]) / torch.ceil(
        torch.clamp_min(a * f32([p.N for p in ps]), 1.0))
    o0 = torch.where(torch.from_numpy(finite).to(device), o0, 0.0)
    w = f32([p.w for p in ps])
    # the scalar solver's operation order (b * S * w * w)
    coeff = sols.b * sols.S * w * w / torch.clamp_min(sols.T_S, 1e-12)
    leak = f32([p.alpha * p.w / p.N for p in ps])
    _check_finite_coeffs(coeff=coeff, a=a, leak=leak, o0=o0)

    o = _integrate_batch(coeff, a, leak, o0, start, n_pre, n_delay, n_total,
                         buf_len, dt)
    converged, residual = _trace_diag(o, dt)
    if strict:
        _strict_trace(converged, what="solve_observation_availability_batch")
    return DDESolution(tau=tau, o=o, dt=dt, converged=converged,
                       residual=residual)


def _regions(d_I: np.ndarray, d_M: np.ndarray, n_total: int, dt: float):
    """Each lane's ``(finite, start, n_pre, n_delay, buf_len)`` on the
    shared grid: the zero region before ``d_I``, the Eq. (6) plateau until
    ``start``, the delay in steps; unstable lanes (infinite delays) are
    pushed past the grid's end and never integrate."""
    finite = np.isfinite(d_I) & np.isfinite(d_M)
    d_I0 = np.where(finite, d_I, 0.0)
    d_M0 = np.where(finite, d_M, 0.0)
    n_pre = np.minimum(np.round(d_I0 / dt).astype(np.int64), n_total)
    n_plateau = np.minimum(np.round(d_M0 / dt).astype(np.int64) + 1,
                           n_total - n_pre)
    n_delay = np.maximum(np.round(d_M0 / dt).astype(np.int64), 1)
    n_pre = np.where(finite, n_pre, n_total)
    n_plateau = np.where(finite, n_plateau, 0)
    start = n_pre + n_plateau
    # lanes that never integrate do not set the shared buffer's length
    n_delay = np.where(start < n_total, n_delay, 1)
    return finite, start, n_pre, n_delay, int(n_delay.max())


def solve_observation_availability_multizone(p: FGParams, mz, *,
                                             dt: float = 0.05,
                                             tau_max: float | None = None,
                                             strict: bool = False
                                             ) -> DDESolution:
    """Zone-coupled Theorem-1 DDE for a multi-zone operating point ``mz``
    (a ``core.meanfield.MultizoneSolution``), on its device.

    Each zone integrates Eq. (5) with its own coefficients (``a_z``,
    ``b_z``, ``S_z``, ``T_S_z``, leak ``alpha_z w / N_z``) and its own
    Eq. (6) plateau ``Lam_z / ceil(a_z N_z)``, plus the migration exchange

        + sum_z' (w R[z, z'] a_z' / (a_z N_z)) (o_z' - o_z):

    holders enter zone ``z`` from ``z'`` at rate ``R[z, z'] a_z'`` carrying
    incorporation probability ``o_z'``. Disjoint zones give the uncoupled
    per-zone solves; unstable zones emit o == 0 and couple as empty. ``o``
    has a leading zone axis."""
    device = mz.a.device
    n_total, tau = _grid(float(tau_max if tau_max is not None else p.tau_l),
                         dt, device)
    finite, start, n_pre, n_delay, buf_len = _regions(
        mz.d_I.double().cpu().numpy(), mz.d_M.double().cpu().numpy(),
        n_total, dt)

    a, N_z = mz.a, mz.N_z
    o0 = mz.Lam_z / torch.ceil(torch.clamp_min(a * N_z, 1.0))
    o0 = torch.where(torch.from_numpy(finite).to(device), o0, 0.0)
    coeff = mz.b * mz.S * p.w * p.w / torch.clamp_min(mz.T_S, 1e-12)
    leak = mz.alpha_z * p.w / N_z
    _check_finite_coeffs(coeff=coeff, a=a, leak=leak, o0=o0)

    R = mz.R.double().cpu().numpy()
    R_off = R - np.diag(np.diag(R))
    a_np = a.double().cpu().numpy()
    holders = np.maximum(a_np * N_z.double().cpu().numpy(), 1e-12)
    couple = p.w * R_off * a_np[None, :] / holders[:, None]
    couple = np.where(finite[:, None] & finite[None, :], couple, 0.0)

    o = _integrate_batch(coeff, a, leak, o0, start, n_pre, n_delay, n_total,
                         buf_len, dt, couple=torch.tensor(
                             couple, dtype=torch.float32, device=device))
    converged, residual = _trace_diag(o, dt)
    if strict:
        _strict_trace(converged,
                      what="solve_observation_availability_multizone")
    return DDESolution(tau=tau, o=o, dt=dt, converged=converged,
                       residual=residual)


def solve_observation_availability_classes(p: FGParams, csol, faults=None,
                                           *, dt: float = 0.05,
                                           tau_max: float | None = None,
                                           strict: bool = False
                                           ) -> DDESolution:
    """Class-weighted Theorem-1 observation availability, on the device of
    ``csol`` (a ``core.meanfield.ClassSolution``; ``faults`` defaults to
    ``p.faults``). Each (class ``c``, zone ``z``) lane integrates Eq. (5)
    with the class fixed point's coefficients: gain ``q_c b S w^2 / T_S``
    (a holder merges only while on), partner availability ``a_serve``,
    leak ``(alpha / N + crash_rate) w``, and the Eq. (6) plateau ``Lam /
    ceil(a_serve N q_bar)``, over the zone's delays.

    ``o`` is ``(C, K, nt)``; :meth:`DDESolution.weighted` collapses the
    class axis. At a disabled configuration (``csol.base`` set) it
    delegates to :func:`solve_observation_availability` (or to
    :func:`solve_observation_availability_multizone` when ``csol.base`` is
    a ``MultizoneSolution``), bit for bit, with weight 1."""
    fc = faults if faults is not None else getattr(p, "faults", None)
    base = csol.base
    if base is not None:
        if isinstance(base, MultizoneSolution):
            sol = solve_observation_availability_multizone(
                p, base, dt=dt, tau_max=tau_max, strict=strict)
            o = sol.o[None, :, :]
        else:
            sol = solve_observation_availability(
                p, base, dt=dt, tau_max=tau_max, strict=strict)
            o = sol.o[None, None, :]
        return DDESolution(
            tau=sol.tau, o=o, dt=dt,
            weights=torch.ones((1,), dtype=torch.float32,
                               device=sol.o.device),
            converged=sol.converged, residual=sol.residual)

    device = csol.a.device
    crash = float(fc.crash_rate) if fc is not None and fc.enabled else 0.0
    C, K = csol.a.shape
    n_total, tau = _grid(float(tau_max if tau_max is not None else p.tau_l),
                         dt, device)

    # the zone's delays, one lane a class
    def lanes(x):
        return np.broadcast_to(x.double().cpu().numpy(), (C, K)).ravel()

    finite, start, n_pre, n_delay, buf_len = _regions(
        lanes(csol.d_I), lanes(csol.d_M), n_total, dt)

    q, a_serve, N_z = csol.q, csol.a_serve, csol.N_z
    coeff_z = csol.b * csol.S * p.w * p.w / torch.clamp_min(csol.T_S, 1e-12)
    coeff = (q[:, None] * coeff_z[None, :]).reshape(-1)
    a_lane = a_serve[None, :].expand(C, K).reshape(-1)
    leak = ((csol.alpha_z / N_z + crash) * p.w)[None, :].expand(C, K)
    o0_z = csol.Lam_z / torch.ceil(
        torch.clamp_min(a_serve * N_z * csol.q_bar, 1.0))
    o0 = o0_z[None, :].expand(C, K).reshape(-1)
    o0 = torch.where(torch.from_numpy(finite).to(device), o0, 0.0)
    leak = leak.reshape(-1)
    _check_finite_coeffs(coeff=coeff, a=a_lane, leak=leak, o0=o0)

    o = _integrate_batch(coeff, a_lane, leak, o0, start, n_pre, n_delay,
                         n_total, buf_len, dt).reshape(C, K, n_total)
    converged, residual = _trace_diag(o, dt)
    if strict:
        _strict_trace(converged,
                      what="solve_observation_availability_classes")
    weights = csol.fracs * q / torch.clamp_min(csol.q_bar, 1e-12)
    return DDESolution(tau=tau, o=o, dt=dt, weights=weights,
                       converged=converged, residual=residual)


def solve_contamination_transient(contam, *, dt: float = 1.0,
                                  t_max: float | None = None,
                                  strict: bool = False) -> DDESolution:
    """Transient of the Byzantine contamination compartment model, on the
    device of ``contam`` (a ``core.meanfield.ContaminationSolution``).
    Each (class ``c``, zone ``z``) lane integrates, from a clean start
    ``x(0) = 0``,

        dx_cz/dt = m_cz (1 - x_cz) [ p_adv_z eta_adv
                     + eta_honest sum_h s_hz x_hz ] - reset_z x_cz,

    the balance whose root ``solve_contamination_classes`` returns, so the
    trace settles onto ``contam.x``. No delay enters (the poison flag moves
    at merge time): a plain Euler scan, a few kernels a step, in a
    ``DDESolution`` with ``o`` of shape (C, K, nt), ``weights = fracs``
    (``weighted()`` gives the population trace) and the usual diagnostics.
    With no adversarial class the trace is identically zero.

    ``t_max`` defaults to eight relaxation times of the slowest lane (its
    rate is at least ``m p_adv eta_adv + reset``)."""
    m, reset, p_adv, honest_n = (
        torch.as_tensor(v).float() for v in
        (contam.m, contam.reset, contam.p_adv, contam.honest_n))
    e_a, e_h = (torch.as_tensor(v).float()
                for v in (contam.eta_adv, contam.eta_honest))
    _check_finite_coeffs(m=m, reset=reset, p_adv=p_adv, honest_n=honest_n,
                         eta=torch.stack([e_a, e_h]))

    if t_max is None:
        rate = float((m * (p_adv * e_a)[None, :] + reset[None, :]).min())
        t_max = 8.0 / max(rate, 1e-6)
    n_steps = min(max(int(round(float(t_max) / dt)), 1), 1_000_000)
    tau = torch.arange(n_steps + 1, dtype=torch.float32,
                       device=m.device) * dt

    dt_t = torch.tensor(dt, dtype=torch.float32, device=m.device)
    o = torch.zeros(m.shape + (n_steps + 1,), dtype=torch.float32,
                    device=m.device)
    x = o[..., 0]
    for i in range(1, n_steps + 1):
        poi = _poison_intensity(p_adv, e_a, e_h, honest_n, x)
        # XLA contracts repro's `m*(1-x)*poi - reset*x` and `x + dt*dx`
        dx = fma32(m * (1.0 - x), poi[None, :], -(reset[None, :] * x))
        x = torch.clamp(fma32(dt_t, dx, x), 0.0, 1.0)
        o[..., i] = x
    converged, residual = _trace_diag(o, dt)
    if strict:
        _strict_trace(converged, what="solve_contamination_transient")
    return DDESolution(tau=tau, o=o, dt=dt, weights=contam.fracs,
                       converged=converged, residual=residual)
