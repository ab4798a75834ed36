"""The port's analytics against ``repro``'s, on the same inputs (CPU).

* The contact models' arrays (``rdm_contact_model``,
  ``paper_contact_model``): rtol 1e-6.
* ``solve_fixed_point`` on ``tests/test_meanfield.py``'s λ × M grid: every
  field within rtol 1e-5, and ``converged``; ``transfer_stats`` (with and
  without a link failure rate), ``merge_arrival_rate``,
  ``queueing_delays`` and ``stability_lhs`` likewise; +inf outside the
  stability region in both packages; ``strict=True`` and a NaN parameter
  raise in both.
* The batched solvers: each row equals the port's own scalar solve bit
  for bit, and ``repro``'s batch within rtol 1e-5.
* The Theorem-1 DDE: o(τ) within atol 1e-5, ``integral(τ_l)`` within rtol
  1e-4 (``repro``'s jitted Euler step contracts its products into fused
  multiply-adds; the port's does not).
* Lemma 4, Problem 1 and Theorem 2 (``node_stored_information``,
  ``learning_capacity(_batch)``, ``solve_learning_capacity``,
  ``staleness_lower_bound(_batch)``): rtol 1e-4.
* ``protocol_from_meanfield``: the same gates.
* The entry points default to ``cuda`` and raise without a card.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import fg_paper as r_paper
from repro.core import capacity as r_cap
from repro.core import dde as r_dde
from repro.core import gossip as r_gossip
from repro.core import meanfield as r_mf
from repro.core import mobility as r_mob
from repro.core import staleness as r_stale
from repro_torch.configs import fg_paper as t_paper
from repro_torch.core import capacity as t_cap
from repro_torch.core import dde as t_dde
from repro_torch.core import gossip as t_gossip
from repro_torch.core import meanfield as t_mf
from repro_torch.core import mobility as t_mob
from repro_torch.core import staleness as t_stale

GRID = [(lam, M) for lam in (0.01, 0.05, 0.2) for M in (1, 4)]
FIELDS = ("a", "b", "S", "T_S", "r", "d_M", "d_I", "stability", "rho",
          "residual")
CM_R = r_paper.paper_contact_model()
CM_T = t_paper.paper_contact_model(device="cpu")


def _np(x):
    return x.numpy() if torch.is_tensor(x) else np.asarray(x)


def _close(got, want, rtol, atol=0.0, what=""):
    np.testing.assert_allclose(_np(got), _np(want), rtol=rtol, atol=atol,
                               err_msg=what)


def _pair(**kw):
    return r_paper.paper_params(**kw), t_paper.paper_params(**kw)


def _same_solution(t_sol, r_sol, rtol=1e-5):
    for f in FIELDS:
        _close(getattr(t_sol, f), getattr(r_sol, f), rtol, atol=1e-30,
               what=f)
    np.testing.assert_array_equal(_np(t_sol.converged), _np(r_sol.converged))


def _same_bits(x, y, what=""):
    x, y = _np(x), _np(y)
    assert x.shape == y.shape and x.dtype == y.dtype, what
    assert np.array_equal(x.view(np.uint32), y.view(np.uint32)), what


@pytest.mark.parametrize("kw", [
    dict(speed=1.0, r_tx=5.0, density=5e-3),
    dict(speed=0.3, r_tx=5.0, density=5e-3, nt=64),
    dict(speed=2.5, r_tx=12.0, density=1e-3, nt=1000),
])
def test_rdm_contact_model_matches(kw):
    r, t = r_mob.rdm_contact_model(**kw), t_mob.rdm_contact_model(
        **kw, device="cpu")
    for f in ("g", "t_grid", "pdf", "weights"):
        got = getattr(t, f)
        assert got.dtype == torch.float32 and got.device.type == "cpu"
        _close(got, getattr(r, f), 1e-6, what=f)
    _close(t.mean_duration, r.mean_duration, 1e-6)
    _close(t.expect(lambda x: x * x), r.expect(lambda x: x * x), 1e-6)


@pytest.mark.parametrize("speed", [0.5, 1.0, 2.0])
def test_paper_contact_model_matches(speed):
    r = r_paper.paper_contact_model(speed=speed)
    t = t_paper.paper_contact_model(speed=speed, device="cpu")
    for f in ("g", "t_grid", "pdf", "weights"):
        _close(getattr(t, f), getattr(r, f), 1e-6, what=f)


def test_speed_range_contact_model_matches():
    """U(lo, hi) speeds: the port's quadrature runs in float64, the
    reference's mean in float32 over 2.4M terms, and the two relative
    speeds differ by 1.3e-6 of their value. So g and the bin centers
    agree to rtol 2e-6; the bin widths (differences of neighbouring edges,
    each an ulp apart in the two) and the densities (the chord CDF's slope
    grows without bound at the support's end) to rtol 1e-4."""
    kw = dict(speed=1.0, r_tx=5.0, density=5e-3, speed_range=(0.1, 1.9))
    r, t = r_mob.rdm_contact_model(**kw), t_mob.rdm_contact_model(
        **kw, device="cpu")
    for f in ("g", "t_grid"):
        _close(getattr(t, f), getattr(r, f), 2e-6, what=f)
    for f in ("pdf", "weights"):
        _close(getattr(t, f), getattr(r, f), 1e-4, what=f)
    np.testing.assert_allclose(t_mob.mean_relative_speed_uniform(1.0, 1.0),
                               4.0 / np.pi, rtol=1e-3)


def test_contact_model_registry():
    with pytest.raises(ValueError, match="unknown mobility model"):
        t_mob.contact_model_for("levy", speed=1.0, r_tx=5.0, density=1e-3)
    # the rwp and manhattan twins, refused until the mobility slice, build
    for name in ("rwp", "manhattan"):
        t = t_paper.paper_contact_model(mobility=name, device="cpu")
        r = r_paper.paper_contact_model(mobility=name)
        for f in ("g", "t_grid", "pdf", "weights"):
            _same_bits(getattr(t, f), getattr(r, f), f"{name} {f}")


@pytest.mark.parametrize("lam,M", GRID)
def test_fixed_point_matches(lam, M):
    pr, pt = _pair(lam=lam, M=M)
    t_sol = t_mf.solve_fixed_point(pt, CM_T)
    _same_solution(t_sol, r_mf.solve_fixed_point(pr, CM_R))
    assert bool(t_sol.converged) and bool(t_sol.stable)
    assert t_sol.a.shape == () and t_sol.a.dtype == torch.float32


@pytest.mark.parametrize("fail_rate", [None, 0.02])
@pytest.mark.parametrize("a", [1e-3, 0.3, 0.95])
def test_transfer_stats_matches(a, fail_rate):
    pr, pt = _pair(lam=0.05, M=3)
    got = t_mf.transfer_stats(torch.tensor(a), pt, CM_T, fail_rate=fail_rate)
    want = r_mf.transfer_stats(jnp.float32(a), pr, CM_R, fail_rate=fail_rate)
    for g, w in zip(got, want):
        _close(g, w, 1e-5)


def test_rates_delays_and_stability_match():
    pr, pt = _pair(lam=0.05, M=3)
    r_sol = r_mf.solve_fixed_point(pr, CM_R)
    t_sol = t_mf.solve_fixed_point(pt, CM_T)
    r = t_mf.merge_arrival_rate(t_sol.a, t_sol.b, t_sol.S, pt, CM_T)
    _close(r, r_mf.merge_arrival_rate(r_sol.a, r_sol.b, r_sol.S, pr, CM_R),
           1e-5)
    for got, want in zip(t_mf.queueing_delays(r, pt),
                         r_mf.queueing_delays(jnp.asarray(_np(r)), pr)):
        _close(got, want, 1e-5)
    d_M, d_I = t_mf.queueing_delays(r, pt)
    for got, want in zip(t_mf.stability_lhs(r, d_M, d_I, pt),
                         r_mf.stability_lhs(jnp.asarray(_np(r)), None, None,
                                            pr)):
        _close(got, want, 1e-5)


@pytest.mark.parametrize("r", [1.0 / 2.5 + 1.0, 0.4, 10.0])
def test_unstable_delays_and_stability_are_inf(r):
    pr, pt = _pair(lam=0.05, M=1)
    rt = torch.tensor(r, dtype=torch.float32)
    got = (*t_mf.queueing_delays(rt, pt),
           t_mf.stability_lhs(rt, None, None, pt)[0])
    want = (*r_mf.queueing_delays(jnp.float32(r), pr),
            r_mf.stability_lhs(jnp.float32(r), None, None, pr)[0])
    for g, w in zip(got, want):
        assert float(g) == float(w) == float("inf")
    # far past stability, the solver itself reports it
    pr, pt = _pair(lam=50.0, M=8)
    t_sol = t_mf.solve_fixed_point(pt, CM_T)
    r_sol = r_mf.solve_fixed_point(pr, CM_R)
    assert not bool(t_sol.stable) and not bool(r_sol.stable)
    assert float(t_sol.d_I) == float(r_sol.d_I) == float("inf")


def test_strict_and_non_finite_inputs_raise_in_both():
    pr, pt = _pair(lam=0.05, M=1)
    for mf, p, cm in ((r_mf, pr, CM_R), (t_mf, pt, CM_T)):
        with pytest.raises(RuntimeError, match="did not converge"):
            mf.solve_fixed_point(p, cm, iters=1, strict=True)
        with pytest.raises(RuntimeError, match="did not converge"):
            mf.solve_fixed_point_batch([p, p], cm, iters=1, strict=True)
        sol = mf.solve_fixed_point(p, cm, iters=1)
        assert not bool(sol.converged)
        with pytest.raises(ValueError, match="'lam'"):
            mf.solve_fixed_point(p.replace(lam=float("nan")), cm)
        with pytest.raises(ValueError, match="'T_M'"):
            mf.solve_fixed_point_batch([p, p.replace(T_M=float("inf"))], cm)
    bad = dataclasses.replace(CM_T, g=torch.tensor(float("nan")))
    with pytest.raises(ValueError, match="contact.g"):
        t_mf.solve_fixed_point(pt, bad)


def _batch_grid():
    kws = [dict(lam=lam, M=M) for lam, M in GRID] + [
        dict(lam=0.05, M=4, Lam=2.0), dict(lam=0.5, M=2, T_T=0.5, T_M=0.25),
        dict(lam=50.0, M=8)]                                # unstable
    return ([r_paper.paper_params(**kw) for kw in kws],
            [t_paper.paper_params(**kw) for kw in kws])


def test_fixed_point_batch_rows_equal_scalar_and_match_reference():
    rps, tps = _batch_grid()
    t_batch = t_mf.solve_fixed_point_batch(tps, CM_T)
    r_batch = r_mf.solve_fixed_point_batch(rps, CM_R)
    assert t_batch.a.shape == (len(tps),)
    _same_solution(t_batch, r_batch)
    for i, p in enumerate(tps):
        scalar = t_mf.solve_fixed_point(p, CM_T)
        for f in FIELDS:
            _same_bits(getattr(t_batch.point(i), f), getattr(scalar, f),
                       f"{f} at point {i}")


@pytest.mark.parametrize("lam,M", GRID)
def test_dde_matches(lam, M):
    pr, pt = _pair(lam=lam, M=M)
    r_d = r_dde.solve_observation_availability(
        pr, r_mf.solve_fixed_point(pr, CM_R))
    t_d = t_dde.solve_observation_availability(
        pt, t_mf.solve_fixed_point(pt, CM_T))
    _close(t_d.tau, r_d.tau, 1e-6)
    _close(t_d.o, r_d.o, 0.0, atol=1e-5)
    _close(t_d.integral(pt.tau_l), r_d.integral(pr.tau_l), 1e-4)
    _close(t_d.incorporation_rate(lam), r_d.incorporation_rate(lam), 0.0,
           atol=1e-6)
    assert bool(t_d.converged)
    _close(t_d.residual, r_d.residual, 0.0, atol=1e-4)


def test_unstable_dde_returns_zeros():
    pr, pt = _pair(lam=50.0, M=8)
    r_d = r_dde.solve_observation_availability(
        pr, r_mf.solve_fixed_point(pr, CM_R))
    t_d = t_dde.solve_observation_availability(
        pt, t_mf.solve_fixed_point(pt, CM_T))
    assert t_d.o.shape == r_d.o.shape
    assert not torch.any(t_d.o) and not np.any(np.asarray(r_d.o))
    assert float(t_d.integral(pt.tau_l)) == 0.0


def test_dde_batch_rows_equal_scalar_and_match_reference():
    rps, tps = _batch_grid()
    t_sols = t_mf.solve_fixed_point_batch(tps, CM_T)
    t_b = t_dde.solve_observation_availability_batch(tps, t_sols, dt=0.1)
    r_b = r_dde.solve_observation_availability_batch(
        rps, r_mf.solve_fixed_point_batch(rps, CM_R), dt=0.1)
    assert t_b.o.shape == r_b.o.shape == (len(tps), 3001)
    _close(t_b.o, r_b.o, 0.0, atol=1e-5)
    tau_l = torch.tensor([p.tau_l for p in tps])
    _close(t_b.integral(tau_l),
           r_b.integral(jnp.asarray([p.tau_l for p in rps])), 1e-4,
           atol=1e-6)
    for i, p in enumerate(tps):
        scalar = t_dde.solve_observation_availability(
            p, t_mf.solve_fixed_point(p, CM_T), dt=0.1)
        _same_bits(t_b.point(i).o[: scalar.o.shape[0]], scalar.o,
                   f"point {i}")
    assert not torch.any(t_b.o[-1])


@pytest.mark.parametrize("lam,M", [(0.02, 1), (0.05, 1), (0.2, 4)])
def test_stored_information_capacity_and_staleness_match(lam, M):
    pr, pt = _pair(lam=lam, M=M)
    r_sol, t_sol = (r_mf.solve_fixed_point(pr, CM_R),
                    t_mf.solve_fixed_point(pt, CM_T))
    r_d = r_dde.solve_observation_availability(pr, r_sol, dt=0.1)
    t_d = t_dde.solve_observation_availability(pt, t_sol, dt=0.1)
    r_int, t_int = r_d.integral(pr.tau_l), t_d.integral(pt.tau_l)
    _close(t_cap.node_stored_information(pt, t_sol, t_int),
           r_cap.node_stored_information(pr, r_sol, r_int), 1e-4)
    _close(t_cap.learning_capacity(pt, t_sol, t_int),
           r_cap.learning_capacity(pr, r_sol, r_int), 1e-4)
    _close(t_stale.staleness_lower_bound(pt, t_d),
           r_stale.staleness_lower_bound(pr, r_d), 1e-4)
    _close(t_stale.erlang_weighted_o(t_d, lam, pt.tau_l, 12),
           r_stale.erlang_weighted_o(r_d, lam, pr.tau_l, 12), 1e-4,
           atol=1e-7)
    assert (t_stale._default_i_max(pt.lam, pt.tau_l)
            == r_stale._default_i_max(pr.lam, pr.tau_l))


def test_capacity_and_staleness_batches_match():
    rps, tps = _batch_grid()
    t_sols = t_mf.solve_fixed_point_batch(tps, CM_T)
    r_sols = r_mf.solve_fixed_point_batch(rps, CM_R)
    t_b = t_dde.solve_observation_availability_batch(tps, t_sols, dt=0.1)
    r_b = r_dde.solve_observation_availability_batch(rps, r_sols, dt=0.1)
    t_int = t_b.integral(torch.tensor([p.tau_l for p in tps]))
    r_int = r_b.integral(jnp.asarray([p.tau_l for p in rps]))
    caps = t_cap.learning_capacity_batch(tps, t_sols, t_int)
    _close(caps, r_cap.learning_capacity_batch(rps, r_sols, r_int), 1e-4,
           atol=1e-7)
    assert float(caps[-1]) == 0.0                       # the unstable point
    stable = slice(0, len(tps) - 1)   # the unstable point's bound is inf
    _close(t_stale.staleness_lower_bound_batch(tps, t_b)[stable],
           r_stale.staleness_lower_bound_batch(rps, r_b)[stable], 1e-4)


def test_solve_learning_capacity_matches():
    pr, pt = _pair(lam=0.05)
    r_best = r_cap.solve_learning_capacity(pr, CM_R, L_m=10e3, M_max=8,
                                           dt=0.1)
    t_best = t_cap.solve_learning_capacity(pt, CM_T, L_m=10e3, M_max=8,
                                           dt=0.1)
    assert t_best.M == r_best.M and t_best.L == r_best.L == 10e3
    _close(t_best.capacity, r_best.capacity, 1e-4)
    _close(t_best.stored, r_best.stored, 1e-4)
    assert bool(t_best.sol.stable) and float(t_best.capacity) > 0.0
    # unstable even at M = 1: the objective is 0
    pr, pt = _pair(lam=50.0)
    t_none = t_cap.solve_learning_capacity(pt, CM_T, L_m=10e3, M_max=2)
    r_none = r_cap.solve_learning_capacity(pr, CM_R, L_m=10e3, M_max=2)
    assert t_none.M == r_none.M == 1
    assert float(t_none.capacity) == float(r_none.capacity) == 0.0


def test_protocol_from_meanfield_matches():
    pr, pt = _pair(lam=0.05, M=1)
    r_cfg = r_gossip.protocol_from_meanfield(
        pr, r_mf.solve_fixed_point(pr, CM_R), round_interval=2.0, seed=3)
    t_cfg = t_gossip.protocol_from_meanfield(
        pt, t_mf.solve_fixed_point(pt, CM_T), round_interval=2.0, seed=3)
    for f in dataclasses.fields(t_cfg):
        assert getattr(t_cfg, f.name) == getattr(r_cfg, f.name), f.name


def test_entry_points_default_to_cuda_and_raise_without_one(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        t_paper.paper_contact_model()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        t_mob.rdm_contact_model(speed=1.0, r_tx=5.0, density=5e-3)
    # the solvers compute where the contact model's tensors are
    pt = t_paper.paper_params()
    sol = t_mf.solve_fixed_point(pt, CM_T)
    d = t_dde.solve_observation_availability(pt, sol, dt=0.5)
    assert sol.a.device.type == d.o.device.type == "cpu"
