"""The port's main path held to the paper's analytics (the free-run check
of ``tests/test_sim_vs_meanfield.py``, on the port).

A 12000-slot free run of ``repro_torch.sim.simulate`` at the paper point
(``paper_params(lam=0.05, M=1)``, sample every 24 slots, seed 0, on the
CPU) against the port's own Lemma 1-3 fixed point, Theorem-1 DDE and
Lemma 4 stored information, over the second half of the samples, with the
reference test's thresholds: population within 5% of N; availability
within 15%, the mean field no more than 0.02 below the run; busy fraction
within 50%; stored information with mf/sim < 2.0 and mf >= sim - 0.5; the
operating point well inside stability (Eq. 3 LHS < 0.5) with S > 0.95.
The port's mean-field side is also held to ``repro``'s analytics.

The run takes about 110 s on two CPU threads, so the module is marked
``slow``, as its reference is.
"""

import numpy as np
import pytest
import torch

from repro.configs import fg_paper as r_paper
from repro.core import capacity as r_cap
from repro.core import dde as r_dde
from repro.core import meanfield as r_mf
from repro_torch.configs.fg_paper import paper_contact_model, paper_params
from repro_torch.core.capacity import node_stored_information
from repro_torch.core.dde import solve_observation_availability
from repro_torch.core.meanfield import solve_fixed_point
from repro_torch.sim import SimConfig, simulate

pytestmark = pytest.mark.slow


@pytest.fixture(scope="module")
def run():
    threads = torch.get_num_threads()
    torch.set_num_threads(min(threads, 2))
    try:
        p = paper_params(lam=0.05, M=1)
        sol = solve_fixed_point(p, paper_contact_model(device="cpu"))
        dde = solve_observation_availability(p, sol)
        out = simulate(p, SimConfig(n_slots=12000, sample_every=24), seed=0,
                       device="cpu")
    finally:
        torch.set_num_threads(threads)
    return p, sol, dde, out, len(out.t) // 2


def test_population_matches(run):
    p, sol, dde, out, s0 = run
    n_sim = float(out.n_in_rz[s0:].mean())
    assert abs(n_sim - p.N) / p.N < 0.05


def test_availability_matches(run):
    p, sol, dde, out, s0 = run
    a_sim = float(out.availability[s0:].mean())
    a_mf = float(sol.a)
    assert abs(a_mf - a_sim) / a_sim < 0.15
    assert a_mf >= a_sim - 0.02  # mean field optimistic, not pessimistic


def test_busy_prob_matches(run):
    p, sol, dde, out, s0 = run
    b_sim = float(out.busy_frac[s0:].mean())
    assert abs(float(sol.b) - b_sim) / max(b_sim, 1e-6) < 0.5


def test_stored_info_matches(run):
    p, sol, dde, out, s0 = run
    mf = float(node_stored_information(p, sol, dde.integral(p.tau_l)))
    sim = float(out.stored_info[s0:].mean())
    assert sim > 0
    assert mf / sim < 2.0
    assert mf >= sim - 0.5


def test_substable_regime_holds(run):
    p, sol, dde, out, s0 = run
    assert float(sol.stability) < 0.5
    assert float(sol.S) > 0.95


def test_mean_field_side_matches_the_reference(run):
    """The thresholds above compare the run with the port's analytics;
    these are ``repro``'s own, to the analytics tests' tolerances."""
    p, sol, dde, out, s0 = run
    rp = r_paper.paper_params(lam=0.05, M=1)
    r_sol = r_mf.solve_fixed_point(rp, r_paper.paper_contact_model())
    r_d = r_dde.solve_observation_availability(rp, r_sol)
    for f in ("a", "b", "S", "stability"):
        np.testing.assert_allclose(float(getattr(sol, f)),
                                   float(getattr(r_sol, f)), rtol=1e-5,
                                   err_msg=f)
    np.testing.assert_allclose(dde.o.numpy(), np.asarray(r_d.o), rtol=0,
                               atol=1e-5)
    np.testing.assert_allclose(
        float(node_stored_information(p, sol, dde.integral(p.tau_l))),
        float(r_cap.node_stored_information(rp, r_sol,
                                            r_d.integral(rp.tau_l))),
        rtol=1e-4)
