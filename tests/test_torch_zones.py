"""The port's multi-zone geometry and analytics against ``repro``'s, on
the CPU.

1. ``repro_torch.core.zones``: ``migration_rate_matrix``, ``lens_area``,
   ``union_area``, ``_arc_inside``, ``mean_relative_speed`` and
   ``ZoneSet.centers_at`` equal ``repro``'s in float64 (disjoint,
   overlapping, contained and drifting discs), and
   ``tests/test_sim_zones.py:263-325``'s geometry checks hold on the port.
2. ``solve_fixed_point_multizone`` at K = 1, 2, 3 and a drifting set
   equals ``repro``'s bit for bit at M = 1 (also after a few iterations
   from random geometries, where the pinned contractions show: the zone sum
   ``R_off @ a`` as a chain of fused multiply-adds, the root's ``H*H + 4 G
   (lt + inj)`` and the occupation bound as XLA contracts them in the loop,
   the residual step eager) and within a few steps of Lemma 1's float32
   busy-probability grid at M = 3 (``tests/test_torch_faults.py``);
   ``solve_observation_availability_multizone`` within atol 1e-6 (the
   scalar DDE's 1e-5, tighter since the port reaches it).
3. The k = 1 collapse to ``solve_fixed_point`` and the scalar DDE, and the
   coupling lifting a weak zone (``tests/test_sim_zones.py:327-377``).
4. The class solvers' zone branches: the class fixed point with a
   ``ZoneSet`` within a few busy-probability steps of ``repro``'s (its
   link-failure integrand's ``exp`` is not bit for bit), its DDE within
   atol 1e-5 on ``repro``'s class solution carried across, the disabled
   configuration delegating to the multizone solvers bit for bit, and the
   contamination solver with zones bit for bit on the same class solution.
"""

import dataclasses

import numpy as np
import pytest
import torch

from repro.configs import fg_adversarial as rfa
from repro.configs import fg_faults as rff
from repro.configs.fg_paper import paper_contact_model as r_contact
from repro.configs.fg_paper import paper_params as r_paper_params
from repro.core import dde as r_dde
from repro.core import meanfield as r_mf
from repro.core import zones as r_zones
from repro_torch.configs import fg_adversarial as tfa
from repro_torch.configs import fg_faults as tff
from repro_torch.configs.fg_paper import (DENSITY, paper_contact_model,
                                          paper_params)
from repro_torch.core import dde as t_dde
from repro_torch.core import meanfield as t_mf
from repro_torch.core import zones as t_zones

CM_R = r_contact()
CM_T = paper_contact_model(device="cpu")
ZONES = {
    "k1": dict(centers=((100.0, 100.0),), radii=(100.0,)),
    "k2": dict(centers=((75.0, 100.0), (125.0, 100.0)), radii=(60.0, 60.0)),
    "k3": dict(centers=((60.0, 100.0), (110.0, 100.0), (140.0, 140.0)),
               radii=(45.0, 40.0, 37.0)),
    "drift": dict(centers=((60.0, 100.0), (110.0, 100.0), (140.0, 140.0)),
                  radii=(45.0, 40.0, 37.0),
                  drift=((0.0, 0.0), (0.3, -0.2), (0.0, 0.7))),
}
#: The drifting set is solved at t = 13 s in the paper's 200 m square.
WHEN = {"drift": dict(t=13.0, area_side=200.0)}
MZ_FIELDS = ("a", "b", "S", "T_S", "r", "d_M", "d_I", "stability", "rho",
             "N_z", "alpha_z", "Lam_z", "R", "residual")
CLASS_FIELDS = ("a", "a_serve", "q", "q_bar", "fracs", "b", "S", "T_S",
                "N_z", "alpha_z", "Lam_z", "r", "d_M", "d_I")
CLASS_INPUTS = ("q", "q_bar", "fracs", "N_z", "alpha_z", "Lam_z")
#: Steps of Lemma 1's float32 busy-probability grid a solution may wander
#: (tests/test_torch_faults.py::QUANTUM_STEPS).
QUANTUM_STEPS = 3


def _zs(name):
    kw = ZONES[name]
    return r_zones.ZoneSet(**kw), t_zones.ZoneSet(**kw)


def _bits(a):
    a = np.asarray(a)
    return a.view(np.int32) if a.dtype == np.float32 else a


def _same(got, want, what=""):
    got = got.numpy() if torch.is_tensor(got) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape and got.dtype == want.dtype, (
        what, got.shape, want.shape, got.dtype, want.dtype)
    np.testing.assert_array_equal(_bits(got), _bits(want), err_msg=what)


def _busy_step(b: np.ndarray) -> np.ndarray:
    """One float32 step of Lemma 1's busy probability, relative to ``b``:
    ulp(K) / b with K = (b + 1/b) / 2."""
    b = np.asarray(b, np.float64)
    return np.spacing(((b + 1.0 / b) / 2.0).astype(np.float32)) / b


# --------------------------------------------------------- 1. geometry

GEOMETRY = [
    ((0.0, 0.0), 10.0, (30.0, 0.0), 10.0),        # disjoint
    ((0.0, 0.0), 10.0, (20.0, 0.0), 10.0),        # touching
    ((0.0, 0.0), 50.0, (30.0, 10.0), 40.0),       # overlapping
    ((100.0, 100.0), 30.0, (100.0, 100.0), 80.0),  # concentric
    ((100.0, 100.0), 80.0, (110.0, 90.0), 20.0),  # contained
    ((12.3, 45.6), 17.7, (31.9, 40.2), 9.1),
]


@pytest.mark.parametrize("c1,r1,c2,r2", GEOMETRY)
def test_disc_geometry_equals_repro(c1, r1, c2, r2):
    for fn in ("lens_area", "_arc_inside"):
        for args in ((c1, r1, c2, r2), (c2, r2, c1, r1)):
            got = getattr(t_zones, fn)(*args)
            assert got == getattr(r_zones, fn)(*args), (fn, args)
    centers = np.asarray([c1, c2, (c1[0] + 5.0, c1[1] - 7.0)])
    radii = np.asarray([r1, r2, 11.0])
    assert t_zones.union_area(centers, radii) == \
        r_zones.union_area(centers, radii)


@pytest.mark.parametrize("name", list(ZONES) + ["grid32"])
def test_migration_matrix_equals_repro(name):
    kw = ZONES.get(name) or dict(
        centers=tuple((12.5 + 25.0 * (z % 8), 25.0 + 50.0 * (z // 8))
                      for z in range(32)), radii=(14.0,) * 32)
    rz, tz = r_zones.ZoneSet(**kw), t_zones.ZoneSet(**kw)
    for t in (0.0, 13.0, 411.75):
        for side in (None, 200.0):
            want = r_zones.migration_rate_matrix(
                rz, density=DENSITY, speed=1.0, t=t, area_side=side)
            got = t_zones.migration_rate_matrix(
                tz, density=DENSITY, speed=1.0, t=t, area_side=side)
            assert got.dtype == want.dtype == np.float64
            np.testing.assert_array_equal(got, want)
        if tz.moving:
            np.testing.assert_array_equal(tz.centers_at(t, 200.0),
                                          rz.centers_at(t, 200.0))
    np.testing.assert_array_equal(tz.drift_speeds(), rz.drift_speeds())
    assert t_zones.__all__ == r_zones.__all__


@pytest.mark.parametrize("v,u", [(1.0, 0.0), (1.0, 1.0), (1.0, 50.0),
                                 (1.3, 0.7), (0.4, 2.9)])
def test_mean_relative_speed_equals_repro(v, u):
    assert t_zones.mean_relative_speed(v, u) == \
        r_zones.mean_relative_speed(v, u)
    assert t_zones.mean_relative_speed(v, u, n_theta=37) == \
        r_zones.mean_relative_speed(v, u, n_theta=37)


def test_mean_relative_speed_limits():
    assert t_zones.mean_relative_speed(1.0, 0.0) == 1.0
    assert t_zones.mean_relative_speed(1.0, 50.0) == pytest.approx(
        50.0, rel=0.01)
    assert t_zones.mean_relative_speed(1.0, 1.0) == pytest.approx(
        4.0 / np.pi, rel=1e-3)


def test_migration_matrix_geometry():
    mrm = t_zones.migration_rate_matrix
    R = mrm(t_zones.single_zone((100.0, 100.0), 100.0), density=DENSITY,
            speed=1.0)
    assert R.shape == (1, 1)
    np.testing.assert_allclose(R[0, 0], 2.0 * DENSITY * 100.0)
    R2 = mrm(t_zones.ZoneSet(centers=((50.0, 100.0), (150.0, 100.0)),
                             radii=(45.0, 45.0)), density=DENSITY, speed=1.0)
    assert R2[0, 1] == 0.0 and R2[1, 0] == 0.0
    R3 = mrm(t_zones.ZoneSet(centers=((70.0, 100.0), (130.0, 100.0)),
                             radii=(50.0, 50.0)), density=DENSITY, speed=1.0)
    assert R3[0, 1] == pytest.approx(R3[1, 0])
    assert 0.0 < R3[0, 1] < R3[0, 0]
    R4 = mrm(t_zones.ZoneSet(centers=((100.0, 100.0), (100.0, 100.0)),
                             radii=(30.0, 80.0)), density=DENSITY, speed=1.0)
    np.testing.assert_allclose(R4[0, 1], R4[0, 0])
    assert R4[1, 0] == 0.0


def test_migration_matrix_tracks_drifting_zones():
    zs = t_zones.ZoneSet(centers=((40.0, 100.0), (160.0, 100.0)),
                         radii=(40.0, 40.0),
                         drift=((1.0, 0.0), (-1.0, 0.0)))
    R0 = t_zones.migration_rate_matrix(zs, density=DENSITY, speed=1.0,
                                       t=0.0, area_side=200.0)
    R30 = t_zones.migration_rate_matrix(zs, density=DENSITY, speed=1.0,
                                        t=30.0, area_side=200.0)
    assert R0[0, 1] == 0.0 and R30[0, 1] > 0.0 and R30[1, 0] > 0.0
    Rs = t_zones.migration_rate_matrix(
        t_zones.single_zone((40.0, 100.0), 40.0), density=DENSITY, speed=1.0)
    assert R0[0, 0] > Rs[0, 0]
    p = paper_params(lam=0.05, M=1)
    mz0, mz30 = (t_mf.solve_fixed_point_multizone(
        p, CM_T, zs, density=DENSITY, speed=1.0, t=t, area_side=200.0)
        for t in (0.0, 30.0))
    assert float(mz0.R[0, 1]) == 0.0 and float(mz30.R[0, 1]) > 0.0


# ----------------------------------------------- 2. the coupled fixed point

def _pair(name, M, **kw):
    rz, tz = _zs(name)
    when = dict(WHEN.get(name, {}), **kw)
    r = r_mf.solve_fixed_point_multizone(
        r_paper_params(lam=0.05, M=M), CM_R, rz, density=DENSITY, speed=1.0,
        **when)
    t = t_mf.solve_fixed_point_multizone(
        paper_params(lam=0.05, M=M), CM_T, tz, density=DENSITY, speed=1.0,
        **when)
    return r, t


@pytest.mark.parametrize("name", list(ZONES))
def test_multizone_fixed_point_equals_repro_bitwise_at_m1(name):
    r, t = _pair(name, 1)
    for f in MZ_FIELDS:
        _same(getattr(t, f), getattr(r, f), f)
    assert bool(t.converged) == bool(r.converged)
    _same(t.stable, r.stable, "stable")


@pytest.mark.parametrize("seed", [0, 1, 2, 32])
def test_multizone_iteration_pins_its_contractions(seed):
    """A few damped steps from random overlapping triples, where the zone
    sum, the root and the occupation bound round otherwise than unfused
    (the unfused root fails seeds 1 and 2, the unfused zone sum seed 2,
    the unfused occupation bound seed 32): ``a`` and the eager residual
    equal ``repro``'s bit for bit."""
    rng = np.random.default_rng(seed)
    kw = dict(centers=tuple(map(tuple, rng.uniform(60, 140, (3, 2)))),
              radii=tuple(rng.uniform(30, 60, 3)))
    for iters in (2, 3, 5, 9):
        r = r_mf.solve_fixed_point_multizone(
            r_paper_params(lam=0.05, M=1), CM_R, r_zones.ZoneSet(**kw),
            density=DENSITY, speed=1.0, iters=iters)
        t = t_mf.solve_fixed_point_multizone(
            paper_params(lam=0.05, M=1), CM_T, t_zones.ZoneSet(**kw),
            density=DENSITY, speed=1.0, iters=iters)
        _same(t.a, r.a, f"a iters={iters}")
        _same(t.residual, r.residual, f"residual iters={iters}")


@pytest.mark.parametrize("name", ["k2", "k3", "drift"])
def test_multizone_fixed_point_within_busy_steps_at_m3(name):
    r, t = _pair(name, 3)
    steps = QUANTUM_STEPS * _busy_step(np.asarray(r.b))
    for f in MZ_FIELDS[:-1]:
        want = np.asarray(getattr(r, f))
        got = getattr(t, f).numpy()
        assert got.shape == want.shape and got.dtype == want.dtype, f
        rtol = steps * (1.0 - want) if f == "a" else steps
        if f in ("N_z", "alpha_z", "Lam_z", "R"):
            rtol = 0.0
        assert np.all(np.abs(got - want) <= rtol * np.abs(want)), (f, got,
                                                                  want)


@pytest.mark.parametrize("name", list(ZONES))
def test_multizone_dde_equals_repro(name):
    r, t = _pair(name, 1)
    p_r, p_t = r_paper_params(lam=0.05, M=1), paper_params(lam=0.05, M=1)
    rd = r_dde.solve_observation_availability_multizone(p_r, r)
    td = t_dde.solve_observation_availability_multizone(p_t, t, strict=True)
    assert td.o.shape == rd.o.shape == (len(ZONES[name]["radii"]), 6001)
    np.testing.assert_allclose(td.o.numpy(), np.asarray(rd.o), rtol=0,
                               atol=1e-6)
    _same(td.tau, rd.tau, "tau")
    assert bool(td.converged)
    if name in ("k3", "drift"):
        # the coupling term moves the trace of unequal overlapping zones
        # (two equal ones see o_z' - o_z = 0): without the off-diagonal
        # migrations each zone integrates alone
        alone = t_dde.solve_observation_availability_multizone(
            p_t, dataclasses.replace(t, R=torch.diag(torch.diag(t.R))))
        assert not torch.equal(alone.o, td.o)


# --------------------------------------------- 3. collapse and coupling

def test_multizone_collapses_to_lemma1_and_the_scalar_dde_at_k1():
    p = paper_params(lam=0.05, M=1)
    sol = t_mf.solve_fixed_point(p, CM_T)
    mz = t_mf.solve_fixed_point_multizone(
        p, CM_T, t_zones.single_zone((100.0, 100.0), 100.0),
        density=DENSITY, speed=1.0)
    for f in ("a", "b", "S", "T_S", "r", "d_M", "d_I", "stability"):
        np.testing.assert_allclose(getattr(mz, f).numpy()[0],
                                   float(getattr(sol, f)), rtol=2e-5,
                                   err_msg=f)
        np.testing.assert_array_equal(getattr(mz.zone(0), f).numpy(),
                                      getattr(mz, f).numpy()[0])
    np.testing.assert_allclose(float(mz.N_z[0]), p.N, rtol=1e-5)
    np.testing.assert_allclose(float(mz.Lam_z[0]), p.Lam, rtol=1e-5)
    dde = t_dde.solve_observation_availability(p, sol, dt=0.1)
    ddez = t_dde.solve_observation_availability_multizone(p, mz, dt=0.1)
    assert ddez.o.shape == (1, dde.o.shape[0])
    np.testing.assert_allclose(ddez.o[0].numpy(), dde.o.numpy(), atol=2e-4)


def test_multizone_coupling_lifts_weak_zone():
    p = paper_params(lam=0.05, M=1)
    iso, coupled = (t_mf.solve_fixed_point_multizone(
        p, CM_T, t_zones.ZoneSet(centers=((60.0, 100.0), (x, 100.0)),
                                 radii=(50.0, 50.0)),
        density=DENSITY, speed=1.0) for x in (300.0, 140.0))
    assert float(coupled.a[0]) > float(iso.a[0])
    assert bool(coupled.stable.all()) and bool(iso.stable.all())


def test_multizone_needs_a_zone_set():
    with pytest.raises(ValueError, match="ZoneSet"):
        t_mf.solve_fixed_point_multizone(paper_params(), CM_T,
                                         density=DENSITY, speed=1.0)
    _, tz = _zs("k2")
    via_p = t_mf.solve_fixed_point_multizone(
        paper_params(lam=0.05, zones=tz), CM_T, density=DENSITY, speed=1.0)
    _same(via_p.a, _pair("k2", 1)[1].a, "p.zones")


# ------------------------------------------------ 4. the class solvers

#: (preset, kw, zones, M)
CLASS_CASES = [
    pytest.param("duty_mix", dict(duty=0.4), "k3", 1, id="duty-k3-M1"),
    pytest.param("zipf_mix", dict(n_classes=3), "drift", 1,
                 id="zipf3-drift-M1"),
    pytest.param("harsh", {}, "k2", 1, id="harsh-k2-M1"),
    pytest.param("zipf_mix", dict(n_classes=3), "k3", 3, id="zipf3-k3-M3"),
]


def _carried(rc):
    """``repro``'s class solution as the port's record."""
    return t_mf.ClassSolution(
        **{f: torch.from_numpy(np.array(getattr(rc, f)))
           for f in CLASS_FIELDS},
        converged=torch.tensor(bool(rc.converged)),
        residual=torch.tensor(float(rc.residual)))


@pytest.mark.parametrize("name,kw,zones,M", CLASS_CASES)
def test_class_solvers_with_zones_equal_repro(name, kw, zones, M):
    rz, tz = _zs(zones)
    when = dict(density=DENSITY, speed=1.0, **WHEN.get(zones, {}))
    rp, p = r_paper_params(lam=0.05, M=M), paper_params(lam=0.05, M=M)
    r_fc, t_fc = getattr(rff, name)(**kw), getattr(tff, name)(**kw)
    rc = r_mf.solve_fixed_point_classes(rp, CM_R, r_fc, rz, strict=True,
                                        **when)
    tc = t_mf.solve_fixed_point_classes(p, CM_T, t_fc, tz, strict=True,
                                        **when)
    assert tc.a.shape == (t_fc.n_classes, tz.k)
    steps = QUANTUM_STEPS * _busy_step(np.asarray(rc.b))
    for f in CLASS_FIELDS:
        want, got = np.asarray(getattr(rc, f)), getattr(tc, f).numpy()
        assert got.shape == want.shape and got.dtype == want.dtype, f
        if f in CLASS_INPUTS:
            _same(got, want, f)
            continue
        rtol = steps * (1.0 - want) if f in ("a", "a_serve") else steps
        assert np.all(np.abs(got - want) <= rtol * np.abs(want)), (
            f, got, want)
    assert bool(tc.converged) and bool(rc.converged)
    rd = r_dde.solve_observation_availability_classes(rp, rc, strict=True)
    td = t_dde.solve_observation_availability_classes(p, _carried(rc),
                                                      strict=True)
    assert td.o.shape == rd.o.shape == (t_fc.n_classes, tz.k, 6001)
    np.testing.assert_allclose(td.o.numpy(), np.asarray(rd.o), rtol=0,
                               atol=1e-5)
    np.testing.assert_allclose(td.weighted().o.numpy(),
                               np.asarray(rd.weighted().o), rtol=0,
                               atol=1e-5)
    # the zones ride p.zones too
    via_p = t_mf.solve_fixed_point_classes(p.replace(zones=tz), CM_T, t_fc,
                                           **when)
    assert torch.equal(via_p.a, tc.a)


@pytest.mark.parametrize("zones", ["k2", "drift"])
def test_class_solvers_delegate_to_the_multizone_solvers(zones):
    """A disabled configuration with a ``ZoneSet``: the class solution is
    the multizone one, bit for bit, and so is its DDE."""
    _, tz = _zs(zones)
    when = dict(density=DENSITY, speed=1.0, **WHEN.get(zones, {}))
    p = paper_params(lam=0.05, M=1)
    mz = t_mf.solve_fixed_point_multizone(p, CM_T, tz, **when)
    d0 = t_dde.solve_observation_availability_multizone(p, mz)
    for fc in (None, tff.always_on()):
        cs = t_mf.solve_fixed_point_classes(p, CM_T, fc, tz, **when)
        assert cs.a.shape == (1, tz.k) and isinstance(
            cs.base, t_mf.MultizoneSolution)
        _same(cs.a[0], mz.a, "a")
        for f in ("b", "S", "T_S", "N_z", "alpha_z", "Lam_z", "r", "d_M",
                  "d_I"):
            _same(getattr(cs, f), getattr(mz, f), f)
        dc = t_dde.solve_observation_availability_classes(p, cs)
        assert dc.o.shape == (1,) + tuple(d0.o.shape)
        _same(dc.o[0], d0.o, "o")
        _same(dc.weighted().o, d0.o, "weighted o")
    # repro delegates alike
    rz = _zs(zones)[0]
    rc = r_mf.solve_fixed_point_classes(r_paper_params(lam=0.05, M=1), CM_R,
                                        None, rz, **when)
    _same(cs.a, rc.a, "repro's delegation")


@pytest.mark.parametrize("zones", ["k2", "k3"])
def test_contamination_with_zones_equals_repro(zones):
    """On ``repro``'s class solution with zones, carried across, the
    contamination solver and its transient equal ``repro``'s bit for bit;
    end to end (the class solver included) within the class solver's
    steps."""
    rz, tz = _zs(zones)
    when = dict(density=DENSITY, speed=1.0)
    rp = r_paper_params(lam=0.05, Lam=10.0, M=1)
    p = paper_params(lam=0.05, Lam=10.0, M=1)
    r_fc = rfa.harsh_adversarial()
    t_fc = tfa.harsh_adversarial()
    rc = r_mf.solve_fixed_point_classes(rp, CM_R, r_fc, rz, **when)
    r = r_mf.solve_contamination_classes(rp, CM_R, r_fc, eta_adv=0.37,
                                         eta_honest=0.81, csol=rc)
    t = t_mf.solve_contamination_classes(p, CM_T, t_fc, eta_adv=0.37,
                                         eta_honest=0.81, csol=_carried(rc))
    assert t.x.shape == (t_fc.n_classes, tz.k)
    for f in ("x", "x_mean", "p_adv", "m", "reset", "honest_n", "residual"):
        _same(getattr(t, f), getattr(r, f), f)
    for f in ("x_pop", "x_holders", "x_pop_holders"):
        _same(getattr(t, f), getattr(r, f), f)
    rt = r_dde.solve_contamination_transient(r, dt=0.3, t_max=120.0)
    tt = t_dde.solve_contamination_transient(t, dt=0.3, t_max=120.0)
    _same(tt.o, rt.o, "transient")
    # end to end: zones handed to the contamination solver
    e2e = t_mf.solve_contamination_classes(p, CM_T, t_fc, tz, **when)
    r_e2e = r_mf.solve_contamination_classes(rp, CM_R, r_fc, rz, **when)
    np.testing.assert_allclose(e2e.x.numpy(), np.asarray(r_e2e.x),
                               rtol=QUANTUM_STEPS * float(
                                   _busy_step(np.asarray(rc.b)).max()))
    via_p = t_mf.solve_contamination_classes(p.replace(zones=tz), CM_T, t_fc,
                                             **when)
    assert torch.equal(via_p.x, e2e.x)
