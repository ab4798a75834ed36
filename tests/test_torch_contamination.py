"""The port's contamination twin against ``repro``'s, on the same inputs
(CPU): ``core.meanfield.solve_contamination_classes`` with its
``ContaminationSolution``, ``contamination_closed_form`` and
``core.dde.solve_contamination_transient``.

* The steady solver at M = 1, end to end (the class solver included), for
  every attack preset, ``honest()`` and ``harsh()`` (the zero branch), the
  parameters' own ``faults`` and a configuration with two honest classes
  (duty-cycled and always on) beside sign flippers, where the class sums
  have more than one non-zero term; at eta (1, 1) and (0.37, 0.81), where
  XLA's fused multiply-adds round otherwise than separate products; with
  ``merge_rate`` None, 0.03 and a (C, K) array. At M = 3 on ``repro``'s own
  class solution, carried across (the class solver's ulp-of-K wander,
  ``tests/test_torch_faults.py``, stays out). Every field and property
  within rel 1e-5, shapes and dtypes equal, ``converged`` equal.
* ``contamination_closed_form`` over a grid that reaches both branches.
* The transient at dt 0.5 and 0.3, ``t_max`` None and given: ``tau`` equal,
  ``o`` within abs 1e-5, its holder fraction and weighted trace too.
* The fused multiply-adds pinned: on the two cases where they show, the
  steady solution, its class sums and the transient equal ``repro``'s bit
  for bit.
* ``tests/test_adversarial.py:507-579``'s six tests on the port.
"""

import numpy as np
import pytest
import torch

from repro.configs import fg_adversarial as rfa
from repro.configs import fg_faults as rff
from repro.configs import fg_paper as r_paper
from repro.core import dde as r_dde
from repro.core import meanfield as r_mf
from repro.core.zones import ZoneSet as RZoneSet
from repro.sim import faults as r_faults
from repro_torch.configs import fg_adversarial as tfa
from repro_torch.configs import fg_faults as tff
from repro_torch.configs import fg_paper as t_paper
from repro_torch.core import dde as t_dde
from repro_torch.core import meanfield as t_mf
from repro_torch.core.zones import ZoneSet
from repro_torch.sim import faults as t_faults

CM_R = r_paper.paper_contact_model()
CM_T = t_paper.paper_contact_model(device="cpu")
#: ``tests/test_adversarial.py``'s point.
P = t_paper.paper_params(lam=0.05, Lam=10.0, M=1)
CM = CM_T
RTOL, OTOL = 1e-5, 1e-5
ETAS = [pytest.param(1.0, 1.0, id="eta1"),
        pytest.param(0.37, 0.81, id="eta037-081")]
RATES = [None, 0.03, "ck"]
FIELDS = ("x", "x_mean", "p_adv", "m", "reset", "eta_adv", "eta_honest",
          "honest_n", "fracs", "residual")
PROPERTIES = ("x_pop", "x_holders", "x_pop_holders")
CLASS_FIELDS = ("a", "a_serve", "q", "q_bar", "fracs", "b", "S", "T_S",
                "N_z", "alpha_z", "Lam_z", "r", "d_M", "d_I")


def _two_honest(mod):
    """Two honest classes (one duty-cycled) beside sign flippers, with
    crashes: the class solver runs, and the poison's class sum has two
    non-zero terms."""
    return mod.FaultConfig(classes=(
        mod.FaultClass(frac=0.5, rate_off=0.01, rate_on=0.03, name="duty"),
        mod.FaultClass(frac=0.35, name="on"),
        mod.FaultClass(frac=0.15, adv_mode="signflip", adv_scale=4.0,
                       name="flip")), crash_rate=0.001)


#: name -> (repro's config, the port's): the preset pairs; None rides
#: ``p.faults``.
CONFIGS = {
    "signflip": lambda: (rfa.signflip(frac=0.1), tfa.signflip(frac=0.1)),
    "harsh_adversarial": lambda: (rfa.harsh_adversarial(),
                                  tfa.harsh_adversarial()),
    "noise_injector": lambda: (rfa.noise_injector(), tfa.noise_injector()),
    "stale_replay": lambda: (rfa.stale_replay(), tfa.stale_replay()),
    "metadata_liar": lambda: (rfa.metadata_liar(), tfa.metadata_liar()),
    "honest": lambda: (rfa.honest(), tfa.honest()),
    "harsh": lambda: (rff.harsh(), tff.harsh()),
    "p.faults": lambda: (None, None),
    "two_honest": lambda: (_two_honest(r_faults), _two_honest(t_faults)),
}


def _np(x):
    return x.numpy() if torch.is_tensor(x) else np.asarray(x)


def _check(got, want, what, rtol=RTOL, atol=0.0):
    got, want = _np(got), _np(want)
    assert got.shape == want.shape and got.dtype == want.dtype, (
        what, got.shape, got.dtype, want.shape, want.dtype)
    np.testing.assert_allclose(got, want, rtol=rtol, atol=atol, err_msg=what)


def _same_bits(got, want, what):
    got, want = _np(got), _np(want)
    assert got.dtype == want.dtype == np.float32, what
    assert np.array_equal(got.view(np.uint32), want.view(np.uint32)), what


def _rate(rate, n_classes):
    if rate == "ck":
        return np.linspace(0.02, 0.05, n_classes, dtype=np.float32)[:, None]
    return rate


def _same_solution(t, r):
    for f in FIELDS:
        # the residual is one damped step at the fixed point, a few ulps:
        # held to the solver's tol
        _check(getattr(t, f), getattr(r, f), f,
               atol=1e-6 if f == "residual" else 1e-30)
    for f in PROPERTIES:
        _check(getattr(t, f), getattr(r, f), f, atol=1e-30)
    assert bool(t.converged) == bool(r.converged)


def _carried(rc):
    """``repro``'s class solution as the port's record (float32 tensors)."""
    return t_mf.ClassSolution(
        **{f: torch.from_numpy(np.array(getattr(rc, f)))
           for f in CLASS_FIELDS},
        converged=torch.tensor(bool(rc.converged)),
        residual=torch.tensor(float(rc.residual)))


def _solve_pair(name, eta, rate=None, M=1, carried=False):
    r_fc, t_fc = CONFIGS[name]()
    rp = r_paper.paper_params(lam=0.05, Lam=10.0, M=M)
    tp = t_paper.paper_params(lam=0.05, Lam=10.0, M=M)
    n_classes = len(r_fc.classes) if r_fc is not None else 1
    kw = dict(eta_adv=eta[0], eta_honest=eta[1],
              merge_rate=_rate(rate, n_classes))
    if carried:
        rc = r_mf.solve_fixed_point_classes(rp, CM_R, r_fc, tol=1e-6)
        r = r_mf.solve_contamination_classes(rp, CM_R, r_fc, csol=rc, **kw)
        t = t_mf.solve_contamination_classes(tp, CM_T, t_fc,
                                             csol=_carried(rc), **kw)
    else:
        r = r_mf.solve_contamination_classes(rp, CM_R, r_fc, **kw)
        t = t_mf.solve_contamination_classes(tp, CM_T, t_fc, **kw)
    return t, r


@pytest.mark.parametrize("rate", RATES, ids=["lemma2", "scalar", "ck"])
@pytest.mark.parametrize("ea,eh", ETAS)
@pytest.mark.parametrize("name", list(CONFIGS))
def test_steady_solution_equals_repro(name, ea, eh, rate):
    t, r = _solve_pair(name, (ea, eh), rate)
    _same_solution(t, r)
    assert t.x.device.type == "cpu" and t.x.dtype == torch.float32
    assert bool(t.converged)
    if name in ("honest", "harsh", "p.faults"):
        assert not t.x.any() and float(t.x_pop_holders) == 0.0


@pytest.mark.parametrize("ea,eh", ETAS)
@pytest.mark.parametrize("name", list(CONFIGS))
def test_steady_solution_on_repros_class_solution_at_m3(name, ea, eh):
    t, r = _solve_pair(name, (ea, eh), M=3, carried=True)
    _same_solution(t, r)


@pytest.mark.parametrize("ea,eh", [(1.0, 1.0), (0.37, 0.81), (1.0, 0.0),
                                   (0.2, 1e-8)])
def test_closed_form_equals_repro(ea, eh):
    """Both branches: ``A = m (1 - p_adv) eta_honest`` above and at or below
    1e-9 (m 0 or 1e-10, p_adv 1, eta_honest 0 or 1e-8)."""
    m, p_adv, reset = np.meshgrid(
        np.asarray([0.0, 1e-10, 1e-3, 0.03, 0.3, 1.0], np.float32),
        np.asarray([0.0, 0.05, 0.1, 0.5, 1.0], np.float32),
        np.asarray([1e-3, 6.4e-3, 0.1, 2.0], np.float32), indexing="ij")
    got = t_mf.contamination_closed_form(
        torch.from_numpy(m), torch.from_numpy(p_adv), torch.from_numpy(reset),
        eta_adv=ea, eta_honest=eh)
    want = r_mf.contamination_closed_form(m, p_adv, reset, eta_adv=ea,
                                          eta_honest=eh)
    _check(got, want, "closed form", atol=1e-30)
    A = m * (1.0 - p_adv) * np.float32(eh)
    assert (A <= 1e-9).any() and (A > 1e-9).any() == (eh > 0.0)
    for args in ((1.0, 0.2, 0.1), (0.03, 0.1, 0.0064), (2.0, 0.0, 0.5)):
        _check(t_mf.contamination_closed_form(*args, eta_adv=ea,
                                              eta_honest=eh),
               r_mf.contamination_closed_form(*args, eta_adv=ea,
                                              eta_honest=eh),
               f"closed form {args}", atol=1e-30)


def _same_transient(tt, rt):
    _check(tt.tau, rt.tau, "tau", rtol=0.0)
    _check(tt.o, rt.o, "o", rtol=0.0, atol=OTOL)
    _check(tt.weights, rt.weights, "weights")
    _check(tt.weighted().o, rt.weighted().o, "weighted o", rtol=0.0,
           atol=OTOL)
    assert tt.dt == rt.dt
    assert bool(tt.converged) == bool(rt.converged)
    _check(tt.residual, rt.residual, "residual", rtol=0.0, atol=OTOL)


@pytest.mark.parametrize("dt", [0.5, 0.3])
@pytest.mark.parametrize("name", list(CONFIGS))
def test_transient_equals_repro(name, dt):
    t, r = _solve_pair(name, (0.37, 0.81))
    tt = t_dde.solve_contamination_transient(t, dt=dt)
    rt = r_dde.solve_contamination_transient(r, dt=dt)
    _same_transient(tt, rt)
    _check(t.holder_fraction(tt.o), r.holder_fraction(rt.o),
           "holder fraction of o", rtol=0.0, atol=OTOL)


@pytest.mark.parametrize("t_max", [1.0, 150.0, 1234.5])
@pytest.mark.parametrize("dt", [0.5, 0.3])
@pytest.mark.parametrize("name", ["signflip", "harsh_adversarial"])
def test_transient_with_t_max_equals_repro(name, dt, t_max):
    t, r = _solve_pair(name, (1.0, 1.0), 0.03)
    tt = t_dde.solve_contamination_transient(t, dt=dt, t_max=t_max,
                                             strict=True)
    rt = r_dde.solve_contamination_transient(r, dt=dt, t_max=t_max,
                                             strict=True)
    assert tt.o.shape[-1] == max(int(round(t_max / dt)), 1) + 1
    _same_transient(tt, rt)


@pytest.mark.parametrize("name", ["harsh_adversarial", "two_honest"])
def test_fused_multiply_adds_bit_for_bit(name):
    """XLA contracts the steady iteration's ``p_adv eta_adv + eta_honest
    sum_h s_h x_h``, the class sums (``einsum("c,ck->k")``: a product, then
    one FMA a class) and the transient's ``m (1 - x) poi - reset x`` and ``x
    + dt dx``; at eta (0.37, 0.81) and dt 0.3 a separate product rounds
    otherwise on some steps. The port writes each as ``fma32``. On
    ``repro``'s own class solution (the class solvers agree to rtol 1e-5,
    not bit for bit, on these configurations)."""
    for M in (1, 3):
        t, r = _solve_pair(name, (0.37, 0.81), M=M, carried=True)
        for f in ("x", "x_mean", "p_adv", "honest_n", "residual"):
            _same_bits(getattr(t, f), getattr(r, f), f"M={M} {f}")
        for f in PROPERTIES:
            _same_bits(getattr(t, f), getattr(r, f), f"M={M} {f}")
        tt = t_dde.solve_contamination_transient(t, dt=0.3, t_max=300.0)
        rt = r_dde.solve_contamination_transient(r, dt=0.3, t_max=300.0)
        _same_bits(tt.o, rt.o, f"M={M} transient o")
        _same_bits(tt.tau, rt.tau, f"M={M} tau")


def test_zone_sets_equal_repro():
    """The configuration the single-zone port refused, ``signflip()``
    across two zones (an attack-only configuration: the class solver
    delegates to the multizone one), given as ``zones`` and as
    ``p.zones``, equals ``repro``'s."""
    kw = dict(centers=((60.0, 100.0), (140.0, 100.0)), radii=(45.0, 45.0))
    zs, rzs = ZoneSet(**kw), RZoneSet(**kw)
    geo = dict(density=t_paper.DENSITY, speed=1.0)
    rp = r_paper.paper_params(lam=0.05, Lam=10.0, M=1)
    want = r_mf.solve_contamination_classes(rp, CM_R, rfa.signflip(),
                                            zones=rzs, **geo)
    for got in (
            t_mf.solve_contamination_classes(P, CM, tfa.signflip(),
                                             zones=zs, **geo),
            t_mf.solve_contamination_classes(P.replace(zones=zs), CM,
                                             tfa.signflip(), **geo)):
        assert got.x.shape == (2, 2)
        for f in ("x", "x_mean", "p_adv", "m", "reset", "honest_n"):
            _same_bits(getattr(got, f), getattr(want, f), f)


def test_delegated_path_broadcasts_the_class_solution():
    """``signflip()`` is attack-only: the class solver delegates, its
    solution carries one class column, and the balance broadcasts it over
    the fault configuration's two classes."""
    fc = tfa.signflip(frac=0.1)
    assert fc.adversarial and not fc.enabled
    sol = t_mf.solve_contamination_classes(P, CM, fc)
    assert sol.csol.a.shape == (1, 1) and sol.csol.base is not None
    assert sol.x.shape == sol.m.shape == sol.honest_n.shape == (2, 1)
    assert sol.fracs.shape == (2,) and sol.csol.fracs.shape == (1,)
    assert torch.equal(sol.x[0], sol.x[1])
    np.testing.assert_allclose(float(sol.x[0, 0]), 0.89323854, rtol=1e-7)
    np.testing.assert_allclose(float(sol.p_adv[0]), 0.1, rtol=1e-6)
    tr = t_dde.solve_contamination_transient(sol, dt=0.5)
    assert tr.o.shape == (2, 1, 1306)


# ------------------------------------------ tests/test_adversarial.py:507-579


def test_contamination_trivial_is_exactly_zero():
    sol = t_mf.solve_contamination_classes(P, CM, tfa.honest())
    assert np.all(sol.x.numpy() == 0.0)
    assert bool(sol.converged)
    assert float(sol.x_pop) == 0.0 and float(sol.x_pop_holders) == 0.0


def test_contamination_matches_closed_form():
    fc = tfa.signflip(frac=0.1)
    sol = t_mf.solve_contamination_classes(P, CM, fc)
    assert bool(sol.converged)
    m = float(sol.m[0, 0])
    ref = t_mf.contamination_closed_form(m, float(sol.p_adv[0]),
                                         float(sol.reset[0]))
    # both classes see the same (m, p_adv, reset) single-zone balance
    np.testing.assert_allclose(sol.x.numpy(), float(ref), rtol=1e-4)
    assert 0.0 < float(ref) < 1.0


def test_contamination_closed_form_limits():
    # eta_honest -> 0 kills self-spread: x -> B/(B+rho), the linear limit
    x = float(t_mf.contamination_closed_form(1.0, 0.2, 0.1, eta_honest=0.0))
    assert x == pytest.approx(0.2 / 0.3, rel=1e-5)
    # p_adv -> 0 above threshold: the seeded root tends to the endemic
    # equilibrium (A - rho)/A, not to 0
    assert float(t_mf.contamination_closed_form(1.0, 0.0, 0.1)) == \
        pytest.approx(0.9, rel=1e-5)
    # ... while below threshold (rho > A) zero seeding stays clean
    assert float(t_mf.contamination_closed_form(1.0, 0.0, 2.0)) == 0.0


def test_contamination_merge_rate_override():
    fc = tfa.signflip(frac=0.1)
    sol = t_mf.solve_contamination_classes(P, CM, fc, merge_rate=0.03)
    np.testing.assert_allclose(sol.m.numpy(), 0.03, rtol=1e-6)
    assert sol.x.shape == (2, 1)              # delegated attack-only path
    # a slower exchange fabric contaminates less at fixed churn
    fast = t_mf.solve_contamination_classes(P, CM, fc, merge_rate=3.0)
    assert float(sol.x_pop) < float(fast.x_pop)


def test_contamination_transient_settles_on_fixed_point():
    fc = tfa.signflip(frac=0.1)
    sol = t_mf.solve_contamination_classes(P, CM, fc)
    tr = t_dde.solve_contamination_transient(sol, dt=0.5)
    assert bool(tr.converged)
    x_end = tr.o.numpy()[..., -1]
    np.testing.assert_allclose(x_end, sol.x.numpy(), rtol=1e-3)
    # starts clean, monotone toward the fixed point
    assert np.all(tr.o.numpy()[..., 0] == 0.0)
    assert np.all(np.diff(tr.o.numpy(), axis=-1) >= -1e-6)


def test_holder_conditioning_bounds():
    fc = tfa.signflip(frac=0.1)
    sol = t_mf.solve_contamination_classes(P, CM, fc)
    xh = sol.x_holders.numpy()
    assert np.all((xh >= 0.0) & (xh <= 1.0))
    # non-holders are clean, so the holder-masked fraction dominates
    assert np.all(xh >= sol.x.numpy() - 1e-6)
    # the map handles trailing time axes (the transient trace)
    tr = t_dde.solve_contamination_transient(sol, dt=0.5)
    xt = sol.holder_fraction(tr.o).numpy()
    assert xt.shape == tuple(tr.o.shape)
    assert np.all((xt >= 0.0) & (xt <= 1.0))
