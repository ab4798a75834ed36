"""The port's other mobility models against ``repro``'s, piece by piece
(CPU).

* ``random.bernoulli`` and ``random.randint`` equal ``jax.random``'s bit for
  bit (partitionable threefry), over ``(B, 2)`` keys.
* The rwp (pause 0 and 60), manhattan (spacing 25 and 30) and ``speed_range``
  rdm inits, and 60 rwp and manhattan steps, equal jitted
  ``repro.sim.mobility`` bit for bit on every state field, at the paper's
  ``speed * dt = 0.25`` (an exact product) and at ``speed = 1.3, dt = 0.3``
  (where no product is exact); ``speed_range`` rdm steps stay within
  ``tests/test_torch_mobility.py``'s ulp bound. Each pinned operation is
  also shown to decide: the other order misses the jitted step.
* ``tests/test_sim_mobility.py``'s model invariants on the port alone.
* The analytic twins' arrays equal ``repro``'s bit for bit; the fixed point
  and the DDE on the rwp and manhattan twins within
  ``tests/test_torch_analytics.py``'s tolerances (the fixed point bit for
  bit at M = 1); ``tests/test_sim_mobility.py``'s analytic checks.
* ``measure_contact_rate`` on the CPU equals ``repro``'s bit for bit for
  rwp and manhattan (free runs: no transcendental on their path), within
  1% for rdm.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import fg_paper as r_paper
from repro.core import dde as r_dde
from repro.core import meanfield as r_mf
from repro.core import mobility as r_mob
from repro.sim import SimConfig as RCfg
from repro.sim.mobility import ManhattanState as RManhattan
from repro.sim.mobility import RWPState as RRWP
from repro.sim.mobility import get_mobility as rget
from repro.sim.mobility import measure_contact_rate as r_rate
from repro_torch import random as tr
from repro_torch.configs import fg_paper as t_paper
from repro_torch.core import dde as t_dde
from repro_torch.core import meanfield as t_mf
from repro_torch.core import mobility as t_mob
from repro_torch.numerics import fma32, sqrt32
import repro.sim as rsim
import repro_torch.sim as tsim
from repro_torch.configs.fg_paper import paper_params
from repro_torch.sim import (MOBILITY_MODELS, MobilityModel, SimConfig,
                             get_mobility, measure_contact_rate,
                             register_mobility, simulate)
from repro_torch.sim.mobility import ManhattanState

GEOM = dict(speed=t_paper.SPEED_DEFAULT, r_tx=t_paper.R_TX,
            density=t_paper.DENSITY, street_spacing=25.0,
            area_side=t_paper.AREA_SIDE)
SLOW = dict(speed=1.3, dt=0.3)


@pytest.fixture(autouse=True)
def one_thread():
    """Small torch ops beside JAX's thread pool: one intra-op thread keeps
    them from contending (as ``tests/test_torch_faults.py`` does)."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _keys(seed, b):
    keys = jax.random.split(jax.random.PRNGKey(seed), b)
    return keys, torch.from_numpy(np.asarray(keys).astype(np.int64))


def _bits(x):
    x = x.numpy() if torch.is_tensor(x) else np.asarray(x)
    return x.view(np.uint32) if x.dtype == np.float32 else x


# ------------------------------------------------------------------ draws

@pytest.mark.parametrize("b", [1, 2])
@pytest.mark.parametrize("p", [0.5, 0.1])
def test_bernoulli_equals_jax(b, p):
    keys, kt = _keys(11 + b, b)
    want = np.stack([np.asarray(jax.jit(
        lambda k: jax.random.bernoulli(k, p, (1000,)))(k)) for k in keys])
    got = tr.bernoulli(kt, p, (1000,))
    assert got.dtype == torch.bool
    np.testing.assert_array_equal(got.numpy(), want)
    assert 0.5 * p < want.mean() < 1.5 * p


@pytest.mark.parametrize("lo,hi", [
    (0, 9), (0, 1), (5, 5), (7, 3), (-5, 1000003), (0, 2**31 - 1),
    (-2**30, 2**30 + 77), (3, 65536)])
def test_randint_equals_jax(lo, hi):
    """The paper grid's street count (9), a one-value range, ``maxval <=
    minval`` (always ``minval``), a wide range (``mult`` wraps to 0), a
    span near 2³¹, one past it (int32 overflow of ``maxval - minval``) and
    a span of 2¹⁶ - 3, over B = 1 and 2 keys."""
    for b in (1, 2):
        keys, kt = _keys(lo % 97 + b, b)
        want = np.stack([np.asarray(jax.jit(
            lambda k: jax.random.randint(k, (999,), lo, hi))(k))
            for k in keys])
        got = tr.randint(kt, (999,), lo, hi)
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), want)


def test_randint_refuses_bounds_outside_int32():
    with pytest.raises(ValueError, match="int32"):
        tr.randint(tr.PRNGKey(0)[None], (3,), 0, 2**31)


# ------------------------------------------------------------------ steps

STEP_CASES = {
    "rwp": ("rwp", {}),
    "rwp-pause60": ("rwp", dict(pause_s=60.0)),
    "manhattan": ("manhattan", {}),
    "manhattan-s30": ("manhattan", dict(street_spacing=30.0)),
    "rdm-speed_range": ("rdm", dict(speed_range=(0.1, 1.9))),
}


def _same_state(got, want, what):
    for f in dataclasses.fields(want):
        w, g = np.asarray(getattr(want, f.name)), getattr(got, f.name)[0]
        assert g.numpy().dtype == w.dtype, (what, f.name)
        np.testing.assert_array_equal(_bits(g), _bits(w),
                                      err_msg=f"{what} {f.name}")


@pytest.mark.parametrize("slow", [False, True], ids=["paper", "slow"])
@pytest.mark.parametrize("case", list(STEP_CASES))
def test_init_and_steps_equal_repro(case, slow):
    name, kw = STEP_CASES[case]
    kw = dict(kw, n_nodes=400, **(SLOW if slow else {}))
    rcfg, tcfg = RCfg(**kw), SimConfig(**kw)
    rm, tm = rget(name), get_mobility(name)
    for seed in ((3,) if slow else (0,)):
        want, wkey = jax.jit(lambda k: rm.init(k, rcfg))(
            jax.random.PRNGKey(seed))
        got, gkey = tm.init(tr.PRNGKey(seed)[None], tcfg)
        _same_state(got, want, f"{case} init seed {seed}")
        np.testing.assert_array_equal(gkey[0].numpy(), np.asarray(wkey))
        step = jax.jit(lambda k1, k2, s: rm.step(k1, k2, s, rcfg))
        key = jax.random.PRNGKey(100 + seed)
        for t in range(60):
            key, k1, k2 = jax.random.split(key, 3)
            nxt = step(k1, k2, want)
            if name == "rdm":
                # cos/sin/atan2 differ by ulps: one step from the same state
                kt = torch.from_numpy(np.stack([np.asarray(k1),
                                                np.asarray(k2)]).astype(
                                                    np.int64))
                one = tm.step(kt[0:1], kt[1:2], type(got)(**{
                    f.name: torch.from_numpy(np.array(getattr(want, f.name)))
                    [None] for f in dataclasses.fields(want)}), tcfg)
                wp, gp = np.asarray(nxt.pos), one.pos[0].numpy()
                bound = (np.spacing(np.maximum(np.abs(wp), np.abs(gp)))
                         + rcfg.dt * 1.9 * 2**-22)
                assert np.all(np.abs(wp - gp) <= bound), (case, t)
                np.testing.assert_array_equal(one.spd[0].numpy(),
                                              np.asarray(nxt.spd))
            else:
                kt = torch.from_numpy(np.stack([np.asarray(k1),
                                                np.asarray(k2)]).astype(
                                                    np.int64))
                got = tm.step(kt[0:1], kt[1:2], got, tcfg)
                _same_state(got, nxt, f"{case} step {t} seed {seed}")
            want = nxt
    if name == "rwp" and kw.get("pause_s"):
        assert np.any(np.asarray(want.wait) > 0)          # nodes paused


def _jitted_step(name, kw, state_cls, fields, n, seed):
    """``repro``'s jitted step on states drawn by ``fields(rng)``, and the
    state it stepped: many inputs, one call."""
    cfg = RCfg(n_nodes=n, mobility=name, **kw)
    key = jax.random.PRNGKey(0)
    st = state_cls(**{k: jnp.asarray(v) for k, v in
                      fields(np.random.default_rng(seed)).items()})
    return cfg, st, jax.jit(lambda s: rget(name).step(key, key, s, cfg))(st)


def test_rwp_pinned_orders_decide():
    """Moving nodes (no arrival, no pause), 200k of them at speed 1.3, dt
    0.3: the port's distance (``sqrt32(fma(dy, dy, dx*dx))``) and move
    (``fma(direction, step_len, pos)``) give the jitted step's positions;
    torch's vectorized float32 root, or the unfused move, do not."""
    n = 200_000

    def fields(rng):
        return dict(pos=rng.uniform(0, 200, (n, 2)).astype(np.float32),
                    dest=rng.uniform(0, 200, (n, 2)).astype(np.float32),
                    wait=np.zeros(n, np.float32))

    cfg, st, nxt = _jitted_step("rwp", SLOW, RRWP, fields, n, 7)
    pos, dest = (torch.from_numpy(np.array(getattr(st, f)))
                 for f in ("pos", "dest"))
    want = np.asarray(nxt.pos)
    step_len = float(np.float32(cfg.speed * cfg.dt))
    d = dest - pos
    s2 = fma32(d[:, 1], d[:, 1], d[:, 0] * d[:, 0])
    moving = (sqrt32(s2) > step_len).numpy()

    def moved(root, fused):
        direction = d / root(s2)[:, None]
        out = (fma32(direction, step_len, pos) if fused
               else pos + direction * step_len)
        return (out.numpy() == want).all(-1)[moving]

    assert moved(sqrt32, True).all()
    assert not moved(torch.sqrt, True).all()
    assert not moved(sqrt32, False).all()


def test_manhattan_pinned_orders_decide():
    """The move ``u + sgn * speed * dt`` is ``u + sgn * f32(speed * dt)``
    in the jitted step (an FMA of ``sgn * speed`` and ``dt`` misses it),
    and the next street line is the floor of ``u * f32(1/s)`` (a true
    division misses it): nodes placed next to the lines."""
    n = 200_000
    s = 30.0

    def fields(rng):
        line = rng.integers(0, 8, n) * np.float32(s)
        u = np.clip(line + rng.normal(0, 1e-3, n), 0, 200).astype(np.float32)
        w = (rng.integers(0, 8, n) * np.float32(s)).astype(np.float32)
        horiz = rng.random(n) < 0.5
        return dict(pos=np.stack([np.where(horiz, u, w),
                                  np.where(horiz, w, u)], -1),
                    horiz=horiz,
                    sgn=np.where(rng.random(n) < 0.5, 1.0, -1.0).astype(
                        np.float32))

    cfg, st, nxt = _jitted_step("manhattan", dict(SLOW, street_spacing=s),
                                RManhattan, fields, n, 8)
    tst = get_mobility("manhattan").step(
        tr.PRNGKey(0)[None], None, ManhattanState(**{
            f: torch.from_numpy(np.array(getattr(st, f)))[None]
            for f in ("pos", "horiz", "sgn")}),
        SimConfig(n_nodes=n, street_spacing=s, **SLOW))
    _same_state(tst, nxt, "manhattan near the lines")
    x, hz = np.array(st.pos), np.array(st.horiz)
    u = torch.from_numpy(np.where(hz, x[:, 0], x[:, 1]))
    sgn = torch.from_numpy(np.array(st.sgn))
    f32 = lambda v: float(np.float32(v))  # noqa: E731
    folded = u + sgn * f32(f32(cfg.speed) * f32(cfg.dt))
    fused = fma32(sgn * f32(cfg.speed), f32(cfg.dt), u)
    assert (folded != fused).sum() > 100
    ahead = sgn > 0

    def crossed(q):
        m = torch.where(ahead, (torch.floor(q) + 1.0) * f32(s),
                        (torch.ceil(q) - 1.0) * f32(s))
        return torch.where(ahead, folded >= m, folded <= m)

    # where a true division puts the line elsewhere, it offers other turns
    assert (crossed(u * f32(1.0 / s)) != crossed(u / f32(s))).sum() > 10


# ------------------------------------------------- invariants, port alone

@pytest.mark.parametrize("name", sorted(MOBILITY_MODELS))
def test_positions_stay_in_area(name):
    cfg = SimConfig(n_nodes=50, mobility=name)
    model = get_mobility(name)
    mob, key = model.init(tr.PRNGKey(3)[None], cfg)
    for _ in range(500):
        key, k1, k2 = tr.split(key, 3).unbind(-2)
        mob = model.step(k1, k2, mob, cfg)
    pos = mob.pos.numpy()
    assert pos.min() >= -1e-6 and pos.max() <= cfg.area_side + 1e-6


def test_manhattan_stays_on_street_graph():
    cfg = SimConfig(n_nodes=50, mobility="manhattan", street_spacing=25.0)
    model = get_mobility("manhattan")
    mob, key = model.init(tr.PRNGKey(4)[None], cfg)
    turned = torch.zeros(50, dtype=torch.bool)
    for _ in range(300):
        key, k1, k2 = tr.split(key, 3).unbind(-2)
        nxt = model.step(k1, k2, mob, cfg)
        turned |= (nxt.horiz != mob.horiz)[0]
        mob = nxt
    pos, horiz = mob.pos[0].numpy(), mob.horiz[0].numpy()
    fixed = np.where(horiz, pos[:, 1], pos[:, 0])
    # the non-moving coordinate sits exactly on a street line
    dist_to_line = np.minimum(fixed % 25.0, 25.0 - fixed % 25.0)
    np.testing.assert_allclose(dist_to_line, 0.0, atol=1e-4)
    assert turned.any()


# ------------------------------------------------------------------ twins

TWIN_CASES = {
    "rwp": ("rwp", dict(speed=1.0, r_tx=5.0, density=5e-3)),
    "rwp-pause60": ("rwp", dict(speed=1.0, r_tx=5.0, density=5e-3,
                                pause_s=60.0, area_side=200.0)),
    "rwp-pause7-slow": ("rwp", dict(speed=1.3, r_tx=5.0, density=5e-3,
                                    pause_s=7.0, area_side=282.8, nt=300)),
    "manhattan-infinite": ("manhattan", dict(speed=1.0, r_tx=5.0,
                                             density=5e-3)),
    "manhattan-s25": ("manhattan", dict(speed=1.0, r_tx=5.0, density=5e-3,
                                        area_side=200.0)),
    "manhattan-s30": ("manhattan", dict(speed=1.0, r_tx=5.0, density=5e-3,
                                        street_spacing=30.0,
                                        area_side=200.0)),
    "manhattan-s30-infinite": ("manhattan", dict(
        speed=1.3, r_tx=5.0, density=5e-3, street_spacing=30.0)),
}


@pytest.mark.parametrize("case", list(TWIN_CASES))
def test_twin_equals_repro_bitwise(case):
    name, kw = TWIN_CASES[case]
    r, t = (r_mob.contact_model_for(name, **kw),
            t_mob.contact_model_for(name, device="cpu", **kw))
    for f in ("g", "t_grid", "pdf", "weights"):
        got = getattr(t, f)
        assert got.dtype == torch.float32 and got.device.type == "cpu"
        np.testing.assert_array_equal(_bits(got), _bits(getattr(r, f)),
                                      err_msg=f"{case} {f}")


def test_rwp_pause_needs_area_side():
    for mob in (r_mob, t_mob):
        with pytest.raises(ValueError, match="area_side"):
            mob.rwp_contact_model(speed=1.0, r_tx=5.0, density=5e-3,
                                  pause_s=10.0,
                                  **({"device": "cpu"} if mob is t_mob
                                     else {}))


@pytest.mark.parametrize("name", ["rdm", "rwp", "manhattan"])
def test_paper_contact_model_equals_repro(name):
    r = r_paper.paper_contact_model(mobility=name)
    t = t_paper.paper_contact_model(mobility=name, device="cpu")
    for f in ("g", "t_grid", "pdf", "weights"):
        np.testing.assert_array_equal(_bits(getattr(t, f)),
                                      _bits(getattr(r, f)), err_msg=f)


FP_FIELDS = ("a", "b", "S", "T_S", "r", "d_M", "d_I", "stability", "rho",
             "residual")


@pytest.mark.parametrize("M", [1, 4])
@pytest.mark.parametrize("name", ["rwp", "manhattan"])
def test_fixed_point_and_dde_on_the_twins(name, M):
    """The fixed point on the twin bit for bit at M = 1 and within rtol
    1e-5 at M = 4; the DDE within ``tests/test_torch_analytics.py``'s
    tolerances (o within atol 1e-5, its integral rtol 1e-4)."""
    pr = r_paper.paper_params(lam=0.05, M=M)
    pt = t_paper.paper_params(lam=0.05, M=M)
    r_sol = r_mf.solve_fixed_point(pr, r_paper.paper_contact_model(
        mobility=name))
    t_sol = t_mf.solve_fixed_point(pt, t_paper.paper_contact_model(
        mobility=name, device="cpu"))
    for f in FP_FIELDS:
        got, want = getattr(t_sol, f), getattr(r_sol, f)
        if M == 1:
            np.testing.assert_array_equal(_bits(got), _bits(want),
                                          err_msg=f)
        else:
            np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                       rtol=1e-5, atol=1e-30, err_msg=f)
    assert bool(t_sol.converged) and bool(t_sol.stable)
    r_d = r_dde.solve_observation_availability(pr, r_sol)
    t_d = t_dde.solve_observation_availability(pt, t_sol)
    np.testing.assert_allclose(t_d.o.numpy(), np.asarray(r_d.o), atol=1e-5)
    np.testing.assert_allclose(float(t_d.integral(pt.tau_l)),
                               float(r_d.integral(pr.tau_l)), rtol=1e-4)


def test_registries_are_paired():
    assert set(MOBILITY_MODELS) == set(t_mob.CONTACT_MODELS) == \
        {"rdm", "rwp", "manhattan"}
    for name, model in MOBILITY_MODELS.items():
        assert model.name == name
        assert float(t_mob.contact_model_for(name, device="cpu",
                                             **GEOM).g) > 0


def test_unknown_names_raise():
    with pytest.raises(ValueError, match="unknown mobility"):
        get_mobility("levy_flight")
    with pytest.raises(ValueError, match="unknown mobility"):
        t_mob.contact_model_for("levy_flight", device="cpu", **GEOM)


@pytest.mark.parametrize("name", ["rdm", "rwp", "manhattan"])
def test_contact_duration_pdf_normalized(name):
    cm = t_mob.contact_model_for(name, device="cpu", **GEOM)
    assert float(cm.g) > 0
    np.testing.assert_allclose(float((cm.pdf * cm.weights).sum()), 1.0,
                               atol=1e-5)
    assert float(cm.mean_duration) > 0


def test_mobility_models_are_actually_different():
    sig = {n: (float(cm.g), float(cm.mean_duration))
           for n in t_mob.CONTACT_MODELS
           for cm in [t_mob.contact_model_for(n, device="cpu", **GEOM)]}
    names = sorted(sig)
    for i, a in enumerate(names):
        for b in names[i + 1:]:
            (ga, da), (gb, db) = sig[a], sig[b]
            assert abs(ga - gb) > 1e-3 * ga or abs(da - db) > 0.05 * da


def test_pause_and_speed_range_corrections():
    g0 = float(t_mob.contact_model_for("rwp", device="cpu", **GEOM).g)
    paused = t_mob.contact_model_for("rwp", pause_s=60.0, device="cpu",
                                     **GEOM)
    base = t_mob.contact_model_for("rwp", pause_s=0.0, device="cpu", **GEOM)
    assert float(base.g) == g0
    assert 0 < float(paused.g) < g0
    assert float(paused.mean_duration) > float(base.mean_duration)
    r0 = float(t_mob.contact_model_for("rdm", device="cpu", **GEOM).g)
    rc = float(t_mob.contact_model_for("rdm", speed_range=(0.1, 1.9),
                                       device="cpu", **GEOM).g)
    assert rc > 1.05 * r0


# ------------------------------------------------------------------ probe

@pytest.mark.parametrize("name,kw,seed", [
    ("rwp", {}, 0), ("manhattan", {}, 0), ("rwp", dict(pause_s=60.0), 1),
    ("manhattan", dict(street_spacing=30.0, **SLOW), 2)],
    ids=["rwp", "manhattan", "rwp-pause60", "manhattan-s30-slow"])
def test_contact_rate_equals_repro_bitwise(name, kw, seed):
    want = r_rate(jax.random.PRNGKey(seed), name=name,
                  cfg=RCfg(n_nodes=200, **kw), n_slots=300)
    got = measure_contact_rate(tr.PRNGKey(seed), name=name,
                               cfg=SimConfig(n_nodes=200, **kw), n_slots=300,
                               device="cpu")
    assert got.shape == () and got.dtype == torch.float32
    assert _bits(got) == _bits(want) and float(got) > 0


@pytest.mark.parametrize("kw", [{}, dict(speed_range=(0.1, 1.9))],
                         ids=["rdm", "rdm-speed_range"])
def test_rdm_contact_rate_within_one_percent(kw):
    """Free rdm runs drift by ulps (cos, sin, atan2), so the rate is held
    to 1% of ``repro``'s."""
    want = float(r_rate(jax.random.PRNGKey(0), name="rdm",
                        cfg=RCfg(n_nodes=200, **kw), n_slots=300))
    got = float(measure_contact_rate(0, name="rdm",
                                     cfg=SimConfig(n_nodes=200, **kw),
                                     n_slots=300, device="cpu"))
    assert abs(got - want) <= 0.01 * want, (got, want)


def test_no_fallback_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device works")
    for call in (
            lambda: measure_contact_rate(0, name="rwp",
                                         cfg=SimConfig(n_nodes=8), n_slots=1),
            lambda: t_mob.rwp_contact_model(speed=1.0, r_tx=5.0,
                                            density=5e-3),
            lambda: t_mob.manhattan_contact_model(speed=1.0, r_tx=5.0,
                                                  density=5e-3),
            lambda: t_paper.paper_contact_model(mobility="manhattan")):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            call()


# ---------------------------------------------- a user's model, the exports

def test_registered_model_runs_through_simulate():
    """``register_mobility`` puts a user's model under its name: rdm's own
    functions under another name run rdm's run bit for bit, and a model
    whose nodes never move keeps every node's zone membership."""
    rdm = get_mobility("rdm")
    cfg = dict(n_nodes=40, n_slots=64, sample_every=8)
    p = paper_params(lam=0.2, M=1)
    try:
        assert register_mobility(MobilityModel(
            name="rdm-again", init=rdm.init, step=rdm.step)) is \
            MOBILITY_MODELS["rdm-again"]
        register_mobility(MobilityModel(
            name="parked", init=rdm.init, step=lambda k1, k2, s, cfg: s))
        want = simulate(p, SimConfig(**cfg), seed=3, device="cpu")
        got = simulate(p, SimConfig(**cfg, mobility="rdm-again"), seed=3,
                       device="cpu")
        for f in ("availability", "busy_frac", "stored_info", "n_in_rz"):
            np.testing.assert_array_equal(getattr(got, f), getattr(want, f),
                                          err_msg=f)
        parked = simulate(p, SimConfig(**cfg, mobility="parked"), seed=3,
                          device="cpu")
        assert np.all(parked.n_in_rz == parked.n_in_rz[0])
        assert not np.all(want.n_in_rz == want.n_in_rz[0])
        assert np.all(np.isfinite(parked.availability))
    finally:
        MOBILITY_MODELS.pop("rdm-again", None)
        MOBILITY_MODELS.pop("parked", None)
    with pytest.raises(ValueError, match="unknown mobility model"):
        get_mobility("parked")


def test_sim_exports_repro_sims_names():
    assert set(rsim.__all__) <= set(tsim.__all__)
    for name in tsim.__all__:
        assert getattr(tsim, name) is not None, name
