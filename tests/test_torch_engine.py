"""The port's ``simulate`` against ``repro.sim.simulate``.

(a) With ``repro``'s rdm positions (computed under the engine's key
    schedule by a jitted scan over ``repro.sim.mobility``) replayed
    through the port, every ``SimOutputs`` trace is equal bit for bit.
(b) A ``repro`` initial state carried across with ``state_from_numpy``
    equals the port's own ``init_sim_state``, and ``state_to_numpy``
    carries it back.
(c) The port runs free on the CPU; without CUDA the default device raises;
    rwp and ``speed_range`` run, an unknown mobility name, ``speed_range``
    outside rdm and a ``faults`` that is not the port's ``FaultConfig``
    raise ``ValueError``.
(d) Two-zone configurations, on either backend, with faults and on the
    Byzantine path, equal ``repro``'s runs on its positions.
"""

import dataclasses
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.sim.compute as rcompute
import repro.sim.observations as robs
from repro.configs import fg_faults as rff
from repro.configs.fg_learn import logreg_task as r_logreg
from repro.configs.fg_paper import paper_params as r_paper_params
from repro.core.zones import ZoneSet as RZoneSet
from repro.sim import SimConfig as RCfg
from repro.sim import learn as rlearn
from repro.sim import simulate as r_simulate
from repro.sim.faults import FaultClass as RFaultClass
from repro.sim.faults import FaultConfig as RFaultConfig
from repro.sim.mobility import get_mobility as rget
from repro.sim.state import init_sim_state as r_init_state
from repro_torch import random as tr
from repro_torch.configs.fg_faults import harsh
from repro_torch.configs.fg_learn import logreg_task
from repro_torch.configs.fg_paper import paper_params
from repro_torch.core.zones import ZoneSet
from repro_torch.sim import SimConfig, estimate_o_of_tau, simulate
from repro_torch.sim.engine import mobility_track
from repro_torch.sim import learn as tlearn
from repro_torch.sim.faults import FaultClass, FaultConfig
from repro_torch.sim.mobility import get_mobility
from repro_torch.sim.state import (init_sim_state, state_from_numpy,
                                   state_to_numpy)

GEOM = dict(n_nodes=64, area_side=60.0, rz_radius=30.0, n_slots=480)
TRACES = ("t", "availability", "busy_frac", "stored_info", "obs_birth",
          "obs_holders", "model_holders", "n_in_rz", "availability_z",
          "stored_info_z", "n_in_rz_z")


@pytest.fixture
def working_barrier():
    """The seed's ``shared_barrier`` fails on this jax (TypeError in its
    vmap-rule registration); the barrier is the identity, so the reference
    runs the barrier it wraps while a test needs it."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(rcompute, "shared_barrier", jax.lax.optimization_barrier)
        mp.setattr(robs, "shared_barrier", jax.lax.optimization_barrier)
        yield


@partial(jax.jit, static_argnames=("cfg",))
def _repro_track(key, cfg):
    """``(n_slots + 1, N, 2)`` rdm positions under the engine's schedule:
    init, then per slot ``key, k1, k2, k_obs, k_who = split(key, 5)``."""
    model = rget("rdm")
    mob, key = model.init(key, cfg)

    def step(carry, _):
        mob, key = carry
        key, k1, k2, _, _ = jax.random.split(key, 5)
        mob = model.step(k1, k2, mob, cfg)
        return (mob, key), mob.pos

    _, frames = jax.lax.scan(step, (mob, key), None, length=cfg.n_slots)
    return jnp.concatenate([mob.pos[None], frames])


@pytest.mark.parametrize("m_count,lam,seed", [(1, 0.05, 3), (3, 0.3, 1)])
def test_replayed_run_equals_repro_bitwise(working_barrier, m_count, lam,
                                           seed):
    lam_obs = 2 if m_count > 1 else 1
    ref = r_simulate(r_paper_params(lam=lam, M=m_count, Lam=lam_obs),
                     RCfg(**GEOM), seed=seed)
    track = np.asarray(_repro_track(jax.random.PRNGKey(seed), RCfg(**GEOM)))
    out = simulate(paper_params(lam=lam, M=m_count, Lam=lam_obs),
                   SimConfig(**GEOM, mobility="replay"), seed=seed,
                   device="cpu", positions=track)
    for f in TRACES:
        want, got = getattr(ref, f), getattr(out, f)
        assert got.dtype == want.dtype and got.shape == want.shape, f
        np.testing.assert_array_equal(got, want, err_msg=f)
    assert ref.availability.max() > 0          # the protocol really ran
    grid = np.linspace(0.0, 60.0, 13)
    np.testing.assert_allclose(estimate_o_of_tau(out, grid),
                               robs.estimate_o_of_tau(ref, grid),
                               rtol=1e-5, equal_nan=True)


def test_zone_test_rounds_as_the_reversed_fma():
    """Nodes on the zone boundary: the port's membership equals the jitted
    ``norm(pos - c) <= r`` of ``repro``'s engine only with the square as
    ``fma(dy, dy, dx*dx)`` — the reverse of d²'s operand order."""
    from repro_torch.sim.engine import zone_member
    from repro_torch.core.zones import single_zone

    th = np.random.default_rng(1).uniform(0, 2 * np.pi, 50_000)
    c = np.float32(100.0)
    pos = np.stack([c + (5 * np.cos(th)).astype(np.float32),
                    c + (5 * np.sin(th)).astype(np.float32)], -1)
    want = np.asarray(jax.jit(
        lambda p, cc, r: jnp.linalg.norm(p - cc[0], axis=-1) <= r)(
            pos, np.full((1, 2), c), np.float32(5.0)))
    got = zone_member(torch.from_numpy(pos)[None],
                       single_zone((100.0, 100.0), 5.0))[0, :, 0].numpy()
    np.testing.assert_array_equal(got, want)
    dx, dy = pos[:, 0] - c, pos[:, 1] - c
    d2_order = (dx.astype(np.float64) * dx + dy * dy).astype(np.float32)
    assert np.any((np.sqrt(d2_order) <= 5.0) != want)


def test_port_track_starts_where_repro_starts():
    """The port's own rdm track shares ``repro``'s initial frame bit for
    bit and stays within float32 rounding of it (cos/sin/atan2 differ by
    an ulp on a few percent of inputs, so free runs drift slowly)."""
    cfg = dataclasses.replace(SimConfig(**GEOM), n_slots=120)
    want = np.asarray(_repro_track(jax.random.PRNGKey(3),
                                   RCfg(**{**GEOM, "n_slots": 120})))
    got = mobility_track(cfg, seed=3, device="cpu")
    np.testing.assert_array_equal(got[0], want[0])
    assert np.abs(got - want).max() < 1e-3


def _repro_state_fields(cfg, m_count, seed):
    mob, _ = rget("rdm").init(jax.random.PRNGKey(seed), cfg)
    zone0 = jnp.linalg.norm(mob.pos - cfg.area_side / 2, axis=-1) \
        <= cfg.rz_radius
    state = r_init_state(mob, zone0, M=m_count, cfg=cfg)
    fields = {f.name: getattr(state, f.name) for f in dataclasses.fields(state)
              if getattr(state, f.name) is not None}
    fields["mob"] = {f.name: np.asarray(getattr(mob, f.name))
                     for f in dataclasses.fields(mob)}
    return {k: (v if k == "mob" else np.asarray(v)) for k, v in fields.items()}


@pytest.mark.parametrize("m_count", [1, 3])
def test_state_carried_across_equals_port_init(m_count):
    cfg = SimConfig(**GEOM)
    fields = _repro_state_fields(RCfg(**GEOM), m_count, seed=2)
    carried = state_from_numpy(fields, "cpu")
    mob, _ = get_mobility("rdm").init(tr.PRNGKey(2)[None], cfg)
    from repro_torch.sim.engine import effective_zones, zone_member
    from repro_torch.kernels.contacts import zone_words
    own = init_sim_state(mob, zone_words(zone_member(mob.pos,
                                                      effective_zones(cfg))),
                         M=m_count, cfg=cfg)
    for f in dataclasses.fields(own):
        a, b = getattr(carried, f.name), getattr(own, f.name)
        if a is None or b is None:          # the learning carry is off
            assert a is None and b is None, f.name
        elif f.name == "mob":
            for g in dataclasses.fields(a):
                assert torch.equal(getattr(a, g.name), getattr(b, g.name))
        else:
            assert a.dtype == b.dtype and torch.equal(a, b), f.name
    back = state_to_numpy(carried, cfg)
    for k, v in fields.items():
        if k == "mob":
            for g, arr in v.items():
                np.testing.assert_array_equal(back["mob"][g], arr)
        else:
            assert back[k].dtype == v.dtype, k
            np.testing.assert_array_equal(back[k], v, err_msg=k)


def test_free_run_on_cpu():
    cfg = SimConfig(**{**GEOM, "n_slots": 400})
    out = simulate(paper_params(lam=0.05, M=1), cfg, seed=0, device="cpu")
    n_samples = cfg.n_slots // cfg.sample_every
    assert out.availability.shape == (n_samples, 1)
    assert out.obs_birth.shape == (n_samples, 1, cfg.k_obs)
    for f in ("availability", "busy_frac", "stored_info"):
        assert np.all(np.isfinite(getattr(out, f)))
    assert np.all((out.availability >= 0) & (out.availability <= 1))
    assert out.availability.max() > 0
    assert 0 < out.n_in_rz.mean() <= cfg.n_nodes


def test_default_device_without_cuda_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device works")
    with pytest.raises(RuntimeError, match="CUDA"):
        simulate(paper_params(), SimConfig(**GEOM))


TWO_ZONES = ZoneSet(centers=((20.0, 20.0), (40.0, 40.0)), radii=(15.0, 15.0))


@pytest.mark.parametrize("change,error,match", [
    # rwp and speed_range ran into NotImplementedError until the mobility
    # slice: now they run, and what stays outside raises ValueError
    (dict(mobility="rwp"), ValueError, "speed_range is implemented"),
    (dict(speed_range=(0.5, 1.5)), ValueError, "unknown mobility model"),
    # faults must be the port's own record: not an object, not repro's
    (dict(learn=logreg_task(), faults=object()), ValueError,
     "repro_torch.sim.faults.FaultConfig"),
], ids=["change2-rwp", "change3-speed_range", "change4-faults slice"])
def test_configurations_outside_the_slice_raise(change, error, match):
    cfg = SimConfig(**{**GEOM, **change})
    if "faults" not in change:
        out = simulate(paper_params(), dataclasses.replace(cfg, n_slots=16),
                       device="cpu")
        assert np.all(np.isfinite(out.availability)) and out.n_in_rz.min() > 0
        with pytest.raises(error, match=match):
            if change.get("mobility") == "rwp":
                dataclasses.replace(cfg, speed_range=(0.5, 1.5))
            else:
                simulate(paper_params(), dataclasses.replace(
                    cfg, mobility="levy", speed_range=None), device="cpu")
        return
    with pytest.raises(error, match=match):
        simulate(paper_params(), cfg, device="cpu")
    if change.get("faults") is not None and error is ValueError:
        cfg = dataclasses.replace(cfg, faults=RFaultConfig(classes=(
            RFaultClass(frac=0.5), RFaultClass(frac=0.5, free_rider=True))))
        with pytest.raises(ValueError, match="FaultConfig"):
            simulate(paper_params(), cfg, device="cpu")


R_TWO_ZONES = RZoneSet(centers=((20.0, 20.0), (40.0, 40.0)),
                       radii=(15.0, 15.0))


def _byzantine(config, klass):
    return config(classes=(
        klass(frac=0.5), klass(frac=0.5, adv_mode="signflip", adv_scale=1.0)))


@pytest.mark.parametrize("case", ["cells", "cells-harsh", "byzantine",
                                  "dense"])
def test_two_zone_configurations_equal_repro(working_barrier, case):
    """The two-zone configurations this port refused before the multi-zone
    slice (dense, cells, cells under ``harsh()``, the Byzantine path) run
    and equal ``repro``'s runs on its positions, bit for bit on every
    protocol trace (learning traces within rtol 1e-5, as
    ``tests/test_torch_learn.py``)."""
    geom = dict(GEOM, n_slots=160)
    r_kw, t_kw, task, faulted = {}, {}, None, False
    if case.startswith("cells"):
        r_kw["contact_backend"] = t_kw["contact_backend"] = "cells"
    if case == "cells-harsh":
        r_kw["faults"], t_kw["faults"], faulted = rff.harsh(), harsh(), True
    if case == "byzantine":
        r_kw["faults"] = _byzantine(RFaultConfig, RFaultClass)
        t_kw["faults"] = _byzantine(FaultConfig, FaultClass)
        r_kw["learn"], t_kw["learn"] = r_logreg(), logreg_task()
        rtask = rlearn.make_task(r_kw["learn"])
        task = tlearn.task_from_numpy(*(np.asarray(getattr(rtask, f)) for f in
                                        ("theta0", "w_true", "x_test",
                                         "y_test", "stream_key")))
    rcfg = RCfg(**geom, zones=R_TWO_ZONES, **r_kw)
    p_kw = dict(lam=0.3, M=1, Lam=4.0)
    ref = r_simulate(r_paper_params(**p_kw), rcfg, seed=2)
    track = np.asarray(_repro_track_faulted(jax.random.PRNGKey(2), rcfg)
                       if faulted else
                       _repro_track(jax.random.PRNGKey(2), rcfg))
    out = simulate(paper_params(**p_kw),
                   SimConfig(**geom, zones=TWO_ZONES, mobility="replay",
                             **t_kw),
                   seed=2, device="cpu", positions=track, task=task)
    for f in TRACES:
        want, got = getattr(ref, f), getattr(out, f)
        assert got.dtype == want.dtype and got.shape == want.shape, f
        np.testing.assert_array_equal(got, want, err_msg=f)
    assert out.n_in_rz_z.shape[-1] == 2 and ref.availability.max() > 0
    if case == "byzantine":
        np.testing.assert_array_equal(out.merge_stats, ref.merge_stats)
        np.testing.assert_allclose(out.poisoned_frac, ref.poisoned_frac,
                                   rtol=1e-5, atol=1e-6)
    if case == "cells-harsh":
        np.testing.assert_array_equal(out.fault_events, ref.fault_events)


@partial(jax.jit, static_argnames=("cfg",))
def _repro_track_faulted(key, cfg):
    """``_repro_track`` with the fault layer's extra split a slot."""
    model = rget("rdm")
    mob, key = model.init(key, cfg)

    def step(carry, _):
        mob, key = carry
        key, k1, k2, _, _ = jax.random.split(key, 5)
        key = jax.random.split(key, 5)[0]
        mob = model.step(k1, k2, mob, cfg)
        return (mob, key), mob.pos

    _, frames = jax.lax.scan(step, (mob, key), None, length=cfg.n_slots)
    return jnp.concatenate([mob.pos[None], frames])


def test_repro_zone_set_shape_is_kept():
    """The port's ZoneSet is a copy of ``repro``'s record."""
    assert [f.name for f in dataclasses.fields(ZoneSet)] == \
        [f.name for f in dataclasses.fields(RZoneSet)]
