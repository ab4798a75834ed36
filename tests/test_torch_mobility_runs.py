"""Whole runs of the port's other mobility models against ``repro``'s engine
and sweep (CPU).

rwp and manhattan call no transcendental, so the port's *free* runs equal
``repro``'s free runs bit for bit on every trace (fault fields and
``nbr_overflow`` included):

1. ``tests/test_sim_engine.py:93-100``'s configuration (N = 60, 400 slots,
   λ = 0.2, seed 1, dense), rwp and manhattan;
2. rwp with a 60 s pause at ``speed = 1.3, dt = 0.3`` (no exact product);
3. manhattan on the cell lists at the paper density, 160 slots, on a side
   whose street lines lie on cell edges (N = 200, 200 m: cells of 5 m) and
   on one where they fall inside cells (N = 400, 282.8 m);
4. ``harsh()`` faults with rwp (N = 60, 160 slots);
5. a manhattan sweep of 2 λ × 2 seeds (``reduce="trace"``) against
   ``repro.sim.sweep.run``.

rdm with ``speed_range`` drifts by ulps (cos, sin, atan2), so (6) replays
``repro``'s positions, whose init split the key four ways, and equals its
run bit for bit. Then the carry: ``repro``'s initial rwp and manhattan
states carried across equal the port's own, and ``scan_carry_bytes`` is
``repro``'s plus the key's 8 bytes; a sweep checkpoint made under one
street spacing is foreign under another. ``repro``'s engine and sweep run
with ``jax.lax.optimization_barrier`` in place of its ``shared_barrier``
(which fails under this JAX), patched inside each test that runs them.
"""

import dataclasses
import warnings
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.sim.compute as rcompute
import repro.sim.observations as robs
from repro.configs import fg_faults as rff
from repro.configs.fg_paper import paper_params as r_paper_params
from repro.sim import SimConfig as RCfg
from repro.sim import simulate as r_simulate
from repro.sim import sweep as rsweep
from repro.sim.engine import scan_carry_bytes as r_scan_carry_bytes
from repro.sim.mobility import get_mobility as rget
from repro.sim.state import init_sim_state as r_init_state
from repro_torch import random as tr
from repro_torch.configs.fg_faults import harsh
from repro_torch.configs.fg_paper import DENSITY, paper_params
from repro_torch.kernels.contacts import zone_words
from repro_torch.sim import SimConfig, simulate, sweep
from repro_torch.sim.engine import (effective_zones, mobility_track,
                                    scan_carry_bytes, zone_member)
from repro_torch.sim.mobility import (ManhattanState, RWPState, get_mobility,
                                      replay_model)
from repro_torch.sim.state import (init_sim_state, state_from_numpy,
                                   state_to_numpy)

TRACES = ("t", "availability", "busy_frac", "stored_info", "obs_birth",
          "obs_holders", "model_holders", "n_in_rz", "availability_z",
          "stored_info_z", "n_in_rz_z", "nbr_overflow", "availability_c",
          "on_frac_c", "n_in_rz_c", "fault_events")


@pytest.fixture(autouse=True)
def one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture
def working_barrier():
    """``repro``'s ``shared_barrier`` fails on this jax (TypeError in its
    vmap-rule registration); the barrier is the identity, so the reference
    runs the barrier it wraps while a test needs it."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(rcompute, "shared_barrier", jax.lax.optimization_barrier)
        mp.setattr(robs, "shared_barrier", jax.lax.optimization_barrier)
        yield


def _same(ref, out, what, fields=TRACES):
    for f in fields:
        want, got = getattr(ref, f), getattr(out, f)
        if want is None:
            assert got is None, (what, f)
            continue
        assert got.dtype == want.dtype and got.shape == want.shape, (what, f)
        np.testing.assert_array_equal(got, want, err_msg=f"{what} {f}")


def _side(n):
    """The area side holding ``n`` nodes at the paper density."""
    return float(np.sqrt(n / DENSITY))


FREE_RUNS = {
    "rwp": (dict(n_nodes=60, n_slots=400, mobility="rwp",
                 contact_backend="dense"), dict(lam=0.2, M=1), 1, False),
    "manhattan": (dict(n_nodes=60, n_slots=400, mobility="manhattan",
                       contact_backend="dense"), dict(lam=0.2, M=1), 1,
                  False),
    "rwp-pause60-slow": (dict(n_nodes=60, n_slots=304, mobility="rwp",
                              pause_s=60.0, speed=1.3, dt=0.3),
                         dict(lam=0.2, M=1), 1, False),
    "manhattan-cells-200": (dict(n_nodes=200, n_slots=160,
                                 mobility="manhattan",
                                 contact_backend="cells"),
                            dict(lam=0.05, M=1), 0, False),
    "manhattan-cells-400": (dict(n_nodes=400, area_side=_side(400),
                                 rz_radius=_side(400) / 2, n_slots=160,
                                 mobility="manhattan",
                                 contact_backend="cells"),
                            dict(lam=0.05, M=1), 0, False),
    "rwp-harsh": (dict(n_nodes=60, n_slots=160, mobility="rwp"),
                  dict(lam=0.2, M=1), 1, True),
}


@pytest.mark.parametrize("case", list(FREE_RUNS))
def test_free_run_equals_repro(working_barrier, case):
    kw, p_kw, seed, faulted = FREE_RUNS[case]
    ref = r_simulate(r_paper_params(**p_kw), RCfg(
        **kw, **(dict(faults=rff.harsh()) if faulted else {})), seed=seed)
    out = simulate(paper_params(**p_kw), SimConfig(
        **kw, **(dict(faults=harsh()) if faulted else {})), seed=seed,
        device="cpu")
    _same(ref, out, case)
    assert ref.availability.max() > 0                  # the protocol ran
    if "cells" in case:
        assert out.nbr_overflow is not None and out.nbr_overflow.max() == 0
        cell = kw["area_side"] / np.floor(kw["area_side"] / 5.0) \
            if "area_side" in kw else 5.0
        # 200 m: the street lines lie on cell edges; 282.8 m: inside cells
        on_edges = np.allclose(np.arange(0, 200, 25) / cell,
                               np.round(np.arange(0, 200, 25) / cell))
        assert on_edges == ("200" in case)
    if faulted:
        assert out.fault_events[-1].sum() > 0


def test_manhattan_sweep_equals_repro(working_barrier):
    lams, seeds = (0.05, 0.3), (0, 5)
    kw = dict(n_nodes=60, n_slots=96, mobility="manhattan",
              street_spacing=30.0)
    ref = rsweep.run([r_paper_params(lam=x, M=1) for x in lams], RCfg(**kw),
                     seeds, reduce="trace")
    got = sweep.run([paper_params(lam=x, M=1) for x in lams], SimConfig(**kw),
                    seeds, reduce="trace", device="cpu")
    for f in TRACES[1:11]:
        np.testing.assert_array_equal(getattr(got, f), getattr(ref, f),
                                      err_msg=f)
    # per-seed mobility: each seed's rows share their population trace
    np.testing.assert_array_equal(got.n_in_rz[0], got.n_in_rz[1])
    assert not np.array_equal(got.n_in_rz[0, 0], got.n_in_rz[0, 1])


@partial(jax.jit, static_argnames=("cfg",))
def _repro_track(key, cfg):
    """``(n_slots + 1, N, 2)`` positions of ``cfg.mobility`` under the
    engine's schedule: init, then ``key, k1, k2, k_obs, k_who = split(key,
    5)`` a slot."""
    model = rget(cfg.mobility)
    mob, key = model.init(key, cfg)

    def step(carry, _):
        mob, key = carry
        key, k1, k2, _, _ = jax.random.split(key, 5)
        mob = model.step(k1, k2, mob, cfg)
        return (mob, key), mob.pos

    _, frames = jax.lax.scan(step, (mob, key), None, length=cfg.n_slots)
    return jnp.concatenate([mob.pos[None], frames])


def test_speed_range_replay_equals_repro(working_barrier):
    """rdm under ``speed_range`` splits its init key four ways: the replay
    does too (``cfg.speed_range`` with ``mobility="replay"``), so every
    draw after the init stays aligned and the run equals ``repro``'s."""
    kw = dict(n_nodes=60, area_side=60.0, rz_radius=30.0, n_slots=304,
              speed_range=(0.1, 1.9))
    p_kw = dict(lam=0.3, M=1)
    ref = r_simulate(r_paper_params(**p_kw), RCfg(**kw), seed=2)
    track = np.asarray(_repro_track(jax.random.PRNGKey(2), RCfg(**kw)))
    out = simulate(paper_params(**p_kw), SimConfig(**kw, mobility="replay"),
                   seed=2, device="cpu", positions=track)
    _same(ref, out, "speed_range replay")
    assert ref.availability.max() > 0
    # the three-way split of a constant-speed replay puts the draws
    # elsewhere: the same positions then give another run
    other = simulate(paper_params(**p_kw), SimConfig(
        **dict(kw, speed_range=None), mobility="replay"), seed=2,
        device="cpu", positions=track)
    assert not np.array_equal(other.obs_birth, ref.obs_birth)
    # the port's own track: the initial frame bit for bit
    np.testing.assert_array_equal(
        mobility_track(SimConfig(**kw), seed=2, device="cpu")[0], track[0])


def test_replay_splits_like_the_replayed_model():
    track = torch.zeros((2, 1, 8, 2))
    key = tr.PRNGKey(9)[None]
    for kw in ({}, dict(speed_range=(0.5, 1.5))):
        cfg = SimConfig(n_nodes=8, **kw)
        _, want = get_mobility("rdm").init(key, cfg)
        _, got = replay_model(track).init(key, dataclasses.replace(
            cfg, mobility="replay"))
        assert torch.equal(got, want)
    for name in ("rwp", "manhattan"):
        _, want = get_mobility(name).init(key, SimConfig(n_nodes=8))
        _, got = replay_model(track).init(key, SimConfig(n_nodes=8))
        assert torch.equal(got, want)


# ------------------------------------------------------------------ carry

def _repro_fields(cfg, name, seed):
    mob, _ = rget(name).init(jax.random.PRNGKey(seed), cfg)
    zone0 = jnp.linalg.norm(mob.pos - cfg.area_side / 2, axis=-1) \
        <= cfg.rz_radius
    state = r_init_state(mob, zone0, M=1, cfg=cfg)
    fields = {f.name: np.asarray(getattr(state, f.name))
              for f in dataclasses.fields(state)
              if f.name != "mob" and getattr(state, f.name) is not None}
    fields["mob"] = {f.name: np.asarray(getattr(mob, f.name))
                     for f in dataclasses.fields(mob)}
    return fields


@pytest.mark.parametrize("name", ["rwp", "manhattan"])
def test_state_carried_across_equals_port_init(name):
    kw = dict(n_nodes=64, area_side=60.0, rz_radius=30.0, mobility=name)
    cfg = SimConfig(**kw)
    fields = _repro_fields(RCfg(**kw), name, seed=2)
    carried = state_from_numpy(fields, "cpu")
    assert isinstance(carried.mob, RWPState if name == "rwp"
                      else ManhattanState)
    mob, _ = get_mobility(name).init(tr.PRNGKey(2)[None], cfg)
    own = init_sim_state(mob, zone_words(zone_member(
        mob.pos, effective_zones(cfg))), M=1, cfg=cfg)
    for f in dataclasses.fields(own):
        a, b = getattr(carried, f.name), getattr(own, f.name)
        if a is None or b is None:
            assert a is None and b is None, f.name
        elif f.name == "mob":
            for g in dataclasses.fields(a):
                x, y = getattr(a, g.name), getattr(b, g.name)
                assert x.dtype == y.dtype and torch.equal(x, y), g.name
        else:
            assert a.dtype == b.dtype and torch.equal(a, b), f.name
    back = state_to_numpy(carried, cfg)
    for k, v in fields.items():
        if k == "mob":
            for g, arr in v.items():
                assert back["mob"][g].dtype == arr.dtype, g
                np.testing.assert_array_equal(back["mob"][g], arr)
        else:
            np.testing.assert_array_equal(back[k], v, err_msg=k)


@pytest.mark.parametrize("kw", [dict(mobility="rwp", pause_s=30.0),
                                dict(mobility="manhattan"),
                                dict(speed_range=(0.1, 1.9))],
                         ids=["rwp", "manhattan", "speed_range"])
def test_scan_carry_bytes_is_repros_plus_the_key(kw):
    for m in (1, 4):
        assert scan_carry_bytes(SimConfig(**kw), m) == \
            r_scan_carry_bytes(RCfg(**kw), m) + 8


def test_checkpoint_of_another_street_spacing_is_foreign(tmp_path):
    ps = [paper_params(lam=x, M=1) for x in (0.05, 0.2)]
    kw = dict(n_nodes=40, area_side=60.0, rz_radius=30.0, n_slots=32,
              mobility="manhattan")
    sweep.run(ps, SimConfig(**kw, street_spacing=20.0), (0,), reduce="mean",
              device="cpu", checkpoint_dir=str(tmp_path))
    cfg = SimConfig(**kw, street_spacing=15.0)
    fresh = sweep.run(ps, cfg, (0,), reduce="mean", device="cpu")
    with warnings.catch_warnings(record=True) as rec:
        warnings.simplefilter("always")
        resumed = sweep.run(ps, cfg, (0,), reduce="mean", device="cpu",
                            checkpoint_dir=str(tmp_path), resume=True)
    assert any("fingerprint" in str(w.message) for w in rec)
    for k, v in fresh.stats.items():
        np.testing.assert_array_equal(resumed.stats[k], v, err_msg=k)
