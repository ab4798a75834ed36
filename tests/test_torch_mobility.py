"""``repro_torch.sim.mobility`` against jitted ``repro.sim.mobility``:
the rdm initial state bit for bit, one rdm step within a stated bound
(reflections at the walls included), and the ``replay`` model's key
schedule."""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.sim import SimConfig as RCfg
from repro.sim.mobility import RDMState as RState
from repro.sim.mobility import get_mobility as rget
from repro_torch import random as tr
from repro_torch.numerics import fma32
from repro_torch.sim.engine import SimConfig
from repro_torch.sim.mobility import RDMState, get_mobility, replay_model


def _keys(seed, n=3):
    keys = jax.random.split(jax.random.PRNGKey(seed), n)
    return keys, torch.from_numpy(np.asarray(keys).astype(np.int64))


@pytest.mark.parametrize("seed", [0, 5, 123])
@pytest.mark.parametrize("n,side", [(200, 200.0), (64, 60.0), (800, 400.0)])
def test_rdm_init_bitwise(seed, n, side):
    key = jax.random.PRNGKey(seed)
    want, wkey = jax.jit(lambda k: rget("rdm").init(
        k, RCfg(n_nodes=n, area_side=side)))(key)
    got, gkey = get_mobility("rdm").init(
        tr.PRNGKey(seed)[None], SimConfig(n_nodes=n, area_side=side))
    np.testing.assert_array_equal(got.pos[0].numpy(), np.asarray(want.pos))
    np.testing.assert_array_equal(got.ang[0].numpy(), np.asarray(want.ang))
    np.testing.assert_array_equal(got.spd[0].numpy(), np.asarray(want.spd))
    np.testing.assert_array_equal(gkey[0].numpy(), np.asarray(wkey))


@pytest.mark.parametrize("seed", range(3))
def test_rdm_step_within_ulp_bound(seed):
    """torch's and XLA's float32 cos, sin and atan2 differ by an ulp on a
    few percent of inputs, so a step is held to: positions within one ulp
    of the position plus ``dt`` times 2 ulp of a unit velocity; headings
    within 4 ulp. The renewal coin and new heading are bit for bit, and
    so is the reflection decision wherever the positions agree."""
    n = 4000
    rng = np.random.default_rng(seed)
    pos = rng.uniform(0, 200, (n, 2)).astype(np.float32)
    pos[:800] = rng.choice([0.05, 0.2, 199.8, 199.95], (800, 2))  # walls
    ang = rng.uniform(0, 2 * math.pi, n).astype(np.float32)
    spd = np.ones(n, np.float32)
    keys, kt = _keys(seed, 2)
    cfg = RCfg(n_nodes=n)
    want = jax.jit(lambda k1, k2, s: rget("rdm").step(k1, k2, s, cfg))(
        keys[0], keys[1], RState(jnp.asarray(pos), jnp.asarray(ang),
                                 jnp.asarray(spd)))
    got = get_mobility("rdm").step(
        kt[0:1], kt[1:2],
        RDMState(*(torch.from_numpy(a)[None] for a in (pos, ang, spd))),
        SimConfig(n_nodes=n))
    wp, gp = np.asarray(want.pos), got.pos[0].numpy()
    bound = np.spacing(np.maximum(np.abs(wp), np.abs(gp))) + cfg.dt * 2**-22
    assert np.all(np.abs(wp - gp) <= bound)
    reflected = (np.abs(pos - wp) > 0.3) | (pos < 0.25) | (pos > 199.75)
    assert reflected[:800].any()
    wa, ga = np.asarray(want.ang), got.ang[0].numpy()
    assert np.all(np.abs(wa - ga) <= 4 * np.spacing(np.abs(wa)))
    assert np.mean(wp == gp) > 0.99


@pytest.mark.parametrize("dt", [0.25, 0.1, 0.3])
def test_position_update_is_contracted(dt):
    """``pos + vel * dt`` as jitted XLA rounds it equals the port's FMA
    form (at dt = 0.25 the product is exact and every form agrees)."""
    rng = np.random.default_rng(1)
    p = rng.uniform(0, 200, 100_000).astype(np.float32)
    v = rng.uniform(-1, 1, 100_000).astype(np.float32)
    want = np.asarray(jax.jit(lambda p, v: p + v * dt)(p, v))
    got = fma32(torch.from_numpy(v), float(np.float32(dt)),
                torch.from_numpy(p)).numpy()
    np.testing.assert_array_equal(got, want)


def test_replay_consumes_keys_like_rdm():
    cfg = SimConfig(n_nodes=16, n_slots=3)
    track = torch.rand((4, 1, 16, 2))
    key = tr.PRNGKey(9)[None]
    _, rdm_key = get_mobility("rdm").init(key, cfg)
    model = replay_model(track)
    state, replay_key = model.init(key, cfg)
    assert torch.equal(rdm_key, replay_key)
    assert torch.equal(state.pos, track[0])
    for t in range(1, 4):
        state = model.step(None, None, state, cfg)
        assert torch.equal(state.pos, track[t])
