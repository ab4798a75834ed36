"""Zone membership at a radius where the float32 root decides it.

``repro``'s engine tests ``‖pos - c‖ <= r`` with ``jnp.linalg.norm``
under ``jit``: the correctly rounded float32 root of ``fma(dy, dy,
dx*dx)``. The port's ``sim.engine.zone_member`` takes that root as
``numerics.sqrt32`` (torch's vectorized float32 root on the CPU is an ulp
off on some inputs). The input: a centred zone of radius
24.78697967529297 m and a node at (124.78194, 100.5), whose d² is
614.3944 (bits ``0x4419993e``) and whose root is one ulp above the
radius, so the node is outside.

1. On a (1, 200, 2) track, uniform in a 200 m square from numpy seed 0
   with node 7 on that point, the port's membership equals ``repro``'s
   K = 1 expression on all 200 nodes, and node 7 is out.
2. A replay through ``repro.simulate`` (its rdm positions, with node 7
   moved onto that point at a sampled slot; the barrier patched as in
   ``tests/test_torch_faults.py``) equals the port's run on the same
   positions bit for bit on every trace, and the zone words of every
   frame are ``repro``'s.
"""

from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.sim.compute as rcompute
import repro.sim.mobility as rmob
import repro.sim.observations as robs
from repro.configs.fg_paper import paper_params as r_paper_params
from repro.core.zones import ZoneSet as RZoneSet
from repro.sim import SimConfig as RCfg
from repro.sim import simulate as r_simulate
from repro_torch.configs.fg_paper import paper_params
from repro_torch.core.zones import ZoneSet
from repro_torch.kernels.contacts import zone_words
from repro_torch.numerics import fma32
from repro_torch.sim import SimConfig, simulate
from repro_torch.sim.engine import zone_member
from test_torch_zones_runs import _repro_track

CENTER = (100.0, 100.0)
RADIUS = 24.78697967529297
NODE, POINT = 7, (124.78194, 100.5)
GEOM = dict(n_nodes=200, n_slots=32, sample_every=8)
#: The frame the node sits on the boundary: after slot 7, a sampled slot.
FRAME = 8
PROTOCOL = ("t", "availability", "busy_frac", "stored_info", "obs_birth",
            "obs_holders", "model_holders", "n_in_rz", "availability_z",
            "stored_info_z", "n_in_rz_z")
F32 = np.float32


@pytest.fixture(autouse=True)
def one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@jax.jit
def _repro_member(pos):
    """``repro``'s K = 1 expression (``src/repro/sim/engine.py:412-415``)
    on ``(N, 2)`` positions."""
    return jnp.linalg.norm(pos - jnp.asarray(CENTER, jnp.float32),
                           axis=-1) <= jnp.float32(RADIUS)


def _uniform_track():
    pos = np.random.default_rng(0).uniform(
        0.0, 200.0, (1, 200, 2)).astype(F32)
    pos[0, NODE] = POINT
    return pos


def test_the_boundary_node_is_one_ulp_outside():
    dx, dy = (torch.tensor(F32(POINT[i]) - F32(CENTER[i])) for i in (0, 1))
    d2 = fma32(dy, dy, dx * dx)
    assert int(d2.numpy().view(np.int32)) == 0x4419993E
    root = F32(np.sqrt(np.float64(d2.item())))
    assert root == np.nextafter(F32(RADIUS), F32(np.inf))


def test_zone_member_equals_repro_on_the_queue_input():
    pos = _uniform_track()
    zs = ZoneSet(centers=(CENTER,), radii=(RADIUS,))
    got = zone_member(torch.from_numpy(pos), zs)
    assert got.shape == (1, 200, 1)
    want = np.asarray(_repro_member(pos[0]))
    np.testing.assert_array_equal(got[0, :, 0].numpy(), want)
    assert not want[NODE] and not bool(got[0, NODE, 0])
    assert want.sum() > 0  # other nodes are inside


class _Frames(NamedTuple):
    pos: jnp.ndarray
    frame: jnp.ndarray


def _repro_replay(track: np.ndarray) -> rmob.MobilityModel:
    """``repro``'s side of the port's ``replay_model``: frame 0 at init,
    frame ``t + 1`` after step ``t``, the init key split as rdm's."""
    frames = jnp.asarray(track)

    def init(key, cfg):
        key = jax.random.split(key, 3)[2]
        return _Frames(pos=frames[0], frame=jnp.int32(0)), key

    def step(_k1, _k2, s, cfg):
        return _Frames(pos=frames[s.frame + 1], frame=s.frame + 1)

    return rmob.MobilityModel(name="zone-root-replay", init=init, step=step)


def test_replay_with_a_node_on_the_boundary_equals_repro(monkeypatch):
    monkeypatch.setattr(rcompute, "shared_barrier",
                        jax.lax.optimization_barrier)
    monkeypatch.setattr(robs, "shared_barrier", jax.lax.optimization_barrier)
    track = np.array(_repro_track(jax.random.PRNGKey(0), RCfg(**GEOM)))
    track[FRAME, NODE] = POINT
    monkeypatch.setitem(rmob.MOBILITY_MODELS, "zone-root-replay",
                        _repro_replay(track))

    p = dict(lam=0.3, M=1)
    ref = r_simulate(r_paper_params(**p), RCfg(
        **GEOM, mobility="zone-root-replay",
        zones=RZoneSet(centers=(CENTER,), radii=(RADIUS,))), seed=0)
    zs = ZoneSet(centers=(CENTER,), radii=(RADIUS,))
    out = simulate(paper_params(**p), SimConfig(
        **GEOM, mobility="replay", zones=zs), seed=0, device="cpu",
        positions=track)
    for f in PROTOCOL:
        want, got = getattr(ref, f), getattr(out, f)
        assert got.dtype == want.dtype and got.shape == want.shape, f
        np.testing.assert_array_equal(got, want, err_msg=f)

    # every frame's membership and packed zone words are repro's
    member = zone_member(torch.from_numpy(track), zs)
    want = np.stack([np.asarray(_repro_member(f)) for f in track])
    np.testing.assert_array_equal(member[..., 0].numpy(), want)
    np.testing.assert_array_equal(zone_words(member).numpy(),
                                  want.astype(np.int32))
    assert not want[FRAME, NODE]
    # the sampled count at that slot leaves the boundary node out
    assert ref.n_in_rz[0] == want[FRAME].sum()
