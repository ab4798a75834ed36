"""The port's multi-zone and drifting Replication Zones in whole runs,
against ``repro``'s engine and sweep on the same positions.

1. ``tests/test_sim_zones.py``'s churn invariants on the port's
   ``zone_churn``, over membership words of up to 32 bits (bit 31, the
   int32 sign bit, included): state drops exactly once, on leaving the
   union of zones, and a move from one zone into another keeps it.
2. An explicit one-disc ``ZoneSet`` runs the default configuration bit for
   bit, and disjoint zones' ``n_in_rz_z`` sums to ``n_in_rz``.
3. Replays of ``repro``'s positions (N = 200 dense, N = 1024 cells, 160
   slots) equal ``repro``'s runs bit for bit on every trace, the per-zone
   ones included: three zones (two overlapping, one disjoint and
   drifting) on both backends, 32 zones with a node in zone 31 alone,
   ``harsh()`` faults with learning across two zones, and a B = 2 sweep
   with its ``mean`` reduction (within ``tests/test_torch_sweep.py``'s
   1e-6 relative). The drifting zone's radius and one static zone's are
   set so that a node sits exactly on the boundary at a sampled slot under
   the pinned arithmetic (``fma(u, t, c)`` for the drift, ``sqrt(fma(dy,
   dy, dx*dx))`` for the distance) and outside it under the other order,
   so the replay decides both.

``repro``'s engine and sweep run with ``jax.lax.optimization_barrier`` in
place of its ``shared_barrier`` (which fails under this JAX), patched
inside each test that runs them.
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
from repro.sim import sweep as rsweep
from repro.sim.mobility import get_mobility as rget
from repro_torch.configs import fg_faults as tff
from repro_torch.configs.fg_learn import logreg_task
from repro_torch.configs.fg_paper import DENSITY, paper_params
from repro_torch.core.zones import ZoneSet, single_zone
from repro_torch.kernels.contacts import zone_words
from repro_torch.numerics import fma32
from repro_torch.sim import SimConfig, simulate, sweep
from repro_torch.sim import learn as tlearn
from repro_torch.sim.engine import zone_churn, zone_member

PROTOCOL = ("t", "availability", "busy_frac", "stored_info", "obs_birth",
            "obs_holders", "model_holders", "n_in_rz", "availability_z",
            "stored_info_z", "n_in_rz_z")
FAULT = ("availability_c", "on_frac_c", "n_in_rz_c", "fault_events")
LEARNING = ("test_acc", "test_acc_holders", "learn_obs", "theta_var")
TASK_FIELDS = ("theta0", "w_true", "x_test", "y_test", "stream_key")
#: The paper's §VI geometry, cut to 160 slots.
PAPER = dict(n_nodes=200, n_slots=160, sample_every=8)
#: N = 1024 at the paper's density on the cell lists, 160 slots.
SIDE_1024 = float(np.sqrt(1024 / DENSITY))
CELLS = dict(n_nodes=1024, area_side=SIDE_1024, n_slots=160, sample_every=8,
             contact_backend="cells")
#: mean reductions: float32 sums in another order (test_torch_sweep.py)
RTOL = 1e-6
F32 = np.float32


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


@partial(jax.jit, static_argnames=("cfg", "faulted"))
def _repro_track(key, cfg, faulted=False):
    """``(n_slots + 1, N, 2)`` rdm positions under ``repro``'s key schedule
    (with the fault layer's extra split a slot when ``faulted``)."""
    model = rget("rdm")
    mob, key = model.init(key, cfg)

    def step(carry, _):
        mob, key = carry
        key, k1, k2, _, _ = jax.random.split(key, 5)
        if faulted:
            key = jax.random.split(key, 5)[0]
        mob = model.step(k1, k2, mob, cfg)
        return (mob, key), mob.pos

    _, frames = jax.lax.scan(step, (mob, key), None, length=cfg.n_slots)
    return jnp.concatenate([mob.pos[None], frames])


def _zone_sets(**kw):
    return RZoneSet(**kw), ZoneSet(**kw)


# ------------------------------------------------ 1. the churn invariants

def _apply_trajectory(words: np.ndarray):
    """Roll the port's ``zone_churn`` over a (T, N) int32 membership
    trajectory from a nonzero packed state; returns the (T-1, N) drops,
    the (T-1, N) survival of the packed state and the final fields."""
    n = words.shape[1]
    inc = torch.full((n, 1, 1), 0xABCD, dtype=torch.int32)
    has_model = torch.ones((n, 1), dtype=torch.bool)
    tq = torch.zeros((n, 2), dtype=torch.int32)
    mq = torch.zeros((n, 2), dtype=torch.int32)
    serving = torch.zeros((n,), dtype=torch.int32)
    serv_left = torch.ones((n,))
    drops, alive = [], []
    prev = torch.from_numpy(words[0])
    for t in range(1, words.shape[0]):
        cur = torch.from_numpy(words[t])
        left, ch = zone_churn(prev, cur, inc=inc, has_model=has_model,
                              tq_model=tq, mq_model=mq, serving=serving,
                              serv_left=serv_left)
        drops.append(left.numpy())
        inc, has_model = ch["inc"], ch["has_model"]
        tq, mq = ch["tq_model"], ch["mq_model"]
        serving, serv_left = ch["serving"], ch["serv_left"]
        alive.append((inc[:, 0, 0] != 0).numpy())
        prev = cur
    return np.asarray(drops), np.asarray(alive), dict(
        inc=inc.numpy(), has_model=has_model.numpy(), tq=tq.numpy(),
        mq=mq.numpy(), serving=serving.numpy())


def _check_churn_invariants(words: np.ndarray):
    drops, alive, final = _apply_trajectory(words)
    member = words != 0
    expect = member[:-1] & ~member[1:]
    np.testing.assert_array_equal(drops, expect)
    ever = expect.any(axis=0)
    np.testing.assert_array_equal(final["inc"][:, 0, 0] == 0, ever)
    np.testing.assert_array_equal(~final["has_model"][:, 0], ever)
    np.testing.assert_array_equal(final["tq"][:, 0] == -1, ever)
    np.testing.assert_array_equal(final["mq"][:, 0] == -1, ever)
    np.testing.assert_array_equal(final["serving"] == -1, ever)
    first = np.where(ever, expect.argmax(axis=0), expect.shape[0])
    steps = np.arange(expect.shape[0])[:, None]
    np.testing.assert_array_equal(alive, steps < first[None, :])


@pytest.mark.parametrize("seed", range(8))
def test_churn_drops_exactly_on_union_exit_seeded(seed):
    """Words of k in 1..32 bits; a word with bit 31 set is a negative int32
    and still a member."""
    rng = np.random.default_rng(seed)
    k = int(rng.choice([1, 2, 4, 31, 32]))
    words = rng.integers(0, 2 ** k, size=(12, 16)).astype(np.int64)
    words[rng.random(words.shape) < 0.3] = 0        # leave the union often
    if k == 32:
        words[:, 0] = np.where(np.arange(12) % 3 == 2, 0, 1 << 31)
    _check_churn_invariants(words.astype(np.uint32).view(np.int32))


def test_zone_migration_transfers_state():
    """A move from zone 0 to zone 1, or into zone 31 alone (the sign bit),
    keeps the packed state; only the union exit clears it."""
    words = np.asarray([
        [0b01, 0b01, 1],
        [0b10, 0b11, 1 << 31],
        [0b10, 0b10, 1 << 31],
        [0b00, 0b10, 0],
    ], dtype=np.int64).astype(np.uint32).view(np.int32)
    drops, _, final = _apply_trajectory(words)
    np.testing.assert_array_equal(
        drops, [[False] * 3, [False] * 3, [True, False, True]])
    assert final["inc"][0, 0, 0] == 0 and final["inc"][1, 0, 0] != 0
    assert not final["has_model"][0, 0] and final["has_model"][1, 0]


def test_zone_words_keep_bit_31():
    """``zone_words`` of a (N, 32) membership sets bit 31 as the int32 sign
    bit, and the words intersect as ``repro``'s uint32 words do."""
    rng = np.random.default_rng(4)
    member = rng.random((300, 32)) < 0.1
    member[:5] = False
    member[:5, 31] = True                       # zone 31 only
    got = zone_words(torch.from_numpy(member)).numpy()
    want = (member.astype(np.uint64) << np.arange(32, dtype=np.uint64)).sum(
        -1).astype(np.uint32)
    np.testing.assert_array_equal(got, want.view(np.int32))
    assert np.all(got[:5] == np.int32(-2 ** 31))
    share = (got[:, None] & got[None, :]) != 0
    np.testing.assert_array_equal(share, (want[:, None] & want[None, :]) != 0)


# ----------------------------------------------- 2. runs of the port alone

def test_k1_zoneset_bitwise_equals_default_engine():
    cfg = SimConfig(n_nodes=60, n_slots=160, sample_every=8)
    zcfg = dataclasses.replace(cfg, zones=single_zone(
        (cfg.area_side / 2, cfg.area_side / 2), cfg.rz_radius))
    p = paper_params(lam=0.2, M=2, Lam=2)
    a = simulate(p, cfg, seed=5, device="cpu")
    b = simulate(p, zcfg, seed=5, device="cpu")
    for f in PROTOCOL:
        np.testing.assert_array_equal(getattr(a, f), getattr(b, f),
                                      err_msg=f)


def test_disjoint_zones_partition_the_union():
    zs = ZoneSet(centers=((50.0, 100.0), (150.0, 100.0)), radii=(45.0, 45.0))
    out = simulate(paper_params(lam=0.2, M=1),
                   SimConfig(n_nodes=200, n_slots=160, sample_every=8,
                             zones=zs), seed=0, device="cpu")
    assert out.n_in_rz_z.shape == out.n_in_rz.shape + (2,)
    np.testing.assert_array_equal(out.n_in_rz_z.sum(-1), out.n_in_rz)
    assert np.all(out.n_in_rz_z > 0)


# ------------------------------------------------- 3. replays against repro

def _center(c, u, t_slot: int, side: float, fused: bool) -> np.ndarray:
    """A drifting center at slot ``t_slot``, folded into the area, with
    ``c + u t`` fused (the engine's pin) or rounded twice."""
    t = float(F32(t_slot) * F32(0.25))
    c, u = torch.tensor(F32(c)), torch.tensor(F32(u))
    raw = fma32(u, t, c) if fused else u * t + c
    m = torch.remainder(raw, float(F32(2 * side)))
    return (float(F32(side)) - torch.abs(float(F32(side)) - m)).numpy()


def _dist(p, c, yx: bool) -> np.ndarray:
    dx = torch.from_numpy(p[:, 0] - F32(c[0]))
    dy = torch.from_numpy(p[:, 1] - F32(c[1]))
    sq = fma32(dy, dy, dx * dx) if yx else fma32(dx, dx, dy * dy)
    return torch.sqrt(sq).numpy()


def _on_boundary(track, c, u, side, lo, hi, *, drift: bool) -> float:
    """A radius in [lo, hi] that puts one node exactly on the zone's
    boundary at a sampled slot (every 8th) under the engine's arithmetic
    and outside it under the other order: the fold unfused when
    ``drift``, else the distance squared as ``fma(dx, dx, dy*dy)``."""
    for s in range(7, track.shape[0] - 1, 8):
        p = track[s + 1]
        if drift:
            cf, co = (_center(c, u, s, side, f) for f in (True, False))
            d, d_other = _dist(p, cf, True), _dist(p, co, True)
        else:
            d, d_other = _dist(p, c, True), _dist(p, c, False)
        hit = np.nonzero((d_other > d) & (d > lo) & (d < hi))[0]
        if hit.size:
            return float(d[hit[0]])
    raise AssertionError("no node on an order-sensitive boundary")


def three_zones(track, side: float):
    """Two overlapping static zones and a disjoint drifting one, scaled to
    the area ``side`` (200 m: the paper's), their radii put on the
    boundaries of :func:`_on_boundary`."""
    s = side / 200.0
    c0, c1 = (60.0 * s, 100.0 * s), (110.0 * s, 100.0 * s)
    c2, u2 = (150.0 * s, 165.0 * s), (2.6, 1.8)
    r0 = _on_boundary(track, c0, None, side, 35 * s, 45 * s, drift=False)
    r2 = _on_boundary(track, c2, u2, side, 15 * s, 28 * s, drift=True)
    return dict(centers=(c0, c1, c2), radii=(r0, 40.0 * s, r2),
                drift=((0.0, 0.0), (0.0, 0.0), u2))


def grid_32_zones():
    """32 discs on an 8 x 4 grid over the paper's area, neighbours in a row
    overlapping: zone 31 is the top right disc."""
    centers = tuple((12.5 + 25.0 * (z % 8), 25.0 + 50.0 * (z // 8))
                    for z in range(32))
    return dict(centers=centers, radii=(14.0,) * 32)


def _replay(geom, zkw, *, seed, lam=0.3, M=1, faults=None, learn=False,
            track=None):
    """``repro``'s run and the port's on ``repro``'s positions."""
    rz, tz = _zone_sets(**zkw)
    extra_r, extra_t, task = {}, {}, None
    if faults is not None:
        extra_r["faults"] = getattr(rff, faults)()
        extra_t["faults"] = getattr(tff, faults)()
    p_args = dict(lam=lam, M=M)
    if learn:
        p_args["Lam"] = 10.0
        extra_r["learn"], extra_t["learn"] = r_logreg(), logreg_task()
        rtask = rlearn.make_task(extra_r["learn"])
        task = tlearn.task_from_numpy(
            *(np.asarray(getattr(rtask, f)) for f in TASK_FIELDS))
    rcfg = RCfg(**geom, zones=rz, **extra_r)
    ref = r_simulate(r_paper_params(**p_args), rcfg, seed=seed)
    if track is None:
        track = _track(geom, seed, faulted=faults is not None)
    out = simulate(paper_params(**p_args),
                   SimConfig(**geom, zones=tz, mobility="replay", **extra_t),
                   seed=seed, device="cpu", positions=track, task=task)
    return ref, out


def _track(geom, seed, faulted=False):
    return np.asarray(_repro_track(jax.random.PRNGKey(seed), RCfg(**geom),
                                   faulted))


def _assert_same(ref, out, fields):
    for f in fields:
        want, got = getattr(ref, f), getattr(out, f)
        assert want is not None and got is not None, f
        assert got.dtype == want.dtype and got.shape == want.shape, f
        np.testing.assert_array_equal(got, want, err_msg=f)


def _other_order_counts(track, zkw, side):
    """``n_in_rz_z`` at the sampled slots under the unpinned orders (the
    drift unfused, the square as ``fma(dx, dx, dy*dy)``)."""
    c = np.asarray(zkw["centers"], np.float32)
    r = np.asarray(zkw["radii"], np.float32)
    u = zkw.get("drift") or ((0.0, 0.0),) * len(r)
    counts = []
    for s in range(7, track.shape[0] - 1, 8):
        p = track[s + 1]
        cols = []
        for z in range(len(r)):
            cz = (_center(c[z], u[z], s, side, False) if any(u[z]) else c[z])
            cols.append((_dist(p, cz, False) <= r[z]).sum())
        counts.append(cols)
    return np.asarray(counts, np.int32)


@pytest.mark.parametrize("backend", ["dense", "cells"])
def test_three_zones_with_drift_equal_repro(working_barrier, backend):
    geom = PAPER if backend == "dense" else CELLS
    side = geom.get("area_side", 200.0)
    track = _track(geom, seed=3)
    zkw = three_zones(track, side)
    ref, out = _replay(geom, zkw, seed=3, track=track)
    _assert_same(ref, out, PROTOCOL + (
        ("nbr_overflow",) if backend == "cells" else ()))
    assert out.n_in_rz_z.shape == out.n_in_rz.shape + (3,)
    assert np.all(ref.n_in_rz_z.max(axis=0) > 0)
    assert np.all(ref.availability_z[:, 0, :2].max(axis=0) > 0)  # it ran
    # the boundary nodes: the other orders count differently somewhere
    assert not np.array_equal(_other_order_counts(track, zkw, side),
                              ref.n_in_rz_z)
    # the overlap: the union counts a node of zones 0 and 1 once
    assert np.any(ref.n_in_rz_z.sum(-1) > ref.n_in_rz)


def test_32_zones_with_bit_31_equal_repro(working_barrier):
    track = _track(PAPER, seed=1)
    zkw = grid_32_zones()
    ref, out = _replay(PAPER, zkw, seed=1, track=track)
    _assert_same(ref, out, PROTOCOL)
    assert out.n_in_rz_z.shape[-1] == 32
    # nodes in zone 31 alone (word = the int32 sign bit) in the run
    zs = ZoneSet(**zkw)
    words = zone_words(zone_member(torch.tensor(track[1:]), zs))
    assert int((words == -2 ** 31).sum()) > 0
    assert ref.n_in_rz_z[:, 31].max() > 0


def test_harsh_learning_across_two_zones_equals_repro(working_barrier):
    zkw = dict(centers=((75.0, 100.0), (125.0, 100.0)), radii=(60.0, 60.0))
    ref, out = _replay(PAPER, zkw, seed=2, lam=0.05, faults="harsh",
                       learn=True)
    _assert_same(ref, out, PROTOCOL + FAULT + ("merge_stats",))
    for f in LEARNING:
        want, got = getattr(ref, f), getattr(out, f)
        assert got.dtype == want.dtype and got.shape == want.shape, f
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6,
                                   err_msg=f)
    assert ref.merge_stats[-1, rlearn.MS_ATTEMPT] > 0
    assert np.all(ref.fault_events[-1] > 0)


SWEEP_GEOM = dict(n_nodes=64, area_side=60.0, n_slots=160, sample_every=8)
SWEEP_ZONES = dict(centers=((18.0, 30.0), (33.0, 30.0), (45.0, 49.5)),
                   radii=(13.5, 12.0, 6.0),
                   drift=((0.0, 0.0), (0.0, 0.0), (0.4, 0.3)))


@pytest.mark.parametrize("reduce", ["trace", "mean"])
def test_zone_sweep_equals_repro(working_barrier, reduce):
    """A P = 2 x R = 1 sweep (B = 2) over three zones, one drifting."""
    rz, tz = _zone_sets(**SWEEP_ZONES)
    lams, seeds = (0.1, 0.3), (4,)
    rcfg = RCfg(**SWEEP_GEOM, zones=rz)
    ref = rsweep.run([r_paper_params(lam=x, M=1) for x in lams], rcfg,
                     seeds, reduce=reduce)
    tracks = np.stack([_track(SWEEP_GEOM, s) for s in seeds])
    got = sweep.run([paper_params(lam=x, M=1) for x in lams],
                    SimConfig(**SWEEP_GEOM, zones=tz, mobility="replay"),
                    seeds, reduce=reduce, device="cpu", positions=tracks)
    if reduce == "trace":
        _assert_same(ref, got, PROTOCOL)
        assert got.availability_z.shape[-1] == 3
        return
    assert set(got.stats) == set(ref.stats)
    for k, want in ref.stats.items():
        have = got.stats[k]
        assert have.shape == want.shape and have.dtype == want.dtype, k
        np.testing.assert_allclose(have, want, rtol=RTOL, atol=0.0,
                                   err_msg=k)
    assert got.stats["availability_z"].shape[-1] == 3
