"""``repro_torch.sim.contacts`` against jitted ``repro.sim.contacts``, bit
for bit: the pairwise stages on the CPU structure (shared packed matrix,
partner bit read from it), the O(N) partner recompute, matching,
exchange progression, deliveries (M = 1 fast path and the general path)
and new connections, including the ``t0 + n T_L`` multiply-add."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.sim.compute as rcompute
from repro.sim import contacts as rc
from repro_torch.kernels.contacts import zone_words
from repro_torch.sim import contacts as tc

R_TX2 = 25.0


@pytest.fixture(autouse=True)
def working_barrier(monkeypatch):
    """The seed's ``shared_barrier`` fails on this jax (TypeError in its
    vmap-rule registration); the barrier is the identity, so each test
    runs the barrier it wraps."""
    monkeypatch.setattr(rcompute, "shared_barrier",
                        jax.lax.optimization_barrier)


def _t(a):
    a = np.array(a)
    if a.dtype == np.uint32:
        a = a.view(np.int32)
    return torch.from_numpy(a)[None]


def _np(t, words=False):
    a = t[0].numpy()
    return a.view(np.uint32) if words else a


def _geometry(seed, n=96, side=40.0):
    rng = np.random.default_rng(seed)
    pos = rng.uniform(0, side, (n, 2)).astype(np.float32)
    member = (np.linalg.norm(pos - side / 2, axis=1) <= side / 2.2)[:, None]
    perm = rng.permutation(n)
    partner = np.full(n, -1, np.int32)
    half = n // 3
    partner[perm[:half]] = perm[half:2 * half]        # some busy pairs,
    partner[perm[half:2 * half]] = perm[:half]        # symmetric
    return rng, pos, member, partner


@pytest.mark.parametrize("seed", range(3))
def test_pairwise_stages_and_partner_bits(seed):
    rng, pos, member, partner = _geometry(seed)
    zw_r = np.asarray(rcompute.pack_mask(jnp.asarray(member))[:, 0])
    closew_r, d2ctx = jax.jit(rc.pairwise_close, static_argnums=2)(
        pos, member[:, 0], R_TX2)
    zw = _t(zw_r)
    closew, ctx = tc.pairwise_close(_t(pos), zw, R_TX2)
    np.testing.assert_array_equal(_np(closew, True), np.asarray(closew_r))
    np.testing.assert_array_equal(_np(zone_words(_t(member))), zw_r.view(np.int32))

    bit_r = jax.jit(rc.partner_close_bit)(closew_r, partner)
    bit = tc.partner_close_bit(closew, _t(partner))
    still = tc.pair_still_close(_t(pos), zw, _t(partner), R_TX2)
    still_r = jax.jit(rc.pair_still_close, static_argnums=3)(
        pos, zw_r, partner, R_TX2)
    busy = partner >= 0
    np.testing.assert_array_equal(_np(bit), np.asarray(bit_r))
    np.testing.assert_array_equal(_np(still), np.asarray(still_r))
    np.testing.assert_array_equal(_np(bit)[busy], _np(still)[busy])

    prev = rng.random((len(pos), len(pos))) < 0.2
    prevw_r = rcompute.pack_mask(jnp.asarray(prev & prev.T))
    elig = rng.random(len(pos)) < 0.7
    cw_r, match_r = jax.jit(rc.match_candidates)(d2ctx, prevw_r, elig)
    cw, match = tc.match_candidates(ctx, _t(prevw_r), _t(elig))
    np.testing.assert_array_equal(_np(cw, True), np.asarray(cw_r))
    np.testing.assert_array_equal(_np(match), np.asarray(match_r))


def test_partner_recompute_on_the_threshold():
    """Pairs placed where d²'s close bit depends on its rounding: the
    O(N) recompute matches the jitted reference only with
    d² = fma(dx, dx, dy*dy)."""
    rng = np.random.default_rng(2)
    th = rng.uniform(0, 2 * np.pi, 100_000)
    off = np.stack([5 * np.cos(th), 5 * np.sin(th)], -1).astype(np.float32)
    dx, dy = off[:, 0], off[:, 1]
    fma = (dx.astype(np.float64) * dx + (dy * dy)).astype(np.float32)
    off = off[(fma <= 25.0) != (dx * dx + dy * dy <= 25.0)][:64]
    n = 2 * len(off)
    pos = np.zeros((n, 2), np.float32)
    pos[1::2] = -off                      # node 2k at the origin, 2k+1 off
    partner = np.arange(n, dtype=np.int32) ^ 1
    zw = np.ones(n, np.uint32)
    want = jax.jit(rc.pair_still_close, static_argnums=3)(
        pos, zw, partner, R_TX2)
    got = tc.pair_still_close(_t(pos), _t(zw), _t(partner), R_TX2)
    np.testing.assert_array_equal(_np(got), np.asarray(want))
    assert 0 < np.asarray(want).sum() < n


def test_mutualize_sentinels():
    best = np.asarray([3, -1, -1, 0, 5, 4, 1], np.int32)
    for has in ([True, False, False, True, True, True, True],
                [True, False, False, False, True, False, True]):
        has = np.asarray(has)
        np.testing.assert_array_equal(
            _np(tc.mutualize(_t(best), _t(has))),
            np.asarray(jax.jit(rc.mutualize)(best, has)))


@pytest.mark.parametrize("seed", range(3))
def test_advance_exchanges(seed):
    rng, _, _, partner = _geometry(seed)
    n = len(partner)
    kw = dict(
        partner=partner,
        exch_elapsed=rng.choice([0.0, 0.05, 0.25, 1.0], n).astype(np.float32),
        exch_total=rng.choice([0.102, 0.25, 0.5, 0.104], n).astype(np.float32),
        still_close=rng.random(n) < 0.8,
    )
    want = jax.jit(lambda kw: rc.advance_exchanges(**kw, dt=0.25))(kw)
    got = tc.advance_exchanges(**{k: _t(v) for k, v in kw.items()}, dt=0.25)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(_np(g), np.asarray(w))


def _delivery_inputs(seed, m_count, n=64, kw=2):
    rng = np.random.default_rng(seed)
    return dict(
        order_seed=rng.integers(0, 2**32, n, dtype=np.uint32),
        snap_has=rng.random((n, m_count)) < 0.7,
        snap=rng.integers(0, 2**32, (n, m_count, kw), dtype=np.uint32),
        pidx=rng.integers(0, n, n, dtype=np.int32),
        eff_time=rng.choice([0.0, 0.05, 0.1, 0.102, 0.104, 0.106, 0.15, 1.0],
                            n).astype(np.float32),
        ending=rng.random(n) < 0.5,
    )


@pytest.mark.parametrize("m_count", [1, 3, 5])
@pytest.mark.parametrize("t0,T_L", [(0.1, 0.002), (0.1, 0.05), (0.0, 0.1)])
@pytest.mark.parametrize("seed", range(2))
def test_compute_deliveries(seed, t0, T_L, m_count):
    kw = _delivery_inputs(seed, m_count)
    want = jax.jit(rc.compute_deliveries)(
        **kw, t0=jnp.float32(t0), T_L=jnp.float32(T_L))
    got = tc.compute_deliveries(**{k: _t(v) for k, v in kw.items()},
                                t0=t0, T_L=T_L)
    np.testing.assert_array_equal(_np(got[0]), np.asarray(want[0]))
    np.testing.assert_array_equal(_np(got[1], True), np.asarray(want[1]))


def test_deliveries_on_fma_rounded_finish_times():
    """40 models, effective times exactly at ``fma(r, T_L, t0)`` for ranks
    whose plain rounding is one ulp higher: whether rank ``r`` delivers
    depends on ``t0 + r T_L`` being one FMA, as in the reference."""
    m_count, n = 40, 64
    t0, T_L = np.float32(0.1), np.float32(0.002)
    r = np.arange(1, m_count + 1, dtype=np.float32)
    fma = (r.astype(np.float64) * T_L + t0).astype(np.float32)
    ranks = np.flatnonzero(t0 + r * T_L > fma)
    assert len(ranks) > 0
    kw = _delivery_inputs(5, m_count, n=n)
    kw["snap_has"][:] = True
    kw["ending"][:] = True
    kw["eff_time"] = fma[np.random.default_rng(5).choice(ranks, n)]
    want = jax.jit(rc.compute_deliveries)(**kw, t0=t0, T_L=T_L)
    got = tc.compute_deliveries(**{k: _t(v) for k, v in kw.items()},
                                t0=float(t0), T_L=float(T_L))
    np.testing.assert_array_equal(_np(got[0]), np.asarray(want[0]))


@pytest.mark.parametrize("m_count", [1, 3, 40])
@pytest.mark.parametrize("t0,T_L", [(0.1, 0.002), (0.37, 0.0031)])
def test_form_connections(t0, T_L, m_count):
    rng, _, _, partner = _geometry(4)
    n = len(partner)
    idle = np.flatnonzero(partner < 0)
    rng.shuffle(idle)
    match = np.full(n, -1, np.int32)
    k = len(idle) // 2 * 2
    match[idle[:k:2]], match[idle[1:k:2]] = idle[1:k:2], idle[:k:2]
    kw = dict(
        partner=partner, match=match,
        has_model=rng.random((n, m_count)) < 0.6,
        inc=rng.integers(0, 2**32, (n, m_count, 2), dtype=np.uint32),
        snap=rng.integers(0, 2**32, (n, m_count, 2), dtype=np.uint32),
        snap_has=rng.random((n, m_count)) < 0.5,
        exch_elapsed=rng.random(n).astype(np.float32),
        exch_total=rng.random(n).astype(np.float32),
        order_seed=rng.integers(0, 2**32, n, dtype=np.uint32),
    )
    slot = 6133
    want = jax.jit(rc.form_connections)(
        **kw, slot_idx=jnp.int32(slot), t0=jnp.float32(t0),
        T_L=jnp.float32(T_L))
    got = tc.form_connections(**{k_: _t(v) for k_, v in kw.items()},
                              slot_idx=slot, t0=t0, T_L=T_L)
    for k_, w in want.items():
        w = np.asarray(w)
        np.testing.assert_array_equal(_np(got[k_], w.dtype == np.uint32), w,
                                      err_msg=k_)


def test_t0_plus_n_tl_is_contracted():
    """Jitted XLA rounds ``t0 + n * T_L`` as one FMA (the plain form
    differs on about a fifth of these counts); the port writes the FMA."""
    n = np.arange(200, dtype=np.int32)
    t0, T_L = np.float32(0.1), np.float32(0.002)
    xla = np.asarray(jax.jit(lambda n: t0 + n.astype(jnp.float32) * T_L)(n))
    from repro_torch.numerics import fma32
    port = fma32(torch.from_numpy(n).float(), float(T_L), float(t0)).numpy()
    np.testing.assert_array_equal(port, xla)
    assert np.any(t0 + n.astype(np.float32) * T_L != xla)
