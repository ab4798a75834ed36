"""``repro_torch.sim.observations`` against jitted
``repro.sim.observations`` at N = 64 and N = 600 (either side of the
observer-rank switch at ``RANK_DENSE_MAX_N = 512``): generation with the
same keys, completions and per-sample outputs bit for bit; the o(τ)
histograms to float32 summation order."""

import jax
import numpy as np
import pytest
import torch

import repro.sim.compute as rcompute
import repro.sim.observations as ro
from repro_torch.sim import observations as to

K_OBS = 64


@pytest.fixture(autouse=True)
def working_barrier(monkeypatch):
    """The seed's ``shared_barrier`` fails on this jax (TypeError in its
    vmap-rule registration); the barrier is the identity, so each test
    runs the barrier it wraps."""
    monkeypatch.setattr(rcompute, "shared_barrier",
                        jax.lax.optimization_barrier)
    monkeypatch.setattr(ro, "shared_barrier", jax.lax.optimization_barrier)


def _t(a):
    a = np.array(a)
    if a.dtype == np.uint32:
        a = a.view(np.int32)
    return torch.from_numpy(a)[None]


def _np(t, words=False):
    a = t[0].numpy()
    return a.view(np.uint32) if words else a


def _state(seed, n, m_count):
    rng = np.random.default_rng(seed)
    birth = np.where(rng.random((m_count, K_OBS)) < 0.7,
                     rng.uniform(0, 500, (m_count, K_OBS)), -np.inf)
    return rng, dict(
        obs_birth=birth.astype(np.float32),
        obs_head=rng.integers(0, K_OBS, m_count).astype(np.int32),
        inc=rng.integers(0, 2**32, (n, m_count, 2), dtype=np.uint32),
        in_rz=rng.random(n) < 0.8,
    )


@pytest.mark.parametrize("m_count", [1, 3])
@pytest.mark.parametrize("n", [64, 600])
@pytest.mark.parametrize("seed", range(2))
def test_generate_observations(seed, n, m_count):
    rng, s = _state(seed, n, m_count)
    keys = jax.random.split(jax.random.PRNGKey(seed), 2)
    # lam * dt = 0.5: about half the models draw an observation
    kw = dict(lam=2.0, Lam=3.0, dt=0.25, t_now=501.25)
    want = jax.jit(lambda k1, k2, s: ro.generate_observations(
        k_obs=k1, k_who=k2, **s, **kw))(keys[0], keys[1], s)
    kt = torch.from_numpy(np.asarray(keys).astype(np.int64))
    got = to.generate_observations(
        k_obs=kt[:1], k_who=kt[1:], **{k: _t(v) for k, v in s.items()}, **kw)
    for g, w, name in zip(got, want, ("obs_birth", "obs_head", "inc",
                                      "want_train", "slot_payload")):
        w = np.asarray(w)
        np.testing.assert_array_equal(_np(g, w.dtype == np.uint32), w,
                                      err_msg=name)


@pytest.mark.parametrize("n", [64, 600])
def test_observer_ranks_on_both_sides_of_the_switch(n):
    rng = np.random.default_rng(n)
    scores = rng.random((2, n)).astype(np.float32)
    scores[:, ::7] = scores[:, 1:2]                       # ties
    want = jax.jit(ro._observer_ranks)(scores)
    got = to._observer_ranks(torch.from_numpy(scores))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("m_count", [1, 3])
@pytest.mark.parametrize("n", [64, 600])
def test_apply_completions_and_slot_outputs(n, m_count):
    rng, s = _state(7, n, m_count)
    kw = dict(
        fin_merge=rng.random(n) < 0.3, fin_train=rng.random(n) < 0.3,
        serv_model=rng.integers(0, m_count, n).astype(np.int32),
        serv_mask=rng.integers(0, 2**32, (n, 2), dtype=np.uint32),
        serv_slot=rng.integers(0, K_OBS, n).astype(np.int32),
        inc=s["inc"], has_model=rng.random((n, m_count)) < 0.5,
        obs_birth=s["obs_birth"],
    )
    want = jax.jit(lambda kw: ro.apply_completions(**kw))(kw)
    got = to.apply_completions(**{k: _t(v) for k, v in kw.items()})
    np.testing.assert_array_equal(_np(got[0], True), np.asarray(want[0]))
    np.testing.assert_array_equal(_np(got[1]), np.asarray(want[1]))

    zone = rng.random(n) < 0.8
    out_kw = dict(inc=np.asarray(want[0]), has_model=np.asarray(want[1]),
                  obs_birth=s["obs_birth"], in_rz=zone,
                  partner=rng.integers(-1, n, n).astype(np.int32))
    ref = jax.jit(lambda kw: ro.slot_outputs(
        **kw, member=kw["in_rz"][:, None], t_now=np.float32(501.25),
        tau_l=np.float32(300.0)))(out_kw)
    tk = {k: _t(v) for k, v in out_kw.items()}
    out = to.slot_outputs(**tk, member=tk["in_rz"][..., None], t_now=501.25,
                          tau_l=300.0)
    assert set(out) == set(ref)
    for k, w in ref.items():
        w = np.asarray(w)
        assert out[k].dtype == _t(w).dtype, k
        np.testing.assert_array_equal(_np(out[k]), w, err_msg=k)


def test_o_tau_estimate_matches_repro():
    """Same histogram bins and counts; the holder-fraction sums differ only
    by float32 summation order (relative 1e-5 on sums of <= 1e4 terms)."""
    rng = np.random.default_rng(0)
    s, m, k = 300, 2, K_OBS
    t = np.arange(1, s + 1) * 2.0
    birth = np.where(rng.random((s, m, k)) < 0.8,
                     t[:, None, None] - rng.uniform(0, 400, (s, m, k)),
                     -np.inf).astype(np.float32)
    holders = rng.integers(1, 150, (s, m))

    class Out:
        pass

    out = Out()
    out.t, out.obs_birth, out.model_holders = t, birth, holders
    out.obs_holders = np.minimum(rng.integers(0, 150, (s, m, k)),
                                 holders[..., None])
    grid = np.linspace(0.0, 300.0, 61)
    want = ro.estimate_o_of_tau(out, grid)
    got = to.estimate_o_of_tau(out, grid)
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=0)
