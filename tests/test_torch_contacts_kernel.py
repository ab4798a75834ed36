"""The plain version of the ``pairwise_contacts`` sweep in
``repro_torch.kernels.contacts`` against ``repro``'s jitted oracle
``pairwise_contacts_ref`` and its Pallas kernel in interpret mode, bit for
bit on every output (packed close words, first-minimum candidate, flag),
on the grid of ``tests/test_kernels.py``; plus multi-bit zone words, an
access mask, and a batch equal to its items. The CUDA kernel itself runs
on the card only, where ``chip_smoke.py`` holds it against this plain
version."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.sim.compute as rcompute
from repro.kernels import contacts as rk
from repro_torch.kernels import contacts as tk
from repro_torch.sim.compute import pack_mask


@pytest.fixture(autouse=True)
def working_barrier(monkeypatch):
    """``repro.sim.compute.shared_barrier`` registers a vmap rule by a
    membership test on jax's batcher table, which this jax no longer
    supports (TypeError); the barrier is the identity, so the tests run
    the barrier it wraps for the duration of each test."""
    monkeypatch.setattr(rcompute, "shared_barrier",
                        jax.lax.optimization_barrier)


def _case(n, density, *, side=60.0, k_zones=1, seed=None):
    rng = np.random.default_rng(n if seed is None else seed)
    pos = rng.uniform(0, side, (n, 2)).astype(np.float32)
    member = rng.random((n, k_zones)) < (0.8 if k_zones == 1 else 0.4)
    elig = rng.random(n) < 0.7
    prev = rng.random((n, n)) < density
    prev = prev & prev.T
    return pos, member, elig, prev


def _torch_args(pos, member, elig, prevw):
    p = torch.from_numpy(pos)
    zw = tk.zone_words(torch.from_numpy(member))
    return (p[None, :, 0].contiguous(), p[None, :, 1].contiguous(), zw[None],
            torch.from_numpy(elig)[None],
            torch.from_numpy(np.array(prevw).view(np.int32))[None])


def _port(pos, member, elig, prevw, r_tx2=25.0):
    closew, best, has = tk.pairwise_contacts(
        *_torch_args(pos, member, elig, prevw), r_tx2)
    return closew[0].numpy().view(np.uint32), best[0].numpy(), has[0].numpy()


def _assert_equal(got, want):
    for g, w, name in zip(got, want, ("closew", "best_j", "has")):
        np.testing.assert_array_equal(g, np.asarray(w), err_msg=name)


_ref = jax.jit(rk.pairwise_contacts_ref, static_argnames=("r_tx2",))


@pytest.mark.parametrize("n,blk_i", [
    (20, 32), (33, 128), (65, 32), (120, 64), (128, 128), (130, 128),
    (200, 128),
])
@pytest.mark.parametrize("density", [0.0, 0.3, 1.0])
def test_plain_matches_repro_oracle_and_pallas(n, blk_i, density):
    pos, member, elig, prev = _case(n, density)
    prevw = rcompute.pack_mask(jnp.asarray(prev))
    got = _port(pos, member, elig, prevw)
    _assert_equal(got, _ref(pos, member[:, 0], elig, prevw, r_tx2=25.0))
    _assert_equal(got, rk.pairwise_contacts(
        pos, member[:, 0], elig, prevw, 25.0, blk_i=blk_i, interpret=True))


@pytest.mark.parametrize("n,k_zones", [(20, 3), (65, 5), (130, 31),
                                       (200, 4)])
def test_multibit_zone_words(n, k_zones):
    pos, member, elig, prev = _case(n, 0.2, k_zones=k_zones,
                                    seed=1000 + n + k_zones)
    prevw = rcompute.pack_mask(jnp.asarray(prev))
    got = _port(pos, member, elig, prevw)
    _assert_equal(got, _ref(pos, member, elig, prevw, r_tx2=25.0))


def test_access_mask_rides_the_zone_words():
    n = 90
    pos, member, elig, prev = _case(n, 0.1, side=30.0)
    access = np.random.default_rng(9).random(n) < 0.6
    prevw = rcompute.pack_mask(jnp.asarray(prev))
    want = jax.jit(rk.pairwise_contacts_ref, static_argnames=("r_tx2",))(
        pos, member[:, 0], elig, prevw, r_tx2=25.0, access=access)
    x, y, zw, el, pw = _torch_args(pos, member, elig, prevw)
    zw = tk.apply_access(zw, torch.from_numpy(access)[None])
    closew, best, has = tk.pairwise_contacts(x, y, zw, el, pw, 25.0)
    _assert_equal((closew[0].numpy().view(np.uint32), best[0].numpy(),
                   has[0].numpy()), want)


def test_dense_cluster_edge_tile():
    """Everyone inside one radius (the edge-tile case of
    ``tests/test_kernels.py``): dense words, pad bits zero, real winners."""
    n = 130
    pos, member, elig, _ = _case(n, 0.0, side=4.0, seed=5)
    member[:] = True
    prevw = jnp.zeros((n, (n + 31) // 32), jnp.uint32)
    got = _port(pos, member, elig, prevw)
    _assert_equal(got, _ref(pos, member[:, 0], elig, prevw, r_tx2=25.0))
    assert not np.any(got[0][:, -1] >> (n % 32))
    assert np.all(got[1][got[2]] < n)


def threshold_offsets(count: int, seed: int = 0) -> np.ndarray:
    """``(count, 2)`` float32 offsets whose d² lands on the r_tx = 5
    threshold differently under ``fma(dx, dx, dy*dy)``, the plain
    ``dx*dx + dy*dy`` and the reversed ``fma(dy, dy, dx*dx)``: only the
    reference's rounding gives the reference's close bits."""
    rng = np.random.default_rng(seed)
    th = rng.uniform(0, 2 * np.pi, 200_000)
    dx = (5 * np.cos(th)).astype(np.float32)
    dy = (5 * np.sin(th)).astype(np.float32)
    fma = (dx.astype(np.float64) * dx + (dy * dy)).astype(np.float32)
    rev = (dy.astype(np.float64) * dy + (dx * dx)).astype(np.float32)
    inside = fma <= 25.0
    pick = (inside != (dx * dx + dy * dy <= 25.0)) & (inside != (rev <= 25.0))
    return np.stack([dx, dy], -1)[pick][:count]


def test_threshold_pairs_round_as_one_fma():
    """Row 0 at the origin, every other node at an offset whose close bit
    depends on how d² is rounded: the plain version matches the jitted
    reference (and the Pallas kernel) only with d² = fma(dx, dx, dy*dy)."""
    off = threshold_offsets(95)
    pos = np.concatenate([np.zeros((1, 2), np.float32), -off])
    n = len(pos)
    member = np.ones((n, 1), bool)
    elig = np.ones(n, bool)
    prevw = jnp.zeros((n, (n + 31) // 32), jnp.uint32)
    got = _port(pos, member, elig, prevw)
    want = _ref(pos, member[:, 0], elig, prevw, r_tx2=25.0)
    _assert_equal(got, want)
    _assert_equal(got, rk.pairwise_contacts(pos, member[:, 0], elig, prevw,
                                            25.0, interpret=True))
    row0 = np.unpackbits(got[0][0].view(np.uint8), bitorder="little")[:n]
    assert 0 < row0.sum() < n - 1          # both sides of the threshold


def test_batch_equals_items():
    items = [_case(65, d, seed=s) for s, d in ((1, 0.0), (2, 0.4))]
    args = [_torch_args(pos, m, e, pack_mask(torch.from_numpy(pv)).numpy())
            for pos, m, e, pv in items]
    stacked = tk.pairwise_contacts(
        *[torch.cat([a[i] for a in args]) for i in range(5)], 25.0)
    for b, a in enumerate(args):
        single = tk.pairwise_contacts(*a, 25.0)
        for s, g in zip(single, stacked):
            assert torch.equal(s[0], g[b])


def test_cpu_tensors_take_the_plain_version():
    before = tk.pairwise_contacts.launches
    pos, member, elig, prev = _case(40, 0.2)
    _port(pos, member, elig, rcompute.pack_mask(jnp.asarray(prev)))
    assert tk.pairwise_contacts.launches == before


def test_other_devices_raise():
    args = [t.to("meta") for t in _torch_args(
        *_case(40, 0.0)[:3], np.zeros((40, 2), np.uint32))]
    with pytest.raises(ValueError, match="unsupported device"):
        tk.pairwise_contacts(*args, 25.0)
