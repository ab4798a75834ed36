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


# ------------------------------------------------- the kernel's launch and order

@pytest.mark.parametrize("lo,hi", [(1, 1024), (1025, 4096), (4097, 12000),
                                   (12001, 16384), (16385, 25600)])
def test_contact_geometry_limits(lo, hi):
    """Every N from 1 to 25600: what the kernel receives, 4 rows a block,
    the chunk and its shared bytes, stays within what the kernel and an
    H100 block take."""
    for n in range(lo, hi + 1):
        g = tk.contact_geometry(n)
        assert g.rows == tk.ROWS == 4                # 128 threads
        assert g.smem % 16 == 0
        assert tk.STAGE_BYTES * g.chunk <= g.smem <= 227 * 1024
        if n <= tk.MAX_CHUNK:
            assert g.chunk == n
        else:
            assert g.chunk == tk.MAX_CHUNK and g.chunk % 32 == 0


def test_contact_geometry_at_the_paths_shapes():
    """The wrapper's rows are the kernel's, and the path's shapes stage
    every column at once."""
    src = tk.SOURCE.read_text()
    assert f"constexpr int kRows = {tk.ROWS};" in src
    assert f"constexpr int kMaxChunk = {tk.MAX_CHUNK};" in src
    assert [tk.contact_geometry(n) for n in (200, 800)] == [
        (4, 200, 2608), (4, 800, 10400)]
    with pytest.raises(ValueError):
        tk.contact_geometry(0)


def test_contact_geometry_chunks_only_beyond_one_block():
    """All columns stay in one chunk up to 16384 (13 B a node); one more
    column takes a second pass, and the paper's largest N two."""
    assert tk.contact_geometry(16384) == (4, 16384, 13 * 16384)
    assert tk.contact_geometry(16385).chunk == 16384
    assert -(-25600 // tk.contact_geometry(25600).chunk) == 2
    assert tk.contact_geometry(tk.MAX_CHUNK).smem <= 227 * 1024


_INT_MAX = 2**31 - 1


def lane_argmin(d2, closew, prevw, elig, chunk=None, ties_by_j=True):
    """The kernel's order, written out in torch: each lane ``l`` visits its
    columns ``j = c0 + (32 s + w) * 32 + l`` chunk by chunk, segment by
    segment, word by word, keeping its first minimum (strict ``<``); then a
    butterfly of shuffles (xor 16, 8, 4, 2, 1) merges the lanes by (d², j),
    the smaller j on equal d² (``ties_by_j=False``: each lane keeps its own
    on equal d², a faulty merge). Returns ``(best_j, has)``."""
    from repro_torch.sim.compute import unpack_mask

    b, n, _ = d2.shape
    chunk = chunk or tk.contact_geometry(n).chunk
    cand = (unpack_mask(closew & ~prevw, n) & elig[..., :, None]
            & elig[..., None, :])
    lanes = torch.arange(32)
    best_d = torch.full((b, n, 32), float("inf"))
    best = torch.full((b, n, 32), _INT_MAX, dtype=torch.int64)
    for c0 in range(0, n, chunk):
        cn = min(chunk, n - c0)
        for word in range((cn + 31) // 32):          # word = 32 s + w
            j = c0 + word * 32 + lanes
            ok = j < c0 + cn
            jj = torch.where(ok, j, 0)
            d = d2[..., jj]
            c = cand[..., jj] & ok
            take = c & (d < best_d)
            best_d = torch.where(take, d, best_d)
            best = torch.where(take, j, best)
    for off in (16, 8, 4, 2, 1):
        od, oj = best_d[..., lanes ^ off], best[..., lanes ^ off]
        take = (od < best_d) | ((od == best_d) & (oj < best) & ties_by_j)
        best_d = torch.where(take, od, best_d)
        best = torch.where(take, oj, best)
    has = best[..., 0] != _INT_MAX
    return torch.where(has, best[..., 0], -1).to(torch.int32), has


def _lattice(b, n, side, seed):
    rng = np.random.default_rng(seed)
    xy = torch.from_numpy(rng.integers(0, side, (2, b, n)).astype(np.float32))
    zw = torch.ones((b, n), dtype=torch.int32)
    elig = torch.from_numpy(rng.random((b, n)) < 0.7)
    prev = torch.from_numpy(rng.random((b, n, n)) < 0.1)
    return xy[0], xy[1], zw, elig, pack_mask(prev & prev.transpose(1, 2))


@pytest.mark.parametrize("n,side,chunk", [
    (20, 6, None), (200, 12, None), (200, 12, 64), (1025, 32, None),
    (2100, 48, None), (2100, 48, 1024)])
def test_lane_order_and_merge_equal_the_first_minimum(n, side, chunk):
    """On integer-lattice positions most rows have several candidates at
    the same least d², in different lanes and words: the kernel's per-lane
    minima and (d², j) merge still give the first minimum, as
    ``candidate_best_ref`` does (chunks of 64 and 1024 taken as well)."""
    x, y, zw, elig, prevw = _lattice(2, n, side, seed=n + side)
    closew, d2 = tk.pairwise_close_ref(x, y, zw, 25.0)
    want = tk.candidate_best_ref(d2, closew, prevw, elig)
    got = lane_argmin(d2, closew, prevw, elig, chunk)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    # the plain version on these inputs, held to repro's jitted oracle and
    # its Pallas kernel: the tie rule has a witness outside the port
    if chunk is None:
        plain = tk.pairwise_contacts_ref(x, y, zw, elig, prevw, 25.0)
        for b in range(2):
            pos = np.stack([x[b].numpy(), y[b].numpy()], -1)
            member = np.ones(n, bool)
            pw = prevw[b].numpy().view(np.uint32)
            got_b = (plain[0][b].numpy().view(np.uint32), plain[1][b].numpy(),
                     plain[2][b].numpy())
            _assert_equal(got_b, _ref(pos, member, elig[b].numpy(), pw,
                                      r_tx2=25.0))
            _assert_equal(got_b, rk.pairwise_contacts(
                pos, member, elig[b].numpy(), pw, 25.0, interpret=True))
    # tie-heavy: many rows hold their least d² at more than one candidate
    from repro_torch.sim.compute import unpack_mask
    cand = (unpack_mask(closew & ~prevw, n) & elig[..., :, None]
            & elig[..., None, :])
    scores = torch.where(cand, d2, torch.full_like(d2, float("inf")))
    least = scores.min(-1, keepdim=True).values
    ties = ((scores == least) & cand).sum(-1) > 1
    assert ties.float().mean() > 0.2


def test_a_merge_that_breaks_ties_otherwise_fails_on_the_lattice():
    """Taking the larger j on equal d², or merging the lanes without the j
    rule, changes best_j on these inputs: the lattice cases can fail a
    kernel with the wrong tie rule."""
    x, y, zw, elig, prevw = _lattice(1, 200, 12, seed=7)
    closew, d2 = tk.pairwise_close_ref(x, y, zw, 25.0)
    want = tk.candidate_best_ref(d2, closew, prevw, elig)[0]
    from repro_torch.sim.compute import unpack_mask
    cand = (unpack_mask(closew & ~prevw, 200) & elig[..., :, None]
            & elig[..., None, :])
    scores = torch.where(cand, d2, torch.full_like(d2, float("inf")))
    last = 199 - scores.flip(-1).argmin(-1)             # larger j on ties
    assert not torch.equal(torch.where(want >= 0, last, -1).to(torch.int32),
                           want)
    faulty = lane_argmin(d2, closew, prevw, elig, ties_by_j=False)[0]
    assert not torch.equal(faulty, want)


def test_kernel_source_keeps_the_d2_order_and_the_tie_rule():
    """The CUDA source spells the reference's d² rounding and the merge by
    (d², j) that the emulation above holds to the first minimum."""
    src = tk.SOURCE.read_text()
    assert "__fmaf_rn(dx, dx, __fmul_rn(dy, dy))" in src
    assert "if (od < best_d2 || (od == best_d2 && oj < best))" in src
    assert "if (cand & (d2[u] < best_d2))" in src
