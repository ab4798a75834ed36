"""The port's cell-list backend (``repro_torch.sim.cells`` and the engine's
cells branch) against ``repro``.

1. ``make_grid`` and ``contact_backend`` equal ``repro``'s on a grid of
   configurations, and ``simulate`` runs every configuration on the
   backend ``repro`` picks.
2. ``bin_nodes``, ``neighbor_lists`` (against both of ``repro``'s branches:
   the node-centric gather and the Pallas kernel in interpret mode) and
   ``candidate_best`` are bit for bit ``repro``'s, with nodes on cell
   edges, multi-bit zone words, lattice ties, and both kinds of overflow
   with equal overflow counts.
3. A replayed cells run at N = 1024 (the paper's density) equals
   ``repro.simulate`` on every trace and on ``nbr_overflow``.
4. In the port, cells runs equal dense runs bit for bit (N = 256, 800, and
   with learning), and ``overflow_mode`` warns or raises.

Inputs are made with numpy from a seed and cross as numpy arrays.
"""

import dataclasses
import math
import warnings
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.sim.compute as rcompute
import repro.sim.observations as robs
from repro.configs.fg_paper import paper_params as r_paper_params
from repro.sim import SimConfig as RCfg
from repro.sim import simulate as r_simulate
from repro.sim import cells as rcells
from repro.sim.mobility import get_mobility as rget
from repro.sim.state import init_sim_state as r_init_state
from repro_torch.configs.fg_learn import logreg_task
from repro_torch.configs.fg_paper import DENSITY, paper_params
from repro_torch.kernels.contacts import zone_words
from repro_torch.sim import SimConfig, cells, simulate
from repro_torch.sim.engine import _check_supported, check_overflow
from repro_torch.sim.mobility import get_mobility
from repro_torch.sim.state import init_sim_state, state_to_numpy
from repro_torch import random as tr

TRACES = ("t", "availability", "busy_frac", "stored_info", "obs_birth",
          "obs_holders", "model_holders", "n_in_rz", "availability_z",
          "stored_info_z", "n_in_rz_z", "nbr_overflow")


@pytest.fixture(autouse=True)
def one_torch_thread():
    """The suite runs several test processes on the machine's cores; torch's
    intra-op threads in each would contend for them (the results do not
    depend on the thread count at these sizes)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture
def working_barrier():
    """``repro.sim.compute.shared_barrier`` fails on this jax (TypeError in
    its vmap-rule registration); the barrier is the identity, so the
    reference runs the barrier it wraps while a test needs it."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(rcompute, "shared_barrier", jax.lax.optimization_barrier)
        mp.setattr(robs, "shared_barrier", jax.lax.optimization_barrier)
        yield


def _both(**kw):
    return SimConfig(**kw), RCfg(**kw)


# ------------------------------------------------------- grid and backend

GRID_CASES = [
    dict(n_nodes=200),
    dict(n_nodes=1023, area_side=452.0, rz_radius=226.0),
    dict(n_nodes=1024, area_side=math.sqrt(1024 / DENSITY)),
    dict(n_nodes=1024, area_side=20.0, rz_radius=10.0),   # 3 x 3 cells
    dict(n_nodes=1024, area_side=20.0, r_tx=1.0),
    dict(n_nodes=4096, area_side=10.0, r_tx=5.0),
    dict(n_nodes=4096, area_side=127.0, r_tx=7.3),
    dict(n_nodes=12800, area_side=1600.0, rz_radius=800.0),
    dict(n_nodes=500, area_side=200.0, r_tx=5.0, contact_backend="cells"),
    dict(n_nodes=4096, contact_backend="dense"),
    dict(n_nodes=300, cell_cap=2, nbr_cap=3, contact_backend="cells"),
    dict(n_nodes=25600, area_side=math.sqrt(25600 / DENSITY)),
]


@pytest.mark.parametrize("kw", GRID_CASES)
def test_grid_and_backend_equal_repro(kw):
    port, ref = _both(**kw)
    assert cells.contact_backend(port) == rcells.contact_backend(ref)
    assert dataclasses.asdict(cells.make_grid(port)) == \
        dataclasses.asdict(rcells.make_grid(ref))
    assert cells.make_grid(port).n_pad_cells == \
        rcells.make_grid(ref).n_pad_cells


def test_city_scale_grid():
    """The N = 12800 point: 319 x 319 cells, cap 9, lists of 13."""
    grid = cells.make_grid(SimConfig(n_nodes=12800, area_side=1600.0))
    assert (grid.ncx, grid.ncy, grid.cap_cell, grid.nbr_cap) == \
        (319, 319, 9, 13)


def test_unknown_backend_raises():
    with pytest.raises(ValueError, match="contact_backend"):
        cells.contact_backend(SimConfig(contact_backend="octree"))
    with pytest.raises(ValueError, match="contact_backend"):
        simulate(paper_params(), SimConfig(contact_backend="octree"),
                 device="cpu")


def test_simulate_runs_on_the_backend_repro_picks():
    """N = 1024 in a 20 m square gives 3 x 3 cells: ``repro`` stays dense
    there, and so does the port (it used to raise NotImplementedError for
    any N >= 1024 under ``auto``)."""
    kw = dict(n_nodes=1024, area_side=20.0, rz_radius=10.0, n_slots=8,
              sample_every=8)
    port, ref = _both(**kw)
    assert rcells.contact_backend(ref) == "dense"
    _check_supported(paper_params(), port)
    out = simulate(paper_params(lam=0.2), port, seed=0, device="cpu")
    assert out.nbr_overflow is None
    assert out.availability.shape == (1, 1)


# ------------------------------------------------------------ the stages

def _zw(member: np.ndarray) -> np.ndarray:
    return np.asarray(rcompute.pack_mask(jnp.asarray(member)))[:, 0]


def _t(a: np.ndarray) -> torch.Tensor:
    a = np.array(a)
    if a.dtype == np.uint32:
        a = a.view(np.int32)
    return torch.from_numpy(a)[None]


def _edge_positions(cfg, seed=0) -> np.ndarray:
    """Nodes on vertical and horizontal grid lines and corners (float32
    multiples of the cell, one ulp either side, the area's edges), with
    partners just across the lines within the radius."""
    grid = rcells.make_grid(cfg)
    c = np.float32(grid.cell)
    rng = np.random.default_rng(seed)
    side = cfg.area_side
    pts = []
    for k in range(cfg.n_nodes // 4):
        line = np.float32((k % (grid.ncx - 1)) + 1) * c
        pts.append((line, rng.uniform(0, side)))
        pts.append((rng.uniform(0, side), np.nextafter(line, np.float32(0))))
        pts.append((np.nextafter(line, np.float32(side)), line))
        pts.append((line + rng.uniform(-4, 4), line + rng.uniform(-4, 4)))
    pts[0], pts[1] = (0.0, 0.0), (side, side)
    return np.clip(np.asarray(pts, np.float32), 0, np.float32(side))


def _random_positions(n, side, seed, spread=1.0):
    rng = np.random.default_rng(seed)
    return rng.uniform(0, side * spread, (n, 2)).astype(np.float32)


BIN_CASES = {
    "random": (dict(n_nodes=150, area_side=200.0), 1.0),
    "clustered-overflow": (dict(n_nodes=200, area_side=200.0, cell_cap=2,
                                nbr_cap=2), 0.15),
    "paper-1024": (dict(n_nodes=1024, area_side=math.sqrt(1024 / DENSITY)),
                   1.0),
}


@pytest.mark.parametrize("case", sorted(BIN_CASES))
def test_bin_nodes_equals_repro(case):
    kw, spread = BIN_CASES[case]
    port, ref = _both(**kw)
    pos = _random_positions(port.n_nodes, port.area_side, 7, spread)
    _check_bins(pos, port, ref)


def test_bin_nodes_on_cell_edges_equals_repro():
    port, ref = _both(n_nodes=64, area_side=200.0, cell_cap=64, nbr_cap=64)
    _check_bins(_edge_positions(ref), port, ref)


def test_cell_index_is_floor_divide():
    """At the N = 12800 grid (cell = 1600/319) ``repro``'s jitted
    ``(x // cell).astype(int32)`` is ``torch.floor_divide`` on every
    position on or within 1e-4 of a cell edge; ``floor(x / cell)`` is
    not."""
    cell = np.float32(1600.0 / 319)
    rng = np.random.default_rng(11)
    edges = np.arange(320, dtype=np.float32) * cell
    near = (edges[rng.integers(0, 320, 200_000)]
            + rng.uniform(-1e-4, 1e-4, 200_000)).astype(np.float32)
    x = np.clip(np.concatenate([edges, near]), 0, 1600).astype(np.float32)
    want = np.asarray(jax.jit(lambda v, c: (v // c).astype(jnp.int32))(
        x, cell))
    got = cells.bin_nodes(_t(np.stack([x, x], -1)), cells.make_grid(
        SimConfig(n_nodes=12800, area_side=1600.0)))[1][0].numpy()
    grid = rcells.make_grid(RCfg(n_nodes=12800, area_side=1600.0))
    np.testing.assert_array_equal(
        got, (np.clip(want, 0, 318) + 1) * (grid.ncy + 2)
        + np.clip(want, 0, 318) + 1)
    xt = torch.from_numpy(x)
    np.testing.assert_array_equal(
        torch.floor_divide(xt, torch.tensor(cell)).to(torch.int32).numpy(),
        want)
    assert np.any(torch.floor(xt / torch.tensor(cell)).to(torch.int32)
                  .numpy() != want)


def _check_bins(pos, port, ref):
    want = rcells.bin_nodes(jnp.asarray(pos), rcells.make_grid(ref))
    got = cells.bin_nodes(_t(pos), cells.make_grid(port))
    for g, w, name in zip(got, want, ("cellbuf", "pcid", "binned",
                                      "bin_overflow")):
        g = g[0].numpy()
        np.testing.assert_array_equal(g, np.asarray(w), err_msg=name)


def _lists(pos, member, port, ref, *, kernel_branch):
    r_tx2 = float(np.float32(ref.r_tx ** 2))
    zw = _zw(member)
    want = rcells.neighbor_lists(jnp.asarray(pos), jnp.asarray(zw),
                                 rcells.make_grid(ref), r_tx2,
                                 use_kernel=kernel_branch,
                                 interpret=kernel_branch)
    got = cells.neighbor_lists(_t(pos), _t(zw), cells.make_grid(port), r_tx2)
    np.testing.assert_array_equal(got[0][0].numpy(), np.asarray(want[0]))
    assert int(got[1][0]) == int(want[1])
    return got[0][0].numpy(), int(got[1][0])


LIST_CASES = {
    # name: (config, position spread, zones, repro's kernel branch too)
    "random": (dict(n_nodes=150, area_side=200.0), 1.0, 1, False),
    "multizone": (dict(n_nodes=120, area_side=200.0), 1.0, 3, False),
    "small-grid": (dict(n_nodes=120, area_side=40.0), 1.0, 2, True),
    "overflow": (dict(n_nodes=200, area_side=40.0, cell_cap=2, nbr_cap=2),
                 0.5, 1, True),
    "list-overflow": (dict(n_nodes=150, area_side=40.0, nbr_cap=3), 0.6, 1,
                      True),
    "paper-1024": (dict(n_nodes=1024, area_side=math.sqrt(1024 / DENSITY)),
                   1.0, 1, False),
}


@pytest.mark.parametrize("case", sorted(LIST_CASES))
def test_neighbor_lists_equal_repro(case):
    kw, spread, k_zones, kernel_too = LIST_CASES[case]
    port, ref = _both(**kw)
    rng = np.random.default_rng(len(case))
    pos = _random_positions(port.n_nodes, port.area_side, len(case), spread)
    member = rng.random((port.n_nodes, k_zones)) < 0.7
    nbr, ovf = _lists(pos, member, port, ref, kernel_branch=False)
    if kernel_too:
        _lists(pos, member, port, ref, kernel_branch=True)
    assert (nbr >= 0).any()
    assert (ovf > 0) == ("overflow" in case)


def test_neighbor_lists_on_cell_edges_equal_repro():
    port, ref = _both(n_nodes=64, area_side=200.0, cell_cap=64, nbr_cap=64)
    pos = _edge_positions(ref, seed=3)
    member = np.ones((64, 1), bool)
    nbr, ovf = _lists(pos, member, port, ref, kernel_branch=False)
    assert ovf == 0 and (nbr >= 0).sum() > 16


@pytest.mark.parametrize("case", ["random", "overflow"])
def test_batched_stages_equal_items(case):
    """Two runs stacked on the leading B axis give each run's own result
    in every stage, overflow counts included; the planes handed to the
    cell pass meet its kernel's contract (contiguous) at B = 2 too."""
    kw, spread, k_zones, _ = LIST_CASES[case]
    port = SimConfig(**kw)
    grid = cells.make_grid(port)
    r_tx2 = float(np.float32(port.r_tx ** 2))
    rng = np.random.default_rng(21)
    items = []
    for seed in (1, 2):
        pos = _random_positions(port.n_nodes, port.area_side, seed, spread)
        items.append((_t(pos), _t(_zw(rng.random((port.n_nodes, k_zones))
                                      < 0.7))))
    pos, zw = (torch.cat(t) for t in zip(*items))
    nbr, ovf = cells.neighbor_lists(pos, zw, grid, r_tx2)
    binned = cells.bin_nodes(pos, grid)
    prev = torch.flip(nbr, [0])                   # the other run's lists
    elig = torch.from_numpy(rng.random((2, port.n_nodes)) < 0.7)
    best = cells.candidate_best(pos, nbr, prev, elig)
    for b, (p1, z1) in enumerate(items):
        n1, o1 = cells.neighbor_lists(p1, z1, grid, r_tx2)
        assert torch.equal(nbr[b], n1[0]) and int(ovf[b]) == int(o1[0])
        for got, want in zip(binned, cells.bin_nodes(p1, grid)):
            assert torch.equal(got[b], want[0])
        for got, want in zip(best, cells.candidate_best(
                p1, n1, prev[b:b + 1], elig[b:b + 1])):
            assert torch.equal(got[b], want[0])
    assert (int(ovf.min()) > 0) == (case == "overflow")


def _prev_lists(nbr: np.ndarray, rng, nbr_cap: int) -> np.ndarray:
    """Previous-slot lists: a random symmetric subset of this slot's."""
    n = nbr.shape[0]
    prev = np.zeros((n, n), bool)
    rows, cols = np.nonzero(nbr >= 0)
    prev[rows, nbr[rows, cols]] = rng.random(len(rows)) < 0.4
    prev &= prev.T
    key = np.where(prev, np.arange(n), n)
    key = np.sort(key, axis=1)[:, :nbr_cap]
    return np.where(key < n, key, -1).astype(np.int32)


@pytest.mark.parametrize("layout,seed", [("clustered", 0), ("clustered", 1),
                                         ("lattice", 2)])
def test_candidate_best_equals_repro(layout, seed):
    """Clustered nodes compete for partners; on a 1 m lattice many d² tie
    exactly and the lowest id must win."""
    n = 150
    port, ref = _both(n_nodes=n, area_side=200.0, nbr_cap=24)
    rng = np.random.default_rng(seed)
    if layout == "lattice":
        pos = rng.integers(0, 12, (n, 2)).astype(np.float32)
    else:
        pos = _random_positions(n, 60.0, seed)
    member = np.ones((n, 1), bool)
    nbr, _ = _lists(pos, member, port, ref, kernel_branch=False)
    prev = _prev_lists(nbr, rng, 24)
    elig = rng.random(n) < 0.7
    want = jax.jit(rcells.candidate_best)(pos, nbr, prev, elig)
    got = cells.candidate_best(_t(pos), _t(nbr), _t(prev), _t(elig))
    np.testing.assert_array_equal(got[0][0].numpy(), np.asarray(want[0]))
    np.testing.assert_array_equal(got[1][0].numpy(), np.asarray(want[1]))
    assert got[1].sum() > 10


def _first_argmin_of_bits(d2: np.ndarray, nbr: np.ndarray) -> np.ndarray:
    bits = d2.astype(np.float32).view(np.int32)
    return nbr[np.arange(len(nbr)), np.argmin(bits, axis=1)]


def test_candidate_best_scores_as_one_fma():
    """Rows with two candidates at mirrored offsets ``(a, b)`` and ``(b, a)``:
    the plain sum ties them, while ``fma(dx, dx, dy*dy)`` and the reversed
    FMA order them, oppositely. The port's winners equal ``repro``'s, and
    on this data both other roundings pick another winner on some rows."""
    rng = np.random.default_rng(5)
    rows, k = 2000, 13
    ab = rng.uniform(0.5, 3.0, (rows, 2)).astype(np.float32)
    pos = np.zeros((3 * rows, 2), np.float32)       # rows at the origin
    pos[rows::2] = -ab
    pos[rows + 1::2] = -ab[:, ::-1]
    nbr = np.full((3 * rows, k), -1, np.int32)
    nbr[:rows, 0] = rows + 2 * np.arange(rows)
    nbr[:rows, 1] = rows + 2 * np.arange(rows) + 1
    prev = np.full((3 * rows, 2), -1, np.int32)
    elig = np.ones(3 * rows, bool)
    want = np.asarray(jax.jit(rcells.candidate_best)(pos, nbr, prev, elig)[0])
    got = cells.candidate_best(_t(pos), _t(nbr), _t(prev), _t(elig))[0]
    np.testing.assert_array_equal(got[0].numpy(), want)

    nbr, want = nbr[:rows, :2], want[:rows]
    dx = pos[:rows, None, 0] - pos[nbr, 0]
    dy = pos[:rows, None, 1] - pos[nbr, 1]
    f64 = np.float64
    fma = dx.astype(f64) * dx + dy * dy
    np.testing.assert_array_equal(_first_argmin_of_bits(fma, nbr), want)
    for name, d2 in (("plain", dx * dx + dy * dy),
                     ("reversed", dy.astype(f64) * dy + dx * dx)):
        assert np.any(_first_argmin_of_bits(d2, nbr) != want), name


# ---------------------------------------------------------------- engine

@partial(jax.jit, static_argnames=("cfg",))
def _repro_track(key, cfg):
    """``(n_slots + 1, N, 2)`` rdm positions under the engine's schedule."""
    model = rget("rdm")
    mob, key = model.init(key, cfg)

    def step(carry, _):
        mob, key = carry
        key, k1, k2, _, _ = jax.random.split(key, 5)
        mob = model.step(k1, k2, mob, cfg)
        return (mob, key), mob.pos

    _, frames = jax.lax.scan(step, (mob, key), None, length=cfg.n_slots)
    return jnp.concatenate([mob.pos[None], frames])


def _scaled(n_total, n_slots, lam, **kw):
    """``benchmarks/fig_convergence.py::scaled_point`` for both packages."""
    area = math.sqrt(n_total / DENSITY)
    r_rz = area / 2.0
    geom = dict(n_nodes=n_total, area_side=area, rz_radius=r_rz,
                n_slots=n_slots, sample_every=16, **kw)
    pk = dict(N=DENSITY * math.pi * r_rz ** 2, alpha=2.0 * DENSITY * r_rz)
    return (paper_params(lam=lam, M=1).replace(**pk), SimConfig(**geom),
            r_paper_params(lam=lam, M=1).replace(**pk), RCfg(**geom))


def _same(a, b, fields=TRACES):
    for f in fields:
        x, y = getattr(a, f), getattr(b, f)
        assert (x is None) == (y is None), f
        if x is not None:
            assert x.dtype == y.dtype and x.shape == y.shape, f
            np.testing.assert_array_equal(x, y, err_msg=f)


def test_replayed_cells_run_equals_repro_bitwise(working_barrier):
    p, cfg, rp, rcfg = _scaled(1024, 192, lam=0.2)
    assert rcells.contact_backend(rcfg) == "cells"
    ref = r_simulate(rp, rcfg, seed=4)
    track = np.asarray(_repro_track(jax.random.PRNGKey(4), rcfg))
    out = simulate(p, dataclasses.replace(cfg, mobility="replay"), seed=4,
                   device="cpu", positions=track)
    _same(out, ref)
    assert out.nbr_overflow.shape == (192 // 16,)
    assert out.busy_frac.max() > 0             # contacts really formed


def test_initial_cells_state_equals_repro():
    n = 1024
    kw = dict(n_nodes=n, area_side=math.sqrt(n / DENSITY))
    port, ref = _both(**kw)
    mob, _ = rget("rdm").init(jax.random.PRNGKey(1), ref)
    zone0 = jnp.linalg.norm(mob.pos - ref.area_side / 2, axis=-1) \
        <= ref.rz_radius
    want = r_init_state(mob, zone0, M=1, cfg=ref).prev_close
    tmob, _ = get_mobility("rdm").init(tr.PRNGKey(1)[None], port)
    zw = zone_words(torch.ones((1, n, 1), dtype=torch.bool))
    state = init_sim_state(tmob, zw, M=1, cfg=port)
    back = state_to_numpy(state, port)["prev_close"]
    assert back.dtype == np.asarray(want).dtype == np.int32
    np.testing.assert_array_equal(back, np.asarray(want))
    dense = dataclasses.replace(port, contact_backend="dense")
    state = init_sim_state(tmob, zw, M=1, cfg=dense)
    assert state_to_numpy(state, dense)["prev_close"].dtype == np.uint32


@pytest.mark.parametrize("n_total,n_slots", [(256, 320), (800, 160)])
def test_cells_equals_dense_in_the_port(n_total, n_slots):
    p, cfg, _, _ = _scaled(n_total, n_slots, lam=0.2,
                           contact_backend="dense")
    dense = simulate(p, cfg, seed=2, device="cpu")
    cell = simulate(p, dataclasses.replace(cfg, contact_backend="cells"),
                    seed=2, device="cpu")
    _same(dense, cell, TRACES[:-1])
    assert dense.nbr_overflow is None
    assert int(cell.nbr_overflow.max()) == 0
    assert dense.busy_frac.max() > 0


def test_learning_rides_the_cells_backend():
    """Learning does not touch the contact stage: a learning run on cells
    equals the same run on dense, learning traces included."""
    cfg = SimConfig(n_nodes=120, area_side=60.0, rz_radius=30.0,
                    n_slots=64, learn=logreg_task(), contact_backend="dense")
    p = paper_params(lam=0.2, Lam=10.0, M=1, T_T=5.0)
    dense = simulate(p, cfg, seed=1, device="cpu")
    cell = simulate(p, dataclasses.replace(cfg, contact_backend="cells"),
                    seed=1, device="cpu")
    _same(dense, cell, TRACES[:-1] + ("test_acc", "test_acc_holders",
                                      "learn_obs", "theta_var",
                                      "merge_stats"))
    assert dense.merge_stats[-1].sum() > 0


# -------------------------------------------------------------- overflow

def test_check_overflow_warn_vs_strict():
    cfg = SimConfig(overflow_mode="warn")
    with warnings.catch_warnings(record=True) as rec:
        warnings.simplefilter("always")
        assert check_overflow(cfg, 7, context="unit") == 7
    assert any(isinstance(w.message, cells.NeighborOverflowWarning)
               and "7" in str(w.message) for w in rec)
    with pytest.raises(RuntimeError, match="unit"):
        check_overflow(dataclasses.replace(cfg, overflow_mode="strict"), 7,
                       context="unit")
    with warnings.catch_warnings(record=True) as rec:
        warnings.simplefilter("always")
        assert check_overflow(cfg, 0) == 0
        assert check_overflow(
            dataclasses.replace(cfg, overflow_mode="strict"), 0) == 0
        assert check_overflow(cfg, None) == 0
    assert not rec


def test_simulate_surfaces_overflow():
    """An undersized neighbour cap degrades loudly: a warning with the
    running max in the trace, or a RuntimeError under ``"strict"``."""
    cfg = SimConfig(n_nodes=256, n_slots=24, sample_every=8,
                    contact_backend="cells", nbr_cap=1)
    p = paper_params(lam=0.05, M=1)
    with warnings.catch_warnings(record=True) as rec:
        warnings.simplefilter("always")
        out = simulate(p, cfg, seed=0, device="cpu")
    assert int(np.max(out.nbr_overflow)) > 0
    assert np.all(np.diff(out.nbr_overflow) >= 0)        # a running max
    assert any(isinstance(w.message, cells.NeighborOverflowWarning)
               for w in rec)
    with pytest.raises(RuntimeError, match="dropped close pairs"):
        simulate(p, dataclasses.replace(cfg, overflow_mode="strict"),
                 seed=0, device="cpu")


def test_adequate_caps_no_overflow_no_warning():
    cfg = SimConfig(n_nodes=256, n_slots=24, sample_every=8,
                    contact_backend="cells")
    with warnings.catch_warnings(record=True) as rec:
        warnings.simplefilter("always")
        out = simulate(paper_params(lam=0.05, M=1), cfg, seed=0,
                       device="cpu")
    assert int(np.max(out.nbr_overflow)) == 0
    assert not any(isinstance(w.message, cells.NeighborOverflowWarning)
                   for w in rec)


def test_bad_overflow_mode_rejected_at_construction():
    with pytest.raises(ValueError, match="overflow_mode"):
        SimConfig(overflow_mode="bogus")
