"""The port's sweep runner (``repro_torch.sim.sweep``) against ``repro``'s.

(a) ``plan_sweep`` equals ``repro``'s over (P, R, device count, chunk).
(b) With ``repro``'s rdm positions per seed replayed through the port, the
    port's trace sweep equals ``repro.sim.sweep.run`` bit for bit on every
    protocol trace, on a divisible grid and on a padded, chunked one.
(c) Every row of a free-running sweep equals the port's own ``simulate``
    of that (scenario, seed), on the dense and the cells backends and with
    learning; per-row Λ and T_L take effect.
(d) Each reduction equals ``repro``'s reduced sweep (on replayed
    positions) and numpy's reduction of the port's own trace: ``final``
    and ``o_tau_den`` bit for bit, ``mean``, ``std``, ``quantiles`` and
    ``o_tau_num`` within 1e-6 relative (float32 sums in another order).
(e) ``SweepSummary``'s keys, shapes and dtypes and ``host_bytes`` equal
    ``repro``'s; ``expected_shapes`` equals real chunk outputs.
(f) What the port does not run raises, and the dispatch queue's
    arguments are accepted (one worker equals the in-process sweep);
    ``simulate_batch`` is the trace sweep; ``scan_carry_bytes`` is
    ``repro``'s plus the key's 8 bytes.

``repro``'s sweep runs with ``jax.lax.optimization_barrier`` in place of
its ``shared_barrier`` (which fails under this JAX), patched inside each
test that runs it.
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
from repro.configs.fg_learn import logreg_task as r_logreg
from repro.configs.fg_paper import paper_params as r_paper_params
from repro.sim import SimConfig as RCfg
from repro.sim import plan_sweep as r_plan_sweep
from repro.sim import sweep as rsweep
from repro.sim.engine import scan_carry_bytes as r_scan_carry_bytes
from repro.sim.mobility import get_mobility as rget
from repro_torch.configs.fg_learn import logreg_task
from repro_torch.configs.fg_paper import paper_params
from repro_torch.core.zones import ZoneSet
from repro_torch.sim import (BatchSimOutputs, SimConfig, SweepPlan,
                             plan_sweep, simulate, simulate_batch, sweep)
from repro_torch.sim.engine import scan_carry_bytes

GEOM = dict(n_nodes=40, n_slots=160, sample_every=8)
LAMS = (0.1, 0.2, 0.3)
PROTOCOL = ("availability", "busy_frac", "stored_info", "obs_birth",
            "obs_holders", "model_holders", "n_in_rz", "availability_z",
            "stored_info_z", "n_in_rz_z")
TAU = np.arange(0.0, 60.0, 4.0)
#: mean, std, quantiles and o_tau_num: float32 sums in another order
RTOL = 1e-6


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


def _tracks(seeds, rcfg):
    return np.stack([np.asarray(_repro_track(jax.random.PRNGKey(s), rcfg))
                     for s in seeds])


def _pair(lams=LAMS, **kw):
    return ([r_paper_params(lam=lam, M=1, **kw) for lam in lams],
            [paper_params(lam=lam, M=1, **kw) for lam in lams])


def _replayed(seeds, reduce="trace", lams=LAMS, geom=GEOM, **kw):
    """``repro``'s sweep and the port's on ``repro``'s positions."""
    rps, ps = _pair(lams)
    rcfg = RCfg(**geom)
    ref = rsweep.run(rps, rcfg, seeds, reduce=reduce, **kw)
    got = sweep.run(ps, SimConfig(**geom, mobility="replay"), seeds,
                    reduce=reduce, device="cpu",
                    positions=_tracks(seeds, rcfg), **kw)
    return ref, got


def _bits(a):
    a = np.asarray(a)
    return a.view(np.int32) if a.dtype == np.float32 else a


# ------------------------------------------------------------------ planner

@pytest.mark.parametrize("n_devices", range(1, 9))
def test_plan_equals_repro(n_devices):
    for p in (1, 2, 3, 5, 8, 13):
        for r in (1, 2, 3, 5):
            for chunk in (None, 1, 2, 3, 7, 20):
                got = plan_sweep(p, r, n_devices=n_devices, chunk_size=chunk)
                want = r_plan_sweep(p, r, n_devices=n_devices,
                                    chunk_size=chunk)
                assert dataclasses.asdict(got) == dataclasses.asdict(want)
                assert (got.n_chunks, got.padded_runs, got.utilization) == (
                    want.n_chunks, want.padded_runs, want.utilization)


def test_plan_defaults_to_one_device_and_refuses_empty_grids():
    assert plan_sweep(3, 2).n_devices == 1
    with pytest.raises(ValueError, match="empty"):
        plan_sweep(0, 4)


# ----------------------------------------------- trace sweep against repro

@pytest.mark.parametrize("grid", ["divisible", "padded_chunked"])
def test_trace_equals_repro_bitwise(working_barrier, grid):
    """2 x 2 in one chunk, and 3 x 2 in chunks of 2 scenarios (the last
    chunk half pad rows): every protocol trace bit for bit."""
    if grid == "divisible":
        ref, got = _replayed((0, 3), lams=LAMS[:2])
    else:
        ref, got = _replayed((0, 1), chunk_size=2)
        assert got.plan.n_chunks == 2 and got.plan.pad_scenarios == 4
    assert dataclasses.asdict(got.plan) == dataclasses.asdict(ref.plan)
    for f in PROTOCOL + ("t",):
        want, have = getattr(ref, f), getattr(got, f)
        assert have.dtype == want.dtype and have.shape == want.shape, f
        np.testing.assert_array_equal(have, want, err_msg=f)
    assert got.host_bytes == ref.host_bytes
    assert got.devices_used == 1 and got.coverage.all()
    assert ref.availability.max() > 0          # the protocol really ran


# ------------------------------------------------- rows against single runs

CELLS_GEOM = dict(n_nodes=64, area_side=60.0, rz_radius=30.0, n_slots=160,
                  sample_every=8, contact_backend="cells")


@pytest.mark.parametrize("kind", ["dense", "cells", "learn"])
def test_rows_equal_single_runs(kind):
    """A free-running 3 x 2 sweep in chunks of 2: row (i, j) equals
    ``simulate(ps[i], cfg, seeds[j])`` bit for bit on every trace."""
    cfg = {"dense": SimConfig(**GEOM),
           "cells": SimConfig(**CELLS_GEOM),
           "learn": SimConfig(**GEOM, learn=logreg_task())}[kind]
    ps = [paper_params(lam=lam, M=1, Lam=lam_n)
          for lam, lam_n in zip(LAMS, (1.0, 3.0, 2.0))]
    seeds = (2, 5)
    batch = sweep.run(ps, cfg, seeds, chunk_size=2, device="cpu")
    fields = PROTOCOL + {"dense": (), "cells": ("nbr_overflow",),
                         "learn": ("test_acc", "test_acc_holders",
                                   "learn_obs", "theta_var",
                                   "merge_stats")}[kind]
    for i, p in enumerate(ps):
        for j, seed in enumerate(seeds):
            one = simulate(p, cfg, seed=seed, device="cpu")
            pt = batch.point(i, j)
            for f in fields + ("t",):
                want, got = getattr(one, f), getattr(pt, f)
                assert got.dtype == want.dtype and got.shape == want.shape
                np.testing.assert_array_equal(_bits(got), _bits(want),
                                              err_msg=f"{kind} {i} {j} {f}")
    assert batch.availability.max() > 0


def test_per_row_lam_and_tl_take_effect():
    """B = 2 x 2: a scenario that differs only in Λ changes every seed's
    stored information; one that differs only in T_L (2 s instead of 2 ms,
    L = 1000x) changes the busy fraction; equal scenarios give equal
    rows."""
    cfg = SimConfig(**GEOM)
    base = paper_params(lam=0.3, M=1)
    seeds = (0, 1)
    batch = sweep.run([base, base.replace(Lam=4.0)], cfg, seeds,
                      device="cpu")
    for j in range(len(seeds)):
        assert not np.array_equal(batch.stored_info[0, j],
                                  batch.stored_info[1, j])
    batch = sweep.run([base, base.replace(L=1000 * base.L)], cfg, seeds,
                      device="cpu")
    assert any(not np.array_equal(batch.busy_frac[0, j], batch.busy_frac[1, j])
               for j in range(len(seeds)))
    same = sweep.run([base, base], cfg, seeds, device="cpu")
    for f in PROTOCOL:
        np.testing.assert_array_equal(getattr(same, f)[0],
                                      getattr(same, f)[1], err_msg=f)


# --------------------------------------------------------------- reductions

def _trace_dict(b):
    return {"availability": b.availability, "busy_frac": b.busy_frac,
            "stored": b.stored_info, "model_holders": b.model_holders,
            "n_in_rz": b.n_in_rz, "availability_z": b.availability_z,
            "stored_z": b.stored_info_z, "n_in_rz_z": b.n_in_rz_z}


def _numpy_reduce(trace: dict, reduce, s0, qs=()):
    out = {}
    for k, v in trace.items():
        w = v[:, :, s0:].astype(np.float32)
        if reduce == "mean":
            out[k] = w.mean(axis=2)
            out[k + "_std"] = w.std(axis=2)
        elif reduce == "final":
            out[k] = v[:, :, -1]
        else:
            out[k] = np.moveaxis(np.quantile(w, qs, axis=2), 0, -1)
    return out


def _close(got, want, what):
    assert got.shape == want.shape and got.dtype == want.dtype, what
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=0.0, err_msg=what)


@pytest.mark.parametrize("reduce", ["mean", "final", "quantiles"])
def test_reductions_equal_repro_and_numpy(working_barrier, reduce):
    """A padded, chunked 3 x 2 grid on replayed positions: each statistic
    equals ``repro``'s and numpy's reduction of the port's own trace
    (``final`` bit for bit; the others within ``RTOL``)."""
    kw = dict(chunk_size=2, quantiles=(0.1, 0.5, 0.9))
    ref, got = _replayed((0, 1), reduce, **kw)
    assert set(got.stats) == set(ref.stats)
    assert got.host_bytes == ref.host_bytes
    assert got.warmup_samples == ref.warmup_samples
    trace = sweep.run(_pair()[1], SimConfig(**GEOM, mobility="replay"),
                      (0, 1), device="cpu", chunk_size=2,
                      positions=_tracks((0, 1), RCfg(**GEOM)))
    mine = _numpy_reduce(_trace_dict(trace), reduce, got.warmup_samples,
                         kw["quantiles"])
    for k, want in ref.stats.items():
        have = got.stats[k]
        assert have.shape == want.shape and have.dtype == want.dtype, k
        if reduce == "final":
            np.testing.assert_array_equal(have, want, err_msg=k)
            np.testing.assert_array_equal(have, mine[k], err_msg=k)
        else:
            _close(have, want, f"{reduce} {k} vs repro")
            np.testing.assert_allclose(have, mine[k], rtol=RTOL, atol=0.0,
                                       err_msg=f"{reduce} {k} vs numpy")


def test_o_tau_equals_repro_and_the_estimator(working_barrier):
    """``o_tau_den`` bit for bit, ``o_tau_num`` within ``RTOL``, and each
    row's ratio equal to ``estimate_o_of_tau`` of its trace row."""
    from repro_torch.sim import estimate_o_of_tau

    geom = dict(GEOM, n_nodes=50, n_slots=480)
    kw = dict(tau_grid=TAU, chunk_size=2, warmup_frac=0.3)
    ref, got = _replayed((0, 2), "o_tau", geom=geom, **kw)
    assert set(got.stats) == set(ref.stats)
    np.testing.assert_array_equal(got.stats["o_tau_den"],
                                  ref.stats["o_tau_den"])
    _close(got.stats["o_tau_num"], ref.stats["o_tau_num"], "o_tau_num")
    assert ref.stats["o_tau_den"].sum() > 0
    trace = sweep.run(_pair()[1], SimConfig(**geom, mobility="replay"),
                      (0, 2), device="cpu", chunk_size=2,
                      positions=_tracks((0, 2), RCfg(**geom)))
    for i in range(3):
        for j in range(2):
            want = estimate_o_of_tau(trace.point(i, j), TAU, 0.3)
            np.testing.assert_allclose(got.stats["o_tau"][i, j], want,
                                       rtol=RTOL, equal_nan=True)


def test_reduce_knobs_and_errors():
    ps = _pair()[1]
    cfg = SimConfig(**GEOM)
    a = sweep.run(ps[:1], cfg, [0], reduce="mean", warmup_frac=0.0,
                  device="cpu")
    b = sweep.run(ps[:1], cfg, [0], reduce="mean", warmup_frac=0.9,
                  device="cpu")
    assert a.warmup_samples == 0 and b.warmup_samples > 0
    assert not np.allclose(a.stats["stored"], b.stats["stored"])
    with pytest.raises(ValueError, match="reduce"):
        sweep.run(ps, cfg, [0], reduce="median", device="cpu")
    with pytest.raises(ValueError, match="tau_grid"):
        sweep.run(ps[:1], cfg, [0], reduce="o_tau", device="cpu")
    with pytest.raises(ValueError, match="uniform"):
        sweep.run(ps[:1], cfg, [0], reduce="o_tau", device="cpu",
                  tau_grid=np.asarray([0.0, 1.0, 4.0]))


# ------------------------------------------------------------------- schema

SCHEMA_CFGS = {
    "dense": (dict(GEOM), dict(GEOM)),
    "learn": (dict(GEOM, learn=r_logreg()), dict(GEOM, learn=logreg_task())),
    "cells": (dict(CELLS_GEOM), dict(CELLS_GEOM)),
}


@pytest.mark.parametrize("kind", sorted(SCHEMA_CFGS))
@pytest.mark.parametrize("reduce", sweep.REDUCERS)
def test_schema_equals_repro_and_expected_shapes(working_barrier, kind,
                                                  reduce):
    """Keys, shapes and dtypes of a 3 x 2 sweep in chunks of 2 equal
    ``repro``'s, and the plain ``expected_shapes`` equals a real chunk."""
    rkw, kw = SCHEMA_CFGS[kind]
    rkw, kw = dict(rkw, n_slots=32), dict(kw, n_slots=32)
    rps, ps = _pair()
    extra = dict(tau_grid=TAU) if reduce == "o_tau" else {}
    ref = rsweep.run(rps, RCfg(**rkw), (0, 1), reduce=reduce, chunk_size=2,
                     **extra)
    got = sweep.run(ps, SimConfig(**kw), (0, 1), reduce=reduce,
                    chunk_size=2, device="cpu", **extra)
    if reduce == "trace":
        for f in dataclasses.fields(BatchSimOutputs):
            w = getattr(ref, f.name)
            if isinstance(w, np.ndarray) and f.name != "coverage":
                g = getattr(got, f.name)
                assert (g.shape, g.dtype) == (w.shape, w.dtype), f.name
        assert got.host_bytes == ref.host_bytes
    else:
        assert {k: (v.shape, v.dtype) for k, v in got.stats.items()} == \
            {k: (v.shape, v.dtype) for k, v in ref.stats.items()}
        assert got.host_bytes == ref.host_bytes
    # the expected schema, from the definition alone, equals a real chunk
    setup = sweep._prepare(ps, SimConfig(**kw), (0, 1), reduce, None, 2,
                           (0.1, 0.5, 0.9), extra.get("tau_grid"), None,
                           torch.device("cpu"), None)
    chunk = sweep._host_copy(setup.worker()(setup.keys,
                                            setup.chunk_params(0)))()
    want = setup.expected_shapes()
    assert set(chunk) == set(want)
    for k, s in want.items():
        assert (chunk[k].shape, chunk[k].dtype) == (s.shape, s.dtype), k
    assert sweep._tree_mismatch(chunk, want) is None


# ---------------------------------------------------------------- refusals

def test_refusals(tmp_path, monkeypatch):
    ps = _pair()[1]
    cfg = SimConfig(**GEOM)
    # the dispatch queue's arguments are accepted: one worker process on a
    # one-chunk sweep equals the in-process sweep
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    short = SimConfig(**dict(GEOM, n_slots=16))
    want = sweep.run(ps, short, [0], reduce="final", device="cpu")
    got = sweep.run(ps, short, [0], reduce="final", device="cpu", workers=1,
                    queue_dir=str(tmp_path / "q"),
                    xla_cache_dir=str(tmp_path / "x"))
    assert got.plan.n_chunks == 1 and got.coverage.all()
    assert set(got.stats) == set(want.stats)
    for k in want.stats:
        np.testing.assert_array_equal(got.stats[k], want.stats[k], err_msg=k)
    assert (tmp_path / "x").is_dir()
    with pytest.raises(NotImplementedError, match="several cards"):
        sweep.run(ps, cfg, [0], device="cpu", n_devices=2)
    with pytest.raises(ValueError, match="model count"):
        sweep.run([ps[0], paper_params(lam=0.1, M=3)], cfg, [0],
                  device="cpu")
    with pytest.raises(ValueError, match="unknown mobility model"):
        sweep.run(ps, SimConfig(**GEOM, mobility="levy"), [0], device="cpu")
    # rwp, manhattan and speed_range are no longer refused: per-seed
    # mobility on the seeds' rows, broadcast to the scenarios
    for kw in (dict(mobility="rwp", pause_s=5.0),
               dict(mobility="manhattan"), dict(speed_range=(0.5, 1.5))):
        got = sweep.run(ps[:2], SimConfig(**dict(GEOM, n_slots=16), **kw),
                        [0, 1], device="cpu")
        np.testing.assert_array_equal(got.n_in_rz[0], got.n_in_rz[1])
    # two zones are no longer refused: the sweep runs them, one trailing
    # zone axis on the per-zone traces
    two = SimConfig(**dict(GEOM, n_slots=16), zones=ZoneSet(
        centers=((50.0, 50.0), (150.0, 150.0)), radii=(40.0, 40.0)))
    got = sweep.run(ps, two, [0], device="cpu")
    assert got.availability_z.shape[-1] == got.n_in_rz_z.shape[-1] == 2
    # a duck-typed fault record is not the port's FaultConfig
    duck = dataclasses.make_dataclass("F", [("enabled", bool, True)])()
    with pytest.raises(ValueError, match="repro_torch.sim.faults.FaultConfig"):
        sweep.run(ps, SimConfig(**GEOM, faults=duck), [0], device="cpu")
    with pytest.raises(ValueError, match="replay"):
        sweep.run(ps, SimConfig(**GEOM, mobility="replay"), [0],
                  device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            sweep.run(ps, cfg, [0])


# ----------------------------------------------- simulate_batch, carry bytes

def test_simulate_batch_is_the_trace_sweep():
    ps = _pair()[1][:2]
    cfg = SimConfig(**GEOM)
    batch = simulate_batch(ps, cfg, (1, 4), device="cpu")
    again = sweep.run(ps, cfg, (1, 4), reduce="trace", device="cpu")
    assert isinstance(batch, BatchSimOutputs)
    assert isinstance(batch.plan, SweepPlan)
    assert (batch.n_scenarios, batch.n_seeds) == (2, 2)
    for f in PROTOCOL:
        np.testing.assert_array_equal(getattr(batch, f), getattr(again, f))
    pt = batch.point(1, 0)
    np.testing.assert_array_equal(pt.busy_frac, batch.busy_frac[1, 0])
    np.testing.assert_array_equal(pt.obs_birth, batch.obs_birth[1, 0])
    assert pt.nbr_overflow is None and pt.test_acc is None
    one = simulate_batch(ps[0], cfg, (4,), device="cpu")
    np.testing.assert_array_equal(one.availability[0, 0],
                                  batch.availability[0, 1])


@pytest.mark.parametrize("kind", ["paper", "paper_m4", "small", "learn",
                                  "cells"])
def test_scan_carry_bytes_is_repros_plus_the_key(kind):
    """Every ``SimState`` field has ``repro``'s bytes; the key is two int64
    words against two uint32 words."""
    kw, m = {"paper": ({}, 1), "paper_m4": ({}, 4), "small": (GEOM, 1),
             "learn": (dict(GEOM, learn="learn"), 1),
             "cells": (CELLS_GEOM, 1)}[kind]
    rkw = {k: (r_logreg() if v == "learn" else v) for k, v in kw.items()}
    tkw = {k: (logreg_task() if v == "learn" else v) for k, v in kw.items()}
    assert scan_carry_bytes(SimConfig(**tkw), m) == \
        r_scan_carry_bytes(RCfg(**rkw), m) + 8
