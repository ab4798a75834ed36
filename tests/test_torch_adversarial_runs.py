"""Whole Byzantine runs of the port against ``repro``'s, on ``repro``'s
positions (``mobility="replay"``) and the same task.

1. Replayed runs at the paper's §VI geometry (N = 200, 320 slots) with
   ``logreg_task()`` at the learning point (λ = 0.05, Λ = 10):
   ``harsh_adversarial()`` with ``robust_defense()`` on the dense backend
   (and on the cell lists at N = 1024 in
   ``tests/test_torch_adversarial_cells.py``); ``signflip()`` undefended; ``noise_injector()`` with ``trimmed_defense()``;
   ``stale_replay()``; ``metadata_liar()``. Every protocol trace, every
   fault field, ``poisoned_frac``, ``poisoned_frac_c`` and ``merge_stats``
   equal ``repro``'s bit for bit; the learning traces are within
   ``tests/test_torch_learn.py``'s rtol 1e-5 / atol 1e-6.
   An attack-only configuration (``signflip()``) leaves the port's
   protocol traces bit for bit those of its ``faults=None`` run on the same
   positions.
2. A P = 2 x R = 2 trace sweep under ``harsh_adversarial()`` with
   ``robust_defense()`` equals ``repro``'s trace sweep as the runs above,
   but for one counter: ``repro``'s vmapped sweep sums a payload's squared
   norm in another order than its single runs, so a payload that lies on
   the clip radius (a merged replica that took a clipped payload whole) is
   counted as clipped in one and not in the other. The port's sweep rows
   equal its B = 1 runs, and its ``MS_NORMCLIP`` counters equal
   ``repro``'s single runs'; every other trace equals ``repro``'s sweep.
   The ``mean`` reduction is within ``tests/test_torch_sweep.py``'s 1e-6
   relative, the counters exact (the norm clips against ``repro``'s single
   runs). The reduced schema equals ``expected_shapes`` in every mode, and
   the checkpoint fingerprint tells apart configurations that differ in
   any adversarial field.

``repro``'s engine and sweep run with ``jax.lax.optimization_barrier`` in
place of its ``shared_barrier`` (which fails under this JAX), patched
inside each test that runs them.
"""

import dataclasses
import functools
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.sim.compute as rcompute
import repro.sim.observations as robs
from repro.configs import fg_adversarial as rfa
from repro.configs.fg_learn import logreg_task as r_logreg
from repro.configs.fg_paper import paper_params as r_paper_params
from repro.sim import SimConfig as RCfg
from repro.sim import learn as rlearn
from repro.sim import simulate as r_simulate
from repro.sim import sweep as rsweep
from repro.sim.mobility import get_mobility as rget
from repro_torch.configs import fg_adversarial as tfa
from repro_torch.configs.fg_learn import logreg_task
from repro_torch.configs.fg_paper import paper_params
from repro_torch.sim import SimConfig, faults, simulate, sweep

#: The paper's §VI geometry (SimConfig's defaults), cut to 320 slots.
PAPER = dict(n_nodes=200, n_slots=320, sample_every=8)
#: The learning point (tests/test_sim_learn.py, fig_learning.py).
LEARN_P = dict(lam=0.05, Lam=10.0, M=1)
PROTOCOL = ("t", "availability", "busy_frac", "stored_info", "obs_birth",
            "obs_holders", "model_holders", "n_in_rz", "availability_z",
            "stored_info_z", "n_in_rz_z")
FAULT = ("availability_c", "on_frac_c", "n_in_rz_c", "fault_events")
BYZANTINE = ("poisoned_frac", "poisoned_frac_c", "merge_stats")
LEARNING = ("test_acc", "test_acc_holders", "learn_obs", "theta_var")
#: learning floats: tests/test_torch_learn.py's tolerances
LEARN_RTOL, LEARN_ATOL = 1e-5, 1e-6
#: mean reductions: float32 sums in another order (test_torch_sweep.py)
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
    """``(n_slots + 1, N, 2)`` rdm positions under ``repro``'s key schedule:
    the base split, then, with protocol faults on, the fault split whose
    first key carries the chain (an attack-only config adds no split)."""
    model = rget("rdm")
    mob, key = model.init(key, cfg)
    faulted = cfg.faults is not None and cfg.faults.enabled

    def step(carry, _):
        mob, key = carry
        key, k1, k2, _, _ = jax.random.split(key, 5)
        if faulted:
            key = jax.random.split(key, 5)[0]
        mob = model.step(k1, k2, mob, cfg)
        return (mob, key), mob.pos

    _, frames = jax.lax.scan(step, (mob, key), None, length=cfg.n_slots)
    return jnp.concatenate([mob.pos[None], frames])


def _learn_pair(defense):
    r_lc, t_lc = r_logreg(), logreg_task()
    if defense is not None:
        r_lc = dataclasses.replace(r_lc, defense=getattr(rfa, defense)())
        t_lc = dataclasses.replace(t_lc, defense=getattr(tfa, defense)())
    return r_lc, t_lc


def _run_pair(attack, defense, geom, seed):
    """``repro``'s run and the port's on ``repro``'s positions."""
    r_fc, t_fc = getattr(rfa, attack)(), getattr(tfa, attack)()
    r_lc, t_lc = _learn_pair(defense)
    rcfg = RCfg(**geom, faults=r_fc, learn=r_lc)
    ref = r_simulate(r_paper_params(**LEARN_P), rcfg, seed=seed)
    track = np.asarray(_repro_track(jax.random.PRNGKey(seed), rcfg))
    out = simulate(paper_params(**LEARN_P),
                   SimConfig(**geom, faults=t_fc, learn=t_lc,
                             mobility="replay"),
                   seed=seed, device="cpu", positions=track)
    return ref, out, track


def _assert_same(ref, out, fields):
    for f in fields:
        want, got = getattr(ref, f), getattr(out, f)
        assert want is not None and got is not None, f
        assert got.dtype == want.dtype and got.shape == want.shape, f
        np.testing.assert_array_equal(got, want, err_msg=f)


def _assert_learning_close(ref, out):
    for f in LEARNING:
        want, got = getattr(ref, f), getattr(out, f)
        assert got.dtype == want.dtype and got.shape == want.shape, f
        np.testing.assert_allclose(got, want, rtol=LEARN_RTOL,
                                   atol=LEARN_ATOL, err_msg=f)


# -------------------------------------------------- 1. replayed runs

RUN_CASES = {
    "harsh-robust-dense": ("harsh_adversarial", "robust_defense", PAPER, 0),
    "signflip": ("signflip", None, PAPER, 2),
    "noise-trimmed": ("noise_injector", "trimmed_defense", PAPER, 3),
    "replay": ("stale_replay", None, PAPER, 4),
    "liar": ("metadata_liar", None, PAPER, 5),
}


def check_replayed_run(attack, defense, geom, seed, extra=()):
    """``repro``'s run and the port's replay: the protocol, fault and
    Byzantine fields (and ``extra``) bit for bit, the learning within
    tolerance; poison was served and spread, the defense fired."""
    ref, out, track = _run_pair(attack, defense, geom, seed)
    fields = PROTOCOL + BYZANTINE + tuple(extra)
    if getattr(tfa, attack)().enabled:
        fields += FAULT
    _assert_same(ref, out, fields)
    _assert_learning_close(ref, out)
    ms = ref.merge_stats[-1]
    assert ms[rlearn.MS_ATTEMPT_POISON] > 0          # poison was served
    assert ref.poisoned_frac.max() > 0               # and it spread
    if defense is not None:
        assert ms[rlearn.MS_NORMCLIP] > 0 and ms[rlearn.MS_DISTREJ] > 0
    return out, track


@pytest.mark.parametrize("case", list(RUN_CASES))
def test_replayed_attack_run_equals_repro(working_barrier, case):
    attack, defense, geom, seed = RUN_CASES[case]
    out, track = check_replayed_run(attack, defense, geom, seed)
    if case == "signflip":
        # attackers follow the protocol: faults=None on the same positions
        clean = simulate(paper_params(**LEARN_P),
                         SimConfig(**geom, learn=logreg_task(),
                                   mobility="replay"),
                         seed=seed, device="cpu", positions=track)
        _assert_same(clean, out, PROTOCOL)
        assert clean.poisoned_frac is None


# ---------------------------------------------------------- 2. the sweep

SWEEP_GEOM = dict(n_nodes=64, area_side=60.0, rz_radius=30.0, n_slots=240,
                  sample_every=8)
SWEEP_LAMS = (0.1, 0.3)
SEEDS = (0, 3)


def _sweep_pair(reduce, **kw):
    r_lc, t_lc = _learn_pair("robust_defense")
    rcfg = RCfg(**SWEEP_GEOM, faults=rfa.harsh_adversarial(), learn=r_lc)
    ref = rsweep.run([r_paper_params(lam=x, Lam=10.0, M=1)
                      for x in SWEEP_LAMS], rcfg, SEEDS, reduce=reduce, **kw)
    tracks = np.stack([np.asarray(_repro_track(jax.random.PRNGKey(s), rcfg))
                       for s in SEEDS])
    got = sweep.run([paper_params(lam=x, Lam=10.0, M=1) for x in SWEEP_LAMS],
                    SimConfig(**SWEEP_GEOM, faults=tfa.harsh_adversarial(),
                              learn=t_lc, mobility="replay"),
                    SEEDS, reduce=reduce, device="cpu", positions=tracks,
                    **kw)
    return ref, got


@functools.lru_cache(maxsize=None)
def _repro_single_runs():
    """``repro``'s B = 1 runs of the sweep's grid: ``(P, R, S, 6)``
    merge_stats."""
    r_lc, _ = _learn_pair("robust_defense")
    rcfg = RCfg(**SWEEP_GEOM, faults=rfa.harsh_adversarial(), learn=r_lc)
    return np.stack([np.stack([
        r_simulate(r_paper_params(lam=x, Lam=10.0, M=1), rcfg,
                   seed=s).merge_stats for s in SEEDS]) for x in SWEEP_LAMS])


def test_attack_sweep_equals_repro(working_barrier):
    ref, got = _sweep_pair("trace")
    _assert_same(ref, got, PROTOCOL[1:] + FAULT + BYZANTINE[:2])
    _assert_learning_close(ref, got)
    assert got.host_bytes == ref.host_bytes
    single = _repro_single_runs()
    clip = rlearn.MS_NORMCLIP
    others = [k for k in range(rlearn.N_MERGE_STATS) if k != clip]
    np.testing.assert_array_equal(got.merge_stats[..., others],
                                  ref.merge_stats[..., others])
    np.testing.assert_array_equal(got.merge_stats, single)
    # repro's own sweep rows count the clips on the radius otherwise
    assert not np.array_equal(ref.merge_stats[..., clip], single[..., clip])
    assert ref.merge_stats[..., -1, rlearn.MS_ATTEMPT_POISON].min() > 0
    assert ref.poisoned_frac.max() > 0
    # the port's rows are its B = 1 runs
    t_lc = _learn_pair("robust_defense")[1]
    tracks = np.stack([np.asarray(_repro_track(
        jax.random.PRNGKey(s), RCfg(**SWEEP_GEOM,
                                    faults=rfa.harsh_adversarial())))
        for s in SEEDS])
    one = simulate(paper_params(lam=SWEEP_LAMS[1], Lam=10.0, M=1),
                   SimConfig(**SWEEP_GEOM, faults=tfa.harsh_adversarial(),
                             learn=t_lc, mobility="replay"),
                   seed=SEEDS[0], device="cpu", positions=tracks[0])
    pt = got.point(1, 0)
    for f in PROTOCOL + FAULT + BYZANTINE + LEARNING:
        np.testing.assert_array_equal(getattr(pt, f), getattr(one, f),
                                      err_msg=f)


def test_attack_mean_sweep_equals_repro(working_barrier):
    ref, got = _sweep_pair("mean")
    assert set(got.stats) == set(ref.stats)
    assert got.host_bytes == ref.host_bytes
    for k, want in ref.stats.items():
        have = got.stats[k]
        assert have.shape == want.shape and have.dtype == want.dtype, k
        if k == "merge_stats":
            np.testing.assert_array_equal(have, _repro_single_runs()[:, :, -1],
                                          err_msg=k)
        elif k == "fault_events":
            np.testing.assert_array_equal(have, want, err_msg=k)
        else:
            np.testing.assert_allclose(have, want, rtol=RTOL, atol=0.0,
                                       err_msg=k)
    assert {"poisoned_frac", "poisoned_frac_c_std"} <= set(got.stats)


@pytest.mark.parametrize("reduce", ["trace", "mean", "final", "quantiles",
                                    "o_tau"])
def test_attack_schema_equals_expected_shapes(reduce):
    cfg = SimConfig(n_nodes=48, area_side=60.0, rz_radius=30.0, n_slots=48,
                    sample_every=8, faults=tfa.harsh_adversarial(),
                    learn=logreg_task())
    ps = [paper_params(lam=x, Lam=10.0, M=1) for x in (0.1, 0.3, 0.2)]
    kw = dict(chunk_size=2, quantiles=(0.25, 0.75))
    if reduce == "o_tau":
        kw["tau_grid"] = np.arange(0.0, 20.0, 4.0)
    out = sweep.run(ps, cfg, (0, 1), reduce=reduce, device="cpu", **kw)
    keys = ("poisoned_frac", "poisoned_frac_c", "merge_stats")
    stats = {k: getattr(out, k) for k in keys} if reduce == "trace" \
        else out.stats
    tau = (5, 4.0) if reduce == "o_tau" else ()
    want = sweep.expected_shapes(cfg, 1, out.plan, reduce, kw["quantiles"],
                                 tau)
    assert set(keys) <= set(stats) and set(keys) <= set(want)
    for k in stats:
        if k == "o_tau":
            continue
        exp = want[k]
        shape = (3, 2) + tuple(exp.shape[2:])
        assert stats[k].shape == shape and stats[k].dtype == exp.dtype, k
    assert stats["poisoned_frac_c"].shape[2 if reduce != "trace" else 3] == 3
    no_attack = sweep.expected_shapes(
        dataclasses.replace(cfg, faults=faults.FaultConfig(crash_rate=0.01)),
        1, out.plan, reduce, kw["quantiles"], tau)
    assert "poisoned_frac" not in no_attack and "merge_stats" in no_attack


def test_checkpoint_fingerprint_tells_attack_configs_apart():
    from repro_torch.sim.sweep import _sweep_fingerprint, plan_sweep

    plan = plan_sweep(1, 1)
    p_stack = {"lam": torch.zeros(1)}
    base = tfa.harsh_adversarial()
    flip = base.classes[1]
    variants = [
        base, tfa.harsh_adversarial(frac_flip=0.2),
        tfa.harsh_adversarial(frac_liar=0.1),
        tfa.harsh_adversarial(scale=2.0),
        dataclasses.replace(base, classes=(
            base.classes[0], dataclasses.replace(flip, adv_mode="noise"),
            base.classes[2])),
        dataclasses.replace(base, classes=(
            base.classes[0], dataclasses.replace(flip, adv_scale=4.5),
            base.classes[2])),
        dataclasses.replace(base, classes=(
            base.classes[0], dataclasses.replace(flip, adv_mode="replay"),
            base.classes[2])),
        tfa.signflip(), tfa.noise_injector(), tfa.stale_replay(),
        tfa.metadata_liar(), tfa.metadata_liar(claimed_count=1e3)]
    lcs = [logreg_task(),
           dataclasses.replace(logreg_task(), defense=tfa.robust_defense()),
           dataclasses.replace(logreg_task(),
                               defense=tfa.trimmed_defense())]
    fps = {_sweep_fingerprint(SimConfig(n_nodes=48, faults=fc, learn=lc), 1,
                              plan, "mean", 0, (), (), (0,), p_stack)
           for fc in variants for lc in lcs}
    assert len(fps) == len(variants) * len(lcs)
