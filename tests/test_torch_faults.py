"""The port's fault layer (``repro_torch.sim.faults``, the presets of
``repro_torch.configs.fg_faults`` and the engine's fault sites) against
``repro``'s, on the same inputs.

1. Each function of ``faults.py`` equals ``repro``'s bit for bit on random
   inputs from a seed at B = 1 and B = 2 (``duty_step``, ``link_fail``,
   ``abort_matches``, ``gate_deliveries``, ``fault_outputs`` as
   ``repro``'s engine compiles it, ``drop_state``, ``node_classes``,
   ``class_onehot``, ``init_avail``); a threshold that is
   a Python float is compared as float32, pinned with draws on either side
   of it; the presets build equal records and the validation raises alike.
2. Whole runs at the paper's §VI geometry (N = 200, 320 slots; the cells
   backend at N = 1024, 304 slots), the port replaying ``repro``'s
   positions, equal ``repro``'s on every protocol trace and every fault
   field bit for bit: dense and cells under ``harsh()``, ``free_rider_mix()``,
   ``zipf_mix(n_classes=3)`` and ``harsh()`` with ``logreg_task()`` learning
   (learning traces within ``tests/test_torch_learn.py``'s rtol 1e-5 /
   atol 1e-6).
3. A P = 2 x R = 2 trace sweep under ``harsh()`` equals ``repro``'s bit for
   bit; its ``mean`` reduction is within ``tests/test_torch_sweep.py``'s
   1e-6 relative, ``fault_events`` exact; the reduced schema equals
   ``expected_shapes``; the checkpoint fingerprint tells fault configs
   apart.
4. ``tests/test_sim_faults.py``'s invariants on the port: a disabled
   config bit for bit ``faults=None`` on both backends, determinism and
   other events for another seed, dense equal to cells under faults,
   telemetry shapes and the duty class's on-fraction, free-riders never
   delivering, ``drop_state`` clearing only the flagged nodes, the duty
   chain's words and stationary on-fraction.
5. The class-structured fixed point and DDE equal ``repro``'s for
   ``duty_mix(0.4)``, ``zipf_mix(4)``, ``zipf_mix(5)`` and ``harsh()`` at
   M = 1 within ``tests/test_torch_analytics.py``'s tolerances (rtol 1e-5;
   o(τ) atol 1e-5; Zipf-5 at λ = 0.05 exactly), delegate to the scalar
   solvers bit for bit, and order the Zipf ranks. At M = 3 and 4 both
   packages' damped iterations wander on the float32 grid of Lemma 1's
   busy probability (steps of ulp(K), shown in ``repro`` itself), so the
   fixed point is held to a few such steps and the DDE to atol 1e-5 on
   ``repro``'s own fixed point.

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
from repro.configs.fg_paper import paper_contact_model as r_contact
from repro.configs.fg_paper import paper_params as r_paper_params
from repro.core.zones import ZoneSet as RZoneSet
from repro.core import dde as r_dde
from repro.core import meanfield as r_mf
from repro.sim import SimConfig as RCfg
from repro.sim import faults as rfaults
from repro.sim import learn as rlearn
from repro.sim import simulate as r_simulate
from repro.sim import sweep as rsweep
from repro.sim.engine import scan_carry_bytes as r_scan_carry_bytes
from repro.sim.mobility import get_mobility as rget
from repro.sim.state import init_sim_state as r_init_state
from repro_torch import random as tr
from repro_torch.configs import fg_faults as tff
from repro_torch.configs.fg_learn import logreg_task
from repro_torch.configs.fg_paper import DENSITY, paper_contact_model
from repro_torch.configs.fg_paper import paper_params
from repro_torch.core import dde as t_dde
from repro_torch.core import meanfield as t_mf
from repro_torch.core.zones import ZoneSet
from repro_torch.sim import SimConfig, simulate, sweep
from repro_torch.sim import compute, faults
from repro_torch.sim import learn as tlearn
from repro_torch.sim.engine import effective_zones, zone_member
from repro_torch.sim.engine import scan_carry_bytes
from repro_torch.sim.mobility import get_mobility
from repro_torch.kernels.contacts import zone_words
from repro_torch.sim.state import (init_sim_state, state_from_numpy,
                                   state_to_numpy)

#: The paper's §VI geometry (SimConfig's defaults), cut to 320 slots.
PAPER = dict(n_nodes=200, n_slots=320, sample_every=8)
#: N = 1024 at the paper's density on the cell lists, 304 slots.
CELLS = dict(n_nodes=1024, area_side=float(np.sqrt(1024 / DENSITY)),
             rz_radius=float(np.sqrt(1024 / DENSITY)) / 2, n_slots=304,
             sample_every=16, contact_backend="cells")
SMALL = dict(n_nodes=48, area_side=60.0, rz_radius=30.0, n_slots=160,
             sample_every=8)
PROTOCOL = ("t", "availability", "busy_frac", "stored_info", "obs_birth",
            "obs_holders", "model_holders", "n_in_rz", "availability_z",
            "stored_info_z", "n_in_rz_z")
FAULT = ("availability_c", "on_frac_c", "n_in_rz_c", "fault_events")
LEARNING = ("test_acc", "test_acc_holders", "learn_obs", "theta_var")
TASK_FIELDS = ("theta0", "w_true", "x_test", "y_test", "stream_key")
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
    """``(n_slots + 1, N, 2)`` rdm positions under ``repro``'s key schedule
    with an enabled fault layer: the base split, then the fault split,
    whose first key carries the chain."""
    model = rget("rdm")
    mob, key = model.init(key, cfg)

    def step(carry, _):
        mob, key = carry
        key, k1, k2, _, _ = jax.random.split(key, 5)
        key = jax.random.split(key, 5)[0]
        mob = model.step(k1, k2, mob, cfg)
        return (mob, key), mob.pos

    _, frames = jax.lax.scan(step, (mob, key), None, length=cfg.n_slots)
    return jnp.concatenate([mob.pos[None], frames])


def _t(a):
    return torch.from_numpy(np.array(a))


def _bits(a):
    a = np.asarray(a)
    return a.view(np.int32) if a.dtype == np.float32 else a


def _keys(seed, b):
    """``b`` keys from ``seed``, as ``repro`` and as the port holds them."""
    keys = jax.random.split(jax.random.PRNGKey(seed), b)
    return keys, _t(np.asarray(keys).astype(np.int64))


def _same(got, want, what=""):
    got = got.numpy() if torch.is_tensor(got) else np.asarray(got)
    want = np.asarray(want)
    if want.dtype == np.uint32:
        want = want.view(np.int32)
    assert got.shape == want.shape and got.dtype == want.dtype, (
        what, got.shape, want.shape, got.dtype, want.dtype)
    np.testing.assert_array_equal(_bits(got), _bits(want), err_msg=what)


# ------------------------------------------------- 1. functions vs repro

PRESETS = {
    "always_on": {}, "duty_mix": dict(duty=0.4), "harsh": {},
    "free_rider_mix": dict(frac_fr=0.3), "zipf_mix": dict(n_classes=3),
    "zipf_mix_s0": dict(n_classes=4, s=0.0),
}


def _preset(name):
    kw = PRESETS[name]
    fn = name.replace("_s0", "")
    return getattr(rff, fn)(**kw), getattr(tff, fn)(**kw)


@pytest.mark.parametrize("name", list(PRESETS))
def test_presets_and_properties_equal_repro(name):
    r_fc, t_fc = _preset(name)
    assert dataclasses.asdict(t_fc) == dataclasses.asdict(r_fc)
    for prop in ("n_classes", "enabled", "adversarial", "adv_frac"):
        assert getattr(t_fc, prop) == getattr(r_fc, prop), prop
    assert [c.duty for c in t_fc.classes] == [c.duty for c in r_fc.classes]
    assert tff.CYCLE_TIME_DEFAULT == rff.CYCLE_TIME_DEFAULT
    assert tff.zipf_weights(5, 0.7) == rff.zipf_weights(5, 0.7)
    for n in (1, 7, 48, 200, 1025):
        np.testing.assert_array_equal(faults.node_classes(t_fc, n),
                                      rfaults.node_classes(r_fc, n))
        np.testing.assert_array_equal(faults.class_onehot(t_fc, n),
                                      rfaults.class_onehot(r_fc, n))


def test_adversarial_config_and_constants_equal_repro():
    classes = (dict(frac=0.3), dict(frac=0.2, adv_mode="signflip"),
               dict(frac=0.25, adv_mode="noise", adv_scale=0.5),
               dict(frac=0.25, adv_mode="liar", adv_scale=7.0))
    r_fc = rfaults.FaultConfig(classes=tuple(
        rfaults.FaultClass(**c) for c in classes))
    t_fc = faults.FaultConfig(classes=tuple(
        faults.FaultClass(**c) for c in classes))
    assert t_fc.adversarial and not t_fc.enabled
    assert (t_fc.adversarial, t_fc.enabled, t_fc.adv_frac) == (
        r_fc.adversarial, r_fc.enabled, r_fc.adv_frac)
    np.testing.assert_array_equal(faults.node_classes(t_fc, 37),
                                  rfaults.node_classes(r_fc, 37))
    assert (faults.EV_ABORT, faults.EV_LINKFAIL, faults.EV_CRASH,
            faults.N_EVENTS, faults.ADV_MODES) == (
        rfaults.EV_ABORT, rfaults.EV_LINKFAIL, rfaults.EV_CRASH,
        rfaults.N_EVENTS, rfaults.ADV_MODES)


@pytest.mark.parametrize("bad", [
    dict(classes=()), dict(classes=(dict(frac=0.5),)),
    dict(classes=(dict(frac=1.2), dict(frac=-0.2))),
    dict(link_fail_rate=-1.0), dict(crash_rate=-0.1), dict(p_abort=1.0),
    dict(p_abort=-0.1), dict(classes=(dict(adv_mode="bogus"),)),
    dict(classes=(dict(adv_mode="noise", adv_scale=0.0),)),
])
def test_validation_raises_alike(bad):
    def build(mod):
        kw = dict(bad)
        if "classes" in kw:
            kw["classes"] = tuple(mod.FaultClass(**c) for c in kw["classes"])
        return mod.FaultConfig(**kw)

    with pytest.raises(ValueError) as want:
        build(rfaults)
    with pytest.raises(ValueError) as got:
        build(faults)
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("preset,kw", [
    ("duty_mix", dict(duty=0.0)), ("duty_mix", dict(frac_duty=0.0)),
    ("duty_mix", dict(cycle_time=0.0)), ("zipf_weights", dict(n_classes=0)),
    ("zipf_mix", dict(s=-0.1)), ("free_rider_mix", dict(frac_fr=1.0)),
])
def test_preset_validation_raises_alike(preset, kw):
    with pytest.raises(ValueError) as want:
        getattr(rff, preset)(**kw)
    with pytest.raises(ValueError) as got:
        getattr(tff, preset)(**kw)
    assert str(got.value) == str(want.value)


def test_init_avail_equals_repro():
    for n in (1, 31, 32, 33, 200):
        got = faults.init_avail(2, n)
        want = np.asarray(rfaults.init_avail(n))
        for b in range(2):
            _same(got[b], want, f"n={n}")


@pytest.mark.parametrize("b", [1, 2])
def test_duty_step_equals_repro(b):
    rng = np.random.default_rng(3 + b)
    n = 70
    masks = rng.random((b, n)) < 0.6
    p_off = rng.random(n).astype(np.float32) * 0.3
    p_on = rng.random(n).astype(np.float32) * 0.3
    r_keys, t_keys = _keys(b, b)
    step = jax.jit(partial(rfaults.duty_step, n=n))
    t_words = compute.pack_mask(_t(masks))
    got_w, got_on = faults.duty_step(tr.uniform(t_keys, (n,)), t_words,
                                     _t(p_off), _t(p_on))
    for i in range(b):
        words = rcompute.pack_mask(jnp.asarray(masks[i])[None])[0]
        want_w, want_on = step(r_keys[i], words, p_off, p_on)
        _same(got_w[i], want_w, "availw")
        _same(got_on[i], want_on, "on")
        _same(t_words[i], words, "packed input")


def test_slot_draws_are_each_keys_uniform():
    """The engine's one-pass draw of the fault split's four keys equals
    ``repro``'s four ``uniform(k, (N,))`` draws, at R = 1 and 2."""
    for r in (1, 2):
        r_keys, t_keys = _keys(40 + r, r)
        subs = jax.vmap(lambda k: jax.random.split(k, 5))(r_keys)
        got = faults.slot_draws(
            _t(np.asarray(subs).astype(np.int64))[:, 1:], 77)
        assert len(got) == 4
        for i, u in enumerate(got):
            for row in range(r):
                _same(u[row], jax.random.uniform(subs[row, i + 1], (77,)))


def _partners(rng, b, n):
    """Mutual random pairs (``p[p[i]] == i``) with idle nodes at -1."""
    out = np.full((b, n), -1, np.int32)
    for i in range(b):
        perm = rng.permutation(n)[: (n // 3) * 2]
        a, c = perm[0::2], perm[1::2]
        out[i, a], out[i, c] = c, a
    return out


@pytest.mark.parametrize("b", [1, 2])
def test_link_fail_and_abort_equal_repro(b):
    rng = np.random.default_rng(10 + b)
    n = 90
    partner = _partners(rng, b, n)
    r_keys, t_keys = _keys(20 + b, b)
    u = tr.uniform(t_keys, (n,))
    for p in (0.0, 0.05, 0.3, float(1.0 - np.exp(-0.05 * 0.25))):
        got_l = faults.link_fail(u, p, _t(partner))
        got_m, got_a = faults.abort_matches(u, p, _t(partner))
        for i in range(b):
            want_l = jax.jit(rfaults.link_fail)(r_keys[i], p, partner[i])
            _same(got_l[i], want_l, f"link p={p}")
            want_m, want_a = jax.jit(rfaults.abort_matches)(
                r_keys[i], p, partner[i])
            _same(got_m[i], want_m, f"match p={p}")
            _same(got_a[i], want_a, f"aborted p={p}")
            m = got_m[i].numpy()
            ok = m >= 0
            assert np.all(m[m[ok]] == np.arange(n)[ok])    # still mutual


def test_thresholds_compare_as_float32():
    """A threshold just above a draw in float64 that rounds to the draw
    in float32: ``repro`` (weak typing) compares in float32, so the draw
    is not below it; draws on either side of it fall as they should."""
    r_keys, t_keys = _keys(7, 1)
    n = 64
    u = np.asarray(jax.random.uniform(r_keys[0], (n,)))
    j = int(np.argsort(u[:-1])[n // 2])
    p = float(np.nextafter(np.float64(u[j]), 1.0))
    assert np.float32(p) == u[j] and p > float(u[j])
    partner = np.full((1, n), -1, np.int32)
    partner[0, :2] = (1, 0)
    t_u = tr.uniform(t_keys, (n,))
    low = faults.link_fail(t_u, p, _t(partner))[0].numpy()
    assert not low[j]                              # the draw on the threshold
    np.testing.assert_array_equal(low[2:], (u < np.float32(p))[2:])
    assert low[2:].any() and not low[2:].all()     # draws either side
    _same(low, jax.jit(rfaults.link_fail)(r_keys[0], p, partner[0]))
    match = np.full((1, n), -1, np.int32)
    match[0, [j, j + 1]] = (j + 1, j)             # the pair reads j's coin
    _, got = faults.abort_matches(t_u, p, _t(match))
    _, want = jax.jit(rfaults.abort_matches)(r_keys[0], p, match[0])
    _same(got[0], want)
    assert not got[0, j] and not got[0, j + 1]


def test_gate_deliveries_equals_repro():
    rng = np.random.default_rng(11)
    b, n, m = 2, 40, 3
    delivered = rng.random((b, n, m)) < 0.6
    pidx = rng.integers(0, n, (b, n)).astype(np.int32)
    is_fr = rng.random(n) < 0.3
    got = faults.gate_deliveries(_t(delivered), _t(pidx), _t(is_fr))
    for i in range(b):
        _same(got[i], rfaults.gate_deliveries(
            jnp.asarray(delivered[i]), jnp.asarray(pidx[i]),
            jnp.asarray(is_fr)))
        fr_partner = is_fr[pidx[i]]
        assert not got[i].numpy()[fr_partner].any()
        np.testing.assert_array_equal(got[i].numpy()[~fr_partner],
                                      delivered[i][~fr_partner])


@pytest.mark.parametrize("b", [1, 2])
def test_fault_outputs_equal_repro(b):
    """As ``repro``'s engine compiles it: the class membership and sizes
    are constants of the program (the on-fraction then multiplies by the
    reciprocal of the class size)."""
    rng = np.random.default_rng(5)
    n, m = 64, 2
    r_fc, t_fc = rff.zipf_mix(n_classes=3), tff.zipf_mix(n_classes=3)
    cls1h = rfaults.class_onehot(r_fc, n)
    npc = cls1h.sum(axis=0).astype(np.float32)
    ref = jax.jit(lambda on, in_rz, hm, ev: rfaults.fault_outputs(
        on=on, in_rz=in_rz, has_model=hm, cls1h=jnp.asarray(cls1h),
        n_per_class=jnp.asarray(npc), fault_events=ev))
    on = rng.random((b, n)) < 0.55
    in_rz = rng.random((b, n)) < 0.7
    hm = rng.random((b, n, m)) < 0.5
    ev = rng.integers(0, 50, (b, 3)).astype(np.int32)
    got = faults.fault_outputs(
        on=_t(on), in_rz=_t(in_rz), has_model=_t(hm),
        cls1h=_t(faults.class_onehot(t_fc, n)), n_per_class=_t(npc),
        fault_events=_t(ev))
    for i in range(b):
        want = ref(on[i], in_rz[i], hm[i], ev[i])
        assert set(got) == set(want)
        for k in want:
            _same(got[k][i], want[k], k)


def _drop_args(rng, b, n):
    return dict(
        inc=rng.integers(0, 2**32, (b, n, 1, 2), dtype=np.uint32),
        has_model=rng.random((b, n, 1)) < 0.8,
        tq_model=rng.integers(-1, 3, (b, n, 4)).astype(np.int8),
        mq_model=rng.integers(-1, 3, (b, n, 4)).astype(np.int8),
        serving=rng.integers(-1, 2, (b, n)).astype(np.int32),
        serv_left=rng.random((b, n)).astype(np.float32),
    )


@pytest.mark.parametrize("b", [1, 2])
def test_drop_state_equals_repro_and_clears_only_flagged(b):
    rng = np.random.default_rng(b)
    n = 32
    args = _drop_args(rng, b, n)
    drop = rng.random((b, n)) < 0.4
    t_args = {k: _t(v.view(np.int32) if v.dtype == np.uint32 else v)
              for k, v in args.items()}
    got = faults.drop_state(_t(drop), **t_args)
    for i in range(b):
        want = rfaults.drop_state(
            jnp.asarray(drop[i]), **{k: jnp.asarray(v[i])
                                     for k, v in args.items()})
        for k in want:
            _same(got[k][i], want[k], k)
    keep = ~drop
    for k, v in t_args.items():
        g = got[k].numpy()
        np.testing.assert_array_equal(g[keep], v.numpy()[keep], err_msg=k)
        dropped = g[drop]
        empty = {"inc": 0, "has_model": False, "tq_model": -1,
                 "mq_model": -1, "serving": -1, "serv_left": 0.0}[k]
        assert np.all(dropped == empty), k


def test_duty_chain_words_and_stationary_fraction():
    """The packed word unpacks to the step's mask, and the chain settles
    at rate_on / (rate_on + rate_off)."""
    n = 96
    fc = tff.duty_mix(duty=0.7, frac_duty=1.0)
    c = fc.classes[0]
    p_off = torch.full((n,), float(np.float32(1 - np.exp(-c.rate_off * .25))))
    p_on = torch.full((n,), float(np.float32(1 - np.exp(-c.rate_on * .25))))
    availw = faults.init_avail(1, n)
    key = tr.PRNGKey(0)[None]
    on_frac = []
    for _ in range(400):
        key, k = tr.split(key, 2).unbind(-2)
        availw, on = faults.duty_step(tr.uniform(k, (n,)), availw, p_off,
                                      p_on)
        assert torch.equal(compute.unpack_mask(availw, n), on)
        on_frac.append(float(on.float().mean()))
    assert abs(np.mean(on_frac[100:]) - 0.7) < 0.05


# -------------------------------------------------- 2. whole runs vs repro

def _run_pair(name, kw, geom, seed, lam=0.05, learn=False):
    """``repro``'s run and the port's on ``repro``'s positions."""
    r_fc, t_fc = getattr(rff, name)(**kw), getattr(tff, name)(**kw)
    p_args = dict(lam=lam, M=1, **(dict(Lam=10.0) if learn else {}))
    extra_r, extra_t, task = {}, {}, None
    if learn:
        r_lc, t_lc = r_logreg(), logreg_task()
        extra_r, extra_t = dict(learn=r_lc), dict(learn=t_lc)
        rtask = rlearn.make_task(r_lc)
        task = tlearn.task_from_numpy(
            *(np.asarray(getattr(rtask, f)) for f in TASK_FIELDS))
    rcfg = RCfg(**geom, faults=r_fc, **extra_r)
    ref = r_simulate(r_paper_params(**p_args), rcfg, seed=seed)
    track = np.asarray(_repro_track(jax.random.PRNGKey(seed), rcfg))
    out = simulate(paper_params(**p_args),
                   SimConfig(**geom, faults=t_fc, mobility="replay",
                             **extra_t),
                   seed=seed, device="cpu", positions=track, task=task)
    return ref, out


def _assert_same_run(ref, out, extra=()):
    for f in PROTOCOL + FAULT + tuple(extra):
        want, got = getattr(ref, f), getattr(out, f)
        assert want is not None and got is not None, f
        assert got.dtype == want.dtype and got.shape == want.shape, f
        np.testing.assert_array_equal(got, want, err_msg=f)


RUN_CASES = {
    "dense-harsh": ("harsh", {}, PAPER, 3, 0.05, ()),
    "cells-harsh": ("harsh", {}, CELLS, 1, 0.05, ("nbr_overflow",)),
    "free_riders": ("free_rider_mix", {}, PAPER, 4, 0.3, ()),
    "zipf3": ("zipf_mix", dict(n_classes=3), PAPER, 5, 0.05, ()),
}


@pytest.mark.parametrize("case", list(RUN_CASES))
def test_replayed_faulted_run_equals_repro_bitwise(working_barrier, case):
    name, kw, geom, seed, lam, extra = RUN_CASES[case]
    ref, out = _run_pair(name, kw, geom, seed, lam)
    _assert_same_run(ref, out, extra)
    assert ref.availability.max() > 0                # the protocol ran
    if name == "harsh":
        assert np.all(ref.fault_events[-1] > 0)       # every fault fired
        assert ref.on_frac_c[:, 1].min() < 1.0
    if name == "free_rider_mix":
        assert ref.availability_c[:, 0, 1].max() > 0  # free-riders receive


def test_replayed_faulted_learning_run_equals_repro(working_barrier):
    ref, out = _run_pair("harsh", {}, PAPER, 2, learn=True)
    _assert_same_run(ref, out, ("merge_stats",))
    for f in LEARNING:
        want, got = getattr(ref, f), getattr(out, f)
        assert got.dtype == want.dtype and got.shape == want.shape, f
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6,
                                   err_msg=f)
    assert ref.merge_stats[-1, rlearn.MS_ATTEMPT] > 0
    assert np.all(ref.fault_events[-1] > 0)


def test_state_carried_across_under_faults():
    """``repro``'s initial faulted state carried across equals the port's
    own, the fault carry included, and carries back."""
    rcfg, cfg = RCfg(**SMALL, faults=rff.harsh()), SimConfig(
        **SMALL, faults=tff.harsh())
    mob, _ = rget("rdm").init(jax.random.PRNGKey(2), rcfg)
    zone0 = jnp.linalg.norm(mob.pos - rcfg.area_side / 2, axis=-1) \
        <= rcfg.rz_radius
    state = r_init_state(mob, zone0, M=1, cfg=rcfg)
    fields = {f.name: np.asarray(getattr(state, f.name))
              for f in dataclasses.fields(state)
              if f.name != "mob" and getattr(state, f.name) is not None}
    fields["mob"] = {f.name: np.asarray(getattr(mob, f.name))
                     for f in dataclasses.fields(mob)}
    assert "availw" in fields and "fault_events" in fields
    carried = state_from_numpy(fields, "cpu")
    own_mob, _ = get_mobility("rdm").init(tr.PRNGKey(2)[None], cfg)
    own = init_sim_state(own_mob, zone_words(zone_member(
        own_mob.pos, effective_zones(cfg))), M=1, cfg=cfg)
    for name in ("availw", "fault_events", "inc", "partner"):
        assert torch.equal(getattr(carried, name), getattr(own, name)), name
    back = state_to_numpy(carried, cfg)
    for k in ("availw", "fault_events"):
        assert back[k].dtype == fields[k].dtype
        np.testing.assert_array_equal(back[k], fields[k])


def test_scan_carry_bytes_under_faults_is_repros_plus_the_key():
    for name in ("harsh", "zipf_mix"):
        r_fc, t_fc = getattr(rff, name)(), getattr(tff, name)()
        for geom in (SMALL, PAPER):
            want = r_scan_carry_bytes(RCfg(**geom, faults=r_fc), 1)
            assert scan_carry_bytes(SimConfig(**geom, faults=t_fc), 1) \
                == want + 8
    assert scan_carry_bytes(SimConfig(**SMALL, faults=tff.always_on()), 1) \
        == scan_carry_bytes(SimConfig(**SMALL), 1)


# --------------------------------------------------------- 3. the sweep

SWEEP_GEOM = dict(n_nodes=64, area_side=60.0, rz_radius=30.0, n_slots=240,
                  sample_every=8)
SWEEP_LAMS = (0.1, 0.3)
SEEDS = (0, 3)


def _sweep_pair(reduce, **kw):
    rcfg = RCfg(**SWEEP_GEOM, faults=rff.harsh())
    ref = rsweep.run([r_paper_params(lam=x, M=1) for x in SWEEP_LAMS], rcfg,
                     SEEDS, reduce=reduce, **kw)
    tracks = np.stack([np.asarray(_repro_track(jax.random.PRNGKey(s), rcfg))
                       for s in SEEDS])
    got = sweep.run([paper_params(lam=x, M=1) for x in SWEEP_LAMS],
                    SimConfig(**SWEEP_GEOM, faults=tff.harsh(),
                              mobility="replay"),
                    SEEDS, reduce=reduce, device="cpu", positions=tracks,
                    **kw)
    return ref, got


def test_faulted_sweep_equals_repro(working_barrier):
    ref, got = _sweep_pair("trace")
    for f in PROTOCOL + FAULT:
        want, have = getattr(ref, f), getattr(got, f)
        assert have.dtype == want.dtype and have.shape == want.shape, f
        np.testing.assert_array_equal(have, want, err_msg=f)
    assert got.host_bytes == ref.host_bytes
    assert np.all(ref.fault_events[:, :, -1] > 0)
    # the seeds' fault draws differ; a scenario's rows share its seed's
    assert not np.array_equal(ref.fault_events[0, 0], ref.fault_events[0, 1])
    np.testing.assert_array_equal(ref.on_frac_c[0], ref.on_frac_c[1])


def test_faulted_mean_sweep_equals_repro(working_barrier):
    ref, got = _sweep_pair("mean")
    assert set(got.stats) == set(ref.stats)
    assert got.host_bytes == ref.host_bytes
    for k, want in ref.stats.items():
        have = got.stats[k]
        assert have.shape == want.shape and have.dtype == want.dtype, k
        if k == "fault_events":
            np.testing.assert_array_equal(have, want, err_msg=k)
        else:
            np.testing.assert_allclose(have, want, rtol=RTOL, atol=0.0,
                                       err_msg=k)
    assert {"availability_c", "on_frac_c_std", "n_in_rz_c"} <= set(got.stats)


@pytest.mark.parametrize("reduce", ["trace", "mean", "final", "quantiles",
                                    "o_tau"])
def test_faulted_schema_equals_expected_shapes(reduce):
    cfg = SimConfig(**dict(SMALL, n_slots=48), faults=tff.zipf_mix(
        n_classes=3))
    ps = [paper_params(lam=x, M=1) for x in (0.1, 0.3, 0.2)]
    kw = dict(chunk_size=2, quantiles=(0.25, 0.75))
    if reduce == "o_tau":
        kw["tau_grid"] = np.arange(0.0, 20.0, 4.0)
    out = sweep.run(ps, cfg, (0, 1), reduce=reduce, device="cpu", **kw)
    stats = out.stats if reduce != "trace" else {
        k: getattr(out, k) for k in FAULT}
    tau = (5, 4.0) if reduce == "o_tau" else ()
    want = sweep.expected_shapes(cfg, 1, out.plan, reduce, kw["quantiles"],
                                 tau)
    for k in FAULT if reduce == "trace" else stats:
        if k == "o_tau":
            continue
        exp = want[k]
        shape = (3, 2) + tuple(exp.shape[2:])
        assert stats[k].shape == shape and stats[k].dtype == exp.dtype, k
    assert "fault_events" in stats
    assert stats["fault_events"].shape[-1] == 3


def test_checkpoint_fingerprint_tells_fault_configs_apart():
    from repro_torch.sim.sweep import _sweep_fingerprint, plan_sweep

    plan = plan_sweep(1, 1)
    p_stack = {"lam": torch.zeros(1)}
    base = tff.harsh()
    variants = [base, tff.harsh(duty=0.5), tff.harsh(cycle_time=20.0),
                tff.harsh(link_fail_rate=0.06), tff.harsh(p_abort=0.2),
                tff.harsh(crash_rate=0.003), tff.harsh(frac_duty=0.4),
                dataclasses.replace(base, classes=(
                    base.classes[0], dataclasses.replace(base.classes[1],
                                                         name="other"))),
                dataclasses.replace(base, classes=(
                    dataclasses.replace(base.classes[0], free_rider=True),
                    base.classes[1]))]
    fps = {_sweep_fingerprint(SimConfig(**SMALL, faults=fc), 1, plan,
                              "mean", 0, (), (), (0,), p_stack)
           for fc in variants}
    assert len(fps) == len(variants)


# ------------------------------------------- 4. the port's own invariants

def _port(cfg, seed, p=None):
    return simulate(p or paper_params(lam=0.2, M=1), cfg, seed=seed,
                    device="cpu")


@pytest.mark.parametrize("backend", ["dense", "cells"])
def test_zero_rate_config_bitwise_identical(backend):
    cfg = SimConfig(**SMALL, contact_backend=backend)
    base = _port(cfg, 3)
    for fc in (tff.always_on(), faults.FaultConfig(
            classes=(faults.FaultClass(frac=0.5),
                     faults.FaultClass(frac=0.5, name="b")))):
        zz = _port(dataclasses.replace(cfg, faults=fc), 3)
        for f in PROTOCOL:
            np.testing.assert_array_equal(getattr(zz, f), getattr(base, f),
                                          err_msg=f)
        assert all(getattr(zz, f) is None for f in FAULT)


def test_faulted_run_deterministic_and_seeded():
    cfg = SimConfig(**SMALL, faults=tff.harsh())
    a, b, c = _port(cfg, 7), _port(cfg, 7), _port(cfg, 8)
    for f in PROTOCOL + FAULT:
        np.testing.assert_array_equal(getattr(a, f), getattr(b, f),
                                      err_msg=f)
    assert not np.array_equal(a.fault_events, c.fault_events)


def test_dense_and_cells_agree_under_faults():
    fc = tff.harsh()
    dense = _port(SimConfig(**SMALL, contact_backend="dense", faults=fc), 5)
    cells = _port(SimConfig(**SMALL, contact_backend="cells", faults=fc), 5)
    for f in PROTOCOL + FAULT:
        np.testing.assert_array_equal(getattr(dense, f), getattr(cells, f),
                                      err_msg=f)
    assert cells.nbr_overflow.max() == 0


def test_fault_telemetry_shapes_and_sanity():
    fc = tff.duty_mix(duty=0.6, frac_duty=0.5)
    out = _port(SimConfig(**SMALL, faults=fc), 0)
    s = out.availability.shape[0]
    assert out.availability_c.shape == (s, 1, 2)
    assert out.on_frac_c.shape == (s, 2)
    assert out.n_in_rz_c.shape == (s, 2)
    assert out.fault_events.shape == (s, 3)
    assert np.all(out.on_frac_c[:, 0] == 1.0)
    assert abs(float(out.on_frac_c[s // 2:, 1].mean()) - 0.6) < 0.15
    assert np.all(np.diff(out.fault_events, axis=0) >= 0)
    np.testing.assert_array_equal(out.n_in_rz_c.sum(-1), out.n_in_rz)


def test_free_rider_class_still_receives_in_the_engine():
    """The free-rider class (class 1) gains availability only through
    class-0 servers: it must still receive (``gate_deliveries`` above
    shows it never serves)."""
    out = _port(SimConfig(**SMALL, faults=tff.free_rider_mix(frac_fr=0.5)),
                2)
    assert float(out.availability_c[-1, 0, 1]) > 0.0


# ------------------------------------------------------- 5. the analytics

CM_R = r_contact()
CM_T = paper_contact_model(device="cpu")
CLASS_FIELDS = ("a", "a_serve", "q", "q_bar", "fracs", "b", "S", "T_S",
                "N_z", "alpha_z", "Lam_z", "r", "d_M", "d_I")


#: Lemma 1's b = K - sqrt(K*K - 1) is a difference of two float32 values
#: near K (about 37-41 here), so it moves in steps of ulp(K): 2.8e-4 of b
#: at M = 3. The damped class iteration then has no exact fixed point at
#: M > 1 and wanders between neighbouring steps in both packages, each step
#: moving a class's availability by about (1 - a) ulp(K) / b relative. The
#: M > 1 cases are held to this many such steps.
QUANTUM_STEPS = 3
#: (preset, kw, lam, M). The M = 1 cases keep their ids.
CLASS_CASES = [
    pytest.param("duty_mix", dict(duty=0.4), 0.2, 1, id="duty_mix-kw0"),
    pytest.param("zipf_mix", dict(n_classes=4), 0.2, 1, id="zipf_mix-kw1"),
    pytest.param("harsh", {}, 0.2, 1, id="harsh-kw2"),
    pytest.param("free_rider_mix", {}, 0.2, 1, id="free_rider_mix-kw3"),
    pytest.param("zipf_mix", dict(n_classes=5), 0.05, 1, id="zipf5-M1"),
    pytest.param("zipf_mix", dict(n_classes=5), 0.05, 3, id="zipf5-M3"),
    pytest.param("harsh", {}, 0.02, 3, id="harsh-M3"),
    pytest.param("zipf_mix", dict(n_classes=5), 0.05, 4, id="zipf5-M4"),
]
#: Fields that are the configuration's own numbers, not the iteration's.
CLASS_INPUTS = ("q", "q_bar", "fracs", "N_z", "alpha_z", "Lam_z")


def _busy_step(b: float) -> float:
    """One float32 step of Lemma 1's busy probability: ulp(K), with K =
    (b + 1/b) / 2 recovered from ``b``."""
    return float(np.spacing(np.float32((b + 1.0 / b) / 2.0)))


def _carried_class_solution(rc):
    """``repro``'s class solution as the port's record (float32 tensors)."""
    return t_mf.ClassSolution(
        **{f: torch.from_numpy(np.array(getattr(rc, f)))
           for f in CLASS_FIELDS},
        converged=torch.tensor(bool(rc.converged)),
        residual=torch.tensor(float(rc.residual)))


@pytest.mark.parametrize("name,kw,lam,M", CLASS_CASES)
def test_class_solvers_equal_repro(name, kw, lam, M):
    """At M = 1 every field within rtol 1e-5 and o(τ) within atol 1e-5;
    Zipf-5 at λ = 0.05 is exact since ``gain`` is contracted as XLA does.
    At M > 1 the fixed point is held to ``QUANTUM_STEPS`` steps of the busy
    probability's float32 grid (``a`` to that many (1 - a) ulp(K) / b, the
    derived fields to that many ulp(K) / b), and the DDE to atol 1e-5 on
    ``repro``'s own fixed point, carried across."""
    rp, p = r_paper_params(lam=lam, M=M), paper_params(lam=lam, M=M)
    r_fc, t_fc = getattr(rff, name)(**kw), getattr(tff, name)(**kw)
    rc = r_mf.solve_fixed_point_classes(rp, CM_R, faults=r_fc, strict=True)
    tc = t_mf.solve_fixed_point_classes(p, CM_T, faults=t_fc, strict=True)
    b = float(np.asarray(rc.b)[0])
    steps = QUANTUM_STEPS * _busy_step(b) / b
    for f in CLASS_FIELDS:
        want, got = np.asarray(getattr(rc, f)), getattr(tc, f).numpy()
        assert got.shape == want.shape and got.dtype == want.dtype, f
        if M == 1 or f in CLASS_INPUTS:
            np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-30,
                                       err_msg=f)
        else:
            rtol = steps * (1.0 - want) if f == "a" else steps
            assert np.all(np.abs(got - want) <= rtol * np.abs(want)), (
                f, got, want, rtol)
    if (name, lam, M) == ("zipf_mix", 0.05, 1):
        _same(tc.a, rc.a, "a")
    assert bool(tc.converged) and bool(rc.converged)
    a_mean = np.asarray(rc.a_mean)
    np.testing.assert_allclose(
        tc.a_mean.numpy(), a_mean,
        rtol=1e-5 if M == 1 else float(np.max(steps * (1.0 - a_mean))))
    rd = r_dde.solve_observation_availability_classes(rp, rc, strict=True)
    td = t_dde.solve_observation_availability_classes(
        p, tc if M == 1 else _carried_class_solution(rc), strict=True)
    assert td.o.shape == rd.o.shape
    np.testing.assert_allclose(td.o.numpy(), np.asarray(rd.o), rtol=0,
                               atol=1e-5)
    np.testing.assert_allclose(td.weights.numpy(), np.asarray(rd.weights),
                               rtol=1e-6)
    np.testing.assert_allclose(td.weighted().o.numpy(),
                               np.asarray(rd.weighted().o), rtol=0,
                               atol=1e-5)
    assert bool(td.converged)
    # the faults ride p.faults too
    via_p = t_mf.solve_fixed_point_classes(p.replace(faults=t_fc), CM_T)
    assert torch.equal(via_p.a, tc.a)


def test_busy_probability_moves_in_quanta_of_ulp_k():
    """The cause of the M > 1 departures, in ``repro`` itself: for
    ``zipf_mix(5)`` at λ = 0.05, M = 3, every b its class solver returns
    after 199-202 steps is a whole number of ulp(K), and ``repro``'s own
    availabilities wander across those steps by more than the 1e-5 the
    M = 1 cases hold."""
    rp = r_paper_params(lam=0.05, M=3)
    fc = rff.zipf_mix(n_classes=5)
    bs, avail = [], []
    for iters in (199, 200, 201, 202):
        rc = r_mf.solve_fixed_point_classes(rp, CM_R, faults=fc, iters=iters)
        b = float(np.asarray(rc.b)[0])
        step = _busy_step(b)
        assert 32.0 <= (b + 1.0 / b) / 2.0 < 64.0 and step == 2.0 ** -18
        assert b / step == round(b / step), (iters, b, step)
        bs.append(b)
        avail.append(np.asarray(rc.a)[:, 0])
    assert len(set(bs)) > 1                    # b crossed a step
    avail = np.asarray(avail)
    wander = np.ptp(avail, axis=0) / avail.min(axis=0)
    assert wander.max() > 1e-5, wander


def test_class_solvers_delegate_bitwise():
    p = paper_params(lam=0.2, M=1)
    base = t_mf.solve_fixed_point(p, CM_T)
    d0 = t_dde.solve_observation_availability(p, base)
    for fc in (None, tff.always_on()):
        cs = t_mf.solve_fixed_point_classes(p, CM_T, faults=fc)
        assert cs.a.shape == (1, 1) and cs.base is not None
        _same(cs.a[0, 0], base.a)
        for f in ("b", "S", "T_S", "r", "d_M", "d_I"):
            _same(getattr(cs, f)[0], getattr(base, f), f)
        dc = t_dde.solve_observation_availability_classes(p, cs)
        assert dc.o.shape == (1, 1) + tuple(d0.o.shape)
        _same(dc.o[0, 0], d0.o)
        _same(dc.weighted().o[0], d0.o)
    # and repro's own delegation, to its solvers' tolerance
    rc = r_mf.solve_fixed_point_classes(r_paper_params(lam=0.2, M=1), CM_R)
    np.testing.assert_allclose(cs.a.numpy(), np.asarray(rc.a), rtol=1e-5)


def test_zipf_class_ranks_ordered():
    p = paper_params(lam=0.2, M=1)
    fc = tff.zipf_mix(n_classes=4)
    cs = t_mf.solve_fixed_point_classes(p, CM_T, faults=fc, strict=True)
    a = cs.a[:, 0].numpy()
    assert np.all(np.diff(a) < 0.0) and np.all((a > 0) & (a <= 1))
    assert float(cs.q_bar) == pytest.approx(
        float(np.mean([c.duty for c in fc.classes])), rel=1e-6)
    fracs, q, serves = t_mf._class_vectors(fc)
    np.testing.assert_allclose(q, tff.zipf_weights(4))
    assert np.all(serves == 1.0)


def test_class_solvers_take_zones_as_repro():
    """The configurations the single-zone port refused: ``harsh()`` across
    two zones (the class solver's zone branch), the same zones on
    ``p.zones`` with no faults (delegated to the multizone solver) and its
    DDE, against ``repro``'s (``tests/test_torch_zones.py`` holds more
    cases)."""
    kw = dict(centers=((60.0, 100.0), (140.0, 100.0)), radii=(45.0, 45.0))
    zs, rzs = ZoneSet(**kw), RZoneSet(**kw)
    geo = dict(density=DENSITY, speed=1.0)
    p, rp = paper_params(lam=0.2, M=1), r_paper_params(lam=0.2, M=1)
    tc = t_mf.solve_fixed_point_classes(p, CM_T, faults=tff.harsh(),
                                        zones=zs, **geo)
    rc = r_mf.solve_fixed_point_classes(rp, CM_R, faults=rff.harsh(),
                                        zones=rzs, **geo)
    b = np.asarray(rc.b, np.float64)
    steps = QUANTUM_STEPS * np.spacing(
        ((b + 1.0 / b) / 2.0).astype(np.float32)) / b
    for f in CLASS_FIELDS:
        want, got = np.asarray(getattr(rc, f)), getattr(tc, f).numpy()
        assert got.shape == want.shape and got.dtype == want.dtype, f
        rtol = steps * (1.0 - want) if f in ("a", "a_serve") else steps
        assert np.all(np.abs(got - want) <= rtol * np.abs(want) + 1e-30), f
    td = t_mf.solve_fixed_point_classes(p.replace(zones=zs), CM_T, **geo)
    rd = r_mf.solve_fixed_point_classes(rp.replace(zones=rzs), CM_R, **geo)
    assert isinstance(td.base, t_mf.MultizoneSolution)
    _same(td.a, rd.a, "delegated a")
    o = t_dde.solve_observation_availability_classes(p, td)
    ro = r_dde.solve_observation_availability_classes(rp, rd)
    assert o.o.shape == ro.o.shape == (1, 2, 6001)
    np.testing.assert_allclose(o.o.numpy(), np.asarray(ro.o), rtol=0,
                               atol=1e-5)