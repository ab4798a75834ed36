"""The port's Byzantine layer (``repro_torch.configs.fg_adversarial``,
``sim.faults.adv_vectors`` and the adversarial branches of ``sim.learn``)
against ``repro``'s, on the same inputs, and ``tests/test_adversarial.py``'s
invariants on the port.

1. Functions against ``repro``'s at B = 1 and B = 2 on seeded inputs:
   ``adv_vectors``; every preset's fields, properties and validation;
   ``poison_snapshots`` in each of the four modes and mixed, bit for bit
   (the noise draw included, at the default scale 2 and at 1.7, where
   XLA's folding of the constant scale into the normal's sqrt(2) shows);
   ``merge_deliveries`` with poisoned peers under no defense,
   ``robust_defense()`` and ``trimmed_defense()``: the merge stats, the
   contamination flag, counts and ages bit for bit, ``theta`` within
   ``tests/test_torch_learn.py``'s atol 1e-6 where the norm clip or the
   median makes ``merge_deliveries`` jitted alone contract otherwise than
   the simulator (the simulator's order is held bit for bit by the
   replayed runs); ``snapshot_params``, ``reset_replicas``, ``init_fields``
   and the carried-across state with the contamination carry, and
   ``learn_outputs``' two fractions bit for bit.
2. ``tests/test_adversarial.py:83-504`` on the port, but the contamination
   analytics (``:507-579``, the next slice) and the kernel tests
   (``:581-608``, held by ``tests/test_torch_merge_kernel.py``). The
   defense primitives (``:249-293``) are held bit for bit to ``repro`` by
   ``tests/test_torch_learn.py::test_defense_screens_bitwise`` and
   ``::test_trimmed_peer_median_bitwise``, and the always-armed
   non-finite guard (``:311-327``) by
   ``tests/test_torch_learn.py::test_merge_deliveries_bitwise``, whose
   inputs carry a NaN payload and an infinite count.

The whole replayed runs and sweeps are in
``tests/test_torch_adversarial_runs.py``.
"""

import dataclasses
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import fg_adversarial as rfa
from repro.configs.fg_learn import logreg_task as r_logreg
from repro.sim import faults as rfaults
from repro.sim import learn as rlearn
from repro_torch.configs import fg_adversarial as tfa
from repro_torch.configs.fg_learn import logreg_task
from repro_torch.configs.fg_paper import paper_params
from repro_torch.core.merge import DefenseConfig
from repro_torch.sim import SimConfig, faults, simulate, sweep
from repro_torch.sim import learn as tlearn
from repro_torch.sim.learn import (MS_ATTEMPT, MS_ATTEMPT_POISON, MS_DISTREJ,
                                   MS_DISTREJ_POISON, MS_NORMCLIP)

TASK_FIELDS = ("theta0", "w_true", "x_test", "y_test", "stream_key")
TAU_L = np.float32(300.0)
#: ``tests/test_adversarial.py``'s point and geometry.
P = paper_params(lam=0.05, Lam=10.0, M=1)
PROTOCOL = ("availability", "busy_frac", "stored_info", "model_holders",
            "n_in_rz", "obs_birth", "obs_holders")
LEARN_OUT = ("test_acc", "test_acc_holders", "learn_obs", "theta_var",
             "merge_stats")


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _cfg(**kw):
    base = dict(n_nodes=48, area_side=100.0, rz_radius=50.0, n_slots=320,
                sample_every=8, k_obs=32)
    base.update(kw)
    return SimConfig(**base)


def _run(cfg, seed):
    return simulate(P, cfg, seed=seed, device="cpu")


def _bits(a) -> np.ndarray:
    a = np.asarray(a)
    return a.view(np.int32) if a.dtype == np.float32 else a


def _same(got, want, what=""):
    got = got.numpy() if torch.is_tensor(got) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape and got.dtype == want.dtype, (
        what, got.shape, want.shape, got.dtype, want.dtype)
    np.testing.assert_array_equal(_bits(got), _bits(want), err_msg=what)


def _carried_task():
    r_task = rlearn.make_task(r_logreg())
    return r_task, tlearn.task_from_numpy(
        *(np.asarray(getattr(r_task, f)) for f in TASK_FIELDS))


# ------------------------------------------------- 1. functions vs repro

#: name -> (builder, kwargs)
PRESETS = {
    "honest": ("honest", {}), "signflip": ("signflip", {}),
    "signflip-scaled": ("signflip", dict(frac=0.3, scale=1.5)),
    "noise": ("noise_injector", {}),
    "noise-wide": ("noise_injector", dict(frac=0.4, scale=1.7)),
    "replay": ("stale_replay", dict(frac=0.25)),
    "liar": ("metadata_liar", {}),
    "liar-low": ("metadata_liar", dict(claimed_count=1e3)),
    "harsh": ("harsh_adversarial", {}),
    "harsh-mild": ("harsh_adversarial", dict(frac_flip=0.2, frac_liar=0.1,
                                             scale=2.0, crash_rate=0.0)),
}


def _preset(name):
    fn, kw = PRESETS[name]
    return getattr(rfa, fn)(**kw), getattr(tfa, fn)(**kw)


@pytest.mark.parametrize("name", list(PRESETS))
def test_attack_presets_and_vectors_equal_repro(name):
    r_fc, t_fc = _preset(name)
    assert isinstance(t_fc, faults.FaultConfig)
    assert dataclasses.asdict(t_fc) == dataclasses.asdict(r_fc)
    for prop in ("n_classes", "enabled", "adversarial", "adv_frac"):
        assert getattr(t_fc, prop) == getattr(r_fc, prop), prop
    for n in (1, 7, 48, 100, 200, 1025):
        got, want = faults.adv_vectors(t_fc, n), rfaults.adv_vectors(r_fc, n)
        assert set(got) == set(want)
        for k in want:
            assert got[k].dtype == want[k].dtype, k
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    assert tfa.ADV_SCALE_DEFAULT == rfa.ADV_SCALE_DEFAULT


@pytest.mark.parametrize("kw", [{}, dict(norm_clip=0.5, dist_gate=2.0),
                                dict(dist_floor=0.1, cnt_clip=0.0)])
def test_defense_presets_equal_repro(kw):
    for fn in ("robust_defense", "trimmed_defense"):
        want, got = getattr(rfa, fn)(**kw), getattr(tfa, fn)(**kw)
        assert isinstance(got, DefenseConfig)
        assert dataclasses.asdict(got) == dataclasses.asdict(want), fn
        assert got.enabled == want.enabled
    got = tfa.trimmed_defense(recent_peers=5, **kw)
    assert got.recent_peers == 5 and got.mode == "trimmed"


@pytest.mark.parametrize("preset,kw", [
    ("signflip", dict(frac=0.0)), ("signflip", dict(frac=1.0)),
    ("noise_injector", dict(frac=1.5)), ("stale_replay", dict(frac=-0.1)),
    ("metadata_liar", dict(frac=1.0)), ("signflip", dict(scale=0.0)),
    ("metadata_liar", dict(claimed_count=-1.0)),
    ("harsh_adversarial", dict(frac_flip=0.9, frac_liar=0.2)),
    ("robust_defense", dict(norm_clip=-1.0)),
    ("robust_defense", dict(dist_floor=0.0)),
    ("trimmed_defense", dict(recent_peers=0)),
])
def test_preset_validation_raises_alike(preset, kw):
    with pytest.raises(ValueError) as want:
        getattr(rfa, preset)(**kw)
    with pytest.raises(ValueError) as got:
        getattr(tfa, preset)(**kw)
    assert str(got.value) == str(want.value)


def test_attack_presets_are_protocol_trivial():
    for fc in (tfa.signflip(), tfa.noise_injector(), tfa.stale_replay(),
               tfa.metadata_liar()):
        assert not fc.enabled          # adversaries follow the protocol
        assert fc.adversarial
        assert fc.adv_frac == pytest.approx(0.1)
    assert not tfa.honest().adversarial and not tfa.honest().enabled
    harsh = tfa.harsh_adversarial()
    assert harsh.enabled and harsh.adversarial  # crash churn + attacks
    assert not DefenseConfig().enabled
    assert tfa.robust_defense().enabled
    assert tfa.trimmed_defense().mode == "trimmed"


def test_adv_vectors_partition():
    adv = faults.adv_vectors(tfa.harsh_adversarial(), 100)
    assert adv["is_adv"].sum() == 15         # 10% flip + 5% liar
    assert (adv["signflip"] | adv["liar"]).sum() == 15
    assert not (adv["signflip"] & adv["liar"]).any()
    np.testing.assert_allclose(adv["scale"][adv["liar"]], 1e6)
    assert set(tlearn.attack_tensors(adv)) == {"is_adv", "scale",
                                               "signflip", "liar"}


def _poison_inputs(rng, b, n, d):
    return dict(
        newly=rng.random((b, n)) < 0.6,
        theta_snap=rng.normal(size=(b, n, d)).astype(np.float32),
        snap_cnt=rng.uniform(1.0, 9.0, (b, n)).astype(np.float32),
        snap_age=rng.uniform(0.0, 50.0, (b, n)).astype(np.float32),
        snap_poison=rng.random((b, n)) < 0.2)


POISON_CASES = {
    "signflip": rfa.signflip(frac=0.3), "noise": rfa.noise_injector(frac=0.4),
    "noise-1.7": rfa.noise_injector(frac=0.4, scale=1.7),
    "replay": rfa.stale_replay(frac=0.3),
    "liar": rfa.metadata_liar(frac=0.3, claimed_count=1e5),
    "mixed": rfaults.FaultConfig(classes=tuple(
        rfaults.FaultClass(frac=0.2, adv_mode=m, adv_scale=s)
        for m, s in (("none", 1.0), ("signflip", 3.0), ("noise", 0.7),
                     ("replay", 1.0), ("liar", 50.0)))),
}


@pytest.mark.parametrize("b", [1, 2])
@pytest.mark.parametrize("case", list(POISON_CASES))
def test_poison_snapshots_equal_repro(case, b):
    r_fc = POISON_CASES[case]
    n = 40
    r_task, t_task = _carried_task()
    inp = _poison_inputs(np.random.default_rng(b), b, n,
                         r_task.theta0.shape[0])
    adv = rfaults.adv_vectors(r_fc, n)
    names = ("newly", "theta_snap", "snap_cnt", "snap_age", "snap_poison")
    for slot in (7, 4095):
        ref = jax.jit(partial(rlearn.poison_snapshots, adv, r_task))
        got = tlearn.poison_snapshots(
            tlearn.attack_tensors(adv), t_task, slot,
            *(torch.from_numpy(inp[k]) for k in names))
        for i in range(b):
            want = ref(jnp.int32(slot), *(inp[k][i] for k in names))
            for g, w, what in zip(got, want, names[1:]):
                _same(g[i], w, f"{case} slot {slot} row {i} {what}")
    if b == 2:   # the noise draw is the learning layer's: one for all rows
        hit = inp["newly"] & adv["is_adv"]
        assert hit.any(axis=1).all()


def _port_poison(fc, slot=7, newly=None, n=10):
    _, task = _carried_task()
    adv = faults.adv_vectors(fc, n)
    rng = np.random.default_rng(0)
    snap = torch.from_numpy(
        rng.normal(size=(1, n, task.theta0.shape[0])).astype(np.float32))
    cnt = torch.from_numpy(rng.uniform(1.0, 9.0, (1, n)).astype(np.float32))
    age = torch.from_numpy(rng.uniform(0.0, 50.0, (1, n)).astype(np.float32))
    newly = torch.ones((1, n), dtype=torch.bool) if newly is None else newly
    out = tlearn.poison_snapshots(
        tlearn.attack_tensors(adv), task, slot, newly, snap, cnt, age,
        torch.zeros((1, n), dtype=torch.bool))
    return task, adv, (snap, cnt, age), out


@pytest.mark.parametrize("fc,mode", [
    (tfa.signflip(frac=0.3, scale=4.0), "signflip"),
    (tfa.stale_replay(frac=0.3), "replay"),
    (tfa.metadata_liar(frac=0.3, claimed_count=1e5), "liar"),
])
def test_poison_modes_hit_only_adversaries(fc, mode):
    task, adv, (snap, cnt, age), out = _port_poison(fc)
    out_t, out_c, out_a, out_p = (t[0].numpy() for t in out)
    snap, cnt, age = snap[0].numpy(), cnt[0].numpy(), age[0].numpy()
    hon, bad = ~adv["is_adv"], adv[mode]
    np.testing.assert_array_equal(out_t[hon], snap[hon])
    np.testing.assert_array_equal(out_p, adv["is_adv"])
    if mode == "signflip":
        np.testing.assert_allclose(out_t[bad], -4.0 * snap[bad], rtol=1e-6)
    elif mode == "replay":
        np.testing.assert_array_equal(
            out_t[bad], np.broadcast_to(task.theta0.numpy(),
                                        (bad.sum(), snap.shape[1])))
    else:  # a liar serves honest parameters under bogus metadata
        np.testing.assert_array_equal(out_t[bad], snap[bad])
        np.testing.assert_allclose(out_c[bad], 1e5)
        np.testing.assert_allclose(out_a[bad], 0.0)
    if mode != "liar":   # metadata untouched by payload attacks
        np.testing.assert_array_equal(out_c, cnt)
        np.testing.assert_array_equal(out_a, age)


def test_poison_noise_deterministic_per_slot():
    fc = tfa.noise_injector(frac=0.4, scale=2.0)
    _, adv, (snap, _, _), a = _port_poison(fc, slot=3)
    _, _, _, b = _port_poison(fc, slot=3)
    _, _, _, c = _port_poison(fc, slot=4)
    bad = adv["noise"]
    assert torch.equal(a[0], b[0])
    assert not torch.equal(a[0][0, bad], c[0][0, bad])
    assert torch.equal(a[0][0, ~bad], snap[0, ~bad])


def test_poison_skips_nodes_without_new_connection():
    _, _, (snap, _, _), out = _port_poison(
        tfa.signflip(frac=0.5), slot=0, newly=torch.zeros((1, 10),
                                                           dtype=torch.bool))
    assert torch.equal(out[0], snap)
    assert not out[3].any()


def _merge_inputs(seed, b, n=64, d=34, recent=3):
    """Receivers, senders and snapshots where a quarter of the payloads are
    poisoned (sign-flipped and amplified 4x, as ``signflip()`` serves)."""
    rng = np.random.default_rng(seed)
    theta = (rng.normal(size=(b, n, d)) * 0.4).astype(np.float32)
    snap = (rng.normal(size=(b, n, d)) * 0.4).astype(np.float32)
    snap_poison = rng.random((b, n)) < 0.25
    snap[snap_poison] *= np.float32(-4.0)
    cnt = rng.uniform(0, 20, (b, n)).astype(np.float32)
    return dict(
        received=rng.random((b, n)) < 0.7,
        pidx=rng.integers(0, n, (b, n)).astype(np.int32),
        theta=theta, theta_cnt=cnt,
        theta_age=rng.uniform(0, 400, (b, n)).astype(np.float32),
        theta_snap=snap, snap_cnt=(cnt * 3)[:, ::-1].copy(),
        snap_age=rng.uniform(0, 400, (b, n)).astype(np.float32),
        merge_stats=rng.integers(0, 9, (b, 6)).astype(np.int32),
        poisoned=rng.random((b, n)) < 0.1, snap_poison=snap_poison,
        peer_buf=rng.normal(size=(b, n, recent, d)).astype(np.float32),
        peer_fill=rng.integers(0, 7, (b, n)).astype(np.int32))


MERGE_DEFENSES = {"none": None, "robust": "robust_defense",
                  "trimmed": "trimmed_defense"}


@pytest.mark.parametrize("b", [1, 2])
@pytest.mark.parametrize("defense", list(MERGE_DEFENSES))
def test_merge_deliveries_with_poisoned_peers_equal_repro(defense, b):
    fn = MERGE_DEFENSES[defense]
    r_lc = dataclasses.replace(
        r_logreg(), defense=getattr(rfa, fn)() if fn else None)
    t_lc = dataclasses.replace(
        logreg_task(), defense=getattr(tfa, fn)() if fn else None)
    inp = _merge_inputs(b, b)
    args = ("received", "pidx", "theta", "theta_cnt", "theta_age",
            "theta_snap", "snap_cnt", "snap_age")
    extra = ("poisoned", "snap_poison") + (
        ("peer_buf", "peer_fill") if defense == "trimmed" else ())

    def ref(*a, merge_stats, **kw):
        return rlearn.merge_deliveries(r_lc, *a, TAU_L,
                                       merge_stats=merge_stats, **kw)

    got = tlearn.merge_deliveries(
        t_lc, *(torch.from_numpy(inp[k]) for k in args), float(TAU_L),
        merge_stats=torch.from_numpy(inp["merge_stats"]),
        **{k: torch.from_numpy(inp[k]) for k in extra})
    stats = np.zeros(6, np.int64)
    for i in range(b):
        want = jax.jit(ref)(*(inp[k][i] for k in args),
                            merge_stats=inp["merge_stats"][i],
                            **{k: inp[k][i] for k in extra})
        assert set(got) == set(want)
        for k in want:
            if k == "theta" and defense != "none":
                np.testing.assert_allclose(got[k][i].numpy(),
                                           np.asarray(want[k]), rtol=0,
                                           atol=1e-6)
            else:
                _same(got[k][i], want[k], f"{defense} row {i} {k}")
        stats += np.asarray(want["merge_stats"]) - inp["merge_stats"][i]
    assert stats[MS_ATTEMPT_POISON] > 0                  # poison arrived
    if defense != "none":
        assert stats[MS_NORMCLIP] > 0 and stats[MS_DISTREJ_POISON] > 0
    # the flag spreads only through accepted poisoned payloads
    newly = got["poisoned"].numpy() & ~inp["poisoned"]
    peer = np.take_along_axis(inp["snap_poison"], inp["pidx"], 1)
    assert newly.any() and np.all(peer[newly] & inp["received"][newly])


@pytest.mark.parametrize("b", [1, 2])
def test_snapshot_reset_and_init_with_poison_equal_repro(b):
    inp = _merge_inputs(11 + b, b)
    rng = np.random.default_rng(b)
    newly = rng.random((b, 64)) < 0.3
    drop = rng.random((b, 64)) < 0.3
    names = ("theta", "theta_cnt", "theta_age", "theta_snap", "snap_cnt",
             "snap_age")
    got_s = tlearn.snapshot_params(
        torch.from_numpy(newly), *(torch.from_numpy(inp[k]) for k in names),
        poisoned=torch.from_numpy(inp["poisoned"]),
        snap_poison=torch.from_numpy(inp["snap_poison"]))
    theta0 = rng.normal(size=34).astype(np.float32)
    got_r = tlearn.reset_replicas(
        torch.from_numpy(drop), *(torch.from_numpy(inp[k])
                                  for k in names[:3]),
        torch.from_numpy(theta0), poisoned=torch.from_numpy(inp["poisoned"]),
        peer_fill=torch.from_numpy(inp["peer_fill"]))
    for i in range(b):
        want = jax.jit(partial(rlearn.snapshot_params))(
            newly[i], *(inp[k][i] for k in names),
            poisoned=inp["poisoned"][i], snap_poison=inp["snap_poison"][i])
        assert len(got_s) == len(want) == 4
        for g, w in zip(got_s, want):
            _same(g[i], w)
        want = jax.jit(rlearn.reset_replicas)(
            drop[i], *(inp[k][i] for k in names[:3]), theta0,
            poisoned=inp["poisoned"][i], peer_fill=inp["peer_fill"][i])
        assert set(got_r) == set(want)
        for k in want:
            _same(got_r[k][i], want[k], k)
    r_lc = dataclasses.replace(r_logreg(), defense=rfa.trimmed_defense())
    t_lc = dataclasses.replace(logreg_task(), defense=tfa.trimmed_defense())
    want = rlearn.init_fields(r_lc, 12, fc=rfa.signflip())
    _, task = _carried_task()
    got = tlearn.init_fields(t_lc, task, b, 12, fc=tfa.signflip())
    assert set(got) == set(want)
    for k in want:
        for i in range(b):
            _same(got[k][i], want[k], k)
    carried = tlearn.fields_from_numpy({k: np.asarray(v)
                                        for k, v in want.items()})
    assert set(carried) == set(want)
    for fc in (None, tfa.honest(), faults.FaultConfig(crash_rate=0.01)):
        assert "poisoned" not in tlearn.init_fields(t_lc, task, b, 12, fc=fc)


def test_sim_state_with_poison_carried_across():
    """``state_from_numpy`` carries ``repro``'s contamination carry, which
    equals the port's own initial state, and carries it back."""
    from repro.sim import SimConfig as RCfg
    from repro.sim.mobility import get_mobility as rget
    from repro.sim.state import init_sim_state as r_init_state
    from repro_torch.sim.state import (init_sim_state, state_from_numpy,
                                       state_to_numpy)

    geom = dict(n_nodes=48, area_side=100.0, rz_radius=50.0)
    r_cfg = RCfg(**geom, learn=r_logreg(), faults=rfa.harsh_adversarial())
    t_cfg = SimConfig(**geom, learn=logreg_task(),
                      faults=tfa.harsh_adversarial())
    mob, _ = rget("rdm").init(jax.random.PRNGKey(1), r_cfg)
    zone0 = np.ones(48, np.uint32)
    state = r_init_state(mob, zone0, M=1, cfg=r_cfg)
    fields = {f.name: np.asarray(getattr(state, f.name))
              for f in dataclasses.fields(state)
              if f.name != "mob" and getattr(state, f.name) is not None}
    fields["mob"] = {f.name: np.asarray(getattr(mob, f.name))
                     for f in dataclasses.fields(mob)}
    assert {"poisoned", "snap_poison", "availw"} <= set(fields)
    carried = state_from_numpy(fields, "cpu")
    _, task = _carried_task()
    own = init_sim_state(carried.mob, torch.from_numpy(
        zone0.view(np.int32)[None]), M=1, cfg=t_cfg, task=task)
    for name in tlearn.LEARN_FIELDS[:7] + tlearn.ATTACK_FIELDS:
        a, b = getattr(carried, name), getattr(own, name)
        assert a.dtype == b.dtype and torch.equal(a, b), name
    back = state_to_numpy(carried, t_cfg)
    for k in ("poisoned", "snap_poison"):
        assert back[k].dtype == fields[k].dtype
        np.testing.assert_array_equal(back[k], fields[k])


@pytest.mark.parametrize("b", [1, 2])
def test_learn_outputs_poisoned_fractions_equal_repro(b):
    r_task, t_task = _carried_task()
    rng = np.random.default_rng(13 + b)
    n = 50
    fc = rfa.harsh_adversarial()
    cls1h = rfaults.class_onehot(fc, n)
    theta = (rng.normal(size=(b, n, 34)) * 0.5).astype(np.float32)
    cnt = rng.uniform(0, 20, (b, n)).astype(np.float32)
    has = rng.random((b, n, 1)) < 0.6
    in_rz = rng.random((b, n)) < 0.8
    poisoned = rng.random((b, n)) < 0.3
    ms = rng.integers(0, 9, (b, 6)).astype(np.int32)
    got = tlearn.learn_outputs(
        logreg_task(), t_task, *(torch.from_numpy(a)
                                 for a in (theta, cnt, has, in_rz)),
        merge_stats=torch.from_numpy(ms),
        poisoned=torch.from_numpy(poisoned), cls1h=torch.from_numpy(cls1h))
    ref = jax.jit(partial(rlearn.learn_outputs, r_logreg(), r_task,
                          cls1h=jnp.asarray(cls1h)))
    for i in range(b):
        want = ref(theta[i], cnt[i], has[i], in_rz[i], merge_stats=ms[i],
                   poisoned=poisoned[i])
        assert set(got) == set(want)
        for k in ("poisoned_frac", "poisoned_frac_c", "merge_stats"):
            _same(got[k][i], want[k], k)
        for k in ("test_acc", "test_acc_holders", "learn_obs", "theta_var"):
            np.testing.assert_allclose(got[k][i].numpy(), np.asarray(want[k]),
                                       rtol=1e-5, atol=1e-6, err_msg=k)
        assert 0.0 < float(want["poisoned_frac"]) < 1.0


def test_zero_holder_sample_pins_finite():
    """A sample without holders falls back (population accuracy, zeros)
    and never NaNs the holder-conditioned telemetry."""
    _, task = _carried_task()
    n = 6
    out = tlearn.learn_outputs(
        logreg_task(), task, torch.ones((1, n, 34)), torch.zeros((1, n)),
        torch.zeros((1, n, 1), dtype=torch.bool),
        torch.ones((1, n), dtype=torch.bool),
        merge_stats=torch.zeros((1, 6), dtype=torch.int32),
        poisoned=torch.ones((1, n), dtype=torch.bool),
        cls1h=torch.ones((n, 1), dtype=torch.bool))
    for k in ("test_acc", "test_acc_holders", "learn_obs", "theta_var",
              "poisoned_frac", "poisoned_frac_c"):
        assert torch.isfinite(out[k]).all(), k
    assert out["test_acc_holders"].item() == out["test_acc"].item()
    assert out["learn_obs"].item() == 0.0
    assert out["poisoned_frac"].item() == 0.0
    assert out["poisoned_frac_c"].shape == (1, 1)


# ------------------------------------------------- merge screens, port only

def _merge_args(n=4, defense=None):
    lc = dataclasses.replace(logreg_task(), defense=defense)
    d = lc.param_dim
    zeros = torch.zeros((1, n))
    return lc, dict(
        received=torch.ones((1, n), dtype=torch.bool),
        pidx=torch.arange(n, dtype=torch.int32).flip(0)[None],
        theta=torch.full((1, n, d), 0.1), theta_cnt=zeros + 2.0,
        theta_age=zeros.clone(), theta_snap=torch.full((1, n, d), 0.2),
        snap_cnt=zeros + 2.0, snap_age=zeros.clone(), tau_l=300.0,
        merge_stats=torch.zeros((1, 6), dtype=torch.int32))


def _merge(lc, kw):
    pos = ("received", "pidx", "theta", "theta_cnt", "theta_age",
           "theta_snap", "snap_cnt", "snap_age", "tau_l")
    return tlearn.merge_deliveries(lc, *(kw.pop(k) for k in pos), **kw)


def test_distance_gate_rejects_and_attributes():
    lc, kw = _merge_args(defense=DefenseConfig(dist_gate=1.0,
                                               dist_floor=0.05))
    kw["theta_snap"][0, 3] = 50.0                  # far-off payload, row 0
    kw["snap_poison"] = torch.tensor([[False, False, False, True]])
    kw["poisoned"] = torch.zeros((1, 4), dtype=torch.bool)
    out = _merge(lc, kw)
    ms = out["merge_stats"][0]
    assert ms[MS_DISTREJ] == 1 and ms[MS_DISTREJ_POISON] == 1
    assert ms[MS_ATTEMPT_POISON] == 1
    torch.testing.assert_close(out["theta"][0, 0],
                               torch.full((34,), 0.1))     # kept
    # the rejected poisoned payload did not contaminate its receiver
    assert not bool(out["poisoned"][0, 0])
    # the accepted (clean, near) merges moved their receivers
    assert not torch.allclose(out["theta"][0, 1], torch.full((34,), 0.1))


def test_norm_clip_counts_and_bounds_energy():
    lc, kw = _merge_args(defense=DefenseConfig(norm_clip=0.5))
    kw["theta_snap"] = kw["theta_snap"] * 100.0     # all over-norm
    out = _merge(lc, kw)
    assert out["merge_stats"][0, MS_NORMCLIP] == 4
    # the merged replica combines own and the *clipped* payload
    assert torch.all(torch.linalg.vector_norm(out["theta"], dim=-1) <= 0.6)


def test_disabled_defense_merges_bitwise_undefended():
    outs = [_merge(*_merge_args(defense=dc)) for dc in (DefenseConfig(),
                                                        None)]
    for k in ("theta", "theta_cnt", "theta_age", "merge_stats"):
        assert torch.equal(outs[0][k], outs[1][k]), k


# ----------------------------------------- port runs: the engine invariants

@pytest.fixture(scope="module")
def adv_runs():
    """The clean run, an undefended and a defended ``signflip(0.15)`` run
    (port only, seed 0)."""
    cfg = _cfg(learn=logreg_task())
    base = _run(cfg, 0)
    atk = dataclasses.replace(cfg, faults=tfa.signflip(frac=0.15))
    undef = _run(atk, 0)
    dfd = _run(dataclasses.replace(atk, learn=dataclasses.replace(
        cfg.learn, defense=tfa.robust_defense())), 0)
    return base, undef, dfd, atk


def test_attack_leaves_protocol_bitwise(adv_runs):
    """Attackers follow the protocol: every protocol trace of an attacked
    run equals the clean run's bit for bit."""
    base, undef, dfd, _ = adv_runs
    for out in (undef, dfd):
        for f in PROTOCOL:
            np.testing.assert_array_equal(getattr(base, f), getattr(out, f),
                                          err_msg=f)
    assert base.poisoned_frac is None and base.poisoned_frac_c is None


def test_adversarial_run_deterministic(adv_runs):
    _, undef, _, atk = adv_runs
    again = _run(atk, 0)
    for f in ("test_acc", "poisoned_frac", "poisoned_frac_c", "merge_stats"):
        np.testing.assert_array_equal(getattr(undef, f), getattr(again, f),
                                      err_msg=f)


def test_contamination_telemetry_sane(adv_runs):
    _, undef, _, _ = adv_runs
    pf = undef.poisoned_frac
    assert pf.shape == undef.test_acc.shape and pf.dtype == np.float32
    assert np.all((pf >= 0.0) & (pf <= 1.0))
    assert pf[-1] > pf[len(pf) // 4]          # the contamination spreads
    assert undef.poisoned_frac_c.shape == (pf.shape[0], 2)
    ms = undef.merge_stats
    assert ms.shape == (pf.shape[0], tlearn.N_MERGE_STATS)
    assert np.all(np.diff(ms, axis=0) >= 0)   # cumulative counters
    assert np.all(ms[:, MS_ATTEMPT_POISON] <= ms[:, MS_ATTEMPT])
    assert ms[-1, MS_ATTEMPT_POISON] > 0


def test_defense_reduces_contamination(adv_runs):
    _, undef, dfd, _ = adv_runs
    assert dfd.poisoned_frac[-5:].mean() < undef.poisoned_frac[-5:].mean()
    assert dfd.merge_stats[-1, MS_DISTREJ_POISON] > 0


@pytest.mark.parametrize("backend", ["dense", "cells"])
def test_zero_rate_defense_off_bitwise(backend):
    """``honest()`` faults and a disabled ``DefenseConfig`` run the
    undefended program bit for bit and report no Byzantine telemetry."""
    cfg = _cfg(n_slots=160, learn=logreg_task(), contact_backend=backend)
    base = _run(cfg, 3)
    zz = _run(dataclasses.replace(cfg, faults=tfa.honest(), learn=(
        dataclasses.replace(cfg.learn, defense=DefenseConfig()))), 3)
    for f in PROTOCOL + LEARN_OUT:
        np.testing.assert_array_equal(getattr(base, f), getattr(zz, f),
                                      err_msg=f)
    assert zz.poisoned_frac is None and zz.poisoned_frac_c is None


def test_attack_without_learning_is_the_plain_run():
    """Without learning there is no payload to poison: an attack-only
    config runs the ``faults=None`` program bit for bit."""
    cfg = _cfg(n_slots=160)
    base = _run(cfg, 4)
    atk = _run(dataclasses.replace(cfg, faults=tfa.signflip()), 4)
    for f in PROTOCOL:
        np.testing.assert_array_equal(getattr(base, f), getattr(atk, f),
                                      err_msg=f)
    assert atk.poisoned_frac is None and atk.test_acc is None


def test_trimmed_defense_runs_and_carries_buffer():
    cfg = _cfg(n_slots=160, faults=tfa.signflip(frac=0.15),
               learn=dataclasses.replace(logreg_task(),
                                         defense=tfa.trimmed_defense()))
    out = _run(cfg, 1)
    assert np.all(np.isfinite(out.test_acc))
    assert np.all(out.poisoned_frac <= 1.0)
    assert out.merge_stats[-1, MS_ATTEMPT] > 0


def test_harsh_preset_runs_both_fault_gates():
    """``harsh_adversarial`` arms the protocol faults (crashes) and the
    attacks: the crash reset of the contamination flag rides the fault
    drop path."""
    cfg = _cfg(n_slots=160, faults=tfa.harsh_adversarial(),
               learn=dataclasses.replace(logreg_task(),
                                         defense=tfa.robust_defense()))
    out = _run(cfg, 2)
    assert np.all(np.isfinite(out.test_acc))
    pf = out.poisoned_frac
    assert np.all((pf >= 0.0) & (pf <= 1.0))
    assert out.poisoned_frac_c.shape == (pf.shape[0], 3)
    assert out.fault_events is not None       # protocol faults active


def test_no_holder_warmup_sweep_stays_finite():
    """An 80-slot run ends before the model reaches an in-zone holder, so
    with ``warmup_frac=0`` every reduced sample has no holder: the masked
    means fall back and never NaN the reductions."""
    cfg = _cfg(n_slots=80, faults=tfa.signflip(frac=0.15),
               learn=logreg_task())
    summ = sweep.run([P], cfg, (0,), reduce="mean", warmup_frac=0.0,
                     device="cpu")
    for k in ("test_acc", "test_acc_holders", "learn_obs", "theta_var",
              "poisoned_frac", "poisoned_frac_c"):
        assert np.all(np.isfinite(summ.stats[k])), k
    np.testing.assert_allclose(summ.stats["test_acc_holders"],
                               summ.stats["test_acc"], rtol=1e-6)
    np.testing.assert_allclose(summ.stats["learn_obs"], 0.0)
    np.testing.assert_allclose(summ.stats["poisoned_frac"], 0.0)


def test_byzantine_telemetry_rides_sweep_reduction():
    cfg = _cfg(n_slots=160, faults=tfa.signflip(frac=0.15),
               learn=dataclasses.replace(logreg_task(),
                                         defense=tfa.robust_defense()))
    summ = sweep.run([P], cfg, (0, 1), reduce="mean", warmup_frac=0.25,
                     device="cpu")
    for k in ("poisoned_frac", "poisoned_frac_c", "poisoned_frac_std"):
        assert k in summ.stats, k
        assert np.all(np.isfinite(summ.stats[k]))
    assert summ.stats["poisoned_frac"].shape == (1, 2)
    assert summ.stats["poisoned_frac_c"].shape == (1, 2, 2)
    assert summ.stats["merge_stats"].shape == (1, 2, tlearn.N_MERGE_STATS)


def test_adversarial_sweep_checkpoint_resume_bitwise(tmp_path):
    ps = [P, paper_params(lam=0.02, Lam=10.0, M=1)]
    cfg = _cfg(n_slots=160, faults=tfa.signflip(frac=0.15),
               learn=dataclasses.replace(logreg_task(),
                                         defense=tfa.robust_defense()))
    ck = str(tmp_path / "ck")
    s1 = sweep.run(ps, cfg, (0,), reduce="mean", chunk_size=1,
                   checkpoint_dir=ck, device="cpu")
    s2 = sweep.run(ps, cfg, (0,), reduce="mean", chunk_size=1,
                   checkpoint_dir=ck, resume=True, device="cpu")
    assert all(v.get("resumed") for v in s2.telemetry["chunks"].values())
    assert {"poisoned_frac", "poisoned_frac_c"} <= set(s1.stats)
    for k in s1.stats:
        np.testing.assert_array_equal(s1.stats[k], s2.stats[k], err_msg=k)
