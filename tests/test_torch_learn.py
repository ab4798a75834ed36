"""The port's Gossip-Learning layer against ``repro``'s, on the same inputs.

* ``make_task`` draws the same task bit for bit; ``tiny_*`` and ``sgd``
  agree to float32 rounding (matmul sums in another order: rtol 1e-5).
* ``merge_weights``, the defense screens, ``merge_deliveries``,
  ``snapshot_params`` and ``reset_replicas`` equal the jitted reference bit
  for bit on carried-across inputs, for the uniform and obs_count policies,
  each defense knob and trimmed mode with an even median count; the
  staleness policy goes through ``exp``: its weights are held to 2 ulp
  (rtol 3e-7) and its merged parameters to atol 1e-6.
  XLA contracts the merge's multiply-add by what it fuses it with: where
  ``merge_deliveries`` jitted alone picks another order than the simulator
  (the norm clip, obs_count in trimmed mode), its parameters are held to
  atol 1e-6 and every other output bit for bit; the simulator's own orders
  are pinned bit for bit inside replayed runs (see the engine section).
* ``stream_batches`` draws the same minibatches bit for bit, and
  ``train_completions`` steps on them to within rtol 1e-5 / atol 1e-6
  (gradients sum in another order).
* A replayed engine run at ``tests/test_sim_learn.py``'s geometry (N = 48,
  480 slots) equals ``repro.simulate(..., learn=...)`` bit for bit on every
  protocol trace and on ``merge_stats``; its learning traces are within
  rtol 1e-5 / atol 1e-6 of the reference's (``check_replayed_learning_run``,
  run from ``tests/test_torch_learn_runs_a.py`` and ``_b.py``).
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
from repro.configs.fg_learn import mlp_task as r_mlp
from repro.configs.fg_learn import policy_grid as r_policy_grid
from repro.configs.fg_paper import paper_params as r_paper_params
from repro.core import merge as rmerge
from repro.models import tiny as rtiny
from repro.optim.optimizers import sgd as r_sgd
from repro.sim import SimConfig as RCfg
from repro.sim import learn as rlearn
from repro.sim import simulate as r_simulate
from repro.sim.mobility import get_mobility as rget
from repro_torch.configs.fg_learn import logreg_task, mlp_task, policy_grid
from repro_torch.configs.fg_paper import paper_params
from repro_torch.core import merge as tmerge
from repro_torch.models import tiny
from repro_torch.optim.optimizers import sgd
from repro_torch.sim import SimConfig, simulate
from repro_torch.sim import learn as tlearn

GEOM = dict(n_nodes=48, area_side=100.0, rz_radius=50.0, n_slots=480,
            sample_every=8, k_obs=32)
PROTOCOL = ("t", "availability", "busy_frac", "stored_info", "obs_birth",
            "obs_holders", "model_holders", "n_in_rz", "availability_z",
            "stored_info_z", "n_in_rz_z", "merge_stats")
LEARNING = ("test_acc", "test_acc_holders", "learn_obs", "theta_var")
TASK_FIELDS = ("theta0", "w_true", "x_test", "y_test", "stream_key")
TAU_L = np.float32(300.0)


@pytest.fixture(autouse=True)
def one_thread():
    """One torch thread a test: with JAX's thread pool in the same process
    and the other test workers beside it, torch's intra-op threads made
    these small-op runs several times slower."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture
def working_barrier():
    """The seed's ``shared_barrier`` fails on this jax (TypeError in its
    vmap-rule registration); the barrier is the identity, so the reference
    runs the barrier it wraps while a test needs it."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(rcompute, "shared_barrier", jax.lax.optimization_barrier)
        mp.setattr(robs, "shared_barrier", jax.lax.optimization_barrier)
        yield


def _pair(lc_kw=None, defense=None, model="logreg"):
    """The same LearnConfig in both packages."""
    kw = dict(lc_kw or {})
    r_lc = (r_logreg if model == "logreg" else r_mlp)(**kw)
    t_lc = (logreg_task if model == "logreg" else mlp_task)(**kw)
    if defense is not None:
        r_lc = dataclasses.replace(r_lc, defense=rmerge.DefenseConfig(**defense))
        t_lc = dataclasses.replace(t_lc, defense=tmerge.DefenseConfig(**defense))
    return r_lc, t_lc


def _carried_task(r_lc):
    task = rlearn.make_task(r_lc)
    return task, tlearn.task_from_numpy(
        *(np.asarray(getattr(task, f)) for f in TASK_FIELDS))


def _t(a):
    """numpy -> torch with a leading batch axis of 1."""
    return torch.from_numpy(np.array(a)[None])


def _bits(a) -> np.ndarray:
    a = np.asarray(a)
    return a.view(np.int32) if a.dtype == np.float32 else a


def _equal(got: torch.Tensor, want, name=""):
    got = got[0].numpy()
    want = np.asarray(want)
    assert got.dtype == want.dtype and got.shape == want.shape, name
    np.testing.assert_array_equal(_bits(got), _bits(want), err_msg=name)


# ---------------------------------------------------------------- task, model

@pytest.mark.parametrize("model,seed", [("logreg", 0), ("mlp", 0),
                                        ("logreg", 5)])
def test_make_task_equals_repro_bitwise(model, seed):
    r_lc, t_lc = _pair(dict(data_seed=seed), model=model)
    want = rlearn.make_task(r_lc)
    got = tlearn.make_task(t_lc)
    for f in TASK_FIELDS:
        w, g = np.asarray(getattr(want, f)), getattr(got, f).numpy()
        if f == "stream_key":
            g = g.astype(np.uint32)
        assert g.dtype == w.dtype and g.shape == w.shape, f
        np.testing.assert_array_equal(g, w, err_msg=f)


def test_presets_match_repro():
    pairs = [(r_logreg(), logreg_task()), (r_mlp(), mlp_task()),
             (r_logreg(merge_policy="uniform", lr=0.1),
              logreg_task(merge_policy="uniform", lr=0.1))]
    pairs += list(zip(r_policy_grid(), policy_grid()))
    for r_lc, t_lc in pairs:
        for f in dataclasses.fields(r_lc):
            assert getattr(t_lc, f.name) == getattr(r_lc, f.name), f.name
        assert t_lc.param_dim == r_lc.param_dim


@pytest.mark.parametrize("model", ["logreg", "mlp"])
def test_tiny_functions_within_rounding(model):
    spec_kw = dict(model=model, n_features=16, n_classes=3, hidden=8)
    rspec, tspec = rtiny.TinySpec(**spec_kw), tiny.TinySpec(**spec_kw)
    assert tiny.param_dim(tspec) == rtiny.param_dim(rspec)
    rng = np.random.default_rng(1)
    theta = rng.normal(size=(5, rtiny.param_dim(rspec))).astype(np.float32)
    x = rng.normal(size=(12, 16)).astype(np.float32)
    y = rng.integers(0, 3, 12).astype(np.int32)
    th, xt, yt = (torch.from_numpy(a) for a in (theta, x, y))
    np.testing.assert_allclose(
        tiny.tiny_logits(tspec, th, xt).numpy(),
        np.asarray(jax.jit(partial(rtiny.tiny_logits, rspec))(theta, x)),
        rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(
        tiny.tiny_loss(tspec, th[0], xt, yt).numpy(),
        np.asarray(jax.jit(partial(rtiny.tiny_loss, rspec))(theta[0], x, y)),
        rtol=1e-5, atol=1e-6)
    np.testing.assert_array_equal(
        tiny.tiny_accuracy(tspec, th, xt, yt).numpy(),
        np.asarray(jax.jit(partial(rtiny.tiny_accuracy, rspec))(theta, x, y)))
    r_init = rtiny.init_theta(jax.random.PRNGKey(3), rspec)
    from repro_torch import random as tr
    np.testing.assert_array_equal(
        tiny.init_theta(tr.PRNGKey(3), tspec).numpy(), np.asarray(r_init))


@pytest.mark.parametrize("momentum", [0.0, 0.9])
def test_sgd_steps_like_repro(momentum):
    rng = np.random.default_rng(2)
    p = rng.normal(size=(7, 34)).astype(np.float32)
    grads = [rng.normal(size=(7, 34)).astype(np.float32) for _ in range(3)]
    r_opt, t_opt = r_sgd(0.3, momentum=momentum), sgd(0.3, momentum=momentum)
    rp, rs = jnp.asarray(p), r_opt.init(jnp.asarray(p))
    tp, ts = torch.from_numpy(p), t_opt.init(torch.from_numpy(p))
    for step, g in enumerate(grads):
        rp, rs = jax.jit(r_opt.update)(jnp.asarray(g), rs, rp,
                                       jnp.asarray(step))
        tp, ts = t_opt.update(torch.from_numpy(g), ts, tp, step)
    np.testing.assert_allclose(tp.numpy(), np.asarray(rp), rtol=1e-6,
                               atol=1e-7)


# ----------------------------------------------------------- merge primitives

def _counts(rng, n):
    c = rng.uniform(0, 20, n).astype(np.float32)
    c[rng.random(n) < 0.2] = 0.0
    return c


@pytest.mark.parametrize("policy", ["uniform", "obs_count"])
def test_merge_weights_bitwise(policy):
    rng = np.random.default_rng(3)
    args = [_counts(rng, 300), _counts(rng, 300),
            rng.uniform(0, 500, 300).astype(np.float32),
            rng.uniform(0, 500, 300).astype(np.float32)]
    want = jax.jit(partial(rmerge.merge_weights, policy),
                   static_argnums=())(*args, TAU_L)
    got = tmerge.merge_weights(policy, *(torch.from_numpy(a) for a in args),
                               float(TAU_L))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(
            _bits(g.numpy()), _bits(np.broadcast_to(np.asarray(w), (300,))))


def test_merge_weights_staleness_within_two_ulp():
    rng = np.random.default_rng(4)
    a, b = (rng.uniform(0, 2000, 500).astype(np.float32) for _ in range(2))
    c = np.zeros(500, np.float32)
    want = jax.jit(partial(rmerge.merge_weights, "staleness"))(c, c, a, b,
                                                               TAU_L)
    got = tmerge.merge_weights("staleness", *(torch.from_numpy(v)
                                              for v in (c, c, a, b)),
                               float(TAU_L))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=3e-7,
                                   atol=0)


def test_obs_count_copies_the_fractional_count_defect():
    """``merge_weights("obs_count")`` divides by ``max(tot, 1)``: equal counts
    of 0.25 give w_own = 0.25, not 0.5 (both packages; reachable only
    through a fractional ``cnt_clip``)."""
    q = np.full(3, 0.25, np.float32)
    z = np.zeros(3, np.float32)
    want, _ = rmerge.merge_weights("obs_count", q, q, z, z, TAU_L)
    got, _ = tmerge.merge_weights("obs_count", *(torch.from_numpy(v)
                                                 for v in (q, q, z, z)),
                                  float(TAU_L))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert np.all(got.numpy() == 0.25)


@pytest.mark.parametrize("d", [34, 306])
def test_defense_screens_bitwise(d):
    rng = np.random.default_rng(d)
    own = (rng.normal(size=(400, d)) * rng.uniform(0, 2, (400, 1))
           ).astype(np.float32)
    own[:20] *= np.float32(1e-4)                     # cold replicas
    peer = (own + rng.normal(size=(400, d)) * rng.uniform(0, 3, (400, 1))
            ).astype(np.float32)
    radius = float(np.median(np.linalg.norm(peer, axis=1)))
    t_own, t_peer = torch.from_numpy(own), torch.from_numpy(peer)
    want = jax.jit(partial(rmerge.norm_clip_factors, radius=radius))(peer)
    got = tmerge.norm_clip_factors(t_peer, radius)
    np.testing.assert_array_equal(_bits(got.numpy()), _bits(want))
    assert 0 < np.mean(np.asarray(want) < 1) < 1
    want = jax.jit(partial(rmerge.distance_accept, gate=0.8,
                           floor=1e-3))(own, peer)
    got = tmerge.distance_accept(t_own, t_peer, 0.8, 1e-3)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert 0 < np.mean(np.asarray(want)) < 1
    oc, pc = _counts(rng, 400), _counts(rng, 400) * 10
    want = jax.jit(partial(rmerge.clip_peer_counts, clip=2.5))(oc, pc)
    got = tmerge.clip_peer_counts(torch.from_numpy(oc), torch.from_numpy(pc),
                                  2.5)
    np.testing.assert_array_equal(_bits(got.numpy()), _bits(want))


@pytest.mark.parametrize("recent", [3, 2, 1])
def test_trimmed_peer_median_bitwise(recent):
    """``recent_peers = 3`` gives an even count of 4: the median is the mean
    of the middle pair, as ``jnp.median`` takes it."""
    rng = np.random.default_rng(recent)
    own = rng.normal(size=(60, 34)).astype(np.float32)
    buf = rng.normal(size=(60, recent, 34)).astype(np.float32)
    fill = rng.integers(0, 2 * recent + 1, 60).astype(np.int32)
    want = jax.jit(rmerge.trimmed_peer)(own, buf, fill)
    got = tmerge.trimmed_peer(*(torch.from_numpy(a) for a in (own, buf, fill)))
    np.testing.assert_array_equal(_bits(got.numpy()), _bits(want))
    if recent == 3:
        lower = torch.cat([torch.from_numpy(own)[:, None],
                           torch.from_numpy(buf)], 1).median(1).values
        assert not torch.equal(lower, got)


# ------------------------------------------------------------ layer functions

def _layer_inputs(d, seed, n=64, recent=3):
    rng = np.random.default_rng(seed)
    theta = rng.normal(size=(n, d)).astype(np.float32)
    snap = (rng.normal(size=(n, d)) * rng.uniform(0.2, 4, (n, 1))
            ).astype(np.float32)
    snap[3] = np.nan                       # a corrupted payload
    snap_cnt = _counts(rng, n)
    snap_cnt[5] = np.inf
    return dict(
        received=rng.random(n) < 0.7,
        pidx=rng.integers(0, n, n).astype(np.int32),
        theta=theta, theta_cnt=_counts(rng, n),
        theta_age=rng.uniform(0, 400, n).astype(np.float32),
        theta_snap=snap, snap_cnt=snap_cnt,
        snap_age=rng.uniform(0, 400, n).astype(np.float32),
        merge_stats=rng.integers(0, 9, 6).astype(np.int32),
        peer_buf=rng.normal(size=(n, recent, d)).astype(np.float32),
        peer_fill=rng.integers(0, 7, n).astype(np.int32))


DEFENSES = {
    "none": None,
    "cnt_clip": dict(cnt_clip=1.5),
    "norm_clip": dict(norm_clip=3.0),
    "dist_gate": dict(dist_gate=1.2),
    "clip+gate": dict(norm_clip=3.0, dist_gate=1.2, cnt_clip=2.0),
    "trimmed": dict(mode="trimmed"),
    "trimmed+all": dict(mode="trimmed", norm_clip=3.0, dist_gate=1.2,
                        cnt_clip=2.0),
}


def _merge_both(policy, defense, model, seed):
    r_lc, t_lc = _pair(dict(merge_policy=policy), defense, model)
    trimmed = defense is not None and defense.get("mode") == "trimmed"
    inp = _layer_inputs(r_lc.param_dim, seed)
    args = ("received", "pidx", "theta", "theta_cnt", "theta_age",
            "theta_snap", "snap_cnt", "snap_age")
    extra = ("peer_buf", "peer_fill") if trimmed else ()

    def ref(*a, merge_stats, **kw):
        return rlearn.merge_deliveries(r_lc, *a, TAU_L,
                                       merge_stats=merge_stats, **kw)

    want = jax.jit(ref)(*(inp[k] for k in args),
                        merge_stats=inp["merge_stats"],
                        **{k: inp[k] for k in extra})
    got = tlearn.merge_deliveries(
        t_lc, *(_t(inp[k]) for k in args), float(TAU_L),
        merge_stats=_t(inp["merge_stats"]), **{k: _t(inp[k]) for k in extra})
    assert set(got) == set(want)
    return got, want


#: Where ``merge_deliveries`` jitted alone contracts the merge as the
#: simulator does (the port's kernels follow the simulator).
SAME_ORDER_ALONE = {("uniform", "none"), ("uniform", "cnt_clip"),
                    ("uniform", "dist_gate"), ("uniform", "trimmed"),
                    ("obs_count", "none"), ("obs_count", "cnt_clip"),
                    ("obs_count", "dist_gate")}


@pytest.mark.parametrize("defense", list(DEFENSES))
@pytest.mark.parametrize("policy", ["uniform", "obs_count"])
def test_merge_deliveries_bitwise(policy, defense):
    got, want = _merge_both(policy, DEFENSES[defense], "logreg", seed=7)
    for k in want:
        if k == "theta" and (policy, defense) not in SAME_ORDER_ALONE:
            np.testing.assert_allclose(got[k][0].numpy(), np.asarray(want[k]),
                                       rtol=0, atol=1e-6)
        else:
            _equal(got[k], want[k], k)
    ms = np.asarray(want["merge_stats"]) - _layer_inputs(34, 7)["merge_stats"]
    assert ms[rlearn.MS_NONFINITE] >= 1 or ms[rlearn.MS_ATTEMPT] == 0


def test_merge_deliveries_mlp_width_bitwise():
    got, want = _merge_both("obs_count", DEFENSES["dist_gate"], "mlp", seed=8)
    for k in want:
        _equal(got[k], want[k], k)


def test_merge_deliveries_staleness_within_tolerance():
    """The weights come from ``exp`` (2 ulp apart at most); the merged
    parameters then differ by up to an ulp of the merge's larger term."""
    got, want = _merge_both("staleness", None, "logreg", seed=9)
    for k in want:
        if k == "theta":
            np.testing.assert_allclose(got[k][0].numpy(), np.asarray(want[k]),
                                       rtol=0, atol=1e-6)
        else:
            _equal(got[k], want[k], k)


def test_snapshot_and_reset_bitwise():
    inp = _layer_inputs(34, 11)
    rng = np.random.default_rng(11)
    newly = rng.random(64) < 0.3
    drop = rng.random(64) < 0.3
    names = ("theta", "theta_cnt", "theta_age", "theta_snap", "snap_cnt",
             "snap_age")
    want = jax.jit(rlearn.snapshot_params)(newly, *(inp[k] for k in names))
    got = tlearn.snapshot_params(_t(newly), *(_t(inp[k]) for k in names))
    for g, w in zip(got, want):
        _equal(g, w)
    theta0 = rng.normal(size=34).astype(np.float32)
    want = jax.jit(rlearn.reset_replicas)(
        drop, inp["theta"], inp["theta_cnt"], inp["theta_age"], theta0,
        peer_fill=inp["peer_fill"])
    got = tlearn.reset_replicas(
        _t(drop), _t(inp["theta"]), _t(inp["theta_cnt"]),
        _t(inp["theta_age"]), torch.from_numpy(theta0),
        peer_fill=_t(inp["peer_fill"]))
    assert set(got) == set(want)
    for k in want:
        _equal(got[k], want[k], k)


def test_init_fields_carried_across_equal_port_init():
    r_lc, t_lc = _pair(defense=dict(mode="trimmed"), model="mlp")
    want = rlearn.init_fields(r_lc, 12)
    _, task = _carried_task(r_lc)
    got = tlearn.init_fields(t_lc, task, 1, 12)
    carried = tlearn.fields_from_numpy(
        {k: np.asarray(v) for k, v in want.items()})
    assert set(got) == set(want) == set(carried)
    for k in want:
        _equal(got[k], want[k], k)
        assert torch.equal(carried[k], got[k]), k


def test_sim_state_with_learning_carried_across():
    """``state_from_numpy`` carries ``repro``'s learning carry too, and it
    equals the port's own initial state on the carried-across task."""
    from repro.sim.state import init_sim_state as r_init_state
    from repro_torch.sim.state import init_sim_state, state_from_numpy

    r_lc, t_lc = _pair(defense=dict(mode="trimmed"), model="mlp")
    r_cfg, t_cfg = RCfg(**GEOM, learn=r_lc), SimConfig(**GEOM, learn=t_lc)
    mob, _ = rget("rdm").init(jax.random.PRNGKey(1), r_cfg)
    zone0 = np.ones(GEOM["n_nodes"], np.uint32)
    state = r_init_state(mob, zone0, M=1, cfg=r_cfg)
    fields = {f.name: np.asarray(getattr(state, f.name))
              for f in dataclasses.fields(state)
              if f.name != "mob" and getattr(state, f.name) is not None}
    fields["mob"] = {f.name: np.asarray(getattr(mob, f.name))
                     for f in dataclasses.fields(mob)}
    carried = state_from_numpy(fields, "cpu")
    _, task = _carried_task(r_lc)
    own = init_sim_state(carried.mob, _t(zone0.view(np.int32)), M=1,
                         cfg=t_cfg, task=task)
    for name in tlearn.LEARN_FIELDS:
        a, b = getattr(carried, name), getattr(own, name)
        assert a.dtype == b.dtype and torch.equal(a, b), name


@pytest.mark.parametrize("model", ["logreg", "mlp"])
def test_train_completions_within_tolerance(model):
    r_lc, t_lc = _pair(model=model)
    r_task, t_task = _carried_task(r_lc)
    rng = np.random.default_rng(12)
    n, d = 40, r_lc.param_dim
    theta = (np.asarray(r_task.theta0)
             + rng.normal(size=(n, d)) * 0.3).astype(np.float32)
    cnt = _counts(rng, n)
    age = rng.uniform(0, 50, n).astype(np.float32)
    did = rng.random(n) < 0.5
    dt = np.float32(0.25)
    slot = 137
    want = jax.jit(partial(rlearn.train_completions, r_lc, r_task))(
        jnp.int32(slot), did, theta, cnt, age, dt)
    x, y = tlearn.stream_batches(t_lc, t_task, torch.tensor([slot]), n)
    got = tlearn.train_completions(t_lc, slot, _t(did), _t(theta), _t(cnt),
                                   _t(age), float(dt), (x[0], y[0]))
    np.testing.assert_allclose(got[0][0].numpy(), np.asarray(want[0]),
                               rtol=1e-5, atol=1e-6)
    _equal(got[0][:, ~did], np.asarray(want[0])[~did])
    _equal(got[1], want[1])
    _equal(got[2], want[2])
    assert not np.array_equal(np.asarray(want[0])[did], theta[did])


def test_stream_batches_draw_the_reference_minibatches():
    r_lc, t_lc = _pair()
    r_task, t_task = _carried_task(r_lc)

    def draw(slot):
        kx, ky = jax.random.split(jax.random.fold_in(r_task.stream_key, slot))
        x = jax.random.normal(kx, (30, r_lc.batch, r_lc.n_features))
        return x, rlearn._labels(ky, r_lc, x, r_task.w_true)

    slots = [0, 1, 63, 64, 4095]
    x, y = tlearn.stream_batches(t_lc, t_task, torch.tensor(slots), 30)
    for i, s in enumerate(slots):
        wx, wy = jax.jit(draw)(s)
        np.testing.assert_array_equal(_bits(x[i].numpy()), _bits(wx))
        np.testing.assert_array_equal(y[i].numpy(), np.asarray(wy))


def test_learn_outputs_within_tolerance():
    r_lc, t_lc = _pair()
    r_task, t_task = _carried_task(r_lc)
    rng = np.random.default_rng(13)
    theta = (rng.normal(size=(50, 34)) * 0.5).astype(np.float32)
    cnt = _counts(rng, 50)
    has = rng.random((50, 1)) < 0.6
    in_rz = rng.random(50) < 0.8
    ms = rng.integers(0, 9, 6).astype(np.int32)
    want = jax.jit(partial(rlearn.learn_outputs, r_lc, r_task))(
        theta, cnt, has, in_rz, merge_stats=ms)
    got = tlearn.learn_outputs(t_lc, t_task, _t(theta), _t(cnt), _t(has),
                               _t(in_rz), merge_stats=_t(ms))
    assert set(got) == set(want)
    _equal(got["merge_stats"], want["merge_stats"])
    for k in LEARNING:
        np.testing.assert_allclose(got[k][0].numpy(), np.asarray(want[k]),
                                   rtol=1e-5, atol=1e-6, err_msg=k)
    none = tlearn.learn_outputs(t_lc, t_task, _t(theta), _t(cnt),
                                _t(np.zeros_like(has)), _t(in_rz),
                                merge_stats=_t(ms))
    assert none["theta_var"].item() == 0 and none["learn_obs"].item() == 0
    assert none["test_acc_holders"].item() == none["test_acc"].item()


# ------------------------------------------------------------------ the engine

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


ENGINE_CASES = {
    "logreg-obs_count": (dict(), None, "logreg", 0),
    "mlp-uniform": (dict(merge_policy="uniform"), None, "mlp", 1),
    "logreg-norm_clip": (dict(), dict(norm_clip=0.5), "logreg", 2),
    "logreg-trimmed": (dict(), dict(mode="trimmed", dist_gate=2.0,
                                    cnt_clip=3.0), "logreg", 0),
}


def check_replayed_learning_run(case):
    """The replayed run of ``ENGINE_CASES[case]`` against ``repro``'s (the
    barrier patched by the caller's ``working_barrier``). The four cases
    run in ``tests/test_torch_learn_runs_a.py`` and ``_b.py``, two a file,
    so that they spread over the workers: each takes minutes there."""
    lc_kw, defense, model, seed = ENGINE_CASES[case]
    r_lc, t_lc = _pair(lc_kw, defense, model)
    p_args = dict(lam=0.05, Lam=10.0, M=1)
    ref = r_simulate(r_paper_params(**p_args), RCfg(**GEOM, learn=r_lc),
                     seed=seed)
    track = np.asarray(_repro_track(jax.random.PRNGKey(seed), RCfg(**GEOM)))
    _, task = _carried_task(r_lc)
    out = simulate(paper_params(**p_args),
                   SimConfig(**GEOM, mobility="replay", learn=t_lc),
                   seed=seed, device="cpu", positions=track, task=task)
    for f in PROTOCOL:
        want, got = getattr(ref, f), getattr(out, f)
        assert got.dtype == want.dtype and got.shape == want.shape, f
        np.testing.assert_array_equal(got, want, err_msg=f)
    for f in LEARNING:
        want, got = getattr(ref, f), getattr(out, f)
        assert got.dtype == want.dtype and got.shape == want.shape, f
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6,
                                   err_msg=f)
    assert ref.merge_stats[-1, rlearn.MS_ATTEMPT] > 0     # merges happened
    assert ref.learn_obs[-1] > 0


#: Replayed runs whose SGD step is a no-op (lr = 1e-50 is 0 in float32),
#: so the parameters move by merges alone and rounding in the gradients
#: cannot hide the merge's operand order.
FROZEN = dict(lr=1e-50)
MERGE_ORDER_CASES = {
    "rows-obs_count": (FROZEN, None),
    "rows-trimmed": (FROZEN, dict(mode="trimmed", norm_clip=1.0)),
    "rows-uniform-trimmed": (dict(FROZEN, merge_policy="uniform"),
                             dict(mode="trimmed")),
    "scaled-obs_count": (FROZEN, dict(norm_clip=1.0)),
}


def _params_out(monkeypatch):
    """Both packages report the parameters themselves at every sample
    (``test_acc`` carries ``theta``)."""
    def report(lc, task, theta, theta_cnt, has_model, in_rz, *, merge_stats,
               **_):
        return dict(test_acc=theta, test_acc_holders=theta_cnt,
                    learn_obs=theta_cnt, theta_var=theta_cnt,
                    merge_stats=merge_stats)

    monkeypatch.setattr(rlearn, "learn_outputs", report)
    monkeypatch.setattr(tlearn, "learn_outputs", report)


def _replayed_pair(lc_kw, defense, model, seed, n_slots, port_only=False):
    r_lc, t_lc = _pair(lc_kw, defense, model)
    geom = dict(GEOM, n_slots=n_slots)
    p_args = dict(lam=0.05, Lam=10.0, M=1)
    ref = None if port_only else r_simulate(
        r_paper_params(**p_args), RCfg(**geom, learn=r_lc), seed=seed)
    track = np.asarray(_repro_track(jax.random.PRNGKey(seed), RCfg(**geom)))
    _, task = _carried_task(r_lc)
    out = simulate(paper_params(**p_args),
                   SimConfig(**geom, mobility="replay", learn=t_lc),
                   seed=seed, device="cpu", positions=track, task=task)
    return ref, out


@pytest.mark.parametrize("case", list(MERGE_ORDER_CASES))
def test_simulator_merge_orders_bitwise(working_barrier, monkeypatch, case):
    """Inside ``repro``'s jitted simulator the merge is
    ``fma(1-w, peer, w*own)``, in trimmed mode too, and the norm-clipped
    merge is that of the rounded ``c*peer``: the port's parameters equal
    the reference's bit for bit at every sample."""
    _params_out(monkeypatch)
    lc_kw, defense = MERGE_ORDER_CASES[case]
    ref, out = _replayed_pair(lc_kw, defense, "mlp", 0, 320)
    assert ref.merge_stats[-1, rlearn.MS_ATTEMPT] > 0
    if defense and defense.get("norm_clip"):
        assert ref.merge_stats[-1, rlearn.MS_NORMCLIP] > 0
    np.testing.assert_array_equal(_bits(out.test_acc), _bits(ref.test_acc))


def test_uniform_norm_clip_folds_the_weight(working_barrier, monkeypatch):
    """With the uniform policy's constant ``w = 0.5`` the simulator folds the
    weight into the scale, ``fma((1-w)*c, peer, w*own)``; the port's scaled
    merge takes that order there (``fold``), so its parameters equal the
    reference's bit for bit at every sample, and the general-weight order
    would not."""
    _params_out(monkeypatch)
    ref, out = _replayed_pair(dict(FROZEN, merge_policy="uniform"),
                              dict(norm_clip=1.0), "mlp", 0, 320)
    assert ref.merge_stats[-1, rlearn.MS_NORMCLIP] > 0
    np.testing.assert_array_equal(_bits(out.test_acc), _bits(ref.test_acc))
    unfolded = tlearn.gossip_merge_rows_scaled
    monkeypatch.setattr(tlearn, "gossip_merge_rows_scaled",
                        lambda *a, fold: unfolded(*a))
    _, other = _replayed_pair(dict(FROZEN, merge_policy="uniform"),
                              dict(norm_clip=1.0), "mlp", 0, 320,
                              port_only=True)
    assert np.any(_bits(other.test_acc) != _bits(ref.test_acc))


def test_learning_leaves_the_protocol_alone_and_learns():
    cfg = SimConfig(**GEOM, learn=logreg_task())
    p = paper_params(lam=0.05, Lam=10.0, M=1)
    out = simulate(p, cfg, seed=0, device="cpu")
    base = simulate(p, dataclasses.replace(cfg, learn=None), seed=0,
                    device="cpu")
    for f in PROTOCOL[:-1]:
        np.testing.assert_array_equal(getattr(out, f), getattr(base, f),
                                      err_msg=f)
    assert base.test_acc is None and base.merge_stats is None
    early, late = out.test_acc[:3].mean(), out.test_acc[-3:].mean()
    assert late > early + 0.05, (early, late)
    assert out.test_acc_holders[-3:].mean() >= late - 1e-6
    assert out.merge_stats.shape == (len(out.t), tlearn.N_MERGE_STATS)
    assert np.all(np.diff(out.merge_stats[:, tlearn.MS_ATTEMPT]) >= 0)


def test_learn_config_validation():
    with pytest.raises(ValueError, match="merge policy"):
        tlearn.LearnConfig(merge_policy="median")
    with pytest.raises(ValueError, match="DefenseConfig"):
        tlearn.LearnConfig(defense=rmerge.DefenseConfig(norm_clip=1.0))
    with pytest.raises(ValueError, match="LearnConfig"):
        simulate(paper_params(), SimConfig(**GEOM, learn=r_logreg()),
                 device="cpu")
