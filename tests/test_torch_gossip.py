"""The port's gossip round against ``repro``'s ``build_gossip_round``, bit
for bit on every leaf, ``count`` and ``age`` (tolerance: none).

``repro``'s round needs one device per replica, so its side runs once per
module in a subprocess with eight host devices
(``--xla_force_host_platform_device_count=8``, as
``tests/test_gossip_protocol.py`` does) and writes every case's inputs and
per-round outputs to an ``.npz``. It runs the round under ``jax.jit``, as
``repro``'s trainer does: XLA then contracts the whole-leaf merge into
``fma(1-w, peer, w*own)`` (float32 leaves of one element a replica:
``fma(w, own, (1-w)*peer)``), and the segmented merge into
``fma(w, own, (1-w)*peer)`` for float32 leaves and ``fma(1-w, peer,
w*own)`` for bfloat16 ones; the port takes every merge through
``gossip_merge``, with ``own_first=True`` for the second order. Each case
starts from ``repro``'s
``init_lm`` replicas of a reduced h2o-danube-3-4b (carried over with
``params_from_numpy``) and carries its state through six rounds.
"""

import os
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest
import torch

from repro.core import gossip as r_gossip
from repro_torch import random as jr
from repro_torch.configs import get_arch_config
from repro_torch.configs.base import reduced
from repro_torch.core import gossip
from repro_torch.models.transformer import (init_lm, params_from_numpy,
                                            stack_replicas)
from repro_torch.tree import tree_items, tree_map


@pytest.fixture(autouse=True)
def one_torch_thread():
    """The suite runs several test processes on the machine's cores; torch's
    intra-op threads in each would contend for them (the results do not
    depend on the thread count)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


ROOT = Path(__file__).resolve().parents[1]
ROUNDS = 6
GATES = dict(success_prob=0.8, busy_prob=0.1, churn_prob=0.15)
CASES = {
    "hypercube-f32": dict(R=4, dtype="float32", matching="hypercube",
                          seed=3, **GATES),
    "hypercube-bf16-nogates": dict(R=4, dtype="bfloat16",
                                   matching="hypercube", seed=2),
    "random-bf16": dict(R=4, dtype="bfloat16", matching="random",
                        n_random_matchings=5, seed=1, **GATES),
    "random-f32-nogates": dict(R=4, dtype="float32", matching="random",
                               n_random_matchings=3, seed=6),
    "random-f32-r3": dict(R=3, dtype="float32", matching="random",
                          n_random_matchings=4, seed=4, **GATES),
    "random-bf16-r3-nogates": dict(R=3, dtype="bfloat16", matching="random",
                                   n_random_matchings=4, seed=8),
    "random-f32-seg3": dict(R=4, dtype="float32", matching="random",
                            segments=3, seed=5, **GATES),
    "hypercube-bf16-seg3": dict(R=4, dtype="bfloat16", matching="hypercube",
                                segments=3, seed=7, **GATES),
    "random-f32-r3-seg3-nogates": dict(R=3, dtype="float32",
                                       matching="random", segments=3,
                                       seed=9),
    "hypercube-f32-uniform": dict(R=4, dtype="float32", matching="hypercube",
                                  merge_policy="uniform", seed=10, **GATES),
}
#: A float32 leaf of one element a replica, added to the model's tree.
ONE = "one_element"


def arch(dtype: str):
    return reduced(get_arch_config("h2o-danube-3-4b"), dtype=dtype)


def init_keys(name: str) -> range:
    """The seeds of a case's R replicas, then of its R default replicas."""
    base = 100 * sorted(CASES).index(name)
    return range(base, base + 2 * CASES[name]["R"])


def start_state(name: str):
    """``count`` (some 0, some fractional) and ``age``, from numpy."""
    rng = np.random.default_rng(sorted(CASES).index(name))
    R = CASES[name]["R"]
    count = rng.choice([0.0, 0.5, 1.0, 2.0, 3.0, 7.0], R).astype(np.float32)
    age = rng.integers(0, 9, R).astype(np.float32)
    return count, age


def one_element(name: str) -> np.ndarray:
    rng = np.random.default_rng(1000 + sorted(CASES).index(name))
    return rng.normal(size=(CASES[name]["R"], 1)).astype(np.float32)


def to_bits(a) -> np.ndarray:
    """An array's raw bits (bfloat16 as uint16), to store and compare."""
    a = np.asarray(a)
    return a.view(np.uint16 if a.dtype.itemsize == 2 else np.uint32)


REFERENCE = """
import os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
sys.path[:0] = [{src!r}, {tests!r}]
import jax, jax.numpy as jnp, numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
from repro.configs import get_arch_config
from repro.configs.base import reduced
from repro.core.gossip import GossipConfig, build_gossip_round
from repro.launch.mesh import use_mesh
from repro.models.transformer import init_lm
from test_torch_gossip import (CASES, ONE, ROUNDS, init_keys, one_element,
                               start_state, to_bits)
from repro_torch.tree import tree_items
out = {{}}
for name, kw in CASES.items():
    kw = dict(kw)
    R, dtype = kw.pop("R"), kw.pop("dtype")
    mesh = Mesh(np.array(jax.devices()[:R]), ("data",))
    cfg = reduced(get_arch_config("h2o-danube-3-4b"), dtype=dtype)
    keys = list(init_keys(name))
    reps = [init_lm(cfg, jax.random.PRNGKey(k))[0] for k in keys]
    stack = lambda trees: jax.tree.map(lambda *xs: jnp.stack(xs), *trees)
    params, default = stack(reps[:R]), stack(reps[R:])
    params[ONE] = jnp.asarray(one_element(name))
    default[ONE] = jnp.zeros((R, 1), jnp.float32)
    specs = jax.tree.map(lambda x: P("data", *([None] * (x.ndim - 1))),
                         params)
    put = lambda t: jax.tree.map(
        lambda x, s: jax.device_put(x, NamedSharding(mesh, s)), t, specs)
    params, default = put(params), put(default)
    for k, v in tree_items(params):
        out[f"{{name}}/init/{{k}}"] = to_bits(v)
    for k, v in tree_items(default):
        out[f"{{name}}/default/{{k}}"] = to_bits(v)
    count, age = start_state(name)
    st = dict(count=jax.device_put(count, NamedSharding(mesh, P("data"))),
              age=jax.device_put(age, NamedSharding(mesh, P("data"))))
    fn, _ = build_gossip_round(mesh, specs, GossipConfig(**kw))
    fn = jax.jit(fn)
    with use_mesh(mesh):
        for r in range(ROUNDS):
            params, st = fn(params, st, default, r)
            for k, v in tree_items(params):
                out[f"{{name}}/{{r}}/{{k}}"] = to_bits(v)
            out[f"{{name}}/{{r}}/count"] = np.asarray(st["count"])
            out[f"{{name}}/{{r}}/age"] = np.asarray(st["age"])
np.savez(sys.argv[1], **out)
"""


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    path = tmp_path_factory.mktemp("gossip") / "rounds.npz"
    code = REFERENCE.format(src=str(ROOT / "src"), tests=str(ROOT / "tests"))
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    res = subprocess.run([sys.executable, "-c", textwrap.dedent(code),
                          str(path)], capture_output=True, text=True,
                         timeout=600, env=env)
    assert res.returncode == 0, res.stderr[-3000:]
    with np.load(path) as z:
        return dict(z)


def carried_over(reference, name: str, what: str) -> dict:
    """The reference's stacked ``what`` tree, carried over into tensors
    with ``params_from_numpy``: a flat tree keyed by leaf path."""
    import ml_dtypes

    prefix = f"{name}/{what}/"
    arrays = {k[len(prefix):]: v.view(ml_dtypes.bfloat16 if v.dtype ==
                                      np.uint16 else np.float32)
              for k, v in reference.items() if k.startswith(prefix)}
    return params_from_numpy(arrays, device="cpu")


def port_case(reference, name: str):
    """The case's config and its replicas and defaults, carried over from
    the reference."""
    kw = dict(CASES[name])
    R = kw.pop("R")
    kw.pop("dtype")
    return (gossip.GossipConfig(**kw), R,
            carried_over(reference, name, "init"),
            carried_over(reference, name, "default"))


def port_init(name: str):
    """The case's replicas and defaults from the port's own ``init_lm``,
    stacked."""
    R, cfg = CASES[name]["R"], arch(CASES[name]["dtype"])
    reps = [init_lm(cfg, jr.PRNGKey(k), device="cpu")
            for k in init_keys(name)]
    params, default = stack_replicas(reps[:R]), stack_replicas(reps[R:])
    params[ONE] = torch.from_numpy(one_element(name))
    default[ONE] = torch.zeros((R, 1))
    return params, default


def leaf_bits(t: torch.Tensor) -> np.ndarray:
    return t.view(torch.int16 if t.dtype == torch.bfloat16
                  else torch.int32).numpy()


def assert_bits(got: torch.Tensor, want: np.ndarray, what: str) -> None:
    np.testing.assert_array_equal(to_bits(leaf_bits(got)), want,
                                  err_msg=what)


@pytest.mark.parametrize("name", sorted(CASES))
def test_round_equals_repro_bit_for_bit(reference, name):
    cfg, R, params, default = port_case(reference, name)
    fn, r_out = gossip.build_gossip_round(R, cfg)
    assert r_out == R
    count, age = start_state(name)
    state = dict(count=torch.from_numpy(count), age=torch.from_numpy(age))
    for r in range(ROUNDS):
        inputs, before = params, tree_map(torch.clone, params)
        params, state = fn(params, state, default, r)
        for path, leaf in tree_items(params):
            assert_bits(leaf, reference[f"{name}/{r}/{path}"],
                        f"round {r} leaf {path}")
        for k in ("count", "age"):
            np.testing.assert_array_equal(
                state[k].numpy(), reference[f"{name}/{r}/{k}"],
                err_msg=f"round {r} {k}")
        # the round left its inputs as they were
        for (path, a), (_, b) in zip(tree_items(inputs), tree_items(before)):
            assert torch.equal(a, b), path


@pytest.mark.parametrize("name", ["hypercube-f32", "random-bf16-r3-nogates"])
def test_stacked_port_init_equals_the_reference_inputs(reference, name):
    """The replicas the reference starts from are the port's own
    ``init_lm`` replicas, stacked with ``stack_replicas``."""
    params, default = port_init(name)
    for what, tree in (("init", params), ("default", default)):
        want = carried_over(reference, name, what)
        assert sorted(want) == sorted(dict(tree_items(tree)))
        for path, got in tree_items(tree):
            assert got.dtype == want[path].dtype, f"{what} {path}"
            assert got.shape[0] == CASES[name]["R"], f"{what} {path}"
            assert_bits(got, to_bits(leaf_bits(want[path])), f"{what} {path}")


@pytest.mark.parametrize("name", sorted(CASES))
def test_cases_move_replicas(reference, name):
    """Each case merges in some round, and each case with gates or an odd
    R leaves some replica unmerged in some round, so a round that did
    nothing, or ignored the gates, would fail the bit-for-bit test."""
    R = CASES[name]["R"]
    embed = [reference[f"{name}/{r}/embed"] for r in range(ROUNDS)]
    prev = reference[f"{name}/init/embed"]
    changed = []
    for cur in embed:
        changed.append([not np.array_equal(cur[i], prev[i])
                        for i in range(R)])
        prev = cur
    flat = sum(changed, [])
    assert any(flat), changed
    if "success_prob" in CASES[name] or R % 2:
        assert not all(flat), changed


@pytest.mark.parametrize("name", ["random-f32-r3", "hypercube-bf16-seg3"])
def test_gates_say_what_the_round_did(reference, name):
    """``round_fn.gates`` gives the draws the round makes: a churned
    replica is its default, an unmerged one is unchanged, a merged one
    sums its partner's count; a self-paired replica never merges."""
    cfg, R, params, default = port_case(reference, name)
    fn, _ = gossip.build_gossip_round(R, cfg)
    count, age = start_state(name)
    state = dict(count=torch.from_numpy(count), age=torch.from_numpy(age))
    seen = set()
    for r in range(ROUNDS):
        g = fn.gates(state, r)
        new, new_state = fn(params, state, default, r)
        for i in range(R):
            p = int(g.partner[i])
            if p == i:
                assert not g.success[i]
            if g.reset[i]:
                kind, want, c = "churn", default, 0.0
            elif g.success[i]:
                kind, want = "merge", None
                c = float(state["count"][i] + state["count"][p])
            else:
                kind, want, c = "none", params, float(state["count"][i])
            seen.add(kind)
            assert float(new_state["count"][i]) == c, (r, i, kind)
            if want is not None:
                for path, leaf in tree_items(new):
                    assert torch.equal(leaf[i], want[path][i]), (r, i, path)
        params, state = new, new_state
    assert seen == {"churn", "merge", "none"}


@pytest.mark.parametrize("R,K,seed", [(4, 16, 0), (3, 5, 1), (8, 4, 7),
                                      (5, 2, 11), (2, 3, 2)])
def test_random_matchings_equal_repro(R, K, seed):
    assert gossip.random_matchings(R, K, seed) == [
        [(int(a), int(b)) for a, b in m]
        for m in r_gossip.random_matchings(R, K, seed)]


@pytest.mark.parametrize("R", [1, 2, 4, 8, 16])
def test_hypercube_matchings_equal_repro(R):
    assert gossip.hypercube_matchings(R) == r_gossip.hypercube_matchings(R)


def test_hypercube_needs_a_power_of_two():
    with pytest.raises(ValueError, match="power-of-two"):
        gossip.hypercube_matchings(6)
    with pytest.raises(ValueError, match="unknown matching"):
        gossip.build_gossip_round(4, gossip.GossipConfig(matching="ring"))


def test_config_defaults_equal_repro():
    import dataclasses

    want = {f.name: f.default for f in dataclasses.fields(
        r_gossip.GossipConfig) if f.name != "axis_names"}
    got = {f.name: f.default for f in dataclasses.fields(gossip.GossipConfig)}
    assert got == want


def test_init_state_is_zero_on_the_device():
    st = gossip.init_gossip_state(3, device="cpu")
    for k in ("count", "age"):
        assert st[k].dtype == torch.float32 and st[k].shape == (3,)
        assert not st[k].any()
