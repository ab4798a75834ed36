"""The plain version of the port's flat ``gossip_merge`` kernel against
``repro``'s, bit for bit (tolerance: none).

``gossip_merge`` runs on the CPU here (a CUDA tensor would launch the
kernel; ``chip_smoke.py`` holds the kernel against this plain version on
the card). ``repro``'s merge is held in the two forms its callers run it:
``jax.jit(gossip_merge_op)`` (its jnp reference, jitted) and the Pallas
kernel in interpret mode (``gossip_merge_op(..., interpret=True)``, as
``tests/test_kernels.py`` runs it). Both contract the merge into
``fma(1-w, peer, w*own)``, the order of the jitted gossip round. Called
eagerly, outside ``jit``, ``repro``'s merge rounds the two products apart;
a test records that, so the choice of order stays visible.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.gossip_merge import gossip_merge as r_merge
from repro.kernels.ops import gossip_merge_op as r_merge_op
from repro_torch.kernels import gossip_merge as gm
from repro_torch.kernels.ops import gossip_merge_op
from repro_torch.numerics import fma32


@pytest.fixture(autouse=True)
def one_torch_thread():
    """The suite runs several test processes on the machine's cores; torch's
    intra-op threads in each would contend for them (the results do not
    depend on the thread count)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


SHAPES = [(1,), (7,), (4095,), (16385,), (3, 5, 7)]
DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}
WEIGHTS = [1 / 3, 0.5, 0.0, 1.0, 0.7, "random"]


def _inputs(shape, dtype: str, seed: int):
    """``own`` and ``peer`` as JAX arrays of ``dtype`` and the same values
    as torch tensors."""
    rng = np.random.default_rng(seed)
    jdt, tdt = DTYPES[dtype]
    own = jnp.asarray((rng.normal(size=shape) * 2).astype(np.float32))
    peer = jnp.asarray((rng.normal(size=shape) * 2).astype(np.float32))
    own, peer = own.astype(jdt), peer.astype(jdt)
    return own, peer, _torch(own, tdt), _torch(peer, tdt)


def _torch(a, tdt) -> torch.Tensor:
    return torch.from_numpy(np.array(a.astype(jnp.float32))).to(tdt)


def _weight(w, seed: int) -> np.float32:
    if w == "random":
        return np.float32(np.random.default_rng(seed).uniform())
    return np.float32(w)


def _bits(a) -> np.ndarray:
    """Values of either package (bfloat16 widened exactly) as float32
    bits."""
    if torch.is_tensor(a):
        a = a.float().numpy()
    return np.asarray(np.asarray(a, np.float32)).view(np.int32)


def _plain(own, peer, w, success: bool) -> torch.Tensor:
    return gm.gossip_merge(own, peer, torch.tensor(w),
                           torch.tensor(success))


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("w", WEIGHTS)
def test_plain_equals_jitted_repro_and_pallas_interpret(shape, dtype, w):
    seed = len(shape) * 1000 + int(np.prod(shape)) + WEIGHTS.index(w)
    own, peer, t_own, t_peer = _inputs(shape, dtype, seed)
    wt = _weight(w, seed)
    got = _plain(t_own, t_peer, wt, True)
    assert got.dtype == t_own.dtype and got.shape == t_own.shape
    jitted = jax.jit(r_merge_op)({"x": own}, {"x": peer}, wt, True)["x"]
    pallas = r_merge_op({"x": own}, {"x": peer}, wt, 1.0,
                        interpret=True)["x"]
    np.testing.assert_array_equal(_bits(got), _bits(jitted))
    np.testing.assert_array_equal(_bits(got), _bits(pallas))


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("bad", [np.nan, np.inf, -np.inf])
def test_unselected_leaf_is_own_whatever_peer_holds(dtype, bad):
    own, _, t_own, _ = _inputs((4097,), dtype, 3)
    peer = torch.full_like(t_own, bad)
    peer[::3] = 1.5
    got = _plain(t_own, peer, np.float32(0.3), False)
    np.testing.assert_array_equal(_bits(got), _bits(t_own))
    pallas = r_merge(own, jnp.asarray(peer.float().numpy()).astype(own.dtype),
                     0.3, 0.0, interpret=True)
    np.testing.assert_array_equal(_bits(got), _bits(pallas))


def _orders(t_own, t_peer, w):
    """The merge in its three roundings, each rounded to the leaves'
    dtype: XLA's contraction in the jitted round, the other contraction,
    and the two products rounded apart."""
    o, p = t_own.float(), t_peer.float()
    w = torch.tensor(w)
    return {"peer-first": fma32(1.0 - w, p, w * o),
            "own-first": fma32(w, o, (1.0 - w) * p),
            "unfused": w * o + (1.0 - w) * p}


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_threshold_inputs_tell_the_three_orders_apart(dtype):
    """On the elements where the three roundings disagree, the plain
    version and both ``repro`` forms take ``fma(1-w, peer, w*own)``, and
    each other order misses them, so a wrong-order mutant fails."""
    own, peer, t_own, t_peer = _inputs((200003,), dtype, 17)
    w = np.float32(1 / 3)
    orders = {k: _bits(v.to(t_own.dtype)) for k, v in
              _orders(t_own, t_peer, w).items()}
    split = ((orders["peer-first"] != orders["own-first"])
             & (orders["peer-first"] != orders["unfused"])
             & (orders["own-first"] != orders["unfused"]))
    assert split.sum() > (1000 if dtype == "float32" else 10)
    got = _bits(_plain(t_own, t_peer, w, True))[split]
    jitted = _bits(jax.jit(r_merge_op)({"x": own}, {"x": peer}, w,
                                       True)["x"])[split]
    pallas = _bits(r_merge(own, peer, w, 1.0, interpret=True))[split]
    np.testing.assert_array_equal(got, jitted)
    np.testing.assert_array_equal(got, pallas)
    np.testing.assert_array_equal(got, orders["peer-first"][split])
    for other in ("own-first", "unfused"):
        assert not np.any(orders[other][split] == jitted), other


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_own_first_takes_the_other_contraction(dtype):
    """``own_first=True`` is ``fma(w, own, (1-w)*peer)``, the order XLA
    contracts the jitted round's one-element float32 leaves and segments
    into (``tests/test_torch_gossip.py`` holds the round to ``repro``), on
    the elements where the three orders disagree; unselected elements stay
    ``own``."""
    _, _, t_own, t_peer = _inputs((200003,), dtype, 19)
    w = np.float32(0.7)
    orders = {k: _bits(v.to(t_own.dtype)) for k, v in
              _orders(t_own, t_peer, w).items()}
    split = ((orders["peer-first"] != orders["own-first"])
             & (orders["own-first"] != orders["unfused"]))
    assert split.sum() > (1000 if dtype == "float32" else 10)
    got = gm.gossip_merge(t_own, t_peer, torch.tensor(w), torch.tensor(True),
                          own_first=True)
    np.testing.assert_array_equal(_bits(got), orders["own-first"])
    assert not np.any(_bits(got)[split] == orders["peer-first"][split])
    kept = gm.gossip_merge(t_own, t_peer, torch.tensor(w),
                           torch.tensor(False), own_first=True)
    assert torch.equal(kept, t_own)


def test_eager_repro_merge_is_unfused():
    """``repro``'s merge called eagerly rounds ``w*own`` and
    ``(1-w)*peer`` apart: a second result for the same function, which
    the port does not follow (it follows the jitted round)."""
    own, peer, t_own, t_peer = _inputs((100003,), "float32", 23)
    w = np.float32(0.7)
    eager = _bits(r_merge_op({"x": own}, {"x": peer}, w, True)["x"])
    orders = {k: _bits(v) for k, v in _orders(t_own, t_peer, w).items()}
    np.testing.assert_array_equal(eager, orders["unfused"])
    assert np.mean(eager != orders["peer-first"]) > 0.05


def test_out_receives_the_result_in_a_view():
    """``out=`` writes one replica's slice of a stacked buffer and leaves
    the other replicas as they were."""
    _, _, own, peer = _inputs((3, 4, 33), "bfloat16", 5)
    buf = torch.full((3, 4, 33), 7.0, dtype=torch.bfloat16)
    w, s = torch.tensor(np.float32(0.25)), torch.tensor(True)
    got = gm.gossip_merge(own[1], peer[2], w, s, out=buf[1])
    assert got.data_ptr() == buf[1].data_ptr()
    assert torch.equal(buf[1], gm.gossip_merge_ref(own[1], peer[2], w, s))
    assert torch.equal(buf[0], torch.full_like(buf[0], 7.0))
    assert torch.equal(buf[2], torch.full_like(buf[2], 7.0))


def test_ops_merge_a_tree_leaf_by_leaf_as_repro():
    """``gossip_merge_op`` over a nested tree equals ``repro``'s jitted op;
    ``success`` counts as true above 0.5, as there."""
    rng = np.random.default_rng(8)
    own = {"a": rng.normal(size=(5, 3)).astype(np.float32),
           "b": (rng.normal(size=7).astype(np.float32),
                 rng.normal(size=(2, 2, 9)).astype(np.float32))}
    peer = jax.tree.map(lambda x: x * 3 + 1, own)
    to_t = lambda t: jax.tree.map(torch.from_numpy, t)
    for success in (0.7, 0.3, True):
        got = gossip_merge_op(to_t(own), to_t(peer), np.float32(0.3),
                              success)
        want = jax.jit(r_merge_op)(own, peer, np.float32(0.3), success)
        assert isinstance(got["b"], tuple) and len(got["b"]) == 2
        for g, w_ in zip(jax.tree.leaves(got, is_leaf=torch.is_tensor),
                         jax.tree.leaves(want)):
            np.testing.assert_array_equal(_bits(g), _bits(w_))


def _args(**over):
    own = torch.zeros(6, 4)
    args = dict(own=own, peer=torch.ones(6, 4),
                w_own=torch.tensor(0.5), success=torch.tensor(True),
                out=None)
    args.update(over)
    return args


@pytest.mark.parametrize("bad,match", [
    (dict(own=torch.zeros(4, 6).t()), "own must be contiguous"),
    (dict(peer=torch.ones(4, 6).t()), "peer must be contiguous"),
    (dict(out=torch.empty(4, 6).t()), "out must be contiguous"),
    (dict(own=torch.zeros(6, 4, dtype=torch.float16),
          peer=torch.ones(6, 4, dtype=torch.float16)), "float32 or bfloat16"),
    (dict(peer=torch.ones(6, 4, dtype=torch.bfloat16)), "peer wants"),
    (dict(peer=torch.ones(4, 6)), "peer wants"),
    (dict(out=torch.empty(6, 4, dtype=torch.float64)), "out wants"),
    (dict(w_own=torch.tensor([0.5])), "w_own wants"),
    (dict(w_own=torch.tensor(0.5, dtype=torch.float64)), "w_own wants"),
    (dict(w_own=0.5), "w_own must be a tensor"),
    (dict(success=torch.tensor(1.0)), "success wants"),
    (dict(success=torch.tensor(True, device="meta")), "success is on meta"),
])
def test_contract_is_checked_on_cpu_tensors(bad, match):
    with pytest.raises(ValueError, match=match):
        gm.gossip_merge(**_args(**bad))


def test_other_devices_raise():
    args = {k: v.to("meta") for k, v in _args().items() if v is not None}
    with pytest.raises(ValueError, match="unsupported device"):
        gm.gossip_merge(**args)


def test_cpu_tensors_take_the_plain_version_and_count_nothing():
    before = gm.gossip_merge.launches
    got = gm.gossip_merge(**_args())
    assert torch.equal(got, torch.full((6, 4), 0.5))
    assert gm.gossip_merge.launches == before


def test_kernel_source_writes_the_reference_order():
    """The CUDA source spells the orders and roundings the plain version
    pins: ``1 - w`` once in float, ``fma(1-w, peer, w*own)`` and (own
    first) ``fma(w, own, (1-w)*peer)``, and one round-to-nearest-even into
    bfloat16."""
    src = gm.SOURCE.read_text()
    assert "const float omw = __fsub_rn(1.f, wr);" in src
    assert "__fmaf_rn(omw, to_f32(p), __fmul_rn(w, to_f32(o)))" in src
    assert "__fmaf_rn(w, to_f32(o), __fmul_rn(omw, to_f32(p)))" in src
    assert "*out = __float2bfloat16_rn(v);" in src
    assert "extern \"C\" int gossip_merge_launch(" in src
