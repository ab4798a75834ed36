"""``repro_torch.sim.compute`` against jitted ``repro.sim.compute``: the
packed word ops and the compute queues, bit for bit, on the cases of
``tests/test_sim_packing.py`` and ``tests/test_sim_queue_ops.py`` at
M in {1, 3}. Words cross as uint32 on the ``repro`` side and int32 bits
in the port."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.sim import compute as rc
from repro_torch.sim import compute as tc


def _t(a):
    a = np.array(a)
    return torch.from_numpy(a.view(np.int32) if a.dtype == np.uint32 else a)


def _np(t, words=False):
    a = t.numpy()
    return a.view(np.uint32) if words else a


def _masks(rng, shape, k):
    return rng.random((*shape, k)) < rng.uniform(0.1, 0.9)


@pytest.mark.parametrize("seed", range(3))
@pytest.mark.parametrize("k", [1, 7, 32, 33, 64, 100])
def test_word_setops_match_repro_and_bools(seed, k):
    rng = np.random.default_rng(100 * k + seed)
    a, b = _masks(rng, (4, 3), k), _masks(rng, (4, 3), k)
    aw, bw = tc.pack_mask(_t(a)), tc.pack_mask(_t(b))
    assert aw.dtype == torch.int32
    np.testing.assert_array_equal(_np(aw, True),
                                  np.asarray(jax.jit(rc.pack_mask)(a)))
    for got, want in ((aw & bw, a & b), (aw | bw, a | b), (aw & ~bw, a & ~b)):
        np.testing.assert_array_equal(tc.unpack_mask(got, k).numpy(), want)
    np.testing.assert_array_equal(tc.packed_any(aw & ~bw).numpy(),
                                  np.any(a & ~b, axis=-1))
    np.testing.assert_array_equal(
        tc.packed_popcount(aw).numpy(),
        np.asarray(jax.jit(rc.packed_popcount)(rc.pack_mask(a))))


@pytest.mark.parametrize("k", [1, 31, 32, 33, 100])
def test_packed_onehot_matches_repro(k):
    idx = np.arange(k, dtype=np.int32)
    want = jax.jit(rc.packed_onehot, static_argnums=1)(idx, k)
    np.testing.assert_array_equal(_np(tc.packed_onehot(_t(idx), k), True),
                                  np.asarray(want))


def test_pad_bits_stay_zero_through_setops():
    k = 40
    rng = np.random.default_rng(0)
    a, b = _masks(rng, (5,), k), _masks(rng, (5,), k)
    aw, bw = tc.pack_mask(_t(a)), tc.pack_mask(_t(b))
    np.testing.assert_array_equal(_np(aw & ~bw, True),
                                  _np(tc.pack_mask(_t(a & ~b)), True))


@pytest.mark.parametrize("k", [1, 31, 32, 33, 64, 100])
def test_pack_unpack_roundtrip(k):
    mask = np.random.default_rng(k).random((5, 3, k)) < 0.5
    words = tc.pack_mask(_t(mask))
    assert words.shape == (5, 3, (k + 31) // 32)
    np.testing.assert_array_equal(tc.unpack_mask(words, k).numpy(), mask)


def _queue_case(seed, m_count, n=17, q=5, k=40):
    rng = np.random.default_rng(seed)
    queue = np.where(rng.random((n, q)) < 0.55,
                     rng.integers(0, m_count, (n, q)), -1).astype(np.int8)
    want = rng.random((n, m_count)) < 0.5
    words_store = rng.integers(0, 2**32, (n, q, 2), dtype=np.uint32)
    words_src = rng.integers(0, 2**32, (n, m_count, 2), dtype=np.uint32)
    slot_store = rng.integers(0, 64, (n, q)).astype(np.int16)
    slot_src = rng.integers(0, 64, (n, m_count)).astype(np.int32)
    bool_store = rng.random((n, q, k)) < 0.5
    bool_src = rng.random((n, m_count, k)) < 0.5
    return queue, want, [(words_store, words_src), (slot_store, slot_src),
                         (bool_store, bool_src)]


@pytest.mark.parametrize("seed", range(4))
@pytest.mark.parametrize("m_count", [1, 3, 7])
def test_enqueue_matches_repro(seed, m_count):
    queue, want, pairs = _queue_case(seed, m_count)
    ref = jax.jit(rc.enqueue_ascending)(
        jnp.asarray(queue), jnp.asarray(want),
        *[(jnp.asarray(d), jnp.asarray(s)) for d, s in pairs])
    got = tc.enqueue_ascending(_t(queue), _t(want),
                               *[(_t(d), _t(s)) for d, s in pairs])
    for i, (g, r) in enumerate(zip(got, ref)):
        r = np.asarray(r)
        np.testing.assert_array_equal(_np(g, r.dtype == np.uint32), r,
                                      err_msg=f"output {i}")
        assert g.dtype == _t(r).dtype


@pytest.mark.parametrize("m_count", [1, 3])
def test_enqueue_batch_axis_equals_per_item(m_count):
    cases = [_queue_case(s, m_count) for s in (0, 1)]
    stacked = tc.enqueue_ascending(
        torch.stack([_t(c[0]) for c in cases]),
        torch.stack([_t(c[1]) for c in cases]),
        *[(torch.stack([_t(c[2][p][0]) for c in cases]),
           torch.stack([_t(c[2][p][1]) for c in cases])) for p in range(3)])
    for b, (queue, want, pairs) in enumerate(cases):
        single = tc.enqueue_ascending(_t(queue), _t(want),
                                      *[(_t(d), _t(s)) for d, s in pairs])
        for g, s in zip(stacked, single):
            assert torch.equal(g[b], s)


def test_enqueue_drops_beyond_capacity_and_fills_ascending():
    (got,) = tc.enqueue_ascending(torch.tensor([[2, -1, 3]], dtype=torch.int8),
                                  torch.tensor([[True, True, True, True]]))
    np.testing.assert_array_equal(got.numpy(), [[2, 0, 3]])
    (got,) = tc.enqueue_ascending(
        torch.tensor([[-1, 7, -1, -1]], dtype=torch.int8),
        torch.tensor([[False, True, True, False, True]]))
    np.testing.assert_array_equal(got.numpy(), [[1, 7, 2, 4]])


def _server_case(seed, m_count, n=24, qm=4, qt=4, kw=2):
    rng = np.random.default_rng(seed)

    def queue(q):
        return np.where(rng.random((n, q)) < 0.4,
                        rng.integers(0, m_count, (n, q)), -1).astype(np.int8)

    return dict(
        serving=rng.integers(-1, 2, n).astype(np.int32),
        serv_left=rng.choice([0.0, 0.25, 1.0, 2.5], n).astype(np.float32),
        serv_model=rng.integers(0, m_count, n).astype(np.int32),
        serv_mask=rng.integers(0, 2**32, (n, kw), dtype=np.uint32),
        serv_slot=rng.integers(0, 64, n).astype(np.int32),
        mq_model=queue(qm),
        mq_mask=rng.integers(0, 2**32, (n, qm, kw), dtype=np.uint32),
        tq_model=queue(qt),
        tq_slot=rng.integers(0, 64, (n, qt)).astype(np.int16),
    )


@pytest.mark.parametrize("seed", range(4))
@pytest.mark.parametrize("m_count", [1, 3])
def test_timers_and_pick_next_jobs_match_repro(seed, m_count):
    s = _server_case(seed, m_count)
    left, fin_m, fin_t = jax.jit(rc.advance_timers)(
        s["serving"], s["serv_left"], 0.25)
    got = tc.advance_timers(_t(s["serving"]), _t(s["serv_left"]), 0.25)
    for g, r in zip(got, (left, fin_m, fin_t)):
        np.testing.assert_array_equal(g.numpy(), np.asarray(r))
    s["serv_left"] = np.asarray(left)
    s["serving"] = np.where(np.asarray(fin_m | fin_t), -1, s["serving"])
    ref = jax.jit(lambda kw: rc.pick_next_jobs(**kw, T_M=2.5, T_T=5.0))(
        {k: jnp.asarray(v) for k, v in s.items()})
    out = tc.pick_next_jobs(**{k: _t(v) for k, v in s.items()},
                            T_M=2.5, T_T=5.0)
    for k, r in ref.items():
        r = np.asarray(r)
        np.testing.assert_array_equal(_np(out[k], r.dtype == np.uint32), r,
                                      err_msg=k)


def test_merge_priority_fifo_and_no_preemption():
    s = {k: _t(v) for k, v in _server_case(0, 1, n=1).items()}
    s.update(serving=torch.tensor([-1], dtype=torch.int32),
             mq_model=torch.tensor([[-1, 4, -1, -1]], dtype=torch.int8),
             tq_model=torch.tensor([[3, 1, -1, 5]], dtype=torch.int8))
    out = tc.pick_next_jobs(**s, T_M=2.5, T_T=5.0)
    assert int(out["serving"][0]) == 0 and int(out["serv_model"][0]) == 4
    assert float(out["serv_left"][0]) == 2.5
    assert out["tq_model"].tolist() == [[3, 1, -1, 5]]
    s["serving"] = torch.tensor([1], dtype=torch.int32)        # busy: no take
    out = tc.pick_next_jobs(**s, T_M=2.5, T_T=5.0)
    assert out["mq_model"].tolist() == [[-1, 4, -1, -1]]


def test_packed_merge_payload_roundtrips_through_queue():
    k = 64
    mask = np.arange(k) % 3 == 0
    src = tc.pack_mask(torch.from_numpy(mask)[None, None, :])
    new_q, new_store = tc.enqueue_ascending(
        torch.full((1, 2), -1, dtype=torch.int8), torch.tensor([[True]]),
        (torch.zeros((1, 2, 2), dtype=torch.int32), src))
    s = {k_: _t(v) for k_, v in _server_case(0, 1, n=1, qm=2).items()}
    s.update(serving=torch.tensor([-1], dtype=torch.int32), mq_model=new_q,
             mq_mask=new_store)
    out = tc.pick_next_jobs(**s, T_M=2.5, T_T=5.0)
    np.testing.assert_array_equal(tc.unpack_mask(out["serv_mask"], k)[0], mask)
