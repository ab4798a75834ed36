"""The port's serving path against ``repro``'s on the CPU: ``lm_forward``,
``lm_decode_step``, ``make_prefill_step`` and ``ServeEngine.generate``
for the reduced dense-attention configurations (2 layers, d_model 256),
with ``repro``'s parameters carried over.

Tolerances, by reason:

* ``F32`` (rtol = atol = 1e-4) on float32 logits: XLA and torch sum the
  products in other orders and cos and sin may differ by an ulp; the
  largest difference measured is 5.7e-6 at logits up to 4.9. Greedy tokens
  are then held **equal**.
* ``BF16`` (rtol = 2e-2, atol = 0.1) on bfloat16 logits: XLA keeps
  elementwise chains in float32 inside its fusions and rounds once, torch
  rounds every operation to bfloat16, so hidden states differ by up to
  1.5 ulp (0.047 at |x| <= 4.2) and logits by up to 0.05. A greedy token
  can then flip where the two best logits lie within that: in bfloat16 the
  port is fed ``repro``'s tokens (teacher forcing) and must choose
  ``repro``'s token wherever its best logit leads the next by more than
  twice the tolerance.
* ``SELF`` (rtol = atol = 1e-5): the port's decode against its own
  forward, float32 sums of other lengths and orders.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as r_configs
from repro.configs import base as r_base
from repro.models import transformer as r_tf
from repro.serve.engine import ServeEngine as RServeEngine
from repro.serve.engine import make_prefill_step as r_make_prefill_step
from repro_torch import configs
from repro_torch.configs import base
from repro_torch.kernels import flash_attention as fa
from repro_torch.models import transformer as tf
from repro_torch.serve import ServeEngine, make_decode_step, make_prefill_step

F32 = dict(rtol=1e-4, atol=1e-4)
BF16 = dict(rtol=2e-2, atol=0.1)
SELF = dict(rtol=1e-5, atol=1e-5)
DENSE = ["h2o-danube-3-4b", "minitron-4b", "glm4-9b", "phi3-medium-14b"]


@pytest.fixture(autouse=True)
def one_torch_thread():
    """The suite runs several test processes on the machine's cores; torch's
    intra-op threads in each would contend for them (the results do not
    depend on the thread count)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@functools.lru_cache(maxsize=None)
def _model(name: str, dtype: str = "float32"):
    """(port cfg, port params on the CPU, repro cfg, repro params): the
    reduced config at 2 layers, ``repro``'s ``init_lm`` from key 0."""
    cfg = base.reduced(configs.get_arch_config(name), n_layers=2,
                       dtype=dtype)
    rcfg = r_base.reduced(r_configs.get_arch_config(name), n_layers=2,
                          dtype=dtype)
    rparams, _ = r_tf.init_lm(rcfg, jax.random.PRNGKey(0))
    params = tf.params_from_numpy(jax.tree.map(np.asarray, rparams),
                                  device="cpu")
    return cfg, params, rcfg, rparams


def _np(x) -> np.ndarray:
    if torch.is_tensor(x):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _tokens(cfg, shape, seed: int) -> np.ndarray:
    return np.random.default_rng(seed).integers(
        0, cfg.vocab_size, shape).astype(np.int32)


@pytest.mark.parametrize("name", DENSE)
def test_lm_forward_matches_repro(name):
    """80 tokens in 32-key chunks: past the reduced h2o's 64-token window."""
    cfg, params, rcfg, rparams = _model(name)
    tok = _tokens(cfg, (2, 80), 1)
    got, aux = tf.lm_forward(cfg, params, torch.from_numpy(tok).long(),
                             chunk=32)
    want = jax.jit(lambda p, t: r_tf.lm_forward(rcfg, p, t, chunk=32)[0])(
        rparams, tok)
    assert tuple(got.shape) == (2, 80, cfg.padded_vocab)
    assert float(aux) == 0.0
    np.testing.assert_allclose(_np(got), _np(want), **F32)


@pytest.mark.parametrize("name", DENSE)
def test_decode_steps_and_prefill_match_repro(name):
    """Six decode steps from an empty cache, and the prefill's
    last-position logits."""
    cfg, params, rcfg, rparams = _model(name)
    tok = _tokens(cfg, (2, 6), 2)
    cache = tf.init_cache(cfg, 2, 16, device="cpu")
    rcache, _ = r_tf.init_cache(rcfg, 2, 16)
    step = jax.jit(lambda p, c, t, i: r_tf.lm_decode_step(rcfg, p, c, t, i))
    for t in range(6):
        got, cache = tf.lm_decode_step(
            cfg, params, cache, torch.from_numpy(tok[:, t:t + 1]).long(), t)
        want, rcache = step(rparams, rcache, tok[:, t:t + 1], t)
        np.testing.assert_allclose(_np(got), _np(want), **F32)
    got = make_prefill_step(cfg)(params, dict(tokens=torch.from_numpy(tok)))
    want = jax.jit(r_make_prefill_step(rcfg))(rparams, dict(tokens=tok))
    assert tuple(got.shape) == (2, cfg.padded_vocab)
    np.testing.assert_allclose(_np(got), _np(want), **F32)


@pytest.mark.parametrize("name", DENSE)
def test_generate_equals_repro(name):
    """``tests/test_system.py``'s shape: B = 3, a 5-token prompt, 8 new
    tokens, ``max_len`` 32. Tokens equal; int64 on the params' device."""
    cfg, params, rcfg, rparams = _model(name)
    prompts = _tokens(cfg, (3, 5), 3)
    got = ServeEngine(cfg, params, max_len=32).generate(prompts, 8)
    want = RServeEngine(cfg=rcfg, params=rparams, max_len=32).generate(
        jnp.asarray(prompts), 8)
    assert got.dtype == torch.int64 and got.device.type == "cpu"
    assert tuple(got.shape) == (3, 8)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_generate_over_a_wrapping_ring_equals_repro():
    """``window_override=8``: the cache holds 8 slots and wraps over the 5
    prompt and 20 new tokens."""
    cfg, params, rcfg, rparams = _model("h2o-danube-3-4b")
    prompts = _tokens(cfg, (3, 5), 4)
    engine = ServeEngine(cfg, params, max_len=32, window_override=8)
    got = engine.generate(prompts, 20)
    want = RServeEngine(cfg=rcfg, params=rparams, max_len=32,
                        window_override=8).generate(jnp.asarray(prompts), 20)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert torch.equal(engine.generate(prompts, 20), got)


def test_bfloat16_logits_and_greedy_choices_match_repro():
    """bfloat16: the forward's logits within ``BF16``; then ``repro``'s
    greedy run (prompt 5, 20 new tokens over a ring of 8) replayed through
    the port's decode step by step, logits within ``BF16`` and the same
    token wherever ``repro``'s lead exceeds twice the tolerance."""
    cfg, params, rcfg, rparams = _model("h2o-danube-3-4b", "bfloat16")
    tok = _tokens(cfg, (2, 80), 5)
    got, _ = tf.lm_forward(cfg, params, torch.from_numpy(tok).long(),
                           chunk=32)
    want = jax.jit(lambda p, t: r_tf.lm_forward(rcfg, p, t, chunk=32)[0])(
        rparams, tok)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(_np(got), _np(want), **BF16)

    prompts = _tokens(cfg, (3, 5), 6)
    seq = np.concatenate([prompts, np.asarray(RServeEngine(
        cfg=rcfg, params=rparams, max_len=32, window_override=8).generate(
            jnp.asarray(prompts), 20))], axis=1)
    cache = tf.init_cache(cfg, 3, 32, window_override=8, device="cpu")
    rcache, _ = r_tf.init_cache(rcfg, 3, 32, window_override=8)
    step = jax.jit(lambda p, c, t, i: r_tf.lm_decode_step(rcfg, p, c, t, i))
    decided = 0
    for t in range(seq.shape[1] - 1):
        got, cache = tf.lm_decode_step(
            cfg, params, cache, torch.from_numpy(seq[:, t:t + 1]).long(), t)
        want, rcache = step(rparams, rcache, seq[:, t:t + 1], t)
        g, w = _np(got)[:, 0, :cfg.vocab_size], _np(want)[:, 0, :cfg.vocab_size]
        np.testing.assert_allclose(g, w, **BF16)
        if t < prompts.shape[1] - 1:
            continue
        top2 = np.sort(w, axis=-1)[:, -2:]
        clear = top2[:, 1] - top2[:, 0] > 2 * BF16["atol"]
        np.testing.assert_array_equal(g.argmax(-1)[clear], seq[clear, t + 1])
        decided += int(clear.sum())
    assert decided >= 30, decided


@pytest.mark.parametrize("name", DENSE)
def test_decode_matches_forward_inside_the_port(name):
    """The port's decode path, token by token, gives its own forward's
    logits (``tests/test_arch_smoke.py``'s check, on the port alone)."""
    cfg, params, _, _ = _model(name)
    tok = torch.from_numpy(_tokens(cfg, (2, 6), 7)).long()
    decode = make_decode_step(cfg)
    cache = tf.init_cache(cfg, 2, 16, device="cpu")
    outs = []
    for t in range(6):
        logits, cache = decode(params, cache, tok[:, t:t + 1], t)
        outs.append(logits[:, 0])
    want, _ = tf.lm_forward(cfg, params, tok)
    np.testing.assert_allclose(_np(torch.stack(outs, 1)), _np(want), **SELF)


def test_serving_on_the_cpu_launches_no_kernel():
    cfg, params, _, _ = _model("h2o-danube-3-4b")
    fa.flash_attention.launches = 0
    ServeEngine(cfg, params, max_len=32).generate(_tokens(cfg, (2, 3), 8), 4)
    make_prefill_step(cfg)(params, dict(tokens=torch.zeros((1, 9),
                                                           dtype=torch.long)))
    assert fa.flash_attention.launches == 0


def test_init_cache_shapes_and_default_device():
    cfg, _, rcfg, _ = _model("h2o-danube-3-4b")
    cache = tf.init_cache(cfg, 3, 256, device="cpu")
    rcache, _ = r_tf.init_cache(rcfg, 3, 256)
    assert len(cache) == len(rcache) == 1
    for name in ("k", "v"):
        assert tuple(cache[0]["kv"][name].shape) == rcache[0]["kv"][name].shape
        assert cache[0]["kv"][name].dtype == torch.float32
        assert not cache[0]["kv"][name].any()
    if not torch.cuda.is_available():
        with pytest.raises((RuntimeError, AssertionError)):
            tf.init_cache(cfg, 1, 8)          # the default device is cuda


@pytest.mark.parametrize("name,what", [
    ("granite-moe-3b-a800m", "MoE FFNs"),
    ("deepseek-v2-lite-16b", "MLA attention"),
    ("llama-3.2-vision-11b", "cross-attention")])
def test_other_layer_kinds_raise(name, what):
    cfg = base.reduced(configs.get_arch_config(name))
    tok = torch.zeros((1, 2), dtype=torch.long)
    with pytest.raises(NotImplementedError, match=what):
        tf.lm_forward(cfg, {}, tok)
    with pytest.raises(NotImplementedError, match=what):
        make_prefill_step(cfg)({}, dict(tokens=tok))
    with pytest.raises(NotImplementedError, match=what):
        tf.init_cache(cfg, 1, 8, device="cpu")
    with pytest.raises(NotImplementedError, match=what):
        tf.lm_decode_step(cfg, {}, (), tok[:, :1], 0)
