"""The port's Mamba-2 serving path against ``repro``'s on the CPU:
``init_mamba`` and ``init_lm`` bit for bit; ``mamba_forward``,
``lm_forward``, ``mamba_decode``, ``lm_decode_step``, ``make_prefill_step``
and ``ServeEngine.generate`` of the reduced mamba2-130m (d_model 256, 16
heads of 32, N = 32, chunks of 16) with ``repro``'s parameters carried
over.

Tolerances, by reason (``F32`` and ``BF16`` are
``tests/test_torch_serve.py``'s):

* ``F32`` (rtol = atol = 1e-4) on float32 logits and states: XLA and torch
  sum in other orders, and the scan's ``exp`` of cumulative sums amplifies
  that; the largest difference measured is 2.9e-5 at logits up to 4.7.
  Greedy tokens are then held **equal**.
* ``BF16`` (rtol = 2e-2, atol = 0.1) on bfloat16 logits of one layer and
  of the teacher-forced decode (largest measured: 0.031 and 0.10). Both
  sides round every bfloat16 operation (XLA's CPU code keeps the converts
  of each one), but products sum in other orders, so an activation can
  differ by an ulp.
* ``BF16_DEEP`` (rtol = 2e-2, atol = 0.5) on the bfloat16 forward's logits
  at 2 layers: an ulp of difference at layer 1's input comes out of its
  chunked scan up to 7 ulps apart (0.03 to 0.21 at |x| <= 6). Over seeds
  0-9 the two sides' logits differ by 0.08-0.21, while ``repro``'s own
  bfloat16 logits lie 0.12-0.50 from its float32 forward on the same
  weights; 0.5 is that size.
* The port's decode against its own forward over 40 tokens (3 chunks),
  and the forward's final state against the decode's, are held to ``F32``,
  not to ``test_torch_serve.py``'s ``SELF`` (1e-5): the chunked scan
  multiplies ``exp(-(csum_i - csum_j))`` where the recurrence multiplies
  one decay a step, two algorithms and not two orders of one (largest
  measured: 1.7e-5).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as r_configs
from repro.configs import base as r_base
from repro.models import mamba as r_mamba
from repro.models import transformer as r_tf
from repro.serve.engine import ServeEngine as RServeEngine
from repro.serve.engine import make_prefill_step as r_make_prefill_step
from repro_torch import configs
from repro_torch import random as jr
from repro_torch.configs import base
from repro_torch.kernels import ssd_scan as ks
from repro_torch.models import mamba
from repro_torch.models import transformer as tf
from repro_torch.serve import ServeEngine, make_decode_step, make_prefill_step
from repro_torch.tree import tree_items

F32 = dict(rtol=1e-4, atol=1e-4)
BF16 = dict(rtol=2e-2, atol=0.1)
BF16_DEEP = dict(rtol=2e-2, atol=0.5)
NAME = "mamba2-130m"


@pytest.fixture(autouse=True)
def one_torch_thread():
    """The suite runs several test processes on the machine's cores; torch's
    intra-op threads in each would contend for them (the results do not
    depend on the thread count)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _cfgs(dtype: str = "float32", **kw):
    return (base.reduced(configs.get_arch_config(NAME), dtype=dtype, **kw),
            r_base.reduced(r_configs.get_arch_config(NAME), dtype=dtype,
                           **kw))


@functools.lru_cache(maxsize=None)
def _model(dtype: str = "float32", n_layers: int = 2):
    """(port cfg, port params on the CPU, repro cfg, repro params): the
    reduced config, ``repro``'s ``init_lm`` from key 0."""
    cfg, rcfg = _cfgs(dtype, n_layers=n_layers)
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


def _repro_leaves(tree) -> dict:
    return {jax.tree_util.keystr(p, simple=True, separator="/"): v
            for p, v in jax.tree_util.tree_leaves_with_path(tree)}


def _assert_same_tree(got: dict, want, what: str) -> None:
    want = {k: np.asarray(v) for k, v in _repro_leaves(want).items()}
    got = dict(tree_items(tf.params_to_numpy(got)))
    assert sorted(got) == sorted(want), what
    for path, w in want.items():
        g = got[path]
        assert (g.dtype, g.shape) == (w.dtype, w.shape), f"{what} {path}"
        np.testing.assert_array_equal(g.view(np.uint8), w.view(np.uint8),
                                      err_msg=f"{what} {path}")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_init_mamba_equals_repro_bit_for_bit(dtype):
    cfg, rcfg = _cfgs(dtype)
    got = mamba.init_mamba(jr.PRNGKey(5), cfg)
    want, _ = r_mamba.init_mamba(jax.random.PRNGKey(5), rcfg)
    assert list(got) == list(want)
    _assert_same_tree(got, want, f"init_mamba {dtype}")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_init_lm_equals_repro_bit_for_bit(dtype):
    """The reduced config (1 layer, d_model 256, H 16, N 32, P 32)."""
    cfg, rcfg = _cfgs(dtype)
    assert (cfg.n_layers, cfg.d_model, cfg.ssm_heads, cfg.ssm_state,
            cfg.ssm_head_dim, cfg.ssm_chunk) == (1, 256, 16, 32, 32, 16)
    got = tf.init_lm(cfg, jr.PRNGKey(11), device="cpu")
    assert set(got["blocks"][0]) == {"norm_mix", "mamba"}
    _assert_same_tree(got, r_tf.init_lm(rcfg, jax.random.PRNGKey(11))[0],
                      f"init_lm {dtype}")


def test_full_width_tree_on_the_meta_device():
    """mamba2-130m at its published widths and all 24 layers: ``repro``'s
    shapes and dtypes, 172,157,376 values; ``param_count``'s formula (it
    counts 3·d of norms a layer and leaves out ``conv_b`` and
    ``dt_bias``) gives 172,149,888 for both packages."""
    cfg = configs.get_arch_config(NAME)
    rcfg = r_configs.get_arch_config(NAME)
    want = _repro_leaves(r_tf.abstract_lm(rcfg)[0])
    got = dict(tree_items(tf.init_lm(cfg, jr.PRNGKey(0), device="meta")))
    assert sorted(got) == sorted(want) and len(got) == 12
    for path, w in want.items():
        assert tuple(got[path].shape) == w.shape, path
        assert str(got[path].dtype).split(".")[-1] == str(w.dtype), path
    assert sum(v.numel() for v in got.values()) == 172_157_376
    assert base.param_count(cfg) == r_base.param_count(rcfg) == 172_149_888


def test_carry_over_round_trips_exactly():
    _, rcfg = _cfgs("bfloat16", n_layers=2)
    params = r_tf.init_lm(rcfg, jax.random.PRNGKey(4))[0]
    host = jax.tree.map(np.asarray, params)
    tensors = tf.params_from_numpy(host, device="cpu")
    assert tensors["blocks"][0]["mamba"]["A_log"].dtype == torch.float32
    assert tensors["blocks"][0]["mamba"]["in_proj"].dtype == torch.bfloat16
    _assert_same_tree(tensors, params, "carry-over")
    _assert_same_tree(tf.params_from_numpy(tf.params_to_numpy(tensors),
                                           device="cpu"), params, "back")


def test_mamba_forward_and_its_final_state_match_repro():
    """One layer over 80 tokens (5 chunks of 16), ``return_state``."""
    cfg, params, rcfg, rparams = _model()
    p = {k: v[0] for k, v in params["blocks"][0]["mamba"].items()}
    rp = jax.tree.map(lambda a: a[0], rparams["blocks"][0]["mamba"])
    u = np.random.default_rng(1).standard_normal((2, 80, cfg.d_model)).astype(
        np.float32)
    got, st = mamba.mamba_forward(p, cfg, torch.from_numpy(u),
                                  return_state=True)
    want, want_st = jax.jit(lambda p, u: r_mamba.mamba_forward(
        p, rcfg, u, return_state=True))(rp, u)
    np.testing.assert_allclose(_np(got), _np(want), **F32)
    np.testing.assert_allclose(_np(st), _np(want_st), **F32)
    assert torch.equal(mamba.mamba_forward(p, cfg, torch.from_numpy(u)), got)


def test_lm_forward_matches_repro():
    """Two layers over 80 tokens: 5 chunks of 16."""
    cfg, params, rcfg, rparams = _model()
    tok = _tokens(cfg, (2, 80), 1)
    got, aux = tf.lm_forward(cfg, params, torch.from_numpy(tok).long())
    want = jax.jit(lambda p, t: r_tf.lm_forward(rcfg, p, t)[0])(rparams, tok)
    assert tuple(got.shape) == (2, 80, cfg.padded_vocab)
    assert float(aux) == 0.0
    np.testing.assert_allclose(_np(got), _np(want), **F32)


def test_decode_steps_caches_and_prefill_match_repro():
    """Six steps of ``mamba_decode`` (one layer) and of ``lm_decode_step``
    (two) from empty caches, the caches after each step, and the
    prefill's last-position logits."""
    cfg, params, rcfg, rparams = _model()
    p = {k: v[0] for k, v in params["blocks"][0]["mamba"].items()}
    rp = jax.tree.map(lambda a: a[0], rparams["blocks"][0]["mamba"])
    u = np.random.default_rng(2).standard_normal((2, 6, cfg.d_model)).astype(
        np.float32)
    one = mamba.init_mamba_cache(cfg, 2, torch.float32, device="cpu")
    rone, _ = r_mamba.init_mamba_cache(rcfg, 2, jnp.float32)
    rdec = jax.jit(lambda p, u, c: r_mamba.mamba_decode(p, rcfg, u, c))
    for t in range(6):
        got, same = mamba.mamba_decode(p, cfg, torch.from_numpy(u[:, t:t + 1]),
                                       one)
        assert same is one
        want, rone = rdec(rp, u[:, t:t + 1], rone)
        np.testing.assert_allclose(_np(got), _np(want), **F32)
        for k in ("state", "conv"):
            np.testing.assert_allclose(_np(one[k]), _np(rone[k]), **F32)

    tok = _tokens(cfg, (2, 6), 2)
    cache = tf.init_cache(cfg, 2, 16, device="cpu")
    rcache, _ = r_tf.init_cache(rcfg, 2, 16)
    step = jax.jit(lambda p, c, t, i: r_tf.lm_decode_step(rcfg, p, c, t, i))
    for t in range(6):
        got, cache = tf.lm_decode_step(
            cfg, params, cache, torch.from_numpy(tok[:, t:t + 1]).long(), t)
        want, rcache = step(rparams, rcache, tok[:, t:t + 1], t)
        np.testing.assert_allclose(_np(got), _np(want), **F32)
        for k in ("state", "conv"):
            assert tuple(cache[0]["ssm"][k].shape) == rcache[0]["ssm"][k].shape
            np.testing.assert_allclose(_np(cache[0]["ssm"][k]),
                                       _np(rcache[0]["ssm"][k]), **F32)
    got = make_prefill_step(cfg)(params, dict(tokens=torch.from_numpy(tok)))
    want = jax.jit(r_make_prefill_step(rcfg))(rparams, dict(tokens=tok))
    assert tuple(got.shape) == (2, cfg.padded_vocab)
    np.testing.assert_allclose(_np(got), _np(want), **F32)


def test_generate_equals_repro():
    """``tests/test_system.py``'s shape: B = 3, a 5-token prompt, 8 new
    tokens. Tokens equal; int64 on the params' device."""
    cfg, params, rcfg, rparams = _model()
    prompts = _tokens(cfg, (3, 5), 3)
    engine = ServeEngine(cfg, params, max_len=32)
    got = engine.generate(prompts, 8)
    want = RServeEngine(cfg=rcfg, params=rparams, max_len=32).generate(
        jnp.asarray(prompts), 8)
    assert got.dtype == torch.int64 and got.device.type == "cpu"
    assert tuple(got.shape) == (3, 8)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert torch.equal(engine.generate(prompts, 8), got)


def test_bfloat16_logits_and_greedy_choices_match_repro():
    """bfloat16: the forward's logits at 1 layer within ``BF16`` and at 2
    within ``BF16_DEEP``; then ``repro``'s greedy run (prompt 5, 20 new
    tokens) replayed through the port's decode at 2 layers step by step,
    logits within ``BF16`` and the same token wherever ``repro``'s lead
    exceeds twice the tolerance."""
    for n_layers, tol in ((1, BF16), (2, BF16_DEEP)):
        cfg, params, rcfg, rparams = _model("bfloat16", n_layers)
        tok = _tokens(cfg, (2, 80), 5)
        got, _ = tf.lm_forward(cfg, params, torch.from_numpy(tok).long())
        want = jax.jit(lambda p, t: r_tf.lm_forward(rcfg, p, t)[0])(
            rparams, tok)
        assert got.dtype == torch.bfloat16
        np.testing.assert_allclose(_np(got), _np(want), **tol)

    prompts = _tokens(cfg, (3, 5), 6)
    seq = np.concatenate([prompts, np.asarray(RServeEngine(
        cfg=rcfg, params=rparams, max_len=32).generate(
            jnp.asarray(prompts), 20))], axis=1)
    cache = tf.init_cache(cfg, 3, 32, device="cpu")
    rcache, _ = r_tf.init_cache(rcfg, 3, 32)
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
    assert decided >= 20, decided


def test_decode_matches_forward_inside_the_port():
    """The port's decode path, token by token, gives its own forward's
    logits (``tests/test_arch_smoke.py``'s check, on the port alone), and
    the forward's final state is the decode's."""
    cfg, params, _, _ = _model()
    tok = torch.from_numpy(_tokens(cfg, (2, 40), 7)).long()
    decode = make_decode_step(cfg)
    cache = tf.init_cache(cfg, 2, 64, device="cpu")
    outs = []
    for t in range(tok.shape[1]):
        logits, cache = decode(params, cache, tok[:, t:t + 1], t)
        outs.append(logits[:, 0])
    want, _ = tf.lm_forward(cfg, params, tok)
    np.testing.assert_allclose(_np(torch.stack(outs, 1)), _np(want), **F32)
    p = {k: v[0] for k, v in params["blocks"][0]["mamba"].items()}
    u = torch.from_numpy(np.random.default_rng(8).standard_normal(
        (2, 40, cfg.d_model)).astype(np.float32))
    _, st = mamba.mamba_forward(p, cfg, u, return_state=True)
    one = mamba.init_mamba_cache(cfg, 2, torch.float32, device="cpu")
    for t in range(u.shape[1]):
        mamba.mamba_decode(p, cfg, u[:, t:t + 1], one)
    np.testing.assert_allclose(_np(st), _np(one["state"]), **F32)


def test_serving_on_the_cpu_launches_no_kernel():
    cfg, params, _, _ = _model()
    ks.ssd_scan.launches = 0
    ServeEngine(cfg, params, max_len=32).generate(_tokens(cfg, (2, 3), 8), 4)
    make_prefill_step(cfg)(params, dict(tokens=torch.zeros((1, 40),
                                                           dtype=torch.long)))
    assert ks.ssd_scan.launches == 0


def test_init_cache_shapes_and_default_device():
    cfg, _, rcfg, _ = _model("bfloat16")
    cache = tf.init_cache(cfg, 3, 256, device="cpu")
    rcache, _ = r_tf.init_cache(rcfg, 3, 256)
    assert len(cache) == len(rcache) == 1 and list(cache[0]) == ["ssm"]
    for name, dtype in (("state", torch.float32), ("conv", torch.bfloat16)):
        assert tuple(cache[0]["ssm"][name].shape) == \
            rcache[0]["ssm"][name].shape
        assert cache[0]["ssm"][name].dtype == dtype
        assert not cache[0]["ssm"][name].any()
    if not torch.cuda.is_available():
        with pytest.raises((RuntimeError, AssertionError)):
            tf.init_cache(cfg, 1, 8)          # the default device is cuda
