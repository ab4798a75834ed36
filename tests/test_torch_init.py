"""The port's architecture configs and LM initialiser against ``repro``'s
(tolerance: none, every value bit for bit).

``init_lm`` draws with ``repro_torch.random``, so from the same key it
gives ``repro``'s parameters: the same tree, shapes, dtypes and bits.
``jax.vmap`` of the block initialiser over split keys is the port's draw
over a batch of keys. The full-width tree of the gossip round's
configuration (h2o-danube-3-4b cut to two layers) is checked for its
structure on torch's ``meta`` device, which allocates nothing.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro import configs as r_configs
from repro.configs import base as r_base
from repro.models.transformer import abstract_lm as r_abstract_lm
from repro.models.transformer import init_lm as r_init_lm
from repro_torch import configs
from repro_torch import random as jr
from repro_torch.configs import base
from repro_torch.configs.base import LayerSpec
from repro_torch.models.transformer import (init_lm, params_from_numpy,
                                            params_to_numpy, stack_replicas)
from repro_torch.tree import tree_items


@pytest.fixture(autouse=True)
def one_torch_thread():
    """The suite runs several test processes on the machine's cores; torch's
    intra-op threads in each would contend for them (the results do not
    depend on the thread count)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


DENSE = ["glm4-9b", "h2o-danube-3-4b", "minitron-4b", "phi3-medium-14b"]
#: Dense-attention variants beyond the registry: two pattern positions,
#: GELU with tied embeddings, and no FFN.
VARIANTS = {
    "two-positions-gelu-tied": dict(pattern=(LayerSpec(), LayerSpec()),
                                    n_layers=4, act="gelu",
                                    tie_embeddings=True),
    "no-ffn": dict(d_ff=0, n_layers=2),
}


def _fields(cfg) -> dict:
    return dataclasses.asdict(cfg)


def test_registry_equals_repro():
    assert configs.list_archs() == r_configs.list_archs()
    for name in configs.list_archs():
        cfg, want = configs.get_arch_config(name), r_configs.get_arch_config(
            name)
        assert _fields(cfg) == _fields(want), name
        assert base.param_count(cfg) == r_base.param_count(want), name
        assert base.param_count(cfg, active_only=True) == r_base.param_count(
            want, active_only=True), name
        assert _fields(base.reduced(cfg)) == _fields(r_base.reduced(want))
        assert (cfg.repeats, cfg.hd, cfg.padded_vocab, cfg.is_mla) == (
            want.repeats, want.hd, want.padded_vocab, want.is_mla)
    with pytest.raises(KeyError, match="unknown arch"):
        configs.get_arch_config("gpt-5")


def _port_and_repro(name: str, dtype: str, **over):
    cfg = base.reduced(configs.get_arch_config(name), dtype=dtype, **over)
    want = r_base.reduced(r_configs.get_arch_config(name), dtype=dtype,
                          **{k: _to_repro(v) for k, v in over.items()})
    return cfg, want


def _to_repro(v):
    if isinstance(v, tuple) and v and isinstance(v[0], LayerSpec):
        return tuple(r_base.LayerSpec(**dataclasses.asdict(s)) for s in v)
    return v


def _assert_same_tree(got: dict, want, what: str) -> None:
    want = {jax.tree_util.keystr(p, simple=True, separator="/"): np.asarray(v)
            for p, v in jax.tree_util.tree_leaves_with_path(want)}
    got = dict(tree_items(params_to_numpy(got)))
    assert sorted(got) == sorted(want), what
    for path, w in want.items():
        g = got[path]
        assert (g.dtype, g.shape) == (w.dtype, w.shape), f"{what} {path}"
        np.testing.assert_array_equal(g.view(np.uint8), w.view(np.uint8),
                                      err_msg=f"{what} {path}")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", DENSE)
def test_init_lm_equals_repro_bit_for_bit(name, dtype):
    cfg, want_cfg = _port_and_repro(name, dtype, n_layers=2)
    got = init_lm(cfg, jr.PRNGKey(11), device="cpu")
    assert isinstance(got["blocks"], tuple) and len(got["blocks"]) == 1
    _assert_same_tree(got, r_init_lm(want_cfg, jax.random.PRNGKey(11))[0],
                      f"{name} {dtype}")


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_init_lm_variants_equal_repro(variant):
    cfg, want_cfg = _port_and_repro("h2o-danube-3-4b", "bfloat16",
                                    **VARIANTS[variant])
    got = init_lm(cfg, jr.PRNGKey(3), device="cpu")
    assert len(got["blocks"]) == len(cfg.pattern)
    _assert_same_tree(got, r_init_lm(want_cfg, jax.random.PRNGKey(3))[0],
                      variant)


def test_full_width_tree_of_the_gossip_configuration():
    """h2o-danube-3-4b at its published widths, cut to 2 of its 24 layers:
    ``repro``'s tree (12 leaves, 561,335,040 parameters, bfloat16)."""
    cfg = configs.get_arch_config("h2o-danube-3-4b", n_layers=2)
    want = r_abstract_lm(r_configs.get_arch_config("h2o-danube-3-4b",
                                                   n_layers=2))[0]
    want = {jax.tree_util.keystr(p, simple=True, separator="/"): v
            for p, v in jax.tree_util.tree_leaves_with_path(want)}
    got = dict(tree_items(init_lm(cfg, jr.PRNGKey(0), device="meta")))
    assert sorted(got) == sorted(want) and len(got) == 12
    for path, w in want.items():
        assert tuple(got[path].shape) == w.shape, path
        assert str(w.dtype) == "bfloat16", path
        assert got[path].dtype == torch.bfloat16, path
    assert sum(v.numel() for v in got.values()) == 561_335_040


@pytest.mark.parametrize("name,what", [
    ("granite-moe-3b-a800m", "MoE FFNs"),
    ("deepseek-v2-lite-16b", "MLA attention"),
    ("llama-3.2-vision-11b", "cross-attention"),
    ("whisper-small", "an encoder"), ("jamba-v0.1-52b", "MoE FFNs")])
def test_other_layer_kinds_raise(name, what):
    cfg = base.reduced(configs.get_arch_config(name))
    with pytest.raises(NotImplementedError, match=what) as err:
        init_lm(cfg, jr.PRNGKey(0), device="cpu")
    assert "model-zoo slice" in str(err.value)


def test_carry_over_round_trips_exactly():
    """``repro``'s parameters through ``np.asarray`` (bfloat16 leaves
    included) go to tensors and back bit for bit, keeping the nesting."""
    want_cfg = r_base.reduced(r_configs.get_arch_config("h2o-danube-3-4b"),
                              dtype="bfloat16")
    params = r_init_lm(want_cfg, jax.random.PRNGKey(4))[0]
    params["extra"] = np.arange(5, dtype=np.float32)
    host = jax.tree.map(np.asarray, params)
    tensors = params_from_numpy(host, device="cpu")
    assert isinstance(tensors["blocks"], tuple)
    assert tensors["embed"].dtype == torch.bfloat16
    assert tensors["extra"].dtype == torch.float32
    _assert_same_tree(tensors, params, "carry-over")
    back = params_to_numpy(tensors)
    for (path, g), (_, w) in zip(tree_items(back), tree_items(
            jax.tree.map(np.asarray, host))):
        assert g.dtype == w.dtype and np.array_equal(
            g.view(np.uint8), w.view(np.uint8)), path


def test_stack_replicas_gives_every_leaf_a_leading_axis():
    cfg = base.reduced(configs.get_arch_config("h2o-danube-3-4b"),
                       d_model=64, head_dim=16, d_ff=64, vocab_size=128)
    reps = [init_lm(cfg, jr.PRNGKey(k), device="cpu") for k in range(3)]
    stacked = stack_replicas(reps)
    assert isinstance(stacked["blocks"], tuple)
    for path, leaf in tree_items(stacked):
        assert leaf.is_contiguous() and leaf.shape[0] == 3, path
        for i, rep in enumerate(reps):
            assert torch.equal(leaf[i], dict(tree_items(rep))[path]), path
