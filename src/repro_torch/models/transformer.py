"""Decoder LM parameters over a repeating pattern of LayerSpecs: the
initialiser (port of ``repro.models.transformer``, ``init_lm`` and its
helpers) and the carry-over of parameters to and from numpy.

:func:`init_lm` returns ``repro``'s nested dict: the same keys, shapes and
dtypes, and, from the same key, the same values bit for bit. ``blocks``
is a tuple with one dict per pattern position, each leaf stacked on a
leading ``repeats`` axis (``repro`` scans the layers over it). The forward
pass comes with the trainer. This slice initialises dense-attention
patterns only; Mamba layers, MoE FFNs, MLA attention, cross-attention and
encoders raise ``NotImplementedError``.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch import random as jr
from repro_torch.configs.base import ArchConfig
from repro_torch.models import attention as attn
from repro_torch.models.layers import (DTYPES, embed_init, rmsnorm_init,
                                       swiglu_init)
from repro_torch.tree import tree_map

__all__ = ["init_lm", "params_from_numpy", "params_to_numpy",
           "stack_replicas"]


def _check_supported(cfg: ArchConfig) -> None:
    found = [what for what, hit in (
        ("Mamba layers", any(s.kind == "mamba" for s in cfg.pattern)),
        ("MoE FFNs", any(s.moe for s in cfg.pattern)),
        ("MLA attention", cfg.is_mla),
        ("cross-attention", any(s.cross_attn for s in cfg.pattern)),
        ("an encoder", cfg.encoder is not None and cfg.encoder.n_layers > 0),
    ) if hit]
    if found:
        raise NotImplementedError(
            f"init_lm: {', '.join(found)} of {cfg.name} come with the "
            f"model-zoo slice of the port (ROADMAP §1 item 8); this slice "
            f"initialises dense-attention patterns only")


def _init_block(keys, cfg: ArchConfig) -> dict:
    """A dense-attention block's parameters for each of the ``(n, 2)``
    keys (``repro``'s ``jax.vmap`` of ``_init_block`` over split keys),
    ``(n, ...)``. Of its six keys the block uses the first (attention) and
    the third (FFN), as ``repro``'s does for this layer kind."""
    dt = DTYPES[cfg.dtype]
    lead = tuple(keys.shape[:-1])
    ks = jr.split(keys, 6)
    p = dict(norm_mix=rmsnorm_init(cfg.d_model, dt, lead, keys.device))
    p["attn"] = attn.init_gqa(ks[..., 0, :], cfg)
    if cfg.d_ff > 0:
        p["norm_ffn"] = rmsnorm_init(cfg.d_model, dt, lead, keys.device)
        p["ffn"] = swiglu_init(ks[..., 2, :], cfg.d_model, cfg.d_ff, dt,
                               cfg.act)
    return p


def _init_stack(key, cfg: ArchConfig, n: int) -> dict:
    return _init_block(jr.split(key, n), cfg)


def init_lm(cfg: ArchConfig, key, device=None) -> dict:
    """The LM's parameters from ``key`` (a ``repro_torch.random.PRNGKey``),
    on ``device`` (default ``cuda``)."""
    _check_supported(cfg)
    device = torch.device("cuda" if device is None else device)
    key = key.to(device)
    dt = DTYPES[cfg.dtype]
    ks = jr.split(key, 4 + len(cfg.pattern))
    p = dict(embed=embed_init(ks[0], cfg.padded_vocab, cfg.d_model, dt))
    p["blocks"] = tuple(_init_stack(ks[1 + i], cfg, cfg.repeats)
                        for i in range(len(cfg.pattern)))
    p["norm_f"] = rmsnorm_init(cfg.d_model, dt, device=device)
    if not cfg.tie_embeddings:
        p["unembed"] = (jr.normal(ks[-2], (cfg.d_model, cfg.padded_vocab))
                        * float(np.float32(cfg.d_model ** -0.5))).to(dt)
    return p


def params_from_numpy(tree, device=None):
    """A tree of numpy arrays (``repro``'s parameters through
    ``np.asarray``, bfloat16 leaves included) as tensors on ``device``
    (default ``cuda``), bit for bit."""
    device = torch.device("cuda" if device is None else device)

    def one(a):
        a = np.array(a)                      # a writable copy
        if a.dtype.name == "bfloat16":
            return torch.from_numpy(a.view(np.int16)).view(
                torch.bfloat16).to(device)
        return torch.from_numpy(a).to(device)

    return tree_map(one, tree)


def params_to_numpy(tree):
    """A tree of tensors as numpy arrays on the host, bit for bit;
    bfloat16 leaves become ``ml_dtypes.bfloat16`` arrays (the type
    ``np.asarray`` gives a JAX bfloat16 array)."""
    def one(t):
        t = t.detach().cpu()
        if t.dtype == torch.bfloat16:
            import ml_dtypes

            return t.view(torch.int16).numpy().view(ml_dtypes.bfloat16)
        return t.numpy()

    return tree_map(one, tree)


def stack_replicas(trees):
    """R trees of one structure as one tree whose leaves carry a leading
    replica axis of size R (the layout of ``repro``'s gossip round)."""
    return tree_map(lambda *xs: torch.stack(xs), *trees)
