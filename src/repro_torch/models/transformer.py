"""Decoder LM over a repeating pattern of LayerSpecs (port of
``repro.models.transformer``): the initialiser, the forward pass, the
decode step and its caches, and the carry-over of parameters to and from
numpy.

:func:`init_lm` returns ``repro``'s nested dict: the same keys, shapes and
dtypes, and, from the same key, the same values bit for bit. ``blocks``
is a tuple with one dict per pattern position, each leaf stacked on a
leading ``repeats`` axis. ``repro`` scans the layers over that axis; the
port loops over it in Python (``remat`` does not apply to inference).
:func:`hidden_forward`, :func:`lm_forward`, :func:`init_cache` and
:func:`lm_decode_step` serve the dense-attention patterns; Mamba layers,
MoE FFNs, MLA attention, cross-attention and encoders raise
``NotImplementedError``. ``act_spec``, a sharding constraint in ``repro``,
is accepted only as ``None``. :func:`lm_decode_step` writes the KV cache in
place (``repro`` returns a new one) and returns the same tuple.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch import random as jr
from repro_torch.configs.base import ArchConfig
from repro_torch.models import attention as attn
from repro_torch.models.layers import (DTYPES, embed_init, ffn_apply,
                                       rmsnorm, rmsnorm_init, swiglu_init)
from repro_torch.tree import tree_map

__all__ = ["init_lm", "hidden_forward", "lm_forward", "init_cache",
           "lm_decode_step", "params_from_numpy", "params_to_numpy",
           "stack_replicas"]


def _check_supported(cfg: ArchConfig, what: str = "init_lm") -> None:
    found = [what for what, hit in (
        ("Mamba layers", any(s.kind == "mamba" for s in cfg.pattern)),
        ("MoE FFNs", any(s.moe for s in cfg.pattern)),
        ("MLA attention", cfg.is_mla),
        ("cross-attention", any(s.cross_attn for s in cfg.pattern)),
        ("an encoder", cfg.encoder is not None and cfg.encoder.n_layers > 0),
    ) if hit]
    if found:
        raise NotImplementedError(
            f"{what}: {', '.join(found)} of {cfg.name} come with the "
            f"model-zoo slice of the port (ROADMAP §1); the port runs "
            f"dense-attention patterns only")


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


def _block_forward(p, cfg: ArchConfig, x, window, chunk: int):
    """One dense-attention block: pre-norm attention, then the pre-norm
    FFN, each added to the residual stream."""
    h = rmsnorm(x, p["norm_mix"], cfg.norm_eps)
    x = x + attn.gqa_forward(p["attn"], cfg, h, causal=True, window=window,
                             chunk=chunk)
    if cfg.d_ff > 0:
        h = rmsnorm(x, p["norm_ffn"], cfg.norm_eps)
        x = x + ffn_apply(p["ffn"], h, cfg.act)
    return x


def _layers(cfg: ArchConfig, stacked):
    """``(repeat, pattern position, that layer's tree)`` in execution
    order: the body of ``repro``'s scan over the repeat axis."""
    for r in range(cfg.repeats):
        for i in range(len(cfg.pattern)):
            yield r, i, tree_map(lambda a: a[r], stacked[i])


def _unembed(cfg: ArchConfig, params):
    return params["embed"].T if cfg.tie_embeddings else params["unembed"]


def hidden_forward(cfg: ArchConfig, params, tokens, *, enc_embeds=None,
                   window_override: int | None = None, chunk: int = 1024,
                   act_spec=None):
    """tokens ``(B, S)`` -> final hidden states ``(B, S, d)``. Returns
    ``(x, aux)``; ``aux`` (the MoE loss in ``repro``) is a float32 zero."""
    _check_supported(cfg, "hidden_forward")
    if act_spec is not None:
        raise NotImplementedError("act_spec: the port has no sharding yet")
    x = params["embed"][tokens]
    window = window_override if window_override is not None else cfg.window
    for _, _, bp in _layers(cfg, params["blocks"]):
        x = _block_forward(bp, cfg, x, window, chunk)
    x = rmsnorm(x, params["norm_f"], cfg.norm_eps)
    return x, torch.zeros((), dtype=torch.float32, device=x.device)


def lm_forward(cfg: ArchConfig, params, tokens, *, enc_embeds=None,
               window_override: int | None = None, chunk: int = 1024,
               act_spec=None):
    """tokens ``(B, S)`` -> logits ``(B, S, padded_vocab)``. Returns
    ``(logits, aux)``."""
    x, aux = hidden_forward(cfg, params, tokens, enc_embeds=enc_embeds,
                            window_override=window_override, chunk=chunk,
                            act_spec=act_spec)
    return x @ _unembed(cfg, params), aux


def init_cache(cfg: ArchConfig, batch: int, max_len: int, *,
               window_override: int | None = None, device=None):
    """The decode caches, a tuple over pattern positions of
    ``dict(kv=dict(k=..., v=...))``, each leaf ``(repeats, batch, L, Hkv,
    hd)`` zeros (``L = min(max_len, window)``) on ``device`` (default
    ``cuda``)."""
    _check_supported(cfg, "init_cache")
    window = window_override if window_override is not None else cfg.window
    one = attn.init_kv_cache(cfg, batch, max_len, window=window,
                             dtype=DTYPES[cfg.dtype], device=device)
    return tuple(
        dict(kv={k: torch.zeros((cfg.repeats, *t.shape), dtype=t.dtype,
                                device=t.device) for k, t in one.items()})
        for _ in cfg.pattern)


def lm_decode_step(cfg: ArchConfig, params, cache, token, index: int, *,
                   window_override: int | None = None, chunk: int = 2048):
    """One decode step. token ``(B, 1)``; ``index`` (a host integer): the
    tokens already cached. Returns ``(logits (B, 1, padded_vocab),
    cache)``, the cache written in place."""
    _check_supported(cfg, "lm_decode_step")
    x = params["embed"][token]
    for r, i, p in _layers(cfg, params["blocks"]):
        kv = {k: t[r] for k, t in cache[i]["kv"].items()}
        h = rmsnorm(x, p["norm_mix"], cfg.norm_eps)
        h, _ = attn.gqa_decode(p["attn"], cfg, h, kv, index, chunk=chunk)
        x = x + h
        if cfg.d_ff > 0:
            h = rmsnorm(x, p["norm_ffn"], cfg.norm_eps)
            x = x + ffn_apply(p["ffn"], h, cfg.act)
    x = rmsnorm(x, params["norm_f"], cfg.norm_eps)
    return x @ _unembed(cfg, params), cache


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
