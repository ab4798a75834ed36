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
:func:`lm_decode_step` serve patterns of GQA attention and Mamba-2 layers
(dense FFNs or none); MoE FFNs, MLA attention, cross-attention and
encoders raise ``NotImplementedError``. ``act_spec``, a sharding constraint
in ``repro``, is accepted only as ``None``. :func:`lm_decode_step` writes
the KV and SSM caches in place (``repro`` returns new ones) and returns
the same tuple.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch import random as jr
from repro_torch.configs.base import ArchConfig, LayerSpec
from repro_torch.models import attention as attn
from repro_torch.models import mamba as mam
from repro_torch.models.layers import (DTYPES, embed_init, ffn_apply,
                                       rmsnorm, rmsnorm_init, swiglu_init)
from repro_torch.tree import tree_map

__all__ = ["init_lm", "hidden_forward", "lm_forward", "init_cache",
           "lm_decode_step", "params_from_numpy", "params_to_numpy",
           "stack_replicas"]


def _check_supported(cfg: ArchConfig, what: str = "init_lm") -> None:
    found = [what for what, hit in (
        ("MoE FFNs", any(s.moe for s in cfg.pattern)),
        ("MLA attention", cfg.is_mla),
        ("cross-attention", any(s.cross_attn for s in cfg.pattern)),
        ("an encoder", cfg.encoder is not None and cfg.encoder.n_layers > 0),
    ) if hit]
    if found:
        raise NotImplementedError(
            f"{what}: {', '.join(found)} of {cfg.name} come with the "
            f"model-zoo slice of the port (ROADMAP §1); the port runs "
            f"GQA attention and Mamba-2 layers with dense FFNs only")


def _init_block(keys, cfg: ArchConfig, spec: LayerSpec) -> dict:
    """A block's parameters for each of the ``(n, 2)`` keys (``repro``'s
    ``jax.vmap`` of ``_init_block`` over split keys), ``(n, ...)``. Of its
    six keys the block uses the first (attention or Mamba mixer) and the
    third (FFN), as ``repro``'s does for these layer kinds."""
    dt = DTYPES[cfg.dtype]
    lead = tuple(keys.shape[:-1])
    ks = jr.split(keys, 6)
    p = dict(norm_mix=rmsnorm_init(cfg.d_model, dt, lead, keys.device))
    if spec.kind == "attn":
        p["attn"] = attn.init_gqa(ks[..., 0, :], cfg)
    else:
        p["mamba"] = mam.init_mamba(ks[..., 0, :], cfg)
    if cfg.d_ff > 0:
        p["norm_ffn"] = rmsnorm_init(cfg.d_model, dt, lead, keys.device)
        p["ffn"] = swiglu_init(ks[..., 2, :], cfg.d_model, cfg.d_ff, dt,
                               cfg.act)
    return p


def _init_stack(key, cfg: ArchConfig, spec: LayerSpec, n: int) -> dict:
    return _init_block(jr.split(key, n), cfg, spec)


def init_lm(cfg: ArchConfig, key, device=None) -> dict:
    """The LM's parameters from ``key`` (a ``repro_torch.random.PRNGKey``),
    on ``device`` (default ``cuda``)."""
    _check_supported(cfg)
    device = torch.device("cuda" if device is None else device)
    key = key.to(device)
    dt = DTYPES[cfg.dtype]
    ks = jr.split(key, 4 + len(cfg.pattern))
    p = dict(embed=embed_init(ks[0], cfg.padded_vocab, cfg.d_model, dt))
    p["blocks"] = tuple(_init_stack(ks[1 + i], cfg, spec, cfg.repeats)
                        for i, spec in enumerate(cfg.pattern))
    p["norm_f"] = rmsnorm_init(cfg.d_model, dt, device=device)
    if not cfg.tie_embeddings:
        p["unembed"] = (jr.normal(ks[-2], (cfg.d_model, cfg.padded_vocab))
                        * float(np.float32(cfg.d_model ** -0.5))).to(dt)
    return p


def _block_forward(p, cfg: ArchConfig, spec: LayerSpec, x, window,
                   chunk: int):
    """One block: the pre-norm mixer (attention or Mamba), then the
    pre-norm FFN where there is one, each added to the residual stream."""
    h = rmsnorm(x, p["norm_mix"], cfg.norm_eps)
    if spec.kind == "attn":
        x = x + attn.gqa_forward(p["attn"], cfg, h, causal=True,
                                 window=window, chunk=chunk)
    else:
        x = x + mam.mamba_forward(p["mamba"], cfg, h)
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
    for _, i, bp in _layers(cfg, params["blocks"]):
        x = _block_forward(bp, cfg, cfg.pattern[i], x, window, chunk)
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
    """The decode caches, a tuple over pattern positions of zeros on
    ``device`` (default ``cuda``), each leaf with a leading ``repeats``
    axis: ``dict(kv=dict(k=..., v=...))`` for attention, each ``(repeats,
    batch, L, Hkv, hd)`` (``L = min(max_len, window)``);
    ``dict(ssm=dict(state=..., conv=...))`` for Mamba, ``(repeats, batch,
    H, N, P)`` float32 and ``(repeats, batch, K-1, conv_ch)``."""
    _check_supported(cfg, "init_cache")
    window = window_override if window_override is not None else cfg.window
    dt = DTYPES[cfg.dtype]
    caches = []
    for spec in cfg.pattern:
        if spec.kind == "attn":
            name, one = "kv", attn.init_kv_cache(
                cfg, batch, max_len, window=window, dtype=dt, device=device)
        else:
            name, one = "ssm", mam.init_mamba_cache(cfg, batch, dt, device)
        caches.append({name: {k: torch.zeros((cfg.repeats, *t.shape),
                                             dtype=t.dtype, device=t.device)
                              for k, t in one.items()}})
    return tuple(caches)


def lm_decode_step(cfg: ArchConfig, params, cache, token, index: int, *,
                   window_override: int | None = None, chunk: int = 2048):
    """One decode step. token ``(B, 1)``; ``index`` (a host integer): the
    tokens already cached. Returns ``(logits (B, 1, padded_vocab),
    cache)``, the cache written in place."""
    _check_supported(cfg, "lm_decode_step")
    x = params["embed"][token]
    for r, i, p in _layers(cfg, params["blocks"]):
        h = rmsnorm(x, p["norm_mix"], cfg.norm_eps)
        if cfg.pattern[i].kind == "attn":
            kv = {k: t[r] for k, t in cache[i]["kv"].items()}
            h, _ = attn.gqa_decode(p["attn"], cfg, h, kv, index, chunk=chunk)
        else:
            ssm = {k: t[r] for k, t in cache[i]["ssm"].items()}
            h, _ = mam.mamba_decode(p["mamba"], cfg, h, ssm)
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
