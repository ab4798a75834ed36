"""GQA attention (port of ``repro.models.attention``): the initialiser,
blockwise online-softmax attention, full-sequence self-attention and
one-token decode against a ring-buffer KV cache.

Routing by the tensors' device:

* on a CPU tensor, :func:`gqa_forward` and :func:`gqa_decode` compute what
  ``repro`` does: the KV heads repeated, then :func:`blockwise_attention`
  (a chunked online softmax), so the CPU path holds to ``repro`` as
  closely as the arithmetic allows;
* on a CUDA tensor both go through
  :func:`repro_torch.kernels.ops.attention_op`, the ``flash_attention``
  kernel: the prefill as ``causal=True`` with the window over Sq = Skv,
  the decode as ``causal=False, window=None`` over the cache view
  ``[:, :n_valid]``, which holds exactly the keys that ``repro``'s
  ``valid_len`` leaves unmasked (a non-causal softmax does not care about
  the ring's order).

``repro``'s ``head_constraint`` and logical axis names describe sharding
and are not ported. Cross-attention (``kv_src``, ``cross_prefill``,
``cross_decode``) comes with the model-zoo slice. :func:`gqa_decode`
writes the new key and value into the cache in place, where ``repro``
returns a new cache; it returns the same dict.
"""

from __future__ import annotations

import operator

import torch
import torch.nn.functional as F

from repro_torch import random as jr
from repro_torch.kernels.ops import attention_op
from repro_torch.models.layers import DTYPES, dense_init, rope, rope_at

__all__ = ["init_gqa", "gqa_qkv", "gqa_forward", "gqa_decode",
           "init_kv_cache", "blockwise_attention", "cross_prefill",
           "cross_decode"]

NEG_INF = -1e30


def init_gqa(key, cfg) -> dict:
    """``wq`` ``(d, H·hd)``, ``wk`` and ``wv`` ``(d, Hkv·hd)``, ``wo``
    ``(H·hd, d)``, mapped over the keys' leading axes."""
    d, hd, H, Hkv = cfg.d_model, cfg.hd, cfg.n_heads, cfg.n_kv_heads
    ks = jr.split(key, 4)
    dt = DTYPES[cfg.dtype]
    return dict(
        wq=dense_init(ks[..., 0, :], d, H * hd, dt),
        wk=dense_init(ks[..., 1, :], d, Hkv * hd, dt),
        wv=dense_init(ks[..., 2, :], d, Hkv * hd, dt),
        wo=dense_init(ks[..., 3, :], H * hd, d, dt, scale=(H * hd) ** -0.5),
    )


def blockwise_attention(q, k, v, *, causal: bool, window: int | None = None,
                        q_offset: int = 0, chunk: int = 1024, valid_len=None):
    """Online-softmax attention over KV chunks.

    q: ``(B, Sq, Hkv, G, D)``; k, v: ``(B, Skv, Hkv, D)``. Positions of q
    are ``q_offset + arange(Sq)``, of k ``arange(Skv)``; ``valid_len``
    masks out cache slots from it on. Returns ``(B, Sq, Hkv, G, D)`` in
    q's dtype.
    """
    B, Sq, Hkv, G, D = q.shape
    Skv = k.shape[1]
    chunk = min(chunk, Skv)
    n_chunks = -(-Skv // chunk)
    pad = n_chunks * chunk - Skv
    if pad:
        k = F.pad(k, (0, 0, 0, 0, 0, pad))
        v = F.pad(v, (0, 0, 0, 0, 0, pad))
    dev = q.device
    q32 = q.float() * D ** -0.5
    q_pos = q_offset + torch.arange(Sq, device=dev)
    m = torch.full((B, Sq, Hkv, G), NEG_INF, dtype=torch.float32, device=dev)
    l = torch.zeros((B, Sq, Hkv, G), dtype=torch.float32, device=dev)
    acc = torch.zeros((B, Sq, Hkv, G, D), dtype=torch.float32, device=dev)
    for c in range(n_chunks):
        kb = k[:, c * chunk:(c + 1) * chunk].float()
        vb = v[:, c * chunk:(c + 1) * chunk].float()
        k_pos = c * chunk + torch.arange(chunk, device=dev)
        s = torch.einsum("bqhgd,bkhd->bqhgk", q32, kb)
        mask = (k_pos < Skv)[None, :].expand(Sq, chunk)
        if causal:
            mask = mask & (q_pos[:, None] >= k_pos[None, :])
        if window is not None:
            mask = mask & (q_pos[:, None] - k_pos[None, :] < window)
        if valid_len is not None:
            mask = mask & (k_pos < valid_len)[None, :]
        s = torch.where(mask[None, :, None, None, :], s, NEG_INF)
        m_new = torch.maximum(m, s.amax(dim=-1))
        p = torch.exp(s - m_new[..., None])
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(dim=-1)
        acc = acc * corr[..., None] + torch.einsum("bqhgk,bkhd->bqhgd", p, vb)
        m = m_new
    out = acc / l.clamp_min(1e-30)[..., None]
    return out.to(q.dtype)


def _split_heads(x, H: int, hd: int):
    return x.reshape(*x.shape[:-1], H, hd)


def gqa_qkv(params, cfg, x, positions=None):
    """The rotated q ``(B, S, H, hd)`` and k, v ``(B, S, Hkv, hd)`` of a
    self-attention over x ``(B, S, d)`` (positions default ``arange(S)``)."""
    B, S, _ = x.shape
    H, Hkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    q = _split_heads(x @ params["wq"], H, hd)
    k = _split_heads(x @ params["wk"], Hkv, hd)
    v = _split_heads(x @ params["wv"], Hkv, hd)
    if positions is None:
        positions = torch.arange(S, device=x.device).expand(B, S)
    return rope(q, positions, cfg.rope_theta), rope(k, positions,
                                                    cfg.rope_theta), v


def gqa_forward(params, cfg, x, *, causal: bool = True,
                window: int | None = None, kv_src=None, positions=None,
                chunk: int = 1024):
    """Full-sequence self-attention over x ``(B, S, d)``; returns ``(B, S,
    d)``. CPU: KV heads repeated, then :func:`blockwise_attention` in
    ``chunk``-key chunks; CUDA: the ``flash_attention`` kernel."""
    if kv_src is not None:
        raise NotImplementedError("gqa_forward: cross-attention comes with "
                                  "the model-zoo slice of the port")
    B, S, _ = x.shape
    H, Hkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    q, k, v = gqa_qkv(params, cfg, x, positions)
    if x.device.type == "cuda":
        out = attention_op(q, k, v, causal=causal, window=window)
    else:
        G = H // Hkv
        out = blockwise_attention(
            q.reshape(B, S, H, 1, hd), k.repeat_interleave(G, dim=2),
            v.repeat_interleave(G, dim=2), causal=causal, window=window,
            chunk=chunk)
    return out.reshape(B, S, H * hd) @ params["wo"]


def init_kv_cache(cfg, batch: int, max_len: int, *, window: int | None,
                  dtype, device=None) -> dict:
    """Ring-buffer KV cache of one attention layer: ``k`` and ``v`` zeros of
    ``(batch, L, Hkv, hd)``, ``L = min(max_len, window)`` (``max_len``
    without a window), on ``device`` (default ``cuda``)."""
    L = min(max_len, window) if window else max_len
    device = torch.device("cuda" if device is None else device)
    shape = (batch, L, cfg.n_kv_heads, cfg.hd)
    return dict(k=torch.zeros(shape, dtype=dtype, device=device),
                v=torch.zeros(shape, dtype=dtype, device=device))


def gqa_decode(params, cfg, x, cache, index: int, *, window=None,
               chunk: int = 2048):
    """One-token decode. x ``(B, 1, d)``; ``index``, a host integer, counts
    the tokens already cached (the new token's position). The rotated key
    and the value go into slot ``index mod L`` of the cache, in place;
    attention then covers the ``min(index + 1, L)`` filled slots. Returns
    ``(out (B, 1, d), cache)``. ``window`` is unused, as in ``repro``: the
    ring's length bounds what is seen."""
    index = operator.index(index)
    B = x.shape[0]
    H, Hkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    L = cache["k"].shape[1]
    q = _split_heads(x @ params["wq"], H, hd)
    k = _split_heads(x @ params["wk"], Hkv, hd)
    v = _split_heads(x @ params["wv"], Hkv, hd)
    q = rope_at(q, index, cfg.rope_theta)
    k = rope_at(k, index, cfg.rope_theta)
    ck, cv = cache["k"], cache["v"]
    slot = index % L
    ck[:, slot] = k[:, 0].to(ck.dtype)
    cv[:, slot] = v[:, 0].to(cv.dtype)
    n_valid = min(index + 1, L)
    if x.device.type == "cuda":
        out = attention_op(q, ck[:, :n_valid], cv[:, :n_valid],
                           causal=False, window=None)
    else:
        out = blockwise_attention(
            q.reshape(B, 1, Hkv, H // Hkv, hd), ck, cv, causal=False,
            window=None, valid_len=n_valid, chunk=chunk)
    return out.reshape(B, 1, H * hd) @ params["wo"], cache


def cross_prefill(params, cfg, enc_out):
    raise NotImplementedError("cross_prefill comes with the model-zoo slice "
                              "of the port")


def cross_decode(params, cfg, x, cross_cache, chunk: int = 2048):
    raise NotImplementedError("cross_decode comes with the model-zoo slice "
                              "of the port")
