"""Mamba-2 (SSD, state-space duality) mixer (port of
``repro.models.mamba``): the initialiser, the full-sequence forward, the
decode cache and the one-token recurrent step.

Shapes as in ``repro``'s code: x ``(B, S, H, P)``, dt ``(B, S, H)``, A
``(H,)`` positive (the decay is ``exp(-dt·A)``), B and C ``(B, S, G, N)``
with G groups over the heads. The decode cache holds the SSM state ``(B,
H, N, P)`` float32 and the convolution's last ``K - 1`` inputs.

Routing by the tensors' device: :func:`mamba_forward` runs the scan
through :func:`repro_torch.kernels.ops.ssd_op`, the ``ssd_scan`` kernel on
a CUDA tensor and its plain chunked scan (:func:`_ssd_chunked`, the one
plain scan of the port) on a CPU tensor. :func:`mamba_decode` is the
recurrence in plain torch on either device, as in ``repro``: one token is
no scan. It writes the cache in place (``repro`` returns a new one) and
returns the same dict. As in ``repro``, the forward's convolution runs in
the model dtype and the decode's in float32, and the gate is
``rmsnorm(y * silu(z))``. ``repro``'s ``head_constraint`` and logical
axis names describe sharding and are not ported.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch import random as jr
from repro_torch.kernels.ops import ssd_op
from repro_torch.kernels.ssd_scan import ssd_scan_ref
from repro_torch.models.layers import DTYPES, dense_init, rmsnorm, rmsnorm_init
from repro_torch.numerics import linspace32, log32

__all__ = ["init_mamba", "mamba_scan_inputs", "mamba_forward",
           "init_mamba_cache", "mamba_decode"]

#: ``repro``'s chunked scan, ``(y float32, final state)``: the kernel's
#: plain version, the one plain scan of the port.
_ssd_chunked = ssd_scan_ref


def init_mamba(key, cfg) -> dict:
    """``in_proj`` ``(d, 2·d_inner + 2·G·N + H)``, ``conv_w`` ``(K,
    conv_ch)``, ``conv_b``, ``A_log = log(linspace(1, 16, H))``, ``D``,
    ``dt_bias``, ``norm`` and ``out_proj`` ``(d_inner, d)``, mapped over
    the keys' leading axes; bit for bit ``repro``'s from the same key."""
    d = cfg.d_model
    di, G, N, H = cfg.d_inner, cfg.ssm_groups, cfg.ssm_state, cfg.ssm_heads
    K = cfg.conv_kernel
    dt = DTYPES[cfg.dtype]
    lead, dev = tuple(key.shape[:-1]), key.device
    ks = jr.split(key, 5)
    conv_ch = di + 2 * G * N
    a_log = log32(linspace32(1.0, 16.0, H, device=dev))
    return dict(
        in_proj=dense_init(ks[..., 0, :], d, 2 * di + 2 * G * N + H, dt),
        conv_w=(jr.normal(ks[..., 1, :], (K, conv_ch))
                * float(np.float32(K ** -0.5))).to(dt),
        conv_b=torch.zeros((*lead, conv_ch), dtype=dt, device=dev),
        A_log=a_log.expand(*lead, H).clone(),
        D=torch.ones((*lead, H), dtype=torch.float32, device=dev),
        dt_bias=torch.zeros((*lead, H), dtype=torch.float32, device=dev),
        norm=rmsnorm_init(di, dt, lead, dev),
        out_proj=dense_init(ks[..., 2, :], di, d, dt, scale=di ** -0.5),
    )


def _silu(x):
    """``x * sigmoid(x)``, the sigmoid as ``1 / (1 + exp(-x))``, each
    operation rounded to x's dtype: ``jax.nn.silu`` as XLA expands it
    (``F.silu`` rounds once, which in bfloat16 moved the reduced model's
    logits by up to 3.4x the bfloat16 tolerance against ``repro``)."""
    return x * (1.0 / (1.0 + torch.exp(-x)))


def _softplus(x):
    """``jax.nn.softplus``: ``max(x, 0) + log1p(exp(-|x|))``."""
    return torch.clamp_min(x, 0.0) + torch.log1p(torch.exp(-x.abs()))


def _split_proj(cfg, proj):
    """``(z, xBC, dt_raw)``: views of ``proj``'s last axis."""
    di, G, N, H = cfg.d_inner, cfg.ssm_groups, cfg.ssm_state, cfg.ssm_heads
    return torch.split(proj, [di, di + 2 * G * N, H], dim=-1)


def _causal_conv(xBC, w, b, prev_tail=None):
    """Depthwise causal convolution along the sequence, then SiLU, in
    xBC's dtype. xBC ``(B, S, ch)``; w ``(K, ch)``; ``prev_tail`` ``(B,
    K-1, ch)`` (zeros by default)."""
    K, S = w.shape[0], xBC.shape[1]
    if prev_tail is None:
        prev_tail = torch.zeros((xBC.shape[0], K - 1, xBC.shape[2]),
                                dtype=xBC.dtype, device=xBC.device)
    xp = torch.cat([prev_tail, xBC], dim=1)               # (B, S+K-1, ch)
    out = sum(xp[:, i:i + S] * w[i][None, None, :] for i in range(K))
    return _silu(out + b[None, None, :])


def mamba_scan_inputs(params, cfg, u):
    """The scan's inputs from u ``(B, S, d)``: ``(z, x, dt, A, B_, C_)``.
    x, B_ and C_ are views of the convolved ``xBC`` buffer (no copy); dt
    ``softplus(dt_raw + dt_bias)`` and ``A = exp(A_log)`` in float32."""
    Bb, S, _ = u.shape
    di, G, N, H, P = (cfg.d_inner, cfg.ssm_groups, cfg.ssm_state,
                      cfg.ssm_heads, cfg.ssm_head_dim)
    z, xBC, dt_raw = _split_proj(cfg, u @ params["in_proj"])
    xBC = _causal_conv(xBC, params["conv_w"], params["conv_b"])
    xs, B_, C_ = torch.split(xBC, [di, G * N, G * N], dim=-1)
    dt = _softplus(dt_raw.float() + params["dt_bias"][None, None, :])
    return (z, xs.reshape(Bb, S, H, P), dt, torch.exp(params["A_log"]),
            B_.reshape(Bb, S, G, N), C_.reshape(Bb, S, G, N))


def mamba_forward(params, cfg, u, *, return_state: bool = False):
    """u ``(B, S, d)`` -> ``(B, S, d)``; with ``return_state`` also the
    SSM state after the last token ``(B, H, N, P)`` float32."""
    Bb, S, _ = u.shape
    z, x, dt, A, B_, C_ = mamba_scan_inputs(params, cfg, u)
    y = ssd_op(x, dt, A, B_, C_, params["D"], chunk=cfg.ssm_chunk,
               return_state=return_state)
    if return_state:
        y, state = y
    y = y.reshape(Bb, S, cfg.d_inner).to(u.dtype)
    y = rmsnorm(y * _silu(z), params["norm"], cfg.norm_eps)
    out = y @ params["out_proj"]
    return (out, state) if return_state else out


def init_mamba_cache(cfg, batch: int, dtype, device=None) -> dict:
    """One Mamba layer's decode cache on ``device`` (default ``cuda``):
    ``state`` ``(batch, H, N, P)`` float32 and ``conv`` ``(batch, K-1,
    conv_ch)`` in ``dtype``, zeros."""
    di, G, N, H, P = (cfg.d_inner, cfg.ssm_groups, cfg.ssm_state,
                      cfg.ssm_heads, cfg.ssm_head_dim)
    device = torch.device("cuda" if device is None else device)
    return dict(
        state=torch.zeros((batch, H, N, P), dtype=torch.float32,
                          device=device),
        conv=torch.zeros((batch, cfg.conv_kernel - 1, di + 2 * G * N),
                         dtype=dtype, device=device))


def mamba_decode(params, cfg, u, cache):
    """One-token recurrent step. u ``(B, 1, d)``. Writes the new state and
    convolution tail into ``cache`` in place; returns ``(out (B, 1, d),
    cache)``."""
    Bb = u.shape[0]
    di, G, N, H, P = (cfg.d_inner, cfg.ssm_groups, cfg.ssm_state,
                      cfg.ssm_heads, cfg.ssm_head_dim)
    z, xBC, dt_raw = _split_proj(cfg, u @ params["in_proj"])

    tail = cache["conv"]                                  # (B, K-1, ch)
    xp = torch.cat([tail, xBC.to(tail.dtype)], dim=1)     # (B, K, ch)
    conv_out = torch.einsum("bkc,kc->bc", xp.float(),
                            params["conv_w"].float()) + params["conv_b"].float()
    xBC1 = _silu(conv_out)[:, None, :].to(u.dtype)
    tail.copy_(xp[:, 1:])

    xs, B_, C_ = torch.split(xBC1, [di, G * N, G * N], dim=-1)
    x = xs.reshape(Bb, H, P).float()
    rep = H // G
    Bh = B_.reshape(Bb, G, N).float().repeat_interleave(rep, dim=1)
    Ch = C_.reshape(Bb, G, N).float().repeat_interleave(rep, dim=1)
    dt = _softplus(dt_raw[:, 0].float() + params["dt_bias"])
    decay = torch.exp(-dt * torch.exp(params["A_log"])[None, :])   # (B, H)

    st = decay[:, :, None, None] * cache["state"] + torch.einsum(
        "bh,bhn,bhp->bhnp", dt, Bh, x)
    cache["state"].copy_(st)
    y = torch.einsum("bhn,bhnp->bhp", Ch, st) + params["D"][None, :, None] * x
    y = y.reshape(Bb, 1, di).to(u.dtype)
    y = rmsnorm(y * _silu(z), params["norm"], cfg.norm_eps)
    return y @ params["out_proj"], cache
