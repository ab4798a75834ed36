"""Shared neural building blocks, the initialisers and the forward
functions (port of ``repro.models.layers``).

Each initialiser draws with :mod:`repro_torch.random`, bit for bit
``repro``'s ``jax.random`` draws, and maps over the keys' leading axes as
``jax.vmap`` over a batch of keys does: a ``(n, 2)`` batch of keys gives
``(n, ...)`` parameters. Unlike ``repro``'s, they return the parameters
alone: the logical axis names that ``repro`` returns beside them name mesh
shardings, which the port does not have yet.

The forward functions (``rmsnorm``, ``rope``, ``rope_at``, ``ffn_apply``)
compute ``repro``'s in its dtypes: float32 statistics and angles, results
cast back to the input dtype where ``repro`` casts. Matrix products are
``torch.matmul``, as ``repro`` leaves them to XLA. cos and sin may differ
from XLA's by an ulp, so a rotated value agrees with ``repro``'s to a
tolerance, not bit for bit.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch import random as jr

__all__ = ["DTYPES", "dense_init", "rmsnorm_init", "rmsnorm", "embed_init",
           "rope", "rope_at", "swiglu_init", "ffn_apply"]

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def _scaled_normal(key, shape, scale: float, dtype) -> torch.Tensor:
    """``(normal(key, shape, float32) * scale).astype(dtype)``: the scale
    rounded to float32 as JAX rounds a Python number, one float32
    multiply, then one rounding (to nearest even) to ``dtype``."""
    return (jr.normal(key, shape) * float(np.float32(scale))).to(dtype)


def dense_init(key, d_in: int, d_out: int, dtype,
               scale: float | None = None) -> torch.Tensor:
    """``(d_in, d_out)`` weights, normal with std ``scale`` (default
    ``d_in ** -0.5``)."""
    scale = scale if scale is not None else d_in ** -0.5
    return _scaled_normal(key, (d_in, d_out), scale, dtype)


def rmsnorm_init(d: int, dtype, lead: tuple = (), device=None) -> torch.Tensor:
    """Ones of shape ``(*lead, d)``."""
    return torch.ones((*lead, d), dtype=dtype, device=device)


def rmsnorm(x: torch.Tensor, scale: torch.Tensor, eps: float) -> torch.Tensor:
    """``x / rms(x)`` with the mean of squares in float32, cast back to
    ``x``'s dtype, then times ``scale`` in that dtype."""
    x32 = x.float()
    var = x32.square().mean(dim=-1, keepdim=True)
    return (x32 * torch.rsqrt(var + eps)).to(x.dtype) * scale


def embed_init(key, vocab: int, d: int, dtype) -> torch.Tensor:
    return _scaled_normal(key, (vocab, d), 0.02, dtype)


def _rope_freqs(head_dim: int, theta: float, device=None) -> torch.Tensor:
    return theta ** (-torch.arange(0, head_dim, 2, dtype=torch.float32,
                                   device=device) / head_dim)


def rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """Rotary embeddings on split halves (not interleaved). x: ``(..., S,
    H, D)``; positions: ``(..., S)``. Computed in float32, cast back to
    ``x``'s dtype."""
    d = x.shape[-1]
    freqs = _rope_freqs(d, theta, x.device)                  # (D/2,)
    ang = positions[..., None].to(torch.float32) * freqs     # (..., S, D/2)
    cos, sin = ang.cos()[..., None, :], ang.sin()[..., None, :]
    x1, x2 = x[..., : d // 2], x[..., d // 2:]
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def rope_at(x: torch.Tensor, pos: int, theta: float) -> torch.Tensor:
    """Rotary at one decode position ``pos`` (a host integer). x: ``(B, 1,
    H, D)``."""
    positions = torch.full((x.shape[0], 1), pos, dtype=torch.int32,
                           device=x.device)
    return rope(x, positions, theta)


def swiglu_init(key, d: int, d_ff: int, dtype, act: str = "swiglu") -> dict:
    """The FFN's weights: ``wi``, ``wg`` and ``wo`` for SwiGLU, ``wi`` and
    ``wo`` for GELU (which skips the second of three keys)."""
    ks = jr.split(key, 3)
    params = dict(wi=dense_init(ks[..., 0, :], d, d_ff, dtype))
    if act == "swiglu":
        params["wg"] = dense_init(ks[..., 1, :], d, d_ff, dtype)
    params["wo"] = dense_init(ks[..., 2, :], d_ff, d, dtype, scale=d_ff**-0.5)
    return params


def ffn_apply(params: dict, x: torch.Tensor, act: str = "swiglu") -> torch.Tensor:
    """SwiGLU ``(silu(x@wg) * (x@wi)) @ wo``, or GELU (tanh form, JAX's
    default) ``gelu(x@wi) @ wo``."""
    if act == "swiglu":
        h = F.silu(x @ params["wg"]) * (x @ params["wi"])
    else:
        h = F.gelu(x @ params["wi"], approximate="tanh")
    return h @ params["wo"]
