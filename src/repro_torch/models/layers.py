"""Shared neural building blocks, the initialisers (port of
``repro.models.layers``).

Each initialiser draws with :mod:`repro_torch.random`, bit for bit
``repro``'s ``jax.random`` draws, and maps over the keys' leading axes as
``jax.vmap`` over a batch of keys does: a ``(n, 2)`` batch of keys gives
``(n, ...)`` parameters. Unlike ``repro``'s, they return the parameters
alone: the logical axis names that ``repro`` returns beside them name mesh
shardings, which the port does not have yet. The forward functions
(``rmsnorm``, ``rope``, ``ffn_apply``) come with the trainer.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch import random as jr

__all__ = ["DTYPES", "dense_init", "rmsnorm_init", "embed_init",
           "swiglu_init"]

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


def embed_init(key, vocab: int, d: int, dtype) -> torch.Tensor:
    return _scaled_normal(key, (vocab, d), 0.02, dtype)


def swiglu_init(key, d: int, d_ff: int, dtype, act: str = "swiglu") -> dict:
    """The FFN's weights: ``wi``, ``wg`` and ``wo`` for SwiGLU, ``wi`` and
    ``wo`` for GELU (which skips the second of three keys)."""
    ks = jr.split(key, 3)
    params = dict(wi=dense_init(ks[..., 0, :], d, d_ff, dtype))
    if act == "swiglu":
        params["wg"] = dense_init(ks[..., 1, :], d, d_ff, dtype)
    params["wo"] = dense_init(ks[..., 2, :], d_ff, d, dtype, scale=d_ff**-0.5)
    return params
