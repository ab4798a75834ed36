"""GQA attention, the initialiser (port of ``repro.models.attention``).

The forward path (``gqa_forward`` over ``blockwise_attention``) comes with
the trainer.
"""

from __future__ import annotations

from repro_torch import random as jr
from repro_torch.models.layers import DTYPES, dense_init

__all__ = ["init_gqa"]


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
