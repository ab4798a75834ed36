"""Serving runtime: batched prefill and one-token decode with KV and SSM
caches (port of ``repro.serve.engine``).

``make_prefill_step`` and ``make_decode_step`` return the functions that
``repro`` jits; the port calls them eagerly (no ``jit``, no CUDA graph).
``ServeEngine`` is the host-side greedy loop: the prompt goes through the
decode path token by token, as in ``repro``, then ``n_new`` tokens are
chosen by argmax over the real vocabulary. On CUDA parameters every
attention runs the ``flash_attention`` kernel and every Mamba layer of a
prefill the ``ssd_scan`` kernel (a Mamba decode step is the plain
recurrence); on CPU parameters the plain path. Models of GQA attention
and Mamba-2 layers (see :mod:`repro_torch.models.transformer`).
"""

from __future__ import annotations

import dataclasses
from typing import Any

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.models.transformer import (hidden_forward, init_cache,
                                            lm_decode_step)

__all__ = ["make_prefill_step", "make_decode_step", "ServeEngine"]


def make_prefill_step(cfg: ArchConfig, *, window_override=None, chunk=1024,
                      act_spec=None):
    """``prefill(params, batch)`` -> the last position's logits ``(B,
    padded_vocab)``; ``batch["tokens"]`` is ``(B, S)``."""

    def prefill(params, batch):
        x, _ = hidden_forward(
            cfg, params, batch["tokens"], enc_embeds=batch.get("enc_embeds"),
            window_override=window_override, chunk=chunk, act_spec=act_spec)
        unembed = (params["embed"].T if cfg.tie_embeddings
                   else params["unembed"])
        return x[:, -1, :] @ unembed   # only the last position's logits

    return prefill


def make_decode_step(cfg: ArchConfig, *, window_override=None, chunk=2048):
    """``decode(params, cache, token, index)`` -> ``(logits, cache)``: one
    new token against a cache holding ``index`` earlier tokens."""

    def decode(params, cache, token, index):
        return lm_decode_step(cfg, params, cache, token, index,
                              window_override=window_override, chunk=chunk)

    return decode


@dataclasses.dataclass
class ServeEngine:
    """Minimal batched greedy serving loop."""

    cfg: ArchConfig
    params: Any
    max_len: int = 256
    window_override: int | None = None

    def __post_init__(self):
        self._decode = make_decode_step(self.cfg,
                                        window_override=self.window_override)

    def generate(self, prompt_tokens, n_new: int, enc_embeds=None):
        """prompt_tokens ``(B, P)`` (a tensor or array of token ids) ->
        ``(B, n_new)`` int64 greedy continuation on the parameters'
        device."""
        if enc_embeds is not None:
            raise NotImplementedError("ServeEngine: encoder inputs come with "
                                      "the model-zoo slice of the port")
        dev = self.params["embed"].device
        prompt = torch.as_tensor(prompt_tokens, device=dev).long()
        B, plen = prompt.shape
        cache = init_cache(self.cfg, B, self.max_len,
                           window_override=self.window_override, device=dev)
        vocab = self.cfg.vocab_size
        logits = None
        for t in range(plen):
            logits, cache = self._decode(self.params, cache,
                                         prompt[:, t:t + 1], t)
        tok = logits[:, -1:, :vocab].argmax(dim=-1)
        out = []
        for i in range(n_new):
            out.append(tok[:, 0])
            logits, cache = self._decode(self.params, cache, tok, plen + i)
            tok = logits[:, -1:, :vocab].argmax(dim=-1)
        return torch.stack(out, dim=1)
