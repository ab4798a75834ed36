"""Public wrappers around the port's kernels (port of
``repro.kernels.ops``).

``gossip_merge_op`` merges a parameter tree leaf by leaf through
:func:`repro_torch.kernels.gossip_merge.gossip_merge`, ``attention_op``
is the GQA attention of
:func:`repro_torch.kernels.flash_attention.flash_attention`, and ``ssd_op``
is the Mamba-2 scan of :func:`repro_torch.kernels.ssd_scan.ssd_scan`: each the
CUDA kernel on a CUDA tensor, its plain version on a CPU tensor.
"""

from __future__ import annotations

import torch

from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.kernels.gossip_merge import gossip_merge
from repro_torch.kernels.ssd_scan import ssd_scan
from repro_torch.tree import tree_items, tree_map

__all__ = ["attention_op", "ssd_op", "gossip_merge_op"]


def attention_op(q, k, v, *, causal: bool = True, window: int | None = None):
    """GQA attention. q ``(B, Sq, H, D)``; k, v ``(B, Skv, Hkv, D)`` with
    ``H % Hkv == 0``; returns ``(B, Sq, H, D)``. Query head ``h`` reads KV
    head ``h // (H // Hkv)`` (``repro``'s ``jnp.repeat`` of the KV heads)
    without a repeated copy. ``repro``'s TPU block sizes and ``interpret``
    have no counterpart here."""
    return flash_attention(q, k, v, causal=causal, window=window)


def ssd_op(x, dt, A, B_, C_, D, *, chunk: int = 128,
           return_state: bool = False):
    """The SSD scan. x ``(B, S, H, P)``; dt ``(B, S, H)``; A, D ``(H,)``;
    B_, C_ ``(B, S, G, N)``. Returns y ``(B, S, H, P)`` in x's dtype, and
    with ``return_state`` also the final state ``(B, H, N, P)`` float32
    (``repro``'s ``_ssd_chunked`` returns it; its ``ssd_op`` does not).
    ``repro``'s ``interpret`` has no counterpart here."""
    return ssd_scan(x, dt, A, B_, C_, D, chunk=chunk,
                    return_state=return_state)


def gossip_merge_op(own_tree, peer_tree, w_own, success):
    """Leafwise ``success ? w_own*own + (1-w_own)*peer : own`` over two
    trees of one structure. ``w_own`` and ``success`` are one value each,
    a tensor on the leaves' device or a Python number; as in ``repro``,
    ``success`` counts as true where it exceeds 0.5."""
    items = tree_items(own_tree)
    if not items:
        return own_tree
    dev = items[0][1].device
    w = torch.as_tensor(w_own, dtype=torch.float32, device=dev).reshape(())
    s = (torch.as_tensor(success, dtype=torch.float32, device=dev)
         > 0.5).reshape(())
    return tree_map(lambda a, b: gossip_merge(a, b, w, s), own_tree,
                    peer_tree)
