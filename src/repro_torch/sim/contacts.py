"""D2D contact dynamics (port of ``repro.sim.contacts``, dense backend).

Two non-busy nodes inside a shared Replication Zone that *newly* come
within the transmission radius connect (setup ``t0``), snapshot their
model instances and exchange them one at a time (``T_L`` each, in a
per-connection random order), staying busy until the exchange finishes
or the contact breaks.

The O(N²) sweep runs in ``repro_torch.kernels.contacts``. As in ``repro``
the structure depends on the device: on the CPU, :func:`pairwise_close`
builds the shared packed contact matrix and the partner-proximity bit is
read from it (:func:`partner_close_bit`); on a CUDA device
:func:`pairwise_close` returns no matrix, the proximity bit comes from the
O(N) recompute :func:`pair_still_close`, and :func:`match_candidates`
launches the fused kernel once per slot. Both give the same bits.

Every function takes a leading batch axis ``B``.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch import random as jr
from repro_torch.kernels.contacts import (apply_access, candidate_best_ref,
                                          pairwise_close_ref,
                                          pairwise_contacts)
from repro_torch.numerics import fma32
from repro_torch.sim.compute import run_param, to_int32_bits

__all__ = [
    "take_nodes", "mutualize", "pair_still_close", "pairwise_close",
    "match_candidates", "partner_close_bit", "advance_exchanges",
    "compute_deliveries", "form_connections",
]


def take_nodes(arr: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``arr[b, idx[b, n], ...]`` for ``arr`` ``(B, N, ...)`` and ``idx``
    ``(B, N')`` of valid node indices."""
    trail = arr.shape[2:]
    full = idx.reshape(*idx.shape, *([1] * len(trail))).expand(
        *idx.shape, *trail)
    return torch.gather(arr, 1, full.to(torch.int64))


def mutualize(best: torch.Tensor, has: torch.Tensor) -> torch.Tensor:
    """Keep ``best[i]`` only where i and best[i] each have a candidate and
    point at each other; -1 elsewhere (``best`` may hold -1 sentinels)."""
    n = best.shape[-1]
    bidx = best.clamp(min=0)                 # -1 rows fail the `has` gate
    mutual = ((take_nodes(best, bidx) == torch.arange(n, device=best.device))
              & has & take_nodes(has, bidx))
    return torch.where(mutual, best, -1)


def _clip_partner(partner):
    return partner.clamp(0, partner.shape[-1] - 1)


def pair_still_close(pos, zw, partner, r_tx2, access=None):
    """O(N) row of the contact matrix at ``(i, partner[i])``: within radius
    and still sharing a zone (bitwise ``close[i, partner[i]]``)."""
    zw = apply_access(zw, access)
    pidx = _clip_partner(partner)
    n = partner.shape[-1]
    dx = pos[..., 0] - take_nodes(pos[..., 0], pidx)
    dy = pos[..., 1] - take_nodes(pos[..., 1], pidx)
    d2 = fma32(dx, dx, dy * dy)
    return ((d2 <= r_tx2) & ((zw & take_nodes(zw, pidx)) != 0)
            & (torch.arange(n, device=pidx.device) != pidx))


def pairwise_close(pos, zw, r_tx2, access=None):
    """Shared stage of the sweep: ``(closew, ctx)``.

    On the CPU ``closew`` is this slot's packed contact matrix and ``ctx``
    carries it with the squared distances; on a CUDA device ``closew`` is
    None and ``ctx`` carries the kernel's inputs."""
    zw = apply_access(zw, access)
    x = pos[..., 0].contiguous()
    y = pos[..., 1].contiguous()
    if x.is_cuda:
        return None, (x, y, zw, r_tx2)
    closew, d2 = pairwise_close_ref(x, y, zw, r_tx2)
    return closew, (closew, d2)


def match_candidates(ctx, prevw, elig):
    """Per-run stage: ``(closew, match)`` — the packed contact matrix (the
    next ``prev_close``) and the mutual-best partner among new, eligible
    contacts (or -1)."""
    if ctx[0].is_cuda:
        x, y, zw, r_tx2 = ctx
        closew, best, has = pairwise_contacts(x, y, zw, elig, prevw, r_tx2)
    else:
        closew, d2 = ctx
        best, has = candidate_best_ref(d2, closew, prevw, elig)
    return closew, mutualize(best, has)


def partner_close_bit(closew, partner):
    """``close[i, partner[i]]`` read from the packed contact matrix."""
    pidx = _clip_partner(partner)
    word = torch.gather(closew, -1, (pidx // 32)[..., None].to(torch.int64))
    return ((word[..., 0] >> (pidx % 32)) & 1) != 0


def advance_exchanges(*, partner, exch_elapsed, exch_total, still_close, dt):
    """Tick ongoing exchanges: ``(elapsed, done, broke, ending, eff_time,
    pidx)``; ``eff_time`` is the time usable for transfers."""
    busy = partner >= 0
    pidx = _clip_partner(partner)
    still = still_close & busy
    elapsed = torch.where(busy, exch_elapsed + dt, 0.0)
    done = busy & (elapsed >= exch_total)
    broke = busy & ~still & ~done
    ending = done | broke
    eff_time = torch.where(done, exch_total, (elapsed - dt).clamp(min=0.0))
    return elapsed, done, broke, ending, eff_time, pidx


def compute_deliveries(*, order_seed, snap_has, snap, pidx, eff_time, ending,
                       t0, T_L):
    """Per (receiver, model) delivery flags of exchanges ending this slot,
    and the sender's packed snapshot words.

    Instance with send rank ``r`` is delivered iff ``t0 + (r + 1) T_L``
    fits in the effective contact time (``t0`` and ``T_L`` numbers or
    float32 ``(B,)`` tensors). At M = 1 the lone instance has rank 0 and
    no per-connection draw is made."""
    sender_has = take_nodes(snap_has, pidx)
    sender_words = take_nodes(snap, pidx)
    m_count = snap_has.shape[-1]
    if m_count == 1:
        if torch.is_tensor(t0):
            fin = run_param(t0 + T_L, eff_time.dim())
        else:
            fin = float(np.float32(t0) + np.float32(T_L))
        delivered = sender_has & (fin <= eff_time)[..., None]
        return delivered & ending[..., None], sender_words
    # per-connection send order: uniform(fold_in(PRNGKey(0), seed)), ranked
    keys = jr.fold_in(jr.PRNGKey(0, device=order_seed.device),
                      take_nodes(order_seed, pidx))
    rnd = jr.uniform(keys, (m_count,))
    rnd = torch.where(sender_has, rnd, float("inf"))
    rank = rnd.argsort(dim=-1, stable=True).argsort(dim=-1, stable=True)
    fin = fma32((rank + 1).float(), run_param(T_L, rank.dim()),
                run_param(t0, rank.dim()))
    delivered = sender_has & (fin <= eff_time[..., None])
    return delivered & ending[..., None], sender_words


def form_connections(*, partner, match, has_model, inc, snap, snap_has,
                     exch_elapsed, exch_total, order_seed, slot_idx: int,
                     t0, T_L):
    """Start the exchanges of this slot's mutually matched pairs: planned
    busy time ``t0 + (n_i + n_j) T_L``, snapshots of ``has_model`` and the
    packed ``inc`` words, and the send-order seed."""
    n = partner.shape[-1]
    newly = match >= 0
    midx = match.clamp(0, n - 1)
    n_own = has_model.sum(-1)
    n_exch = n_own + take_nodes(n_own, midx)
    total = fma32(n_exch.float(), run_param(T_L, n_exch.dim()),
                  run_param(t0, n_exch.dim()))
    seed = (((int(slot_idx) * 2654435761) & 0xFFFFFFFF)
            + torch.arange(n, device=partner.device)) & 0xFFFFFFFF
    return dict(
        partner=torch.where(newly, match, partner),
        exch_elapsed=torch.where(newly, 0.0, exch_elapsed),
        exch_total=torch.where(newly, total, exch_total),
        snap=torch.where(newly[..., None, None], inc, snap),
        snap_has=torch.where(newly[..., None], has_model, snap_has),
        order_seed=torch.where(newly, to_int32_bits(seed), order_seed),
    )
