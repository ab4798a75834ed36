"""Packed mask words and the compute queues (port of ``repro.sim.compute``).

Packed word layout: a boolean trailing axis of length K is stored as
``ceil(K/32)`` words, bit ``j`` of word ``w`` being element ``32*w + j``
(LSB-first), pad bits zero. Words are **int32 tensors holding the uint32
bits**: torch on the CPU has no ``>>``, ``<``, ``min`` or ``gather`` on
uint32, and every set operation here (``&``, ``|``, ``^``, ``~``, and a
bit test ``(w >> b) & 1``) gives the same bits on int32. Words are viewed
as uint32 only where they cross to numpy.

Queues are ``(..., N, Q)`` tensors of model ids, ``-1`` marking a free
slot; enqueues fill free slots in ascending order and service takes the
lowest occupied slot. Every function maps over any leading batch axes.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = [
    "pack_mask", "unpack_mask", "packed_onehot", "packed_any",
    "packed_popcount", "enqueue_ascending", "advance_timers",
    "pick_next_jobs", "to_int32_bits", "run_param", "broadcast_rows",
]


def to_int32_bits(x: torch.Tensor) -> torch.Tensor:
    """int64 values in [0, 2³²) -> int32 with the same 32 bits."""
    return (x - ((x >> 31) << 32)).to(torch.int32)


def run_param(v, nd: int):
    """A dynamic parameter ready to broadcast against ``(B, ...)`` tensors
    of ``nd`` dims: a float32 tensor ``(B,)``, one value a run, is viewed
    as ``(B, 1, ..., 1)``; a Python number is rounded to float32, as
    ``repro``'s jitted program holds it."""
    if torch.is_tensor(v):
        return v.reshape(v.shape + (1,) * (nd - v.dim()))
    return float(np.float32(v))


def broadcast_rows(x: torch.Tensor, b: int) -> torch.Tensor:
    """``x`` ``(R, ...)``, one row a seed, repeated to ``b`` scenario-major
    rows (row ``i`` takes seed ``i % R``), contiguous; ``x`` itself when
    ``R == b``."""
    r = x.shape[0]
    if r == b:
        return x
    if b % r:
        raise ValueError(f"{b} rows are not a whole number of {r} seeds")
    return x.repeat(b // r, *([1] * (x.dim() - 1)))


def _bit_weights(device) -> torch.Tensor:
    return torch.ones(32, dtype=torch.int64, device=device) << torch.arange(
        32, device=device
    )


def pack_mask(mask: torch.Tensor) -> torch.Tensor:
    """Pack a trailing bool axis of length K into ``ceil(K/32)`` words."""
    k = mask.shape[-1]
    pad = (-k) % 32
    if pad:
        mask = torch.nn.functional.pad(mask, (0, pad))
    grouped = mask.reshape(*mask.shape[:-1], (k + pad) // 32, 32)
    words = (grouped.to(torch.int64) * _bit_weights(mask.device)).sum(-1)
    return to_int32_bits(words)


def unpack_mask(words: torch.Tensor, k: int) -> torch.Tensor:
    """Inverse of :func:`pack_mask` for a trailing axis of K bits."""
    lanes = torch.arange(32, dtype=torch.int32, device=words.device)
    bits = (words[..., None] >> lanes) & 1
    return bits.reshape(*words.shape[:-1], words.shape[-1] * 32)[..., :k] != 0


def packed_onehot(idx: torch.Tensor, k: int) -> torch.Tensor:
    """Words of a K-bit mask with only bit ``idx`` set (trailing word axis)."""
    idx = idx.to(torch.int64)
    lanes = torch.arange((k + 31) // 32, device=idx.device)
    word = torch.where(lanes == (idx // 32)[..., None],
                       torch.ones_like(idx)[..., None] << (idx % 32)[..., None],
                       0)
    return to_int32_bits(word)


def packed_any(words: torch.Tensor) -> torch.Tensor:
    """Any bit set over the trailing word axis."""
    return (words != 0).any(-1)


def packed_popcount(words: torch.Tensor) -> torch.Tensor:
    """Set bits over the trailing word axis (int32), SWAR popcount."""
    x = words.to(torch.int64) & 0xFFFFFFFF
    x = x - ((x >> 1) & 0x55555555)
    x = (x & 0x33333333) + ((x >> 2) & 0x33333333)
    x = (x + (x >> 4)) & 0x0F0F0F0F
    x = ((x * 0x01010101) & 0xFFFFFFFF) >> 24
    return x.sum(-1).to(torch.int32)


def _first_true(cond: torch.Tensor) -> torch.Tensor:
    """First True index over the last axis, or its length if none."""
    q = cond.shape[-1]
    ar = torch.arange(q, device=cond.device)
    return torch.where(cond, ar, q).amin(-1)


def enqueue_ascending(queue: torch.Tensor, want: torch.Tensor, *payloads):
    """Enqueue every wanted model id into the first free slots.

    ``queue`` is ``(..., N, Q)``, ``want`` ``(..., N, M)`` bool; each
    payload is a ``(dest (..., N, Q, *E), src (..., N, M, *E))`` pair
    written alongside the id. Items are taken in ascending ``m``, each into
    the next free slot; items beyond the free capacity are dropped.
    Returns ``(new_queue, *new_dests)``."""
    m = want.shape[-1]
    q = queue.shape[-1]
    ax = want.dim() - 1                                  # the M / Q axis
    free = queue < 0
    slots = torch.arange(q, device=queue.device)

    if m == 1:
        first_free = _first_true(free)
        ok = want[..., 0] & (first_free < q)
        sel_q = (slots == first_free[..., None]) & ok[..., None]
        new_queue = torch.where(sel_q, torch.zeros_like(queue), queue)
        out = []
        for store, src in payloads:
            extra = src.dim() - want.dim()
            sel_e = sel_q.reshape(sel_q.shape + (1,) * extra)
            src_row = src.narrow(ax, 0, 1).to(store.dtype)
            out.append(torch.where(sel_e, src_row, store))
        return (new_queue, *out)

    free_rank = free.cumsum(-1) - 1
    n_free = free.sum(-1)
    rank = want.cumsum(-1) - 1
    ok = want & (rank < n_free[..., None])
    # sel[..., n, m, q]: item m of node n lands in slot q
    sel = (free[..., None, :] & (free_rank[..., None, :] == rank[..., :, None])
           & ok[..., :, None])
    taken = sel.any(ax)
    m_ids = torch.arange(m, device=queue.device)[:, None]
    new_queue = torch.where(taken, (sel * m_ids).sum(ax).to(queue.dtype), queue)
    out = []
    for store, src in payloads:
        extra = src.dim() - want.dim()
        sel_e = sel.reshape(sel.shape + (1,) * extra)
        src_e = src.unsqueeze(ax + 1)
        if store.dtype == torch.bool:
            val = (sel_e & src_e).any(ax)
        else:
            val = (sel_e * src_e).sum(ax).to(store.dtype)
        taken_e = taken.reshape(taken.shape + (1,) * extra)
        out.append(torch.where(taken_e, val, store))
    return (new_queue, *out)


def advance_timers(serving, serv_left, dt):
    """Tick running jobs: ``(serv_left, finished_merge, finished_train)``.
    ``dt`` is a number, or a ``(B, N)`` float32 tensor of each node's tick
    (the fault layer freezes an off node's timer with a tick of 0)."""
    serv_left = torch.where(serving >= 0, serv_left - dt, serv_left)
    fin = (serving >= 0) & (serv_left <= 0.0)
    return serv_left, fin & (serving == 0), fin & (serving == 1)


def pick_next_jobs(*, serving, serv_left, serv_model, serv_mask, serv_slot,
                   mq_model, mq_mask, tq_model, tq_slot, T_M, T_T,
                   can_serve=None):
    """Assign idle servers their next job: merge queue first (non-preemptive
    priority), then training. ``T_M`` and ``T_T`` are numbers or float32
    ``(B,)`` tensors. ``can_serve`` (``(B, N)`` bool, the fault layer's
    accessibility) gates *starting* a job; queued work waits. Returns the
    updated fields as a dict."""
    def row_sel(arr, sel, like):
        # arr[..., n, first[n]] as a one-hot sum over the queue axis
        sel = sel.reshape(sel.shape + (1,) * (arr.dim() - sel.dim()))
        return torch.where(sel, arr, torch.zeros_like(arr)).sum(
            serving.dim()).to(like.dtype)

    def take(model_q, serving):
        first = _first_true(model_q >= 0)
        ok = (serving < 0) & (model_q >= 0).any(-1)
        if can_serve is not None:
            ok = ok & can_serve
        slots = torch.arange(model_q.shape[-1], device=model_q.device)
        return ok, (slots == first[..., None]) & ok[..., None]

    take_m, sel_m = take(mq_model, serving)
    serv_model = torch.where(take_m, row_sel(mq_model, sel_m, serv_model),
                             serv_model)
    serv_mask = torch.where(take_m[..., None],
                            row_sel(mq_mask, sel_m, serv_mask), serv_mask)
    mq_model = torch.where(sel_m, torch.full_like(mq_model, -1), mq_model)
    serving = torch.where(take_m, 0, serving)
    serv_left = torch.where(take_m, run_param(T_M, serving.dim()), serv_left)

    take_t, sel_t = take(tq_model, serving)
    serv_model = torch.where(take_t, row_sel(tq_model, sel_t, serv_model),
                             serv_model)
    serv_slot = torch.where(take_t, row_sel(tq_slot, sel_t, serv_slot),
                            serv_slot)
    tq_model = torch.where(sel_t, torch.full_like(tq_model, -1), tq_model)
    serving = torch.where(take_t, 1, serving)
    serv_left = torch.where(take_t, run_param(T_T, serving.dim()), serv_left)
    return dict(
        serving=serving, serv_left=serv_left, serv_model=serv_model,
        serv_mask=serv_mask, serv_slot=serv_slot, mq_model=mq_model,
        tq_model=tq_model,
    )
