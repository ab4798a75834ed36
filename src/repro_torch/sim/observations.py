"""Observation bookkeeping (port of ``repro.sim.observations``).

Each model keeps a ring of ``K`` recent observations with birth times;
each node keeps packed incorporation words per (model, ring slot).
Merging ORs word rows, training ORs a packed one-hot, ring recycling ANDs
one out, stored information is a popcount. Every function takes a
leading batch axis ``B``.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch import random as jr
from repro_torch.sim.compute import (broadcast_rows, pack_mask,
                                     packed_onehot, packed_popcount,
                                     run_param, unpack_mask)

__all__ = ["generate_observations", "apply_completions", "slot_outputs",
           "o_tau_histograms", "estimate_o_of_tau", "RANK_DENSE_MAX_N"]

#: At or below this node count the observer rank is an O(N²)
#: compare-reduce, above it sort + searchsorted; both give the number of
#: scores strictly below one's own, ties included.
RANK_DENSE_MAX_N = 512


def _observer_ranks(who_scores: torch.Tensor) -> torch.Tensor:
    """``(..., M, N)`` rank of each score in its row: #scores < own."""
    n = who_scores.shape[-1]
    if n <= RANK_DENSE_MAX_N:
        return (who_scores[..., :, None] > who_scores[..., None, :]).sum(-1)
    srt = torch.sort(who_scores, dim=-1).values
    return torch.searchsorted(srt, who_scores, side="left")


def generate_observations(*, k_obs, k_who, obs_birth, obs_head, inc, in_rz,
                          lam, Lam, dt, t_now):
    """Draw per-model observation arrivals and pick their Λ observers.

    ``k_obs``/``k_who`` are ``(R, 2)`` keys, one a seed, for ``B`` runs
    laid out scenario-major (row ``b`` runs seed ``b % R``; ``R == B`` when
    every run has its own key). The draws and the observer ranks depend
    only on the seed, so they are made on the R seed rows (``in_rz``'s
    first R rows) and broadcast; ``lam`` and ``Lam`` are numbers or float32
    ``(B,)`` tensors. Returns ``(obs_birth, obs_head, inc, want_train
    (B, N, M), slot_payload (B, N, M))``."""
    m_count, k_count = obs_birth.shape[-2:]
    b, n = in_rz.shape
    r = k_obs.shape[0]
    dev = obs_birth.device

    if torch.is_tensor(lam):
        rate = run_param(lam * float(np.float32(dt)), 2)
    else:
        rate = float(np.float32(lam) * np.float32(dt))
    new_obs = broadcast_rows(jr.uniform(k_obs, (m_count,)), b) < rate
    slot_of = obs_head
    ring = torch.arange(k_count, device=dev)
    obs_birth = torch.where(
        new_obs[..., None] & (ring == slot_of[..., None]),
        float(np.float32(t_now)), obs_birth)
    obs_head = torch.where(new_obs, (obs_head + 1) % k_count, obs_head)
    recycled = torch.where(new_obs[..., None], packed_onehot(slot_of, k_count),
                           0)
    inc = inc & ~recycled[..., None, :, :]

    # Λ random in-RZ nodes record each new observation: score nodes
    # i.i.d. (out-of-RZ nodes pushed back by 1e3) and take rank < Λ
    who = jr.uniform(k_who, (m_count, n)) + (~in_rz[:r])[..., None, :] * 1e3
    rank = broadcast_rows(_observer_ranks(who), b)
    if torch.is_tensor(Lam):
        lam_n = run_param(torch.round(Lam).clamp(1, n).to(torch.int64), 3)
    else:
        lam_n = int(np.clip(np.round(np.float32(Lam)), 1, n))
    is_obs = (rank < lam_n) & in_rz[..., None, :] & new_obs[..., None]
    want_train = is_obs.transpose(-1, -2)
    slot_payload = slot_of[..., None, :].expand(*slot_of.shape[:-1], n,
                                                m_count)
    return obs_birth, obs_head, inc, want_train, slot_payload


def apply_completions(*, fin_merge, fin_train, serv_model, serv_mask,
                      serv_slot, inc, has_model, obs_birth):
    """Apply finished merge/train jobs: a merge ORs the job's packed words
    into the served model's and grants the model; a training job ORs the
    packed one-hot of its (model, slot) bit, if the slot was not recycled."""
    m_count, k_count = obs_birth.shape[-2:]
    onehot_m = serv_model[..., None] == torch.arange(m_count,
                                                     device=serv_model.device)
    merged = fin_merge[..., None] & onehot_m                      # (B, N, M)
    inc = inc | torch.where(merged[..., None], serv_mask[..., None, :], 0)
    has_model = has_model | merged

    # fresh[b, n, m] = obs_birth[b, m, serv_slot[b, n]] > -inf
    slot_idx = serv_slot.to(torch.int64)[..., None, :].expand(
        *serv_slot.shape[:-1], m_count, serv_slot.shape[-1])
    fresh = torch.gather(obs_birth, -1, slot_idx).transpose(-1, -2) \
        > float("-inf")
    trained = fin_train[..., None] & onehot_m & fresh
    onehot_kw = packed_onehot(serv_slot, k_count)                 # (B, N, KW)
    inc = inc | torch.where(trained[..., None], onehot_kw[..., None, :], 0)
    return inc, has_model | trained


def slot_outputs(*, inc, has_model, obs_birth, in_rz, partner, t_now, tau_l,
                 member=None, with_obs_trace: bool = True):
    """Per-sample observables of one slot (the quantities of Figs. 1-4).

    ``in_rz`` is the union zone membership ``(B, N)``; ``member`` the
    ``(B, N, K)`` per-zone membership, which adds the per-zone traces;
    ``tau_l`` a number or a float32 ``(B,)`` tensor."""
    k_count = obs_birth.shape[-1]
    age = float(np.float32(t_now)) - obs_birth
    live = (obs_birth > float("-inf")) & (age <= run_param(tau_l, age.dim()))
    livew = pack_mask(live)                                       # (B, M, KW)
    stored = packed_popcount(inc & livew[..., None, :, :]).sum(-1)  # (B, N)
    n_in = in_rz.sum(-1)
    n_rz = n_in.clamp(min=1)
    hold = has_model & in_rz[..., None]
    out = dict(
        availability=hold.sum(-2) / n_rz[..., None],
        busy_frac=((partner >= 0) & in_rz).sum(-1) / n_rz,
        stored=torch.where(in_rz, stored, 0).sum(-1) / n_rz,
        model_holders=hold.sum(-2).to(torch.int32),
        n_in_rz=n_in.to(torch.int32),
    )
    if member is not None:
        n_z = member.sum(-2)                                      # (B, K)
        denom = n_z.clamp(min=1)
        out["n_in_rz_z"] = n_z.to(torch.int32)
        out["availability_z"] = (
            has_model[..., None] & member[..., None, :]
        ).sum(-3) / denom[..., None, :]                           # (B, M, K)
        out["stored_z"] = torch.where(member, stored[..., None], 0).sum(-2) \
            / denom
    if with_obs_trace:
        inc_bits = unpack_mask(inc, k_count)                      # (B,N,M,K)
        out["obs_birth"] = obs_birth
        # integer holder counts (repro's float GEMV is exact for counts <= N)
        out["obs_holders"] = (inc_bits & in_rz[..., None, None]).sum(-3).to(
            torch.int32)
    return out


def o_tau_histograms(*, t, obs_birth, obs_holders, model_holders, n_tau: int,
                     dtau: float):
    """``(num, den)`` observation-age histograms behind the o(τ) estimator.

    Every live observation (finite age >= 0) of a model with a holder adds
    its holder fraction to ``num`` and 1 to ``den`` at bin
    ``floor(age / dtau)``. Shapes: ``t (S,)``, ``obs_birth``/``obs_holders``
    ``(..., S, M, K)``, ``model_holders`` ``(..., S, M)`` -> ``(..., n_tau)``.
    """
    age = t[:, None, None] - obs_birth
    holders = model_holders.clamp(min=1)[..., None]
    frac = obs_holders / holders
    bins = torch.floor(age / float(np.float32(dtau)))
    ok = (torch.isfinite(age) & (age >= 0) & (model_holders > 0)[..., None]
          & (bins < n_tau) & (bins >= 0))
    bins = torch.where(ok, bins, 0).to(torch.int64)
    onehot = bins[..., None] == torch.arange(n_tau, device=bins.device)
    sel = ok[..., None] & onehot                                  # (...,S,M,K,T)
    axes = tuple(range(sel.dim() - 4, sel.dim() - 1))
    num = torch.where(sel, frac[..., None], 0.0).sum(axes)
    den = sel.sum(axes).to(torch.float32)
    return num, den


def estimate_o_of_tau(out, tau_grid: np.ndarray, warmup_frac: float = 0.3):
    """Empirical o(τ): holders-of-observation / holders-of-model at age τ,
    over the post-warmup samples of a ``SimOutputs``."""
    s0 = int(len(out.t) * warmup_frac)

    def f32(a):
        return torch.from_numpy(np.asarray(a[s0:], np.float32))

    num, den = o_tau_histograms(
        t=f32(out.t), obs_birth=f32(out.obs_birth),
        obs_holders=f32(out.obs_holders), model_holders=f32(out.model_holders),
        n_tau=len(tau_grid), dtau=float(tau_grid[1] - tau_grid[0]),
    )
    num, den = num.numpy(), den.numpy()
    return np.where(den > 0, num / np.maximum(den, 1), np.nan)
