"""Floating Gossip as a training protocol over R model replicas on one
device (port of ``repro.core.gossip``).

The paper's scheme mapped onto data-parallel training: each replica is an
FG *node*; a *contact* is one pair of a matching; *transfer success* S(a),
*busy* probability b and *churn* are Bernoulli gates drawn from
``(seed, round, pair)``, so both ends of a pair agree; *merging* is the
weighted parameter average of :mod:`repro_torch.core.merge`, with the
observation counts summed as the union of training sets; churn resets a
replica to the default parameters. Segmented gossip (``segments > 1``)
merges one ``1/segments`` slice of every leaf a round.

Matchings are static: ``random`` (K precomputed uniformly random
pairings, the paper's random contacts) or ``hypercube`` (partner = index
XOR 2^(round mod log2 R)). ``repro`` moves the partner's leaves with
``ppermute`` over the round's matching under ``shard_map``; here every
replica's leaves lie on one device, stacked on a leading axis of size R,
and a replica reads its partner's slice. The matchings are involutions,
so this is the same function. The host picks the matching from the round
index; every gate, weight and count stays a tensor on the device, and no
value waits for the host.

Every merge goes through the ``gossip_merge`` kernel
(:mod:`repro_torch.kernels.gossip_merge`), once per replica and leaf, on
views of the stacked leaves (or of the round's segment of them), into a
new buffer: every replica merges with its partner's pre-round leaves. Its
operand order is the one XLA contracts the merge into inside ``repro``'s
jitted round: ``fma(1-w, peer, w*own)``, except for float32 leaves of one
element a replica and the segmented branch's float32 leaves, which are
``fma(w, own, (1-w)*peer)`` (the kernel's ``own_first``).

``protocol_from_meanfield`` waits for the analytics slice (ROADMAP §1
item 1), and replicas across cards (``torch.distributed``) for a slice
that needs more than one card.
"""

from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple

import numpy as np
import torch

from repro_torch import random as jr
from repro_torch.core.merge import merge_weights
from repro_torch.kernels.gossip_merge import gossip_merge
from repro_torch.tree import tree_map

__all__ = ["GossipConfig", "Gates", "init_gossip_state",
           "hypercube_matchings", "random_matchings", "build_gossip_round"]


@dataclasses.dataclass(frozen=True)
class GossipConfig:
    """Protocol parameters: the stochastic gates are the mean-field
    operating point of the paper. ``repro``'s ``axis_names`` (the gossip
    mesh axes) has no counterpart: one device holds every replica."""

    period: int = 1                  # gossip every `period` optimizer steps
    matching: str = "random"         # "random" (paper) | "hypercube" (opt.)
    n_random_matchings: int = 16
    success_prob: float = 1.0        # S(a): transfer success per contact
    busy_prob: float = 0.0           # b: node unavailable this round
    churn_prob: float = 0.0          # α/N per round: replica reset
    merge_policy: str = "obs_count"
    segments: int = 1                # segmented gossip (1 = whole model)
    seed: int = 0


def init_gossip_state(R: int, device=None) -> dict:
    """Per-replica bookkeeping, ``(R,)`` float32 on ``device`` (default
    ``cuda``): ``count``, the observations (local batches) incorporated;
    ``age``, steps since the replica last saw a fresh observation."""
    device = torch.device("cuda" if device is None else device)
    return dict(count=torch.zeros(R, dtype=torch.float32, device=device),
                age=torch.zeros(R, dtype=torch.float32, device=device))


def hypercube_matchings(R: int) -> list[list[tuple[int, int]]]:
    if R & (R - 1):
        raise ValueError(f"hypercube matching needs power-of-two R, got {R}")
    return [[(i, i ^ (1 << k)) for i in range(R)]
            for k in range(int(math.log2(R)))]


def random_matchings(R: int, K: int, seed: int) -> list[list[tuple[int, int]]]:
    """K random pairings, each an involution, from numpy's draws (the same
    as ``repro``'s). With odd R one node per matching is left over and
    pairs with itself, which the round treats as no contact."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(K):
        order = rng.permutation(R)
        perm = list(range(R))
        for a, b in zip(order[0::2], order[1::2]):
            perm[a], perm[b] = b, a
        out.append([(i, perm[i]) for i in range(R)])
    return out


class Gates(NamedTuple):
    """One round's draws and weights, each ``(R,)`` on the device."""

    partner: torch.Tensor           # int64: the replica each one meets
    success: torch.Tensor           # bool: the pair merges
    w_own: torch.Tensor             # float32; the peer's is 1 - w_own
    reset: torch.Tensor | None      # bool: churn; None if churn_prob == 0


def _f32(v: float) -> float:
    """A Python number as JAX compares it with a float32 array."""
    return float(np.float32(v))


def build_gossip_round(R: int, cfg: GossipConfig):
    """Build ``round_fn(params, state, default_params, round_idx) ->
    (params, state)`` over ``R`` replicas on one device; returns
    ``(round_fn, R)``.

    ``repro`` builds the round from a mesh and the parameters' partition
    specs, and R is the product of the gossip axes; here R is given.
    ``params`` and ``default_params`` are trees of one structure whose
    leaves carry a leading replica axis of size R
    (:func:`repro_torch.models.transformer.stack_replicas`), contiguous;
    ``state`` is :func:`init_gossip_state`'s; ``round_idx`` a Python int.
    The round returns new tensors and leaves its inputs as they were.
    ``round_fn.gates(state, round_idx)`` gives the :class:`Gates` that the
    round draws from that state."""
    if cfg.matching == "hypercube":
        matchings = hypercube_matchings(R)
    elif cfg.matching == "random":
        matchings = random_matchings(R, cfg.n_random_matchings, cfg.seed)
    else:
        raise ValueError(f"unknown matching {cfg.matching!r}")
    partners = [[dst for _, dst in m] for m in matchings]
    n_match = len(matchings)
    on_device: dict = {}        # device -> (partner table, PRNGKey(seed))

    def gates(state: dict, round_idx: int) -> Gates:
        count, age = state["count"], state["age"]
        dev = count.device
        if dev not in on_device:
            on_device[dev] = (torch.tensor(partners, device=dev),
                              jr.PRNGKey(cfg.seed, device=dev))
        table, seed_key = on_device[dev]
        partner = table[round_idx % n_match]
        i = torch.arange(R, device=dev)
        base = jr.fold_in(seed_key, round_idx)
        pair_id = torch.minimum(i, partner) * R + torch.maximum(i, partner)
        transfer_ok = (jr.uniform(jr.fold_in(base, pair_id), ())
                       < _f32(cfg.success_prob))
        own_key = jr.fold_in(base, i)
        u_busy = jr.uniform(own_key, ())
        busy = _f32(cfg.busy_prob)
        both_free = (u_busy >= busy) & (u_busy[partner] >= busy)
        success = transfer_ok & both_free & (partner != i)
        w_own, _ = merge_weights(cfg.merge_policy, count, count[partner],
                                 age, age[partner], tau_l=1.0e4)
        reset = None
        if cfg.churn_prob > 0.0:
            u_churn = jr.uniform(jr.fold_in(own_key, 0x5EED), ())
            reset = u_churn < _f32(cfg.churn_prob)
        return Gates(partner, success, w_own, reset)

    def merge_leaf(x, partner: list, g: Gates, round_idx: int):
        """Leaf ``x`` ``(R, ...)`` merged replica by replica into a new
        buffer."""
        flat = x.reshape(R, -1)
        n = flat.shape[1]
        lo, hi = 0, n
        if cfg.segments > 1:
            # segmented gossip: merge only chunk (round mod segments)
            seg_len = -(-n // cfg.segments)
            lo = (round_idx % cfg.segments) * seg_len
            hi = min(lo + seg_len, n)
        own_first = x.dtype == torch.float32 and (cfg.segments > 1 or n == 1)
        out = x.clone() if hi - lo < n else torch.empty_like(x)
        dst = out.view(R, -1)
        for i, p in enumerate(partner):
            gossip_merge(flat[i, lo:hi], flat[p, lo:hi], g.w_own[i],
                         g.success[i], out=dst[i, lo:hi], own_first=own_first)
        return out

    def round_fn(params, state: dict, default_params, round_idx: int):
        round_idx = int(round_idx)
        g = gates(state, round_idx)
        partner = partners[round_idx % n_match]

        def leaf(x, default):
            out = merge_leaf(x, partner, g, round_idx)
            if g.reset is None:
                return out
            return torch.where(g.reset.view(R, *([1] * (x.dim() - 1))),
                               default, out)

        new_params = tree_map(leaf, params, default_params)
        # training-set union ≈ count sum; staleness = min age
        count, age = state["count"], state["age"]
        new_count = torch.where(g.success, count + count[g.partner], count)
        new_age = torch.where(g.success,
                              torch.minimum(age, age[g.partner]), age)
        if g.reset is not None:
            new_count = torch.where(g.reset, 0.0, new_count)
            new_age = torch.where(g.reset, 0.0, new_age)
        return new_params, dict(count=new_count, age=new_age)

    round_fn.gates = gates
    return round_fn, R
