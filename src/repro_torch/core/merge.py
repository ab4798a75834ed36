"""Model-merging weights and Byzantine screens (port of
``repro.core.merge``, the parts the sim learning layer uses).

Merging is a weighted average of two model instances. ``merge_weights``
gives the own weight under three policies: ``uniform`` (0.5),
``obs_count`` (proportional to incorporated observations) and
``staleness`` (``exp(-age / tau_l)`` scores). :class:`DefenseConfig`
screens the peer first: ``cnt_clip`` clamps its claimed count,
``norm_clip`` scales an over-norm payload down, ``dist_gate`` rejects
peers outside a radius relative to the own norm, and ``mode="trimmed"``
merges against the coordinate-wise median of recent accepted peers.

Every function works on tensors with any leading axes (the simulator's
``(B, N, ...)``). Norms sum in jitted XLA's order
(:func:`repro_torch.numerics.row_sum32`), so screens decide as
``repro``'s do on the same inputs.
"""

from __future__ import annotations

import dataclasses

import torch

from repro_torch.numerics import row_sum32, sqrt32

__all__ = ["DefenseConfig", "norm_clip_factors", "distance_accept",
           "clip_peer_counts", "trimmed_peer", "merge_weights"]

_EPS = 1e-12


@dataclasses.dataclass(frozen=True)
class DefenseConfig:
    """Hashable Byzantine-defense knobs; every knob at its default is off,
    and a disabled config keeps the merge path the undefended one."""

    norm_clip: float = 0.0     # clip radius for the peer payload norm
    dist_gate: float = 0.0     # accept iff ||peer-own|| <= gate*(floor+||own||)
    dist_floor: float = 1e-3   # absolute floor of the relative gate radius
    cnt_clip: float = 0.0      # cap peer_cnt at cnt_clip * (1 + own_cnt)
    mode: str = "average"      # "average" | "trimmed"
    recent_peers: int = 3      # trimmed mode: accepted-peer ring buffer size

    def __post_init__(self):
        for r in (self.norm_clip, self.dist_gate, self.cnt_clip):
            if r < 0.0:
                raise ValueError("defense radii/clips must be >= 0")
        if self.dist_floor <= 0.0:
            raise ValueError("dist_floor must be > 0")
        if self.mode not in ("average", "trimmed"):
            raise ValueError(f"unknown defense mode {self.mode!r}; known: "
                             "'average', 'trimmed'")
        if self.mode == "trimmed" and self.recent_peers < 1:
            raise ValueError("trimmed mode needs recent_peers >= 1")

    @property
    def enabled(self) -> bool:
        return (self.norm_clip > 0.0 or self.dist_gate > 0.0
                or self.cnt_clip > 0.0 or self.mode != "average")


def _norm(x: torch.Tensor) -> torch.Tensor:
    """Euclidean norm over the last axis: the correctly rounded ``sqrt`` of
    the squares summed in XLA's order."""
    return sqrt32(row_sum32(x * x))


def norm_clip_factors(peer_theta: torch.Tensor, radius: float):
    """``min(1, radius / ||peer||)`` per row (1 for in-radius peers). The
    radius is a tensor here: torch divides a Python number by a tensor as
    a reciprocal times the number, which rounds twice."""
    nrm = torch.clamp(_norm(peer_theta), min=_EPS)
    return torch.clamp(torch.full_like(nrm, radius) / nrm, max=1.0)


def distance_accept(own_theta, peer_theta, gate: float, floor: float):
    """``||peer - own|| <= gate * (floor + ||own||)``, or a cold own replica
    (``||own|| <= floor``) that accepts anything."""
    own_nrm = _norm(own_theta)
    d = _norm(peer_theta - own_theta)
    return (d <= gate * (floor + own_nrm)) | (own_nrm <= floor)


def clip_peer_counts(own_cnt, peer_cnt, clip: float):
    """The metadata-liar screen: ``min(peer_cnt, clip * (1 + own_cnt))``."""
    return torch.minimum(peer_cnt, clip * (1.0 + own_cnt))


def trimmed_peer(own_theta, peer_buf, peer_fill):
    """Coordinate-wise median over {own} and the valid ring-buffer entries.

    ``peer_buf`` is ``(..., R, D)``; entries from ``min(fill, R)`` on are
    unwritten and stand in as the own row. The median of an even count is
    the mean of the middle pair, ``(lo + hi) * 0.5``, as ``jnp.median``
    takes it (``torch.median`` would return the lower one)."""
    r = peer_buf.shape[-2]
    slots = torch.arange(r, device=peer_buf.device)
    valid = slots < torch.clamp(peer_fill, max=r)[..., None]
    own = own_theta[..., None, :]
    vals = torch.cat([own, torch.where(valid[..., None], peer_buf, own)], -2)
    vals = torch.where(vals.isnan().any(-2, keepdim=True), float("nan"), vals)
    srt = vals.sort(dim=-2).values
    n = r + 1
    lo, hi = srt[..., (n - 1) // 2, :], srt[..., n // 2, :]
    return (lo + hi) * 0.5


def merge_weights(policy: str, own_count, peer_count, own_age, peer_age,
                  tau_l: float):
    """``(w_own, w_peer)`` with ``w_own + w_peer == 1``.

    ``obs_count`` divides by ``max(tot, 1)`` as ``repro`` does, so for
    ``0 < tot < 1`` the two weights do not sum to the counts' shares."""
    if policy == "uniform":
        w_own = torch.full_like(own_count, 0.5)
    elif policy == "obs_count":
        tot = own_count + peer_count
        w_own = torch.where(tot > 0.0, own_count / torch.clamp(tot, min=1.0),
                            0.5)
    elif policy == "staleness":
        m = torch.minimum(own_age, peer_age)
        tau = torch.full_like(m, tau_l)      # a true division, as above
        s_own = torch.exp(-(own_age - m) / tau)
        s_peer = torch.exp(-(peer_age - m) / tau)
        w_own = s_own / (s_own + s_peer)
    else:
        raise ValueError(f"unknown merge policy {policy!r}")
    return w_own, 1.0 - w_own
