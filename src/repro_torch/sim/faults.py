"""The protocol fault layer: per-node behavior classes for the simulator
(port of ``repro.sim.faults``).

Real opportunistic deployments see

* **duty-cycled radios** — a per-node two-state on/off Markov chain. The
  accessibility of all N nodes is packed into ``ceil(N/32)`` int32 words
  (the :func:`repro_torch.sim.compute.pack_mask` layout) carried in the
  state; an *off* node neither detects contacts, nor can be contacted, nor
  serves (ongoing exchanges break, compute timers freeze, no new jobs
  start, no observations are recorded). Its protocol state is kept.
* **mid-transfer link failure** — each link end dies at
  ``link_fail_rate`` [1/s]; a failed link breaks the ongoing exchange
  exactly like moving out of radio range.
* **per-contact transfer abort** — a newly matched pair aborts connection
  setup with probability ``p_abort`` (both ends read the same coin).
* **crash-restart churn** — each node crashes at ``crash_rate`` [1/s] and
  restarts at once, dropping its protocol state through
  :func:`drop_state`, the path zone churn takes.
* **free-riders** — class-flagged nodes that receive model instances but
  never serve them.

The Byzantine classes (``FaultClass.adv_mode``) are part of the
configuration record, but the poisoned learning payloads (and
``repro``'s ``adv_vectors``) come with a later slice: the engine refuses
an adversarial configuration.

A :class:`FaultConfig` whose rates are all zero reports ``enabled ==
False``, and the engine then runs exactly the fault-free program (no extra
key split, no extra carry). Class membership is static: nodes fall into
contiguous index blocks by :func:`node_classes`, so the per-node rate
vectors are constants of a run.

Every draw is ``repro_torch.random.uniform`` on a key of the slot's extra
split, bit for bit ``repro``'s; :func:`duty_step`, :func:`link_fail` and
:func:`abort_matches` take the draw ``u = uniform(k, (N,))`` where
``repro``'s take the key ``k``, so the engine draws all four of a slot in
one pass (:func:`slot_draws`). The functions take ``(B, N)`` rows (``on``
and the draws one row a seed, or one a run); a probability threshold that
is a Python float is rounded to float32 first, as JAX's weak typing
compares it.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch import random as jr
from repro_torch.sim import compute
from repro_torch.sim.contacts import take_nodes

__all__ = [
    "FaultClass", "FaultConfig", "node_classes", "class_onehot",
    "init_avail", "slot_draws", "duty_step", "drop_state", "link_fail",
    "abort_matches", "gate_deliveries", "fault_outputs", "threshold",
    "ADV_MODES", "EV_ABORT", "EV_LINKFAIL", "EV_CRASH", "N_EVENTS",
]

#: Indices into the cumulative ``fault_events`` counters (node-level
#: events; symmetric pair events count both ends).
EV_ABORT, EV_LINKFAIL, EV_CRASH = 0, 1, 2
N_EVENTS = 3

#: Known adversarial serve-side behaviors (``FaultClass.adv_mode``);
#: ``"none"`` is honest.
ADV_MODES = ("none", "signflip", "noise", "replay", "liar")


@dataclasses.dataclass(frozen=True)
class FaultClass:
    """One behavior class: a fraction of the population sharing duty-cycle
    rates, the free-rider flag and the adversarial serve behavior.
    ``rate_off == 0`` means always on; ``adv_mode == "none"`` is honest.
    ``adv_scale`` is the noise σ of ``"noise"`` and the claimed count of
    ``"liar"``."""

    frac: float = 1.0        # fraction of nodes in this class
    rate_off: float = 0.0    # on -> off transition rate [1/s]
    rate_on: float = 0.0     # off -> on transition rate [1/s]
    free_rider: bool = False  # receives but never serves
    adv_mode: str = "none"   # serve-side attack (see ADV_MODES)
    adv_scale: float = 1.0   # attack magnitude (noise sigma / liar count)
    name: str = "default"

    @property
    def duty(self) -> float:
        """Stationary accessible (on) fraction of the two-state chain."""
        if self.rate_off <= 0.0:
            return 1.0
        if self.rate_on <= 0.0:
            return 0.0
        return self.rate_on / (self.rate_on + self.rate_off)


@dataclasses.dataclass(frozen=True)
class FaultConfig:
    """The fault model of a run (``SimConfig.faults``).

    ``classes`` partitions the population (fractions sum to 1);
    ``link_fail_rate`` and ``crash_rate`` are per-node Poisson rates [1/s]
    and ``p_abort`` a per-contact probability. The all-default config is
    disabled: the engine runs the fault-free program."""

    classes: tuple = (FaultClass(),)
    link_fail_rate: float = 0.0   # per link-end mid-transfer failure [1/s]
    p_abort: float = 0.0          # per-contact connection-setup abort prob
    crash_rate: float = 0.0       # per-node crash-restart rate [1/s]

    def __post_init__(self):
        if not self.classes:
            raise ValueError("FaultConfig needs at least one FaultClass")
        fracs = [c.frac for c in self.classes]
        if any(f < 0 for f in fracs) or abs(sum(fracs) - 1.0) > 1e-6:
            raise ValueError(
                f"class fractions must be >= 0 and sum to 1, got {fracs}")
        for r in (self.link_fail_rate, self.crash_rate):
            if r < 0:
                raise ValueError("fault rates must be >= 0")
        if not 0.0 <= self.p_abort < 1.0:
            raise ValueError("p_abort must be in [0, 1)")
        for c in self.classes:
            if c.adv_mode not in ADV_MODES:
                raise ValueError(
                    f"unknown adv_mode {c.adv_mode!r}; known: {ADV_MODES}")
            if c.adv_mode != "none" and c.adv_scale <= 0.0:
                raise ValueError("adversarial classes need adv_scale > 0")

    @property
    def n_classes(self) -> int:
        return len(self.classes)

    @property
    def enabled(self) -> bool:
        """True iff any *protocol* fault mechanism is active. Adversarial
        serve behavior does not count: Byzantine nodes follow the protocol
        (see :attr:`adversarial`)."""
        return (self.link_fail_rate > 0.0 or self.p_abort > 0.0
                or self.crash_rate > 0.0
                or any(c.rate_off > 0.0 or c.free_rider
                       for c in self.classes))

    @property
    def adversarial(self) -> bool:
        """True iff any class poisons the learning payload it serves."""
        return any(c.adv_mode != "none" for c in self.classes)

    @property
    def adv_frac(self) -> float:
        """Population fraction of adversarial nodes."""
        return sum(c.frac for c in self.classes if c.adv_mode != "none")


def node_classes(fc: FaultConfig, n: int) -> np.ndarray:
    """(N,) int32 class id per node: contiguous index blocks sized by the
    class fractions (bounds at ``round(cumsum(frac) * N)``, the last class
    taking the rounding remainder)."""
    bounds = np.round(
        np.cumsum([c.frac for c in fc.classes]) * n).astype(np.int64)
    bounds[-1] = n
    ids = np.zeros((n,), np.int32)
    lo = 0
    for ci, hi in enumerate(bounds):
        ids[lo:hi] = ci
        lo = max(lo, int(hi))
    return ids


def class_onehot(fc: FaultConfig, n: int) -> np.ndarray:
    """(N, C) bool class membership."""
    ids = node_classes(fc, n)
    return ids[:, None] == np.arange(fc.n_classes, dtype=np.int32)[None, :]


def threshold(p) -> float:
    """A probability as the float32 value a weakly typed JAX comparison
    against float32 draws uses."""
    return float(np.float32(p))


def init_avail(b: int, n: int, device=None) -> torch.Tensor:
    """``(b, ceil(N/32))`` packed availability words: every node on (the
    duty chain relaxes to its stationary distribution within the warmup)."""
    return compute.pack_mask(torch.ones((b, n), dtype=torch.bool,
                                        device=device))


def slot_draws(keys, n: int) -> tuple:
    """The slot's fault draws from ``keys`` ``(R, 4, 2)`` (the duty, crash,
    link and abort keys of the extra split): four ``(R, N)`` uniforms, each
    bit for bit ``uniform(key, (N,))``, hashed in one pass."""
    return jr.uniform(keys, (n,)).unbind(-2)


def duty_step(u, availw, p_off, p_on):
    """One slot of the per-node on/off chain: ``(availw_new, on)``.

    ``u`` ``(B, N)`` is the slot's duty draw, ``availw`` ``(B,
    ceil(N/32))`` the words, ``p_off``/``p_on`` ``(N,)`` float32 per-slot
    transition probabilities; ``on`` ``(B, N)`` is this slot's
    accessibility."""
    on_prev = compute.unpack_mask(availw, u.shape[-1])
    on = torch.where(on_prev, u >= p_off, u < p_on)
    return compute.pack_mask(on), on


def drop_state(drop, *, inc, has_model, tq_model, mq_model, serving,
               serv_left):
    """Drop the packed protocol state of the ``(B, N)`` flagged nodes: the
    single state-drop path of zone churn and crash-restart churn."""
    return dict(
        inc=torch.where(drop[..., None, None], 0, inc),
        has_model=has_model & ~drop[..., None],
        tq_model=torch.where(drop[..., None], -1, tq_model),
        mq_model=torch.where(drop[..., None], -1, mq_model),
        serving=torch.where(drop, -1, serving),
        serv_left=torch.where(drop, 0.0, serv_left),
    )


def _take(x, idx):
    """``x[b, idx[b, n]]``, ``x`` on seed rows repeated to ``idx``'s."""
    return take_nodes(compute.broadcast_rows(x, idx.shape[0]), idx)


def link_fail(u, p_link, partner):
    """Symmetric per-slot mid-transfer link failure ``(B, N)``: each node
    has one draw (``u`` ``(R, N)``, one row a seed, repeated to the ``B``
    rows of ``partner``) and a link fails when either end's draw is below
    ``p_link``. Meaningful only where ``partner >= 0``."""
    n = partner.shape[-1]
    low = u < threshold(p_link)
    pidx = partner.clamp(0, n - 1)
    return compute.broadcast_rows(low, partner.shape[0]) | _take(low, pidx)


def abort_matches(u, p_abort, match):
    """Symmetric per-contact setup abort: ``(match_new, aborted)``. Both
    ends of a pair read the coin of the lower node index, so the mutual
    match invariant holds. ``u`` is the ``(R, N)`` draw, one row a seed."""
    n = match.shape[-1]
    pair_lo = torch.minimum(torch.arange(n, device=match.device),
                            match.clamp(0, n - 1))
    low = u < threshold(p_abort)
    aborted = (match >= 0) & _take(low, pair_lo)
    return torch.where(aborted, -1, match), aborted


def gate_deliveries(delivered, pidx, is_free_rider):
    """Drop the ``(B, N, M)`` deliveries whose sender (``pidx`` ``(B, N)``)
    is a free-rider (``is_free_rider`` ``(N,)`` bool)."""
    return delivered & ~is_free_rider[pidx.to(torch.int64)][..., None]


def fault_outputs(*, on, in_rz, has_model, cls1h, n_per_class,
                  fault_events) -> dict:
    """Per-sample degradation telemetry of ``B`` runs.

    ``availability_c`` ``(B, M, C)``: model availability among the in-RZ
    members of each class (the twin of
    ``core.meanfield.solve_fixed_point_classes``' ``a``); ``on_frac_c``
    ``(B, C)`` accessible fraction per class; ``n_in_rz_c`` ``(B, C)``;
    and the cumulative ``fault_events`` ``(B, 3)``. ``cls1h`` is the
    ``(N, C)`` bool membership, ``n_per_class`` ``(C,)`` float32. Counts
    are integers, exact in float32 (<= N). The on-fraction multiplies by
    the float32 reciprocal of the class size: ``repro``'s engine holds the
    sizes as constants, and XLA rewrites a division by a constant so."""
    in_cls = in_rz[..., :, None] & cls1h                       # (B, N, C)
    n_rz_c = in_cls.sum(-2)                                    # (B, C)
    holders = (has_model[..., :, :, None] & in_cls[..., :, None, :]).sum(-3)
    avail_c = holders.float() / n_rz_c.float().clamp_min(1.0)[..., None, :]
    on_c = (on[..., :, None] & cls1h).sum(-2).float()
    return dict(
        availability_c=avail_c,
        on_frac_c=on_c * (1.0 / n_per_class.clamp_min(1.0)),
        n_in_rz_c=n_rz_c.to(torch.int32),
        fault_events=fault_events,
    )
