"""Gossip-Learning layer: a parameter vector per node on the simulator
(port of ``repro.sim.learn``).

The engine runs the paper's protocol (model ids, incorporation bits,
queues); this layer turns its events into learning on model
``LEARN_MODEL``:

* **delivery**: the receiver merges the sender's parameter snapshot from
  connection time (:func:`merge_deliveries`, through the
  ``gossip_merge_rows`` kernel, or ``gossip_merge_rows_scaled`` under a
  norm clip), weighted by ``LearnConfig.merge_policy``;
* **train completion**: one local SGD step on a minibatch of the node's
  synthetic stream (:func:`train_completions`);
* **churn**: leaving the zone resets the replica to the shared init
  (:func:`reset_replicas`);
* **connection formation**: the parameters are snapshotted beside the
  protocol's ``snap`` words (:func:`snapshot_params`).

The task is a fixed linear teacher, ``y = argmax(x W* + σ g)`` over normal
features, drawn from ``LearnConfig.data_seed`` alone, so it is the same for
every run. The layer draws only from its own key chain and never feeds
back into the protocol: with learning on, every protocol trace equals the
``learn=None`` run's.

Every tensor carries ``repro``'s shape behind a leading batch axis ``B``.

**Byzantine layer.** Under an adversarial ``cfg.faults`` (see
``repro_torch.sim.faults``) the attackers poison the payload they serve:
:func:`poison_snapshots` transforms the snapshot an attacker just took
(sign flip, noise from the layer's own key chain, stale replay of θ0, or
a lying count and age), so the receive path and every protocol trace stay
as they are. The defenses (``LearnConfig.defense``) screen the peer inside
:func:`merge_deliveries`, in the average and trimmed modes. A
``poisoned`` flag spreads through accepted poisoned payloads (its
snapshot ``snap_poison`` rides with the parameters), the poison-attributed
``merge_stats`` counters count the attempts and rejections of poisoned
payloads, and :func:`learn_outputs` reports ``poisoned_frac`` and its
per-class split. The analytic twin of that flag is
``core.meanfield.solve_contamination_classes`` (steady) with
``core.dde.solve_contamination_transient``.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch

from repro_torch import random as jr
from repro_torch.core.merge import (DefenseConfig, clip_peer_counts,
                                    distance_accept, merge_weights,
                                    norm_clip_factors, trimmed_peer)
from repro_torch.kernels.gossip_merge import (gossip_merge_rows,
                                              gossip_merge_rows_scaled)
from repro_torch.models import tiny
from repro_torch.numerics import fma32, mean32
from repro_torch.optim.optimizers import sgd
from repro_torch.sim.contacts import take_nodes

__all__ = ["LearnConfig", "LearnTask", "make_task", "task_from_numpy",
           "init_fields", "fields_from_numpy", "LEARN_FIELDS",
           "ATTACK_FIELDS",
           "reset_replicas", "merge_deliveries", "snapshot_params",
           "attack_tensors", "poison_snapshots", "stream_batches",
           "train_completions", "learn_outputs",
           "LEARN_MODEL", "MS_ATTEMPT", "MS_ATTEMPT_POISON", "MS_NONFINITE",
           "MS_NORMCLIP", "MS_DISTREJ", "MS_DISTREJ_POISON", "N_MERGE_STATS",
           "CNT_CAP"]

#: The model id the learning layer attaches to.
LEARN_MODEL = 0

#: Indices into the cumulative ``merge_stats`` counters: delivery-merge
#: attempts, attempts with a poisoned payload, non-finite peers skipped,
#: peers down-scaled by the norm clip, peers rejected by the distance gate,
#: and rejections of poisoned payloads.
(MS_ATTEMPT, MS_ATTEMPT_POISON, MS_NONFINITE, MS_NORMCLIP,
 MS_DISTREJ, MS_DISTREJ_POISON) = range(6)
N_MERGE_STATS = 6

#: Saturation of the observation counters (merging sums them).
CNT_CAP = 1.0e12

#: The learning carry of ``SimState``; the last two only in trimmed mode.
LEARN_FIELDS = ("theta", "theta_cnt", "theta_age", "theta_snap", "snap_cnt",
                "snap_age", "merge_stats", "peer_buf", "peer_fill")
#: ... and the contamination carry, under an adversarial fault config only.
ATTACK_FIELDS = ("poisoned", "snap_poison")


@dataclasses.dataclass(frozen=True)
class LearnConfig:
    """Hashable learning parameters (``SimConfig.learn``): the model, the
    local SGD step, the synthetic task and the merge policy."""

    model: str = "logreg"         # repro_torch.models.tiny family
    n_features: int = 16
    n_classes: int = 2
    hidden: int = 16              # mlp only
    lr: float = 0.5
    batch: int = 8                # samples per local step (one observation)
    n_test: int = 256             # shared held-out set
    label_noise: float = 0.5      # teacher logit noise σ
    merge_policy: str = "obs_count"
    data_seed: int = 0
    defense: Any = None           # a DefenseConfig; None or a disabled one
                                  # keeps the undefended merge

    def __post_init__(self):
        self.spec  # noqa: B018  (validates the architecture)
        if self.lr <= 0.0 or self.batch < 1 or self.n_test < 1:
            raise ValueError("need lr > 0, batch >= 1, n_test >= 1")
        if self.label_noise < 0.0:
            raise ValueError("label_noise must be >= 0")
        if self.merge_policy not in ("uniform", "obs_count", "staleness"):
            raise ValueError(
                f"unknown merge policy {self.merge_policy!r}; known: "
                "'uniform', 'obs_count', 'staleness'")
        if self.defense is not None and not isinstance(self.defense,
                                                       DefenseConfig):
            raise ValueError(
                "LearnConfig.defense must be a repro_torch.core.merge."
                f"DefenseConfig (got {type(self.defense).__name__})")

    @property
    def spec(self) -> tiny.TinySpec:
        return tiny.TinySpec(model=self.model, n_features=self.n_features,
                             n_classes=self.n_classes, hidden=self.hidden)

    @property
    def param_dim(self) -> int:
        return self.spec.dim

    @property
    def active_defense(self) -> DefenseConfig | None:
        """The defense if it screens anything, else None."""
        dc = self.defense
        return dc if dc is not None and dc.enabled else None


@dataclasses.dataclass(frozen=True)
class LearnTask:
    """Constants of a config, all drawn from ``LearnConfig.data_seed``."""

    theta0: torch.Tensor       # (D,) shared replica init
    w_true: torch.Tensor       # (F, C) linear teacher
    x_test: torch.Tensor       # (n_test, F)
    y_test: torch.Tensor       # (n_test,) int32
    stream_key: torch.Tensor   # (2,) base key of the per-slot minibatches


def _labels(key, lc: LearnConfig, x, w_true):
    """Teacher labels ``argmax(x W* + σ g)``; ``key`` may carry leading
    axes, which lead ``x`` too."""
    logits = torch.matmul(x, w_true)
    if lc.label_noise > 0.0:
        noise = jr.normal(key, logits.shape[key.dim() - 1:])
        logits = logits + float(np.float32(lc.label_noise)) * noise
    return logits.argmax(-1).to(torch.int32)


def make_task(lc: LearnConfig, device=None) -> LearnTask:
    """The task of ``lc``, drawn as ``repro.sim.learn.make_task`` draws it."""
    base = jr.PRNGKey(lc.data_seed, device=device)
    k_teacher, k_init, k_test, k_ytest, k_stream = jr.split(
        jr.fold_in(base, 0x7EAC), 5).unbind(-2)
    w_true = jr.normal(k_teacher, (lc.n_features, lc.n_classes))
    x_test = jr.normal(k_test, (lc.n_test, lc.n_features))
    return LearnTask(theta0=tiny.init_theta(k_init, lc.spec), w_true=w_true,
                     x_test=x_test, y_test=_labels(k_ytest, lc, x_test, w_true),
                     stream_key=k_stream)


def task_from_numpy(theta0, w_true, x_test, y_test, stream_key,
                    device=None) -> LearnTask:
    """A ``LearnTask`` from ``repro``'s task arrays as numpy (the key's
    uint32 words become int64), so both packages learn the same task."""
    def f32(a):
        return torch.tensor(np.asarray(a, np.float32), device=device)

    return LearnTask(
        theta0=f32(theta0), w_true=f32(w_true), x_test=f32(x_test),
        y_test=torch.tensor(np.asarray(y_test, np.int32), device=device),
        stream_key=torch.tensor(np.asarray(stream_key).astype(np.int64),
                                device=device))


def init_fields(lc: LearnConfig, task: LearnTask, b: int, n: int,
                fc=None) -> dict:
    """Initial learning carry of ``b`` runs of ``n`` nodes: every replica
    and snapshot at the shared init, counts and ages zero. An adversarial
    ``fc`` (the run's ``FaultConfig``) adds the clean contamination flags
    ``poisoned`` and ``snap_poison``; a trimmed defense adds the empty
    recent-peer buffer."""
    dev = task.theta0.device
    d = task.theta0.shape[0]
    theta = task.theta0.expand(b, n, d).contiguous()
    zeros = torch.zeros((b, n), dtype=torch.float32, device=dev)
    fields = dict(
        theta=theta, theta_cnt=zeros, theta_age=zeros.clone(),
        theta_snap=theta.clone(), snap_cnt=zeros.clone(),
        snap_age=zeros.clone(),
        merge_stats=torch.zeros((b, N_MERGE_STATS), dtype=torch.int32,
                                device=dev))
    if fc is not None and fc.adversarial:
        fields.update(
            poisoned=torch.zeros((b, n), dtype=torch.bool, device=dev),
            snap_poison=torch.zeros((b, n), dtype=torch.bool, device=dev))
    dc = lc.active_defense
    if dc is not None and dc.mode == "trimmed":
        fields.update(
            peer_buf=torch.zeros((b, n, dc.recent_peers, d),
                                 dtype=torch.float32, device=dev),
            peer_fill=torch.zeros((b, n), dtype=torch.int32, device=dev))
    return fields


def fields_from_numpy(fields: dict, device=None) -> dict:
    """The learning carry (``B = 1``) from one ``repro`` run's fields as
    numpy, keyed by the names in :data:`LEARN_FIELDS` and
    :data:`ATTACK_FIELDS`."""
    return {k: torch.from_numpy(np.array(v)[None]).to(device)
            for k, v in fields.items() if k in LEARN_FIELDS + ATTACK_FIELDS}


def reset_replicas(drop, theta, theta_cnt, theta_age, theta0, *,
                   poisoned=None, peer_fill=None) -> dict:
    """Churn: the dropped nodes' replicas go back to the shared init, their
    counts and ages to zero (snapshots belong to the exchange and stay);
    the contamination flag and the recent-peer buffer, when carried, are
    cleared: a fresh init is clean and has no peers."""
    out = dict(theta=torch.where(drop[..., None], theta0, theta),
               theta_cnt=torch.where(drop, 0.0, theta_cnt),
               theta_age=torch.where(drop, 0.0, theta_age))
    if poisoned is not None:
        out["poisoned"] = poisoned & ~drop
    if peer_fill is not None:
        out["peer_fill"] = torch.where(drop, 0, peer_fill)
    return out


def merge_deliveries(lc: LearnConfig, received, pidx, theta, theta_cnt,
                     theta_age, theta_snap, snap_cnt, snap_age, tau_l, *,
                     merge_stats, poisoned=None, snap_poison=None,
                     peer_buf=None, peer_fill=None) -> dict:
    """Merge each receiver's replica with its sender's connection-time
    snapshot (``received`` ``(B, N)`` flags the receivers, ``pidx`` the
    senders). The screens run in ``repro``'s order: the non-finite guard,
    then with an active defense the count clip, the norm clip (fused into
    the kernel), the distance gate and, in trimmed mode, the median of the
    recent accepted peers. Counts add (capped) and ages take the min. With
    the contamination carry (``poisoned``, ``snap_poison``) the counters
    attribute attempts and distance rejections to poisoned payloads, and
    an accepted poisoned payload poisons its receiver. Returns the updated
    fields."""
    peer_theta = take_nodes(theta_snap, pidx)
    peer_cnt = take_nodes(snap_cnt, pidx)
    peer_age = take_nodes(snap_age, pidx)
    peer_poison = (take_nodes(snap_poison, pidx) if snap_poison is not None
                   else torch.zeros_like(received))

    finite = (torch.isfinite(peer_theta).all(-1) & torch.isfinite(peer_cnt)
              & torch.isfinite(peer_age))
    accept = received & finite

    def count(mask):
        return mask.sum(-1).to(torch.int32)

    dc = lc.active_defense
    scale = None
    zero = torch.zeros(received.shape[:-1], dtype=torch.int32,
                       device=received.device)
    norm_clipped = dist_rej = dist_rej_poison = zero
    if dc is not None:
        if dc.cnt_clip > 0.0:
            peer_cnt = clip_peer_counts(theta_cnt, peer_cnt, dc.cnt_clip)
        if dc.norm_clip > 0.0:
            scale = norm_clip_factors(peer_theta, dc.norm_clip)
            norm_clipped = count(accept & (scale < 1.0))
        if dc.dist_gate > 0.0:
            gated = peer_theta if scale is None else scale[..., None] * peer_theta
            near = distance_accept(theta, gated, dc.dist_gate, dc.dist_floor)
            dist_rej = count(accept & ~near)
            dist_rej_poison = count(accept & ~near & peer_poison)
            accept = accept & near

    w_own, _ = merge_weights(lc.merge_policy, theta_cnt, peer_cnt, theta_age,
                             peer_age, tau_l)
    out = {}
    if dc is not None and dc.mode == "trimmed":
        pushed = peer_theta if scale is None else scale[..., None] * peer_theta
        slots = torch.arange(dc.recent_peers, device=peer_fill.device)
        at = (slots == (peer_fill % dc.recent_peers)[..., None])[..., None]
        buf_new = torch.where(at, pushed[..., None, :], peer_buf)
        peer_buf = torch.where(accept[..., None, None], buf_new, peer_buf)
        peer_fill = torch.where(accept, peer_fill + 1, peer_fill)
        med = trimmed_peer(theta, peer_buf, peer_fill)
        theta = gossip_merge_rows(theta, med, w_own, accept)
        out.update(peer_buf=peer_buf, peer_fill=peer_fill)
    elif scale is not None:
        theta = gossip_merge_rows_scaled(theta, peer_theta, w_own, scale,
                                         accept,
                                         fold=lc.merge_policy == "uniform")
    else:
        theta = gossip_merge_rows(theta, peer_theta, w_own, accept)

    theta_cnt = torch.where(
        accept, torch.clamp(theta_cnt + peer_cnt, max=CNT_CAP), theta_cnt)
    theta_age = torch.where(accept, torch.minimum(theta_age, peer_age),
                            theta_age)
    stats = torch.stack([count(received), count(received & peer_poison),
                         count(received & ~finite), norm_clipped, dist_rej,
                         dist_rej_poison], -1)
    out.update(theta=theta, theta_cnt=theta_cnt, theta_age=theta_age,
               merge_stats=merge_stats + stats)
    if poisoned is not None:
        # contamination spreads through accepted poisoned payloads
        out["poisoned"] = poisoned | (accept & peer_poison)
    return out


def snapshot_params(newly, theta, theta_cnt, theta_age, theta_snap,
                    snap_cnt, snap_age, *, poisoned=None, snap_poison=None):
    """Snapshot the parameters and their bookkeeping where a connection
    forms: ``(theta_snap, snap_cnt, snap_age)``, and ``snap_poison`` after
    them when the contamination flag is carried (a partner receives what
    was as poisoned as the node at connection time)."""
    out = (torch.where(newly[..., None], theta, theta_snap),
           torch.where(newly, theta_cnt, snap_cnt),
           torch.where(newly, theta_age, snap_age))
    if snap_poison is None:
        return out
    return out + (torch.where(newly, poisoned, snap_poison),)


def attack_tensors(adv: dict, device=None) -> dict:
    """``faults.adv_vectors``' numpy vectors as tensors on ``device``, once
    a run; an attack mode that no node takes is left out, and
    :func:`poison_snapshots` skips it, as ``repro`` skips a mode whose
    mask is all False."""
    return {k: torch.from_numpy(np.asarray(v)).to(device)
            for k, v in adv.items()
            if k in ("is_adv", "scale") or np.asarray(v).any()}


def poison_snapshots(adv: dict, task: LearnTask, slot_idx: int, newly,
                     theta_snap, snap_cnt, snap_age, snap_poison):
    """The serve-side attack: transform the snapshots the attackers just
    took (``newly`` ``(B, N)``), leaving their live replicas and every
    protocol trace alone. ``adv`` is :func:`attack_tensors` of
    ``faults.adv_vectors``. ``signflip`` serves ``-scale * θ``; ``replay``
    serves θ0; ``noise`` adds ``scale`` times a normal draw keyed on
    ``fold_in(fold_in(stream_key, 0xBAD), slot)`` (the learning layer's own
    chain, the same for every run of the batch); ``liar`` serves the honest
    θ under the count ``scale`` and age 0. Every payload an attacker serves
    is flagged poisoned. Returns ``(theta_snap, snap_cnt, snap_age,
    snap_poison)``."""
    hit = newly & adv["is_adv"]
    scale = adv["scale"][:, None]
    poisoned = theta_snap
    if "signflip" in adv:
        poisoned = torch.where(adv["signflip"][:, None], -scale * poisoned,
                               poisoned)
    if "replay" in adv:
        poisoned = torch.where(adv["replay"][:, None], task.theta0, poisoned)
    if "noise" in adv:
        k_noise = jr.fold_in(jr.fold_in(task.stream_key, 0xBAD), slot_idx)
        e = jr.erf_inv_draw(k_noise, theta_snap.shape[-2:])
        # repro's `poisoned + scale * normal` under XLA: the constant scale
        # folded into normal's sqrt(2), the product contracted into one FMA
        poisoned = torch.where(adv["noise"][:, None],
                               fma32(scale * jr.SQRT2, e, poisoned),
                               poisoned)
    theta_snap = torch.where(hit[..., None], poisoned, theta_snap)
    if "liar" in adv:
        liar_hit = hit & adv["liar"]
        snap_cnt = torch.where(liar_hit, adv["scale"], snap_cnt)
        snap_age = torch.where(liar_hit, 0.0, snap_age)
    return theta_snap, snap_cnt, snap_age, snap_poison | hit


def stream_batches(lc: LearnConfig, task: LearnTask, slots: torch.Tensor,
                   n: int):
    """The minibatches of ``n`` nodes at each of ``slots`` (int64): ``x``
    ``(S, n, batch, F)`` and labels ``(S, n, batch)``, keyed on
    ``(data_seed, slot)`` as ``repro`` draws them one slot at a time. The
    draw is one vectorized hash per key, so a block of slots costs what one
    slot costs in kernel launches."""
    k_slot = jr.fold_in(task.stream_key, slots)
    kx, ky = jr.split(k_slot).unbind(-2)
    x = jr.normal(kx, (n, lc.batch, lc.n_features))
    return x, _labels(ky, lc, x, task.w_true)


def train_completions(lc: LearnConfig, slot_idx: int, did_train, theta,
                      theta_cnt, theta_age, dt: float, batch):
    """One local SGD step per node that completed training this slot, on
    ``batch``, the slot's ``(x, y)`` from :func:`stream_batches` (node
    ``i`` reads row ``i``, the same for every run of the batch axis). Ages
    advance by ``dt`` and reset on a step; counts add the one
    observation."""
    x, y = batch
    with torch.enable_grad():
        th = theta.detach().requires_grad_(True)
        loss = tiny.tiny_loss(lc.spec, th, x, y).sum()
        grads, = torch.autograd.grad(loss, th)
    stepped, _ = sgd(lc.lr).update(grads, {}, theta, slot_idx)
    theta = torch.where(did_train[..., None], stepped, theta)
    theta_cnt = torch.where(did_train, theta_cnt + 1.0, theta_cnt)
    theta_age = torch.where(did_train, 0.0, theta_age + dt)
    return theta, theta_cnt, theta_age


def learn_outputs(lc: LearnConfig, task: LearnTask, theta, theta_cnt,
                  has_model, in_rz, *, merge_stats, poisoned=None,
                  cls1h=None) -> dict:
    """Per-sample telemetry ``(B,)``: ``test_acc`` (population mean test
    accuracy), ``test_acc_holders`` (mean over in-zone holders of the
    model, the population mean when there are none), ``learn_obs`` (mean
    count per holder), ``theta_var`` (mean parameter variance across
    holders), and the cumulative ``merge_stats``. With the contamination
    flag ``poisoned`` also ``poisoned_frac``, the poisoned fraction of the
    in-zone holders (0 without holders), and ``poisoned_frac_c`` ``(B,
    C)``, its split by the classes of ``cls1h`` ``(N, C)`` bool."""
    acc = tiny.tiny_accuracy(lc.spec, theta, task.x_test, task.y_test)
    w = (has_model[..., LEARN_MODEL] & in_rz).float()
    n_hold = w.sum(-1)
    denom = torch.clamp(n_hold, min=1.0)
    any_hold = n_hold > 0.0
    mu = (w[..., None] * theta).sum(-2) / denom[..., None]
    var = (w[..., None] * torch.square(theta - mu[..., None, :])).sum(-2) \
        / denom[..., None]
    out = dict(
        test_acc=mean32(acc),
        test_acc_holders=torch.where(any_hold, (w * acc).sum(-1) / denom,
                                     mean32(acc)),
        learn_obs=torch.where(any_hold, (w * theta_cnt).sum(-1) / denom, 0.0),
        theta_var=torch.where(any_hold, mean32(var), 0.0),
        merge_stats=merge_stats,
    )
    if poisoned is not None:
        # counts of 0/1 terms: exact in float32, in any order
        p = poisoned.float()
        out["poisoned_frac"] = torch.where(any_hold,
                                           (w * p).sum(-1) / denom, 0.0)
        in_cls = (w[..., None] * cls1h).float()                 # (B, N, C)
        n_c = in_cls.sum(-2)
        out["poisoned_frac_c"] = torch.where(
            n_c > 0.0, (p[..., None] * in_cls).sum(-2) / n_c.clamp_min(1.0),
            0.0)
    return out
