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
Defenses run in the average and trimmed modes; the adversarial branches of
``repro`` (``poisoned``, ``snap_poison``, ``poison_snapshots``) need
``cfg.faults.adversarial`` and come with the faults slice.
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
from repro_torch.numerics import mean32
from repro_torch.optim.optimizers import sgd
from repro_torch.sim.contacts import take_nodes

__all__ = ["LearnConfig", "LearnTask", "make_task", "task_from_numpy",
           "init_fields", "fields_from_numpy", "LEARN_FIELDS",
           "reset_replicas", "merge_deliveries", "snapshot_params",
           "stream_batches", "train_completions", "learn_outputs",
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


def init_fields(lc: LearnConfig, task: LearnTask, b: int, n: int) -> dict:
    """Initial learning carry of ``b`` runs of ``n`` nodes: every replica
    and snapshot at the shared init, counts and ages zero."""
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
    dc = lc.active_defense
    if dc is not None and dc.mode == "trimmed":
        fields.update(
            peer_buf=torch.zeros((b, n, dc.recent_peers, d),
                                 dtype=torch.float32, device=dev),
            peer_fill=torch.zeros((b, n), dtype=torch.int32, device=dev))
    return fields


def fields_from_numpy(fields: dict, device=None) -> dict:
    """The learning carry (``B = 1``) from one ``repro`` run's fields as
    numpy, keyed by the names in :data:`LEARN_FIELDS`."""
    return {k: torch.from_numpy(np.array(v)[None]).to(device)
            for k, v in fields.items() if k in LEARN_FIELDS}


def reset_replicas(drop, theta, theta_cnt, theta_age, theta0, *,
                   peer_fill=None) -> dict:
    """Churn: the dropped nodes' replicas go back to the shared init, their
    counts and ages to zero (snapshots belong to the exchange and stay);
    the recent-peer buffer, when carried, empties."""
    out = dict(theta=torch.where(drop[..., None], theta0, theta),
               theta_cnt=torch.where(drop, 0.0, theta_cnt),
               theta_age=torch.where(drop, 0.0, theta_age))
    if peer_fill is not None:
        out["peer_fill"] = torch.where(drop, 0, peer_fill)
    return out


def merge_deliveries(lc: LearnConfig, received, pidx, theta, theta_cnt,
                     theta_age, theta_snap, snap_cnt, snap_age, tau_l, *,
                     merge_stats, peer_buf=None, peer_fill=None) -> dict:
    """Merge each receiver's replica with its sender's connection-time
    snapshot (``received`` ``(B, N)`` flags the receivers, ``pidx`` the
    senders). The screens run in ``repro``'s order: the non-finite guard,
    then with an active defense the count clip, the norm clip (fused into
    the kernel), the distance gate and, in trimmed mode, the median of the
    recent accepted peers. Counts add (capped) and ages take the min.
    Returns the updated fields."""
    peer_theta = take_nodes(theta_snap, pidx)
    peer_cnt = take_nodes(snap_cnt, pidx)
    peer_age = take_nodes(snap_age, pidx)

    finite = (torch.isfinite(peer_theta).all(-1) & torch.isfinite(peer_cnt)
              & torch.isfinite(peer_age))
    accept = received & finite

    def count(mask):
        return mask.sum(-1).to(torch.int32)

    dc = lc.active_defense
    scale = None
    zero = torch.zeros(received.shape[:-1], dtype=torch.int32,
                       device=received.device)
    norm_clipped = dist_rej = zero
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
    # no adversaries without the faults slice: the poison counters stay 0
    stats = torch.stack([count(received), zero, count(received & ~finite),
                         norm_clipped, dist_rej, zero], -1)
    out.update(theta=theta, theta_cnt=theta_cnt, theta_age=theta_age,
               merge_stats=merge_stats + stats)
    return out


def snapshot_params(newly, theta, theta_cnt, theta_age, theta_snap,
                    snap_cnt, snap_age):
    """Snapshot the parameters and their bookkeeping where a connection
    forms: ``(theta_snap, snap_cnt, snap_age)``."""
    return (torch.where(newly[..., None], theta, theta_snap),
            torch.where(newly, theta_cnt, snap_cnt),
            torch.where(newly, theta_age, snap_age))


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
                  has_model, in_rz, *, merge_stats) -> dict:
    """Per-sample telemetry ``(B,)``: ``test_acc`` (population mean test
    accuracy), ``test_acc_holders`` (mean over in-zone holders of the
    model, the population mean when there are none), ``learn_obs`` (mean
    count per holder), ``theta_var`` (mean parameter variance across
    holders), and the cumulative ``merge_stats``."""
    acc = tiny.tiny_accuracy(lc.spec, theta, task.x_test, task.y_test)
    w = (has_model[..., LEARN_MODEL] & in_rz).float()
    n_hold = w.sum(-1)
    denom = torch.clamp(n_hold, min=1.0)
    any_hold = n_hold > 0.0
    mu = (w[..., None] * theta).sum(-2) / denom[..., None]
    var = (w[..., None] * torch.square(theta - mu[..., None, :])).sum(-2) \
        / denom[..., None]
    return dict(
        test_acc=mean32(acc),
        test_acc_holders=torch.where(any_hold, (w * acc).sum(-1) / denom,
                                     mean32(acc)),
        learn_obs=torch.where(any_hold, (w * theta_cnt).sum(-1) / denom, 0.0),
        theta_var=torch.where(any_hold, mean32(var), 0.0),
        merge_stats=merge_stats,
    )
