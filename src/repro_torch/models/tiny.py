"""Tiny flat-parameter models for the Gossip-Learning layer (port of
``repro.models.tiny``).

The simulator carries one parameter vector per node, so these models
live on a flat ``(..., D)`` float32 vector: merging is a row-wise convex
combination (the ``gossip_merge_rows`` kernel), and every function takes
arbitrary leading axes on ``theta``. ``TinySpec`` names the architecture:
``logreg`` (multinomial logistic regression) or ``mlp`` (one hidden ReLU
layer).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch import random as jr
from repro_torch.numerics import mean32

__all__ = ["TinySpec", "param_dim", "init_theta", "tiny_logits", "tiny_loss",
           "tiny_accuracy"]


@dataclasses.dataclass(frozen=True)
class TinySpec:
    """Hashable architecture spec."""

    model: str = "logreg"     # "logreg" | "mlp"
    n_features: int = 16
    n_classes: int = 2
    hidden: int = 16          # mlp only

    def __post_init__(self):
        if self.model not in ("logreg", "mlp"):
            raise ValueError(
                f"unknown tiny model {self.model!r}; known: 'logreg', 'mlp'")
        if min(self.n_features, self.n_classes) < 1 or (
                self.model == "mlp" and self.hidden < 1):
            raise ValueError("tiny model dims must be >= 1")

    @property
    def dim(self) -> int:
        return param_dim(self)


def param_dim(spec: TinySpec) -> int:
    """Length of the flat parameter vector."""
    f, c, h = spec.n_features, spec.n_classes, spec.hidden
    if spec.model == "logreg":
        return f * c + c
    return f * h + h + h * c + c


def init_theta(key: torch.Tensor, spec: TinySpec) -> torch.Tensor:
    """Shared initialization ``(D,)`` from a ``(2,)`` key: zeros for
    logreg, 1/sqrt(fan_in)-scaled normals for the MLP's weights."""
    if spec.model == "logreg":
        return torch.zeros(param_dim(spec), dtype=torch.float32,
                           device=key.device)
    f, c, h = spec.n_features, spec.n_classes, spec.hidden
    k1, k2 = jr.split(key).unbind(-2)
    w1 = jr.normal(k1, (f, h)) / float(np.sqrt(np.float32(f)))
    w2 = jr.normal(k2, (h, c)) / float(np.sqrt(np.float32(h)))
    dev = key.device
    return torch.cat([w1.reshape(-1), torch.zeros(h, device=dev),
                      w2.reshape(-1), torch.zeros(c, device=dev)])


def _unflatten(spec: TinySpec, theta: torch.Tensor):
    """The weight matrices as views of the flat ``(..., D)`` vector."""
    f, c, h = spec.n_features, spec.n_classes, spec.hidden
    lead = theta.shape[:-1]
    if spec.model == "logreg":
        return theta[..., :f * c].reshape(*lead, f, c), theta[..., f * c:]
    o1, o2, o3 = f * h, f * h + h, f * h + h + h * c
    return (theta[..., :o1].reshape(*lead, f, h), theta[..., o1:o2],
            theta[..., o2:o3].reshape(*lead, h, c), theta[..., o3:])


def tiny_logits(spec: TinySpec, theta: torch.Tensor, x: torch.Tensor):
    """Logits ``(..., B, C)`` from ``theta (..., D)`` and ``x (B, F)`` (or
    ``(..., B, F)`` matching theta's leading axes)."""
    if spec.model == "logreg":
        w, b = _unflatten(spec, theta)
        return torch.matmul(x, w) + b[..., None, :]
    w1, b1, w2, b2 = _unflatten(spec, theta)
    hdn = torch.relu(torch.matmul(x, w1) + b1[..., None, :])
    return torch.matmul(hdn, w2) + b2[..., None, :]


def tiny_loss(spec: TinySpec, theta, x, y):
    """Mean softmax cross-entropy over the batch axis: ``(...,)`` from
    ``theta (..., D)``, ``x (..., B, F)`` and int labels ``y (..., B)``
    (``x`` and ``y`` broadcast against theta's leading axes)."""
    logp = torch.log_softmax(tiny_logits(spec, theta, x), dim=-1)
    idx = y.to(torch.int64).expand(logp.shape[:-1])[..., None]
    picked = torch.gather(logp, -1, idx)[..., 0]
    return -mean32(picked)


def tiny_accuracy(spec: TinySpec, theta, x, y):
    """Per-replica test accuracy ``(...,)``: the fraction of ``x (B, F)``
    classified as ``y (B,)`` by each leading-axis parameter vector (the
    first maximum wins a tie, as in ``jnp.argmax``)."""
    pred = tiny_logits(spec, theta, x).argmax(-1)
    return mean32((pred == y).float())
