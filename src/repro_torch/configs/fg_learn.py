"""Preset learning configurations (port of ``repro.configs.fg_learn``).

Every builder returns a hashable ``LearnConfig`` for ``SimConfig.learn``.
"""

from __future__ import annotations

from repro_torch.sim.learn import LearnConfig

__all__ = ["logreg_task", "mlp_task", "policy_grid"]


def logreg_task(*, merge_policy: str = "obs_count", lr: float = 0.5,
                label_noise: float = 0.5, data_seed: int = 0) -> LearnConfig:
    """16-feature binary logistic regression (convex: merging always
    helps, the cleanest setting for reading capacity off accuracy)."""
    return LearnConfig(model="logreg", n_features=16, n_classes=2, lr=lr,
                       label_noise=label_noise, merge_policy=merge_policy,
                       data_seed=data_seed)


def mlp_task(*, merge_policy: str = "obs_count", hidden: int = 16,
             lr: float = 0.2, label_noise: float = 0.5,
             data_seed: int = 0) -> LearnConfig:
    """One-hidden-layer ReLU MLP on the same teacher (non-convex, shared
    init, so coordinate-wise averaging stays meaningful)."""
    return LearnConfig(model="mlp", n_features=16, n_classes=2,
                       hidden=hidden, lr=lr, label_noise=label_noise,
                       merge_policy=merge_policy, data_seed=data_seed)


def policy_grid(policies=("uniform", "obs_count"), **kw) -> list[LearnConfig]:
    """One ``logreg_task`` per merge policy."""
    return [logreg_task(merge_policy=p, **kw) for p in policies]
