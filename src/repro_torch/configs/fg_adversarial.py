"""Preset Byzantine configurations for the adversarial studies (port of
``repro.configs.fg_adversarial``).

The attack builders return a hashable
``repro_torch.sim.faults.FaultConfig`` for ``SimConfig.faults``: which
fraction of the population attacks and how (``adv_mode``,
``adv_scale``). The defense builders return a
``repro_torch.core.merge.DefenseConfig`` for ``LearnConfig.defense``. An
attack-only config has ``enabled`` False (adversaries follow the gossip
protocol), so the protocol traces equal the ``faults=None`` run's; only
the learning layer sees the attack.

The ``robust_defense`` knobs are calibrated at the learning-smoke point
(48 nodes, 100 m area, 50 m RZ, ``lam=0.05``, ``Lam=10``): holder
parameter norms near 0.65 and honest peer distances near 0.4, so the clip
radius 1.5 and the relative gate 1.0 with floor 0.3 pass honest payloads
and screen amplified sign flips and far-off replays.
"""

from __future__ import annotations

import dataclasses

from repro_torch.core.merge import DefenseConfig
from repro_torch.sim.faults import FaultClass, FaultConfig

__all__ = ["honest", "signflip", "noise_injector", "stale_replay",
           "metadata_liar", "harsh_adversarial", "robust_defense",
           "trimmed_defense", "ADV_SCALE_DEFAULT"]

# amplified sign flip: adversaries serve -ADV_SCALE_DEFAULT * theta (scale
# 1 is the plain flip)
ADV_SCALE_DEFAULT = 4.0


def honest() -> FaultConfig:
    """One honest class, no attacks: the engine runs as with
    ``faults=None``."""
    return FaultConfig()


def _attack(mode: str, frac: float, scale: float, name: str,
            **fault_kw) -> FaultConfig:
    if not 0.0 < frac < 1.0:
        raise ValueError(f"attacker fraction must be in (0, 1), got {frac}")
    return FaultConfig(classes=(
        FaultClass(frac=1.0 - frac, name="honest"),
        FaultClass(frac=frac, adv_mode=mode, adv_scale=scale, name=name),
    ), **fault_kw)


def signflip(*, frac: float = 0.1,
             scale: float = ADV_SCALE_DEFAULT) -> FaultConfig:
    """Model poisoning: attackers serve ``-scale * theta``."""
    return _attack("signflip", frac, scale, "signflip")


def noise_injector(*, frac: float = 0.1, scale: float = 2.0) -> FaultConfig:
    """Attackers serve ``theta`` plus Gaussian noise of σ ``scale``."""
    return _attack("noise", frac, scale, "noise")


def stale_replay(*, frac: float = 0.1) -> FaultConfig:
    """Attackers always serve the initial parameters θ0."""
    return _attack("replay", frac, 1.0, "replay")


def metadata_liar(*, frac: float = 0.1,
                  claimed_count: float = 1e6) -> FaultConfig:
    """Attackers serve their honest θ under ``theta_cnt = claimed_count``
    and ``theta_age = 0``, hijacking the ``obs_count`` and ``staleness``
    merge weights."""
    return _attack("liar", frac, claimed_count, "liar")


def harsh_adversarial(*, frac_flip: float = 0.1, frac_liar: float = 0.05,
                      scale: float = ADV_SCALE_DEFAULT,
                      crash_rate: float = 0.001) -> FaultConfig:
    """Sign flippers and metadata liars on top of crash-restart churn: the
    config is both ``enabled`` and ``adversarial``."""
    frac_honest = 1.0 - frac_flip - frac_liar
    if frac_honest <= 0.0:
        raise ValueError("attacker fractions must sum below 1")
    return FaultConfig(classes=(
        FaultClass(frac=frac_honest, name="honest"),
        FaultClass(frac=frac_flip, adv_mode="signflip", adv_scale=scale,
                   name="signflip"),
        FaultClass(frac=frac_liar, adv_mode="liar", adv_scale=1e6,
                   name="liar"),
    ), crash_rate=crash_rate)


def robust_defense(*, norm_clip: float = 1.5, dist_gate: float = 1.0,
                   dist_floor: float = 0.3,
                   cnt_clip: float = 4.0) -> DefenseConfig:
    """Norm clipping, the distance gate and the metadata count clamp over
    the plain weighted-average merge."""
    return DefenseConfig(norm_clip=norm_clip, dist_gate=dist_gate,
                         dist_floor=dist_floor, cnt_clip=cnt_clip)


def trimmed_defense(*, recent_peers: int = 3, **kw) -> DefenseConfig:
    """:func:`robust_defense` merging against the coordinate-wise median of
    the last ``recent_peers`` accepted payloads."""
    return dataclasses.replace(robust_defense(**kw), mode="trimmed",
                               recent_peers=recent_peers)
