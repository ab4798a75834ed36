"""Mobility models (port of ``repro.sim.mobility``): ``rdm`` and ``replay``.

Each model pairs ``init(key, cfg) -> (state, key)`` with
``step(k1, k2, state, cfg) -> state``, the state having a ``pos`` field of
``(B, N, 2)`` positions; keys are ``(B, 2)`` (``repro_torch.random``).

* ``rdm`` — Random Direction with specular reflection at the boundary
  (the paper's model), with ``repro``'s exact key schedule: ``init``
  splits its key in 3, ``step`` draws the renewal coin from ``k1`` and the
  new heading from ``k2``.
* ``replay`` — positions given by the caller, one ``(B, N, 2)`` frame per
  slot plus the initial one. It splits and consumes keys exactly as
  ``rdm`` does, so every other draw of the engine stays aligned. XLA's
  and torch's float32 ``cos``, ``sin`` and ``atan2`` differ in the last
  ulp on a few percent of inputs, so a free-running port drifts from
  ``repro``; replaying ``repro``'s positions is how whole runs are
  compared bit for bit.

``rwp``, ``manhattan`` and the contact-rate probe come with a later slice.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from repro_torch import random as jr
from repro_torch.numerics import fma32

__all__ = ["RDMState", "ReplayState", "MobilityModel", "get_mobility",
           "replay_model"]


@dataclasses.dataclass(frozen=True)
class RDMState:
    pos: torch.Tensor     # (B, N, 2)
    ang: torch.Tensor     # (B, N) heading [rad]
    spd: torch.Tensor     # (B, N) speed [m/s]


@dataclasses.dataclass(frozen=True)
class ReplayState:
    pos: torch.Tensor     # (B, N, 2) this slot's frame
    frame: int            # index of ``pos`` in the track


@dataclasses.dataclass(frozen=True)
class MobilityModel:
    name: str
    init: object          # (key, cfg) -> (state, key)
    step: object          # (k1, k2, state, cfg) -> state


def _f32(v: float) -> float:
    return float(np.float32(v))


def _rdm_init(key, cfg):
    k_pos, k_dir, key = jr.split(key, 3).unbind(-2)
    n = cfg.n_nodes
    pos = jr.uniform(k_pos, (n, 2), maxval=cfg.area_side)
    ang = jr.uniform(k_dir, (n,), maxval=2 * math.pi)
    spd = torch.full(ang.shape, cfg.speed, dtype=torch.float32,
                     device=ang.device)
    return RDMState(pos=pos, ang=ang, spd=spd), key


def _rdm_step(k_renew, k_head, s: RDMState, cfg) -> RDMState:
    n = s.pos.shape[-2]
    renew = jr.uniform(k_renew, (n,)) < _f32(cfg.dir_change_rate * cfg.dt)
    new_ang = jr.uniform(k_head, (n,), maxval=2 * math.pi)
    ang = torch.where(renew, new_ang, s.ang)
    vel = s.spd[..., None] * torch.stack([torch.cos(ang), torch.sin(ang)], -1)
    pos = fma32(vel, _f32(cfg.dt), s.pos)               # pos + vel * dt
    side = _f32(cfg.area_side)
    over = pos > side
    under = pos < 0.0
    pos = torch.where(over, _f32(2 * cfg.area_side) - pos,
                      torch.where(under, -pos, pos))
    vel = torch.where(over | under, -vel, vel)
    return RDMState(pos=pos, ang=torch.atan2(vel[..., 1], vel[..., 0]),
                    spd=s.spd)


def replay_model(track: torch.Tensor) -> MobilityModel:
    """A model replaying ``track`` ``(T + 1, B, N, 2)``: frame 0 at init,
    frame ``t + 1`` after step ``t``."""
    def init(key, cfg):
        _, _, key = jr.split(key, 3).unbind(-2)
        return ReplayState(pos=track[0], frame=0), key

    def step(_k1, _k2, s: ReplayState, cfg) -> ReplayState:
        return ReplayState(pos=track[s.frame + 1], frame=s.frame + 1)

    return MobilityModel(name="replay", init=init, step=step)


_MODELS = {"rdm": MobilityModel(name="rdm", init=_rdm_init, step=_rdm_step)}


def get_mobility(name: str) -> MobilityModel:
    try:
        return _MODELS[name]
    except KeyError:
        raise ValueError(
            f"unknown mobility model {name!r}; known: {sorted(_MODELS)}"
        ) from None
