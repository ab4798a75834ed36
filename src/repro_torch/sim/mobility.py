"""Mobility models (port of ``repro.sim.mobility``): ``rdm``, ``rwp``,
``manhattan`` and ``replay``, and the contact-rate probe.

Each model pairs ``init(key, cfg) -> (state, key)`` with
``step(k1, k2, state, cfg) -> state``, the state having a ``pos`` field of
``(B, N, 2)`` positions; keys are ``(B, 2)`` (``repro_torch.random``).
Every model keeps ``repro``'s exact key schedule, and its name selects
the analytic twin of :mod:`repro_torch.core.mobility`.

* ``rdm`` — Random Direction with specular reflection at the boundary
  (the paper's model): ``init`` splits its key in 3 (in 4 under
  ``cfg.speed_range``, whose U(lo, hi) speeds come from the third key),
  ``step`` draws the renewal coin from ``k1`` and the new heading from
  ``k2``. XLA's and torch's float32 ``cos``, ``sin`` and ``atan2`` differ
  in the last ulp on a few percent of inputs, so a free-running rdm port
  drifts from ``repro``; replaying ``repro``'s positions is how whole rdm
  runs are compared bit for bit.
* ``rwp`` — Random Waypoint with a constant pause ``cfg.pause_s`` at each
  waypoint: move at ``cfg.speed`` toward a uniform waypoint, draw the next
  one on arrival (from ``k1``), then sit for the pause.
* ``manhattan`` — axis-aligned movement on a street grid of spacing
  ``cfg.street_spacing``: at each street line reached (boundary lines
  too) turn with probability 1/2 onto a random orientation (from ``k1``),
  reflect at the boundary.
* ``replay`` — positions given by the caller, one ``(B, N, 2)`` frame per
  slot plus the initial one. It splits and consumes keys as the replayed
  model did, so every other draw of the engine stays aligned.

``rwp`` and ``manhattan`` call no transcendental: on either device they
equal ``repro``'s jitted steps bit for bit, with each multiply-add in the
order XLA contracts it (``numerics.fma32``).

:func:`measure_contact_rate` rolls a model alone and counts new pairwise
proximity events, through ``pairwise_contacts`` (the CUDA kernel on a
card, its plain version on the CPU).
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from repro_torch import random as jr
from repro_torch import resolve_device
from repro_torch.kernels.contacts import pairwise_contacts
from repro_torch.numerics import fma32, sqrt32
from repro_torch.sim.compute import packed_popcount

__all__ = ["RDMState", "RWPState", "ManhattanState", "ReplayState",
           "MobilityModel", "MOBILITY_MODELS", "register_mobility",
           "get_mobility", "replay_model", "measure_contact_rate"]


@dataclasses.dataclass(frozen=True)
class RDMState:
    pos: torch.Tensor     # (B, N, 2)
    ang: torch.Tensor     # (B, N) heading [rad]
    spd: torch.Tensor     # (B, N) speed [m/s]


@dataclasses.dataclass(frozen=True)
class RWPState:
    pos: torch.Tensor     # (B, N, 2)
    dest: torch.Tensor    # (B, N, 2) current waypoint
    wait: torch.Tensor    # (B, N) remaining pause at the waypoint [s]


@dataclasses.dataclass(frozen=True)
class ManhattanState:
    pos: torch.Tensor     # (B, N, 2) on the street graph
    horiz: torch.Tensor   # (B, N) bool: moving along x (True) or y (False)
    sgn: torch.Tensor     # (B, N) movement sign, +-1.0


@dataclasses.dataclass(frozen=True)
class ReplayState:
    pos: torch.Tensor     # (B, N, 2) this slot's frame
    frame: int            # index of ``pos`` in the track


@dataclasses.dataclass(frozen=True)
class MobilityModel:
    """A named mobility model; the name also keys its analytic twin
    (``repro_torch.core.mobility.contact_model_for``)."""

    name: str
    init: object          # (key, cfg) -> (state, key)
    step: object          # (k1, k2, state, cfg) -> state


def _f32(v: float) -> float:
    return float(np.float32(v))


# --------------------------------------------------------------- rdm

def _init_splits(cfg) -> int:
    """Ways rdm's init splits its key: 4 with a speed key, else 3."""
    return 3 if cfg.speed_range is None else 4


def _rdm_init(key, cfg):
    n = cfg.n_nodes
    keys = jr.split(key, _init_splits(cfg)).unbind(-2)
    pos = jr.uniform(keys[0], (n, 2), maxval=cfg.area_side)
    ang = jr.uniform(keys[1], (n,), maxval=2 * math.pi)
    if cfg.speed_range is not None:
        lo, hi = cfg.speed_range
        spd = jr.uniform(keys[2], (n,), minval=lo, maxval=hi)
    else:
        spd = torch.full(ang.shape, cfg.speed, dtype=torch.float32,
                         device=ang.device)
    return RDMState(pos=pos, ang=ang, spd=spd), keys[-1]


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


# --------------------------------------------------------------- rwp

def _rwp_init(key, cfg):
    k_pos, k_dest, key = jr.split(key, 3).unbind(-2)
    n = cfg.n_nodes
    pos = jr.uniform(k_pos, (n, 2), maxval=cfg.area_side)
    dest = jr.uniform(k_dest, (n, 2), maxval=cfg.area_side)
    return RWPState(pos=pos, dest=dest, wait=torch.zeros_like(pos[..., 0])), key


def _rwp_step(k_dest, _k_unused, s: RWPState, cfg) -> RWPState:
    """One slot: pause, arrive or move ``speed * dt`` toward the waypoint.
    The distance is ``sqrt(fma(dy, dy, dx*dx))`` and the move
    ``fma(direction, step_len, pos)``, as jitted XLA computes
    ``jnp.linalg.norm`` and ``pos + direction * step_len``; the root is
    ``sqrt32``'s (torch's vectorized float32 root on the CPU is an ulp off
    on about 0.7% of inputs, and the quotient carries it)."""
    n = s.pos.shape[-2]
    step_len = _f32(cfg.speed * cfg.dt)
    delta = s.dest - s.pos
    dx, dy = delta[..., 0], delta[..., 1]
    dist = sqrt32(fma32(dy, dy, dx * dx))
    paused = s.wait > 0.0
    arrive = (dist <= step_len) & ~paused
    direction = delta / torch.clamp(dist, min=_f32(1e-9))[..., None]
    moved = fma32(direction, step_len, s.pos)
    pos = torch.where(paused[..., None], s.pos,
                      torch.where(arrive[..., None], s.dest, moved))
    # the next waypoint is drawn at arrival (the same key use for any
    # pause); the node then waits ceil(pause_s / dt) slots before moving
    new_dest = jr.uniform(k_dest, (n, 2), maxval=cfg.area_side)
    dest = torch.where(arrive[..., None], new_dest, s.dest)
    wait = torch.where(arrive, _f32(cfg.pause_s),
                       torch.where(paused, s.wait - _f32(cfg.dt), s.wait))
    return RWPState(pos=pos, dest=dest, wait=wait)


# --------------------------------------------------------- manhattan

def _n_streets(cfg) -> int:
    """Street lines per direction: ``round(side / s) + 1`` (the grid may
    reach past the area where ``s`` does not divide the side, as in
    ``repro``)."""
    return int(round(cfg.area_side / cfg.street_spacing)) + 1


def _manhattan_init(key, cfg):
    k1, _, key = jr.split(key, 3).unbind(-2)
    ka, kb, kc, kd = jr.split(k1, 4).unbind(-2)
    n = cfg.n_nodes
    horiz = jr.bernoulli(ka, 0.5, (n,))
    street = jr.randint(kb, (n,), 0, _n_streets(cfg)).to(torch.float32)
    fixed = _f32(cfg.street_spacing) * street
    moving = jr.uniform(kc, (n,), maxval=cfg.area_side)
    sgn = torch.where(jr.bernoulli(kd, 0.5, (n,)), 1.0, -1.0)
    pos = torch.stack([torch.where(horiz, moving, fixed),
                       torch.where(horiz, fixed, moving)], -1)
    return ManhattanState(pos=pos, horiz=horiz, sgn=sgn), key


def _manhattan_step(k_turn, _k_unused, st: ManhattanState,
                    cfg) -> ManhattanState:
    """One slot on the street graph. As jitted XLA computes them, the move
    ``u + sgn * speed * dt`` is ``u + sgn * f32(f32(speed) * f32(dt))``
    (the constants folded first: the product with ``sgn = ±1`` is exact,
    the sum rounds once; an FMA of ``sgn * speed`` and ``dt`` would round
    otherwise wherever ``speed * dt`` is inexact), and ``u / s`` is ``u *
    f32(1 / s)`` (a division by a constant becomes a product with its
    reciprocal), so the next street line is the floor or ceiling of that
    product: next to a line it can differ from a true division, and there
    a turn is offered or not."""
    n = st.pos.shape[-2]
    s, side = _f32(cfg.street_spacing), _f32(cfg.area_side)
    inv_s = _f32(1.0 / s)
    x, y = st.pos[..., 0], st.pos[..., 1]
    u = torch.where(st.horiz, x, y)            # moving coordinate
    w = torch.where(st.horiz, y, x)            # fixed coordinate (a street)

    u_new = u + st.sgn * _f32(_f32(cfg.speed) * _f32(cfg.dt))
    # the next street line strictly ahead (at most one a slot while
    # speed * dt < street_spacing); reaching it offers a turn, boundary
    # lines included
    q = u * inv_s
    ahead = st.sgn > 0
    m = torch.where(ahead, (torch.floor(q) + 1.0) * s,
                    (torch.ceil(q) - 1.0) * s)
    crossed = torch.where(ahead, u_new >= m, u_new <= m)

    r = jr.uniform(k_turn, (n, 2))
    turn = crossed & (m >= 0.0) & (m <= side) & (r[..., 0] < 0.5)
    turn_sgn = torch.where(r[..., 1] < 0.5, 1.0, -1.0)

    over = u_new > side
    under = u_new < 0.0
    u_ref = torch.where(over, _f32(2 * cfg.area_side) - u_new,
                        torch.where(under, -u_new, u_new))
    sgn_ref = torch.where(over | under, -st.sgn, st.sgn)

    u_fin = torch.where(turn, m, u_ref)
    sgn = torch.where(turn, turn_sgn, sgn_ref)
    horiz = st.horiz ^ turn
    pos = torch.stack([torch.where(st.horiz, u_fin, w),
                       torch.where(st.horiz, w, u_fin)], -1)
    return ManhattanState(pos=pos, horiz=horiz, sgn=sgn)


#: name -> model; the same names key the analytic registry
#: ``repro_torch.core.mobility.CONTACT_MODELS``.
MOBILITY_MODELS = {
    "rdm": MobilityModel(name="rdm", init=_rdm_init, step=_rdm_step),
    "rwp": MobilityModel(name="rwp", init=_rwp_init, step=_rwp_step),
    "manhattan": MobilityModel(name="manhattan", init=_manhattan_init,
                               step=_manhattan_step),
}


def register_mobility(model: MobilityModel) -> MobilityModel:
    """Add (or replace) ``model`` in :data:`MOBILITY_MODELS` under its
    name, so ``SimConfig(mobility=model.name)`` runs it; returns it. Its
    state needs ``pos`` ``(B, N, 2)``. A dispatched sweep's workers are
    processes of their own: a model registered here reaches them only if
    the module that registers it is imported there."""
    MOBILITY_MODELS[model.name] = model
    return model


def get_mobility(name: str) -> MobilityModel:
    try:
        return MOBILITY_MODELS[name]
    except KeyError:
        raise ValueError(
            f"unknown mobility model {name!r}; known: "
            f"{sorted(MOBILITY_MODELS)}") from None


def replay_model(track: torch.Tensor) -> MobilityModel:
    """A model replaying ``track`` ``(T + 1, B, N, 2)``: frame 0 at init,
    frame ``t + 1`` after step ``t``. Its init splits the key as the
    replayed model's did: in 3 (rwp, manhattan, rdm at one speed), in 4
    under ``cfg.speed_range`` (rdm's speed key)."""
    def init(key, cfg):
        key = jr.split(key, _init_splits(cfg))[..., -1, :]
        return ReplayState(pos=track[0], frame=0), key

    def step(_k1, _k2, s: ReplayState, cfg) -> ReplayState:
        return ReplayState(pos=track[s.frame + 1], frame=s.frame + 1)

    return MobilityModel(name="replay", init=init, step=step)


# ------------------------------------------------- the contact-rate probe

def measure_contact_rate(key, *, name: str, cfg, n_slots: int,
                         device=None) -> torch.Tensor:
    """Mean per-node contact rate [1/s] of mobility model ``name``: a 0-d
    float32 tensor on ``device`` (``cuda`` unless the caller passes
    ``"cpu"``).

    Rolls the model alone (no protocol) for ``n_slots`` slots, per slot
    ``key, k1, k2 = split(key, 3)``, and counts *new* proximity events
    (distance <= r_tx): the bits of this slot's packed contact words that
    were not set the slot before, summed over ordered pairs, so each event
    counts once for each endpoint, as the per-node ``g`` of the twins
    does. The words come from ``pairwise_contacts`` with every zone word 1
    and every node eligible (one kernel launch a slot on a card, plus one
    for the initial words); the count stays on the device. ``key`` is a
    ``(2,)`` key or an int seed."""
    device = resolve_device(device, "measure_contact_rate")
    if not torch.is_tensor(key):
        key = jr.PRNGKey(int(key))
    model = get_mobility(name)
    mob, key = model.init(key.to(device).reshape(1, 2), cfg)
    # the key chain, one split a slot, runs on the host and crosses once:
    # on a card each split is ~180 tiny kernels, a third of a probe slot
    key, chain = key.cpu(), []
    for _ in range(n_slots):
        key, k1, k2 = jr.split(key, 3).unbind(-2)
        chain.append(torch.stack([k1, k2]))
    chain = torch.stack(chain).to(device) if chain else None
    n = cfg.n_nodes
    r_tx2 = _f32(cfg.r_tx ** 2)
    ones = torch.ones((1, n), dtype=torch.int32, device=device)
    everyone = torch.ones((1, n), dtype=torch.bool, device=device)

    def words(pos, prevw):
        return pairwise_contacts(pos[..., 0].contiguous(),
                                 pos[..., 1].contiguous(), ones, everyone,
                                 prevw, r_tx2)[0]

    prev = words(mob.pos, torch.zeros((1, n, (n + 31) // 32),
                                      dtype=torch.int32, device=device))
    total = torch.zeros((), dtype=torch.int64, device=device)
    for t in range(n_slots):
        mob = model.step(chain[t, 0], chain[t, 1], mob, cfg)
        close = words(mob.pos, prev)
        total = total + packed_popcount(close & ~prev).sum()
        prev = close
    # XLA divides by the constant as a product with its float32 reciprocal
    return total.to(torch.float32) * _f32(
        1.0 / _f32(cfg.n_nodes * n_slots * cfg.dt))
