"""Simulator state (port of ``repro.sim.state``), with a leading batch axis.

Every field keeps ``repro``'s name and shape behind a leading batch axis
``B`` (``simulate`` runs ``B = 1``; a sweep stacks runs there), so every
function of the port maps over runs without a ``vmap``. Packed mask words
are int32 tensors holding the uint32 bits (see ``repro_torch.sim.compute``).

:func:`state_from_numpy` and :func:`state_to_numpy` carry one run's state
across from and to ``repro``'s ``SimState`` converted to numpy — the
simulator's counterpart of moving weights across — so both packages can
start from one state.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch

from repro_torch.sim.cells import contact_backend, make_grid
from repro_torch.sim.mobility import ManhattanState, RDMState, RWPState

__all__ = ["SimState", "init_sim_state", "queue_dtypes", "state_from_numpy",
           "state_to_numpy", "WORD_FIELDS"]

#: Fields holding packed uint32 words (int32 here, uint32 in ``repro``).
WORD_FIELDS = ("snap", "order_seed", "prev_close", "inc", "mq_mask",
               "serv_mask", "zone_prev", "availw")


def queue_dtypes(M: int, k_obs: int):
    """(model-id dtype, ring-slot dtype) at the narrowest safe width."""
    id_dt = torch.int8 if M <= 127 else torch.int32
    slot_dt = torch.int16 if k_obs <= 32767 else torch.int32
    return id_dt, slot_dt


@dataclasses.dataclass(frozen=True)
class SimState:
    """Full per-slot state of the Floating Gossip simulator (``(B, ...)``)."""

    mob: Any                     # mobility sub-state (has .pos: (B, N, 2))
    partner: torch.Tensor        # (B, N) partner index, -1 = idle
    exch_elapsed: torch.Tensor   # (B, N) seconds since connection start
    exch_total: torch.Tensor     # (B, N) planned t0 + n * T_L
    snap: torch.Tensor           # (B, N, M, KW) packed masks at connection
    snap_has: torch.Tensor       # (B, N, M) had model at connection
    order_seed: torch.Tensor     # (B, N) uint32 bits: send-order seed
    prev_close: torch.Tensor     # (B, N, NW) packed previous contact matrix;
                                 # cells backend: (B, N, nbr_cap) int32
                                 # neighbour ids, -1 padded
    inc: torch.Tensor            # (B, N, M, KW) packed incorporation bits
    has_model: torch.Tensor      # (B, N, M)
    obs_birth: torch.Tensor      # (B, M, K) birth time of ring slot (-inf)
    obs_head: torch.Tensor       # (B, M) ring head
    tq_model: torch.Tensor       # (B, N, QT) training queue model ids
    tq_slot: torch.Tensor        # (B, N, QT) training queue ring slots
    mq_model: torch.Tensor       # (B, N, QM) merge queue model ids
    mq_mask: torch.Tensor        # (B, N, QM, KW) packed merge payloads
    serving: torch.Tensor        # (B, N) -1 idle, 0 merge, 1 train
    serv_left: torch.Tensor      # (B, N) remaining service time
    serv_model: torch.Tensor     # (B, N)
    serv_mask: torch.Tensor      # (B, N, KW) packed served merge payload
    serv_slot: torch.Tensor      # (B, N) train payload being served
    zone_prev: torch.Tensor      # (B, N) zone-membership word last slot
    nbr_overflow: torch.Tensor   # (B,) int32, always 0 on the dense backend
    # --- fault carry (None unless cfg.faults is an enabled FaultConfig;
    # see repro_torch.sim.faults) ---
    availw: Any = None           # (R, ceil(N/32)) int32 packed on/off
                                 # accessibility, one row a seed (the duty
                                 # chain draws on the seed's keys only)
    fault_events: Any = None     # (B, 3) int32 cumulative abort / link-fail
                                 # / crash node events
    # --- learning carry (None unless cfg.learn is enabled; see
    # repro_torch.sim.learn — D = flat parameter dim of the learned model) ---
    theta: Any = None            # (B, N, D) live replica parameters
    theta_cnt: Any = None        # (B, N) observations incorporated
    theta_age: Any = None        # (B, N) time since last fresh local step
    theta_snap: Any = None       # (B, N, D) parameters at connection
    snap_cnt: Any = None         # (B, N) count at connection
    snap_age: Any = None         # (B, N) age at connection
    merge_stats: Any = None      # (B, 6) int32 cumulative merge counters
    # --- Byzantine carry (learning under an adversarial cfg.faults only) ---
    poisoned: Any = None         # (B, N) bool replica contamination flag
    snap_poison: Any = None      # (B, N) bool payload flag at connection
    peer_buf: Any = None         # (B, N, R, D) trimmed mode: recent peers
    peer_fill: Any = None        # (B, N) int32 trimmed mode: peers accepted

    def replace(self, **kw) -> "SimState":
        return dataclasses.replace(self, **kw)


def init_sim_state(mob_state, zone0: torch.Tensor, *, M: int, cfg,
                   task=None) -> SimState:
    """Empty protocol state around an initialized mobility state.

    ``zone0`` is the ``(B, N)`` int32 initial zone word; the state lives on
    its device. A ``cfg.learn`` adds the learning carry, from
    ``task`` (a ``repro_torch.sim.learn.LearnTask``; drawn from the config
    when None), with the contamination flags under an adversarial
    ``cfg.faults``. With the cells backend the close carry is the bounded
    neighbour list, ``(B, N, nbr_cap)`` int32 filled with -1. An enabled
    ``cfg.faults`` adds the fault carry: every node on, on as many rows as
    ``mob_state`` has (one a seed), and no events."""
    b, n = zone0.shape
    k, qt, qm = cfg.k_obs, cfg.q_train, cfg.q_merge
    kw, nw = (k + 31) // 32, (n + 31) // 32
    id_dt, slot_dt = queue_dtypes(M, k)
    dev = zone0.device

    def full(shape, value, dtype):
        return torch.full(shape, value, dtype=dtype, device=dev)

    if contact_backend(cfg) == "cells":
        prev_close = full((b, n, make_grid(cfg).nbr_cap), -1, torch.int32)
    else:
        prev_close = full((b, n, nw), 0, torch.int32)

    return SimState(
        mob=mob_state,
        partner=full((b, n), -1, torch.int32),
        exch_elapsed=full((b, n), 0.0, torch.float32),
        exch_total=full((b, n), 0.0, torch.float32),
        snap=full((b, n, M, kw), 0, torch.int32),
        snap_has=full((b, n, M), False, torch.bool),
        order_seed=full((b, n), 0, torch.int32),
        prev_close=prev_close,
        inc=full((b, n, M, kw), 0, torch.int32),
        has_model=full((b, n, M), False, torch.bool),
        obs_birth=full((b, M, k), float("-inf"), torch.float32),
        obs_head=full((b, M), 0, torch.int32),
        tq_model=full((b, n, qt), -1, id_dt),
        tq_slot=full((b, n, qt), 0, slot_dt),
        mq_model=full((b, n, qm), -1, id_dt),
        mq_mask=full((b, n, qm, kw), 0, torch.int32),
        serving=full((b, n), -1, torch.int32),
        serv_left=full((b, n), 0.0, torch.float32),
        serv_model=full((b, n), 0, torch.int32),
        serv_mask=full((b, n, kw), 0, torch.int32),
        serv_slot=full((b, n), 0, torch.int32),
        zone_prev=zone0,
        nbr_overflow=full((b,), 0, torch.int32),
        **_fault_fields(cfg, mob_state.pos.shape[0], b, n, dev),
        **_learn_fields(cfg, task, b, n, dev),
    )


def _fault_fields(cfg, r: int, b: int, n: int, device) -> dict:
    fc = cfg.faults
    if fc is None or not fc.enabled:
        return {}
    from repro_torch.sim import faults

    return dict(availw=faults.init_avail(r, n, device),
                fault_events=torch.zeros((b, faults.N_EVENTS),
                                         dtype=torch.int32, device=device))


def _learn_fields(cfg, task, b: int, n: int, device) -> dict:
    if cfg.learn is None:
        return {}
    from repro_torch.sim import learn

    if task is None:
        task = learn.make_task(cfg.learn, device)
    return learn.init_fields(cfg.learn, task, b, n, fc=cfg.faults)


def _to_torch(a: np.ndarray, device) -> torch.Tensor:
    a = np.array(a)                                   # a writable copy
    if a.dtype == np.uint32:
        a = a.view(np.int32)
    return torch.from_numpy(a[None]).to(device)


def _mobility_state(fields: dict, device):
    """The mobility state whose field names are ``fields``' (an rdm, rwp
    or manhattan state: each has its own)."""
    for kind in (RDMState, RWPState, ManhattanState):
        if set(fields) == {f.name for f in dataclasses.fields(kind)}:
            return kind(**{k: _to_torch(v, device) for k, v in fields.items()})
    raise ValueError(f"no mobility state has the fields {sorted(fields)}")


def state_from_numpy(fields: dict, device) -> SimState:
    """The port's ``SimState`` (``B = 1``) from one ``repro`` run's state.

    ``fields`` maps every ``repro`` ``SimState`` field that is not None to
    a numpy array, except ``mob``, which maps the mobility state's fields
    to arrays: an rdm (``pos``, ``ang``, ``spd``), rwp (``pos``, ``dest``,
    ``wait``) or manhattan state (``pos``, ``horiz``, ``sgn``), told apart
    by those names. uint32 words become int32 bits."""
    kw = {f.name: _to_torch(fields[f.name], device)
          for f in dataclasses.fields(SimState)
          if f.name != "mob" and f.name in fields}
    kw["nbr_overflow"] = kw["nbr_overflow"].reshape(1)
    return SimState(mob=_mobility_state(fields["mob"], device), **kw)


def state_to_numpy(state: SimState, cfg, item: int = 0) -> dict:
    """Batch item ``item`` of ``state`` in ``repro``'s layout (numpy,
    uint32 words); the inverse of :func:`state_from_numpy`. ``cfg`` is the
    configuration the state runs: on its cells backend ``prev_close`` is
    the int32 neighbour list, not words. Fields carried one row a seed
    (``mob``, ``availw``) give row ``item % R``, the item's seed."""
    cells = contact_backend(cfg) == "cells"
    words = tuple(f for f in WORD_FIELDS
                  if not (cells and f == "prev_close"))

    def conv(name, t):
        a = t[item % t.shape[0]].cpu().numpy()
        return a.view(np.uint32) if name in words else a

    out = {f.name: conv(f.name, getattr(state, f.name))
           for f in dataclasses.fields(SimState)
           if f.name != "mob" and getattr(state, f.name) is not None}
    out["mob"] = {f.name: conv(f.name, getattr(state.mob, f.name))
                  for f in dataclasses.fields(state.mob)}
    return out
