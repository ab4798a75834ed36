"""The slot loop: one simulation run (port of ``repro.sim.engine``).

``simulate(p, cfg, seed)`` runs ``repro``'s slot step in its exact order
and with its exact PRNG split sequence, as a Python loop over slots on one
device (``cuda`` unless the caller passes ``device="cpu"``):

1. mobility step; 2. zone-membership words; 3. zone churn; 4. the contact
sweep (partner proximity, exchanges, deliveries); 5. merge enqueue,
release and new connections; 6. observations and the train enqueue;
7. the compute server (timers, completions, next jobs).

An output sample is taken every ``cfg.sample_every`` slots. The loop makes
no host synchronisation: samples stay on the device and are copied to the
host once, at the end.

With ``cfg.learn`` set, the Gossip-Learning layer
(``repro_torch.sim.learn``) rides the same loop at ``repro``'s four sites:
replicas reset on zone churn, deliveries merge after the contact sweep,
parameters are snapshotted when connections form, and finished training
jobs take an SGD step. It never feeds back into the protocol.

The port runs the paper's validation loop: ``rdm`` (or ``replay``)
mobility at constant speed, a single static zone, no faults, any ``M``,
with or without learning (average or trimmed defenses), on either contact
backend: the dense O(N²) sweep, or the cell lists of
``repro_torch.sim.cells`` (``contact_backend="cells"``, or ``"auto"`` from
``cells.AUTO_CELLS_MIN_N`` nodes up), whose running overflow count comes
back as ``nbr_overflow``. Any other configuration raises
``NotImplementedError`` naming the slice that will port it.
"""

from __future__ import annotations

import dataclasses
import warnings
from typing import Any

import numpy as np
import torch

from repro_torch import random as jr
from repro_torch import resolve_device
from repro_torch.core.meanfield import FGParams
from repro_torch.core.zones import ZoneSet, single_zone
from repro_torch.kernels.contacts import zone_words
from repro_torch.numerics import fma32
from repro_torch.sim import cells, compute, contacts, faults, observations
from repro_torch.sim import learn as learning
from repro_torch.sim.mobility import get_mobility, replay_model
from repro_torch.sim.state import init_sim_state

__all__ = ["SimConfig", "SimOutputs", "effective_zones", "zone_churn",
           "dynamic_params", "simulate", "mobility_track", "check_overflow"]


@dataclasses.dataclass(frozen=True)
class SimConfig:
    """Geometry, mobility and discretization (paper defaults): the fields
    and defaults of ``repro.sim.SimConfig`` that this slice reads or
    refuses. The rwp and manhattan settings come with their slice."""

    n_nodes: int = 200
    area_side: float = 200.0
    rz_radius: float = 100.0
    r_tx: float = 5.0
    speed: float = 1.0
    dir_change_rate: float = 1.0 / 20.0  # RDM heading renewal [1/s]
    dt: float = 0.25                     # slot [s]
    n_slots: int = 8000
    sample_every: int = 8                # output every k slots
    k_obs: int = 64                      # tracked observations per model
    q_train: int = 16                    # training queue slots per node
    q_merge: int = 16                    # merging queue slots per node
    warmup_frac: float = 0.3             # discarded transient fraction
    mobility: str = "rdm"                # "rdm" | "replay" (positions given)
    zones: ZoneSet | None = None         # None = one centered disc
    contact_backend: str = "auto"        # "dense" | "cells" | "auto"
    cell_cap: int | None = None          # cells: node slots per grid cell
                                         # (None = density-derived auto)
    nbr_cap: int | None = None           # cells: neighbour-list cap per node
                                         # (None = density-derived auto)
    speed_range: tuple | None = None     # per-node U(lo, hi) speeds (rdm)
    faults: Any = None
    learn: Any = None
    overflow_mode: str = "warn"          # cells: nbr_overflow > 0 warns
                                         # ("warn") or raises ("strict")

    def __post_init__(self):
        if self.speed_range is not None and self.mobility != "rdm":
            raise ValueError(
                "speed_range is implemented for the 'rdm' mobility model "
                f"only (got mobility={self.mobility!r})")
        if self.overflow_mode not in ("warn", "strict"):
            raise ValueError(f"unknown overflow_mode {self.overflow_mode!r}; "
                             "known: 'warn', 'strict'")


@dataclasses.dataclass
class SimOutputs:
    """Per-sample traces (leading axis = sample index), as numpy arrays."""

    t: np.ndarray                # (S,) sample times
    availability: np.ndarray     # (S, M) mean fraction of in-RZ nodes w/ model
    busy_frac: np.ndarray        # (S,)
    stored_info: np.ndarray      # (S,) mean obs (age<=tau_l) per in-RZ node
    obs_birth: np.ndarray        # (S, M, K) birth time of ring slot (-inf empty)
    obs_holders: np.ndarray      # (S, M, K) #in-RZ nodes having incorporated
    model_holders: np.ndarray    # (S, M) #in-RZ nodes with the model
    n_in_rz: np.ndarray          # (S,)
    availability_z: np.ndarray | None = None   # (S, M, K_zones)
    stored_info_z: np.ndarray | None = None    # (S, K_zones)
    n_in_rz_z: np.ndarray | None = None        # (S, K_zones)
    # cells backend only: running max of close pairs dropped per slot by
    # the bounded cell buffers and lists (0 = contact detection exact)
    nbr_overflow: np.ndarray | None = None     # (S,)
    # learning telemetry (enabled LearnConfig only; repro_torch.sim.learn)
    test_acc: np.ndarray | None = None         # (S,) population mean accuracy
    test_acc_holders: np.ndarray | None = None # (S,) mean over in-RZ holders
    learn_obs: np.ndarray | None = None        # (S,) mean obs count / holder
    theta_var: np.ndarray | None = None        # (S,) mean parameter variance
    merge_stats: np.ndarray | None = None      # (S, 6) cumulative counters


def effective_zones(cfg: SimConfig) -> ZoneSet:
    """``cfg.zones``, or the single centered disc of radius ``rz_radius``."""
    if cfg.zones is not None:
        return cfg.zones
    c = cfg.area_side / 2.0
    return single_zone((c, c), cfg.rz_radius)


def zone_churn(zone_prev, zonew, *, inc, has_model, tq_model, mq_model,
               serving, serv_left):
    """A node drops its protocol state exactly when it leaves the union of
    zones: ``(left, dict-of-updated-fields)``."""
    left = (zone_prev != 0) & (zonew == 0)
    return left, faults.drop_state(
        left, inc=inc, has_model=has_model, tq_model=tq_model,
        mq_model=mq_model, serving=serving, serv_left=serv_left,
    )


def dynamic_params(p: FGParams) -> dict:
    """The FGParams fields the engine reads, rounded to float32 as the
    reference's jitted program holds them."""
    vals = dict(t0=p.t0, T_L=p.T_L, T_T=p.T_T, T_M=p.T_M, lam=p.lam,
                tau_l=p.tau_l, Lam=float(p.Lam))
    return {k: float(np.float32(v)) for k, v in vals.items()}


def _check_supported(p: FGParams, cfg: SimConfig) -> int:
    """The model count ``M``; raises for what this slice does not run."""
    if p.W < p.M:
        raise NotImplementedError(
            "simulator covers the W >= M (w = 1) regime used in the paper's "
            "evaluation; pass M = min(M, W) for the general case")
    backend = cells.contact_backend(cfg)        # raises on an unknown name
    later = None
    if cfg.mobility not in ("rdm", "replay"):
        later = f"mobility={cfg.mobility!r} (the rwp/manhattan slice)"
    elif cfg.speed_range is not None:
        later = "speed_range (the rwp/manhattan mobility slice)"
    elif cfg.faults is not None and getattr(cfg.faults, "adversarial", False):
        later = ("an adversarial fault configuration (the Byzantine slice: "
                 "the poisoned learning payloads)")
    elif cfg.faults is not None and getattr(cfg.faults, "enabled", True):
        later = "an enabled fault configuration (the faults slice)"
    elif cfg.learn is not None and not isinstance(cfg.learn,
                                                  learning.LearnConfig):
        raise ValueError("SimConfig.learn must be a repro_torch.sim.learn."
                         f"LearnConfig (got {type(cfg.learn).__name__})")
    else:
        zs = effective_zones(cfg)
        if zs.k != 1 or zs.moving:
            later = "multi-zone or drifting ZoneSets (the multizone slice)"
    if later is not None:
        on = " on the cell-list backend" if backend == "cells" else ""
        raise NotImplementedError(f"repro_torch does not run {later}{on} yet")
    return int(p.M)


def _zone_member(pos, zs: ZoneSet):
    """``(B, N, 1)`` membership of the single static zone: ``‖pos - c‖ <=
    r`` with the norm's square as ``fma(dy, dy, dx*dx)`` — the reverse of
    d²'s order, as jitted XLA computes ``jnp.linalg.norm`` here."""
    cx, cy = (float(np.float32(v)) for v in zs.centers[0])
    dx = pos[..., 0] - cx
    dy = pos[..., 1] - cy
    d = torch.sqrt(fma32(dy, dy, dx * dx))
    return (d <= float(np.float32(zs.radii[0])))[..., None]


def _mobility(cfg: SimConfig, positions, device):
    if cfg.mobility != "replay":
        if positions is not None:
            raise ValueError("positions are replayed only with mobility='replay'")
        return get_mobility(cfg.mobility)
    if positions is None:
        raise ValueError("mobility='replay' needs positions")
    track = torch.tensor(np.asarray(positions, np.float32), device=device)
    if track.dim() == 3:
        track = track[:, None]
    if track.shape[0] < cfg.n_slots + 1 or track.shape[-2:] != (cfg.n_nodes, 2):
        raise ValueError(
            f"positions must be ({cfg.n_slots + 1}, {cfg.n_nodes}, 2); got "
            f"{tuple(track.shape)}")
    return replay_model(track)


#: Slots whose learning minibatches are drawn in one vectorized call.
STREAM_BLOCK = 64


def _run(key, p_dyn: dict, cfg: SimConfig, M: int, model, task=None) -> dict:
    """The slot loop from key ``key`` ``(B, 2)``: the per-sample outputs,
    stacked on the device (leading axis = sample). ``task`` is the learning
    task of ``cfg.learn`` (drawn from the config when None)."""
    dt = cfg.dt
    t0, T_L, T_T, T_M = (p_dyn[k] for k in ("t0", "T_L", "T_T", "T_M"))
    tau_l = p_dyn["tau_l"]
    r_tx2 = float(np.float32(cfg.r_tx ** 2))
    zs = effective_zones(cfg)
    use_cells = cells.contact_backend(cfg) == "cells"
    grid = cells.make_grid(cfg) if use_cells else None
    n_run = cfg.n_slots // cfg.sample_every * cfg.sample_every

    lc = cfg.learn
    if lc is not None:
        if task is None:
            task = learning.make_task(lc, key.device)
        dc = lc.active_defense
        trimmed_on = dc is not None and dc.mode == "trimmed"

    def zone_word(pos):
        return zone_words(_zone_member(pos, zs))

    mob, key = model.init(key, cfg)
    state = init_sim_state(mob, zone_word(mob.pos), M=M, cfg=cfg, task=task)
    samples = []
    for slot in range(n_run):
        t_now = float(np.float32(slot) * np.float32(dt))
        key, k_mob1, k_mob2, k_obs, k_who = jr.split(key, 5).unbind(-2)

        # ---- mobility, zone membership, zone churn ----
        mob = model.step(k_mob1, k_mob2, state.mob, cfg)
        zonew = zone_word(mob.pos)
        in_rz = zonew != 0
        left, churned = zone_churn(
            state.zone_prev, zonew, inc=state.inc, has_model=state.has_model,
            tq_model=state.tq_model, mq_model=state.mq_model,
            serving=state.serving, serv_left=state.serv_left,
        )
        inc, has_model = churned["inc"], churned["has_model"]
        tq_model, mq_model = churned["tq_model"], churned["mq_model"]
        serving, serv_left = churned["serving"], churned["serv_left"]
        if lc is not None:
            # learning churn: the replica goes back to the shared init
            lrn = learning.reset_replicas(
                left, state.theta, state.theta_cnt, state.theta_age,
                task.theta0, peer_fill=state.peer_fill if trimmed_on else None)

        # ---- contact sweep. Dense: shared matrix on the CPU, fused kernel
        # later on a CUDA device (then the O(N) recompute gives the
        # proximity bit). Cells: bounded neighbour lists from the cell grid,
        # and the O(N) recompute for the proximity bit.
        if use_cells:
            nbr, ovf = cells.neighbor_lists(mob.pos, zonew, grid, r_tx2)
            still_close = contacts.pair_still_close(
                mob.pos, zonew, state.partner, r_tx2)
        else:
            closew_shared, ctx = contacts.pairwise_close(mob.pos, zonew,
                                                         r_tx2)
            if closew_shared is None:
                still_close = contacts.pair_still_close(
                    mob.pos, zonew, state.partner, r_tx2)
            else:
                still_close = contacts.partner_close_bit(
                    closew_shared, state.partner)
        elapsed, _, _, ending, eff_time, pidx = contacts.advance_exchanges(
            partner=state.partner, exch_elapsed=state.exch_elapsed,
            exch_total=state.exch_total, still_close=still_close, dt=dt,
        )
        delivered, sender_words = contacts.compute_deliveries(
            order_seed=state.order_seed, snap_has=state.snap_has,
            snap=state.snap, pidx=pidx, eff_time=eff_time, ending=ending,
            t0=t0, T_L=T_L,
        )
        if lc is not None:
            # learning merge: the sender's connection-time snapshot
            lrn.update(learning.merge_deliveries(
                lc, delivered[..., learning.LEARN_MODEL], pidx, lrn["theta"],
                lrn["theta_cnt"], lrn["theta_age"], state.theta_snap,
                state.snap_cnt, state.snap_age, tau_l,
                merge_stats=state.merge_stats,
                peer_buf=state.peer_buf if trimmed_on else None,
                peer_fill=lrn.get("peer_fill")))
        # merge only what adds information (Y of Definition 4)
        adds = delivered & compute.packed_any(sender_words & ~inc)
        mq_model, mq_mask = compute.enqueue_ascending(
            mq_model, adds, (state.mq_mask, sender_words))

        # ---- release ending pairs, form new connections ----
        partner = torch.where(ending, -1, state.partner)
        elig = (partner < 0) & in_rz
        if use_cells:
            best, has = cells.candidate_best(mob.pos, nbr, state.prev_close,
                                             elig)
            match = contacts.mutualize(best, has)
            closew = nbr                # the cells path's prev_close carry
        else:
            closew, match = contacts.match_candidates(ctx, state.prev_close,
                                                      elig)
        conn = contacts.form_connections(
            partner=partner, match=match, has_model=has_model, inc=inc,
            snap=state.snap, snap_has=state.snap_has, exch_elapsed=elapsed,
            exch_total=state.exch_total, order_seed=state.order_seed,
            slot_idx=slot, t0=t0, T_L=T_L,
        )
        if lc is not None:
            # learning snapshot, beside the protocol's snap words
            lrn["theta_snap"], lrn["snap_cnt"], lrn["snap_age"] = (
                learning.snapshot_params(
                    match >= 0, lrn["theta"], lrn["theta_cnt"],
                    lrn["theta_age"], state.theta_snap, state.snap_cnt,
                    state.snap_age))

        # ---- observations and the training enqueue ----
        obs_birth, obs_head, inc, want_train, slot_payload = (
            observations.generate_observations(
                k_obs=k_obs, k_who=k_who, obs_birth=state.obs_birth,
                obs_head=state.obs_head, inc=inc, in_rz=in_rz,
                lam=p_dyn["lam"], Lam=p_dyn["Lam"], dt=dt, t_now=t_now,
            ))
        tq_model, tq_slot = compute.enqueue_ascending(
            tq_model, want_train, (state.tq_slot, slot_payload))

        # ---- compute server: finish jobs, then pick next (merge first) ----
        serv_left, fin_merge, fin_train = compute.advance_timers(
            serving, serv_left, dt)
        inc, has_model = observations.apply_completions(
            fin_merge=fin_merge, fin_train=fin_train,
            serv_model=state.serv_model, serv_mask=state.serv_mask,
            serv_slot=state.serv_slot, inc=inc, has_model=has_model,
            obs_birth=obs_birth,
        )
        serving = torch.where(fin_merge | fin_train, -1, serving)
        if lc is not None:
            # learning step: a finished training job on the learned model
            # whose observation is still in the ring
            if slot % STREAM_BLOCK == 0:
                slots = torch.arange(slot, min(slot + STREAM_BLOCK, n_run),
                                     device=key.device)
                stream = learning.stream_batches(lc, task, slots,
                                                 cfg.n_nodes)
            born = torch.gather(obs_birth[:, learning.LEARN_MODEL], -1,
                                state.serv_slot.to(torch.int64))
            did_train = (fin_train
                         & (state.serv_model == learning.LEARN_MODEL)
                         & (born > float("-inf")))
            lrn["theta"], lrn["theta_cnt"], lrn["theta_age"] = (
                learning.train_completions(
                    lc, slot, did_train, lrn["theta"], lrn["theta_cnt"],
                    lrn["theta_age"], dt,
                    tuple(t[slot % STREAM_BLOCK] for t in stream)))
        served = compute.pick_next_jobs(
            serving=serving, serv_left=serv_left, serv_model=state.serv_model,
            serv_mask=state.serv_mask, serv_slot=state.serv_slot,
            mq_model=mq_model, mq_mask=mq_mask, tq_model=tq_model,
            tq_slot=tq_slot, T_M=T_M, T_T=T_T,
        )
        state = state.replace(
            mob=mob, prev_close=closew, inc=inc, has_model=has_model,
            obs_birth=obs_birth, obs_head=obs_head, tq_slot=tq_slot,
            mq_mask=mq_mask, zone_prev=zonew, **conn, **served,
            **(lrn if lc is not None else {}),
            **(dict(nbr_overflow=torch.maximum(state.nbr_overflow, ovf))
               if use_cells else {}),
        )
        if (slot + 1) % cfg.sample_every == 0:
            out = observations.slot_outputs(
                inc=state.inc, has_model=state.has_model,
                obs_birth=state.obs_birth, in_rz=state.zone_prev != 0,
                member=compute.unpack_mask(state.zone_prev[..., None], zs.k),
                partner=state.partner, t_now=t_now, tau_l=tau_l,
            )
            if use_cells:
                out["nbr_overflow"] = state.nbr_overflow
            if lc is not None:
                out.update(learning.learn_outputs(
                    lc, task, state.theta, state.theta_cnt,
                    has_model=state.has_model, in_rz=state.zone_prev != 0,
                    merge_stats=state.merge_stats))
            samples.append(out)
    return {k: torch.stack([s[k] for s in samples]) for k in samples[0]}


def mobility_track(cfg: SimConfig, seed: int = 0, device=None) -> np.ndarray:
    """``(n_slots + 1, N, 2)`` positions of ``cfg.mobility`` under the
    engine's key schedule (what ``simulate`` moves the nodes through), for
    replaying with ``mobility="replay"``."""
    device = resolve_device(device, "simulate")
    model = get_mobility(cfg.mobility)
    key = jr.PRNGKey(seed, device=device)[None]
    mob, key = model.init(key, cfg)
    frames = [mob.pos]
    for _ in range(cfg.n_slots):
        key, k1, k2, _, _ = jr.split(key, 5).unbind(-2)
        mob = model.step(k1, k2, mob, cfg)
        frames.append(mob.pos)
    return torch.stack(frames)[:, 0].cpu().numpy()


def simulate(p: FGParams, cfg: SimConfig, seed: int = 0, device=None,
             positions=None, task=None) -> SimOutputs:
    """Run the simulator for the FG system ``p``.

    ``device`` defaults to ``cuda`` and raises where there is none;
    ``positions`` ``(n_slots + 1, N, 2)`` feed ``mobility="replay"``;
    ``task`` (a ``repro_torch.sim.learn.LearnTask``, e.g. from
    ``task_from_numpy``) replaces the one drawn from ``cfg.learn``."""
    M = _check_supported(p, cfg)
    device = resolve_device(device, "simulate")
    model = _mobility(cfg, positions, device)
    key = jr.PRNGKey(seed, device=device)[None]
    if task is not None:
        task = dataclasses.replace(
            task, **{f.name: getattr(task, f.name).to(device)
                     for f in dataclasses.fields(task)})
    outs = _run(key, dynamic_params(p), cfg, M, model, task)
    host = {k: v[:, 0].cpu().numpy() for k, v in outs.items()}
    if "nbr_overflow" in host:
        check_overflow(cfg, host["nbr_overflow"], context="simulate")
    s = cfg.sample_every
    return SimOutputs(
        t=(np.arange(cfg.n_slots) * cfg.dt)[s - 1::s],
        availability=host["availability"],
        busy_frac=host["busy_frac"],
        stored_info=host["stored"],
        obs_birth=host["obs_birth"],
        obs_holders=host["obs_holders"],
        model_holders=host["model_holders"],
        n_in_rz=host["n_in_rz"],
        availability_z=host["availability_z"],
        stored_info_z=host["stored_z"],
        n_in_rz_z=host["n_in_rz_z"],
        **{k: host.get(k) for k in ("nbr_overflow", "test_acc", "test_acc_holders",
                                    "learn_obs", "theta_var", "merge_stats")},
    )


def check_overflow(cfg: SimConfig, max_ovf, *, context: str = "run") -> int:
    """Post-run check of the cells backend's ``nbr_overflow``: a positive
    running max means contact detection dropped close pairs, which warns
    (:class:`repro_torch.sim.cells.NeighborOverflowWarning`) under
    ``cfg.overflow_mode == "warn"`` and raises ``RuntimeError`` under
    ``"strict"``. Returns the max as an int (0 when clean or None)."""
    if max_ovf is None:
        return 0
    mo = int(np.max(np.asarray(max_ovf))) if np.size(max_ovf) else 0
    if mo > 0:
        msg = (f"cell-list contact detection dropped close pairs ({context}: "
               f"running per-slot max {mo}); results undercount contacts — "
               "raise SimConfig.cell_cap / nbr_cap")
        if cfg.overflow_mode == "strict":
            raise RuntimeError(msg)
        warnings.warn(msg, cells.NeighborOverflowWarning, stacklevel=2)
    return mo
