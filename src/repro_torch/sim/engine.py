"""The slot loop: single runs and batches of runs (port of
``repro.sim.engine``).

``simulate(p, cfg, seed)`` runs ``repro``'s slot step in its exact order
and with its exact PRNG split sequence, as a Python loop over slots on one
device (``cuda`` unless the caller passes ``device="cpu"``);
``simulate_batch(ps, cfg, seeds)`` runs a (scenarios x seeds) grid through
the same loop at once (``repro_torch.sim.sweep``):

1. mobility step; 2. zone-membership words; 3. zone churn; 4. the contact
sweep (partner proximity, exchanges, deliveries); 5. merge enqueue,
release and new connections; 6. observations and the train enqueue;
7. the compute server (timers, completions, next jobs).

An output sample is taken every ``cfg.sample_every`` slots. The loop makes
no host synchronisation: samples stay on the device and are copied to the
host once, at the end.

The loop carries ``B = P·R`` runs on a leading axis, scenario-major: row
``b`` is scenario ``b // R`` and seed ``b % R``, as ``BatchSimOutputs``'
``(P, R, ...)`` axes. The dynamic parameters are float32 ``(B,)`` tensors.
What depends only on the seed — the key chain, mobility, zone words, the
observer ranks and the shared contact stage (the dense contact matrix on
the CPU, the cell lists on either device) — runs once per seed on R rows
and is broadcast to the B rows, as ``repro``'s ``vmap`` and
``shared_barrier`` do. On a card the contact kernel runs once a slot for
all B rows.

With ``cfg.learn`` set, the Gossip-Learning layer
(``repro_torch.sim.learn``) rides the same loop at ``repro``'s four sites:
replicas reset on zone churn (and crashes), deliveries merge after the
contact sweep, parameters are snapshotted when connections form, and
finished training jobs take an SGD step. It never feeds back into the
protocol.

With an enabled ``cfg.faults`` (a ``repro_torch.sim.faults.FaultConfig``)
the fault layer rides the loop at ``repro``'s sites: a second key split
after the base one feeds the duty chain (this slot's accessibility
``on``), the crash coin, the link coin and the abort coin, all drawn once
a seed; crashed nodes drop their state like zone churn; ``on`` is folded
into the zone words of both contact backends (off nodes get a zero word
before the kernel runs); failed links break exchanges; free-riders'
deliveries are dropped; eligibility, observers and new jobs need ``on``,
and an off node's compute timer freezes; new matches abort on their
pair's coin. The per-class telemetry (``availability_c``, ``on_frac_c``,
``n_in_rz_c``) and the cumulative ``fault_events`` come back with every
sample. A disabled configuration runs exactly the fault-free program.

The port runs the paper's validation loop: ``rdm`` (or ``replay``)
mobility at constant speed, a single static zone, any ``M``, with or
without the protocol faults and learning (average or trimmed defenses),
on either contact backend: the dense O(N²) sweep, or the cell lists of
``repro_torch.sim.cells`` (``contact_backend="cells"``, or ``"auto"`` from
``cells.AUTO_CELLS_MIN_N`` nodes up), whose running overflow count comes
back as ``nbr_overflow``. Any other configuration raises
``NotImplementedError`` naming the slice that will port it.
"""

from __future__ import annotations

import dataclasses
import warnings
from functools import partial
from typing import Any, Sequence

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

__all__ = ["SimConfig", "SimOutputs", "BatchSimOutputs", "effective_zones",
           "zone_churn", "dynamic_params", "stack_dynamic_params",
           "simulate", "simulate_batch", "mobility_track", "check_overflow",
           "scan_carry_bytes"]


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
    faults: Any = None                   # repro_torch.sim.faults.FaultConfig;
                                         # None or a disabled config runs
                                         # exactly the fault-free program
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
    # fault telemetry (enabled FaultConfig only; C = n_classes)
    availability_c: np.ndarray | None = None   # (S, M, C) per-class in-RZ
                                               # model availability
    on_frac_c: np.ndarray | None = None        # (S, C) accessible fraction
    n_in_rz_c: np.ndarray | None = None        # (S, C)
    fault_events: np.ndarray | None = None     # (S, 3) cumulative
                                               # abort/link-fail/crash
    # learning telemetry (enabled LearnConfig only; repro_torch.sim.learn)
    test_acc: np.ndarray | None = None         # (S,) population mean accuracy
    test_acc_holders: np.ndarray | None = None # (S,) mean over in-RZ holders
    learn_obs: np.ndarray | None = None        # (S,) mean obs count / holder
    theta_var: np.ndarray | None = None        # (S,) mean parameter variance
    merge_stats: np.ndarray | None = None      # (S, 6) cumulative counters


#: The optional traces of ``SimOutputs``: the cells backend's overflow,
#: the fault and the learning telemetry.
_OPTIONAL = ("nbr_overflow", "availability_c", "on_frac_c", "n_in_rz_c",
             "fault_events", "test_acc", "test_acc_holders", "learn_obs",
             "theta_var", "merge_stats")


@dataclasses.dataclass
class BatchSimOutputs:
    """Batched traces with leading (scenario, seed) axes, as numpy arrays.

    ``point(i, j)`` is the ``SimOutputs`` of scenario ``i``, seed ``j``.
    The fields from ``plan`` on describe how ``repro_torch.sim.sweep.run``
    executed the batch; they stay ``None``/empty for instances built
    elsewhere."""

    t: np.ndarray                # (S,)
    availability: np.ndarray     # (P, R, S, M)
    busy_frac: np.ndarray        # (P, R, S)
    stored_info: np.ndarray      # (P, R, S)
    obs_birth: np.ndarray        # (P, R, S, M, K)
    obs_holders: np.ndarray      # (P, R, S, M, K)
    model_holders: np.ndarray    # (P, R, S, M)
    n_in_rz: np.ndarray          # (P, R, S)
    availability_z: np.ndarray | None = None   # (P, R, S, M, K_zones)
    stored_info_z: np.ndarray | None = None    # (P, R, S, K_zones)
    n_in_rz_z: np.ndarray | None = None        # (P, R, S, K_zones)
    nbr_overflow: np.ndarray | None = None     # (P, R, S) cells backend only
    availability_c: np.ndarray | None = None   # (P, R, S, M, C)
    on_frac_c: np.ndarray | None = None        # (P, R, S, C)
    n_in_rz_c: np.ndarray | None = None        # (P, R, S, C)
    fault_events: np.ndarray | None = None     # (P, R, S, 3)
    test_acc: np.ndarray | None = None         # (P, R, S)
    test_acc_holders: np.ndarray | None = None # (P, R, S)
    learn_obs: np.ndarray | None = None        # (P, R, S)
    theta_var: np.ndarray | None = None        # (P, R, S)
    merge_stats: np.ndarray | None = None      # (P, R, S, 6)
    plan: Any = None             # SweepPlan of the producing sweep
    devices_used: int | None = None
    host_bytes: int | None = None
    failed_chunks: tuple = ()    # sweep chunks that exhausted their retries
    coverage: Any = None         # (n_scenarios,) bool: False = filled rows
    quarantined: tuple = ()      # poison chunks (the dispatch queue's; empty)
    telemetry: Any = None        # per-chunk attempt and latency records

    @property
    def n_scenarios(self) -> int:
        return self.availability.shape[0]

    @property
    def n_seeds(self) -> int:
        return self.availability.shape[1]

    def point(self, scenario: int, seed: int) -> SimOutputs:
        def _z(arr):
            return None if arr is None else arr[scenario, seed]

        return SimOutputs(
            t=self.t,
            **{f: _z(getattr(self, f)) for f in (
                "availability", "busy_frac", "stored_info", "obs_birth",
                "obs_holders", "model_holders", "n_in_rz", "availability_z",
                "stored_info_z", "n_in_rz_z") + _OPTIONAL},
        )


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


def stack_dynamic_params(ps: Sequence[FGParams], device=None) -> dict:
    """The dynamic parameters of each scenario stacked into float32
    ``(P,)`` tensors."""
    dicts = [dynamic_params(p) for p in ps]
    return {k: torch.tensor([d[k] for d in dicts], dtype=torch.float32,
                            device=device)
            for k in dicts[0]}


def _check_params(ps: Sequence[FGParams]) -> int:
    """The one model count ``M`` of a batch; raises for mixed ``M`` and
    for ``W < M``."""
    m_values = {int(p.M) for p in ps}
    if len(m_values) != 1:
        raise ValueError(
            f"one batch runs one model count M; got {sorted(m_values)} — "
            "split the sweep by M")
    for p in ps:
        if p.W < p.M:
            raise NotImplementedError(
                "simulator covers the W >= M (w = 1) regime used in the "
                "paper's evaluation; pass M = min(M, W) for the general case")
    return m_values.pop()


def _check_config(cfg: SimConfig) -> None:
    """Raises ``ValueError`` for a ``faults`` or ``learn`` that is not the
    port's record and ``NotImplementedError`` for what this port does not
    run."""
    backend = cells.contact_backend(cfg)        # raises on an unknown name
    for field, kind in (("faults", faults.FaultConfig),
                        ("learn", learning.LearnConfig)):
        value = getattr(cfg, field)
        if value is not None and not isinstance(value, kind):
            raise ValueError(
                f"SimConfig.{field} must be a {kind.__module__}."
                f"{kind.__name__} (got {type(value).__name__})")
    later = None
    zs = effective_zones(cfg)
    if cfg.mobility not in ("rdm", "replay"):
        later = f"mobility={cfg.mobility!r} (the rwp/manhattan slice)"
    elif cfg.speed_range is not None:
        later = "speed_range (the rwp/manhattan mobility slice)"
    elif cfg.faults is not None and cfg.faults.adversarial:
        later = ("an adversarial fault configuration (the Byzantine slice: "
                 "the poisoned learning payloads)")
    elif zs.k != 1 or zs.moving:
        later = "multi-zone or drifting ZoneSets (the multizone slice)"
    if later is not None:
        on = " on the cell-list backend" if backend == "cells" else ""
        raise NotImplementedError(f"repro_torch does not run {later}{on} yet")


def _check_supported(p: FGParams, cfg: SimConfig) -> int:
    """The model count ``M`` of one run; raises for what the port does not
    run."""
    m = _check_params([p])
    _check_config(cfg)
    return m


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
    if torch.is_tensor(positions):
        track = positions.to(device=device, dtype=torch.float32)
    else:
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


def _run(key, p_dyn: dict, cfg: SimConfig, M: int, model, task=None, *,
         trace: str = "full") -> dict:
    """The slot loop of ``B`` runs: the per-sample outputs, stacked on the
    device (leading axes: sample, then the B rows).

    ``key`` ``(R, 2)`` holds one key a seed and ``p_dyn`` maps each dynamic
    parameter to a float32 ``(B,)`` tensor, ``B`` a multiple of ``R``, rows
    scenario-major (row ``b`` runs seed ``b % R``); ``model``'s state has R
    rows. ``task`` is the learning task of ``cfg.learn`` (drawn from the
    config when None). ``trace="light"`` leaves out the per-observation
    traces (``obs_birth``, ``obs_holders``), which only the o(τ) estimator
    reads."""
    dt = cfg.dt
    t0, T_L, T_T, T_M = (p_dyn[k] for k in ("t0", "T_L", "T_T", "T_M"))
    tau_l = p_dyn["tau_l"]
    b = tau_l.shape[0]
    rows = partial(compute.broadcast_rows, b=b)
    r_tx2 = float(np.float32(cfg.r_tx ** 2))
    zs = effective_zones(cfg)
    use_cells = cells.contact_backend(cfg) == "cells"
    grid = cells.make_grid(cfg) if use_cells else None
    n_run = cfg.n_slots // cfg.sample_every * cfg.sample_every

    # ---- fault constants: a None or disabled FaultConfig keeps every
    # fault branch below dead, the key chain included ----
    fc = cfg.faults if cfg.faults is not None and cfg.faults.enabled else None
    if fc is not None:
        n, dev = cfg.n_nodes, key.device
        ids = faults.node_classes(fc, n)
        cls1h_np = faults.class_onehot(fc, n)
        cls1h = torch.from_numpy(cls1h_np).to(dev)
        n_per_class = torch.tensor(cls1h_np.sum(axis=0), dtype=torch.float32,
                                   device=dev)

        def per_node(rates):
            # per-slot probabilities 1 - exp(-rate dt), float64 -> float32
            return torch.from_numpy(np.asarray(
                [1.0 - np.exp(-r * dt) for r in rates], np.float32)[ids]
            ).to(dev)

        p_off = per_node([c.rate_off for c in fc.classes])
        p_on = per_node([c.rate_on for c in fc.classes])
        p_crash = faults.threshold(1.0 - np.exp(-fc.crash_rate * dt))
        p_link = float(1.0 - np.exp(-fc.link_fail_rate * dt))
        is_fr = torch.from_numpy(np.asarray(
            [c.free_rider for c in fc.classes], bool)[ids]).to(dev)

    lc = cfg.learn
    if lc is not None:
        if task is None:
            task = learning.make_task(lc, key.device)
        dc = lc.active_defense
        trimmed_on = dc is not None and dc.mode == "trimmed"

    def zone_word(pos):
        return zone_words(_zone_member(pos, zs))

    mob, key = model.init(key, cfg)
    state = init_sim_state(mob, rows(zone_word(mob.pos)), M=M, cfg=cfg,
                           task=task)
    samples = []
    for slot in range(n_run):
        t_now = float(np.float32(slot) * np.float32(dt))
        key, k_mob1, k_mob2, k_obs, k_who = jr.split(key, 5).unbind(-2)
        access = access_seed = None
        if fc is not None:
            # the fault layer's keys come from a second split, so the base
            # split (and every fault-free draw) is untouched; its four
            # draws (duty, crash, link, abort) and the duty chain run once
            # a seed
            sub = jr.split(key, 5)
            key = sub[..., 0, :]
            u_duty, u_crash, u_link, u_abort = faults.slot_draws(
                sub[..., 1:, :], cfg.n_nodes)
            availw, access_seed = faults.duty_step(u_duty, state.availw,
                                                   p_off, p_on)
            access = rows(access_seed)

        # ---- mobility and zone membership (once a seed), zone churn ----
        mob = model.step(k_mob1, k_mob2, state.mob, cfg)
        zonew_seed = zone_word(mob.pos)
        zonew = rows(zonew_seed)
        pos = rows(mob.pos)
        in_rz = zonew != 0
        left, churned = zone_churn(
            state.zone_prev, zonew, inc=state.inc, has_model=state.has_model,
            tq_model=state.tq_model, mq_model=state.mq_model,
            serving=state.serving, serv_left=state.serv_left,
        )
        inc, has_model = churned["inc"], churned["has_model"]
        tq_model, mq_model = churned["tq_model"], churned["mq_model"]
        serving, serv_left = churned["serving"], churned["serv_left"]
        drop = left
        if fc is not None:
            # crash-restart: the same drop path; the node stays (and on)
            crashed = rows(u_crash < p_crash)
            dropped = faults.drop_state(
                crashed, inc=inc, has_model=has_model, tq_model=tq_model,
                mq_model=mq_model, serving=serving, serv_left=serv_left)
            inc, has_model = dropped["inc"], dropped["has_model"]
            tq_model, mq_model = dropped["tq_model"], dropped["mq_model"]
            serving, serv_left = dropped["serving"], dropped["serv_left"]
            drop = left | crashed
        if lc is not None:
            # learning churn: the replica goes back to the shared init
            lrn = learning.reset_replicas(
                drop, state.theta, state.theta_cnt, state.theta_age,
                task.theta0, peer_fill=state.peer_fill if trimmed_on else None)

        # ---- contact sweep. Dense: shared matrix on the CPU (once a
        # seed), fused kernel later on a CUDA device, over all B rows (then
        # the O(N) recompute gives the proximity bit). Cells: bounded
        # neighbour lists from the cell grid (once a seed), and the O(N)
        # recompute for the proximity bit. Accessibility (seed-only) is
        # folded into the zone words of either.
        if use_cells:
            nbr, ovf = (rows(t) for t in cells.neighbor_lists(
                mob.pos, zonew_seed, grid, r_tx2, access_seed))
            still_close = contacts.pair_still_close(
                pos, zonew, state.partner, r_tx2, access)
        else:
            closew_shared, ctx = contacts.pairwise_close(
                mob.pos, zonew_seed, r_tx2, access_seed)
            ctx = tuple(rows(c) if torch.is_tensor(c) else c for c in ctx)
            if closew_shared is None:
                still_close = contacts.pair_still_close(
                    pos, zonew, state.partner, r_tx2, access)
            else:
                still_close = contacts.partner_close_bit(
                    rows(closew_shared), state.partner)
        if fc is not None:
            # a failed link breaks the exchange like moving out of range
            lfail = faults.link_fail(u_link, p_link, state.partner)
            still_close = still_close & ~lfail
        elapsed, _, _, ending, eff_time, pidx = contacts.advance_exchanges(
            partner=state.partner, exch_elapsed=state.exch_elapsed,
            exch_total=state.exch_total, still_close=still_close, dt=dt,
        )
        delivered, sender_words = contacts.compute_deliveries(
            order_seed=state.order_seed, snap_has=state.snap_has,
            snap=state.snap, pidx=pidx, eff_time=eff_time, ending=ending,
            t0=t0, T_L=T_L,
        )
        if fc is not None:
            # free-riders receive but never serve
            delivered = faults.gate_deliveries(delivered, pidx, is_fr)
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
        if fc is not None:
            # redundant with the folded zone words; keeps it explicit
            elig = elig & access
        if use_cells:
            best, has = cells.candidate_best(pos, nbr, state.prev_close,
                                             elig)
            match = contacts.mutualize(best, has)
            closew = nbr                # the cells path's prev_close carry
        else:
            closew, match = contacts.match_candidates(ctx, state.prev_close,
                                                      elig)
        if fc is not None:
            # connection-setup abort, one coin a pair
            match, aborted = faults.abort_matches(u_abort, fc.p_abort, match)
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
                obs_head=state.obs_head, inc=inc,
                in_rz=in_rz if fc is None else in_rz & access,
                lam=p_dyn["lam"], Lam=p_dyn["Lam"], dt=dt, t_now=t_now,
            ))
        tq_model, tq_slot = compute.enqueue_ascending(
            tq_model, want_train, (state.tq_slot, slot_payload))

        # ---- compute server: finish jobs, then pick next (merge first);
        # an off node's timer freezes and it starts no job ----
        serv_left, fin_merge, fin_train = compute.advance_timers(
            serving, serv_left,
            dt if fc is None else torch.where(access, dt, 0.0))
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
            tq_slot=tq_slot, T_M=T_M, T_T=T_T, can_serve=access,
        )
        fault_kw = {}
        if fc is not None:
            events = torch.stack([
                aborted.sum(-1), ((state.partner >= 0) & lfail).sum(-1),
                crashed.sum(-1)], -1).to(torch.int32)
            fault_kw = dict(availw=availw,
                            fault_events=state.fault_events + events)
        state = state.replace(
            mob=mob, prev_close=closew, inc=inc, has_model=has_model,
            obs_birth=obs_birth, obs_head=obs_head, tq_slot=tq_slot,
            mq_mask=mq_mask, zone_prev=zonew, **conn, **served, **fault_kw,
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
                with_obs_trace=trace == "full",
            )
            if use_cells:
                out["nbr_overflow"] = state.nbr_overflow
            if fc is not None:
                out.update(faults.fault_outputs(
                    on=rows(compute.unpack_mask(state.availw, cfg.n_nodes)),
                    in_rz=state.zone_prev != 0, has_model=state.has_model,
                    cls1h=cls1h, n_per_class=n_per_class,
                    fault_events=state.fault_events))
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
    replaying with ``mobility="replay"``. An enabled ``cfg.faults`` adds
    its key split a slot, as the engine does."""
    device = resolve_device(device, "simulate")
    model = get_mobility(cfg.mobility)
    key = jr.PRNGKey(seed, device=device)[None]
    mob, key = model.init(key, cfg)
    frames = [mob.pos]
    faulted = cfg.faults is not None and cfg.faults.enabled
    for _ in range(cfg.n_slots):
        key, k1, k2, _, _ = jr.split(key, 5).unbind(-2)
        if faulted:
            key = jr.split(key, 5)[..., 0, :]
        mob = model.step(k1, k2, mob, cfg)
        frames.append(mob.pos)
    return torch.stack(frames)[:, 0].cpu().numpy()


def _sample_times(cfg: SimConfig) -> np.ndarray:
    """The engine samples once every ``sample_every`` slots, at slot
    indices ``s-1, 2s-1, ...``."""
    s = cfg.sample_every
    return (np.arange(cfg.n_slots) * cfg.dt)[s - 1::s]


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
    outs = _run(key, stack_dynamic_params([p], device), cfg, M, model, task)
    host = {k: v[:, 0].cpu().numpy() for k, v in outs.items()}
    if "nbr_overflow" in host:
        check_overflow(cfg, host["nbr_overflow"], context="simulate")
    return SimOutputs(
        t=_sample_times(cfg),
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
        **{k: host.get(k) for k in _OPTIONAL},
    )


def simulate_batch(ps: Sequence[FGParams] | FGParams, cfg: SimConfig,
                   seeds: Sequence[int] = (0,),
                   device=None) -> BatchSimOutputs:
    """One (scenarios x seeds) Monte-Carlo sweep: traces shaped
    ``(len(ps), len(seeds), n_samples, ...)``, every row equal to its
    ``simulate`` run. A thin wrapper over
    ``repro_torch.sim.sweep.run(..., reduce="trace")``, which also streams
    large grids in chunks and reduces them on the device."""
    from repro_torch.sim import sweep

    return sweep.run(ps, cfg, seeds, reduce="trace", device=device)


def scan_carry_bytes(cfg: SimConfig, M: int) -> int:
    """Bytes of one run's carry: its ``SimState`` plus its PRNG key,
    shapes only (built on the ``meta`` device, nothing is allocated).

    Every ``SimState`` field has ``repro``'s shape and width (packed words
    are int32 here, uint32 there), so the carry is ``repro``'s
    ``scan_carry_bytes`` plus 8: the key is two int64 words here (torch has
    no uint32 arithmetic on the CPU, ``repro_torch.random``) against two
    uint32 words in ``repro``."""
    key = jr.PRNGKey(0, device="meta")[None]
    mob, key = get_mobility("rdm" if cfg.mobility == "replay"
                            else cfg.mobility).init(key, cfg)
    zone0 = torch.zeros((1, cfg.n_nodes), dtype=torch.int32, device="meta")
    task = (learning.make_task(cfg.learn, "meta")
            if cfg.learn is not None else None)
    state = init_sim_state(mob, zone0, M=M, cfg=cfg, task=task)
    leaves = [key] + [getattr(mob, f.name) for f in dataclasses.fields(mob)]
    leaves += [getattr(state, f.name) for f in dataclasses.fields(state)
               if f.name != "mob" and getattr(state, f.name) is not None]
    return sum(t.numel() * t.element_size() for t in leaves)


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
