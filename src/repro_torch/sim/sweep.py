"""Sweeps: a (scenarios x seeds) grid of runs through one slot loop (port of
``repro.sim.sweep``).

**One batch axis.** A sweep's runs share the engine's batch axis ``B``,
scenario-major (row ``b`` is scenario ``b // R``, seed ``b % R``), so the
grid's runs share each slot's kernel launches: on a card the contact
kernel runs once a slot for every row. What depends only on the seed —
the key chain, mobility, zone words, observer ranks and the shared contact
stage — runs once per seed and is broadcast over the scenarios
(``repro_torch.sim.engine``). Every row equals its own ``simulate`` run bit
for bit.

**The plan.** :func:`plan_sweep` is ``repro``'s planner: it factorizes a
device count over both grid axes, pads each axis with repeats of its last
row, and rounds the scenario axis to whole chunks. The port runs a sweep
on one device (``n_devices > 1`` raises; ROADMAP queue 1, item 10).

**Chunks.** The scenario axis streams in chunks of ``chunk_scenarios``;
each chunk's next one is issued before the chunk is copied to the host (on
a card the copy runs on a side stream, into pinned memory, behind the
chunk's own work), so device memory holds about two chunks.

**Reductions.** ``reduce="mean" | "final" | "quantiles" | "o_tau"`` reduce
each run's trace over the post-warmup samples on the device and copy only
the statistics; ``"trace"`` returns the full ``BatchSimOutputs``.

**Checkpoints.** With ``checkpoint_dir`` every completed chunk is saved
atomically with content hashes (``repro_torch.checkpoint.ckpt``), under a
fingerprint of the sweep; ``resume=True`` reloads the chunks whose
fingerprint matches and recomputes the rest, warning about any unreadable,
corrupt, foreign or shape-drifted file. A chunk that fails is retried
under a :class:`repro_torch.sim.dispatch.RetryPolicy`; one that exhausts
it is NaN/zero-filled, listed in ``failed_chunks`` and masked out of
``coverage``.

**Workers.** ``workers=`` runs the chunks in that many worker processes
through :mod:`repro_torch.sim.dispatch`'s file-system lease queue, which
survives killed, hung, frozen, slow and corrupt workers; its chunk files
are the checkpoint files above, so either path can resume the other.
"""

from __future__ import annotations

import dataclasses
import hashlib
import os
import time
import warnings
from typing import NamedTuple, Sequence

import numpy as np
import torch

from repro_torch import random as jr
from repro_torch import resolve_device
from repro_torch.core.meanfield import FGParams
from repro_torch.sim import cells
from repro_torch.sim.engine import (BatchSimOutputs, SimConfig, _check_config,
                                    _check_params, _mobility, _run,
                                    _sample_times, check_overflow,
                                    effective_zones, stack_dynamic_params)

__all__ = ["SweepPlan", "SweepSummary", "plan_sweep", "run", "REDUCERS",
           "expected_shapes"]

#: Valid ``reduce=`` modes: "trace" ships the full per-sample trace; the
#: others reduce on the device over the post-warmup samples ("o_tau": the
#: o(τ) estimator's holder-fraction age histograms).
REDUCERS = ("trace", "mean", "final", "quantiles", "o_tau")

#: Quantities of the light (reduced) trace, reduced per run over the
#: sample axis; the ``*_z`` ones keep their trailing zone axis.
_LIGHT_KEYS = ("availability", "busy_frac", "stored", "model_holders",
               "n_in_rz", "availability_z", "stored_z", "n_in_rz_z")

#: Fault telemetry (enabled ``FaultConfig`` only; trailing class axis C),
#: reduced like the light keys; the cumulative ``fault_events`` ride every
#: reduction as their final sample, like ``nbr_overflow``.
_FAULT_KEYS = ("availability_c", "on_frac_c", "n_in_rz_c")

#: Learning telemetry (enabled ``LearnConfig`` only; the last two, the
#: Byzantine contamination, under an adversarial ``FaultConfig`` only),
#: reduced like the light keys; the cumulative ``merge_stats`` ride every
#: reduction as their final sample, like ``nbr_overflow``.
_LEARN_KEYS = ("test_acc", "test_acc_holders", "learn_obs", "theta_var",
               "poisoned_frac", "poisoned_frac_c")

#: The optional reduced quantities, in ``repro``'s order.
_EXTRA_KEYS = _FAULT_KEYS + _LEARN_KEYS

#: Cumulative counters: every reduction keeps their final sample.
_RIDERS = ("nbr_overflow", "fault_events", "merge_stats")

#: ``BatchSimOutputs`` field of each engine output that is named otherwise.
_FIELD = {"stored": "stored_info", "stored_z": "stored_info_z"}


@dataclasses.dataclass(frozen=True)
class SweepPlan:
    """Placement of a (scenarios x seeds) grid on a device mesh.

    ``mesh_shape = (d_scen, d_seed)`` multiplies to the device count; the
    grid axes are padded to ``pad_scenarios`` / ``pad_seeds`` (multiples
    of their mesh axis) and the scenario axis streams in ``n_chunks``
    chunks of ``chunk_scenarios``."""

    n_scenarios: int
    n_seeds: int
    n_devices: int
    mesh_shape: tuple[int, int]
    pad_scenarios: int
    pad_seeds: int
    chunk_scenarios: int

    @property
    def n_chunks(self) -> int:
        return self.pad_scenarios // self.chunk_scenarios

    @property
    def padded_runs(self) -> int:
        return self.pad_scenarios * self.pad_seeds

    @property
    def utilization(self) -> float:
        """Real runs / padded runs (1.0 = no padding)."""
        return self.n_scenarios * self.n_seeds / self.padded_runs


def plan_sweep(n_scenarios: int, n_seeds: int, n_devices: int | None = None,
               chunk_size: int | None = None) -> SweepPlan:
    """Factorize ``n_devices`` (default 1) over the (scenario, seed) grid.

    Every divisor pair ``(d_scen, d_seed)`` is scored by the padded runs it
    implies (each axis rounded up to a multiple of its mesh axis); the
    least wins, ties keeping the larger ``d_scen``. ``chunk_size``
    scenarios a chunk (rounded up to a multiple of ``d_scen``; None: one
    chunk); the scenario axis then pads to whole chunks."""
    if n_devices is None:
        n_devices = 1
    if n_scenarios < 1 or n_seeds < 1:
        raise ValueError("empty sweep grid")

    best = None
    for d_scen in range(n_devices, 0, -1):
        if n_devices % d_scen:
            continue
        d_seed = n_devices // d_scen
        pad_p = -(-n_scenarios // d_scen) * d_scen
        pad_r = -(-n_seeds // d_seed) * d_seed
        cost = pad_p * pad_r
        # strict < keeps the largest d_scen (first seen) on ties
        if best is None or cost < best[0]:
            best = (cost, d_scen, d_seed, pad_p, pad_r)
    _, d_scen, d_seed, pad_p, pad_r = best

    if chunk_size is None:
        chunk_p = pad_p
    else:
        chunk_p = max(1, min(chunk_size, pad_p))
        chunk_p = -(-chunk_p // d_scen) * d_scen
        pad_p = -(-pad_p // chunk_p) * chunk_p
    return SweepPlan(
        n_scenarios=n_scenarios, n_seeds=n_seeds, n_devices=n_devices,
        mesh_shape=(d_scen, d_seed), pad_scenarios=pad_p, pad_seeds=pad_r,
        chunk_scenarios=chunk_p,
    )


@dataclasses.dataclass
class SweepSummary:
    """A sweep reduced on the device.

    ``stats`` maps each quantity to a numpy array with leading (scenario,
    seed) axes: time-means (and ``*_std``, ddof 0) for ``reduce="mean"``,
    the last sample for ``"final"``, a trailing quantile axis for
    ``"quantiles"``, the age histograms and their ratio for ``"o_tau"``.
    ``host_bytes`` counts the bytes copied from the device, pad rows
    included. ``coverage`` is an ``(n_scenarios,)`` mask, False on the rows
    of the chunks in ``failed_chunks`` (NaN/zero fill); ``telemetry`` holds
    each chunk's attempts and latency."""

    reduce: str
    t: np.ndarray
    warmup_samples: int
    stats: dict[str, np.ndarray]
    plan: SweepPlan
    devices_used: int
    host_bytes: int
    quantiles: tuple[float, ...] | None = None
    failed_chunks: tuple[int, ...] = ()
    coverage: np.ndarray | None = None
    quarantined: tuple[int, ...] = ()     # poison chunks of the dispatch queue
    telemetry: dict | None = None


class ShapeDtype(NamedTuple):
    """Shape and numpy dtype of one quantity of a chunk's host result."""

    shape: tuple
    dtype: np.dtype


def _sample_shapes(cfg: SimConfig, M: int, trace: str) -> dict:
    """Per-run, per-sample trailing shape and dtype of each engine output."""
    f32, i32 = np.dtype(np.float32), np.dtype(np.int32)
    kz = effective_zones(cfg).k
    out = {"availability": ((M,), f32), "busy_frac": ((), f32),
           "stored": ((), f32), "model_holders": ((M,), i32),
           "n_in_rz": ((), i32), "availability_z": ((M, kz), f32),
           "stored_z": ((kz,), f32), "n_in_rz_z": ((kz,), i32)}
    if trace == "full":
        out.update(obs_birth=((M, cfg.k_obs), f32),
                   obs_holders=((M, cfg.k_obs), i32))
    if cells.contact_backend(cfg) == "cells":
        out["nbr_overflow"] = ((), i32)
    if cfg.faults is not None and cfg.faults.enabled:
        c = cfg.faults.n_classes
        out.update(availability_c=((M, c), f32), on_frac_c=((c,), f32),
                   n_in_rz_c=((c,), i32), fault_events=((3,), i32))
    if cfg.learn is not None:
        out.update({k: ((), f32) for k in _LEARN_KEYS[:4]})
        out["merge_stats"] = ((6,), i32)
        if cfg.faults is not None and cfg.faults.adversarial:
            out.update(poisoned_frac=((), f32),
                       poisoned_frac_c=((cfg.faults.n_classes,), f32))
    return out


def expected_shapes(cfg: SimConfig, M: int, plan: SweepPlan, reduce: str,
                    quantiles: tuple = (), tau: tuple = ()) -> dict:
    """Quantity name -> :class:`ShapeDtype` of one chunk's host result,
    from the sweep's definition alone (nothing runs): what a checkpoint
    file or a retried chunk is validated against and what a failed chunk
    is filled with. ``tau`` is ``(n_tau, dtau)`` for ``reduce="o_tau"``."""
    if reduce not in REDUCERS:
        raise ValueError(f"unknown reduce mode {reduce!r}; known: {REDUCERS}")
    lead = (plan.chunk_scenarios, plan.pad_seeds)
    f32 = np.dtype(np.float32)
    per = _sample_shapes(cfg, M, "full" if reduce in ("trace", "o_tau")
                         else "light")
    if reduce == "trace":
        s = cfg.n_slots // cfg.sample_every
        return {k: ShapeDtype(lead + (s,) + tail, dt)
                for k, (tail, dt) in per.items()}
    keys = [k for k in _LIGHT_KEYS + _EXTRA_KEYS if k in per]
    out = {}
    if reduce == "o_tau":
        out = {k: ShapeDtype(lead + (tau[0],), f32)
               for k in ("o_tau_num", "o_tau_den")}
        out.update({k: ShapeDtype(lead + per[k][0], per[k][1])
                    for k in keys if k in _EXTRA_KEYS})
    elif reduce == "mean":
        for k in keys:
            out[k] = out[k + "_std"] = ShapeDtype(lead + per[k][0], f32)
    elif reduce == "final":
        out = {k: ShapeDtype(lead + per[k][0], per[k][1]) for k in keys}
    else:
        out = {k: ShapeDtype(lead + per[k][0] + (len(quantiles),), f32)
               for k in keys}
    out.update({k: ShapeDtype(lead + per[k][0], per[k][1])
                for k in _RIDERS if k in per})
    return out


def _reduce_outs(outs: dict, reduce: str, s0: int, qs, tau, t) -> dict:
    """Per-run reduction over the sample axis (axis 2) of ``(P, R, S, ...)``
    device tensors; ``t`` is the ``(S,)`` float32 sample times."""
    keys = _LIGHT_KEYS + tuple(k for k in _EXTRA_KEYS if k in outs)
    if reduce == "o_tau":
        from repro_torch.sim.observations import o_tau_histograms

        n_tau, dtau = tau
        num, den = o_tau_histograms(
            t=t[s0:], obs_birth=outs["obs_birth"][:, :, s0:],
            obs_holders=outs["obs_holders"][:, :, s0:].float(),
            model_holders=outs["model_holders"][:, :, s0:].float(),
            n_tau=n_tau, dtau=dtau)
        red = {"o_tau_num": num, "o_tau_den": den}
        # the fault and learning telemetry ride the o_tau reduction as
        # final samples
        for k in keys[len(_LIGHT_KEYS):]:
            red[k] = outs[k][:, :, -1]
    elif reduce == "mean":
        red = {}
        for k in keys:
            v = outs[k][:, :, s0:].float()
            red[k] = v.mean(2)
            red[k + "_std"] = v.std(2, correction=0)
    elif reduce == "final":
        red = {k: outs[k][:, :, -1] for k in keys}
    elif reduce == "quantiles":
        q = torch.tensor(qs, dtype=torch.float32, device=t.device)
        # the quantile levels land on the TRAILING axis of every quantity
        red = {k: torch.quantile(outs[k][:, :, s0:].float(), q, dim=2)
               .movedim(0, -1) for k in keys}
    else:
        raise ValueError(f"unknown reduce mode {reduce!r}; known: {REDUCERS}")
    for k in _RIDERS:
        if k in outs:
            # cumulative counters: the final sample is the whole run's
            red[k] = outs[k][:, :, -1]
    return red


def _chunk_worker(cfg: SimConfig, M: int, reduce: str, s0: int, qs: tuple,
                  tau: tuple, positions=None):
    """The per-chunk program: ``worker(keys, p_chunk)`` runs the chunk's
    ``(P_c, R)`` runs from ``keys`` ``(R, 2)`` and ``p_chunk`` (each
    dynamic parameter a float32 ``(P_c,)`` tensor) and returns its outputs
    (reduced or not) as device tensors with leading ``(P_c, R)`` axes.
    ``positions`` ``(n_slots + 1, R, N, 2)`` are replayed under
    ``mobility="replay"``."""
    # o_tau reads the per-observation traces, so it runs the full trace
    trace = "full" if reduce in ("trace", "o_tau") else "light"

    def worker(keys, p_chunk):
        device = keys.device
        model = _mobility(cfg, positions, device)
        r = keys.shape[0]
        p_dyn = {k: v.repeat_interleave(r) for k, v in p_chunk.items()}
        outs = _run(keys, p_dyn, cfg, M, model, trace=trace)
        # (S, P_c·R, ...) -> (P_c, R, S, ...)
        outs = {k: v.reshape(v.shape[0], -1, r, *v.shape[2:]).movedim(0, 2)
                for k, v in outs.items()}
        if reduce == "trace":
            return outs
        t = torch.tensor(_sample_times(cfg), dtype=torch.float32,
                         device=device)
        return _reduce_outs(outs, reduce, s0, qs, tau, t)

    return worker


def _host_copy(out: dict):
    """Start copying a chunk's outputs to the host; returns the function
    that finishes the copy and gives numpy arrays. On a CUDA device the
    copy waits for the chunk's work on a side stream and lands in pinned
    memory, so work issued after this call runs beside it."""
    dev = [v for v in out.values() if torch.is_tensor(v) and v.is_cuda]
    if not dev:
        return lambda: {k: v.numpy() if torch.is_tensor(v) else np.asarray(v)
                        for k, v in out.items()}
    device = dev[0].device
    done = torch.cuda.Event()
    done.record(torch.cuda.current_stream(device))
    side = torch.cuda.Stream(device)
    side.wait_event(done)
    host = {}
    with torch.cuda.stream(side):
        for k, v in out.items():
            if torch.is_tensor(v) and v.is_cuda:
                host[k] = torch.empty(v.shape, dtype=v.dtype, pin_memory=True)
                host[k].copy_(v, non_blocking=True)
    copied = torch.cuda.Event()
    copied.record(side)

    def finish():
        copied.synchronize()         # ``out`` stays alive until here
        return {k: host[k].numpy() if k in host else
                (v.numpy() if torch.is_tensor(v) else np.asarray(v))
                for k, v in out.items()}

    return finish


def _pad_rows(arr: torch.Tensor, to: int) -> torch.Tensor:
    pad = to - arr.shape[0]
    if pad == 0:
        return arr
    return torch.cat([arr, arr[-1:].expand(pad, *arr.shape[1:])])


def _sweep_fingerprint(cfg, M, plan, reduce, s0, qs, tau, seeds, p_stack,
                       positions=None) -> str:
    """Content hash of everything that determines a sweep's results: the
    config's repr, the model count, the plan, the reduction, the seeds, the
    parameter bytes and, where given, the replayed positions."""
    h = hashlib.sha256()
    h.update(repr(
        (cfg, M, plan, reduce, s0, qs, tau, tuple(int(s) for s in seeds))
    ).encode())
    for k in sorted(p_stack):
        h.update(k.encode())
        h.update(p_stack[k].cpu().numpy().tobytes())
    if positions is not None:
        h.update(positions.cpu().numpy().tobytes())
    return h.hexdigest()


def _fp_array(fp: str) -> np.ndarray:
    return np.frombuffer(bytes.fromhex(fp), dtype=np.uint8)


def _tree_mismatch(tree: dict, expected: dict | None) -> str | None:
    """Why ``tree`` cannot be this sweep's chunk result (None: it can):
    missing or extra quantities, or a shape or dtype other than
    ``expected``'s."""
    if expected is None:
        return None
    missing = sorted(set(expected) - set(tree))
    extra = sorted(set(tree) - set(expected))
    if missing or extra:
        return f"key mismatch (missing {missing}, unexpected {extra})"
    for k, s in expected.items():
        arr = np.asarray(tree[k])
        if tuple(arr.shape) != tuple(s.shape):
            return (f"shape mismatch for {k!r}: file has {arr.shape}, "
                    f"sweep expects {tuple(s.shape)}")
        if arr.dtype != s.dtype:
            return (f"dtype mismatch for {k!r}: file has {arr.dtype}, "
                    f"sweep expects {np.dtype(s.dtype)}")
    return None


def _load_chunks(directory: str, fp: str, n_chunks: int,
                 expected: dict | None = None) -> dict[int, dict]:
    """The completed chunks in ``directory`` whose fingerprint is ``fp``.
    An unreadable, corrupt (content hash), foreign (fingerprint or plan)
    or shape-drifted file is skipped with a warning naming the chunk and
    the reason, and its chunk recomputes."""
    from repro_torch.checkpoint.ckpt import restore_checkpoint

    done: dict[int, dict] = {}
    if not os.path.isdir(directory):
        return done
    for name in sorted(os.listdir(directory)):
        if not (name.startswith("step_") and name.endswith(".npz")):
            continue
        path = os.path.join(directory, name)
        chunk_id = name[len("step_"):-len(".npz")].lstrip("0") or "0"
        try:
            like = {k: 0 for k in np.load(path).files}
            tree, step = restore_checkpoint(path, like, verify=True)
        except Exception as e:
            warnings.warn(
                f"skipping sweep checkpoint chunk {chunk_id} ({path}): "
                f"unreadable or corrupt ({e}); recomputing")
            continue
        saved_fp = tree.pop("fingerprint", None)
        if (saved_fp is None
                or not np.array_equal(saved_fp, _fp_array(fp))
                or not 0 <= step < n_chunks):
            warnings.warn(
                f"skipping sweep checkpoint {path}: fingerprint/plan "
                "mismatch (different sweep)")
            continue
        reason = _tree_mismatch(tree, expected)
        if reason is not None:
            warnings.warn(
                f"skipping sweep checkpoint chunk {chunk_id} ({path}): "
                f"{reason}; recomputing")
            continue
        done[step] = tree
    return done


def _fill_chunk(expected: dict) -> dict:
    """A chunk that never completed: NaN floats, zero integers, at the
    expected shapes (always paired with False in the coverage mask)."""
    def fill(s):
        if np.issubdtype(s.dtype, np.floating):
            return np.full(s.shape, np.nan, s.dtype)
        return np.zeros(s.shape, s.dtype)

    return {k: fill(s) for k, s in expected.items()}


@dataclasses.dataclass
class _SweepSetup:
    """A validated sweep definition: the config, plan and reduction, the
    compile-key-normalised knobs, the padded parameters and keys."""

    cfg: SimConfig
    M: int
    plan: SweepPlan
    reduce: str
    quantiles: tuple
    s0: int                # warmup samples (reported)
    key_s0: int            # what the reduction reads: the warmup only for
    key_qs: tuple          # mean, quantiles and o_tau, the levels only for
    key_tau: tuple         # quantiles, the age grid only for o_tau
    p_stack: dict          # padded parameter stack (scenario axis)
    keys: torch.Tensor     # padded keys (seed axis), (pad_seeds, 2)
    positions: torch.Tensor | None   # (n_slots + 1, pad_seeds, N, 2)

    def worker(self):
        return _chunk_worker(self.cfg, self.M, self.reduce, self.key_s0,
                             self.key_qs, self.key_tau, self.positions)

    def chunk_params(self, c: int) -> dict:
        cp = self.plan.chunk_scenarios
        return {k: v[c * cp:(c + 1) * cp] for k, v in self.p_stack.items()}

    def expected_shapes(self) -> dict:
        return expected_shapes(self.cfg, self.M, self.plan, self.reduce,
                               self.key_qs, self.key_tau)


def _prepare(ps, cfg, seeds, reduce, warmup_frac, chunk_size, quantiles,
             tau_grid, n_devices, device, positions) -> _SweepSetup:
    """Validate and normalise a sweep definition."""
    if isinstance(ps, FGParams):
        ps = [ps]
    if reduce not in REDUCERS:
        raise ValueError(f"unknown reduce mode {reduce!r}; known: {REDUCERS}")
    M = _check_params(ps)
    _check_config(cfg)
    if n_devices is not None and n_devices > 1:
        raise NotImplementedError(
            "repro_torch runs a sweep on one device; splitting it across "
            "several cards is ROADMAP queue 1, item 10 (multi-card sweeps)")
    seeds = [int(s) for s in seeds]
    plan = plan_sweep(len(ps), len(seeds), n_devices=1,
                      chunk_size=chunk_size)

    p_stack = {k: _pad_rows(v, plan.pad_scenarios)
               for k, v in stack_dynamic_params(ps, device).items()}
    keys = _pad_rows(
        torch.stack([jr.PRNGKey(s % 2**32, device=device) for s in seeds]),
        plan.pad_seeds)
    if positions is not None:
        if cfg.mobility != "replay":
            raise ValueError(
                "positions are replayed only with mobility='replay'")
        track = torch.tensor(np.asarray(positions, np.float32), device=device)
        if track.dim() != 4 or track.shape[0] != len(seeds):
            raise ValueError(
                "positions must be (n_seeds, n_slots + 1, N, 2); got "
                f"{tuple(track.shape)}")
        positions = _pad_rows(track, plan.pad_seeds).movedim(0, 1)
        positions = positions.contiguous()
    elif cfg.mobility == "replay":
        raise ValueError("mobility='replay' needs positions")

    n_samples = cfg.n_slots // cfg.sample_every
    wf = cfg.warmup_frac if warmup_frac is None else warmup_frac
    s0 = min(int(n_samples * wf), n_samples - 1)
    key_s0 = s0 if reduce in ("mean", "quantiles", "o_tau") else 0
    key_qs = tuple(quantiles) if reduce == "quantiles" else ()
    if reduce == "o_tau":
        if tau_grid is None:
            raise ValueError('reduce="o_tau" needs a tau_grid')
        tau_grid = np.asarray(tau_grid, np.float64)
        dtaus = np.diff(tau_grid)
        if len(tau_grid) < 2 or not np.allclose(dtaus, dtaus[0]):
            raise ValueError("tau_grid must be a uniform grid")
        key_tau = (len(tau_grid), float(tau_grid[1] - tau_grid[0]))
    else:
        key_tau = ()
    return _SweepSetup(
        cfg=cfg, M=M, plan=plan, reduce=reduce, quantiles=tuple(quantiles),
        s0=s0, key_s0=key_s0, key_qs=key_qs, key_tau=key_tau,
        p_stack=p_stack, keys=keys, positions=positions)


def _setup_fingerprint(setup: _SweepSetup, seeds) -> str:
    return _sweep_fingerprint(
        setup.cfg, setup.M, setup.plan, setup.reduce, setup.key_s0,
        setup.key_qs, setup.key_tau, seeds, setup.p_stack, setup.positions)


def _coverage_mask(plan: SweepPlan, uncovered: Sequence[int]) -> np.ndarray:
    """``(n_scenarios,)`` bool, False exactly on the rows of the chunks in
    ``uncovered``."""
    cov = np.ones((plan.n_scenarios,), bool)
    cp = plan.chunk_scenarios
    for c in uncovered:
        cov[c * cp:(c + 1) * cp] = False
    return cov


def _finalize(setup: _SweepSetup, host_chunks: list, *, devices_used: int,
              failed: Sequence[int] = (), quarantined: Sequence[int] = (),
              telemetry: dict | None = None):
    """Assemble the chunks' host results (in chunk order) into the sweep's
    ``BatchSimOutputs`` or ``SweepSummary``; shared by the in-process
    runner and the dispatcher, so both give the same result from the same
    chunks."""
    plan, cfg, reduce = setup.plan, setup.cfg, setup.reduce
    failed = tuple(sorted(failed))
    quarantined = tuple(sorted(quarantined))
    P, R = plan.n_scenarios, plan.n_seeds
    host_bytes = sum(v.nbytes for hc in host_chunks for v in hc.values())
    outs = {k: np.concatenate([hc[k] for hc in host_chunks])[:P, :R]
            for k in host_chunks[0]}
    t = _sample_times(cfg)
    coverage = _coverage_mask(plan, failed)
    if failed:
        warnings.warn(
            f"{len(failed)} sweep chunk(s) failed after retry and were "
            f"NaN/zero-filled: {list(failed)} (see SweepSummary.coverage)")
    if "nbr_overflow" in outs:
        # uncovered chunks are zero-filled: they cannot trip the gate
        check_overflow(cfg, outs["nbr_overflow"], context="sweep")

    if reduce == "trace":
        return BatchSimOutputs(
            t=t, **{_FIELD.get(k, k): v for k, v in outs.items()},
            plan=plan, devices_used=devices_used, host_bytes=host_bytes,
            failed_chunks=failed, coverage=coverage, quarantined=quarantined,
            telemetry=telemetry)
    if reduce == "o_tau":
        # the ratio is host arithmetic on the copied histograms
        num, den = outs["o_tau_num"], outs["o_tau_den"]
        outs["o_tau"] = np.where(den > 0, num / np.maximum(den, 1), np.nan)
    return SweepSummary(
        reduce=reduce, t=t, warmup_samples=setup.s0, stats=outs, plan=plan,
        devices_used=devices_used, host_bytes=host_bytes,
        quantiles=setup.quantiles if reduce == "quantiles" else None,
        failed_chunks=failed, coverage=coverage, quarantined=quarantined,
        telemetry=telemetry)


def run(ps: Sequence[FGParams] | FGParams, cfg: SimConfig,
        seeds: Sequence[int] = (0,), *, reduce: str = "trace",
        warmup_frac: float | None = None, chunk_size: int | None = None,
        quantiles: Sequence[float] = (0.1, 0.5, 0.9), tau_grid=None,
        n_devices: int | None = None, checkpoint_dir: str | None = None,
        resume: bool = False, retry_policy=None, workers: int | None = None,
        queue_dir: str | None = None, xla_cache_dir: str | None = None,
        device=None, positions=None):
    """Run a (scenarios x seeds) sweep on one device.

    Args:
      ps:         one ``FGParams`` or a sequence (the scenario axis); all
                  share the model count ``M`` (mixed ``M`` raises
                  ``ValueError``).
      cfg:        the shared geometry and discretization.
      seeds:      the seeds (the replication axis).
      reduce:     ``"trace"`` (every per-sample trace, a
                  ``BatchSimOutputs``), or a reduction on the device over
                  the post-warmup samples, a ``SweepSummary``: ``"mean"``
                  (with ``*_std``, ddof 0), ``"final"`` (the last sample),
                  ``"quantiles"`` (linear, levels on the trailing axis),
                  ``"o_tau"`` (the o(τ) histograms ``o_tau_num`` /
                  ``o_tau_den`` and their ratio ``o_tau``; needs
                  ``tau_grid``). ``nbr_overflow``, ``fault_events`` and
                  ``merge_stats`` ride every reduction as their final
                  sample.
      warmup_frac: samples discarded before reducing (default
                  ``cfg.warmup_frac``).
      chunk_size: scenarios a chunk (None: one chunk); each chunk's next
                  one is issued before it is copied to the host.
      quantiles:  levels for ``reduce="quantiles"``.
      tau_grid:   a uniform age grid from 0 for ``reduce="o_tau"``.
      n_devices:  1 or None; more raises ``NotImplementedError``.
      checkpoint_dir: save every completed chunk there (atomic, content
                  hashes, the attempt in the manifest) under the sweep's
                  fingerprint, and retry chunks under ``retry_policy``; a
                  chunk that exhausts it is NaN/zero-filled, listed in
                  ``failed_chunks`` and masked out of ``coverage``.
      resume:     with ``checkpoint_dir``, reuse the chunks saved by this
                  same sweep; any other file is warned about and its
                  chunk recomputed.
      retry_policy: a :class:`repro_torch.sim.dispatch.RetryPolicy`
                  (default: two attempts).
      workers:    run the chunks in this many worker processes through
                  the lease queue, under ``retry_policy`` (default: three
                  attempts); see :func:`repro_torch.sim.dispatch.
                  run_dispatched` for the whole contract. The result then
                  also carries ``quarantined`` and the queue's telemetry.
      queue_dir:  the work-queue directory for ``workers=`` (default: a
                  temporary directory, or ``{checkpoint_dir}/.queue``).
      xla_cache_dir: accepted and created for ``workers=`` (default
                  ``{queue_dir}/xla_cache``) so the queue's layout is
                  ``repro``'s; the port compiles no programs, and its
                  workers share the checkout's CUDA kernel builds
                  (``build/repro_torch/``) instead.
      device:     ``cuda`` by default (raises without one); ``"cpu"``
                  runs the plain versions.
      positions:  ``(n_seeds, n_slots + 1, N, 2)`` frames per seed for
                  ``mobility="replay"``.

    Every row of the result equals its own ``simulate(p, cfg, seed)``.
    """
    if workers is not None:
        from repro_torch.sim import dispatch

        return dispatch.run_dispatched(
            ps, cfg, seeds, reduce=reduce, warmup_frac=warmup_frac,
            chunk_size=chunk_size, quantiles=quantiles, tau_grid=tau_grid,
            n_devices=n_devices, checkpoint_dir=checkpoint_dir,
            resume=resume, retry_policy=retry_policy, workers=workers,
            queue_dir=queue_dir, xla_cache_dir=xla_cache_dir, device=device,
            positions=positions)
    device = resolve_device(device, "sweep.run")
    setup = _prepare(ps, cfg, seeds, reduce, warmup_frac, chunk_size,
                     quantiles, tau_grid, n_devices, device, positions)
    plan = setup.plan
    worker_cell: list = []

    def dispatch_chunk(c):
        # the worker resolves lazily: a fully resumed sweep never builds it
        if not worker_cell:
            worker_cell.append(setup.worker())
        return worker_cell[0](setup.keys, setup.chunk_params(c))

    if checkpoint_dir is None:
        host_chunks: list[dict] = []
        pending = None
        for c in range(plan.n_chunks):
            copy = _host_copy(dispatch_chunk(c))
            if pending is not None:
                # chunk c is issued: now finish chunk c-1's copy
                host_chunks.append(pending())
            pending = copy
        host_chunks.append(pending())
        return _finalize(setup, host_chunks, devices_used=1)

    from repro_torch.checkpoint.ckpt import save_checkpoint
    from repro_torch.sim.dispatch import RetryPolicy

    policy = retry_policy if retry_policy is not None else RetryPolicy()
    fp = _setup_fingerprint(setup, seeds)
    expected = setup.expected_shapes()
    done = (_load_chunks(checkpoint_dir, fp, plan.n_chunks,
                         expected=expected) if resume else {})
    telemetry: dict = {"chunks": {}}
    by_idx: dict[int, dict] = {}
    failed: list[int] = []
    devices_used = 0
    for c in range(plan.n_chunks):
        if c in done:
            by_idx[c] = done[c]
            telemetry["chunks"][c] = {"attempts": 0, "resumed": True}
            continue
        hc = None
        t_claim = time.monotonic()
        attempt = 0
        for attempt in range(policy.max_attempts):
            # only Exception is retried: a KeyboardInterrupt or SystemExit
            # (the preemption checkpoints guard against) propagates
            try:
                hc = _host_copy(dispatch_chunk(c))()
                # validate before anything is saved: a retry that returned
                # other shapes must not reach the checkpoint directory
                reason = _tree_mismatch(hc, expected)
                if reason is not None:
                    hc = None
                    raise RuntimeError(
                        f"chunk result failed validation: {reason}")
                devices_used = 1
                break
            except Exception as e:
                warnings.warn(
                    f"sweep chunk {c} dispatch failed "
                    f"(attempt {attempt + 1}/{policy.max_attempts}): {e!r}")
                if attempt + 1 < policy.max_attempts:
                    delay = policy.backoff(attempt + 1, key=f"{fp}:{c}")
                    if delay > 0:
                        time.sleep(delay)
        latency = time.monotonic() - t_claim
        if hc is None:
            failed.append(c)
            by_idx[c] = _fill_chunk(expected)
            telemetry["chunks"][c] = {"attempts": policy.max_attempts,
                                      "latency_s": latency}
            continue
        save_checkpoint(
            checkpoint_dir, c, dict(hc, fingerprint=_fp_array(fp)),
            meta={"chunk": c, "attempt": attempt, "fingerprint": fp,
                  "schema": "sweep-chunk-v1"},
            integrity=True, atomic=True)
        by_idx[c] = hc
        telemetry["chunks"][c] = {"attempts": attempt + 1,
                                  "latency_s": latency}
    host_chunks = [by_idx[c] for c in range(plan.n_chunks)]
    return _finalize(setup, host_chunks, devices_used=devices_used,
                     failed=failed, telemetry=telemetry)
