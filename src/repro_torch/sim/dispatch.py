"""Fault-tolerant multi-process sweep dispatch: a lease-based work queue
(port of ``repro.sim.dispatch``).

A coordinator cuts a sweep's :class:`~repro_torch.sim.sweep.SweepPlan`
into chunk *tasks* and drives N worker *processes* through a file-system
work queue, so the study completes, degraded but correctly labelled, no
matter which workers die. Names, layout and on-disk formats are
``repro``'s: a queue directory means the same in both packages.

Everything is plain files under one ``queue_dir``:

``spec.pkl``
    The pickled sweep definition (params, config, seeds, reduction knobs,
    the device as a string, replayed positions as a numpy array) plus the
    sweep fingerprint. Workers rebuild the *identical*
    :class:`~repro_torch.sim.sweep._SweepSetup` from it on their own
    device and check its fingerprint, so every process runs the same
    chunk program and chunk results are bit for bit the same wherever
    they run.
``todo/chunk_{c}.{tag}.task``
    One JSON task per pending chunk attempt. Claiming is a single atomic
    ``os.rename`` of the task file into ``leases/``: exactly one of any
    number of concurrent claimers wins (the losers get ``ENOENT`` and move
    on); there is no lock server and no lock.
``leases/chunk_{c}.{tag}.lease``
    A claimed task. The owning worker renews the lease by touching its
    mtime every ``heartbeat_s`` (a daemon thread, so a busy chunk still
    heartbeats) and writes an ``.owner.json`` sidecar (worker id + pid).
    The coordinator expires a lease whose heartbeat is older than
    ``lease_ttl_s``, or at once when the owning worker process is seen
    dead, and re-enqueues the chunk with exponential backoff and
    deterministic jitter under the :class:`RetryPolicy`.
``results/step_{c}.npz`` (+ ``.json``)
    Completed chunk reductions in the ``repro_torch.checkpoint.ckpt``
    format: the *same* files ``sweep.run(checkpoint_dir=)`` writes and
    ``resume=`` reads (schema ``sweep-chunk-v1``, per-array content
    hashes, the sweep fingerprint, the attempt in the manifest). The
    coordinator validates every result (hashes, fingerprint, shapes)
    before accepting it; a corrupt write is deleted, costs the chunk an
    attempt, and the chunk re-runs. Chunk programs are pure functions of
    (chunk, spec), so duplicate results are equal bit for bit and the
    first completed one wins.
``failures/chunk_{c}.{tag}.json``
    A worker-side exception record (traceback included). After
    ``max_attempts`` failures the chunk is **quarantined**
    (``quarantine/chunk_{c}.json`` keeps the attempt history and the last
    traceback), its rows NaN/zero-filled and masked out of
    ``SweepSummary.coverage``: a poison chunk degrades the study, never
    sinks it.
``DONE``
    The coordinator's shutdown marker; idle workers exit when they see it.
``xla_cache``
    Created for ``repro``'s layout and left empty: the port compiles no
    programs at run time. Its only compiled artefacts are the CUDA
    libraries under ``build/repro_torch/`` (``repro_torch.kernels.build``),
    which every process of a checkout shares and keeps across runs; a
    coordinator on a card builds them once before it spawns its workers.

**Straggler re-dispatch.** Once ``straggler_min_done`` chunks have
completed, a lease older than ``straggler_factor`` times the
``straggler_quantile`` completion latency gets a *duplicate* task enqueued
(at most ``max_duplicates``; no attempt is charged): whichever copy ends
first supplies the (bit for bit equal) result.

**Chaos harness.** ``chaos=`` takes a schedule of fault injections
(:func:`chaos_directive`) matched on (chunk, attempt) inside the worker:
``kill`` (SIGKILL mid-task), ``hang`` (stop heartbeating and sleep),
``freeze`` (SIGSTOP self), ``slow`` (sleep, heartbeats continue),
``corrupt`` (garbage bytes over the chunk result), ``raise`` (a worker-side
exception). Any schedule yields either reductions equal bit for bit to the
in-process ``sweep.run``, or a correctly masked subset (the uncovered
chunks exactly the quarantined ones).

**No fallback.** A worker whose spec names ``cuda`` and that sees no CUDA
device raises :class:`DispatchError` before it claims anything; the pool
respawns it until ``max_respawns`` is spent and the coordinator then
raises :class:`DispatchError`. Nothing runs on the CPU in its place.
"""

from __future__ import annotations

import argparse
import concurrent.futures
import dataclasses
import hashlib
import json
import os
import pickle
import shutil
import signal
import subprocess
import sys
import tempfile
import threading
import time
import traceback
import warnings

import numpy as np
import torch

import repro_torch
from repro_torch import resolve_device
from repro_torch.checkpoint.ckpt import restore_checkpoint, save_checkpoint
from repro_torch.kernels import contacts as kc
from repro_torch.kernels import gossip_merge as gm
from repro_torch.sim import cells, sweep

__all__ = [
    "RetryPolicy", "DispatchError", "run_dispatched", "chaos_directive",
    "claim_task", "enqueue_task", "worker_main",
]


class DispatchError(RuntimeError):
    """The dispatcher could not complete the sweep (every worker died and
    the respawn budget is spent while chunks remain, no progress within
    ``stall_timeout_s``, or a worker cannot run the spec it was given)."""


# --------------------------------------------------------------------------
# retry policy


@dataclasses.dataclass(frozen=True)
class RetryPolicy:
    """Retry, backoff and lease knobs for chunk execution.

    The default ``max_attempts=2`` is the in-process runner's retry-once;
    the dispatcher runs with three by default. Backoff for attempt ``k``
    (the count of failures so far, from 1) is ``backoff_base_s *
    backoff_mult**(k-1)`` capped at ``backoff_max_s``, plus a
    deterministic jitter in ``[0, jitter * backoff)`` from a sha256 of
    ``(key, attempt)``: no global RNG, so a re-run backs off the same and
    two chunks do not retry in lockstep.
    """

    max_attempts: int = 2          # total attempts before quarantine
    backoff_base_s: float = 0.25   # first retry delay
    backoff_mult: float = 2.0      # exponential growth per attempt
    backoff_max_s: float = 30.0    # backoff ceiling
    jitter: float = 0.5            # jitter fraction of the backoff
    heartbeat_s: float = 0.5       # worker lease-renewal period
    lease_ttl_s: float = 5.0       # heartbeat age before a lease expires
    poll_s: float = 0.05           # coordinator/worker queue poll period
    straggler_quantile: float = 0.75   # completion-latency quantile ...
    straggler_factor: float = 4.0      # ... times this = re-dispatch age
    straggler_min_done: int = 3    # completions before stragglers re-dispatch
    max_duplicates: int = 1        # duplicate tasks per chunk (stragglers)
    max_respawns: int = 8          # replacement workers the pool may spawn
    stall_timeout_s: float = 60.0  # no progress + no live workers => fail

    def __post_init__(self):
        if self.max_attempts < 1:
            raise ValueError("max_attempts must be >= 1")
        if self.lease_ttl_s <= self.heartbeat_s:
            raise ValueError("lease_ttl_s must exceed heartbeat_s")

    def backoff(self, attempt: int, key: str = "") -> float:
        """Delay before re-enqueueing after the ``attempt``-th failure."""
        base = min(
            self.backoff_base_s * self.backoff_mult ** max(attempt - 1, 0),
            self.backoff_max_s,
        )
        if self.jitter <= 0.0:
            return base
        h = hashlib.sha256(f"{key}:{attempt}".encode()).digest()
        u = int.from_bytes(h[:8], "big") / 2.0 ** 64
        return base * (1.0 + self.jitter * u)


# --------------------------------------------------------------------------
# chaos schedule


_CHAOS_ACTIONS = ("kill", "hang", "freeze", "slow", "corrupt", "raise")


def chaos_directive(chunk: int, attempt: int, action: str,
                    seconds: float = 30.0) -> dict:
    """One chaos injection: when a worker claims ``chunk`` at task
    ``attempt``, perform ``action`` (see the module docstring).
    ``seconds`` sets the ``hang``, ``freeze`` and ``slow`` durations."""
    if action not in _CHAOS_ACTIONS:
        raise ValueError(f"unknown chaos action {action!r}; "
                         f"known: {_CHAOS_ACTIONS}")
    return {"chunk": int(chunk), "attempt": int(attempt),
            "action": action, "seconds": float(seconds)}


def _chaos_match(chaos: list[dict], chunk: int, attempt: int) -> dict | None:
    for d in chaos:
        if d["chunk"] == chunk and d["attempt"] == attempt:
            return d
    return None


# --------------------------------------------------------------------------
# queue primitives (plain files; every mutation is one atomic rename)


_DIRS = ("todo", "leases", "results", "failures", "quarantine")


def _q(queue_dir: str, *parts: str) -> str:
    return os.path.join(queue_dir, *parts)


def _init_queue(queue_dir: str) -> None:
    for d in _DIRS:
        os.makedirs(_q(queue_dir, d), exist_ok=True)


def _task_name(chunk: int, attempt: int, dup: int = 0) -> str:
    tag = f"a{attempt}" + (f"d{dup}" if dup else "")
    return f"chunk_{chunk:05d}.{tag}"


def _parse_task_name(name: str) -> tuple[int, int, int]:
    """``chunk_00003.a1d2.task`` -> (3, 1, 2), whatever the extension
    (``.task``, ``.lease``, ``.json``, ...)."""
    chunk_s, tag = name.split(".")[:2]
    chunk = int(chunk_s.split("_")[1])
    if "d" in tag:
        a_s, d_s = tag[1:].split("d")
        return chunk, int(a_s), int(d_s)
    return chunk, int(tag[1:]), 0


def enqueue_task(queue_dir: str, chunk: int, attempt: int,
                 dup: int = 0) -> str:
    """Publish a chunk task into ``todo/`` atomically (a temporary file,
    then a rename, so a claimer never sees a half-written task)."""
    name = _task_name(chunk, attempt, dup) + ".task"
    final = _q(queue_dir, "todo", name)
    tmp = final + f".tmp-{os.getpid()}"
    with open(tmp, "w") as f:
        json.dump({"chunk": chunk, "attempt": attempt, "dup": dup,
                   "enqueued_at": time.time()}, f)
    os.replace(tmp, final)
    return final


def claim_task(queue_dir: str, worker_id: str) -> dict | None:
    """Claim the lowest pending task by an atomic rename into ``leases/``.

    The rename is the whole claim protocol: of any number of concurrent
    claimers of one task file, exactly one rename succeeds; the rest see
    ``FileNotFoundError`` and try the next task. Returns ``{chunk,
    attempt, dup, lease}``, or None when nothing is claimable.
    """
    todo = _q(queue_dir, "todo")
    try:
        names = sorted(os.listdir(todo))
    except FileNotFoundError:
        return None
    for name in names:
        if not name.endswith(".task"):
            continue
        lease = _q(queue_dir, "leases", name[:-len(".task")] + ".lease")
        try:
            os.rename(os.path.join(todo, name), lease)
        except FileNotFoundError:
            continue  # another claimer won this one: try the next
        # a rename keeps the task file's mtime: stamp the claim time, so
        # the coordinator never sees a fresh lease as stale
        os.utime(lease)
        chunk, attempt, dup = _parse_task_name(name)
        owner = {"worker": worker_id, "pid": os.getpid(),
                 "claimed_at": time.time()}
        with open(lease + ".owner.json", "w") as f:
            json.dump(owner, f)
        return {"chunk": chunk, "attempt": attempt, "dup": dup,
                "lease": lease}
    return None


def _lease_owner(lease: str) -> dict:
    try:
        with open(lease + ".owner.json") as f:
            return json.load(f)
    except (OSError, ValueError):
        return {}


def _remove_lease(lease: str) -> None:
    for p in (lease, lease + ".owner.json"):
        try:
            os.remove(p)
        except FileNotFoundError:
            pass


class _Heartbeat:
    """Daemon thread renewing a lease's mtime every ``interval`` seconds.

    ``pause()`` stops the renewals but not the thread: the chaos ``hang``
    action uses it for a worker that is alive but makes no progress, which
    the coordinator's lease expiry must catch."""

    def __init__(self, lease: str, interval: float):
        self._lease = lease
        self._interval = interval
        self._stop = threading.Event()
        self._paused = threading.Event()
        self._thread = threading.Thread(target=self._loop, daemon=True)
        self._thread.start()

    def _loop(self):
        while True:
            if not self._paused.is_set():
                try:
                    os.utime(self._lease)  # the first beat lands at once
                except OSError:
                    return  # lease gone (expired, or the task finished)
            if self._stop.wait(self._interval):
                return

    def pause(self):
        self._paused.set()

    def stop(self):
        self._stop.set()
        self._thread.join(timeout=2.0)


# --------------------------------------------------------------------------
# results and failure records


def _result_paths(results_dir: str, chunk: int) -> tuple[str, str]:
    base = os.path.join(results_dir, f"step_{chunk:08d}")
    return base + ".npz", base + ".json"


def _write_result(results_dir: str, chunk: int, tree: dict, fp: str,
                  attempt: int, worker_id: str) -> None:
    """Publish a chunk result in the sweep-checkpoint schema (atomic)."""
    save_checkpoint(
        results_dir, chunk, dict(tree, fingerprint=sweep._fp_array(fp)),
        meta={"chunk": chunk, "attempt": attempt, "worker": worker_id,
              "fingerprint": fp, "schema": "sweep-chunk-v1"},
        integrity=True, atomic=True)


def _validate_result(results_dir: str, chunk: int, fp: str,
                     expected: dict) -> tuple[dict | None, str | None]:
    """Load and validate a published chunk result: ``(tree, None)``, or
    ``(None, reason)`` when the file is torn, corrupt, foreign or
    shape-drifted (the coordinator then charges an attempt and deletes
    the files)."""
    npz, _ = _result_paths(results_dir, chunk)
    try:
        like = {k: 0 for k in np.load(npz).files}
        tree, step = restore_checkpoint(npz, like, verify=True)
    except Exception as e:
        return None, f"unreadable or corrupt ({e})"
    saved_fp = tree.pop("fingerprint", None)
    if saved_fp is None or not np.array_equal(saved_fp,
                                              sweep._fp_array(fp)):
        return None, "fingerprint mismatch (different sweep)"
    if step != chunk:
        return None, f"chunk index mismatch (file says {step})"
    reason = sweep._tree_mismatch(tree, expected)
    if reason is not None:
        return None, reason
    return tree, None


def _write_failure(queue_dir: str, chunk: int, attempt: int, dup: int,
                   worker_id: str, exc: BaseException) -> None:
    name = _task_name(chunk, attempt, dup) + ".json"
    final = _q(queue_dir, "failures", name)
    tmp = final + f".tmp-{os.getpid()}"
    with open(tmp, "w") as f:
        json.dump({
            "chunk": chunk, "attempt": attempt, "dup": dup,
            "worker": worker_id, "time": time.time(),
            "error": repr(exc),
            "traceback": traceback.format_exc(),
        }, f, indent=1)
    os.replace(tmp, final)


# --------------------------------------------------------------------------
# worker process


def _load_spec(queue_dir: str) -> dict:
    with open(_q(queue_dir, "spec.pkl"), "rb") as f:
        return pickle.load(f)


def _setup_from_spec(spec: dict):
    """The spec's ``_SweepSetup``, on the spec's device."""
    return sweep._prepare(
        list(spec["ps"]), spec["cfg"], spec["seeds"], spec["reduce"],
        spec["warmup_frac"], spec["chunk_size"], spec["quantiles"],
        spec["tau_grid"], spec["n_devices"], torch.device(spec["device"]),
        spec["positions"])


def _worker_setup(spec: dict):
    """The worker's setup on the spec's device, refusing to run anywhere
    else: a ``cuda`` spec without a CUDA device, or a setup whose
    fingerprint is not the coordinator's, raises :class:`DispatchError`."""
    if (torch.device(spec["device"]).type == "cuda"
            and not torch.cuda.is_available()):
        raise DispatchError(
            f"the sweep runs on {spec['device']!r} but this worker sees no "
            "CUDA device; start workers where the card is (nothing falls "
            "back to the CPU)")
    setup = _setup_from_spec(spec)
    fp = sweep._setup_fingerprint(setup, spec["seeds"])
    if fp != spec["fingerprint"]:
        raise DispatchError(
            "the worker's sweep setup differs from the coordinator's "
            f"(fingerprint {fp[:12]} against {spec['fingerprint'][:12]})")
    return setup


def worker_main(queue_dir: str, worker_id: str) -> int:
    """Claim-compute-publish loop of one worker process.

    Runs under ``python -m repro_torch.sim.dispatch <queue_dir>`` in a
    process of its own (the coordinator spawns these); everything it needs
    travels through the queue directory, so a worker could equally start
    on another host that mounts it. The chunk program is built on the
    first claimed task.
    """
    spec = _load_spec(queue_dir)
    policy: RetryPolicy = spec["policy"]
    fp: str = spec["fingerprint"]
    results_dir: str = spec.get("results_dir") or _q(queue_dir, "results")
    setup = _worker_setup(spec)
    chaos: list[dict] = spec.get("chaos") or []
    worker_fn = None

    while True:
        if os.path.exists(_q(queue_dir, "DONE")):
            return 0
        task = claim_task(queue_dir, worker_id)
        if task is None:
            time.sleep(policy.poll_s)
            continue
        chunk, attempt, dup = task["chunk"], task["attempt"], task["dup"]
        hb = _Heartbeat(task["lease"], policy.heartbeat_s)
        directive = _chaos_match(chaos, chunk, attempt) if dup == 0 else None
        try:
            if directive is not None:
                act, secs = directive["action"], directive["seconds"]
                if act == "kill":
                    os.kill(os.getpid(), signal.SIGKILL)
                elif act == "freeze":
                    # a stopped process does not heartbeat: the thread is
                    # frozen with the rest of it
                    os.kill(os.getpid(), signal.SIGSTOP)
                elif act == "hang":
                    hb.pause()
                    time.sleep(secs)
                elif act == "slow":
                    time.sleep(secs)
                elif act == "raise":
                    raise RuntimeError(
                        f"chaos: injected failure on chunk {chunk} "
                        f"attempt {attempt}")
            if worker_fn is None:
                worker_fn = setup.worker()
            hc = sweep._host_copy(
                worker_fn(setup.keys, setup.chunk_params(chunk)))()
            if directive is not None and directive["action"] == "corrupt":
                # a torn write at the publish point: the npz name appears
                # with garbage bytes instead of a result
                npz, mpath = _result_paths(results_dir, chunk)
                with open(npz, "wb") as f:
                    f.write(b"\x00garbage-not-an-npz\xff" * 64)
                with open(mpath, "w") as f:
                    f.write("{not json")
            else:
                _write_result(results_dir, chunk, hc, fp, attempt,
                              worker_id)
            _remove_lease(task["lease"])
        except Exception as e:  # noqa: BLE001 — every error becomes a record
            _write_failure(queue_dir, chunk, attempt, dup, worker_id, e)
            _remove_lease(task["lease"])
        finally:
            hb.stop()


# --------------------------------------------------------------------------
# coordinator


class _WorkerPool:
    """Local worker processes and their respawn accounting.

    The coordinator only reads the queue, whoever runs the workers; when
    it spawned them itself it can also reap exit codes, SIGKILL the owners
    of expired leases and respawn replacements."""

    def __init__(self, queue_dir: str, n_workers: int, policy: RetryPolicy,
                 env: dict):
        self.queue_dir = queue_dir
        self.policy = policy
        self.env = env
        self.procs: dict[str, subprocess.Popen] = {}
        self.respawns = 0
        self._next = 0
        for _ in range(n_workers):
            self.spawn()

    def spawn(self) -> str:
        wid = f"w{self._next}"
        self._next += 1
        # -W: ``repro_torch.sim`` imports this module before ``-m`` runs
        # it, which runpy warns about on every start
        self.procs[wid] = subprocess.Popen(
            [sys.executable, "-W", "ignore::RuntimeWarning:runpy", "-m",
             "repro_torch.sim.dispatch", self.queue_dir, "--worker-id", wid],
            env=self.env, stdout=subprocess.DEVNULL, stderr=subprocess.PIPE)
        return wid

    def reap_and_respawn(self) -> list[str]:
        """Collect exited workers and spawn replacements within the
        budget; returns the ids of the workers found dead this call."""
        dead = [wid for wid, p in self.procs.items() if p.poll() is not None]
        for wid in dead:
            p = self.procs.pop(wid)
            if p.returncode != 0:
                err = (p.stderr.read() or b"").decode(errors="replace")
                if err.strip():
                    warnings.warn(
                        f"dispatch worker {wid} died "
                        f"(exit {p.returncode}): ...{err.strip()[-500:]}")
            p.stderr.close()
            if (not os.path.exists(_q(self.queue_dir, "DONE"))
                    and self.respawns < self.policy.max_respawns):
                self.respawns += 1
                self.spawn()
        return dead

    def kill_owner(self, owner: dict) -> None:
        """SIGKILL the local process owning an expired lease, so a hung
        worker can neither publish late nor hold the device."""
        wid, pid = owner.get("worker"), owner.get("pid")
        p = self.procs.get(wid)
        if p is not None and p.pid == pid and p.poll() is None:
            p.kill()

    def alive(self) -> int:
        return sum(1 for p in self.procs.values() if p.poll() is None)

    def shutdown(self):
        # workers exit on DONE; whatever still runs (hung, frozen) is
        # killed: SIGKILL ends a SIGSTOPped process too
        deadline = time.time() + 2.0
        while time.time() < deadline and self.alive():
            time.sleep(0.02)
        for p in self.procs.values():
            if p.poll() is None:
                p.kill()
        for p in self.procs.values():
            try:
                p.wait(timeout=5.0)
            except subprocess.TimeoutExpired:  # pragma: no cover
                pass
            if p.stderr is not None:
                p.stderr.close()


def _spawn_env() -> dict:
    """Worker environment: the coordinator's, with ``repro_torch``
    importable by absolute path (the parent may run with a relative
    ``PYTHONPATH``)."""
    env = dict(os.environ)
    pkg_dir = (os.path.dirname(repro_torch.__file__) if repro_torch.__file__
               else next(iter(repro_torch.__path__)))
    pkg_root = os.path.dirname(os.path.abspath(pkg_dir))
    parts = [pkg_root] + [p for p in env.get("PYTHONPATH", "").split(":")
                          if p]
    env["PYTHONPATH"] = ":".join(dict.fromkeys(parts))
    return env


def _build_kernels(cfg) -> None:
    """Build the CUDA libraries the sweep's chunks launch, one nvcc per
    source, all at once, before any worker starts: N workers started on a
    fresh checkout would each run nvcc on the same sources. An existing
    build is reused."""
    builds = [kc.build_library]
    if cells.contact_backend(cfg) == "cells":
        builds.append(kc.build_cell_library)
    if cfg.learn is not None:
        builds.append(gm.build_library)
    with concurrent.futures.ThreadPoolExecutor(len(builds)) as pool:
        list(pool.map(lambda build: build(), builds))


def run_dispatched(
    ps,
    cfg,
    seeds=(0,),
    *,
    reduce: str = "trace",
    warmup_frac: float | None = None,
    chunk_size: int | None = None,
    quantiles=(0.1, 0.5, 0.9),
    tau_grid=None,
    n_devices: int | None = None,
    checkpoint_dir: str | None = None,
    resume: bool = False,
    retry_policy: RetryPolicy | None = None,
    workers: int = 2,
    queue_dir: str | None = None,
    chaos: list[dict] | None = None,
    xla_cache_dir: str | None = None,
    device=None,
    positions=None,
):
    """Run a sweep through the lease-based multi-process dispatcher.

    Same contract and return types as :func:`repro_torch.sim.sweep.run`
    (which forwards here for ``workers=``), plus:

    Args:
      workers:    worker processes to spawn (the pool respawns dead ones
                  up to ``retry_policy.max_respawns``).
      queue_dir:  work-queue directory (layout in the module docstring).
                  Default ``{checkpoint_dir}/.queue`` when a
                  ``checkpoint_dir`` is given (the results then land in
                  ``checkpoint_dir`` itself, so ``sweep.run(checkpoint_dir=
                  ..., resume=True)`` can finish or reuse a dispatched
                  study and the reverse), else a fresh temporary
                  directory, removed at the end.
      resume:     reuse the valid chunk results of this same sweep already
                  in the results directory (their tasks are skipped).
      chaos:      fault-injection schedule (:func:`chaos_directive`) sent
                  to the workers; directives match non-duplicate tasks by
                  (chunk, attempt).
      xla_cache_dir: created (default ``{queue_dir}/xla_cache``) so the
                  queue's layout is ``repro``'s, and otherwise unused: the
                  port has no XLA. The workers share the checkout's kernel
                  build directory instead; on a card the coordinator
                  builds the libraries once before spawning them.
      device:     where the workers run the chunks: ``cuda`` by default
                  (raises here without one), ``"cpu"`` for the plain
                  versions. The coordinator itself runs no chunk.
      positions:  ``(n_seeds, n_slots + 1, N, 2)`` frames per seed for
                  ``mobility="replay"``, sent to the workers as numpy.

    Returns:
      ``BatchSimOutputs`` / :class:`~repro_torch.sim.sweep.SweepSummary`
      with ``coverage`` marking the scenario rows whose chunks completed,
      ``quarantined`` the poison chunks, and ``telemetry`` the per-chunk
      attempt, latency and requeue records plus the pool's counters.
    """
    policy = retry_policy if retry_policy is not None else RetryPolicy(
        max_attempts=3)
    if workers < 1:
        raise ValueError("workers must be >= 1")
    device = resolve_device(device, "run_dispatched")
    if isinstance(ps, sweep.FGParams):
        ps = [ps]
    if positions is not None:
        positions = np.asarray(
            positions.cpu() if torch.is_tensor(positions) else positions,
            np.float32)
    # the coordinator runs no chunk: its setup, for the plan, fingerprint
    # and shapes, is the CPU's, and every worker checks its own against it
    setup = sweep._prepare(ps, cfg, seeds, reduce, warmup_frac, chunk_size,
                           quantiles, tau_grid, n_devices,
                           torch.device("cpu"), positions)
    plan = setup.plan
    fp = sweep._setup_fingerprint(setup, seeds)
    expected = setup.expected_shapes()
    if device.type == "cuda" and torch.cuda.is_available():
        _build_kernels(cfg)

    own_queue = queue_dir is None and checkpoint_dir is None
    if queue_dir is None:
        # the queue's bookkeeping under .queue/ keeps the checkpoint
        # directory itself in the in-process layout (step_*.npz at its root)
        queue_dir = (os.path.join(checkpoint_dir, ".queue")
                     if checkpoint_dir is not None
                     else tempfile.mkdtemp(prefix="fg-dispatch-"))
    results_dir = (checkpoint_dir if checkpoint_dir is not None
                   else _q(queue_dir, "results"))
    _init_queue(queue_dir)
    os.makedirs(results_dir, exist_ok=True)
    if xla_cache_dir is None:
        xla_cache_dir = _q(queue_dir, "xla_cache")
    os.makedirs(xla_cache_dir, exist_ok=True)
    done_marker = _q(queue_dir, "DONE")
    if os.path.exists(done_marker):
        os.remove(done_marker)

    # ---- publish the sweep spec -----------------------------------------
    spec = dict(
        ps=tuple(ps), cfg=cfg, seeds=tuple(int(s) for s in seeds),
        reduce=reduce, warmup_frac=warmup_frac, chunk_size=chunk_size,
        quantiles=tuple(quantiles), tau_grid=tau_grid, n_devices=n_devices,
        device=str(device), positions=positions, fingerprint=fp,
        policy=policy, chaos=list(chaos or ()), xla_cache_dir=xla_cache_dir,
        results_dir=results_dir,
    )
    spec_tmp = _q(queue_dir, f"spec.pkl.tmp-{os.getpid()}")
    with open(spec_tmp, "wb") as f:
        pickle.dump(spec, f)
    os.replace(spec_tmp, _q(queue_dir, "spec.pkl"))

    # ---- resume: accept valid results already published -----------------
    results: dict[int, dict] = {}
    telemetry: dict = {
        "chunks": {c: {"attempts": 0, "requeues": 0, "duplicates": 0}
                   for c in range(plan.n_chunks)},
        "expired_leases": 0, "corrupt_results": 0, "worker_failures": 0,
        "respawns": 0, "quarantine": {},
    }
    if resume:
        for c, tree in sweep._load_chunks(
                results_dir, fp, plan.n_chunks, expected=expected).items():
            results[c] = tree
            telemetry["chunks"][c]["resumed"] = True
    # drop a previous (killed) coordinator's queue state: tasks, leases and
    # failure records are one run's bookkeeping, results are not
    for d in ("todo", "leases", "failures"):
        for name in os.listdir(_q(queue_dir, d)):
            try:
                os.remove(_q(queue_dir, d, name))
            except FileNotFoundError:  # pragma: no cover
                pass

    attempts = {c: 0 for c in range(plan.n_chunks)}     # failures so far
    backoff_until: dict[int, float] = {}                # chunk -> mono time
    claim_t: dict[tuple[int, int, int], float] = {}     # task -> mono time
    first_enq: dict[int, float] = {}
    latencies: list[float] = []
    quarantined: dict[int, dict] = {}
    seen_failures: set[str] = set()

    now = time.monotonic
    for c in range(plan.n_chunks):
        if c not in results:
            enqueue_task(queue_dir, c, 0)
            first_enq[c] = now()

    pool = _WorkerPool(queue_dir, workers, policy, _spawn_env())
    last_progress = now()

    def outstanding():
        return [c for c in range(plan.n_chunks)
                if c not in results and c not in quarantined]

    def fail_attempt(c: int, reason: str):
        """Charge the chunk an attempt; back off and re-enqueue, or
        quarantine it."""
        nonlocal last_progress
        attempts[c] += 1
        last_progress = now()
        if attempts[c] >= policy.max_attempts:
            record = {"chunk": c, "attempts": attempts[c], "reason": reason,
                      "time": time.time()}
            for name in sorted(os.listdir(_q(queue_dir, "failures")),
                               reverse=True):
                if name.startswith(f"chunk_{c:05d}."):
                    try:
                        with open(_q(queue_dir, "failures", name)) as f:
                            record["last_failure"] = json.load(f)
                    except (OSError, ValueError):  # pragma: no cover
                        pass
                    break
            qpath = _q(queue_dir, "quarantine", f"chunk_{c:05d}.json")
            with open(qpath + ".tmp", "w") as f:
                json.dump(record, f, indent=1)
            os.replace(qpath + ".tmp", qpath)
            quarantined[c] = record
            telemetry["quarantine"][c] = record
            warnings.warn(
                f"dispatch chunk {c} quarantined after {attempts[c]} "
                f"attempts: {reason}")
        else:
            backoff_until[c] = now() + policy.backoff(attempts[c],
                                                      key=f"{fp}:{c}")
            telemetry["chunks"][c]["requeues"] += 1

    try:
        while outstanding():
            progressed = False

            # 1. collect and validate published results
            for c in outstanding():
                npz, _ = _result_paths(results_dir, c)
                if not os.path.exists(npz):
                    continue
                tree, reason = _validate_result(results_dir, c, fp, expected)
                if tree is not None:
                    results[c] = tree
                    tc = telemetry["chunks"][c]
                    tc["attempts"] = attempts[c] + 1
                    lat = now() - first_enq.get(c, now())
                    tc["latency_s"] = round(lat, 4)
                    latencies.append(lat)
                    backoff_until.pop(c, None)
                    progressed = True
                    continue
                telemetry["corrupt_results"] += 1
                for p in _result_paths(results_dir, c):
                    try:
                        os.remove(p)
                    except FileNotFoundError:
                        pass
                warnings.warn(
                    f"dispatch chunk {c} published an invalid result "
                    f"({reason}); discarding and re-dispatching")
                fail_attempt(c, f"invalid result: {reason}")
                progressed = True

            # 2. worker-side failure records
            for name in sorted(os.listdir(_q(queue_dir, "failures"))):
                if name in seen_failures or not name.endswith(".json"):
                    continue
                seen_failures.add(name)
                c, attempt, dup = _parse_task_name(name)
                if c in results or c in quarantined:
                    continue
                try:
                    with open(_q(queue_dir, "failures", name)) as f:
                        rec = json.load(f)
                except (OSError, ValueError):
                    rec = {"error": "unreadable failure record"}
                telemetry["worker_failures"] += 1
                warnings.warn(
                    f"dispatch chunk {c} attempt {attempt} failed in "
                    f"worker {rec.get('worker')}: {rec.get('error')}")
                claim_t.pop((c, attempt, dup), None)
                if dup == 0:
                    fail_attempt(c, rec.get("error", "worker failure"))
                progressed = True

            # 3. lease expiry (dead or stalled workers)
            dead_now = set(pool.reap_and_respawn())
            telemetry["respawns"] = pool.respawns
            for name in sorted(os.listdir(_q(queue_dir, "leases"))):
                if not name.endswith(".lease"):
                    continue
                lease = _q(queue_dir, "leases", name)
                c, attempt, dup = _parse_task_name(name)
                key = (c, attempt, dup)
                claim_t.setdefault(key, now())
                if c in results or c in quarantined:
                    _remove_lease(lease)
                    claim_t.pop(key, None)
                    continue
                owner = _lease_owner(lease)
                try:
                    age = time.time() - os.stat(lease).st_mtime
                except FileNotFoundError:
                    continue  # completed or failed since the listing
                # the lease must also have been *seen* past the TTL on our
                # own clock: a fresh lease whose first beat has not landed
                # is never expired on its inherited mtime
                expired = (age > policy.lease_ttl_s
                           and now() - claim_t[key] > policy.lease_ttl_s)
                if owner.get("worker") in dead_now:
                    expired = True  # the owner's exit was seen: expire now
                if not expired:
                    continue
                telemetry["expired_leases"] += 1
                warnings.warn(
                    f"dispatch lease for chunk {c} (attempt {attempt}"
                    f"{', duplicate' if dup else ''}) expired — worker "
                    f"{owner.get('worker', '?')} dead or stalled; "
                    "re-dispatching")
                pool.kill_owner(owner)
                _remove_lease(lease)
                claim_t.pop(key, None)
                if dup == 0:
                    fail_attempt(c, "lease expired (worker dead/stalled)")
                progressed = True

            # 4. stragglers: a duplicate task for a long-running lease
            if len(latencies) >= policy.straggler_min_done:
                q = float(np.quantile(np.asarray(latencies),
                                      policy.straggler_quantile))
                deadline = max(policy.straggler_factor * q,
                               4 * policy.heartbeat_s)
                for key, t0 in list(claim_t.items()):
                    c, attempt, dup = key
                    if (c in results or c in quarantined or dup > 0
                            or now() - t0 <= deadline):
                        continue
                    tc = telemetry["chunks"][c]
                    if tc["duplicates"] >= policy.max_duplicates:
                        continue
                    tc["duplicates"] += 1
                    enqueue_task(queue_dir, c, attempt,
                                 dup=tc["duplicates"])
                    warnings.warn(
                        f"dispatch chunk {c} is a straggler "
                        f"({now() - t0:.2f}s > {deadline:.2f}s); "
                        "re-dispatching a duplicate (first result wins)")

            # 5. release the chunks whose backoff has run out
            for c, t_ok in list(backoff_until.items()):
                if c in results or c in quarantined:
                    backoff_until.pop(c)
                elif now() >= t_ok:
                    backoff_until.pop(c)
                    enqueue_task(queue_dir, c, attempts[c])
                    first_enq.setdefault(c, now())

            if progressed:
                last_progress = now()
            elif (pool.alive() == 0
                  and pool.respawns >= policy.max_respawns):
                raise DispatchError(
                    f"no live workers and respawn budget exhausted with "
                    f"{len(outstanding())} chunk(s) outstanding")
            elif now() - last_progress > policy.stall_timeout_s:
                raise DispatchError(
                    f"dispatch stalled: no progress in "
                    f"{policy.stall_timeout_s}s with "
                    f"{len(outstanding())} chunk(s) outstanding")
            time.sleep(policy.poll_s)
    finally:
        with open(done_marker + ".tmp", "w") as f:
            f.write("done")
        os.replace(done_marker + ".tmp", done_marker)
        pool.shutdown()

    host_chunks = [results.get(c, sweep._fill_chunk(expected))
                   for c in range(plan.n_chunks)]
    out = sweep._finalize(
        setup, host_chunks, devices_used=plan.n_devices,
        failed=sorted(quarantined), quarantined=sorted(quarantined),
        telemetry=telemetry)
    if own_queue:
        shutil.rmtree(queue_dir, ignore_errors=True)
    return out


# --------------------------------------------------------------------------
# CLI: the worker entry point


def _main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.sim.dispatch",
        description="Sweep-dispatch worker: claims chunk tasks from a "
                    "file-system work queue (see repro_torch.sim.dispatch).")
    ap.add_argument("queue_dir")
    ap.add_argument("--worker-id", default=f"w-pid{os.getpid()}")
    args = ap.parse_args(argv)
    return worker_main(args.queue_dir, args.worker_id)


if __name__ == "__main__":
    sys.exit(_main())
