"""Smoke test of the PyTorch/CUDA port on one NVIDIA H100.

    python3 chip_smoke.py

Phases (any failure ends the run with a non-zero exit code):

1. device — the card's name and power limit; it must be sm_90;
2. build — the CUDA kernels from ``src/repro_torch/csrc``, one nvcc per
   source, all started together;
3. kernel — ``pairwise_contacts`` vs its plain version on the card, bit for
   bit on every output, over N x prev-density cases, multi-bit zone words
   and a dense node cluster;
4. merge-kernel — ``gossip_merge_rows`` and ``gossip_merge_rows_scaled``
   (in both operand orders: ``fold`` off and on) vs their plain versions,
   bit for bit, over N x D, all/no/mixed rows
   selected, w in {0, 1, random}, scale 1 and below 1, NaN and inf in
   unselected peer rows;
5. replay — the port runs the paper geometry on the CPU (1000 slots), then
   on the card replaying the same positions: every trace equal bit for bit,
   and one contact-kernel launch per slot;
6. learn-replay — the same with Gossip Learning at the learning point
   (Λ = 10, T_T = 5 s; logreg for 1000 slots, the MLP for 320): every
   protocol trace equal bit for bit, CPU vs card and learning vs
   ``learn=None``; the learning traces within tolerance;
7. free runs on the card — the paper point (N = 200, 8000 slots) and the
   dense N = 800 point (4000 slots), with wall time, slots/s, launches and
   sanity checks; then the contact kernel is held against its plain
   version bit for bit on that point's own inputs (B = 1) and both are
   timed, beside the kernel's bound;
8. learn-run — the learning point at full size (N = 200, 8000 slots,
   logreg) free on the card: accuracy must rise, holders must be no worse
   than the population; the merge kernel is held against its plain
   version on the run's own merge inputs and timed; then a defended run
   (norm clip) does the same for ``gossip_merge_rows_scaled``.

The line before the last is the per-kernel JSON record; the last line is
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import concurrent.futures
import dataclasses
import json
import math
import os
import subprocess
import sys
import time

import numpy as np
import torch

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "src"))

from repro_torch import random as jr  # noqa: E402
from repro_torch.configs.fg_paper import DENSITY, paper_params  # noqa: E402
from repro_torch.configs.fg_learn import logreg_task, mlp_task  # noqa: E402
from repro_torch.core.merge import DefenseConfig  # noqa: E402
from repro_torch.kernels import contacts as kc  # noqa: E402
from repro_torch.kernels import gossip_merge as gm  # noqa: E402
from repro_torch.sim import learn as learning  # noqa: E402
from repro_torch.sim.compute import pack_mask  # noqa: E402
from repro_torch.sim.engine import (SimConfig, _zone_member,  # noqa: E402
                                    effective_zones, mobility_track,
                                    simulate)
from repro_torch.sim.mobility import get_mobility  # noqa: E402

#: Published H100 SXM peaks (NVIDIA data sheet, 700 W): HBM3 bytes/s and
#: float32 FLOP/s outside the tensor cores.
HBM_BYTES_S = 3.35e12
F32_FLOPS_S = 67e12
TRACES = ("availability", "busy_frac", "stored_info", "obs_birth",
          "obs_holders", "model_holders", "n_in_rz", "availability_z",
          "stored_info_z", "n_in_rz_z", "t")
#: The learning point: fig_learning.py's full-size point.
LEARN_PARAMS = dict(lam=0.05, Lam=10.0, M=1, T_T=5.0)
#: Card vs CPU tolerances of the learning traces (gradients and accuracy
#: logits sum in another order on the card; every draw is bit for bit).
LEARN_TOL = dict(test_acc=(0.0, 2e-3), test_acc_holders=(0.0, 2e-3),
                 learn_obs=(1e-5, 0.0), theta_var=(1e-3, 1e-7))
KERNELS = (kc.pairwise_contacts, gm.gossip_merge_rows,
           gm.gossip_merge_rows_scaled)


_START = time.perf_counter()


def phase(name: str, msg: str) -> None:
    print(f"[{name} +{time.perf_counter() - _START:.0f}s] {msg}", flush=True)


def kernel_bound_ms(b: int, n: int) -> tuple[float, str]:
    """Least time for one sweep: every input read once (x, y, zone word,
    elig, prevw), every output written once (closew, best_j, has), and 5
    float32 operations per pair (2 subtractions, a multiply, an FMA)."""
    nw = (n + 31) // 32
    nbytes = b * n * (4 + 4 + 4 + 1) + 2 * b * n * nw * 4 + b * n * (4 + 1)
    flops = 5 * b * n * n
    t_bytes, t_ops = nbytes / HBM_BYTES_S, flops / F32_FLOPS_S
    return 1e3 * max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def _events_ms(run, count: int) -> float:
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    run()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / count


def call_ms(fn, reps: int = 200) -> float:
    """Time per eager call, CUDA events around ``reps`` calls: what the
    simulator's loop pays, host-side launch overhead included."""
    for _ in range(20):
        fn()

    def run():
        for _ in range(reps):
            fn()

    return _events_ms(run, reps)


def device_ms(fn, per_graph: int = 50, replays: int = 20) -> float:
    """Device time per call: ``per_graph`` calls captured in one CUDA graph
    and replayed, so no host work sits between the launches."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(per_graph):
            fn()
    graph.replay()

    def run():
        for _ in range(replays):
            graph.replay()

    ms = _events_ms(run, replays * per_graph)
    del graph
    return ms


def random_case(rng, b: int, n: int, density: float, side: float,
                zone_bits: int):
    """Kernel inputs on the card: positions in a ``side`` square, zone
    words with up to ``zone_bits`` bits, symmetric previous contacts."""
    x = torch.tensor(rng.uniform(0, side, (b, n)), dtype=torch.float32)
    y = torch.tensor(rng.uniform(0, side, (b, n)), dtype=torch.float32)
    zw = torch.tensor(rng.integers(0, 1 << zone_bits, (b, n)),
                      dtype=torch.int32)
    elig = torch.tensor(rng.random((b, n)) < 0.7)
    prev = torch.rand((b, n, n), device="cuda",
                      generator=torch.Generator("cuda").manual_seed(n)) < density
    prevw = pack_mask(prev & prev.transpose(1, 2))
    return [t.cuda() for t in (x, y, zw, elig)] + [prevw]


def max_abs_err(got, want) -> int:
    return max(int((g.to(torch.int64) - w.to(torch.int64)).abs().max())
               for g, w in zip(got, want))


def check_kernel_cases() -> int:
    rng = np.random.default_rng(0)
    r_tx2 = 25.0
    worst = 0
    cases = [(n, d, 60.0, 1) for n in (20, 33, 65, 130, 200, 800, 3200)
             for d in (0.0, 0.3, 1.0)]
    cases += [(200, 0.2, 60.0, 5), (130, 0.0, 4.0, 1), (130, 0.0, 4.0, 3)]
    for n, density, side, bits in cases:
        args = random_case(rng, 2, n, density, side, bits)
        got = kc.pairwise_contacts(*args, r_tx2)
        want = kc.pairwise_contacts_ref(*args, r_tx2)
        torch.cuda.synchronize()
        for g, w, name in zip(got, want, ("closew", "best_j", "has")):
            if not torch.equal(g, w):
                raise AssertionError(
                    f"kernel != plain on {name} at N={n} density={density} "
                    f"side={side} zone_bits={bits}")
        worst = max(worst, max_abs_err(got, want))
    phase("kernel", f"{len(cases)} cases bit for bit (N up to 3200, B=2, "
                    f"multi-bit zone words, clustered nodes); max_abs_err={worst}")
    return worst


def main_path_inputs(cfg: SimConfig, seed: int):
    """The kernel's inputs as the main path gives them: positions after
    one rdm step at ``cfg``, the zone words, in-zone eligibility, and the
    previous slot's packed contacts."""
    model = get_mobility("rdm")
    key = jr.PRNGKey(seed, device="cuda")[None]
    mob, key = model.init(key, cfg)
    zs = effective_zones(cfg)
    r_tx2 = float(np.float32(cfg.r_tx ** 2))

    def sweep_args(pos):
        zw = pack_mask(_zone_member(pos, zs))[..., 0]
        return (pos[..., 0].contiguous(), pos[..., 1].contiguous(), zw,
                zw != 0)

    x0, y0, zw0, el0 = sweep_args(mob.pos)
    n = cfg.n_nodes
    empty = torch.zeros((1, n, (n + 31) // 32), dtype=torch.int32,
                        device="cuda")
    prevw = kc.pairwise_contacts_ref(x0, y0, zw0, el0, empty, r_tx2)[0]
    k1, k2, _ = jr.split(key, 3).unbind(-2)
    mob = model.step(k1, k2, mob, cfg)
    return (*sweep_args(mob.pos), prevw), r_tx2


def time_kernel(cfg: SimConfig, seed: int) -> dict:
    """Holds the kernel against its plain version, bit for bit, on the
    main path's own inputs at ``cfg``, then times both."""
    args, r_tx2 = main_path_inputs(cfg, seed)

    def kernel():
        return kc.pairwise_contacts(*args, r_tx2)

    def plain():
        return kc.pairwise_contacts_ref(*args, r_tx2)

    got, want = kernel(), plain()
    torch.cuda.synchronize()
    for g, w, name in zip(got, want, ("closew", "best_j", "has")):
        if not torch.equal(g, w):
            raise AssertionError(
                f"kernel != plain on {name} at the main path's inputs, "
                f"N={cfg.n_nodes}")
    bound_ms, bound_by = kernel_bound_ms(1, cfg.n_nodes)
    return dict(max_abs_err=max_abs_err(got, want),
                ms=device_ms(kernel), plain_ms=device_ms(plain),
                call_ms=call_ms(kernel), plain_call_ms=call_ms(plain),
                bound_ms=bound_ms, bound_by=bound_by)


def same_traces(a, b, what: str = "replayed GPU run != CPU run",
                traces=TRACES) -> None:
    for f in traces:
        x, y = getattr(a, f), getattr(b, f)
        if x.shape != y.shape or x.dtype != y.dtype or not np.array_equal(x, y):
            raise AssertionError(f"{what} on {f}")


def check_replay(seed: int = 0, n_slots: int = 1000) -> None:
    p = paper_params(lam=0.05, M=1)
    cfg = SimConfig(n_slots=n_slots)
    t = time.perf_counter()
    cpu = simulate(p, cfg, seed=seed, device="cpu")
    track = mobility_track(cfg, seed=seed, device="cpu")
    t_cpu = time.perf_counter() - t
    reset_counts()
    t = time.perf_counter()
    gpu = simulate(p, dataclasses.replace(cfg, mobility="replay"), seed=seed,
                   device="cuda", positions=track)
    t_gpu = time.perf_counter() - t
    launches = kc.pairwise_contacts.launches
    same_traces(cpu, gpu)
    if launches != n_slots:
        raise AssertionError(f"{launches} kernel launches for {n_slots} slots")
    phase("replay", f"N=200 {n_slots} slots: every trace bit for bit; "
                    f"launches={launches}; cpu {t_cpu:.1f}s, gpu {t_gpu:.1f}s")


def free_run(label: str, p, cfg: SimConfig, seed: int = 0) -> dict:
    reset_counts()
    t = time.perf_counter()
    out = simulate(p, cfg, seed=seed)                 # default device: cuda
    wall = time.perf_counter() - t
    launches = kc.pairwise_contacts.launches
    if counts()["gossip_merge_rows"] or counts()["gossip_merge_rows_scaled"]:
        raise AssertionError(f"{label}: merge kernels ran without learning")
    s0 = int(len(out.t) * cfg.warmup_frac)
    n_rz = float(out.n_in_rz[s0:].mean())
    avail = float(out.availability[s0:].mean())
    for name, arr in (("availability", out.availability),
                      ("stored_info", out.stored_info)):
        if not np.all(np.isfinite(arr)):
            raise AssertionError(f"{label}: non-finite {name}")
    if out.availability.shape != (cfg.n_slots // cfg.sample_every, p.M):
        raise AssertionError(f"{label}: availability {out.availability.shape}")
    if launches != cfg.n_slots:
        raise AssertionError(f"{label}: {launches} launches, {cfg.n_slots} slots")
    if abs(n_rz - p.N) / p.N >= 0.05:
        raise AssertionError(f"{label}: mean n_in_rz {n_rz} vs N {p.N}")
    if not 0.0 < avail <= 1.0:
        raise AssertionError(f"{label}: mean availability {avail}")
    k = time_kernel(cfg, seed)
    phase("run", (
        f"{label}: N={cfg.n_nodes} slots={cfg.n_slots} wall={wall:.3f}s "
        f"slots/s={cfg.n_slots / wall:.1f} launches={launches} "
        f"kernel==plain on the path's inputs (max_abs_err={k['max_abs_err']}) "
        f"kernel_us={1e3 * k['ms']:.3f} bound_us={1e3 * k['bound_ms']:.5f} "
        f"({k['bound_by']}) plain_us={1e3 * k['plain_ms']:.3f} "
        f"kernel_call_us={1e3 * k['call_ms']:.3f} "
        f"plain_call_us={1e3 * k['plain_call_ms']:.3f} "
        f"mean availability={avail:.6f} busy={float(out.busy_frac[s0:].mean()):.6f} "
        f"stored_info={float(out.stored_info[s0:].mean()):.6f} "
        f"n_in_rz={n_rz:.3f} (N={p.N:.3f})"))
    profile_slots(label, p, cfg)
    return dict(launches=launches, **k)


def profile_slots(label: str, p, cfg: SimConfig, n_slots: int = 32) -> None:
    """Where a slot's time goes: ``torch.profiler`` (device activity only,
    a short run: its post-processing walks every event in Python) — the
    device's busy share of the wall time, CUDA kernels per slot, and the
    heaviest kernels. Reports "not measured" if the profiler sees no
    device time."""
    from torch.profiler import ProfilerActivity, profile

    short = dataclasses.replace(cfg, n_slots=n_slots,
                                sample_every=min(cfg.sample_every, n_slots))
    simulate(p, short)
    torch.cuda.synchronize()
    t_all = time.perf_counter()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        simulate(p, short)
        torch.cuda.synchronize()
        wall_us = 1e6 * (time.perf_counter() - t)
    dev = [e for e in prof.key_averages()
           if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_us = sum(e.self_device_time_total for e in dev)
    if busy_us <= 0:
        phase("profile", f"{label}: device time not measured")
        return
    top = sorted(dev, key=lambda e: -e.self_device_time_total)[:5]
    phase("profile", (
        f"{label}: {n_slots} slots in {time.perf_counter() - t_all:.1f}s "
        f"with the profiler, wall_per_slot_us={wall_us / n_slots:.1f} "
        f"device_busy_share={busy_us / wall_us:.4f} "
        f"kernels_per_slot={sum(e.count for e in dev) / n_slots:.1f} top: " +
        "; ".join(f"{e.key[:48]} {e.self_device_time_total / n_slots:.2f}us/slot "
                  f"x{e.count / n_slots:.1f}" for e in top)))


# ------------------------------------------------------------ merge kernels

def merge_bound_ms(n: int, d: int, k: int, scaled: bool) -> tuple[float, str]:
    """Least time for one merge of ``n`` rows of which ``k`` are selected:
    own read and out written on every row, s (1 byte) read on every row,
    peer, w (4 bytes) and, scaled, the scale (4) only on the selected rows;
    3 float32 operations per selected element (a multiply and an FMA), 4
    when scaled, and 1 - w once per selected row."""
    nbytes = 2 * n * d * 4 + k * d * 4 + n + k * (8 if scaled else 4)
    flops = (4 if scaled else 3) * k * d + k
    t_bytes, t_ops = nbytes / HBM_BYTES_S, flops / F32_FLOPS_S
    return 1e3 * max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def merge_case(gen, n: int, d: int, s_kind: str, w_kind: str):
    """Merge inputs on the card: ``own``, ``peer`` (NaN and inf in some
    unselected rows), ``w``, ``scale`` (1 on half the rows) and ``s``."""
    def rand(*shape):
        return torch.rand(shape, device="cuda", generator=gen)

    own = torch.randn((n, d), device="cuda", generator=gen)
    peer = 3 * torch.randn((n, d), device="cuda", generator=gen)
    s = {"all": torch.ones(n, dtype=torch.bool, device="cuda"),
         "none": torch.zeros(n, dtype=torch.bool, device="cuda"),
         "mixed": rand(n) < 0.6}[s_kind]
    w = {"zero": torch.zeros(n, device="cuda"),
         "one": torch.ones(n, device="cuda"), "random": rand(n)}[w_kind]
    scale = torch.where(rand(n) < 0.5, 1.0, 0.01 + 0.99 * rand(n))
    bad = ~s & (rand(n) < 0.5)
    peer[bad] = torch.where(rand(int(bad.sum()), 1) < 0.5, float("nan"),
                            float("inf")).expand(-1, d)
    return own, peer, w, scale, s


def merge_err(got, want) -> float:
    """Max abs difference of two merge outputs; raises unless they are
    equal bit for bit."""
    if not torch.equal(got.view(torch.int32), want.view(torch.int32)):
        raise AssertionError("kernel != plain")
    diff = torch.where(got == want, 0.0, (got - want).abs())
    return float(diff.max()) if got.numel() else 0.0


def check_merge_pair(args, label: str) -> float:
    """Both merge kernels (the scaled one in both orders) against their
    plain versions, bit for bit; returns the largest abs difference."""
    own, peer, w, scale, s = args
    worst = 0.0
    for name, kern, plain, kargs, kw in (
            ("gossip_merge_rows", gm.gossip_merge_rows,
             gm.gossip_merge_rows_ref, (own, peer, w, s), {}),
            ("gossip_merge_rows_scaled", gm.gossip_merge_rows_scaled,
             gm.gossip_merge_rows_scaled_ref, (own, peer, w, scale, s), {}),
            ("gossip_merge_rows_scaled fold", gm.gossip_merge_rows_scaled,
             gm.gossip_merge_rows_scaled_ref, (own, peer, w, scale, s),
             dict(fold=True))):
        got, want = kern(*kargs, **kw), plain(*kargs, **kw)
        torch.cuda.synchronize()
        try:
            worst = max(worst, merge_err(got, want))
        except AssertionError:
            raise AssertionError(f"{name} != plain at {label}") from None
        if not torch.equal(got[~s].view(torch.int32),
                           own[~s].view(torch.int32)):
            raise AssertionError(f"{name}: unselected rows changed at {label}")
    return worst


def check_merge_cases() -> float:
    gen = torch.Generator("cuda").manual_seed(13)
    count, worst = 0, 0.0
    for n in (1, 7, 200, 4097):
        for d in (1, 34, 306, 1000):
            for s_kind in ("all", "none", "mixed"):
                for w_kind in ("zero", "one", "random"):
                    args = merge_case(gen, n, d, s_kind, w_kind)
                    worst = max(worst, check_merge_pair(
                        args, f"N={n} D={d} s={s_kind} w={w_kind}"))
                    count += 1
    phase("merge-kernel", f"{count} cases x 2 kernels (the scaled one with "
                          f"and without fold) bit for bit (N up to 4097, D "
                          f"up to 1000, NaN/inf in unselected peer rows, "
                          f"scale 1 and < 1); max_abs_err={worst}")
    return worst


class MergeRecorder:
    """Wraps a merge wrapper on the learning layer's path and keeps the
    inputs of its last ``keep`` calls (the run's own merge inputs); the
    wrapped kernel still launches and counts."""

    def __init__(self, name: str, keep: int = 64):
        self.name, self.keep, self.calls = name, keep, []
        self.fn = getattr(learning, name)

    def __call__(self, *args, **kw):
        self.calls = (self.calls + [(args, kw)])[-self.keep:]
        return self.fn(*args, **kw)

    def __enter__(self):
        setattr(learning, self.name, self)
        return self

    def __exit__(self, *exc):
        setattr(learning, self.name, self.fn)


def time_merge(kern, plain, library, args, kw) -> dict:
    """Device times (CUDA graph) of the kernel, its plain version and the
    nearest library composition on one set of merge inputs."""
    return dict(ms=device_ms(lambda: kern(*args, **kw)),
                plain_ms=device_ms(lambda: plain(*args, **kw)),
                library_ms=device_ms(lambda: library(*args)),
                call_ms=call_ms(lambda: kern(*args, **kw)))


def lerp_rows(own, peer, w, s):
    """The nearest PyTorch composition: ``where(s, lerp(peer, own, w), own)``
    (two calls; no one library call merges rows under a mask)."""
    return torch.where(s[:, None], torch.lerp(peer, own, w[:, None]), own)


def lerp_rows_scaled(own, peer, w, scale, s):
    return torch.where(s[:, None],
                       torch.lerp(scale[:, None] * peer, own, w[:, None]), own)


def held_on_run_inputs(rec: MergeRecorder, kern, plain, library,
                       bound_fn) -> dict:
    """The kernel against its plain version on every recorded call of a
    run, bit for bit; then the kernel, its plain version and the library
    composition timed on the busiest call (B = 1 -> (N, ...)), beside the
    bound for that call's selected rows."""
    rows, worst = 0, 0.0
    for args, kw in rec.calls:
        got, want = kern(*args, **kw), plain(*args, **kw)
        torch.cuda.synchronize()
        try:
            worst = max(worst, merge_err(got, want))
        except AssertionError:
            raise AssertionError(
                f"{rec.name} != plain on the run's inputs") from None
        rows += int(args[-1].sum())
    if rows == 0:
        raise AssertionError(f"{rec.name}: the recorded calls merged no row")
    args, kw = max(rec.calls, key=lambda c: int(c[0][-1].sum()))
    flat = tuple(a[0].contiguous() for a in args)
    n, d = flat[0].shape
    k = int(flat[-1].sum())
    bound_ms, bound_by = bound_fn(n, d, k)
    return dict(calls=len(rec.calls), rows=rows, n=n, k=k, max_abs_err=worst,
                bound_ms=bound_ms, bound_by=bound_by,
                **time_merge(kern, plain, library, flat, kw))


def reset_counts() -> None:
    torch.cuda.synchronize()
    for k in KERNELS:
        k.launches = 0


def counts() -> dict:
    return {k.__name__: k.launches for k in KERNELS}


def close(a, b, rtol: float, atol: float) -> float:
    """Max abs difference; raises if ``a`` and ``b`` differ beyond
    ``atol + rtol * |b|`` or in shape."""
    if a.shape != b.shape or not np.all(np.isfinite(a)):
        raise AssertionError(f"shape {a.shape} vs {b.shape} or non-finite")
    if not np.all(np.abs(a - b) <= atol + rtol * np.abs(b)):
        raise AssertionError(f"beyond rtol={rtol} atol={atol}")
    return float(np.abs(a.astype(np.float64) - b).max())


def learn_replay(lc, n_slots: int, seed: int = 0) -> None:
    p = paper_params(**LEARN_PARAMS)
    cfg = SimConfig(n_slots=n_slots, learn=lc)
    task = learning.make_task(cfg.learn, "cpu")
    t = time.perf_counter()
    cpu = simulate(p, cfg, seed=seed, device="cpu", task=task)
    track = mobility_track(cfg, seed=seed, device="cpu")
    t_cpu = time.perf_counter() - t
    replay = dataclasses.replace(cfg, mobility="replay")
    reset_counts()
    t = time.perf_counter()
    gpu = simulate(p, replay, seed=seed, device="cuda", positions=track,
                   task=task)
    t_gpu = time.perf_counter() - t
    launches = counts()
    if launches != {"pairwise_contacts": n_slots, "gossip_merge_rows": n_slots,
                    "gossip_merge_rows_scaled": 0}:
        raise AssertionError(f"learn-replay launches {launches}")
    off = simulate(p, dataclasses.replace(replay, learn=None), seed=seed,
                   device="cuda", positions=track)
    same_traces(cpu, gpu, "learning run on the card != on the CPU",
                TRACES + ("merge_stats",))
    same_traces(gpu, off, "learning run != learn=None run")
    errs = {k: close(getattr(gpu, k), getattr(cpu, k), *LEARN_TOL[k])
            for k in LEARN_TOL}
    phase("learn-replay", (
        f"{lc.model} D={lc.param_dim} N=200 {n_slots} slots: protocol traces and merge_stats bit for "
        f"bit (card vs CPU, learning vs learn=None); learning traces "
        f"max abs diff {errs} within (rtol, atol) {LEARN_TOL}; "
        f"launches={launches}; cpu {t_cpu:.1f}s, gpu {t_gpu:.1f}s"))


def learn_run(seed: int = 0) -> dict:
    """The learning point at full size, free on the card: the merge
    kernel's main path."""
    p = paper_params(**LEARN_PARAMS)
    cfg = SimConfig(learn=logreg_task())
    with MergeRecorder("gossip_merge_rows") as rec:
        reset_counts()
        t = time.perf_counter()
        out = simulate(p, cfg, seed=seed)             # default device: cuda
        wall = time.perf_counter() - t
        launches = counts()
    if launches != {"pairwise_contacts": cfg.n_slots,
                    "gossip_merge_rows": cfg.n_slots,
                    "gossip_merge_rows_scaled": 0}:
        raise AssertionError(f"learn-run launches {launches}")
    s = cfg.n_slots // cfg.sample_every
    for k in ("test_acc", "test_acc_holders", "learn_obs", "theta_var"):
        arr = getattr(out, k)
        if arr.shape != (s,) or not np.all(np.isfinite(arr)):
            raise AssertionError(f"learn-run: {k} {arr.shape} not finite")
    early, late = float(out.test_acc[:3].mean()), float(out.test_acc[-3:].mean())
    holders = float(out.test_acc_holders[-3:].mean())
    if not late > early + 0.05:
        raise AssertionError(f"learn-run: accuracy {early} -> {late}")
    if not holders >= late - 1e-6:
        raise AssertionError(f"learn-run: holders {holders} < {late}")
    merged = held_on_run_inputs(
        rec, gm.gossip_merge_rows, gm.gossip_merge_rows_ref, lerp_rows,
        lambda n, d, sel: merge_bound_ms(n, d, sel, scaled=False))
    d = cfg.learn.param_dim
    ms = out.merge_stats[-1]
    phase("learn-run", (
        f"N={cfg.n_nodes} D={d} slots={cfg.n_slots} wall={wall:.3f}s "
        f"slots/s={cfg.n_slots / wall:.1f} launches={launches} "
        f"test_acc {early:.6f} -> {late:.6f} holders {holders:.6f} "
        f"learn_obs={float(out.learn_obs[-1]):.3f} "
        f"theta_var={float(out.theta_var[-1]):.6g} merge_stats={ms.tolist()} "
        f"{merge_line(merged)}"))
    profile_slots("learn", p, cfg)
    return dict(launches=launches["gossip_merge_rows"], **merged)


def merge_line(k: dict) -> str:
    return (f"kernel==plain on the run's last {k['calls']} merges "
            f"({k['rows']} rows, max_abs_err={k['max_abs_err']}); timed on "
            f"the busiest ({k['k']} of {k['n']} rows selected): "
            f"kernel_us={1e3 * k['ms']:.3f} "
            f"bound_us={1e3 * k['bound_ms']:.5f} ({k['bound_by']}) "
            f"plain_us={1e3 * k['plain_ms']:.3f} "
            f"library_us={1e3 * k['library_ms']:.3f} "
            f"kernel_call_us={1e3 * k['call_ms']:.3f}")


def defended_run(seed: int = 0, n_slots: int = 1000) -> dict:
    """A norm-clipped learning run on the card: the scaled merge's path."""
    p = paper_params(**LEARN_PARAMS)
    lc = dataclasses.replace(logreg_task(),
                             defense=DefenseConfig(norm_clip=0.5))
    cfg = SimConfig(n_slots=n_slots, learn=lc)
    with MergeRecorder("gossip_merge_rows_scaled") as rec:
        reset_counts()
        t = time.perf_counter()
        out = simulate(p, cfg, seed=seed)
        wall = time.perf_counter() - t
        launches = counts()
    if launches != {"pairwise_contacts": n_slots, "gossip_merge_rows": 0,
                    "gossip_merge_rows_scaled": n_slots}:
        raise AssertionError(f"defended run launches {launches}")
    ms = out.merge_stats[-1]
    if ms[learning.MS_NORMCLIP] <= 0 or not np.all(np.isfinite(out.test_acc)):
        raise AssertionError(f"defended run: merge_stats {ms.tolist()}")
    merged = held_on_run_inputs(
        rec, gm.gossip_merge_rows_scaled, gm.gossip_merge_rows_scaled_ref,
        lerp_rows_scaled,
        lambda n, d, sel: merge_bound_ms(n, d, sel, scaled=True))
    phase("defended-run", (
        f"norm_clip=0.5 N={cfg.n_nodes} slots={n_slots} wall={wall:.3f}s "
        f"slots/s={n_slots / wall:.1f} launches={launches} "
        f"merge_stats={ms.tolist()} test_acc {float(out.test_acc[0]):.6f} -> "
        f"{float(out.test_acc[-1]):.6f} {merge_line(merged)}"))
    return dict(launches=launches["gossip_merge_rows_scaled"], **merged)


def build_all() -> None:
    """One nvcc per kernel source, all started together."""
    t = time.perf_counter()
    with concurrent.futures.ThreadPoolExecutor() as pool:
        libs = list(pool.map(lambda build: build(),
                             (kc.build_library, gm.build_library)))
    phase("build", f"{', '.join(lib.name for lib in libs)} in "
                   f"{time.perf_counter() - t:.2f}s")


def scaled_point(n_total: int, n_slots: int):
    """The paper scenario at ``n_total`` nodes and fixed density (the
    dense points of the convergence figure)."""
    area = math.sqrt(n_total / DENSITY)
    r_rz = area / 2.0
    p = paper_params(lam=0.05, M=1).replace(
        N=DENSITY * math.pi * r_rz**2, alpha=2.0 * DENSITY * 1.0 * r_rz)
    cfg = SimConfig(n_nodes=n_total, area_side=area, rz_radius=r_rz,
                    n_slots=n_slots, sample_every=16)
    return p, cfg


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    cap = torch.cuda.get_device_capability(0)
    print(smi, flush=True)
    phase("device", f"{torch.cuda.get_device_name(0)} sm_{cap[0]}{cap[1]}, "
                    f"torch {torch.__version__}, CUDA {torch.version.cuda}")
    if cap != (9, 0):
        raise RuntimeError(f"need an sm_90 card, got sm_{cap[0]}{cap[1]}")

    build_all()
    err = check_kernel_cases()
    merge_worst = check_merge_cases()
    check_replay()
    learn_replay(logreg_task(), 1000)
    learn_replay(mlp_task(), 320)
    main_run = free_run("paper", paper_params(lam=0.05, M=1), SimConfig())
    dense_run = free_run("dense-800", *scaled_point(800, 4000))
    rows = learn_run()
    scaled = defended_run()

    def merge_record(name, run, line):
        return dict(
            name=name, route="cuda", source="src/repro_torch/csrc/gossip_merge.cu",
            replaces=f"src/repro/kernels/gossip_merge.py:{line}",
            launches=run["launches"], max_abs_err=max(merge_worst,
                                                      run["max_abs_err"]),
            ms=run["ms"], plain_ms=run["plain_ms"], bound_ms=run["bound_ms"],
            bound_by=run["bound_by"], library_ms=run["library_ms"])

    record = {"kernels": [dict(
        name="pairwise_contacts", route="cuda",
        source="src/repro_torch/csrc/contacts.cu",
        replaces="src/repro/kernels/contacts.py:299",
        launches=main_run["launches"],
        max_abs_err=max(err, main_run["max_abs_err"],
                        dense_run["max_abs_err"]),
        ms=main_run["ms"], plain_ms=main_run["plain_ms"],
        bound_ms=main_run["bound_ms"], bound_by=main_run["bound_by"],
        library_ms=None,
    ), merge_record("gossip_merge_rows", rows, 116),
        merge_record("gossip_merge_rows_scaled", scaled, 173)]}
    print(json.dumps(record))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
