"""Smoke test of the PyTorch/CUDA port on one NVIDIA H100.

    python3 chip_smoke.py

Phases (any failure ends the run with a non-zero exit code):

1. device — the card's name and power limit; it must be sm_90;
2. build — the CUDA kernel from ``src/repro_torch/csrc``;
3. kernel vs plain version on the card, bit for bit on every output, over
   N x prev-density cases, multi-bit zone words and a dense node cluster;
4. replay — the port runs the paper geometry on the CPU, then on the card
   replaying the same positions: every trace equal bit for bit, and one
   kernel launch per slot;
5. free runs on the card — the paper point (N = 200, 8000 slots) and the
   dense N = 800 point, with wall time, slots/s, launches and sanity
   checks; then the kernel is held against its plain version bit for bit
   on that point's own inputs (B = 1) and both are timed, beside the
   kernel's bound.

The line before the last is the per-kernel JSON record; the last line is
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

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
from repro_torch.kernels import contacts as kc  # noqa: E402
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


def same_traces(a, b) -> None:
    for f in TRACES:
        x, y = getattr(a, f), getattr(b, f)
        if x.shape != y.shape or x.dtype != y.dtype or not np.array_equal(x, y):
            raise AssertionError(f"replayed GPU run != CPU run on {f}")


def check_replay(seed: int = 0, n_slots: int = 2000) -> None:
    p = paper_params(lam=0.05, M=1)
    cfg = SimConfig(n_slots=n_slots)
    t = time.perf_counter()
    cpu = simulate(p, cfg, seed=seed, device="cpu")
    track = mobility_track(cfg, seed=seed, device="cpu")
    t_cpu = time.perf_counter() - t
    kc.pairwise_contacts.launches = 0
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
    torch.cuda.synchronize()
    kc.pairwise_contacts.launches = 0
    t = time.perf_counter()
    out = simulate(p, cfg, seed=seed)                 # default device: cuda
    wall = time.perf_counter() - t
    launches = kc.pairwise_contacts.launches
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

    t = time.perf_counter()
    lib = kc.build_library()
    phase("build", f"{lib.name} in {time.perf_counter() - t:.2f}s")

    err = check_kernel_cases()
    check_replay()
    main_run = free_run("paper", paper_params(lam=0.05, M=1), SimConfig())
    dense_run = free_run("dense-800", *scaled_point(800, 8000))

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
    )]}
    print(json.dumps(record))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
