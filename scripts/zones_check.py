"""The multi-zone Monte-Carlo check of ``benchmarks/fig_multizone.py``
(``_sim_check``) on the port: two overlapping zones of 60 m at (75, 100)
and (125, 100) at the paper point, one sweep over the seeds with
``reduce="mean"`` over the second half, each zone's seed-mean availability
against ``solve_fixed_point_multizone`` (relative error; the check holds it
within 0.15).

    PYTHONPATH=src python scripts/zones_check.py [--n-slots 4000]
        [--seeds 0,1] [--device cpu]

``chip_smoke.py``'s ``zones-check`` runs the 4000-slot form on the card.
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.configs.fg_paper import (DENSITY, SPEED_DEFAULT,
                                          paper_contact_model, paper_params)
from repro_torch.core.meanfield import solve_fixed_point_multizone
from repro_torch.core.zones import ZoneSet
from repro_torch.sim import SimConfig, sweep

TWO_ZONES = ZoneSet(centers=((75.0, 100.0), (125.0, 100.0)), radii=(60.0, 60.0))


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--n-slots", type=int, default=4000)
    ap.add_argument("--seeds", default="0,1")
    ap.add_argument("--device", default="cpu")
    args = ap.parse_args()
    torch.set_num_threads(2)
    seeds = [int(s) for s in args.seeds.split(",")]
    p = paper_params(lam=0.05, M=1)
    mz = solve_fixed_point_multizone(
        p, paper_contact_model(device=args.device), TWO_ZONES,
        density=DENSITY, speed=SPEED_DEFAULT)
    cfg = SimConfig(n_slots=args.n_slots, sample_every=32, zones=TWO_ZONES)
    t = time.perf_counter()
    summ = sweep.run([p], cfg, seeds, reduce="mean", warmup_frac=0.5,
                     device=args.device)
    wall = time.perf_counter() - t
    a_seed = np.asarray(summ.stats["availability_z"])[0]      # (R, M, K)
    a_sim = a_seed.mean(axis=(0, 1))
    a_mf = mz.a.cpu().numpy()
    for z in range(TWO_ZONES.k):
        print(f"zone {z}: sim {a_sim[z]:.6f} (seeds "
              f"{[round(float(v), 6) for v in a_seed[:, 0, z]]}) mf "
              f"{a_mf[z]:.6f} rel err {abs(a_mf[z] - a_sim[z]) / a_sim[z]:.4f}")
    print(f"{args.n_slots} slots, seeds {seeds}, {args.device}: "
          f"{wall:.1f}s")


if __name__ == "__main__":
    main()
