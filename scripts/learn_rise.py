"""How short chip_smoke's learn-run may be: its configuration run on the
CPU, and its accuracy check at each prefix length.

    PYTHONPATH=src python scripts/learn_rise.py [--slots 4000] [--seed 0]

``learn-run`` requires the mean test accuracy of the last three samples to
exceed the first three's by over 0.05, and the in-zone holders' to be no
lower than the population's. A run's first k slots are a k-slot run (the
loop is causal), so one run answers for every length up to ``--slots``.
"""

from __future__ import annotations

import argparse
import time

import torch

from repro_torch.configs.fg_learn import logreg_task
from repro_torch.configs.fg_paper import paper_params
from repro_torch.sim import SimConfig, simulate

#: chip_smoke.py's LEARN_PARAMS.
LEARN_PARAMS = dict(lam=0.05, Lam=10.0, M=1, T_T=5.0)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--slots", type=int, default=4000)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--threads", type=int, default=2)
    args = ap.parse_args()
    torch.set_num_threads(args.threads)
    cfg = SimConfig(n_slots=args.slots, learn=logreg_task())
    t = time.perf_counter()
    out = simulate(paper_params(**LEARN_PARAMS), cfg, seed=args.seed,
                   device="cpu")
    print(f"{args.slots} slots on the CPU in {time.perf_counter() - t:.1f}s")
    early = float(out.test_acc[:3].mean())
    for n in range(1000, args.slots + 1, 500):
        s = n // cfg.sample_every
        late = float(out.test_acc[s - 3:s].mean())
        holders = float(out.test_acc_holders[s - 3:s].mean())
        print(f"{n} slots: test_acc {early:.6f} -> {late:.6f} (rise "
              f"{'ok' if late > early + 0.05 else 'FAILS'}), holders "
              f"{holders:.6f} ({'ok' if holders >= late - 1e-6 else 'FAILS'})")


if __name__ == "__main__":
    main()
