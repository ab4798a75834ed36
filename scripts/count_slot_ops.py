"""What the fault layer, the Byzantine attack, several Replication Zones
and the other mobility models add to a slot, counted on the CPU: the aten
operations a slot dispatches (each is one kernel launch on the card, but
for views), with and without faults, with learning under
``robust_defense()`` with and without ``harsh_adversarial()``, with three
zones (one drifting) and with 32, under rwp (with and without a pause),
manhattan and rdm with ``speed_range``, and those of the draws.

    PYTHONPATH=src python scripts/count_slot_ops.py

A slot's count is the difference between sweeps of 48 and 16 slots (B =
2: one scenario, seeds 0 and 1, the paper point at N = 200) over 32, so
the start-up and the samples' outputs cancel. The draws: one
``split(key, 5)``, one ``uniform(key, (200,))`` and the fault split's
four uniforms through ``faults.slot_draws`` (one threefry pass).
"""

from __future__ import annotations

import torch
from torch.utils._python_dispatch import TorchDispatchMode

import dataclasses

from repro_torch import random as jr
from repro_torch.configs.fg_adversarial import (harsh_adversarial,
                                                robust_defense)
from repro_torch.configs.fg_faults import harsh, zipf_mix
from repro_torch.configs.fg_learn import logreg_task
from repro_torch.configs.fg_paper import paper_params
from repro_torch.core.zones import ZoneSet
from repro_torch.sim import SimConfig, faults, sweep

#: Two overlapping zones and a small drifting one (chip_smoke's zones-replay)
THREE_ZONES = ZoneSet(centers=((60.0, 100.0), (110.0, 100.0), (150.0, 165.0)),
                      radii=(45.0, 40.0, 22.0),
                      drift=((0.0, 0.0), (0.0, 0.0), (2.6, 1.8)))
GRID_ZONES = ZoneSet(centers=tuple((12.5 + 25.0 * (z % 8), 25.0 + 50.0 * (z // 8))
                                   for z in range(32)), radii=(14.0,) * 32)


class Count(TorchDispatchMode):
    """Counts the aten operations dispatched inside its ``with``."""

    def __init__(self):
        super().__init__()
        self.n = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.n += 1
        return func(*args, **(kwargs or {}))


def counted(fn) -> int:
    with Count() as c:
        fn()
    return c.n


def per_slot(fc, lc=None, zones=None, **mobility) -> float:
    p = paper_params(lam=0.05, M=1, **({} if lc is None else dict(Lam=10.0)))
    n = [counted(lambda: sweep.run([p], SimConfig(n_slots=s, sample_every=8,
                                                  faults=fc, learn=lc,
                                                  zones=zones, **mobility),
                                   (0, 1), device="cpu"))
         for s in (16, 48)]
    return (n[1] - n[0]) / 32


def main() -> None:
    for label, fc in (("no faults", None), ("zipf_mix(3)", zipf_mix(
            n_classes=3)), ("harsh()", harsh())):
        print(f"{label}: {per_slot(fc)} aten ops a slot (B = 2, N = 200)")
    for label, zs in (("three zones, one drifting", THREE_ZONES),
                      ("32 zones", GRID_ZONES)):
        print(f"{label}: {per_slot(None, zones=zs)} aten ops a slot (B = 2, "
              f"N = 200)")
    for label, kw in (("rwp", dict(mobility="rwp")),
                      ("rwp, 60 s pause", dict(mobility="rwp", pause_s=60.0)),
                      ("manhattan", dict(mobility="manhattan")),
                      ("rdm, speed_range (0.1, 1.9)",
                       dict(speed_range=(0.1, 1.9)))):
        print(f"{label}: {per_slot(None, **kw)} aten ops a slot (B = 2, "
              f"N = 200)")
    defended = dataclasses.replace(logreg_task(), defense=robust_defense())
    for label, fc in (("logreg + robust_defense()", None),
                      ("logreg + robust_defense() + harsh()", harsh()),
                      ("logreg + robust_defense() + harsh_adversarial()",
                       harsh_adversarial())):
        print(f"{label}: {per_slot(fc, defended)} aten ops a slot (B = 2, "
              f"N = 200, Λ = 10)")
    key = jr.PRNGKey(0)[None]
    keys = jr.split(key, 4)
    print(f"split(key, 5): {counted(lambda: jr.split(key, 5))} ops; "
          f"uniform(key, (200,)): {counted(lambda: jr.uniform(key, (200,)))}"
          f" ops; slot_draws of four keys: "
          f"{counted(lambda: faults.slot_draws(keys, 200))} ops")


if __name__ == "__main__":
    main()
