"""What the fault layer adds to a slot, counted on the CPU: the aten
operations a slot dispatches (each is one kernel launch on the card, but
for views), with and without faults, and those of its draws.

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

from repro_torch import random as jr
from repro_torch.configs.fg_faults import harsh, zipf_mix
from repro_torch.configs.fg_paper import paper_params
from repro_torch.sim import SimConfig, faults, sweep


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


def per_slot(fc) -> float:
    p = paper_params(lam=0.05, M=1)
    n = [counted(lambda: sweep.run([p], SimConfig(n_slots=s, sample_every=8,
                                                  faults=fc), (0, 1),
                                   device="cpu"))
         for s in (16, 48)]
    return (n[1] - n[0]) / 32


def main() -> None:
    for label, fc in (("no faults", None), ("zipf_mix(3)", zipf_mix(
            n_classes=3)), ("harsh()", harsh())):
        print(f"{label}: {per_slot(fc)} aten ops a slot (B = 2, N = 200)")
    key = jr.PRNGKey(0)[None]
    keys = jr.split(key, 4)
    print(f"split(key, 5): {counted(lambda: jr.split(key, 5))} ops; "
          f"uniform(key, (200,)): {counted(lambda: jr.uniform(key, (200,)))}"
          f" ops; slot_draws of four keys: "
          f"{counted(lambda: faults.slot_draws(keys, 200))} ops")


if __name__ == "__main__":
    main()
