"""The Byzantine path on the cell-list backend: ``harsh_adversarial()``
with ``robust_defense()`` and ``logreg_task()`` at N = 1024 (the paper's
density, 304 slots), the port replaying ``repro``'s positions, equal to
``repro``'s run bit for bit on every protocol trace, fault field,
``nbr_overflow``, ``poisoned_frac``, ``poisoned_frac_c`` and
``merge_stats``, the learning traces within ``tests/test_torch_learn.py``'s
rtol 1e-5 / atol 1e-6 (``tests/test_torch_adversarial_runs.py`` holds the
dense runs; a file of its own so that the two run side by side: the
port's learning stream at N = 1024 takes minutes on one CPU thread)."""

import numpy as np

from repro_torch.configs.fg_paper import DENSITY
from test_torch_adversarial_runs import (check_replayed_run,  # noqa: F401
                                         one_thread, working_barrier)

#: N = 1024 at the paper's density on the cell lists, 304 slots.
CELLS = dict(n_nodes=1024, area_side=float(np.sqrt(1024 / DENSITY)),
             rz_radius=float(np.sqrt(1024 / DENSITY)) / 2, n_slots=304,
             sample_every=16, contact_backend="cells")


def test_replayed_cells_attack_run_equals_repro(working_barrier):
    out, _ = check_replayed_run("harsh_adversarial", "robust_defense",
                                CELLS, 1, extra=("nbr_overflow",))
    assert out.nbr_overflow.max() == 0
