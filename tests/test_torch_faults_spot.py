"""The Zipf spot check of ``tests/test_sim_faults.py`` on the port: per-class
availability from a paper-geometry sweep against the class solver.

``zipf_mix(n_classes=3)`` at ``paper_params(lam=0.05, M=1)``: a
``SimConfig(n_slots=4000, sample_every=8)`` sweep over seeds 0 and 1 with
``reduce="mean"`` and ``warmup_frac=0.5``, on the CPU. Each class's
simulated availability (seeds pooled) lies within 15% of the port's
``solve_fixed_point_classes``, and the classes come out in the solver's
order. The sweep takes about a minute on two CPU threads, so the module is
marked ``slow``, as the other free-run checks are.
"""

import numpy as np
import pytest
import torch

from repro_torch.configs.fg_faults import zipf_mix
from repro_torch.configs.fg_paper import paper_contact_model, paper_params
from repro_torch.core.meanfield import solve_fixed_point_classes
from repro_torch.sim import SimConfig, sweep

pytestmark = pytest.mark.slow


def test_zipf_sim_vs_class_solver_spot():
    threads = torch.get_num_threads()
    torch.set_num_threads(min(threads, 2))
    try:
        fc = zipf_mix(n_classes=3)
        p = paper_params(lam=0.05, M=1)
        cs = solve_fixed_point_classes(p, paper_contact_model(device="cpu"),
                                       faults=fc)
        summ = sweep.run([p], SimConfig(n_slots=4000, sample_every=8,
                                        faults=fc), seeds=(0, 1),
                         reduce="mean", warmup_frac=0.5, device="cpu")
    finally:
        torch.set_num_threads(threads)
    a_model = cs.a[:, 0].numpy()
    a_sim = summ.stats["availability_c"][0, :, 0, :].mean(axis=0)
    assert np.array_equal(np.argsort(a_model), np.argsort(a_sim))
    rel = np.abs(a_sim - a_model) / a_model
    assert float(rel.max()) < 0.15, (a_model, a_sim)
    assert summ.stats["fault_events"].sum() == 0    # duty cycling only
