"""The Floating Gossip Monte-Carlo simulator (port of ``repro.sim``): the
slot loop on the dense and cell-list contact backends, with the protocol
fault layer (``faults``, ``SimConfig.faults``), Gossip Learning
(``learn``, ``SimConfig.learn``) and the Byzantine attacks on it (the
adversarial classes of ``SimConfig.faults``, presets in
``repro_torch.configs.fg_adversarial``, reporting ``poisoned_frac``), in
single runs and sweeps. The contamination flag's analytic twin is
``repro_torch.core.meanfield.solve_contamination_classes`` with
``core.dde.solve_contamination_transient``. The mobility models (``rdm``,
``rwp``, ``manhattan``; ``MOBILITY_MODELS``, ``get_mobility``) pair with
their analytic twins by name, and ``measure_contact_rate`` measures a
model's contact rate on the contact kernel; ``register_mobility`` adds a
user's model. ``dispatch`` runs a sweep from several worker processes
through a file-system lease queue (``sweep.run(workers=...)``)."""

from repro_torch.core.zones import ZoneSet
from repro_torch.sim import cells, dispatch, faults, sweep
from repro_torch.sim.dispatch import RetryPolicy
from repro_torch.sim.engine import (BatchSimOutputs, SimConfig, SimOutputs,
                                    effective_zones, simulate, simulate_batch)
from repro_torch.sim.mobility import (MOBILITY_MODELS, MobilityModel,
                                      get_mobility, measure_contact_rate,
                                      register_mobility)
from repro_torch.sim.observations import estimate_o_of_tau
from repro_torch.sim.sweep import SweepPlan, SweepSummary, plan_sweep

__all__ = ["cells", "dispatch", "RetryPolicy", "SimConfig", "SimOutputs",
           "BatchSimOutputs", "ZoneSet", "effective_zones", "simulate",
           "simulate_batch", "sweep", "plan_sweep", "SweepPlan",
           "SweepSummary", "estimate_o_of_tau", "faults", "MOBILITY_MODELS",
           "MobilityModel", "get_mobility", "register_mobility",
           "measure_contact_rate"]
