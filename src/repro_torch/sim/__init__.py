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
model's contact rate on the contact kernel."""

from repro_torch.sim import faults, sweep
from repro_torch.sim.engine import (BatchSimOutputs, SimConfig, SimOutputs,
                                    simulate, simulate_batch)
from repro_torch.sim.mobility import (MOBILITY_MODELS, MobilityModel,
                                      get_mobility, measure_contact_rate)
from repro_torch.sim.observations import estimate_o_of_tau
from repro_torch.sim.sweep import SweepPlan, plan_sweep

__all__ = ["SimConfig", "SimOutputs", "BatchSimOutputs", "simulate",
           "simulate_batch", "sweep", "plan_sweep", "SweepPlan",
           "estimate_o_of_tau", "faults", "MOBILITY_MODELS", "MobilityModel",
           "get_mobility", "measure_contact_rate"]
