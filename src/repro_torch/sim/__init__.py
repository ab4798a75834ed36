"""The Floating Gossip Monte-Carlo simulator (port of ``repro.sim``)."""

from repro_torch.sim import sweep
from repro_torch.sim.engine import (BatchSimOutputs, SimConfig, SimOutputs,
                                    simulate, simulate_batch)
from repro_torch.sim.observations import estimate_o_of_tau
from repro_torch.sim.sweep import SweepPlan, plan_sweep

__all__ = ["SimConfig", "SimOutputs", "BatchSimOutputs", "simulate",
           "simulate_batch", "sweep", "plan_sweep", "SweepPlan",
           "estimate_o_of_tau"]
