"""The Floating Gossip Monte-Carlo simulator (port of ``repro.sim``)."""

from repro_torch.sim.engine import SimConfig, SimOutputs, simulate
from repro_torch.sim.observations import estimate_o_of_tau

__all__ = ["SimConfig", "SimOutputs", "simulate", "estimate_o_of_tau"]
