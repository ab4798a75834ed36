"""The paper's §VI evaluation scenario (Figs. 1-4 defaults).

Simulation area: 200 m x 200 m square; circular RZ of radius 100 m at its
center; 200 nodes moving under Random Direction with reflections; 5 m
transmission radius; 10 Mb/s channel; T_T = 5 s, T_M = 2.5 s; τ_l = 300 s;
L = 10 kb (=> 2 ms bidirectional exchange); k = 1.

Derived quantities:
  density D   = 200 / (200 m)^2 = 5e-3 nodes/m^2
  N (in RZ)   = D * π (100 m)^2 ≈ 157.1
  α (exit)    = 2 D v̄ · 100 (boundary flux through the RZ perimeter)

``paper_contact_model`` is the analytic contact model of this geometry
(Random Direction at 1 m/s; its tensors on ``cuda`` unless the caller
passes ``device="cpu"``).
"""

from __future__ import annotations

import math

from repro_torch.core.meanfield import FGParams
from repro_torch.core.mobility import ContactModel, contact_model_for

AREA_SIDE = 200.0        # m
RZ_RADIUS = 100.0        # m
N_TOTAL = 200            # nodes in the simulation area
R_TX = 5.0               # m
CHANNEL_RATE = 10e6      # b/s
T_T_DEFAULT = 5.0        # s
T_M_DEFAULT = 2.5        # s
TAU_L = 300.0            # s
L_DEFAULT = 10e3         # bits
K_DEFAULT = 1.0
SPEED_DEFAULT = 1.0      # m/s (the paper sweeps speed; 1 m/s pedestrian)
T0_DEFAULT = 0.1         # s connection setup

DENSITY = N_TOTAL / AREA_SIDE**2
N_RZ = DENSITY * math.pi * RZ_RADIUS**2


def paper_contact_model(
    speed: float = SPEED_DEFAULT,
    nt: int = 512,
    mobility: str = "rdm",
    street_spacing: float = 25.0,
    device=None,
) -> ContactModel:
    """Analytic contact model at the paper geometry, its tensors on
    ``device`` (default ``cuda``). ``mobility`` names the simulation
    model whose analytic twin is built; the port has ``rdm``, the paper's
    own (:data:`repro_torch.core.mobility.CONTACT_MODELS`)."""
    return contact_model_for(
        mobility, speed=speed, r_tx=R_TX, density=DENSITY, nt=nt,
        street_spacing=street_spacing, area_side=AREA_SIDE, device=device,
    )


def paper_params(
    *,
    lam: float = 0.05,
    Lam: float = 1.0,
    M: int = 1,
    W: int | None = None,
    T_T: float = T_T_DEFAULT,
    T_M: float = T_M_DEFAULT,
    L: float = L_DEFAULT,
    speed: float = SPEED_DEFAULT,
    t0: float = T0_DEFAULT,
    k: float = K_DEFAULT,
    tau_l: float = TAU_L,
    zones=None,
) -> FGParams:
    """FGParams for the paper scenario. W defaults to M (w = 1, as in §VI)."""
    alpha = 2.0 * DENSITY * speed * RZ_RADIUS
    return FGParams(
        N=N_RZ, alpha=alpha, lam=lam, Lam=Lam, M=M, W=W if W is not None else M,
        T_T=T_T, T_M=T_M, t0=t0, L=L, C=CHANNEL_RATE, k=k, tau_l=tau_l,
        zones=zones,
    )
