"""The simulator's state-drop path (port of ``repro.sim.faults.drop_state``).

Zone churn drops a node's packed protocol state through this one function.
The rest of the fault layer (duty cycles, link failures, aborts, crashes,
free-riders) comes with a later slice.
"""

from __future__ import annotations

import torch

__all__ = ["drop_state"]


def drop_state(drop, *, inc, has_model, tq_model, mq_model, serving,
               serv_left):
    """Drop the packed protocol state of the ``(B, N)`` flagged nodes."""
    return dict(
        inc=torch.where(drop[..., None, None], 0, inc),
        has_model=has_model & ~drop[..., None],
        tq_model=torch.where(drop[..., None], -1, tq_model),
        mq_model=torch.where(drop[..., None], -1, mq_model),
        serving=torch.where(drop, -1, serving),
        serv_left=torch.where(drop, 0.0, serv_left),
    )
