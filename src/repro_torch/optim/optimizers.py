"""SGD on flat parameter tensors (port of ``repro.optim.optimizers.sgd``).

``Optimizer`` is an (init, update) pair; ``update(grads, state, params,
step)`` returns ``(new_params, new_state)``, as in ``repro``. The learning
layer steps one ``(..., D)`` tensor, so parameters here are tensors, not
pytrees.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import torch

__all__ = ["Optimizer", "sgd"]


@dataclasses.dataclass(frozen=True)
class Optimizer:
    init: Callable
    update: Callable  # (grads, state, params, step) -> (new_params, new_state)


def sgd(lr, *, momentum: float = 0.0) -> Optimizer:
    """Plain SGD (``momentum == 0``) or heavy-ball momentum: ``v = m*v + g``,
    ``p = p - lr*v``. ``lr`` is a float or a function of the step."""
    lr_fn = lr if callable(lr) else (lambda _: lr)

    def init(params: torch.Tensor) -> dict:
        if momentum == 0.0:
            return {}
        return dict(vel=torch.zeros_like(params, dtype=torch.float32))

    def update(grads, state, params, step):
        lr_t = lr_fn(step)
        if momentum == 0.0:
            return (params.float() - lr_t * grads.float()).to(params.dtype), state
        vel = momentum * state["vel"] + grads.float()
        return (params.float() - lr_t * vel).to(params.dtype), dict(vel=vel)

    return Optimizer(init=init, update=update)
