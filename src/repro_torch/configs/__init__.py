"""Config registry: paper scenario + assigned architecture configs (port of
``repro.configs``, copied as data)."""

from __future__ import annotations

from typing import Callable

_ARCH_REGISTRY: dict[str, Callable] = {}


def register_arch(name: str):
    def deco(fn):
        _ARCH_REGISTRY[name] = fn
        return fn
    return deco


def get_arch_config(name: str, **kw):
    import repro_torch.configs.archs  # noqa: F401  (populates the registry)
    if name not in _ARCH_REGISTRY:
        raise KeyError(
            f"unknown arch {name!r}; available: {sorted(_ARCH_REGISTRY)}"
        )
    return _ARCH_REGISTRY[name](**kw)


def list_archs() -> list[str]:
    import repro_torch.configs.archs  # noqa: F401
    return sorted(_ARCH_REGISTRY)
