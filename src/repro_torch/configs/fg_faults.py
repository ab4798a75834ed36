"""Preset fault configurations for the robustness studies (port of
``repro.configs.fg_faults``).

Every preset returns a hashable ``repro_torch.sim.faults.FaultConfig``
for ``SimConfig.faults`` and for
``core.meanfield.solve_fixed_point_classes``.
"""

from __future__ import annotations

from repro_torch.sim.faults import FaultClass, FaultConfig

__all__ = ["always_on", "duty_mix", "free_rider_mix", "harsh", "zipf_mix",
           "zipf_weights", "CYCLE_TIME_DEFAULT"]

# a duty-cycled node's mean on+off cycle [s]; short against the ~157 s
# RZ sojourn so the duty chain mixes well within a residence
CYCLE_TIME_DEFAULT = 10.0


def always_on() -> FaultConfig:
    """One always-on class, zero fault rates: the disabled configuration,
    which runs exactly as ``faults=None``."""
    return FaultConfig()


def _duty_class(duty: float, cycle_time: float, frac: float,
                name: str = "duty") -> FaultClass:
    """A two-state on/off class with stationary on-fraction ``duty`` and
    mean cycle ``1/rate_on + 1/rate_off = cycle_time``."""
    if not 0.0 < duty < 1.0:
        raise ValueError(f"duty must be in (0, 1), got {duty}")
    if cycle_time <= 0.0:
        raise ValueError(f"cycle_time must be positive, got {cycle_time}")
    # mean on-time = duty * cycle_time, mean off-time = (1-duty) * cycle
    rate_off = 1.0 / (duty * cycle_time)
    rate_on = 1.0 / ((1.0 - duty) * cycle_time)
    return FaultClass(frac=frac, rate_off=rate_off, rate_on=rate_on,
                      name=name)


def duty_mix(*, duty: float = 0.5, frac_duty: float = 0.5,
             cycle_time: float = CYCLE_TIME_DEFAULT,
             link_fail_rate: float = 0.0, p_abort: float = 0.0,
             crash_rate: float = 0.0) -> FaultConfig:
    """An always-on class and a duty-cycled one: ``frac_duty`` of the
    population is accessible a fraction ``duty`` of the time. The link,
    abort and crash rates apply to everyone."""
    if not 0.0 < frac_duty <= 1.0:
        raise ValueError(f"frac_duty must be in (0, 1], got {frac_duty}")
    if frac_duty >= 1.0:
        classes = (_duty_class(duty, cycle_time, 1.0),)
    else:
        classes = (FaultClass(frac=1.0 - frac_duty, name="on"),
                   _duty_class(duty, cycle_time, frac_duty))
    return FaultConfig(classes=classes, link_fail_rate=link_fail_rate,
                       p_abort=p_abort, crash_rate=crash_rate)


def zipf_weights(n_classes: int, s: float = 0.9) -> tuple[float, ...]:
    """Zipf(s) participation weights ``1 / (k + 1)^s``, so ``max == 1``
    (``s = 0``: uniform)."""
    if n_classes < 1:
        raise ValueError(f"n_classes must be >= 1, got {n_classes}")
    if s < 0.0:
        raise ValueError(f"zipf exponent s must be >= 0, got {s}")
    return tuple(1.0 / (k + 1) ** s for k in range(n_classes))


def zipf_mix(*, n_classes: int = 5, s: float = 0.9,
             cycle_time: float = CYCLE_TIME_DEFAULT,
             link_fail_rate: float = 0.0, p_abort: float = 0.0,
             crash_rate: float = 0.0) -> FaultConfig:
    """``n_classes`` equal classes; class ``k``'s duty is the Zipf(s)
    weight ``1/(k+1)^s`` (class 0 always on), so the class solver predicts
    Zipf-graded availability."""
    w = zipf_weights(n_classes, s)
    frac = 1.0 / n_classes
    classes = tuple(
        FaultClass(frac=frac, name=f"zipf{k}") if duty >= 1.0
        else _duty_class(duty, cycle_time, frac, name=f"zipf{k}")
        for k, duty in enumerate(w))
    return FaultConfig(classes=classes, link_fail_rate=link_fail_rate,
                       p_abort=p_abort, crash_rate=crash_rate)


def free_rider_mix(*, frac_fr: float = 0.25) -> FaultConfig:
    """Always-on servers and a free-rider class that receives but never
    serves."""
    if not 0.0 < frac_fr < 1.0:
        raise ValueError(f"frac_fr must be in (0, 1), got {frac_fr}")
    return FaultConfig(classes=(
        FaultClass(frac=1.0 - frac_fr, name="on"),
        FaultClass(frac=frac_fr, free_rider=True, name="free_rider"),
    ))


def harsh(*, duty: float = 0.6, frac_duty: float = 0.5,
          cycle_time: float = CYCLE_TIME_DEFAULT,
          link_fail_rate: float = 0.05, p_abort: float = 0.1,
          crash_rate: float = 0.002) -> FaultConfig:
    """Every fault at once (duty cycling, link failures, aborts, crashes):
    the stress preset, not calibrated to a figure."""
    return duty_mix(duty=duty, frac_duty=frac_duty, cycle_time=cycle_time,
                    link_fail_rate=link_fail_rate, p_abort=p_abort,
                    crash_rate=crash_rate)
