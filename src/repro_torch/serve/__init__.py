"""Serving (port of ``repro.serve``): batched prefill and greedy decode."""

from repro_torch.serve.engine import (ServeEngine, make_decode_step,
                                      make_prefill_step)

__all__ = ["ServeEngine", "make_decode_step", "make_prefill_step"]
