"""PyTorch and CUDA port of the Floating Gossip simulator (``repro``).

The port runs on an NVIDIA Hopper GPU: plain tensor code is PyTorch, and
every TPU Pallas kernel is a hand-written CUDA kernel
(``repro_torch.kernels``). It holds the simulator (``sim``: the slot loop
on both contact backends, the protocol fault layer, Gossip Learning and
sweeps), its analytics (``core``: the Lemma 1-3 fixed point and its
fault-class twin, the Theorem-1 DDE, capacity, staleness), the gossip
round and the serving path. Entry points run on ``cuda``
unless the caller passes ``device="cpu"``, where each kernel's plain
PyTorch version runs instead. The package imports neither JAX nor
``repro``; its tests hold it against ``repro`` on the same inputs.
"""

import torch as _torch


def resolve_device(device, what: str) -> "_torch.device":
    """``device``, or ``cuda`` when it is None. Raises when ``cuda`` is
    meant and no card is present: nothing falls back to the CPU."""
    if device is None:
        if not _torch.cuda.is_available():
            raise RuntimeError(
                f"{what} runs on a CUDA device by default and none is "
                "available; pass device='cpu' to run the plain version")
        return _torch.device("cuda")
    return _torch.device(device)
