"""PyTorch and CUDA port of the Floating Gossip simulator (``repro``).

The port runs on an NVIDIA Hopper GPU: plain tensor code is PyTorch, and
the TPU Pallas kernel of the simulator's main path is a hand-written CUDA
kernel (``repro_torch.kernels.contacts``). Entry points run on ``cuda``
unless the caller passes ``device="cpu"``, where each kernel's plain
PyTorch version runs instead. The package imports neither JAX nor
``repro``; its tests hold it against ``repro`` on the same inputs.
"""
