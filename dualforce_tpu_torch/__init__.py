"""DualForce-TPU's PyTorch/CUDA port.

A second package beside `dualforce_tpu` (the JAX reference, which it never
imports). It mirrors that package's layout (`nn`, `ops`, `models`,
`diffusion`, `convert`) and holds hand-written CUDA kernels for Hopper
under `csrc/`.
"""

from __future__ import annotations

import torch


def resolve_device(device="cuda") -> torch.device:
    """The device an entry point runs on: CUDA unless the caller asks for
    the CPU. Raises when CUDA is asked for and absent (never falls back)."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available; pass device='cpu' to run "
                           "the plain PyTorch path on the CPU")
    return dev
