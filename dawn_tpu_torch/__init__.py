"""dawn_tpu_torch: the PyTorch/CUDA port of dawn_tpu for one NVIDIA H100.

The JAX package ``dawn_tpu`` stays beside it as the reference. This package
imports ``torch`` and ``numpy`` only, never ``jax`` or ``dawn_tpu``. Public
functions keep the JAX package's channels-last layouts ((B, T, H, W, C)
videos, (B, H, W, 3) images) so the two can be compared directly.
"""

import torch


def resolve_device(device=None) -> torch.device:
    """The card by default; the CPU only when the caller asks for it."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device found; pass device='cpu' to run on the CPU")
        return torch.device("cuda")
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("CUDA device requested but none is available")
    return device
