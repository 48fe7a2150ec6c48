"""Training: the DM, LFG and PBnet trainers, their data readers and
augmentations."""

import numpy as np
import torch


def to_device(value, device) -> torch.Tensor:
    """A tensor, or a numpy or JAX array (copied: those may be read-only), on
    ``device``."""
    if isinstance(value, torch.Tensor):
        return value.to(device)
    return torch.as_tensor(np.array(value), device=device)
