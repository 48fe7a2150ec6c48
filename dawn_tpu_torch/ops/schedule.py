"""Diffusion noise schedule and derived buffers (the port's own copy).

Same construction as ``dawn_tpu/ops/schedule.py``: the cosine beta schedule
in float64, every derived buffer cast to float32.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch


def cosine_beta_schedule(timesteps: int, s: float = 0.008) -> np.ndarray:
    """Cosine schedule (Nichol & Dhariwal), float64, clipped to [0, 0.9999]."""
    x = np.linspace(0, timesteps, timesteps + 1, dtype=np.float64)
    alphas_cumprod = np.cos(((x / timesteps) + s) / (1 + s) * np.pi * 0.5) ** 2
    alphas_cumprod = alphas_cumprod / alphas_cumprod[0]
    betas = 1 - (alphas_cumprod[1:] / alphas_cumprod[:-1])
    return np.clip(betas, 0, 0.9999)


def diffusion_buffers(timesteps: int = 1000) -> Dict[str, np.ndarray]:
    """The float32 buffers the sampler needs, keyed as in the reference."""
    betas = cosine_beta_schedule(timesteps)
    alphas = 1.0 - betas
    alphas_cumprod = np.cumprod(alphas, axis=0)
    alphas_cumprod_prev = np.concatenate([[1.0], alphas_cumprod[:-1]])
    posterior_variance = betas * (1.0 - alphas_cumprod_prev) / (1.0 - alphas_cumprod)
    buf = {
        "betas": betas,
        "alphas_cumprod": alphas_cumprod,
        "alphas_cumprod_prev": alphas_cumprod_prev,
        "sqrt_alphas_cumprod": np.sqrt(alphas_cumprod),
        "sqrt_one_minus_alphas_cumprod": np.sqrt(1.0 - alphas_cumprod),
        "log_one_minus_alphas_cumprod": np.log(1.0 - alphas_cumprod),
        "sqrt_recip_alphas_cumprod": np.sqrt(1.0 / alphas_cumprod),
        "sqrt_recipm1_alphas_cumprod": np.sqrt(1.0 / alphas_cumprod - 1),
        "posterior_variance": posterior_variance,
        "posterior_log_variance_clipped": np.log(np.clip(posterior_variance, 1e-20, None)),
        "posterior_mean_coef1": betas * np.sqrt(alphas_cumprod_prev) / (1.0 - alphas_cumprod),
        "posterior_mean_coef2": (1.0 - alphas_cumprod_prev) * np.sqrt(alphas) / (1.0 - alphas_cumprod),
    }
    return {k: v.astype(np.float32) for k, v in buf.items()}


def ddim_times(total_timesteps: int, sampling_timesteps: int):
    """DDIM (time, time_next) pairs: torch.linspace in float32, truncated to
    int, reversed, consecutive pairs (the reference's own recipe)."""
    times = torch.linspace(0.0, float(total_timesteps),
                           steps=sampling_timesteps + 2)[:-1]
    times = list(reversed([int(v) for v in times.tolist()]))
    return list(zip(times[:-1], times[1:]))
