"""Frequency-domain losses and filters of flow videos along their frames.

Port of ``dawn_tpu/ops/fourier.py`` (reference filter_fourier.py):
``hf_loss_2``, the DM trainer's temporal-FFT floss (the L1 magnitude in rFFT
space along the frames against the target); ``hf_loss``; the low-pass
filters ``fourier_filter_1d`` (temporal) and ``fourier_filter_2d`` (a
Gaussian in 2-D frequency space, square frames only); ``naive_filter``; and
the 1-D Kalman smoother, a loop over the frames.
"""

from __future__ import annotations

import numpy as np
import torch


def hf_loss_2(pred: torch.Tensor, target: torch.Tensor, dim: int = 1) -> torch.Tensor:
    """|rfft(target) - rfft(pred)| along ``dim`` (the frames of (B, T, ...)
    videos): the per-element magnitude map."""
    return (torch.fft.rfft(target, dim=dim) - torch.fft.rfft(pred, dim=dim)).abs()


def hf_loss(fea: torch.Tensor, mask: torch.Tensor, dim: int = 1) -> torch.Tensor:
    """|rfft(fea) * (1 - mask)| along ``dim``: ``mask`` weights the rFFT
    bins (a low-pass), so the loss is the high-frequency magnitude."""
    return (torch.fft.rfft(fea, dim=dim) * (1.0 - mask)).abs()


def fourier_filter_1d(x: torch.Tensor, dim: int = 0) -> torch.Tensor:
    """Zero the top 3/4 of the frequencies along ``dim`` (keep bins < n // 4)."""
    n = x.shape[dim]
    f = torch.fft.rfft(x, dim=dim)
    shape = [1] * f.ndim
    shape[dim] = f.shape[dim]
    keep = (torch.arange(f.shape[dim], device=x.device) < n // 4).reshape(shape)
    return torch.fft.irfft(f * keep, n=n, dim=dim)


def _gaussian_pdf(x, mean, std):
    return (1.0 / (std * np.sqrt(2 * np.pi))) * np.exp(-((x - mean) ** 2) / (2 * std ** 2))


def fourier_filter_2d(fea: torch.Tensor) -> torch.Tensor:
    """Gaussian low-pass of (L, H, W, C) frames in 2-D frequency space: the
    (H, H) map of a Gaussian over linspace(-10, 10, H) with std 3, scaled
    to 3 at its peak and clipped to [0, 1]. Square frames only, as the
    reference builds the map from H alone."""
    _, h, w, _ = fea.shape
    if h != w:
        raise ValueError(f"fourier_filter_2d takes square frames only (got {h}x{w})")
    xs = np.linspace(-10, 10, h)
    gm = np.outer(_gaussian_pdf(xs, 0.0, 3.0), _gaussian_pdf(xs, 0.0, 3.0))
    gm = torch.as_tensor(np.clip(gm / gm.max() * 3, 0, 1).astype(np.float32),
                         device=fea.device)
    f = torch.fft.fftshift(torch.fft.fft2(fea, dim=(1, 2)), dim=(1, 2)) * gm[None, :, :, None]
    return torch.fft.ifft2(torch.fft.ifftshift(f, dim=(1, 2)), dim=(1, 2)).real


def naive_filter(fea: torch.Tensor, thresh: float = 1.0 / 64) -> torch.Tensor:
    """Zero the entries of magnitude at most ``thresh``."""
    return fea * (fea.abs() > thresh)


def kalman_filter_1d(observations: torch.Tensor, a: float = 1.0, h: float = 1.0,
                     q: float = 0.01, r: float = 0.1, dim: int = 0) -> torch.Tensor:
    """1-D Kalman smoothing along ``dim``, every other entry its own filter:
    state 0 and variance 1 before the first frame."""
    obs = observations.movedim(dim, 0)
    x, p = torch.zeros_like(obs[0]), torch.ones_like(obs[0])
    out = []
    for z in obs:
        x_pred = a * x
        p_pred = a * p * a + q
        k = p_pred * h / (h * p_pred * h + r)
        x = x_pred + k * (z - h * x_pred)
        p = (1 - k * h) * p_pred
        out.append(x)
    return torch.stack(out).movedim(0, dim)
