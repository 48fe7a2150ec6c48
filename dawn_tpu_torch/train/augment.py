"""Augmentations of the training inputs.

Port of ``dawn_tpu/train/augment.py``:

- the DM's video color jitter (``:16-73``): the reference's torchvision
  ColorJitter on the whole clip (brightness +-64/255, contrast +-0.25,
  saturation +-0.25, hue +-0.04), one random draw per video shared by all
  its frames, applied in that order, on the video's device;
- the LFG's frame-pair augmentation (``:82-131``, LFG/augmentation.py with
  config/hdtf128.yaml's augmentation_params): a random time flip (source
  and driving swapped), a random horizontal flip of both, and one color
  jitter of the pair; host numpy on a ``np.random.RandomState``, which
  gives the JAX package's output bit for bit for the same state.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch


def _rgb_to_hsv(rgb: torch.Tensor):
    r, g, b = rgb[..., 0], rgb[..., 1], rgb[..., 2]
    maxc = rgb.amax(dim=-1)
    minc = rgb.amin(dim=-1)
    delta = maxc - minc
    s = torch.where(maxc > 0, delta / maxc.clamp_min(1e-8), torch.zeros_like(maxc))
    den = delta.clamp_min(1e-8)
    rc, gc, bc = (maxc - r) / den, (maxc - g) / den, (maxc - b) / den
    h = torch.where(maxc == r, bc - gc, torch.where(maxc == g, 2.0 + rc - bc, 4.0 + gc - rc))
    h = torch.where(delta == 0, torch.zeros_like(h), torch.remainder(h / 6.0, 1.0))
    return h, s, maxc


def _hsv_to_rgb(h, s, v):
    i = torch.floor(h * 6.0)
    f = h * 6.0 - i
    p = v * (1 - s)
    q = v * (1 - f * s)
    t = v * (1 - (1 - f) * s)
    i = torch.remainder(i.to(torch.int32), 6)

    def pick(*vals):
        out = vals[5]
        for k in range(4, -1, -1):
            out = torch.where(i == k, vals[k], out)
        return out

    return torch.stack([pick(v, q, p, p, t, v), pick(t, v, v, q, p, p),
                        pick(p, p, t, v, v, q)], dim=-1)


def jitter_factors(batch: int, generator: Optional[torch.Generator] = None, device=None,
                   brightness: float = 64.0 / 255, contrast: float = 0.25,
                   saturation: float = 0.25, hue: float = 0.04) -> Dict[str, torch.Tensor]:
    """One uniform draw per video of each factor, (B,) each."""
    def uniform(lo, hi):
        return lo + (hi - lo) * torch.rand(batch, generator=generator, device=device)

    return {"brightness": uniform(max(0, 1 - brightness), 1 + brightness),
            "contrast": uniform(max(0, 1 - contrast), 1 + contrast),
            "saturation": uniform(max(0, 1 - saturation), 1 + saturation),
            "hue": uniform(-hue, hue)}


def color_jitter_video(video: torch.Tensor, factors: Optional[Dict[str, torch.Tensor]] = None,
                       generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """Jitter a (B, T, H, W, 3) video in [0, 1]. ``factors`` ((B,) tensors
    'brightness', 'contrast', 'saturation', 'hue') are drawn from
    ``generator`` by :func:`jitter_factors` unless given."""
    b = video.shape[0]
    if factors is None:
        factors = jitter_factors(b, generator, video.device)
    bf, cf, sf, hf = (factors[k].to(video.device, video.dtype).reshape(b, 1, 1, 1)
                      for k in ("brightness", "contrast", "saturation", "hue"))
    v = (video * bf[..., None]).clamp(0, 1)
    # torchvision contrast: blend with the mean of the grayscale clip
    gray = 0.299 * v[..., 0] + 0.587 * v[..., 1] + 0.114 * v[..., 2]
    mean = gray.mean(dim=(1, 2, 3), keepdim=True)[..., None]
    v = (cf[..., None] * v + (1 - cf[..., None]) * mean).clamp(0, 1)
    h, s, val = _rgb_to_hsv(v)
    s = (s * sf).clamp(0, 1)
    h = torch.remainder(h + hf, 1.0)
    return _hsv_to_rgb(h, s, val).clamp(0, 1)


def _np_adjust(clip: np.ndarray, brightness: float, contrast: float, saturation: float,
               hue: float, rng: np.random.RandomState) -> np.ndarray:
    """Color jitter of a clip (..., H, W, 3) in [0, 1], one draw for all of it:
    brightness, contrast around the clip's mean, saturation around each
    pixel's gray, then a hue rotation in YIQ space; clipped to [0, 1]."""
    b = 1.0 + rng.uniform(-brightness, brightness)
    c = 1.0 + rng.uniform(-contrast, contrast)
    s = 1.0 + rng.uniform(-saturation, saturation)
    h = rng.uniform(-hue, hue)
    out = clip * b
    mean = out.mean(axis=(-3, -2, -1), keepdims=True)
    out = (out - mean) * c + mean
    gray = out.mean(axis=-1, keepdims=True)
    out = (out - gray) * s + gray
    if hue:
        theta = 2 * np.pi * h
        cs, sn = np.cos(theta), np.sin(theta)
        to_yiq = np.array([[0.299, 0.587, 0.114],
                           [0.596, -0.274, -0.322],
                           [0.211, -0.523, 0.312]], np.float32)
        rot = np.array([[1, 0, 0], [0, cs, -sn], [0, sn, cs]], np.float32)
        out = out @ (np.linalg.inv(to_yiq) @ rot @ to_yiq).T
    return np.clip(out, 0.0, 1.0)


def augment_frame_pair(rng: np.random.RandomState, source: np.ndarray, driving: np.ndarray,
                       horizontal_flip: bool = True, time_flip: bool = True,
                       brightness: float = 0.1, contrast: float = 0.1,
                       saturation: float = 0.1, hue: float = 0.1
                       ) -> Tuple[np.ndarray, np.ndarray]:
    """(source, driving) (H, W, 3) floats in [0, 1] -> the augmented pair
    (augmentation.py:91-103 RandomFlip, :217-345 ColorJitter)."""
    if time_flip and rng.rand() < 0.5:
        source, driving = driving, source
    if horizontal_flip and rng.rand() < 0.5:
        source = source[:, ::-1]
        driving = driving[:, ::-1]
    clip = _np_adjust(np.stack([source, driving]), brightness, contrast, saturation, hue, rng)
    return clip[0], clip[1]
