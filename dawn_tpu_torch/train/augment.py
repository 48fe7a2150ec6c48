"""Video color jitter of the DM training input.

Port of ``dawn_tpu/train/augment.py:16-73``: the reference's torchvision
ColorJitter on the whole clip (brightness +-64/255, contrast +-0.25,
saturation +-0.25, hue +-0.04), one random draw per video shared by all its
frames, applied in that order. It runs on the video's device.
"""

from __future__ import annotations

from typing import Dict, Optional

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
