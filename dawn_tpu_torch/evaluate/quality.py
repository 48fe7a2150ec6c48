"""Video quality harness: FVD-style Frechet metrics and the lip-sync and
AV-sync proxies.

Port of ``dawn_tpu/evaluate/quality.py``. The feature extractor is the
frozen LFG encoder (the port's ``LFGGenerator.compute_fea``, the 256-channel
bottleneck the diffusion model is conditioned on), run on the generator's
device in batches of 64 frames; per frame the spatial mean and the spatial
population standard deviation of the bottleneck. The standard FVD backbone
is :mod:`dawn_tpu_torch.evaluate.i3d`. Everything past the features is host
numpy, the JAX package's code: Frechet distances, the mouth-region L1 and
SSIM (masked by the rasterised mouth-landmark box of
``train/train_dm.generate_mouth_mask``, or a lower-centre crop), and the
audio-offset sweep of mouth motion against the driving audio features.

The functions take the port's generator module (which holds its weights)
where the JAX ones take a flax module and its variables.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from dawn_tpu_torch.evaluate.metrics import (diversity_multimodality, frechet_distance,
                                             nearest_centroid_probs, recognition_accuracy)


# ------------------------------------------------------------- features

@torch.no_grad()
def lfg_frame_features(generator, videos: np.ndarray, batch: int = 64) -> np.ndarray:
    """Per-frame LFG-encoder features.

    videos: (N, T, H, W, 3) float32 in [0, 1]. Returns (N*T, 2*C) f32:
    spatial mean ++ spatial (population) std of the encoder bottleneck per
    frame, computed on the generator's device ``batch`` frames at a time.
    """
    device = generator.final.weight.device
    n, t = videos.shape[:2]
    frames = videos.reshape((n * t,) + videos.shape[2:])
    out = []
    for i in range(0, len(frames), batch):
        x = torch.as_tensor(np.asarray(frames[i: i + batch], np.float32), device=device)
        f = generator.compute_fea(x).float()
        out.append(torch.cat([f.mean(dim=(1, 2)), f.std(dim=(1, 2), correction=0)], -1)
                   .cpu().numpy())
    return np.concatenate(out, axis=0)


def video_features(frame_feats: np.ndarray, n_videos: int) -> np.ndarray:
    """(N*T, D) frame features -> (N, 2D) per-video features
    (temporal mean ++ temporal std) — the FVD-style sample unit."""
    f = frame_feats.reshape(n_videos, -1, frame_feats.shape[-1])
    return np.concatenate([f.mean(axis=1), f.std(axis=1)], axis=-1)


# ------------------------------------------------------------ lip proxy

def mouth_mask_images(mouth_lmk: np.ndarray, img_size: int) -> np.ndarray:
    """(N, T, K, 2) pixel landmarks -> (N, T, H, W, 1) binary mouth-bbox
    masks at image resolution (train_dm.generate_mouth_mask at scale 1)."""
    from dawn_tpu_torch.train.train_dm import generate_mouth_mask
    return generate_mouth_mask(torch.as_tensor(np.asarray(mouth_lmk, np.float32)),
                               img_size, img_size).numpy()


def _ssim2d(a: np.ndarray, b: np.ndarray, c1=0.01 ** 2, c2=0.03 ** 2,
            win: int = 7) -> np.ndarray:
    """Per-pixel SSIM map over (..., H, W) grayscale in [0,1] with a uniform
    window (scipy-free separable box filter)."""
    def box(x):
        k = np.ones(win) / win
        x = np.apply_along_axis(lambda r: np.convolve(r, k, mode="same"), -1, x)
        return np.apply_along_axis(lambda r: np.convolve(r, k, mode="same"),
                                   -2, x)

    mu_a, mu_b = box(a), box(b)
    va = box(a * a) - mu_a ** 2
    vb = box(b * b) - mu_b ** 2
    cov = box(a * b) - mu_a * mu_b
    return ((2 * mu_a * mu_b + c1) * (2 * cov + c2)
            / ((mu_a ** 2 + mu_b ** 2 + c1) * (va + vb + c2)))


def lip_sync_proxy(gen: np.ndarray, gt: np.ndarray,
                   mouth_lmk: Optional[np.ndarray] = None) -> Dict[str, float]:
    """Mouth-region L1 and SSIM between generated and GT videos.

    gen/gt: (N, T, H, W, 3) in [0, 1]. mouth_lmk: (N, T, K, 2) pixel coords
    (landmarks 48:67); when None the center-lower-third crop is used (the
    3DDFA-failure fallback region).
    """
    mask = _mouth_region_mask(gt.shape, mouth_lmk)
    denom = max(float(mask.sum() * 3), 1.0)
    l1 = float((np.abs(gen - gt) * mask).sum() / denom)
    gray_g = gen.mean(-1)
    gray_t = gt.mean(-1)
    smap = _ssim2d(gray_g, gray_t)
    ssim = float((smap * mask[..., 0]).sum() / max(float(mask.sum()), 1.0))
    return {"mouth_l1": l1, "mouth_ssim": ssim}


def _mouth_region_mask(shape4, mouth_lmk: Optional[np.ndarray]) -> np.ndarray:
    """(N, T, H, W, 1) mouth mask: landmark bbox when available, else the
    center-lower-third fallback crop (the 3DDFA-failure region)."""
    h, w = shape4[2], shape4[3]
    if mouth_lmk is not None:
        return mouth_mask_images(mouth_lmk, h)
    mask = np.zeros(tuple(shape4[:4]) + (1,), np.float32)
    mask[:, :, int(h * 0.55): int(h * 0.85), int(w * 0.3): int(w * 0.7)] = 1.0
    return mask


def av_sync_proxy(videos: np.ndarray, audio_feats: np.ndarray,
                  mouth_lmk: Optional[np.ndarray] = None,
                  max_offset: int = 8) -> Dict[str, float]:
    """Offset-sweep audio <-> mouth-motion correlation.

    A checkpoint-free AV-sync signal stronger than mouth-SSIM: audio
    activity a_t = ||f_{t+1} - f_t||_2 over the per-frame audio features
    (HuBERT at 25 fps) should co-vary with mouth-region motion energy
    m_t = mean |I_{t+1} - I_t| over the mouth mask, and should co-vary BEST
    at offset 0 — shifted audio must score worse (sanity-tested in the
    JAX package's tests/test_quality.py). Reports the Pearson correlation at
    offset 0, the argmax offset over [-max_offset, max_offset] (a synced clip gives
    0; a constant lag shows up here), and the margin of the offset-0 score
    over the mean |offset| >= 3 score.

    videos: (N, T, H, W, 3) in [0, 1]; audio_feats: (N, T, D).
    """
    n, t = videos.shape[:2]
    mask = _mouth_region_mask(videos.shape, mouth_lmk)[:, 1:, ..., 0]
    dm = np.abs(np.diff(videos.mean(-1), axis=1))            # (N, T-1, H, W)
    m = ((dm * mask).sum((-1, -2))
         / np.maximum(mask.sum((-1, -2)), 1.0))              # (N, T-1)
    a = np.linalg.norm(np.diff(np.asarray(audio_feats, np.float32), axis=1),
                       axis=-1)                              # (N, T-1)

    def corr(x, y):
        x = x - x.mean()
        y = y - y.mean()
        d = np.sqrt((x * x).sum() * (y * y).sum())
        return float((x * y).sum() / d) if d > 0 else 0.0

    corrs = {}
    for off in range(-max_offset, max_offset + 1):
        vals = []
        for i in range(n):
            if off >= 0:              # audio leads video by `off` frames
                x, y = a[i, off:], m[i, : t - 1 - off]
            else:
                x, y = a[i, : t - 1 + off], m[i, -off:]
            if x.shape[0] >= 4:
                vals.append(corr(x, y))
        corrs[off] = float(np.mean(vals)) if vals else 0.0
    # ties break toward |offset| 0: degenerate/flat correlations report a
    # 0 offset, not whichever extreme happens to iterate first
    best = max(corrs, key=lambda d: (corrs[d], -abs(d)))
    far = [v for d, v in corrs.items() if abs(d) >= 3]
    return {"av_corr": corrs[0], "av_offset": int(best),
            "av_margin": corrs[0] - float(np.mean(far)) if far else 0.0}


def evaluate_quality(generator, real: np.ndarray, fake: np.ndarray,
                     mouth_lmk: Optional[np.ndarray] = None,
                     audio_feats: Optional[np.ndarray] = None) -> Dict[str, float]:
    """The full quality report for a set of (real, generated) videos."""
    fr = lfg_frame_features(generator, real)
    ff = lfg_frame_features(generator, fake)
    out = {
        "fvd_lfg_frames": frechet_distance(fr, ff),
        "l1": float(np.abs(fake - real).mean()),
    }
    if real.shape[0] >= 2:      # a Frechet over videos needs two of them
        out["fvd_lfg_videos"] = frechet_distance(video_features(fr, real.shape[0]),
                                                 video_features(ff, fake.shape[0]))
    out.update(lip_sync_proxy(fake, real, mouth_lmk))
    if audio_feats is not None:
        out.update(av_sync_proxy(fake, audio_feats, mouth_lmk))
    return out


def evaluate_generated_batch(generator, videos: np.ndarray,
                             labels: np.ndarray, source_images: np.ndarray,
                             real_videos: Optional[np.ndarray] = None,
                             mouth_lmk: Optional[np.ndarray] = None,
                             audio_feats: Optional[np.ndarray] = None) -> Dict:
    """One-command metrics for an OOD generation batch (``python -m
    dawn_tpu_torch.scripts.ood_test --metrics``): Frechet + diversity +
    multimodality + accuracy + lip-sync, per identity and aggregate.

    videos: (N, T, H, W, 3) generated clips in [0, 1]; labels: (N,) identity
    index of each clip (>= 2 clips per identity enables multimodality);
    source_images: (num_identities, H, W, 3); real_videos: optional GT clips
    aligned with ``videos`` for the Frechet reference set and the mouth
    proxy (without GT, the reference set is the source-image features —
    golden-output pattern: LFG/test_flowautoenc_hdtf_video.py:57).
    """
    labels = np.asarray(labels, np.int64)
    num_ids = int(labels.max()) + 1
    frame_feats = lfg_frame_features(generator, videos)
    vid_feats = video_features(frame_feats, videos.shape[0])

    src_feats = lfg_frame_features(generator, source_images[:, None])

    report: Dict = {"per_identity": {}}
    t = videos.shape[1]
    frame_labels = np.repeat(labels, t)

    if real_videos is not None:
        real_feats = lfg_frame_features(generator, real_videos)
        report["frechet_frames_vs_real"] = frechet_distance(
            real_feats, frame_feats)
        report.update({f"lip_{k}": v for k, v in
                       lip_sync_proxy(videos, real_videos, mouth_lmk).items()})
    else:
        report["lip_note"] = ("no GT videos supplied - mouth proxy needs "
                              "--real-dir")
    if audio_feats is not None:
        # AV-sync needs no GT video — it correlates the generated mouth
        # motion against the driving audio features directly
        report.update({f"sync_{k}": v for k, v in
                       av_sync_proxy(videos, audio_feats, mouth_lmk).items()})

    div, mm = diversity_multimodality(
        vid_feats, labels, num_ids,
        multimodality_times=min(20, max(1, np.bincount(labels).min() - 1) * 4))
    report["diversity"] = div
    report["multimodality"] = mm

    # identity-recognition accuracy: source-image features are the
    # centroids; a generated frame should land nearest its own identity
    probs = nearest_centroid_probs(src_feats, np.arange(num_ids),
                                   frame_feats, num_ids)
    acc, confusion = recognition_accuracy(probs, frame_labels)
    report["identity_accuracy"] = acc
    report["identity_confusion"] = confusion.tolist()

    for c in range(num_ids):
        sel = labels == c
        rep_c: Dict = {
            "n_clips": int(sel.sum()),
            "frechet_frames_vs_source": frechet_distance(
                np.repeat(src_feats[c: c + 1], 8, axis=0),
                frame_feats[np.repeat(sel, t)]) if sel.any() else None,
        }
        if real_videos is not None and sel.any():
            rep_c.update({f"lip_{k}": v for k, v in lip_sync_proxy(
                videos[sel], real_videos[sel],
                None if mouth_lmk is None else mouth_lmk[sel]).items()})
        if audio_feats is not None and sel.any():
            rep_c.update({f"sync_{k}": v for k, v in av_sync_proxy(
                videos[sel], audio_feats[sel],
                None if mouth_lmk is None else mouth_lmk[sel]).items()})
        report["per_identity"][int(c)] = rep_c
    return report
