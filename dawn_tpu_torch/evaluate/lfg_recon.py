"""LFG reconstruction evaluation — the reference's golden-output test.

Port of ``dawn_tpu/evaluate/lfg_recon.py`` (LFG/test_flowautoenc_hdtf_video.py
:1-120): run the frozen FlowAE over held-out videos on its device
(``FlowAE.reconstruct_video`` of every frame from the first), record each
video's L1 reconstruction loss to JSON, and optionally write side-by-side
(driving | reconstruction) mp4s.
"""

from __future__ import annotations

import json
import os
from typing import Dict, Iterable, Optional

import numpy as np
import torch


@torch.no_grad()
def evaluate_reconstruction(flow_ae, video_iter: Iterable, json_path: str,
                            video_dir: Optional[str] = None,
                            max_videos: int = 10) -> Dict[str, float]:
    """video_iter yields (name, frames (T, H, W, 3) float32 [0,1]); returns
    and writes {name: mean |reconstruction - frames|}."""
    device = flow_ae.generator.final.weight.device
    losses: Dict[str, float] = {}
    for i, (name, frames) in enumerate(video_iter):
        if i >= max_videos:
            break
        vid = torch.as_tensor(np.asarray(frames, np.float32), device=device)
        out = flow_ae.reconstruct_video(vid[:1], vid[None])
        pred = out["real_out_vid"][0].float().cpu().numpy()
        losses[name] = float(np.abs(pred - frames).mean())
        if video_dir is not None:
            _write_side_by_side(os.path.join(video_dir, f"{name}.mp4"), frames, pred)

    os.makedirs(os.path.dirname(os.path.abspath(json_path)), exist_ok=True)
    with open(json_path, "w") as f:
        json.dump(losses, f, indent=2)
    return losses


def _write_side_by_side(path: str, gt: np.ndarray, pred: np.ndarray, fps: int = 25) -> None:
    import cv2
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    t, h, w, _ = gt.shape
    writer = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*"mp4v"), fps, (w * 2, h))
    for i in range(t):
        frame = np.concatenate([gt[i], pred[i]], axis=1)
        frame = (np.clip(frame, 0, 1) * 255).astype(np.uint8)
        writer.write(cv2.cvtColor(frame, cv2.COLOR_RGB2BGR))
    writer.release()
