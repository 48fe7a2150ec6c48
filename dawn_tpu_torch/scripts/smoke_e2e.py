"""End-to-end smoke drive: one image + conditions -> video frames.

The port's counterpart of ``scripts/smoke_e2e.py``:

    python -m dawn_tpu_torch.scripts.smoke_e2e [--img-size 64] [--frames 8] [--steps 2] \\
        [--attn full|local] [--device cpu] [--out DIR]

Runs the whole ``FlowDiffusion.sample_one_video`` (the DDIM loop and the
batched LFG decode) with seeded random weights (``torch.manual_seed(0)``, the
model in f32 as the JAX script's default config) on the JAX script's inputs
(``numpy.random.RandomState(0)``). Prints the per-stage timings: the model
build, a cold first call (on the card it builds the kernels), then a warm
call, each ending in a synchronize of the card. Writes the first frames as PNG and checks that
they are finite, then prints the JAX script's OK line. ``--device`` takes the
place of the JAX ``--platform``: the card unless ``--device cpu``. With
``--attn local`` every temporal attention at T <= 256 runs K1, ten a DDIM
step. ``--out`` defaults to ``dawn_smoke`` under the temporary directory.
``main`` returns the timings, the K1 launches of each call and the video.
"""

from __future__ import annotations

import argparse
import os
import tempfile
import time

import numpy as np
import torch

from dawn_tpu_torch import resolve_device
from dawn_tpu_torch.models.dm.flow_diffusion import FlowDiffusion, FlowDiffusionConfig
from dawn_tpu_torch.ops import local_attention as la


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--img-size", type=int, default=64)
    ap.add_argument("--frames", type=int, default=8)
    ap.add_argument("--steps", type=int, default=2)
    ap.add_argument("--device", default=None, help="torch device (default: the card)")
    ap.add_argument("--attn", default="full", choices=["full", "local"])
    ap.add_argument("--out", default=os.path.join(tempfile.gettempdir(), "dawn_smoke"))
    return ap.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    device = resolve_device(args.device)
    name = torch.cuda.get_device_name(device) if device.type == "cuda" else "CPU"
    print(f"device={device} ({name})")

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    cfg = FlowDiffusionConfig(img_size=args.img_size, sampling_timesteps=args.steps,
                              attn_mode=args.attn, dtype=torch.float32)
    t0 = time.time()
    torch.manual_seed(0)
    model = FlowDiffusion(cfg, device=device)
    sync()
    init_s = time.time() - t0
    print(f"init_variables: {init_s:.1f}s")

    b, t, s = 1, args.frames, args.img_size
    rng = np.random.RandomState(0)
    inputs = dict(sample_img=rng.rand(b, s, s, 3), audio_hubert=rng.randn(b, t, 1024),
                  pose=rng.randn(b, t, 6), eye=rng.rand(b, t, 2),
                  bbox=np.asarray([[s * 0.25, s * 0.75, s * 0.25, s * 0.75, s, s]]))
    inputs = {k: torch.as_tensor(v, dtype=torch.float32) for k, v in inputs.items()}

    def call(seed):
        before = la.local_attention_packed.launches
        t0 = time.time()
        out = model.sample_one_video(**inputs,
                                     generator=torch.Generator(device).manual_seed(seed))
        sync()
        return out, time.time() - t0, la.local_attention_packed.launches - before

    out, first_s, first_k1 = call(1)
    vid = out["sample_out_vid"].cpu().numpy()
    print(f"first call (cold): {first_s:.1f}s, K1 x {first_k1}")
    out, second_s, second_k1 = call(2)
    print(f"second call (warm): {second_s:.2f}s, K1 x {second_k1}")

    if vid.shape != (b, t, s, s, 3):
        raise RuntimeError(f"video shape {vid.shape}")
    if not np.isfinite(vid).all():
        raise RuntimeError("non-finite frames!")
    grid = out["sample_vid_grid"]
    print(f"sample_out_vid shape={vid.shape} range=({vid.min():.3f},{vid.max():.3f})")
    print(f"flow grid range=({grid.min().item():.3f},{grid.max().item():.3f})")

    import cv2
    os.makedirs(args.out, exist_ok=True)
    frames = [(np.clip(vid[0, i], 0, 1) * 255).astype(np.uint8) for i in range(min(t, 4))]
    for i, frame in enumerate(frames):
        path = os.path.join(args.out, f"frame_{i:03d}.png")
        if not cv2.imwrite(path, cv2.cvtColor(frame, cv2.COLOR_RGB2BGR)):
            raise IOError(f"could not write {path}")
    print(f"wrote frames to {args.out}")
    print("E2E SMOKE OK")
    return {"init_s": init_s, "first_s": first_s, "second_s": second_s,
            "k1_launches": (first_k1, second_k1), "video": vid}


if __name__ == "__main__":
    main()
