"""LFG reconstruction eval driver — the reference's golden-output test.

    python -m dawn_tpu_torch.scripts.eval_lfg --lfg-ckpt LFG_128_1000ep.pth \\
        --frames-dir <video tree> [--img-size 128] [--num-videos 10]

Port of ``scripts/eval_lfg.py`` (LFG/test_flowautoenc_hdtf_video.py and its
256/CREMA variants), with its flags plus ``--device`` ('cpu' to run on the
CPU; the card is the default): the FlowAE at the released LFG widths (those
of every shipped LFG config) loads the checkpoint strictly
(``FlowAE.load_reference_checkpoint``) and reconstructs the held-out videos
of the tree (the HDTF test split where the tree has it, else every video)
frame by frame from the first, on the device; each video's L1 goes to
``<workdir>/recon_losses.json`` and, with ``--write-videos``, a side-by-side
(driving | reconstruction) mp4 to ``<workdir>/videos/``.
"""

import argparse
import os
from typing import List, Optional


def main(argv: Optional[List[str]] = None) -> dict:
    """Run the evaluation; returns {video: L1}."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--lfg-ckpt", required=True)
    ap.add_argument("--frames-dir", required=True)
    ap.add_argument("--img-size", type=int, default=128)
    ap.add_argument("--num-videos", type=int, default=10)
    ap.add_argument("--workdir", default="runs/lfg_eval")
    ap.add_argument("--write-videos", action="store_true")
    ap.add_argument("--device", default=None, help="'cpu' to run on the CPU (default: the card)")
    args = ap.parse_args(argv)

    from dawn_tpu_torch import resolve_device
    from dawn_tpu_torch.evaluate.lfg_recon import evaluate_reconstruction
    from dawn_tpu_torch.models.lfg.flow_ae import FlowAE
    from dawn_tpu_torch.train.data import FramesDataset

    flow_ae = FlowAE()
    flow_ae.load_reference_checkpoint(args.lfg_ckpt)
    flow_ae.to(resolve_device(args.device)).eval()

    ds = FramesDataset(args.frames_dir, image_size=args.img_size)

    def video_iter():
        for i in ds.held_out():
            s = ds.sample(i)
            yield s["name"], s["video"]

    losses = evaluate_reconstruction(
        flow_ae, video_iter(), json_path=os.path.join(args.workdir, "recon_losses.json"),
        video_dir=os.path.join(args.workdir, "videos") if args.write_videos else None,
        max_videos=args.num_videos)
    mean = sum(losses.values()) / max(len(losses), 1)
    print(f"{len(losses)} videos, mean L1 {mean:.5f}")
    return losses


if __name__ == "__main__":
    main()
