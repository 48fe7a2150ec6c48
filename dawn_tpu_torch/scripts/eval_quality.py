"""Quality evaluation: FVD-style Frechet, lip-sync and AV-sync proxies.

Port of ``scripts/eval_quality.py``, with its flags; its ``--platform``
becomes ``--device`` ('cpu' to run on the CPU; the card is the default).

Dir-compare mode:

    python -m dawn_tpu_torch.scripts.eval_quality --real-dir DIR --fake-dir DIR \\
        [--lfg-ckpt LFG_128.pth] [--i3d-ckpt rgb_imagenet.pt] \\
        [--mouth-lmk-dir DIR] [--out quality.json]

The real and fake dirs hold matching-named .npy videos (T, H, W, 3), uint8
or float in [0, 1]; the mouth-landmark dir matching .npy (T, K, 2) pixel
landmarks. Without ``--lfg-ckpt`` the LFG feature extractor has seeded
random weights (a pipeline smoke: its Frechet numbers compare nothing).
``--i3d-ckpt`` (the public pytorch-i3d Kinetics-400 state dict, read by
:func:`dawn_tpu_torch.weights.i3d_convert.load_i3d`) adds the standard FVD.

``--released`` mode, the quality-parity hand-off:

    python -m dawn_tpu_torch.scripts.eval_quality --released --pairs pairs.txt \\
        --resolution 128 --dawn-ckpt DAWN_128.pth --lfg-ckpt LFG_128_1000ep.pth \\
        --pose-ckpt .../pose/checkpoint.pth.tar --blink-ckpt .../blink/checkpoint.pth.tar \\
        --hubert-dir .../hubert-large-ls960-ft --reference-dir DIR \\
        [--i3d-ckpt rgb_imagenet.pt] [--out released_quality.json]

Each "image audio" pair runs through the port's four-stage
:class:`~dawn_tpu_torch.pipeline.generator.VideoGenerator` (stage 4's
temporal attentions run K1), its models resident across pairs; its frames
are compared against the reference implementation's outputs for the same
pair (``--reference-dir`` holds ``<image>_<audio>.npy`` or ``.mp4``), and
the report carries the Frechet distances (LFG features, and I3D FVD with
``--i3d-ckpt``), each pair's L1, the mouth L1/SSIM and the AV-sync proxy of
both implementations' outputs against the same audio.
"""

import argparse
import glob
import json
import os
import sys
import types
from typing import List, Optional


def _load_videos(d: str):
    import numpy as np
    names, vids = [], []
    for p in sorted(glob.glob(os.path.join(d, "*.npy"))):
        v = np.load(p)
        if v.dtype == np.uint8:
            v = v.astype(np.float32) / 255.0
        names.append(os.path.splitext(os.path.basename(p))[0])
        vids.append(v)
    return names, vids


def load_reference_video(ref_dir: str, tag: str, size: int):
    """The reference implementation's output for a pair: <tag>.npy or
    <tag>.mp4, (T, size, size, 3) f32 in [0, 1]."""
    import numpy as np
    npy = os.path.join(ref_dir, tag + ".npy")
    if os.path.exists(npy):
        v = np.load(npy)
        return v.astype(np.float32) / 255.0 if v.dtype == np.uint8 else v.astype(np.float32)
    mp4 = os.path.join(ref_dir, tag + ".mp4")
    if not os.path.exists(mp4):
        raise FileNotFoundError(
            f"--reference-dir has neither {tag}.npy nor {tag}.mp4 — generate the reference "
            f"outputs with unified_video_generator.py first")
    from dawn_tpu_torch.scripts.ood_test import load_video
    return load_video(mp4, size)


def _write(report: dict, out: str) -> None:
    os.makedirs(os.path.dirname(os.path.abspath(out)), exist_ok=True)
    with open(out, "w") as f:
        json.dump(report, f, indent=2)
    print(json.dumps({k: v for k, v in report.items() if not isinstance(v, dict)}, indent=2))


def _fvd_i3d(args, real, fake) -> float:
    from dawn_tpu_torch.evaluate.i3d import fvd_i3d
    from dawn_tpu_torch.weights.i3d_convert import load_i3d
    return float(fvd_i3d(load_i3d(args.i3d_ckpt, args.device), real, fake))


def run_released(args) -> dict:
    """Generate with the port (released weights when given, seeded random
    ones otherwise), load the reference implementation's videos for the
    same pairs, and write the comparison."""
    import numpy as np

    from dawn_tpu_torch.evaluate.quality import av_sync_proxy, evaluate_quality
    from dawn_tpu_torch.pipeline.generator import VideoGenerator
    from dawn_tpu_torch.scripts.ood_test import (generator_paths, load_frames, pair_tag,
                                                 read_pairs)

    paths = generator_paths(args)
    resident = {"_hubert": None, "_pbnet": {}, "_video_model": None}
    tags, ours, refs, audio = [], [], [], []
    for image, wav in read_pairs(args):
        name = os.path.splitext(os.path.basename(image))[0]
        tag = pair_tag(image, wav)
        cache = os.path.join(args.cache, tag)
        outdir = os.path.join(args.output, tag)
        gen = VideoGenerator(wav, image, outdir, cache, args.resolution, paths,
                             win_width=args.win_width, sampling_step=args.sampling_step,
                             seed=args.seed, device=args.device)
        for k, v in resident.items():
            setattr(gen, k, v)
        gen.run()
        resident = {k: getattr(gen, k) for k in resident}
        tags.append(tag)
        ours.append(load_frames(os.path.join(outdir, name, "img"), args.resolution))
        refs.append(load_reference_video(args.reference_dir, tag, args.resolution))
        audio.append(np.load(os.path.join(cache, "target_audio.npy")))

    tmin = min(min(v.shape[0] for v in ours), min(r.shape[0] for r in refs))
    fake = np.stack([v[:tmin] for v in ours])
    real = np.stack([r[:tmin] for r in refs])
    aud = np.stack([a[:tmin] for a in audio])

    report = evaluate_quality(resident["_video_model"].generator, real, fake, audio_feats=aud)
    # the AV-sync of both implementations' outputs against the same audio:
    # the lip-sync comparison that needs no external SyncNet
    report["av_sync_reference"] = av_sync_proxy(real, aud)
    if args.i3d_ckpt:
        report["fvd_i3d"] = _fvd_i3d(args, real, fake)
    report["per_video_l1"] = {t: float(np.abs(fake[i] - real[i]).mean())
                              for i, t in enumerate(tags)}
    report["assets"] = {
        "dawn_ckpt": args.dawn_ckpt, "lfg_ckpt": args.lfg_ckpt,
        "pose_ckpt": args.pose_ckpt, "blink_ckpt": args.blink_ckpt,
        "hubert_dir": args.hubert_dir, "i3d_ckpt": args.i3d_ckpt,
        "released_weights": bool(args.dawn_ckpt and args.lfg_ckpt),
    }
    if not report["assets"]["released_weights"]:
        print("WARNING: running WITHOUT released checkpoints — numbers are a pipeline "
              "smoke, not the parity claim", file=sys.stderr)
    _write(report, args.out)
    return report


def run_dirs(args) -> dict:
    """Compare matching-named videos of two folders."""
    import numpy as np
    import torch

    from dawn_tpu_torch import resolve_device
    from dawn_tpu_torch.evaluate.quality import evaluate_quality
    from dawn_tpu_torch.models.lfg.generator import LFGGenerator

    real_names, real = _load_videos(args.real_dir)
    fake_names, fake = _load_videos(args.fake_dir)
    common = [n for n in real_names if n in set(fake_names)]
    if not common:
        raise SystemExit("no matching video names between real and fake dirs")
    tmin = min(min(v.shape[0] for v in real), min(v.shape[0] for v in fake))
    ridx = {n: i for i, n in enumerate(real_names)}
    fidx = {n: i for i, n in enumerate(fake_names)}
    R = np.stack([real[ridx[n]][:tmin] for n in common])
    F = np.stack([fake[fidx[n]][:tmin] for n in common])

    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(0)
        generator = LFGGenerator()
    if args.lfg_ckpt:
        from dawn_tpu_torch.weights.checkpoints import load_lfg_generator
        load_lfg_generator(types.SimpleNamespace(generator=generator), args.lfg_ckpt)
    else:
        print("WARNING: no --lfg-ckpt; feature extractor is random-init", file=sys.stderr)
    generator.to(resolve_device(args.device)).eval()

    mouth = None
    if args.mouth_lmk_dir:
        mouth = np.stack([np.load(os.path.join(args.mouth_lmk_dir, n + ".npy"))[:tmin]
                          for n in common])
    report = evaluate_quality(generator, R, F, mouth)
    if args.i3d_ckpt:
        report["fvd_i3d"] = _fvd_i3d(args, R, F)
    # per-video L1, like the reference's JSON fixture
    report["per_video_l1"] = {n: float(np.abs(F[i] - R[i]).mean()) for i, n in enumerate(common)}
    _write(report, args.out)
    return report


def main(argv: Optional[List[str]] = None) -> dict:
    """Run either mode; returns the report it wrote."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--released", action="store_true",
                    help="generate with the port + compare against the reference "
                         "implementation's outputs (see the module docstring)")
    ap.add_argument("--real-dir", default=None)
    ap.add_argument("--fake-dir", default=None)
    ap.add_argument("--lfg-ckpt", default=None)
    ap.add_argument("--i3d-ckpt", default=None,
                    help="pytorch-i3d Kinetics-400 state dict (.pt) for the standard FVD")
    ap.add_argument("--mouth-lmk-dir", default=None)
    ap.add_argument("--out", default="quality.json")
    ap.add_argument("--device", default=None, help="'cpu' to run on the CPU (default: the card)")
    # --released mode
    ap.add_argument("--pairs", default=None, help="file of 'image audio' lines; default: demo pair")
    ap.add_argument("--image", default="real_female_1.jpeg")
    ap.add_argument("--audio", default="WRA_MarcoRubio_000.wav")
    ap.add_argument("--reference-dir", default=None,
                    help="reference implementation outputs: <tag>.mp4/.npy per pair")
    ap.add_argument("--dawn-ckpt", default=None)
    ap.add_argument("--pose-ckpt", default=None)
    ap.add_argument("--blink-ckpt", default=None)
    ap.add_argument("--hubert-dir", default=None)
    ap.add_argument("--resolution", type=int, default=128)
    ap.add_argument("--sampling-step", type=int, default=20)
    ap.add_argument("--win-width", type=int, default=40)
    ap.add_argument("--output", default="output/eval_released")
    ap.add_argument("--cache", default="cache")
    ap.add_argument("--seed", type=int, default=1234)
    args = ap.parse_args(argv)
    if args.released:
        if not args.reference_dir:
            ap.error("--released requires --reference-dir (the reference implementation's "
                     "outputs for the same pairs)")
        return run_released(args)
    if not (args.real_dir and args.fake_dir):
        ap.error("give --real-dir and --fake-dir (or --released)")
    return run_dirs(args)


if __name__ == "__main__":
    main()
