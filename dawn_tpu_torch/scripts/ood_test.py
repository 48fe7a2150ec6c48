"""Batch OOD testing — the run_ood_test/*.sh pipeline as one command.

    python -m dawn_tpu_torch.scripts.ood_test --pairs pairs.txt --resolution 128 \\
        [--both-ckpt .../pbnet_both/checkpoint_100000.pth.tar |
         --pose-ckpt ... --blink-ckpt ...] \\
        --dawn-ckpt DAWN_128.pth --lfg-ckpt LFG_128.pth --hubert-dir ... [--metrics]

Port of ``scripts/ood_test.py``, with its flags plus ``--device`` ('cpu' to
run on the CPU; the card is the default). For each (image, audio) pair, and
``--samples-per-pair`` times with the seeds ``seed``, ``seed + 1``, ..., the
four stages of :class:`~dawn_tpu_torch.pipeline.generator.VideoGenerator`
run (the init state, HuBERT, the PBnet drives from the joint ``--both-ckpt``
through ``pipeline.pose_blink.run`` or from the separate pose and blink
models, then the DM sample and the LFG decode, whose temporal attentions
run K1), each stage's ``.npy`` files under ``<cache>/<tag>/`` and the
frames and mp4 under ``<output>/<tag>/`` (``<output>/s<i>/<tag>/`` for
several samples), tag = ``<image stem>_<audio stem>``. HuBERT, the PBnets
and the video model are built once and stay resident across pairs.
``--metrics`` then writes ``<output>/metrics.json``
(:func:`dawn_tpu_torch.evaluate.quality.evaluate_generated_batch`: Frechet,
diversity, multimodality, identity accuracy, the lip-sync proxy against
``--real-dir``'s ``<tag>.mp4`` and the AV-sync proxy against each clip's
own HuBERT features).

pairs.txt holds one "image_path audio_path" per line (default: the demo
pair real_female_1.jpeg WRA_MarcoRubio_000.wav).
"""

import argparse
import json
import os
import time
from typing import List, Optional


def parse_args(argv: Optional[List[str]] = None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--pairs", default=None,
                    help="file of 'image audio' lines; default: demo pair")
    ap.add_argument("--image", default="real_female_1.jpeg")
    ap.add_argument("--audio", default="WRA_MarcoRubio_000.wav")
    ap.add_argument("--output", default="output/ood_test")
    ap.add_argument("--cache", default="cache")
    ap.add_argument("--resolution", type=int, default=128,
                    help="128/256 in production (the shipped checkpoints); other sizes run "
                         "the assetless random-weight topology (tests)")
    ap.add_argument("--sampling-step", type=int, default=20)
    ap.add_argument("--win-width", type=int, default=40)
    ap.add_argument("--bucket-frames", type=int, default=25)
    ap.add_argument("--both-ckpt", default=None,
                    help="joint pose+blink PBnet checkpoint (reemb5 8-d)")
    ap.add_argument("--pose-ckpt", default=None)
    ap.add_argument("--blink-ckpt", default=None)
    ap.add_argument("--dawn-ckpt", default=None)
    ap.add_argument("--lfg-ckpt", default=None)
    ap.add_argument("--hubert-dir", default=None)
    ap.add_argument("--seed", type=int, default=1234)
    ap.add_argument("--metrics", action="store_true",
                    help="after generating, write metrics.json (Frechet / diversity / "
                         "multimodality / identity accuracy / lip-sync) over the batch")
    ap.add_argument("--samples-per-pair", type=int, default=1,
                    help=">=2 enables the multimodality metric (several generations of "
                         "the same conditioning)")
    ap.add_argument("--real-dir", default=None,
                    help="folder of GT videos named <tag>.mp4 for the Frechet reference "
                         "set + mouth lip-sync proxy")
    ap.add_argument("--device", default=None, help="'cpu' to run on the CPU (default: the card)")
    return ap.parse_args(argv)


def read_pairs(args) -> List[List[str]]:
    if args.pairs:
        with open(args.pairs) as f:
            return [ln.split() for ln in f if ln.strip()]
    return [[args.image, args.audio]]


def generator_paths(args):
    """The pipeline's assets from the flags; each absent one falls back to
    seeded random weights."""
    from dawn_tpu_torch.pipeline.generator import GeneratorPaths
    return GeneratorPaths(
        hubert_dir=args.hubert_dir or GeneratorPaths.hubert_dir,
        pbnet_pose_ckpt=args.pose_ckpt or GeneratorPaths.pbnet_pose_ckpt,
        pbnet_blink_ckpt=args.blink_ckpt or GeneratorPaths.pbnet_blink_ckpt,
        dawn_ckpt=args.dawn_ckpt, lfg_ckpt=args.lfg_ckpt)


def pair_tag(image: str, audio: str) -> str:
    stem = lambda p: os.path.splitext(os.path.basename(p))[0]  # noqa: E731
    return f"{stem(image)}_{stem(audio)}"


def main(argv: Optional[List[str]] = None) -> dict:
    """Run the batch; returns {'seconds': each sample's seconds, 'report':
    the metrics report or None}."""
    args = parse_args(argv)
    pairs = read_pairs(args)

    import numpy as np

    from dawn_tpu_torch.pipeline import pose_blink
    from dawn_tpu_torch.pipeline.generator import VideoGenerator

    paths = generator_paths(args)
    # the models stay resident across (pair, sample) iterations
    resident = {"_hubert": None, "_pbnet": {}, "_video_model": None}
    gen_videos, gen_labels, gen_audio, src_images, real_videos = [], [], [], [], []
    seconds = []
    for i, (image, audio) in enumerate(pairs):
        tag = pair_tag(image, audio)
        cache = os.path.join(args.cache, tag)
        name = os.path.splitext(os.path.basename(image))[0]
        for s_idx in range(args.samples_per_pair):
            print(f"[{i + 1}/{len(pairs)}] {tag} sample {s_idx}", flush=True)
            t0 = time.perf_counter()
            # outputs keyed by the (image, audio) tag: the generator keys by
            # image name only, so two pairs sharing an image would collide
            outdir = os.path.join(args.output, tag if args.samples_per_pair == 1
                                  else os.path.join(f"s{s_idx}", tag))
            img_dir = os.path.join(outdir, name, "img")
            if os.path.isdir(img_dir):
                # stale PNGs of a longer earlier run would leak into the metrics
                for f in os.listdir(img_dir):
                    os.remove(os.path.join(img_dir, f))
            gen = VideoGenerator(audio, image, outdir, cache, args.resolution, paths,
                                 win_width=args.win_width, sampling_step=args.sampling_step,
                                 bucket_frames=args.bucket_frames, seed=args.seed + s_idx,
                                 device=args.device)
            for k, v in resident.items():
                setattr(gen, k, v)
            gen.extract_pose()
            gen.process_audio()
            if args.both_ckpt:
                pose_blink.run(os.path.join(cache, "target_audio.npy"), cache, cache,
                               ckpt=args.both_ckpt, seed=args.seed + s_idx, device=args.device)
            else:
                gen.generate_pose_blink()
            out = gen.generate_final_video()
            resident = {k: getattr(gen, k) for k in resident}
            seconds.append(time.perf_counter() - t0)
            print(f"  -> {out} ({seconds[-1]:.1f}s)", flush=True)
            if args.metrics:
                gen_videos.append(load_frames(img_dir, args.resolution))
                gen_labels.append(i)
                # the clip's driving HuBERT features feed the AV-sync proxy
                gen_audio.append(np.load(os.path.join(cache, "target_audio.npy")))
        if args.metrics:
            src_images.append(load_image(image, args.resolution))
            if args.real_dir:
                real = load_video(os.path.join(args.real_dir, f"{tag}.mp4"), args.resolution)
                real_videos.extend([real] * args.samples_per_pair)

    report = None
    if args.metrics:
        report = emit_metrics(args.output, resident["_video_model"], gen_videos, gen_labels,
                              src_images, real_videos, gen_audio)
    return {"seconds": seconds, "report": report}


def load_image(path: str, size: int):
    import numpy as np
    from PIL import Image
    img = Image.open(path).convert("RGB").resize((size, size), Image.BILINEAR)
    return np.asarray(img, np.float32) / 255.0


def load_frames(img_dir: str, size: int):
    """The PNG frames of a generated video, (T, size, size, 3) in [0, 1]."""
    import cv2
    import numpy as np
    frames = []
    for f in sorted(os.listdir(img_dir)):
        if f.endswith(".png"):
            bgr = cv2.imread(os.path.join(img_dir, f))
            if bgr.shape[:2] != (size, size):      # stale frames of a run at another size
                bgr = cv2.resize(bgr, (size, size))
            frames.append(cv2.cvtColor(bgr, cv2.COLOR_BGR2RGB))
    return np.asarray(frames, np.float32) / 255.0


def load_video(path: str, size: int):
    """An mp4's frames, (T, size, size, 3) in [0, 1]."""
    import cv2
    import numpy as np
    cap = cv2.VideoCapture(path)
    frames = []
    while True:
        ok, bgr = cap.read()
        if not ok:
            break
        if bgr.shape[:2] != (size, size):
            bgr = cv2.resize(bgr, (size, size))
        frames.append(cv2.cvtColor(bgr, cv2.COLOR_BGR2RGB))
    cap.release()
    return np.asarray(frames, np.float32) / 255.0


def emit_metrics(output: str, video_model, gen_videos, gen_labels, src_images, real_videos,
                 gen_audio) -> dict:
    import numpy as np
    from dawn_tpu_torch.evaluate.quality import evaluate_generated_batch

    t = min(v.shape[0] for v in gen_videos)
    videos = np.stack([v[:t] for v in gen_videos])
    real = np.stack([r[:t] for r in real_videos]) if real_videos else None
    audio = (np.stack([a[:t] for a in gen_audio])
             if gen_audio and all(a.shape[0] >= t for a in gen_audio) else None)
    report = evaluate_generated_batch(video_model.generator, videos, np.asarray(gen_labels),
                                      np.stack(src_images), real_videos=real, audio_feats=audio)
    path = os.path.join(output, "metrics.json")
    with open(path, "w") as f:
        json.dump(report, f, indent=2)
    print(f"metrics -> {path}")
    print(json.dumps({k: v for k, v in report.items() if not isinstance(v, (dict, list))},
                     indent=2))
    return report


if __name__ == "__main__":
    main()
