"""PBnet evaluation driver — the evaluate_cvae_norm_eye_pose pipeline.

    python -m dawn_tpu_torch.scripts.eval_pbnet --ckpt .../checkpoint.pth.tar \\
        --kind pose|blink|both --hubert-dir ... --pose-dir ... --eye-dir ... \\
        --length-dict ... [--stgcn | --stgcn-ckpt uestc_rot6d_stgcn.tar]

Port of ``scripts/eval_pbnet.py`` (PBnet/src/evaluate/
evaluate_cvae_norm_eye_pose.py + tvae_eval_norm_eye_pose.py), with its flags
plus ``--device`` ('cpu' to run on the CPU; the card is the default). For
each seed in range(niter) the PBnet (built from its checkpoint's sibling
opt.yaml) generates drives for every held-out HDTF video, on the same clip
windows for every seed, the latents drawn from a CPU ``torch.Generator``
seeded with the seed; the generated and ground-truth sequences go to
``<workdir>/eval_pred/<seed>/<name>.npy`` and ``<workdir>/eval_gt/<seed>/``
(the layout the reference's tables post-processing reads), and the ACTOR
metrics on the raw motion features (Frechet distance, diversity, temporal
smoothness, L1, acceleration) to ``<workdir>/metrics.json``.

``--stgcn`` adds the STGCN suite in the feature space of the port's seeded
random recognizer over the 'dawn_head' graph (labels: per-video
identities); ``--stgcn-ckpt`` loads a reference recognizer ``.tar`` instead
(for motion dumps in its own (V, C) joint layout).
"""

import argparse
import json
import os
from typing import List, Optional


def parse_args(argv: Optional[List[str]] = None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--ckpt", required=True, help="PBnet .pth.tar (opt.yaml sibling)")
    ap.add_argument("--kind", default="pose", choices=["pose", "blink", "both"])
    ap.add_argument("--hubert-dir", required=True)
    ap.add_argument("--pose-dir", required=True)
    ap.add_argument("--eye-dir", required=True)
    ap.add_argument("--length-dict", required=True)
    ap.add_argument("--workdir", default="runs/pbnet_eval")
    ap.add_argument("--niter", type=int, default=3)
    ap.add_argument("--num-frames", type=int, default=100)
    ap.add_argument("--stgcn", action="store_true",
                    help="also score in a seeded dawn_head STGCN feature space "
                         "(stgcn/evaluate.py capability)")
    ap.add_argument("--stgcn-ckpt", default=None,
                    help="reference recognizer .tar (uestc_rot6d_stgcn style); overrides "
                         "--stgcn's random-init model")
    ap.add_argument("--stgcn-classes", type=int, default=None,
                    help="recognizer classes (ckpt) / label count (default: number of "
                         "test videos)")
    ap.add_argument("--device", default=None, help="'cpu' to run on the CPU (default: the card)")
    return ap.parse_args(argv)


def main(argv: Optional[List[str]] = None) -> dict:
    """Run the evaluation; returns {seed: metrics} as written."""
    args = parse_args(argv)

    import numpy as np
    import torch

    from dawn_tpu_torch import resolve_device
    from dawn_tpu_torch.evaluate.metrics import (diversity, frechet_distance, l1_reconstruction,
                                                 mean_acceleration, temporal_smoothness)
    from dawn_tpu_torch.pipeline.pose_blink import load_pbnet_with_opt
    from dawn_tpu_torch.train.data import PBnetPoseDataset

    device = resolve_device(args.device)
    dims = {"pose": (6, 0), "blink": (2, 0), "both": (6, 2)}[args.kind]
    model = load_pbnet_with_opt(args.ckpt, *dims, device)

    dataset = PBnetPoseDataset(args.hubert_dir, args.pose_dir, args.eye_dir, args.length_dict,
                               mode="test", num_frames=args.num_frames)
    print(f"test videos: {len(dataset.names)}")

    evaluation = None
    if args.stgcn or args.stgcn_ckpt:
        from dawn_tpu_torch.evaluate.stgcn_eval import (STGCNEvaluation, load_stgcn,
                                                        make_dawn_head_stgcn)
        num_classes = args.stgcn_classes or len(dataset.names)
        if args.stgcn_ckpt:
            # C and the class count come from the checkpoint; the dumps'
            # values per frame must reshape into its (V, C) joint layout
            recognizer = load_stgcn(args.stgcn_ckpt, device=device)
            feat_dim = sum(dims)
            v_ck = int(recognizer.A.shape[1])
            if feat_dim != v_ck * recognizer.in_channels:
                raise SystemExit(
                    f"--stgcn-ckpt recognizer expects (V={v_ck}, C={recognizer.in_channels}) "
                    f"motions = {v_ck * recognizer.in_channels} values/frame, but --kind "
                    f"{args.kind} dumps {feat_dim}; use motion dumps matching the checkpoint "
                    f"layout or the built-in --stgcn dawn_head recognizer")
            num_classes = recognizer.num_class
        else:
            recognizer = make_dawn_head_stgcn(num_classes, torch.Generator().manual_seed(1234),
                                              device=device)
        evaluation = STGCNEvaluation(recognizer, num_classes)
        v_nodes = int(recognizer.A.shape[1])

    def as_motion(seqs):
        """(T, D) head sequences -> (N, T, V, C) recognizer motions: the
        dawn_head graph scores D scalars as V=D, C=1 nodes (zero-padded to 8
        for pose-only or blink-only runs); a checkpoint's recognizer takes
        its own (V, C) layout."""
        x = np.stack(seqs).astype(np.float32)
        if args.stgcn_ckpt:
            return x.reshape(x.shape[0], x.shape[1], v_nodes, -1)
        if x.shape[-1] < v_nodes:
            x = np.pad(x, ((0, 0), (0, 0), (0, v_nodes - x.shape[-1])))
        return x[..., None]

    metrics_all = {}
    for seed in range(args.niter):
        pred_dir = os.path.join(args.workdir, "eval_pred", str(seed))
        gt_dir = os.path.join(args.workdir, "eval_gt", str(seed))
        os.makedirs(pred_dir, exist_ok=True)
        os.makedirs(gt_dir, exist_ok=True)

        preds, gts = [], []
        gen = torch.Generator().manual_seed(seed)
        # every seed evaluates the same clip windows: only the generation
        # noise varies, so seed-to-seed variance is the sampling's alone
        dataset.rng = np.random.RandomState(0)
        for idx in range(len(dataset.names)):
            s = dataset.sample(idx)
            if args.kind == "pose":
                gt = s["pose"]
            elif args.kind == "blink":
                gt = s["eye"]
            else:
                gt = np.concatenate([s["pose"], s["eye"]], -1)
            with torch.no_grad():
                out = model.generate(torch.from_numpy(gt[None, 0]),
                                     torch.from_numpy(s["hubert"][None]), generator=gen)
            pred = out[0].float().cpu().numpy() + gt[0]
            np.save(os.path.join(pred_dir, s["name"]), pred)
            np.save(os.path.join(gt_dir, s["name"]), gt)
            preds.append(pred)
            gts.append(gt)

        # raw-motion-feature statistics: mean over frames per sequence
        fp = np.stack([p.mean(0) for p in preds])
        fg = np.stack([g.mean(0) for g in gts])
        m = {
            "fid": float(frechet_distance(fp, fg)),
            "diversity_pred": float(diversity(fp)),
            "diversity_gt": float(diversity(fg)),
            "smoothness_pred": float(np.mean([temporal_smoothness(p) for p in preds])),
            "smoothness_gt": float(np.mean([temporal_smoothness(g) for g in gts])),
            "l1": float(np.mean([l1_reconstruction(p, g) for p, g in zip(preds, gts)])),
            # othermetrics/acceleration.py: mean ||second difference||
            "acceleration_pred": mean_acceleration(preds),
            "acceleration_gt": mean_acceleration(gts),
        }
        if evaluation is not None:
            labels = np.arange(len(preds)) % evaluation.num_classes
            loaders = {"gt": {"train": (as_motion(gts), labels),
                              "test": (as_motion(gts), labels)},
                       "gen": {"train": (as_motion(preds), labels),
                               "test": (as_motion(preds), labels)}}
            m.update({f"stgcn_{k}": float(v) for k, v in evaluation.evaluate(loaders).items()
                      if k.endswith("_test")})
        metrics_all[seed] = m
        print(f"seed {seed}: " + " ".join(f"{k}={v:.4f}" for k, v in m.items()))

    path = os.path.join(args.workdir, "metrics.json")
    with open(path, "w") as f:
        json.dump(metrics_all, f, indent=2)
    print(f"wrote {path}")
    return metrics_all


if __name__ == "__main__":
    main()
