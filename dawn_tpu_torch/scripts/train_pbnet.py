"""PBnet CVAE + PatchGAN training entry (the pose or the blink model) of the port.

    python -m dawn_tpu_torch.scripts.train_pbnet --kind pose|blink \\
        --hubert-dir ... --pose-dir ... --eye-dir ... --length-dict ...

The flags of ``scripts/train_pbnet.py`` plus ``--device`` ('cpu' to run on
the CPU; the card is the default) and ``--restore``. Everything goes under
``<workdir>/<kind>/``: ``opt.yaml`` (the JAX script's keys, so inference
rebuilds the model), ``metrics.jsonl`` every ``--log-every`` steps,
``train.log``, TensorBoard event files under ``tb/`` with
``--tensorboard``, and every ``--ckpt-every`` steps and at the end the
generator as a bare state_dict ``checkpoint_<step>.pth.tar`` beside
``opt.yaml`` (what ``pipeline.pose_blink.load_pbnet_with_opt`` reads) and
the whole trainer state ``ckpt/step_<step>.pt``, which ``--restore``
resumes from (the batches then continue from a stream seeded with the
restored step). The KL annealing is epoch-based: one epoch is one pass
over the videos at the batch size.

Several processes (``torchrun``, or the ``DAWN_*`` environment of
:mod:`dawn_tpu_torch.parallel.distributed`) run ``make_sharded_step`` over
a 'data' mesh; every rank reads the same batches, and only rank 0 writes.
"""

import argparse
import contextlib
import glob
import json
import os
import time
from typing import List, Optional


def parse_args(argv: Optional[List[str]] = None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--kind", choices=["pose", "blink"], default="pose")
    ap.add_argument("--hubert-dir", required=True)
    ap.add_argument("--pose-dir", required=True)
    ap.add_argument("--eye-dir", required=True)
    ap.add_argument("--length-dict", required=True)
    ap.add_argument("--workdir", default="runs/pbnet")
    ap.add_argument("--steps", type=int, default=100000)
    ap.add_argument("--batch-size", type=int, default=32)
    ap.add_argument("--num-frames", type=int, default=100)
    ap.add_argument("--log-every", type=int, default=50)
    ap.add_argument("--ckpt-every", type=int, default=5000)
    ap.add_argument("--tensorboard", action="store_true",
                    help="also write TensorBoard event files to <workdir>/<kind>/tb")
    ap.add_argument("--restore", action="store_true",
                    help="resume from the newest <workdir>/<kind>/ckpt/step_*.pt")
    ap.add_argument("--device", default=None, help="'cpu' to run on the CPU (default: the card)")
    return ap.parse_args(argv)


def latest_checkpoint(ckpt_dir: str) -> Optional[str]:
    paths = sorted(glob.glob(os.path.join(ckpt_dir, "step_*.pt")))
    return paths[-1] if paths else None


def main(argv: Optional[List[str]] = None):
    """Run the training loop; returns the trainer."""
    args = parse_args(argv)

    import torch
    import yaml

    from dawn_tpu_torch.parallel.distributed import maybe_initialize_distributed
    from dawn_tpu_torch.parallel.mesh import make_mesh
    from dawn_tpu_torch.train.data import PBnetPoseDataset
    from dawn_tpu_torch.train.train_pbnet import PBnetTrainConfig, PBnetTrainer
    from dawn_tpu_torch.utils.misc import Logger, setup_seed
    from dawn_tpu_torch.utils.tensorboard import EventWriter
    from dawn_tpu_torch.weights.checkpoints import save_pbnet_checkpoint

    maybe_initialize_distributed(device=args.device)
    mesh = make_mesh()
    lead = mesh.rank == 0
    setup_seed(1234)
    workdir = os.path.join(args.workdir, args.kind)
    ckpt_dir = os.path.join(workdir, "ckpt")
    os.makedirs(ckpt_dir, exist_ok=True)

    trainer = PBnetTrainer(PBnetTrainConfig(kind=args.kind, total_steps=args.steps),
                           device=args.device)
    hp = trainer.model.hp
    if lead:        # opt.yaml, so that inference rebuilds the model (parser/tools.py)
        with open(os.path.join(workdir, "opt.yaml"), "w") as f:
            yaml.safe_dump({
                "modeltype": "cvae", "archiname": hp.archiname,
                "latent_dim": hp.latent_dim, "ff_size": hp.ff_size,
                "num_layers": hp.num_layers, "num_heads": hp.num_heads,
                "num_buckets": hp.num_buckets, "max_distance": hp.max_distance,
                "audio_dim": hp.audio_dim, "pos_dim": hp.pos_dim,
                "eye_dim": hp.eye_dim, "lambdas": dict(hp.lambdas),
            }, f)
    start = 0
    if args.restore:
        path = latest_checkpoint(ckpt_dir)
        if path is not None:
            trainer.load_state_dict(torch.load(path, map_location=trainer.device,
                                               weights_only=True))
            start = trainer.step
    dataset = PBnetPoseDataset(args.hubert_dir, args.pose_dir, args.eye_dir, args.length_dict,
                               num_frames=args.num_frames, seed=start)
    step_fn = trainer.make_sharded_step(mesh) if mesh.distributed else trainer.train_step
    steps_per_epoch = max(1, len(dataset.names) // max(1, args.batch_size))

    def save():
        if lead:
            save_pbnet_checkpoint(trainer.model,
                                  os.path.join(workdir, f"checkpoint_{trainer.step}.pth.tar"))
            path = os.path.join(ckpt_dir, f"step_{trainer.step:07d}.pt")
            torch.save(trainer.state_dict(), path + ".tmp")
            os.replace(path + ".tmp", path)

    with contextlib.ExitStack() as stack:
        log = stack.enter_context(open(os.path.join(workdir, "metrics.jsonl") if lead
                                       else os.devnull, "a"))
        tee = Logger(os.path.join(workdir, "train.log") if lead else os.devnull)
        stack.callback(tee.close)
        stack.enter_context(contextlib.redirect_stdout(tee))
        tb = EventWriter(os.path.join(workdir, "tb")) if args.tensorboard and lead else None
        if tb is not None:
            stack.callback(tb.close)
        print(f"dataset: {len(dataset.names)} videos; device {trainer.device}; mesh "
              f"{mesh.shape}" + (f"; restored from step {start}" if start else ""))
        t0 = time.time()
        for step, raw in enumerate(dataset.batches(args.batch_size, args.steps - start), start):
            x = raw["pose"] if args.kind == "pose" else raw["eye"]
            metrics = step_fn({"x": x, "hubert": raw["hubert"]}, step // steps_per_epoch)
            if step % args.log_every == 0 and lead:
                metrics.update(step=step, wall=time.time() - t0)
                log.write(json.dumps(metrics) + "\n")
                log.flush()
                if tb is not None:
                    tb.add_scalars(metrics, step, prefix="train/")
                    tb.flush()
                print(f"step {step}: g={metrics['g_total']:.4f} d={metrics['d_loss']:.4f} "
                      f"rc={metrics.get('rc', 0):.4f}")
            if trainer.step % args.ckpt_every == 0:
                save()
        save()
    return trainer


if __name__ == "__main__":
    main()
    import torch.distributed as dist
    if dist.is_initialized():
        dist.destroy_process_group()
