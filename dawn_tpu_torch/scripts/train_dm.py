"""DM diffusion training entry (stage 1 / stage 2) of the port.

    python -m dawn_tpu_torch.scripts.train_dm --config configs/dm_train_stage1.yaml \\
        --frames-dir ... --hubert-dir ... --pose-dir ... --eye-dir ... \\
        --length-dict ... [--lmk-dir ...] [--lfg-ckpt LFG_128.pth] [--stage 2]

On several cards of one machine, one process per card:

    torchrun --nproc_per_node=N -m dawn_tpu_torch.scripts.train_dm ...

(or the ``DAWN_COORDINATOR`` / ``DAWN_NUM_PROCESSES`` / ``DAWN_PROCESS_ID``
environment, :mod:`dawn_tpu_torch.parallel.distributed`). The mesh follows
the JAX script's rule (``scripts/train_dm.py:144-145``): 'seq' 2 when
there is more than one process and their count is even, else 1, with the
rest on 'data'; the step is ``DMTrainer.make_sharded_step``. Every rank
reads the same batches; only rank 0 writes checkpoints and
``metrics.jsonl``. The diffused frames must divide over 'seq' and cover
``win_width`` on each rank (the JAX package asserts the same in
``seq_sharded_local_attention``): at stage 1's 20 frames and window 20, two
'seq' ranks hold 10 frames each, so a multi-card stage-1 run stops before
its first step.

The flags are those of ``scripts/train_dm.py``: the yaml config (batch size,
frames, lr, schedule length, loss weights, window; optional ``unet:`` and
``lfg:`` topology overrides and ``compute_dtype: bfloat16``), stage-2 clip
lengths drawn per step and snapped to the config's length buckets,
``<workdir>/metrics.jsonl`` logging every ``--log-every`` steps (with
``--tensorboard`` also TensorBoard event files under ``<workdir>/tb``), and
checkpoints ``<workdir>/ckpt/step_<step>.pt`` (UNet, optimizer, schedule,
EMA, step; ``torch.save``) every ``--ckpt-every`` steps and at the end,
resumed from the newest with ``--restore``. ``--device cpu`` runs on the CPU;
the card is the default. The yaml's ``remat: dots|full`` recomputes the
UNet's forward in the backward (``DMTrainConfig.remat``).

``--teacher-cache DIR`` keeps the frozen teacher's tensors of each (video,
start) clip on disk (:class:`dawn_tpu_torch.train.data.TeacherCache`, f32 or
with ``--teacher-cache-f16`` f16) and trains on them, so a clip seen before
skips the teacher pass; clip starts then lie on a grid of
``--teacher-cache-stride`` frames (default ``max(1, num_frames // 2)``) so
that clips recur, color jitter is skipped (it acts only through the
teacher), and ``metrics.jsonl`` gains ``teacher_cache_hit_rate``. On several
ranks each runs the teacher on its share of a step's misses and all read the
step's entries back from the shared directory
(``TeacherCache.convert_batch_shared``). ``--prefetch``
assembles batches on a worker thread with the C++ chunk reader (built with
g++ at first use) and copies them to the card there, ahead of the step.
``--sample-every N`` writes the training monitor's panels
(``DMTrainer.snapshot``, its draws seeded with step + 1 as in the JAX
script) every N steps as
``<workdir>/imgshots/step_<step:07d>.png``.
"""

import argparse
import glob
import json
import os
import time
from typing import List, Optional

_TIME_KEYS = ("video", "hubert", "pose", "blink", "mouth_lmk")
# the cached teacher's per-frame rows are the diffused frames (stage 2: frame
# 0 already split off), so a stage-2 length L cuts them to :L and the raw
# modalities to :L+1
_TEACHER_TIME_KEYS = ("real_vid_grid", "real_vid_conf")


def parse_args(argv: Optional[List[str]] = None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--config", default="configs/dm_train_stage1.yaml")
    ap.add_argument("--frames-dir", required=True)
    ap.add_argument("--hubert-dir", required=True)
    ap.add_argument("--pose-dir", required=True)
    ap.add_argument("--eye-dir", required=True)
    ap.add_argument("--lmk-dir", default=None)
    ap.add_argument("--length-dict", required=True)
    ap.add_argument("--lfg-ckpt", default=None,
                    help="reference LFG_*.pth for the frozen teacher (random weights "
                         "from the config's seed otherwise)")
    ap.add_argument("--stage", type=int, default=1)
    ap.add_argument("--workdir", default="runs/dm")
    ap.add_argument("--restore", action="store_true")
    ap.add_argument("--steps", type=int, default=None)
    ap.add_argument("--log-every", type=int, default=50)
    ap.add_argument("--ckpt-every", type=int, default=500)
    ap.add_argument("--device", default=None, help="'cpu' to run on the CPU (default: the card)")
    ap.add_argument("--sample-every", type=int, default=1000,
                    help="write the monitor's PNG panels every N steps (0: never)")
    ap.add_argument("--tensorboard", action="store_true",
                    help="also write TensorBoard event files to <workdir>/tb")
    ap.add_argument("--teacher-cache", default=None, metavar="DIR",
                    help="cache the frozen teacher's tensors per (video, start) clip in DIR "
                         "and reuse them (clip starts on a grid, no color jitter)")
    ap.add_argument("--teacher-cache-stride", type=int, default=None,
                    help="the clip-start grid of the cache (default num_frames // 2)")
    ap.add_argument("--teacher-cache-f16", action="store_true",
                    help="store the cache's entries as float16")
    ap.add_argument("--prefetch", action="store_true",
                    help="read and copy batches to the card on a worker thread, ahead of "
                         "the step (the C++ chunk reader)")
    return ap.parse_args(argv)


def check_seq_frames(frame_counts: List[int], seq: int, window: int) -> None:
    """Raise before the first step when a clip's diffused frames do not
    divide over the 'seq' ranks or leave a rank fewer frames than the
    attention window (each rank's stripe must cover +-window)."""
    for t in frame_counts:
        if seq > 1 and (t % seq or t // seq < window):
            raise ValueError(
                f"{t} diffused frames over {seq} 'seq' ranks: each rank needs a whole share "
                f"of at least win_width={window} frames (the halo of "
                f"seq_sharded_local_attention); use clips of a multiple of {seq} frames, "
                f">= {seq * window}, or fewer 'seq' ranks")


def latest_checkpoint(ckpt_dir: str) -> Optional[str]:
    paths = sorted(glob.glob(os.path.join(ckpt_dir, "step_*.pt")))
    return paths[-1] if paths else None


def trainer_from_config(cfg_yaml: dict, stage: int = 1, device=None,
                        lfg_ckpt: Optional[str] = None):
    """The DMTrainer a training yaml (``configs/dm_train_stage{1,2}.yaml``
    and its ``unet:``/``lfg:`` overrides) describes, with the frozen LFG
    from ``lfg_ckpt`` when given; its generator is seeded with the yaml's
    ``random_seed``. The caller seeds torch's initialisation."""
    import torch

    from dawn_tpu_torch.models.lfg.flow_ae import FlowAE
    from dawn_tpu_torch.train.train_dm import DMTrainConfig, DMTrainer

    cfg = DMTrainConfig(
        img_size=cfg_yaml["img_size"], win_width=cfg_yaml.get("win_width", 20),
        stage=stage, lr=cfg_yaml["lr"], total_steps=cfg_yaml["total_steps"],
        grad_clip=cfg_yaml["grad_clip"], floss_weight=cfg_yaml["floss_weight"],
        mouth_weight=cfg_yaml["mouth_weight"], null_cond_prob=cfg_yaml["null_cond_prob"],
        fea_channels=cfg_yaml.get("fea_channels", 256),
        remat=cfg_yaml.get("remat", "none"),
        compute_dtype=getattr(torch, cfg_yaml.get("compute_dtype", "float32")))
    unet_kw = dict(cfg_yaml.get("unet") or {})
    if "dim_mults" in unet_kw:
        unet_kw["dim_mults"] = tuple(unet_kw["dim_mults"])
    lf = cfg_yaml.get("lfg") or {}
    flow_ae = FlowAE(generator_kw=lf.get("generator"), region_kw=lf.get("region"),
                     bg_kw=lf.get("bg"), flow_kw=lf.get("flow"))
    if lfg_ckpt:
        flow_ae.load_reference_checkpoint(lfg_ckpt)
    return DMTrainer(cfg, flow_ae=flow_ae, unet_kw=unet_kw or None, device=device,
                     seed=cfg_yaml.get("random_seed", 1234))


def main(argv: Optional[List[str]] = None):
    """Run the training loop; returns the trainer."""
    args = parse_args(argv)

    import numpy as np
    import torch
    import torch.distributed as dist
    import yaml

    from dawn_tpu_torch.parallel.distributed import (maybe_initialize_distributed,
                                                     process_count)
    from dawn_tpu_torch.parallel.mesh import make_mesh
    from dawn_tpu_torch.train.data import HDTFVideoDataset, TeacherCache
    from dawn_tpu_torch.utils.misc import save_snapshot_grid
    from dawn_tpu_torch.utils.tensorboard import EventWriter

    maybe_initialize_distributed(device=args.device)
    n = process_count()
    mesh = make_mesh(seq_parallel=2 if n > 1 and n % 2 == 0 else 1)
    lead = mesh.rank == 0

    with open(args.config) as f:
        cfg_yaml = yaml.safe_load(f)
    seed = cfg_yaml.get("random_seed", 1234)
    torch.manual_seed(seed)
    os.makedirs(args.workdir, exist_ok=True)

    trainer = trainer_from_config(cfg_yaml, args.stage, args.device, args.lfg_ckpt)
    if args.lfg_ckpt and lead:
        print(f"loaded frozen LFG from {args.lfg_ckpt}")
    cfg = trainer.config

    # stage 2: a random clip length of 30-40 diffused frames per step,
    # snapped to the config's length buckets, +1 for the split-off frame 0
    if args.stage == 2:
        s2_min = cfg_yaml.get("num_frames_min", 30)
        s2_max = cfg_yaml.get("num_frames_max", 40)
        s2_buckets = sorted(set(cfg_yaml.get("frame_buckets",
                                             [s2_min, (s2_min + s2_max) // 2, s2_max])))
        num_frames = s2_max + 1
    else:
        num_frames = cfg_yaml.get("num_frames", 20)
    check_seq_frames(s2_buckets if args.stage == 2 else [num_frames], mesh.shape["seq"],
                     cfg.win_width)
    stride = (args.teacher_cache_stride or max(1, num_frames // 2)) if args.teacher_cache \
        else None
    dataset = HDTFVideoDataset(args.frames_dir, args.hubert_dir, args.pose_dir, args.eye_dir,
                               args.length_dict, lmk_dir=args.lmk_dir, num_frames=num_frames,
                               start_stride=stride)
    if lead:
        print(f"dataset: {len(dataset)} videos, {num_frames} frames/clip"
              + (f", stage-2 buckets {s2_buckets}" if args.stage == 2 else "")
              + f"; device {trainer.device}; mesh {mesh.shape}")
    cache = None
    if args.teacher_cache:
        cache = TeacherCache(args.teacher_cache,
                             dtype=np.float16 if args.teacher_cache_f16 else np.float32)
        if lead:
            print(f"teacher cache: {args.teacher_cache} (start stride {stride}, "
                  f"{'f16' if args.teacher_cache_f16 else 'f32'} entries; no color jitter)")
    step_fn = trainer.make_sharded_step(mesh) if mesh.distributed else trainer.train_step

    start = 0
    ckpt_dir = os.path.join(args.workdir, "ckpt")
    if args.restore:
        path = latest_checkpoint(ckpt_dir)
        if path is not None:
            trainer.load_state_dict(torch.load(path, map_location=trainer.device,
                                               weights_only=True))
            start = trainer.step
            if lead:
                print(f"restored from step {start}")

    def save(step):
        if not lead:
            return
        os.makedirs(ckpt_dir, exist_ok=True)
        path = os.path.join(ckpt_dir, f"step_{step:07d}.pt")
        torch.save(trainer.state_dict(), path + ".tmp")
        os.replace(path + ".tmp", path)

    total = cfg_yaml["total_steps"] if args.steps is None else args.steps
    bs = cfg_yaml["batch_size"]
    rng_len = np.random.RandomState(seed)
    t0 = time.time()
    tb = EventWriter(os.path.join(args.workdir, "tb")) if args.tensorboard and lead else None
    with_meta = cache is not None
    batch_iter = (dataset.batches_prefetched(bs, total - start, with_meta=with_meta,
                                             device=trainer.device) if args.prefetch
                  else dataset.batches(bs, total - start, with_meta=with_meta))
    with open(os.path.join(args.workdir, "metrics.jsonl") if lead else os.devnull,
              "a") as metrics_log:
        for step, item in enumerate(batch_iter, start):
            if cache is not None and mesh.distributed:
                raw, meta = item
                batch = cache.convert_batch_shared(raw, meta, trainer.teacher_precompute,
                                                   mesh.rank, mesh.size, dist.barrier)
            elif cache is not None:
                raw, meta = item
                batch = cache.convert_batch(raw, meta, trainer.teacher_precompute)
            else:
                raw = batch = item
            if args.stage == 2:
                want = rng_len.randint(s2_min, s2_max + 1)
                length = min(s2_buckets, key=lambda q: abs(q - want))
                batch = {k: (v[:, : length + 1] if k in _TIME_KEYS else
                             v[:, :length] if k in _TEACHER_TIME_KEYS else v)
                         for k, v in batch.items()}
            load_t = time.time() - t0
            if load_t > 1.0 and lead:
                print(f"unnormal load {load_t:.2f}s at step {step}")
            metrics = step_fn(batch)
            if step % args.log_every == 0 and lead:
                metrics.update(step=step, wall=time.time() - t0,
                               frames=int(batch["hubert"].shape[1]))
                if cache is not None and cache.hit_rate is not None:
                    metrics["teacher_cache_hit_rate"] = round(cache.hit_rate, 4)
                metrics_log.write(json.dumps(metrics) + "\n")
                metrics_log.flush()
                if tb is not None:
                    tb.add_scalars(metrics, step, prefix="train/")
                    tb.flush()
                print(f"step {step}: " + " ".join(f"{k} {metrics[k]:.4f}" for k in
                                                  ("total", "loss", "floss", "mouth_loss")))
            if step > start and step % args.ckpt_every == 0:
                save(step)
            if args.sample_every and step > start and step % args.sample_every == 0 and lead:
                # the raw batch: a cached one carries no video to decode
                snap_dir = os.path.join(args.workdir, "imgshots")
                os.makedirs(snap_dir, exist_ok=True)
                save_snapshot_grid(os.path.join(snap_dir, f"step_{step:07d}.png"),
                                   trainer.snapshot(raw, seed=step + 1))
            t0 = time.time()
    if tb is not None:
        tb.close()
    save(total)
    return trainer


if __name__ == "__main__":
    main()
    import torch.distributed as dist
    if dist.is_initialized():
        dist.destroy_process_group()
