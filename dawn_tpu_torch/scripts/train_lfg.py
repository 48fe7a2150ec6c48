"""LFG flow-autoencoder training entry of the port.

    python -m dawn_tpu_torch.scripts.train_lfg --config configs/lfg_hdtf128.yaml \\
        --frames-dir <chunked-npy frame dirs> [--vgg19 vgg19-dcbb9e9d.pth]

The flags of ``scripts/train_lfg.py`` plus ``--device`` ('cpu' to run on
the CPU; the card is the default) and ``--restore``. The yaml gives the
training parameters (batch size, lr, scales, loss weights, warp, milestones)
and the nets' widths (``model_params``, the reference's layout). Frame pairs
come from ``train.data.frame_pair_batches`` (RandomState(0), or the
restored step). Without ``--vgg19`` the VGG19 weights are torch's default
init from the seed, which makes the perceptual loss a structural check
only. Under ``--workdir``: ``metrics.jsonl`` every ``--log-every`` steps,
``train.log``, TensorBoard event files under ``tb/`` with
``--tensorboard``, and every ``--ckpt-every`` steps and at the end
``ckpt/LFG_<step>.pth`` in the reference ``LFG_*.pth`` layout
({'generator' with the flow predictor nested as
``pixelwise_flow_predictor.*``, 'region_predictor', 'bg_predictor'}) plus
the optimizer, its schedule, the step and the warp generator's state:
``FlowAE.load_reference_checkpoint`` and ``weights.checkpoints.
load_lfg_generator`` read it, and ``--restore`` resumes from the newest.

Several processes (``torchrun``, or the ``DAWN_*`` environment of
:mod:`dawn_tpu_torch.parallel.distributed`) run ``make_sharded_step`` over
a 'data' mesh, BatchNorm statistics summed over the ranks; every rank reads
the same batches, and only rank 0 writes.
"""

import argparse
import contextlib
import glob
import inspect
import json
import os
import time
from typing import Any, Dict, List, Optional


def parse_args(argv: Optional[List[str]] = None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--config", default="configs/lfg_hdtf128.yaml")
    ap.add_argument("--frames-dir", required=True)
    ap.add_argument("--vgg19", default=None, help="torchvision vgg19 .pth")
    ap.add_argument("--workdir", default="runs/lfg")
    ap.add_argument("--steps", type=int, default=10000)
    ap.add_argument("--batch-size", type=int, default=None)
    ap.add_argument("--log-every", type=int, default=20)
    ap.add_argument("--ckpt-every", type=int, default=1000)
    ap.add_argument("--tensorboard", action="store_true",
                    help="also write TensorBoard event files to <workdir>/tb")
    ap.add_argument("--restore", action="store_true",
                    help="resume from the newest <workdir>/ckpt/LFG_*.pth")
    ap.add_argument("--device", default=None, help="'cpu' to run on the CPU (default: the card)")
    return ap.parse_args(argv)


# architecture flags of the DAWN configurations, which the port always runs
# (FlowAE's nets have no other branch): a yaml that sets one otherwise raises
_ALWAYS_ON = ("estimate_affine", "skips", "pca_based", "use_deformed_source",
              "use_covar_heatmap", "estimate_occlusion_map")


def flow_ae_kwargs(model_params: Dict[str, Any]) -> Dict[str, Any]:
    """The yaml's ``model_params`` (the reference config layout) -> FlowAE's
    keyword arguments, train-mode BatchNorm in every net. Raises on an
    entry that no port module takes, or on a flag of :data:`_ALWAYS_ON`
    set to anything but true."""
    from dawn_tpu_torch.models.lfg.bg_predictor import BGMotionPredictor
    from dawn_tpu_torch.models.lfg.generator import LFGGenerator
    from dawn_tpu_torch.models.lfg.pixelwise_flow import PixelwiseFlowPredictor
    from dawn_tpu_torch.models.lfg.region_predictor import RegionPredictor

    own = ("num_regions", "revert_axis_swap")         # FlowAE's own arguments
    common = ("num_channels",)                         # passed to the nets that take it
    gen = dict(model_params.get("generator_params") or {})
    flow = gen.pop("pixelwise_flow_predictor_params", None) or {}

    def unported(where, params, taken):
        for k, v in params.items():
            if k in taken:
                continue
            if k not in _ALWAYS_ON:
                raise ValueError(f"{where}: {k!r} is not an argument of the port's LFG")
            if v is not True:
                raise NotImplementedError(f"{where}: {k}={v!r} is not ported (only true)")

    top = {k: v for k, v in model_params.items() if not isinstance(v, dict)}
    unported("model_params", top, own + common)

    def pick(cls, params, where):
        names = inspect.signature(cls.__init__).parameters
        unported(where, params, names)
        kw = {k: top[k] for k in common if k in top and k in names}
        return {**kw, **{k: v for k, v in params.items() if k in names}, "train_bn": True}

    return {**{k: top[k] for k in own if k in top},
            "generator_kw": pick(LFGGenerator, gen, "generator_params"),
            "region_kw": pick(RegionPredictor, model_params.get("region_predictor_params") or {},
                              "region_predictor_params"),
            "bg_kw": pick(BGMotionPredictor, model_params.get("bg_predictor_params") or {},
                          "bg_predictor_params"),
            "flow_kw": pick(PixelwiseFlowPredictor, flow, "pixelwise_flow_predictor_params")}


def latest_checkpoint(ckpt_dir: str) -> Optional[str]:
    paths = sorted(glob.glob(os.path.join(ckpt_dir, "LFG_*.pth")))
    return paths[-1] if paths else None


def main(argv: Optional[List[str]] = None):
    """Run the training loop; returns the trainer."""
    args = parse_args(argv)

    import numpy as np
    import torch
    import yaml

    from dawn_tpu_torch.models.lfg.flow_ae import FlowAE
    from dawn_tpu_torch.parallel.distributed import maybe_initialize_distributed
    from dawn_tpu_torch.parallel.mesh import make_mesh
    from dawn_tpu_torch.train.data import frame_pair_batches
    from dawn_tpu_torch.train.train_lfg import LFGTrainConfig, LFGTrainer
    from dawn_tpu_torch.utils.misc import Logger, setup_seed
    from dawn_tpu_torch.utils.tensorboard import EventWriter

    maybe_initialize_distributed(device=args.device)
    mesh = make_mesh()
    lead = mesh.rank == 0
    with open(args.config) as f:
        y = yaml.safe_load(f)
    setup_seed(1234)
    ckpt_dir = os.path.join(args.workdir, "ckpt")
    os.makedirs(ckpt_dir, exist_ok=True)

    tp = y["train_params"]
    bs = args.batch_size or int(tp.get("batch_size", 16))
    tf = tp.get("transform_params") or {}
    cfg = LFGTrainConfig(
        lr=float(tp["lr"]), scales=tuple(tp["scales"]),
        perceptual_weights=tuple(tp["loss_weights"]["perceptual"]),
        equivariance_shift=tp["loss_weights"]["equivariance_shift"],
        equivariance_affine=tp["loss_weights"]["equivariance_affine"],
        sigma_affine=tf.get("sigma_affine", 0.05), sigma_tps=tf.get("sigma_tps", 0.005),
        points_tps=tf.get("points_tps", 5),
        epoch_milestones=tuple(tp.get("epoch_milestones", (60, 90))),
        steps_per_epoch=max(1, (len(os.listdir(args.frames_dir))
                                * int(tp.get("num_repeats", 100))) // bs))
    trainer = LFGTrainer(cfg, flow_ae=FlowAE(**flow_ae_kwargs(y["model_params"])),
                         device=args.device)
    start = 0
    if args.restore:
        path = latest_checkpoint(ckpt_dir)
        if path is not None:
            trainer.load_checkpoint(path)
            start = trainer.step
    step_fn = trainer.make_sharded_step(mesh) if mesh.distributed else trainer.train_step

    def save():
        if lead:
            path = os.path.join(ckpt_dir, f"LFG_{trainer.step:07d}.pth")
            torch.save(trainer.state_dict(), path + ".tmp")
            os.replace(path + ".tmp", path)

    with contextlib.ExitStack() as stack:
        log = stack.enter_context(open(os.path.join(args.workdir, "metrics.jsonl") if lead
                                       else os.devnull, "a"))
        tee = Logger(os.path.join(args.workdir, "train.log") if lead else os.devnull)
        stack.callback(tee.close)
        stack.enter_context(contextlib.redirect_stdout(tee))
        tb = EventWriter(os.path.join(args.workdir, "tb")) if args.tensorboard and lead else None
        if tb is not None:
            stack.callback(tb.close)
        if args.vgg19:
            trainer.vgg.load_torchvision(args.vgg19)
            print(f"loaded VGG19 weights from {args.vgg19}")
        print(f"device {trainer.device}; mesh {mesh.shape}; batch {bs}"
              + (f"; restored from step {start}" if start else ""))
        t0 = time.time()
        batches = frame_pair_batches(args.frames_dir, bs, args.steps - start,
                                     np.random.RandomState(start))
        for step, batch in enumerate(batches, start):
            metrics = step_fn(batch)
            if step % args.log_every == 0 and lead:
                metrics.update(step=step, wall=time.time() - t0)
                log.write(json.dumps(metrics) + "\n")
                log.flush()
                if tb is not None:
                    tb.add_scalars(metrics, step, prefix="train/")
                    tb.flush()
                print(f"step {step}: total={metrics['total']:.4f} "
                      f"perc={metrics['perceptual']:.4f}")
            if trainer.step % args.ckpt_every == 0:
                save()
        save()
    return trainer


if __name__ == "__main__":
    main()
    import torch.distributed as dist
    if dist.is_initialized():
        dist.destroy_process_group()
