"""Phase profile of ``sample_one_video``: the UNet-DDIM phase against the
LFG decode, the port's counterpart of ``scripts/profile_sample.py``.

    python -m dawn_tpu_torch.scripts.profile_sample [--img-size 256] [--frames 200] \\
        [--steps 20] [--attn local|full] [--dtype bf16|f32] [--lfg-dtype f32|bf16] \\
        [--lfg-decode-chunk N] [--decode-only] [--repeats 3] [--device cpu]

Times the two phases of the sampler apart and the whole warm call, so that
optimisation lands where the time is:

- DDIM: the condition, the source feature and mask embedding, the step
  constant init conv and the sampler over the UNet
  (``FlowDiffusion.sample_latents``);
- decode: the LFG decode of every frame (``FlowDiffusion.decode_latents``);
- the whole ``sample_one_video``, against the sum of the two.

Each is the first (cold) call, then the best of ``--repeats`` warm calls: on
the card with CUDA events on the current stream, where the kernels launch
(the JAX script forces each call by fetching one element, ``_force``); on the
CPU with the host clock. ``--decode-only`` decodes random flow fields and
skips the DDIM phase. The decode chunk defaults to the whole video at 128^2
and below, 16 frames above, as in the JAX script.

The operation count comes from ``torch.utils.flop_counter.FlopCounterMode``
over one more call of the decode and over DDIM calls of 1 and 2 steps
(scaled to ``--steps``): matmuls, convolutions and attention calls only, plus on the card K1's in-band pairs at 4 x 32 FLOP a pair (the
ctypes kernel is invisible to the counter) for each temporal attention the
UNet runs (K3's past 256 frames). XLA's
``cost_analysis``, which the JAX script divides by, also counts elementwise
work, so the two counts differ. On the card the line divides it by the warm
time and by the bf16 dense peak of ``utils.profiling.card_peaks``; on the
CPU there is no peak, and the rate is printed without a share. ``main``
returns the times and counts.
"""

from __future__ import annotations

import argparse
import sys
from typing import Dict

import numpy as np
import torch

from dawn_tpu_torch import resolve_device
from dawn_tpu_torch.models.dm.flow_diffusion import FlowDiffusion, FlowDiffusionConfig
from dawn_tpu_torch.models.dm.unet3d import TemporalAttention
from dawn_tpu_torch.utils.profiling import band_pairs, card_peaks, time_ms

DTYPES = {"f32": torch.float32, "bf16": torch.bfloat16}


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--img-size", type=int, default=256)
    ap.add_argument("--frames", type=int, default=200)
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--attn", default="local", choices=["full", "local"])
    ap.add_argument("--dtype", default="bf16", choices=list(DTYPES))
    ap.add_argument("--lfg-dtype", default="f32", choices=list(DTYPES))
    ap.add_argument("--lfg-decode-chunk", type=int, default=None)
    ap.add_argument("--decode-only", action="store_true",
                    help="skip the DDIM phase; decode random flow fields")
    ap.add_argument("--repeats", type=int, default=3)
    ap.add_argument("--device", default=None, help="torch device (default: the card)")
    return ap.parse_args(argv)


def count_flops(model: FlowDiffusion, fn) -> Dict[str, int]:
    """{'counted': FlopCounterMode's total, 'k1': the attention kernels'
    in-band FLOP} of one call of ``fn``. The kernels' share is read off
    every 'local' temporal attention the call runs on the card (K1, or K3
    past 256 frames): (B*S sequences) x heads x in-band pairs x 4 x
    head_dim. On the CPU the plain versions run and the counter sees their
    matmuls."""
    from torch.utils.flop_counter import FlopCounterMode

    k1 = [0]

    def hook(module, args, _out):
        b, s, t, _ = args[0].shape
        if module.mode == "local" and not module.seq.active and args[0].is_cuda:
            k1[0] += b * s * module.heads * band_pairs(t, module.window) * 4 * module.dim_head

    handles = [m.register_forward_hook(hook) for m in model.modules()
               if isinstance(m, TemporalAttention)]
    try:
        with FlopCounterMode(display=False) as counter:
            fn()
    finally:
        for h in handles:
            h.remove()
    return {"counted": counter.get_total_flops(), "k1": k1[0]}


def count_ddim_flops(model: FlowDiffusion, fn) -> Dict[str, int]:
    """:func:`count_flops` of one call of ``fn`` at the model's DDIM steps,
    from calls at 1 and 2 steps (every step runs the same shapes, so the
    count is linear in the steps; the counter slows each call several-fold)."""
    steps = model.diffusion.sampling_timesteps
    counts = []
    try:
        for k in (1, 2):
            model.diffusion.sampling_timesteps = k
            counts.append(count_flops(model, fn))
    finally:
        model.diffusion.sampling_timesteps = steps
    return {k: counts[0][k] + (steps - 1) * (counts[1][k] - counts[0][k]) for k in counts[0]}


def main(argv=None):
    args = parse_args(argv)
    device = resolve_device(args.device)
    chunk = args.lfg_decode_chunk
    if chunk is None:
        chunk = 0 if args.img_size <= 128 else 16
    cfg = FlowDiffusionConfig(img_size=args.img_size, sampling_timesteps=args.steps,
                              win_width=40, attn_mode=args.attn, lfg_decode_chunk=chunk,
                              dtype=DTYPES[args.dtype], lfg_dtype=DTYPES[args.lfg_dtype])
    torch.manual_seed(0)
    model = FlowDiffusion(cfg, device=device)
    name = torch.cuda.get_device_name(device) if device.type == "cuda" else "CPU"
    print(f"device={device} ({name}) img={args.img_size} t={args.frames} attn={args.attn} "
          f"chunk={chunk} dtype={args.dtype}/{args.lfg_dtype}", file=sys.stderr)

    b, t, s, ls = 1, args.frames, args.img_size, cfg.latent_size
    rng = np.random.RandomState(0)
    inputs = dict(sample_img=rng.rand(b, s, s, 3), audio_hubert=rng.randn(b, t, 1024),
                  pose=rng.randn(b, t, 6), eye=rng.rand(b, t, 2),
                  bbox=np.asarray([[s * .25, s * .75, s * .25, s * .75, s, s]]))
    inputs = {k: torch.as_tensor(v, dtype=torch.float32, device=device)
              for k, v in inputs.items()}
    img = inputs["sample_img"]

    def gen():
        return torch.Generator(device).manual_seed(1)

    def report(label, first, best, flops):
        total = flops["counted"] + flops["k1"]
        line = (f"{label}: first call {first / 1e3:.2f}s, warm {best / 1e3:.3f}s; "
                f"{total / 1e12:.3f} TFLOP/call counted (matmul/conv/attention "
                f"{flops['counted'] / 1e12:.3f} + kernel in-band {flops['k1'] / 1e12:.3f}) -> "
                f"{total / best / 1e9:.1f} TFLOP/s")
        if device.type == "cuda":
            part, rates = card_peaks(name)
            line += f" = {100 * total / best / 1e-3 / rates[1]:.2f}% of the H100 {part} bf16 peak"
        print(line, file=sys.stderr)

    res = {}
    if args.decode_only:
        pred = torch.as_tensor(rng.randn(b, t, ls, ls, 3) * 0.3, dtype=torch.float32,
                               device=device)
    else:
        def ddim():
            return model.sample_latents(**inputs, generator=gen())
        first, best, pred = time_ms(ddim, device, args.repeats)
        flops = count_ddim_flops(model, ddim)
        report("ddim", first, best, flops)
        print(f"DDIM ({args.steps} steps, attn={args.attn}): {best / 1e3:.3f}s -> "
              f"{t / best * 1e3:.1f} fps-equivalent")
        res.update(ddim_ms=best, ddim_first_ms=first, ddim_flops=flops)

    def decode():
        return model.decode_latents(img, pred)
    first, best, _ = time_ms(decode, device, args.repeats)
    flops = count_flops(model, decode)
    report("decode", first, best, flops)
    print(f"LFG decode ({t} frames @ {s}^2, chunk={chunk}, lfg_dtype={args.lfg_dtype}): "
          f"{best / 1e3:.3f}s -> {t / best * 1e3:.1f} fps-equivalent")
    res.update(decode_ms=best, decode_first_ms=first, decode_flops=flops)

    if not args.decode_only:
        _, whole, _ = time_ms(lambda: model.sample_one_video(**inputs, generator=gen()),
                              device, args.repeats)
        total = res["ddim_ms"] + best
        print(f"total {total / 1e3:.3f}s = {t / total * 1e3:.1f} fps "
              f"(DDIM {100 * res['ddim_ms'] / total:.0f}% / decode {100 * best / total:.0f}%); "
              f"whole warm sample_one_video {whole / 1e3:.3f}s "
              f"(phases sum to {100 * total / whole:.1f}% of it)")
        res.update(whole_ms=whole)
    return res


if __name__ == "__main__":
    main()
