#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (dawn_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Needs one CUDA card and the CUDA toolkit (nvcc). Imports nothing of JAX or of
the JAX package. Phases, one output line or more each, any failure exits
non-zero:

1. device  - the card's name and power limit (nvidia-smi).
2. build   - nvcc builds every kernel source under dawn_tpu_torch/csrc.
3. kernel K1 - the windowed-attention kernel against its plain PyTorch
   version on the card (TF32 off), case by case with max error and
   tolerance; at the main-path shape (N=1024 sequences, T=200, 8 heads x 32,
   w=40, bf16) the kernel, the plain version and one library call
   (F.scaled_dot_product_attention with the (H, T, T) bias and window mask,
   a yardstick the port never calls) are timed with CUDA events, beside the
   least time the card could take (bytes over memory rate, operations over
   peak rate).
4. parity  - a 40-frame, 2-step f32 sample_one_video at full width runs on the
   card (kernel) and on the CPU (plain path), same weights and noise, TF32
   off; max error of the output video at tolerance 1e-3.
5. path    - the 128^2 main path at full width: T=200 frames, 20 DDIM steps,
   UNet bf16, LFG f32, random weights from a seed. Checks a finite
   (1, 200, 128, 128, 3) video in [0, 1] and exactly 200 K1 launches (10
   temporal attentions x 20 UNet calls), and reports the warm call's time,
   frames/s and peak device memory.
6. profile - the warm path once more under torch.profiler: device busy
   share and the kernels with the most device time.
7. kernels - one JSON line listing every ported kernel with its numbers.

The line before the last is nvidia-smi's name and power limit; the last line
is {"ok": true, "device": {...}}.
"""

import json
import os
import subprocess
import sys
import time

SEED = 0
# Dense peak rates from NVIDIA's data sheets: (bytes/s, bf16 FLOP/s, f32 FLOP/s)
PEAKS = {"PCIe": (2.0e12, 756e12, 51e12), "NVL": (3.9e12, 835e12, 60e12),
         "SXM": (3.35e12, 989e12, 67e12)}


def peaks_for(name):
    for key, rates in PEAKS.items():
        if key in name:
            return key, rates
    return "SXM", PEAKS["SXM"]


def time_ms(fn, iters):
    import torch
    for _ in range(2):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def check(ok, what):
    if not ok:
        raise RuntimeError(f"check failed: {what}")


def kernel_k1(card, rates):
    """Phase 3: K1 against its plain version; timings at the main shape."""
    import numpy as np
    import torch
    import torch.nn.functional as F
    from dawn_tpu_torch.ops import local_attention as la

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    gen = torch.Generator(device="cuda").manual_seed(SEED)

    def inputs(n, t, heads, d, w, dtype, bias=True):
        q, k, v = (torch.randn(n, t, heads * d, device="cuda", generator=gen) for _ in range(3))
        vec = torch.randn(heads, 2 * w + 1, device="cuda", generator=gen) if bias else None
        return (q * d ** -0.5).to(dtype), k.to(dtype), v.to(dtype), vec

    cases = [("main f32", 1024, 200, 8, 32, 40, torch.float32, True, 1e-4),
             ("main bf16", 1024, 200, 8, 32, 40, torch.bfloat16, True, 2e-2),
             ("T=77 w=20", 64, 77, 8, 32, 20, torch.float32, True, 1e-4),
             ("T=1", 64, 1, 8, 32, 40, torch.float32, True, 1e-4),
             ("T=256", 64, 256, 8, 32, 40, torch.float32, True, 1e-4),
             ("T=129", 64, 129, 8, 32, 40, torch.float32, True, 1e-4),
             ("no bias", 64, 200, 8, 32, 40, torch.float32, False, 1e-4)]
    errs = {}
    for name, n, t, heads, d, w, dtype, bias, tol in cases:
        q, k, v, vec = inputs(n, t, heads, d, w, dtype, bias)
        got = la.local_attention_packed(q, k, v, vec, w, heads)
        ref = la.local_attention_packed_plain(q, k, v, vec, w, heads)
        torch.cuda.synchronize()
        err = (got.float() - ref.float()).abs().max().item()
        errs[name] = err
        print(f"kernel K1 {name}: N={n} T={t} H={heads} dh={d} w={w} {str(dtype)[6:]} "
              f"max_abs_err={err:.3e} tol={tol:g}", flush=True)
        check(err <= tol and np.isfinite(err), f"K1 {name} error {err} > {tol}")

    n, t, heads, d, w = 1024, 200, 8, 32, 40
    q, k, v, vec = inputs(n, t, heads, d, w, torch.bfloat16)
    ms = time_ms(lambda: la.local_attention_packed(q, k, v, vec, w, heads), 20)
    plain_ms = time_ms(lambda: la.local_attention_packed_plain(q, k, v, vec, w, heads), 5)
    q4, k4, v4 = (x.view(n, t, heads, d).transpose(1, 2).contiguous() for x in (q, k, v))
    mask = la.windowed_bias(t, w, vec, "cuda").to(torch.bfloat16)[None]   # (1, H, T, T)
    lib = lambda: F.scaled_dot_product_attention(q4, k4, v4, attn_mask=mask, scale=1.0)
    library_ms = time_ms(lib, 20)
    lib_err = (lib().transpose(1, 2).reshape(n, t, heads * d).float()
               - la.local_attention_packed_plain(q, k, v, vec, w, heads).float()).abs().max().item()

    band = sum(min(t - 1, i + w) - max(0, i - w) + 1 for i in range(t))
    bytes_moved = 4 * n * t * heads * d * 2 + vec.numel() * 4
    flops = 4 * d * band * n * heads
    bw, bf16_peak, _ = rates
    bound = {"bytes": bytes_moved / bw * 1e3, "operations": flops / bf16_peak * 1e3}
    bound_by = max(bound, key=bound.get)
    print(f"kernel K1 timing [{card}] main shape bf16: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
          f"library (sdpa, err {lib_err:.3e}) {library_ms:.4f} ms, bound {bound[bound_by]:.4f} ms "
          f"by {bound_by} ({bytes_moved / 1e6:.1f} MB, {flops / 1e9:.2f} GFLOP)", flush=True)
    return dict(max_abs_err=errs["main bf16"], ms=ms, plain_ms=plain_ms,
                bound_ms=bound[bound_by], bound_by=bound_by, library_ms=library_ms)


def inputs_for(t, img_size, seed):
    import torch
    g = torch.Generator().manual_seed(seed)
    return dict(sample_img=torch.rand(1, img_size, img_size, 3, generator=g),
                audio_hubert=torch.randn(1, t, 1024, generator=g),
                pose=0.1 * torch.randn(1, t, 6, generator=g),
                eye=0.1 * torch.randn(1, t, 2, generator=g),
                bbox=torch.tensor([[30.0, 98.0, 25.0, 105.0, img_size, img_size]]))


def parity():
    """Phase 4: the card (kernel) against the CPU (plain path), f32, TF32 off."""
    import torch
    from dawn_tpu_torch.models.dm.flow_diffusion import FlowDiffusion, FlowDiffusionConfig

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t, steps = 40, 2
    cfg = FlowDiffusionConfig(sampling_timesteps=steps, dtype=torch.float32)
    torch.manual_seed(SEED)
    gpu = FlowDiffusion(cfg, device="cuda")
    cpu = FlowDiffusion(cfg, device="cpu")
    cpu.load_state_dict(gpu.state_dict())
    inp = inputs_for(t, cfg.img_size, SEED + 1)
    noise = torch.randn((steps + 1, 1, t, cfg.latent_size, cfg.latent_size, 3),
                        generator=torch.Generator().manual_seed(SEED + 2))
    before = _k1().launches
    out_gpu = gpu.sample_one_video(**inp, noise_seq=noise)["sample_out_vid"].cpu()
    check(_k1().launches - before == 10 * steps, "parity run did not go through K1")
    out_cpu = cpu.sample_one_video(**inp, noise_seq=noise)["sample_out_vid"]
    err = (out_gpu - out_cpu).abs().max().item()
    print(f"parity: sample_one_video T={t} steps={steps} f32 full width, card (K1) vs CPU "
          f"(plain), TF32 off: max_abs_err={err:.3e} tol=1e-3", flush=True)
    check(err <= 1e-3, f"parity error {err}")
    del gpu, cpu
    torch.cuda.empty_cache()


def _k1():
    from dawn_tpu_torch.ops.local_attention import local_attention_packed
    return local_attention_packed


def main_path(card):
    """Phase 5: the full-width 128^2 main path; returns K1's launches."""
    import torch
    from dawn_tpu_torch.models.dm.flow_diffusion import FlowDiffusion, FlowDiffusionConfig

    torch.backends.cudnn.allow_tf32 = True      # PyTorch's default for convs
    t = 200
    cfg = FlowDiffusionConfig()                 # 128^2, 20 steps, local, UNet bf16, LFG f32
    torch.manual_seed(SEED)
    model = FlowDiffusion(cfg)
    inp = inputs_for(t, cfg.img_size, SEED + 3)

    def run():
        g = torch.Generator(device="cuda").manual_seed(SEED + 4)
        out = model.sample_one_video(**inp, generator=g)
        torch.cuda.synchronize()
        return out

    t0 = time.perf_counter()
    run()
    cold = time.perf_counter() - t0
    torch.cuda.reset_peak_memory_stats()
    k1 = _k1()
    k1.launches = 0
    t0 = time.perf_counter()
    out = run()
    secs = time.perf_counter() - t0
    launches = k1.launches
    vid = out["sample_out_vid"]
    check(tuple(vid.shape) == (1, t, 128, 128, 3), f"video shape {tuple(vid.shape)}")
    check(bool(torch.isfinite(vid).all()), "video has non-finite values")
    lo, hi = vid.min().item(), vid.max().item()
    check(0.0 <= lo and hi <= 1.0, f"video range [{lo}, {hi}]")
    check(launches == 200, f"K1 launches {launches} != 200")
    peak_gb = torch.cuda.max_memory_allocated() / 2**30
    print(f"path [{card}]: 128^2 T={t} 20 DDIM steps UNet bf16 LFG f32: video "
          f"{tuple(vid.shape)} in [{lo:.4f}, {hi:.4f}], K1 launches {launches}; "
          f"cold call {cold:.2f} s, warm call {secs:.3f} s = {t / secs:.2f} frames/s, "
          f"peak memory {peak_gb:.2f} GiB", flush=True)
    profile(run, card)
    return launches


def profile(run, card):
    """Phase 6: where the warm path's device time goes (torch.profiler)."""
    import torch
    from torch.profiler import ProfilerActivity
    with torch.profiler.profile(activities=[ProfilerActivity.CPU,
                                            ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        wall = time.perf_counter() - t0
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    busy = sum(e.self_device_time_total for e in kernels) / 1e6
    check(busy > 0, "the profiler saw no device time")
    print(f"profile [{card}]: warm path under the profiler {wall:.3f} s, device busy "
          f"{busy:.3f} s ({100 * busy / wall:.1f} %), {sum(e.count for e in kernels)} "
          f"kernel launches", flush=True)
    for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[:12]:
        print(f"profile   {e.self_device_time_total / 1e3:9.2f} ms  {e.count:6d} x  "
              f"{e.key[:110]}", flush=True)


def main():
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from dawn_tpu_torch import build

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip().splitlines()[0]
    kind = torch.cuda.get_device_name(0)
    peak_name, rates = peaks_for(kind)
    print(f"device: {smi} (torch {torch.__version__}, CUDA {torch.version.cuda}; "
          f"peaks used: H100 {peak_name})", flush=True)

    t0 = time.perf_counter()
    build.build_all()
    print(f"build: {', '.join(build.sources())} in {time.perf_counter() - t0:.1f} s", flush=True)

    k1 = kernel_k1(smi, rates)
    parity()
    launches = main_path(smi)
    kernels = [{"name": "K1 local_attention_packed", "route": "cuda",
                "source": "dawn_tpu_torch/csrc/local_attention.cu",
                "replaces": "dawn_tpu/ops/local_attention.py:299",
                "launches": launches, **k1}]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
