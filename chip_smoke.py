#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (dawn_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Needs one CUDA card and the CUDA toolkit (nvcc). Imports nothing of JAX or of
the JAX package. Phases, one output line or more each (and one "phase ...
done" line with its seconds), any failure exits non-zero:

1. device  - the card's name and power limit (nvidia-smi).
2. build   - nvcc builds every kernel source under dawn_tpu_torch/csrc; ptxas's
   registers per kernel, and each kernel's HMMA (tensor-core) instructions
   from cuobjdump -sass (every instantiation of the bf16 forward body, both
   layouts and both walks, and of the two backward passes in both layouts
   must have some).
   routes  - bf16 K1, K3, K6 and K2 called for half a second each under
   the profiler: K1 and K3 must run the tensor-core forward and not the
   CUDA-core one, K6 and K2 the two tensor-core passes and not the f32 ones
   (nor the old whole-sequence K2 body).
3. kernel K1 - the windowed-attention kernel against its plain PyTorch
   version on the card (TF32 off), case by case with max error and
   tolerance (the sampling shape, the stage-1 training shape N=4096, T=20,
   w=20 in f32 and bf16, stage 2 at T=40, T=77, T=1, T=256, T=129, no
   bias, each in f32 and bf16; windows past T, w=300 at T=200 and w=20 at
   T=20, in both); at the main-path shape (N=1024
   sequences, T=200, 8 heads x 32, w=40, bf16) the kernel, the plain version
   and one library call (F.scaled_dot_product_attention with the (H, T, T)
   bias and window mask, a yardstick the port never calls) are timed with
   CUDA events, beside the least time the card could take (bytes over
   memory rate, operations over peak rate).
4. parity  - a 40-frame, 2-step f32 sample_one_video at full width runs on the
   card (kernel) and on the CPU (plain path), same weights and noise, TF32
   off; max error of the output video at tolerance 1e-3.
5. path    - the 128^2 main path at full width: T=200 frames, 20 DDIM steps,
   UNet bf16, LFG f32, random weights from a seed. Checks a finite
   (1, 200, 128, 128, 3) video in [0, 1] and exactly 200 K1 launches (10
   temporal attentions x 20 UNet calls), and reports the warm call's time,
   frames/s and peak device memory.
6. profile - the warm path once more under torch.profiler: device busy
   share, the kernels with the most device time and the port's own kernels.
7. kernel K2 - the windowed-attention backward against its plain version on
   the card (TF32 off), case by case (stage-1 shape f32 and bf16, stage 2 at
   T=40, T=77, T=1, T=129, T=256, no bias, each in f32 and bf16; windows
   past T, w=300 at T=200 and w=255 at T=256, in both): dq, dk, dv, dvec
   errors with their tolerances; two calls give the same bits; autograd through local_attention_packed on CUDA tensors
   (K1 forward, K2 backward) against the plain version's autograd; at the
   stage-1 shape the kernel, the plain version, one library call (the
   backward of F.scaled_dot_product_attention, never called by the port) and
   K1 with its plain version and SDPA are timed, beside their bounds.
8. train-parity - one f32 stage-1 DMTrainer.train_step at full width on the
   card (kernels) and on the CPU (plain path), bs 1, 4 frames, the same
   weights and draws, TF32 off: loss terms, gradients (Adam's first moment)
   and the update, each with its tolerance; 10 K1 and 10 K2 launches.
9. train path - ``python -m dawn_tpu_torch.scripts.train_dm``'s entry point on a
   synthetic chunked-npy HDTF tree (8 videos x 100 frames): stage 1 at bs 4,
   20 frames, 128^2, full width, bf16 compute, uncached teacher with color
   jitter, 4 steps resumed from a saved step-0 checkpoint; then 2 stage-2
   steps. Checks finite losses, changed parameters and EMA, the checkpoint
   round trip, and exactly 10 K1 and 10 K2 launches per step; reports the
   warm step time, examples/s, peak memory, and under torch.profiler the
   device's busy share and the kernels with the most device time.
10. kernel K3 - the tiled windowed-attention forward on the (N, H, T, D)
   layout against its plain version (the banded form) on the card, TF32 off:
   T=400 and T=800 at the 128^2 top level (N=1024, 8 x 32, w=40) in f32 and
   bf16, T=257, T=333, T=1, one tile, no bias, w=20 (bf16 twins of T=1, one
   tile, no bias and T=257), w=400 at T=1024 in bf16, and the 256^2 top
   level (N=4096); kernel, plain, SDPA (with the (H, T, T) bias) and bound
   at the T=400 and T=800 top-level shapes.
11. kernel K4 - its backward against its plain version: dq, dk, dv, dvec
   relative to each tensor's largest magnitude (T=400, 800, 257, 333, 1, one
   64-row tile, no bias, w=70; bf16, the tensor-core body, at T=257, 1, one
   tile, no bias, w=70, 333, 400, 800); autograd through local_attention on
   CUDA tensors (K3 forward, K4 backward) against the plain autograd, f32 at
   T=300 and bf16 at T=400; kernel, plain, SDPA backward and bound at T=400
   and T=800.
12. kernel K4 TemporalAttention - the gradient of one full-width temporal
   attention block at the 128^2 top level of a 400-frame video (f32) through
   K3 + K4 against the banded form's autograd, reaching the input, to_qkv,
   to_out and the T5 table.
13. parity T=264 - as phase 4 at 264 frames, past K1's range: exactly 20 K3
   launches, no K1.
14. long videos - full width, 20 DDIM steps, UNet bf16, LFG f32: 128^2 at
   T=400 (cold call, warm call, profile), 128^2 at T=800 (decode chunk 32)
   and 256^2 at T=400 (decode chunk 16), one call each: a finite video of
   the right shape in [0, 1], exactly 200 K3 launches and no K1, K2 or K4,
   seconds, frames/s and peak memory.
15. kernel K5 - the stripe forward of sequence parallelism against its plain
   version (the JAX package's (H, TQ, TK) stripe bias) on the card, TF32 off:
   the 2- and 4-rank splits of the 128^2 top level at T=200 (N=1024, 8 x 32,
   w=40: t_loc 100 and 50) on edge and interior stripes in f32 and bf16,
   both edges, t_loc = w, odd t_loc, no bias (bf16: the tensor-core body);
   one whole sequence cut into stripes on the card (halo by slicing, edge
   flags by position) against K1 at T=200 (2 and 4 stripes) and K3 at T=400
   (2 stripes) in f32, and against the plain version in bf16; kernel,
   plain, SDPA (with the (H, TQ, TK) bias) and bound at the 2-rank stripe in
   bf16.
16. kernel K6 - its backward against its plain version (the stage-2 stripe
   N=1024, t_loc=20, 60 keys, w=20, interior, both edges, the 180-key
   sampling stripe, t_loc = w, odd, no bias, 256 and 320 keys, each in f32
   and bf16); stripe gradients of one sequence, halo rows added to their
   owners, against K2 (f32) and against the plain version of the whole
   sequence at T=480 over two 320-key stripes (f32 and bf16); two calls
   give the same bits; autograd through LocalAttentionStripe on CUDA
   tensors (K5 + K6); kernel, plain, SDPA backward and bound at the stage-2
   stripe in bf16.
   window limits - for K1-K6 in f32 and bf16, the largest window each
   launch's shared memory allows (dawn_local_attn_max_window); one past it
   must raise the ValueError that names the kernel, the limit and the dtype
   before anything is launched (bf16 K1 has no limit; K2 none at any T <=
   256 in either dtype).
17. seq path - a one-rank NCCL process group (file store, no network) and
   its mesh; the UNet's stripe forced, so one card runs the program of an
   edge rank (halo exchange, K5, the GroupNorm all-reduces and the
   quantile all-gather through NCCL): make_seq_sampler against
   sample_one_video (K1) at full width, f32, T=40, 2 steps, same weights and
   noise, tolerance 1e-3; then the 128^2 T=200 20-step bf16 video: finite,
   in [0, 1], exactly 200 K5 launches and no K1 or K3, cold and warm
   seconds, frames/s and peak memory, and the warm call under the profiler.
18. seq train path - DMTrainer.make_sharded_step on that mesh, stripe
   forced: one f32 stage-1 step (bs 1, 20 frames, the fewest a stripe of
   win_width 20 takes) against the unsharded train_step on the card at
   train-parity's tolerances; then 2 full-width bf16 stage-2 steps (bs 4, 40
   diffused frames): finite losses, exactly 10 K5 + 10 K6 launches a step,
   the warm step's time.
19. kernels - one JSON line listing every ported kernel (K1-K6) with its
   numbers and its launches on every path.

The line before the last is nvidia-smi's name and power limit; the last line
is {"ok": true, "device": {...}}.
"""

import json
import os
import shutil
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


def _bound(bytes_moved, flops, rates):
    """(least ms, what bounds it): bytes over the memory rate or bf16
    operations over the peak rate, whichever is larger."""
    bound = {"bytes": bytes_moved / rates[0] * 1e3, "operations": flops / rates[1] * 1e3}
    by = max(bound, key=bound.get)
    return bound[by], by


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


def sass_mma_counts(build):
    """{kernel function: HMMA (tensor-core) instructions in its SASS} over the
    built libraries, from cuobjdump; empty where the toolkit has none."""
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    if not os.path.exists(tool):
        print("build: cuobjdump not found, tensor-core instructions not counted", flush=True)
        return {}
    counts = {}
    for name in build.sources():
        sass = subprocess.run([tool, "-sass", build._library_path(name)], capture_output=True,
                              text=True, check=True).stdout
        fn = None
        for line in sass.splitlines():
            if "Function :" in line:
                fn = line.split("Function :", 1)[1].strip()
                counts[fn] = 0
            elif fn is not None and "HMMA" in line:
                counts[fn] += 1
    return counts


def check(ok, what):
    if not ok:
        raise RuntimeError(f"check failed: {what}")


def kernels_run(fn, seconds=0.5):
    """Names of the CUDA kernels that calls of ``fn`` launched under
    torch.profiler, calling it again for ``seconds``: a session of a few
    milliseconds late in a long process was seen to record no device
    activity at all."""
    import torch
    from torch.profiler import ProfilerActivity
    with torch.profiler.profile(activities=[ProfilerActivity.CPU,
                                            ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        while time.perf_counter() - t0 < seconds:
            fn()
            torch.cuda.synchronize()
    return {e.key for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA}


def kernel_routes():
    """Phase: which kernels bf16 K1, K3, K6 and K2 launch, under the profiler
    at the start of the run: K1 and K3 the tensor-core forward and not the
    CUDA-core one, K6 and K2 the two tensor-core passes and not the f32 ones.
    Launches here are not counted on any path."""
    import torch
    from dawn_tpu_torch.ops import local_attention as la

    gen = torch.Generator(device="cuda").manual_seed(SEED + 70)
    n, t, w = 1024, 200, 40                       # K1 at the sampling top level
    q, k, v = (torch.randn(n, t, 256, device="cuda", generator=gen).to(torch.bfloat16)
               for _ in range(3))
    vec = torch.randn(8, 2 * w + 1, device="cuda", generator=gen)
    ran = kernels_run(lambda: la.local_attention_packed(q, k, v, vec, w, 8))
    print(f"kernel routes: bf16 K1 under the profiler: {sorted(ran)}", flush=True)
    check(any("attn_fwd_mma_kernel" in x for x in ran)
          and not any("local_attn_fwd_kernel" in x for x in ran),
          f"bf16 K1 did not run the tensor-core body alone: {sorted(ran)}")
    n, t, w = 1024, 400, 40                       # K3 at the 400-frame top level
    q, k, v, vec = _tiled_inputs(gen, n, t, 8, w, torch.bfloat16)
    ran = kernels_run(lambda: la.local_attention_tiled(q, k, v, vec, w))
    print(f"kernel routes: bf16 K3 under the profiler: {sorted(ran)}", flush=True)
    check(any("attn_fwd_mma_kernel" in x for x in ran)
          and not any("local_attn_fwd_kernel" in x for x in ran),
          f"bf16 K3 did not run the tensor-core body alone: {sorted(ran)}")
    del q, k, v

    def passes_alone(what, ran):
        print(f"kernel routes: bf16 {what} under the profiler: {sorted(ran)}", flush=True)
        check(any("bwd_query_mma_kernel" in x for x in ran)
              and any("bwd_key_mma_kernel" in x for x in ran)
              and not any("tiled_bwd_" in x or "local_attn_packed_bwd_kernel" in x
                          for x in ran),
              f"bf16 {what} did not run the two tensor-core passes alone: {sorted(ran)}")

    n, t_loc, w = 1024, 20, 20                    # K6 at the stage-2 stripe
    q, kx, vx, g, vec = _stripe_inputs(gen, n, t_loc, w, torch.bfloat16)
    passes_alone("K6", kernels_run(lambda: la.local_attention_packed_stripe_bwd(
        q, kx, vx, g, vec, w, 8, True, False)))
    n, t, w = 4096, 20, 20                        # K2 at the stage-1 top level
    q, k, v, g = (torch.randn(n, t, 256, device="cuda", generator=gen).to(torch.bfloat16)
                  for _ in range(4))
    vec = torch.randn(8, 2 * w + 1, device="cuda", generator=gen)
    passes_alone("K2", kernels_run(lambda: la.local_attention_packed_bwd(q, k, v, g, vec, w, 8)))


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

    # the sampling shape (T=200, w=40), then the training shapes: stage 1's
    # top UNet level (4 x 32^2 sequences of 20 frames, w=20 >= T-1, so every
    # key is in band) and stage 2's largest length bucket (40 frames); edge
    # cases in both dtypes, and windows past T (bf16 clamps the band to T-1)
    f32, bf16 = torch.float32, torch.bfloat16
    cases = [("main f32", 1024, 200, 8, 32, 40, f32, True, 1e-4),
             ("main bf16", 1024, 200, 8, 32, 40, bf16, True, 2e-2),
             ("stage-1 f32", 4096, 20, 8, 32, 20, f32, True, 1e-4),
             ("stage-1 bf16", 4096, 20, 8, 32, 20, bf16, True, 2e-2),
             ("stage-2 T=40 bf16", 4096, 40, 8, 32, 20, bf16, True, 2e-2),
             ("T=77 w=20", 64, 77, 8, 32, 20, f32, True, 1e-4),
             ("T=1", 64, 1, 8, 32, 40, f32, True, 1e-4),
             ("T=256", 64, 256, 8, 32, 40, f32, True, 1e-4),
             ("T=129", 64, 129, 8, 32, 40, f32, True, 1e-4),
             ("no bias", 64, 200, 8, 32, 40, f32, False, 1e-4),
             ("T=77 w=20 bf16", 64, 77, 8, 32, 20, bf16, True, 2e-2),
             ("T=1 bf16", 64, 1, 8, 32, 40, bf16, True, 2e-2),
             ("T=256 bf16", 64, 256, 8, 32, 40, bf16, True, 2e-2),
             ("T=129 bf16", 64, 129, 8, 32, 40, bf16, True, 2e-2),
             ("no bias bf16", 64, 200, 8, 32, 40, bf16, False, 2e-2),
             ("w=300 T=200", 64, 200, 8, 32, 300, f32, True, 1e-4),
             ("w=300 T=200 bf16", 64, 200, 8, 32, 300, bf16, True, 2e-2),
             ("w=20 T=20", 64, 20, 8, 32, 20, f32, True, 1e-4),
             ("w=20 T=20 bf16", 64, 20, 8, 32, 20, bf16, True, 2e-2)]
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

    bytes_moved = 4 * n * t * heads * d * 2 + vec.numel() * 4
    flops = 4 * d * band_entries(t, w) * n * heads
    bound_ms, bound_by = _bound(bytes_moved, flops, rates)
    print(f"kernel K1 timing [{card}] main shape bf16: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
          f"library (sdpa, err {lib_err:.3e}) {library_ms:.4f} ms, bound {bound_ms:.4f} ms "
          f"by {bound_by} ({bytes_moved / 1e6:.1f} MB, {flops / 1e9:.2f} GFLOP)", flush=True)
    return dict(max_abs_err=errs["main bf16"], ms=ms, plain_ms=plain_ms,
                bound_ms=bound_ms, bound_by=bound_by, library_ms=library_ms)


def write_hdtf_tree(root, lengths, size, seed):
    """A synthetic chunked-npy HDTF tree (the layout of scripts/bench_train.py
    --input-pipeline): per video and modality 25-frame chunk_%04d.npy blocks,
    uint8 frames, f32 hubert (1024), pose (7), eye (8) and lmk (68, 2) in
    pixels, and length_dict.pkl. ``lengths`` maps video names to frame
    counts. Returns the CLI's data flags."""
    import pickle
    import numpy as np

    rng = np.random.RandomState(seed)
    kinds = [("frames", (size, size, 3)), ("hubert", (1024,)), ("pose", (7,)),
             ("eye", (8,)), ("lmk", (68, 2))]
    for name, total in lengths.items():
        for kind, shape in kinds:
            d = os.path.join(root, kind, name)
            os.makedirs(d, exist_ok=True)
            for bi in range(-(-total // 25)):
                arr = rng.rand(min(25, total - bi * 25), *shape)
                arr = ((arr * 255).astype(np.uint8) if kind == "frames"
                       else (arr * size).astype(np.float32) if kind == "lmk"
                       else arr.astype(np.float32))
                np.save(os.path.join(d, f"chunk_{bi:04d}.npy"), arr)
    with open(os.path.join(root, "length_dict.pkl"), "wb") as f:
        pickle.dump(dict(lengths), f)
    return [f"--{kind}-dir={os.path.join(root, kind)}" for kind, _ in kinds] + [
        f"--length-dict={os.path.join(root, 'length_dict.pkl')}"]


def band_entries(t, w):
    """In-band (query, key) pairs of one (sequence, head)."""
    return sum(min(t - 1, i + w) - max(0, i - w) + 1 for i in range(t))


def kernel_k2(card, rates):
    """Phase: K2 against its plain version, the autograd Function on the
    card against the plain version's autograd, timings at the stage-1 shape."""
    import numpy as np
    import torch
    import torch.nn.functional as F
    from dawn_tpu_torch.ops import local_attention as la

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    gen = torch.Generator(device="cuda").manual_seed(SEED + 10)

    def inputs(n, t, heads, d, w, dtype, bias=True):
        q, k, v, g = (torch.randn(n, t, heads * d, device="cuda", generator=gen)
                      for _ in range(4))
        vec = torch.randn(heads, 2 * w + 1, device="cuda", generator=gen) if bias else None
        return (q * d ** -0.5).to(dtype), k.to(dtype), v.to(dtype), g.to(dtype), vec

    # stage 1: 4 x 32^2 sequences of 20 frames at the top UNet level, w=20;
    # stage 2: its largest length bucket, 40 diffused frames. Tolerances are
    # on max|err| / max(1, max|ref|): f32 1e-4 (sum order); bf16 2e-2 for
    # dq/dk/dv (stored in bf16; p and dS rounded to bf16 before the products
    # in both, as the JAX kernel rounds them) and 1e-3 for the f32 dvec.
    # Edge cases in both dtypes, and windows past T (the kernel clamps its
    # band to T - 1 and widens the bias gradient; stage 1 itself has w = T).
    f32, bf16 = torch.float32, torch.bfloat16
    cases = [("stage-1 f32", 4096, 20, 8, 32, 20, f32, True),
             ("stage-1 bf16", 4096, 20, 8, 32, 20, bf16, True),
             ("stage-2 T=40 bf16", 4096, 40, 8, 32, 20, bf16, True),
             ("T=77 w=20", 64, 77, 8, 32, 20, f32, True),
             ("T=1", 64, 1, 8, 32, 20, f32, True),
             ("T=129", 64, 129, 8, 32, 40, f32, True),
             ("T=256", 64, 256, 8, 32, 40, f32, True),
             ("no bias", 64, 200, 8, 32, 40, f32, False),
             ("T=77 w=20 bf16", 64, 77, 8, 32, 20, bf16, True),
             ("T=1 bf16", 64, 1, 8, 32, 20, bf16, True),
             ("T=129 bf16", 64, 129, 8, 32, 40, bf16, True),
             ("T=256 bf16", 64, 256, 8, 32, 40, bf16, True),
             ("no bias bf16", 64, 200, 8, 32, 40, bf16, False),
             ("w=300 T=200", 64, 200, 8, 32, 300, f32, True),
             ("w=300 T=200 bf16", 64, 200, 8, 32, 300, bf16, True),
             ("w=255 T=256", 64, 256, 8, 32, 255, f32, True),
             ("w=255 T=256 bf16", 64, 256, 8, 32, 255, bf16, True)]
    errs = {}
    for name, n, t, heads, d, w, dtype, bias in cases:
        q, k, v, g, vec = inputs(n, t, heads, d, w, dtype, bias)
        got = la.local_attention_packed_bwd(q, k, v, g, vec, w, heads)
        ref = la.local_attention_packed_bwd_plain(q, k, v, g, vec, w, heads)
        torch.cuda.synchronize()
        parts = []
        for label, a, b in zip(("dq", "dk", "dv", "dvec"), got, ref):
            if b is None:
                check(a is None, f"K2 {name}: {label} should be None")
                continue
            tol = 1e-3 if label == "dvec" and dtype == torch.bfloat16 else (
                2e-2 if dtype == torch.bfloat16 else 1e-4)
            err = (a.float() - b.float()).abs().max().item()
            rel = err / max(1.0, b.float().abs().max().item())
            errs[(name, label)] = err
            parts.append(f"{label} {err:.3e} (rel {rel:.3e}, tol {tol:g})")
            check(np.isfinite(err) and rel <= tol, f"K2 {name} {label} error {rel} > {tol}")
        print(f"kernel K2 {name}: N={n} T={t} H={heads} dh={d} w={w} {str(dtype)[6:]} "
              + ", ".join(parts), flush=True)

    # two calls give the same bits, dvec included: no atomics, and the bias
    # partials are summed in a fixed order
    for dtype in (f32, bf16):
        q, k, v, g, vec = inputs(4096, 20, 8, 32, 20, dtype)
        first = la.local_attention_packed_bwd(q, k, v, g, vec, 20, 8)
        again = la.local_attention_packed_bwd(q, k, v, g, vec, 20, 8)
        check(all(torch.equal(a, b) for a, b in zip(first, again)),
              f"K2 {str(dtype)[6:]}: two calls differ")
    print("kernel K2 same bits: two calls at the stage-1 shape in f32 and in bf16 give "
          "identical dq, dk, dv and dvec", flush=True)

    # fault 1: a loss through local_attention_packed on CUDA tensors must
    # reach q, k, v and the bias vector, through K1 forward and K2 backward
    n, t, heads, d, w = 64, 40, 8, 32, 20
    q, k, v, g, vec = inputs(n, t, heads, d, w, torch.float32)
    leaves = [x.clone().requires_grad_() for x in (q, k, v, vec)]
    k1_before, k2_before = la.local_attention_packed.launches, la.local_attention_packed_bwd.launches
    out = la.local_attention_packed(*leaves, w, heads)
    check(out.grad_fn is not None, "K1 output on the card has no grad_fn")
    got = torch.autograd.grad(out, leaves, g)
    check(la.local_attention_packed.launches - k1_before == 1
          and la.local_attention_packed_bwd.launches - k2_before == 1,
          "autograd did not go through K1 and K2")
    ref = torch.autograd.grad(la.local_attention_packed_plain(*leaves, w, heads), leaves, g)
    err = max((a - b).abs().max().item() for a, b in zip(got, ref))
    print(f"kernel K2 autograd: grad of local_attention_packed on the card (K1 + K2) vs "
          f"autograd of the plain version, N={n} T={t} f32: max_abs_err={err:.3e} tol=1e-4",
          flush=True)
    check(err <= 1e-4, f"K2 autograd error {err}")

    n, t, heads, d, w = 4096, 20, 8, 32, 20
    q, k, v, g, vec = inputs(n, t, heads, d, w, torch.bfloat16)
    ms = time_ms(lambda: la.local_attention_packed_bwd(q, k, v, g, vec, w, heads), 20)
    plain_ms = time_ms(lambda: la.local_attention_packed_bwd_plain(q, k, v, g, vec, w, heads), 5)
    q4, k4, v4, g4 = (x.view(n, t, heads, d).transpose(1, 2).contiguous() for x in (q, k, v, g))
    q4, k4, v4 = (x.requires_grad_() for x in (q4, k4, v4))
    mask = la.windowed_bias(t, w, vec, "cuda").to(torch.bfloat16)[None]   # (1, H, T, T)
    lib_out = F.scaled_dot_product_attention(q4, k4, v4, attn_mask=mask, scale=1.0)
    lib = lambda: torch.autograd.grad(lib_out, (q4, k4, v4), g4, retain_graph=True)
    library_ms = time_ms(lib, 20)
    ref = la.local_attention_packed_bwd_plain(q, k, v, g, vec, w, heads)
    lib_err = max((a.transpose(1, 2).reshape(n, t, heads * d).float() - b.float())
                  .abs().max().item() for a, b in zip(lib(), ref[:3]))
    k1_ms = time_ms(lambda: la.local_attention_packed(q, k, v, vec, w, heads), 20)
    k1_plain_ms = time_ms(lambda: la.local_attention_packed_plain(q, k, v, vec, w, heads), 5)
    with torch.no_grad():
        k1_library_ms = time_ms(lambda: F.scaled_dot_product_attention(
            q4, k4, v4, attn_mask=mask, scale=1.0), 20)
    k1_bound, k1_by = _bound(4 * n * t * heads * d * 2 + vec.numel() * 4,
                             4 * d * band_entries(t, w) * n * heads, rates)

    bytes_moved = 7 * n * t * heads * d * 2 + 2 * vec.numel() * 4
    flops = 10 * d * band_entries(t, w) * n * heads
    bound_ms, bound_by = _bound(bytes_moved, flops, rates)
    print(f"kernel K2 timing [{card}] stage-1 shape bf16 (N={n} T={t} 8x32 w={w}): kernel "
          f"{ms:.4f} ms, plain {plain_ms:.4f} ms, library (sdpa backward, dq/dk/dv only, "
          f"err {lib_err:.3e}) {library_ms:.4f} ms, bound {bound_ms:.4f} ms by "
          f"{bound_by} ({bytes_moved / 1e6:.1f} MB, {flops / 1e9:.2f} GFLOP); K1 at the "
          f"same shape {k1_ms:.4f} ms, plain {k1_plain_ms:.4f} ms, library (sdpa) "
          f"{k1_library_ms:.4f} ms, bound {k1_bound:.4f} ms by {k1_by}", flush=True)
    return dict(max_abs_err=max(errs[("stage-1 bf16", x)] for x in ("dq", "dk", "dv")),
                ms=ms, plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
                library_ms=library_ms)


def inputs_for(t, img_size, seed):
    import torch
    g = torch.Generator().manual_seed(seed)
    return dict(sample_img=torch.rand(1, img_size, img_size, 3, generator=g),
                audio_hubert=torch.randn(1, t, 1024, generator=g),
                pose=0.1 * torch.randn(1, t, 6, generator=g),
                eye=0.1 * torch.randn(1, t, 2, generator=g),
                bbox=torch.tensor([[30.0, 98.0, 25.0, 105.0, img_size, img_size]]))


def parity(t=40):
    """Phase 4 (T=40, K1) and the long parity phase (T=264, K3): the card
    (kernel) against the CPU (plain path), f32, TF32 off."""
    import torch
    from dawn_tpu_torch.models.dm.flow_diffusion import FlowDiffusion, FlowDiffusionConfig

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    steps = 2
    kernel = 0 if t <= 256 else 2                 # K1, or K3 past the packed range
    cfg = FlowDiffusionConfig(sampling_timesteps=steps, dtype=torch.float32)
    torch.manual_seed(SEED)
    gpu = FlowDiffusion(cfg, device="cuda")
    cpu = FlowDiffusion(cfg, device="cpu")
    cpu.load_state_dict(gpu.state_dict())
    inp = inputs_for(t, cfg.img_size, SEED + 1)
    noise = torch.randn((steps + 1, 1, t, cfg.latent_size, cfg.latent_size, 3),
                        generator=torch.Generator().manual_seed(SEED + 2))
    _reset_counts()
    out_gpu = gpu.sample_one_video(**inp, noise_seq=noise)["sample_out_vid"].cpu()
    launches = _counts()
    want = tuple(10 * steps if i == kernel else 0 for i in range(6))
    check(launches == want, f"parity launches (K1-K6) {launches} != {want}")
    t0 = time.perf_counter()
    out_cpu = cpu.sample_one_video(**inp, noise_seq=noise)["sample_out_vid"]
    cpu_s = time.perf_counter() - t0
    err = (out_gpu - out_cpu).abs().max().item()
    print(f"parity: sample_one_video T={t} steps={steps} f32 full width, card (K{kernel + 1} x "
          f"{launches[kernel]}) vs CPU (plain, {cpu_s:.1f} s), TF32 off: max_abs_err={err:.3e} "
          f"tol=1e-3", flush=True)
    check(err <= 1e-3, f"parity error {err}")
    del gpu, cpu
    torch.cuda.empty_cache()


def profile(run, card, what="profile"):
    """Where a warm run's device time goes (torch.profiler)."""
    import torch
    from torch.profiler import ProfilerActivity
    with torch.profiler.profile(activities=[ProfilerActivity.CPU,
                                            ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    kernels = [e for e in prof.key_averages()         # kernels, not annotated spans
               if e.device_type == torch.autograd.DeviceType.CUDA
               and not getattr(e, "is_user_annotation", False)]
    busy = sum(e.self_device_time_total for e in kernels) / 1e6
    check(busy > 0, "the profiler saw no device time")
    print(f"{what} [{card}]: warm run under the profiler {wall:.3f} s, device busy "
          f"{busy:.3f} s ({100 * busy / wall:.1f} %), {sum(e.count for e in kernels)} "
          f"kernel launches", flush=True)
    top = sorted(kernels, key=lambda e: -e.self_device_time_total)
    for e in top[:12]:
        print(f"{what}   {e.self_device_time_total / 1e3:9.2f} ms  {e.count:6d} x  "
              f"{e.key[:110]}", flush=True)
    for e in top[12:]:      # the port's own kernels, wherever they rank
        if any(s in e.key for s in ("local_attn", "tiled_bwd", "_mma_kernel")):
            print(f"{what}   {e.self_device_time_total / 1e3:9.2f} ms  {e.count:6d} x  "
                  f"{e.key[:110]} (port kernel, rank {top.index(e) + 1})", flush=True)


def _wrappers():
    """The kernel wrappers K1-K6, each with its launch count."""
    from dawn_tpu_torch.ops import local_attention as la
    return (la.local_attention_packed, la.local_attention_packed_bwd,
            la.local_attention_tiled, la.local_attention_tiled_bwd,
            la.local_attention_packed_stripe, la.local_attention_packed_stripe_bwd)


def _reset_counts():
    for fn in _wrappers():
        fn.launches = 0


def _counts():
    """(K1, ..., K6) launches since the last reset."""
    return tuple(fn.launches for fn in _wrappers())


def _train_batch(b, t, size, seed):
    import numpy as np
    r = np.random.RandomState(seed)
    return {"video": (r.rand(b, t, size, size, 3) * 255).astype(np.uint8),
            "hubert": r.randn(b, t, 1024).astype(np.float32),
            "pose": 0.1 * r.randn(b, t, 7).astype(np.float32),
            "blink": r.rand(b, t, 2).astype(np.float32),
            "bbox": np.tile([30.0, 98.0, 25.0, 105.0, size, size], (b, 1)).astype(np.float32),
            "mouth_lmk": (40 + 40 * r.rand(b, t, 19, 2)).astype(np.float32)}


def train_parity():
    """Phase 8: one f32 stage-1 train step, the card (K1, K2) against the CPU
    (plain path), full width, same weights and draws, TF32 off."""
    import numpy as np
    import torch
    from dawn_tpu_torch.train.train_dm import DMTrainConfig, DMTrainer

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    b, t, lr = 1, 4, 2e-4
    cfg = DMTrainConfig(win_width=20, lr=lr)       # 128^2, full width, f32, jitter on
    torch.manual_seed(SEED)
    gpu = DMTrainer(cfg, device="cuda")
    cpu = DMTrainer(cfg, device="cpu")
    for a, c in ((gpu.unet, cpu.unet), (gpu.flow_ae, cpu.flow_ae), (gpu.face_loc, cpu.face_loc)):
        c.load_state_dict(a.state_dict())
    cpu.ema = [e.cpu().clone() for e in gpu.ema]
    r = np.random.RandomState(SEED + 5)
    ls = cfg.latent_size
    draws = {"t": np.array([371]), "noise": r.randn(b, t, ls, ls, 3).astype(np.float32),
             "drop": np.array([[False, True, False, False]]),
             "jitter": {k: torch.tensor([v]) for k, v in (
                 ("brightness", 1.1), ("contrast", 0.9), ("saturation", 1.2), ("hue", 0.02))}}
    batch = _train_batch(b, t, cfg.img_size, SEED + 6)
    before = [p.detach().cpu().clone() for p in gpu.unet.parameters()]
    _reset_counts()
    got = gpu.train_step(batch, draws)
    launches = _counts()
    want = cpu.train_step(batch, draws)
    check(launches == (10, 10, 0, 0, 0, 0),
          f"train-parity launches (K1-K6) {launches} != (10, 10, 0, 0, 0, 0)")
    for k in ("loss", "floss", "mouth_loss", "total"):
        check(abs(got[k] - want[k]) <= 1e-4 * max(1.0, abs(want[k])),
              f"train-parity {k}: {got[k]} vs {want[k]}")
    # gradients through Adam's first moment (0.1 x the clipped gradient): to
    # 1e-3 of the largest; the update: Adam's first step is about lr * sign(g),
    # so elements with |mu| above 1e-3 of the largest agree to 1e-7 (+1e-6
    # relative), the rest to 2 lr + 1e-7 (a rounding difference may flip a
    # near-zero gradient's sign)
    pairs = list(zip(gpu.unet.parameters(), cpu.unet.parameters(), before))
    mu = [(gpu.optimizer.state[a]["mu"].cpu(), cpu.optimizer.state[c]["mu"]) for a, c, _ in pairs]
    mu_max = max(m.abs().max().item() for _, m in mu)
    mu_err = max((g - c).abs().max().item() for g, c in mu) / mu_max
    upd_err = clear_err = 0.0
    for (a, c, old), (_, m) in zip(pairs, mu):
        diff = (a.detach().cpu() - c.detach()).abs()
        upd_err = max(upd_err, diff.max().item())
        clear = m.abs() > 1e-3 * mu_max
        if clear.any():
            clear_err = max(clear_err, (diff[clear] - 1e-6 * old[clear].abs()).max().item())
    print(f"train-parity: stage-1 train_step f32 full width bs {b} T={t}, card (K1 x "
          f"{launches[0]}, K2 x {launches[1]}) vs CPU (plain), TF32 off: total "
          f"{got['total']:.6f} vs {want['total']:.6f}, loss {got['loss']:.6f} vs "
          f"{want['loss']:.6f}, floss {got['floss']:.6f} vs {want['floss']:.6f}, mouth "
          f"{got['mouth_loss']:.6f} vs {want['mouth_loss']:.6f} (tol 1e-4 rel); grad norm "
          f"{got['grad_norm']:.5f} vs {want['grad_norm']:.5f}; Adam mu max err "
          f"{mu_err:.3e} of its max (tol 1e-3); update max err {upd_err:.3e} (tol "
          f"{2 * lr + 1e-7:.3g}), where |mu| > 1e-3 max {clear_err:.3e} (tol 1e-7)", flush=True)
    check(mu_err <= 1e-3, f"train-parity gradient error {mu_err}")
    check(upd_err <= 2 * lr + 1e-7 and clear_err <= 1e-7,
          f"train-parity update error {upd_err} / {clear_err}")
    del gpu, cpu
    torch.cuda.empty_cache()


def train_path(card):
    """Phase 9: the training CLI at the per-chip recipe point; returns the
    (K1, ..., K6) launches of its stage-1 and stage-2 runs."""
    import tempfile
    import numpy as np
    import torch
    import yaml
    from dawn_tpu_torch.scripts import train_dm as cli
    from dawn_tpu_torch.train.data import HDTFVideoDataset

    torch.backends.cudnn.allow_tf32 = True      # PyTorch's default for convs
    root = os.path.dirname(os.path.abspath(__file__))
    tmp = tempfile.mkdtemp(prefix="dawn_train_")
    flags = write_hdtf_tree(os.path.join(tmp, "data"),
                            {f"vid_{i:03d}": 100 for i in range(8)}, 128, SEED + 7)

    def config(name):
        with open(os.path.join(root, "configs", name)) as f:
            cfg = yaml.safe_load(f)
        cfg.update(batch_size=4, compute_dtype="bfloat16")   # the per-chip recipe point
        path = os.path.join(tmp, name)
        with open(path, "w") as f:
            yaml.safe_dump(cfg, f)
        return path

    work1, work2, steps = os.path.join(tmp, "s1"), os.path.join(tmp, "s2"), 4
    base = [f"--config={config('dm_train_stage1.yaml')}", *flags, "--log-every=1",
            f"--workdir={work1}"]
    cli.main(base + ["--steps=0"])              # the step-0 checkpoint
    torch.cuda.reset_peak_memory_stats()
    _reset_counts()
    t0 = time.perf_counter()
    trainer = cli.main(base + [f"--steps={steps}", "--restore"])
    secs = time.perf_counter() - t0
    launches1 = _counts()
    peak_gb = torch.cuda.max_memory_allocated() / 2**30
    check(launches1 == (10 * steps, 10 * steps, 0, 0, 0, 0),
          f"stage-1 launches (K1-K6) {launches1} != {10 * steps} K1 and K2")
    lines = [json.loads(x) for x in open(os.path.join(work1, "metrics.jsonl"))]
    check([x["step"] for x in lines] == list(range(steps)), "stage-1 metrics.jsonl steps")
    check(all(np.isfinite(x[k]) for x in lines for k in ("total", "loss", "floss", "mouth_loss"))
          and all(x["grads_finite"] == 1.0 for x in lines), "stage-1 losses not finite")
    ck0 = torch.load(os.path.join(work1, "ckpt", "step_0000000.pt"), weights_only=True)
    ck = torch.load(cli.latest_checkpoint(os.path.join(work1, "ckpt")), weights_only=True)
    now = trainer.state_dict()
    check(ck["step"] == steps == trainer.step, "checkpoint step")
    check(all(torch.equal(ck["unet"][k].cpu(), v.cpu()) for k, v in now["unet"].items())
          and all(torch.equal(a.cpu(), b.cpu()) for a, b in zip(ck["ema"], now["ema"])),
          "checkpoint does not round-trip the trainer state")
    changed = sum(not torch.equal(ck0["unet"][k], ck["unet"][k]) for k in ck["unet"])
    ema_changed = sum(not torch.equal(a, b) for a, b in zip(ck0["ema"], ck["ema"]))
    check(changed > 0 and ema_changed > 0, "parameters or EMA did not change")
    walls = [x["wall"] for x in lines]
    print(f"train path [{card}] stage 1: CLI, bs 4, 20 frames, 128^2, full width, bf16, "
          f"uncached teacher + color jitter, {steps} steps resumed from a step-0 "
          f"checkpoint in {secs:.2f} s; totals {[round(x['total'], 4) for x in lines]}; "
          f"step wall times (s) {[round(w, 3) for w in walls]}; {changed}/{len(ck['unet'])} "
          f"UNet tensors and {ema_changed} EMA tensors changed; checkpoint round-trips; "
          f"K1 x {launches1[0]}, K2 x {launches1[1]}; peak memory {peak_gb:.2f} GiB", flush=True)

    dirs = dict(f[2:].split("=", 1) for f in flags)
    ds = HDTFVideoDataset(dirs["frames-dir"], dirs["hubert-dir"], dirs["pose-dir"],
                          dirs["eye-dir"], dirs["length-dict"], lmk_dir=dirs["lmk-dir"],
                          num_frames=20, seed=SEED)
    batches = list(ds.batches(4, 3))
    times = []
    for batch in batches:
        t0 = time.perf_counter()
        trainer.train_step(batch)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    warm = float(np.median(times))
    print(f"train path [{card}] stage 1 warm train_step on resident batches: "
          f"{[round(1e3 * x, 1) for x in times]} ms, median {1e3 * warm:.1f} ms = "
          f"{4 / warm:.2f} examples/s ({80 / warm:.1f} frames/s)", flush=True)
    profile(lambda: trainer.train_step(batches[0]), card, "train profile")
    del trainer
    torch.cuda.empty_cache()

    steps2 = 2
    _reset_counts()
    t0 = time.perf_counter()
    trainer2 = cli.main([f"--config={config('dm_train_stage2.yaml')}", "--stage=2", *flags,
                         f"--steps={steps2}", "--log-every=1", f"--workdir={work2}"])
    secs2 = time.perf_counter() - t0
    launches2 = _counts()
    check(launches2 == (10 * steps2, 10 * steps2, 0, 0, 0, 0),
          f"stage-2 launches (K1-K6) {launches2} != {10 * steps2} K1 and K2")
    lines2 = [json.loads(x) for x in open(os.path.join(work2, "metrics.jsonl"))]
    check(trainer2.step == steps2 and all(np.isfinite(x["total"]) for x in lines2),
          "stage-2 losses not finite")
    print(f"train path [{card}] stage 2: CLI, bs 4, clips of {[x['frames'] for x in lines2]} "
          f"frames (frame 0 split off), {steps2} steps in {secs2:.2f} s (model build "
          f"included); totals {[round(x['total'], 4) for x in lines2]}; step wall times (s) "
          f"{[round(x['wall'], 3) for x in lines2]}; K1 x {launches2[0]}, K2 x "
          f"{launches2[1]}", flush=True)
    del trainer2
    torch.cuda.empty_cache()
    shutil.rmtree(tmp)
    return tuple(a + b for a, b in zip(launches1, launches2))


def _tiled_inputs(gen, n, t, heads, w, dtype, bias=True, grad=False):
    """Random (N, H, T, 32) q (pre-scaled), k, v (and g) with a (H, 2w+1)
    f32 bias vector."""
    import torch
    xs = [torch.randn(n, heads, t, 32, device="cuda", generator=gen)
          for _ in range(4 if grad else 3)]
    xs[0] = xs[0] * 32 ** -0.5
    vec = torch.randn(heads, 2 * w + 1, device="cuda", generator=gen) if bias else None
    return [x.to(dtype) for x in xs] + [vec]


def kernel_k3(card, rates):
    """Phase: K3 against its plain version (the banded form) case by case;
    timings at the 128^2 top-level shapes of T=400 and T=800."""
    import numpy as np
    import torch
    import torch.nn.functional as F
    from dawn_tpu_torch.ops import local_attention as la

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    gen = torch.Generator(device="cuda").manual_seed(SEED + 20)
    f32, bf16 = torch.float32, torch.bfloat16
    # the sampling top level (N = 32^2 sequences, 8 heads, w = 40) at 400 and
    # 800 frames; just past the packed range; odd T; T = 1; one 128-query
    # tile; no bias; w = 20; the 256^2 top level (N = 64^2; checked on its
    # first and last 256 sequences, where the grid starts and ends); in bf16
    # also w = 400 at T = 1024, past the CUDA-core body's w <= 370.
    # Tolerances: f32 1e-4 (sum order); bf16 2e-2 (one bf16 ulp of outputs
    # in [2, 4)).
    cases = [("main T=400 f32", 1024, 400, 40, f32, True, 1e-4),
             ("main T=400 bf16", 1024, 400, 40, bf16, True, 2e-2),
             ("main T=800 bf16", 1024, 800, 40, bf16, True, 2e-2),
             ("T=800 f32", 64, 800, 40, f32, True, 1e-4),
             ("T=257 w=20", 64, 257, 20, f32, True, 1e-4),
             ("T=333", 64, 333, 40, f32, True, 1e-4),
             ("T=333 w=20 bf16", 64, 333, 20, bf16, True, 2e-2),
             ("T=1", 64, 1, 40, f32, True, 1e-4),
             ("single tile T=100", 64, 100, 40, f32, True, 1e-4),
             ("no bias", 64, 400, 40, f32, False, 1e-4),
             ("T=1 bf16", 64, 1, 40, bf16, True, 2e-2),
             ("single tile T=100 bf16", 64, 100, 40, bf16, True, 2e-2),
             ("no bias bf16", 64, 400, 40, bf16, False, 2e-2),
             ("T=257 w=20 bf16", 64, 257, 20, bf16, True, 2e-2),
             ("T=1024 w=400 bf16", 32, 1024, 400, bf16, True, 2e-2),
             ("256^2 top N=4096 T=400 bf16", 4096, 400, 40, bf16, True, 2e-2)]
    errs = {}
    for name, n, t, w, dtype, bias, tol in cases:
        q, k, v, vec = _tiled_inputs(gen, n, t, 8, w, dtype, bias)
        got = la.local_attention_tiled(q, k, v, vec, w)
        parts = [slice(0, 256), slice(n - 256, n)] if n > 1024 else [slice(0, n)]
        err = max((got[p].float() - la.local_attention_banded(q[p], k[p], v[p], vec, w).float())
                  .abs().max().item() for p in parts)
        torch.cuda.synchronize()
        errs[name] = err
        print(f"kernel K3 {name}: N={n} H=8 T={t} dh=32 w={w} {str(dtype)[6:]} "
              f"max_abs_err={err:.3e} tol={tol:g}", flush=True)
        check(err <= tol and np.isfinite(err), f"K3 {name} error {err} > {tol}")
        del q, k, v, got

    timing = {}
    for t in (400, 800):
        n, heads, w = 1024, 8, 40
        q, k, v, vec = _tiled_inputs(gen, n, t, heads, w, bf16)
        ms = time_ms(lambda: la.local_attention_tiled(q, k, v, vec, w), 10)
        plain_ms = time_ms(lambda: la.local_attention_banded(q, k, v, vec, w), 3)
        mask = la.windowed_bias(t, w, vec, "cuda").to(bf16)[None]        # (1, H, T, T)
        library_ms = time_ms(lambda: F.scaled_dot_product_attention(
            q, k, v, attn_mask=mask, scale=1.0), 10)
        bound_ms, bound_by = _bound(4 * q.numel() * 2 + vec.numel() * 4,
                                    4 * 32 * band_entries(t, w) * n * heads, rates)
        timing[t] = dict(ms=ms, plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
                         library_ms=library_ms)
        print(f"kernel K3 timing [{card}] 128^2 top level T={t} bf16 (N={n} 8x32 w={w}): "
              f"kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, library (sdpa with the (H, T, T) "
              f"bias) {library_ms:.4f} ms, bound {bound_ms:.4f} ms by {bound_by}", flush=True)
        del q, k, v, mask
        torch.cuda.empty_cache()
    return dict(max_abs_err=errs["main T=400 bf16"], **timing[400],
                at_T800=dict(max_abs_err=errs["main T=800 bf16"], **timing[800]))


def kernel_k4(card, rates):
    """Phase: K4 against its plain version case by case; autograd through
    local_attention on CUDA tensors (K3 + K4) against the plain autograd;
    timings at the 128^2 top-level shapes of T=400 and T=800."""
    import numpy as np
    import torch
    from dawn_tpu_torch.ops import local_attention as la

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    gen = torch.Generator(device="cuda").manual_seed(SEED + 30)
    f32, bf16 = torch.float32, torch.bfloat16

    def compare(name, n, t, w, dtype, got, ref):
        tol = 2e-2 if dtype == bf16 else 1e-4       # of each tensor's largest magnitude
        parts, worst = [], 0.0
        for label, a, b in zip(("dq", "dk", "dv", "dvec"), got, ref):
            if b is None:
                check(a is None, f"K4 {name}: {label} should be None")
                continue
            err = (a.float() - b.float()).abs().max().item()
            rel = err / max(1e-30, b.float().abs().max().item())
            worst = max(worst, err) if label != "dvec" else worst
            parts.append(f"{label} {err:.3e} (rel {rel:.3e})")
            check(np.isfinite(err) and rel <= tol, f"K4 {name} {label} error {rel} > {tol}")
        print(f"kernel K4 {name}: N={n} H=8 T={t} dh=32 w={w} {str(dtype)[6:]} "
              + ", ".join(parts) + f"; tol {tol:g} of max|ref|", flush=True)
        return worst

    # the sampling top level at 400 frames (bf16) and its f32 form on fewer
    # sequences; 800 frames; just past the packed range; odd T; T = 1; one
    # 64-row tile; no bias; a window wider than a tile (w = 70)
    cases = [("T=400 f32", 256, 400, 40, f32, True),
             ("T=800 f32", 64, 800, 40, f32, True),
             ("T=257 w=20", 64, 257, 20, f32, True),
             ("T=333 bf16", 64, 333, 40, bf16, True),
             ("T=1", 64, 1, 40, f32, True),
             ("single tile T=50", 64, 50, 40, f32, True),
             ("no bias", 64, 400, 40, f32, False),
             ("w=70", 64, 300, 70, f32, True),
             ("T=257 w=20 bf16", 64, 257, 20, bf16, True),
             ("T=1 bf16", 64, 1, 40, bf16, True),
             ("single tile T=50 bf16", 64, 50, 40, bf16, True),
             ("no bias bf16", 64, 400, 40, bf16, False),
             ("w=70 bf16", 64, 300, 70, bf16, True)]
    for name, n, t, w, dtype, bias in cases:
        q, k, v, g, vec = _tiled_inputs(gen, n, t, 8, w, dtype, bias, grad=True)
        compare(name, n, t, w, dtype, la.local_attention_tiled_bwd(q, k, v, g, vec, w),
                la.local_attention_tiled_bwd_plain(q, k, v, g, vec, w))

    # a loss through local_attention on CUDA tensors must reach q, k, v and
    # the bias vector, through K3 forward and K4 backward
    n, t, w = 64, 300, 40
    q, k, v, g, vec = _tiled_inputs(gen, n, t, 8, w, f32, grad=True)
    leaves = [x.clone().requires_grad_() for x in (q, k, v, vec)]
    _reset_counts()
    out = la.local_attention(*leaves, w)
    check(out.grad_fn is not None, "K3 output on the card has no grad_fn")
    got = torch.autograd.grad(out, leaves, g)
    check(_counts() == (0, 0, 1, 1, 0, 0), f"autograd launches (K1-K6) {_counts()}")
    ref = torch.autograd.grad(la.local_attention_banded(*leaves, w), leaves, g)
    err = max(((a - b).abs().max() / b.abs().max()).item() for a, b in zip(got, ref))
    print(f"kernel K4 autograd: grad of local_attention on the card (K3 + K4) vs autograd of "
          f"the plain version, N={n} T={t} f32, q/k/v/bias: max err {err:.3e} of max|ref| "
          f"(tol 1e-4)", flush=True)
    check(err <= 1e-4, f"K4 autograd error {err}")
    # the same in bf16 at T=400 (K3 + the tensor-core K4), 2e-2 of each
    # tensor's max|ref| as the bf16 cases above
    n, t, w = 64, 400, 40
    q, k, v, g, vec = _tiled_inputs(gen, n, t, 8, w, bf16, grad=True)
    leaves = [x.clone().requires_grad_() for x in (q, k, v, vec)]
    _reset_counts()
    got = torch.autograd.grad(la.local_attention(*leaves, w), leaves, g)
    check(_counts() == (0, 0, 1, 1, 0, 0), f"bf16 autograd launches (K1-K6) {_counts()}")
    ref = torch.autograd.grad(la.local_attention_banded(*leaves, w), leaves, g)
    errs = [((a.float() - b.float()).abs().max() / b.float().abs().max()).item()
            for a, b in zip(got, ref)]
    print(f"kernel K4 autograd bf16: grad of local_attention on the card (K3 + K4) vs autograd "
          f"of the plain version, N={n} T={t}: max err / max|ref| for q {errs[0]:.3e}, k "
          f"{errs[1]:.3e}, v {errs[2]:.3e}, bias {errs[3]:.3e} (tol 2e-2)", flush=True)
    check(np.isfinite(max(errs)) and max(errs) <= 2e-2, f"K4 bf16 autograd error {errs}")

    timing = {}
    for t in (400, 800):
        n, heads, w = 1024, 8, 40
        q, k, v, g, vec = _tiled_inputs(gen, n, t, heads, w, bf16, grad=True)
        ms = time_ms(lambda: la.local_attention_tiled_bwd(q, k, v, g, vec, w), 5)
        err = compare(f"main T={t} bf16", n, t, w, bf16,
                      la.local_attention_tiled_bwd(q, k, v, g, vec, w),
                      la.local_attention_tiled_bwd_plain(q, k, v, g, vec, w))
        torch.cuda.empty_cache()
        plain_ms = time_ms(lambda: la.local_attention_tiled_bwd_plain(q, k, v, g, vec, w), 2)
        torch.cuda.empty_cache()
        mask = la.windowed_bias(t, w, vec, "cuda").to(bf16)[None]        # (1, H, T, T)
        ql, kl, vl = (x.detach().clone().requires_grad_() for x in (q, k, v))
        lib_out = torch.nn.functional.scaled_dot_product_attention(ql, kl, vl, attn_mask=mask,
                                                                   scale=1.0)
        library_ms = time_ms(lambda: torch.autograd.grad(lib_out, (ql, kl, vl), g,
                                                         retain_graph=True), 5)
        bound_ms, bound_by = _bound(7 * q.numel() * 2 + 2 * vec.numel() * 4,
                                    10 * 32 * band_entries(t, w) * n * heads, rates)
        timing[t] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                         bound_by=bound_by, library_ms=library_ms)
        print(f"kernel K4 timing [{card}] 128^2 top level T={t} bf16 (N={n} 8x32 w={w}): "
              f"kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, library (sdpa backward, dq/dk/dv "
              f"only) {library_ms:.4f} ms, bound {bound_ms:.4f} ms by {bound_by}", flush=True)
        del q, k, v, g, ql, kl, vl, lib_out, mask
        torch.cuda.empty_cache()
    return dict(**timing[400], at_T800=timing[800])


def temporal_attention_grad(card):
    """Phase: the gradient of one full-width TemporalAttention at the 128^2
    top-level shape of a 400-frame video (1 x 32^2 tokens x 400 frames x 64
    channels, 8 heads x 32, w=40, f32, TF32 off) through K3 + K4, reaching
    to_qkv, to_out, the T5 table and the input, against the same module with
    the plain banded form's autograd in K3's place. Returns the (K1, ..., K6)
    launches of the K3 + K4 run."""
    from unittest import mock
    import torch
    from dawn_tpu_torch.models.dm import unet3d
    from dawn_tpu_torch.ops import local_attention as la
    from dawn_tpu_torch.ops.t5bias import t5_bias_windowed_vector

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.manual_seed(SEED + 40)
    c, t, w = 64, 400, 40
    attn = unet3d.TemporalAttention(c, 8, 32, "local", w, torch.float32).cuda()
    table = torch.nn.Embedding(32, 8).cuda()
    gen = torch.Generator(device="cuda").manual_seed(SEED + 41)
    x = torch.randn(1, 32 * 32, t, c, device="cuda", generator=gen).requires_grad_()
    gout = torch.randn(1, 32 * 32, t, c, device="cuda", generator=gen)
    params = [x, attn.to_qkv.weight, attn.to_out.weight, table.weight]

    def grads():
        vec = t5_bias_windowed_vector(table.weight, w, 32, 32)
        return torch.autograd.grad(attn(x, None, vec), params, gout)

    _reset_counts()
    got = grads()
    torch.cuda.synchronize()
    launches = _counts()
    check(launches == (0, 0, 1, 1, 0, 0), f"TemporalAttention launches (K1-K6) {launches}")
    with mock.patch.object(unet3d, "local_attention", la.local_attention_banded):
        ref = grads()
    errs = [((a - b).abs().max() / b.abs().max()).item() for a, b in zip(got, ref)]
    print(f"kernel K4 TemporalAttention [{card}]: grad of one full-width block at the 128^2 "
          f"top level, T={t}, f32, through K3 x {launches[2]} + K4 x {launches[3]} vs the "
          f"banded form's autograd: max err / max|ref| for x {errs[0]:.3e}, to_qkv "
          f"{errs[1]:.3e}, to_out {errs[2]:.3e}, T5 table {errs[3]:.3e} (tol 1e-4)", flush=True)
    check(max(errs) <= 1e-4, f"TemporalAttention gradient error {errs}")
    del attn, x, gout, got, ref
    torch.cuda.empty_cache()
    return launches


def video_path(card, t, img_size=128, decode_chunk=0, timed=False):
    """Phases 5-6 (T=200) and the long videos: one full-width 20-step video
    (UNet bf16, LFG f32, random weights from the seed); with ``timed``, a
    cold call, a warm call and a profiled call. Checks exactly 200 launches
    of K1 (T <= 256) or K3 (T > 256) and none of the other kernels in the
    (warm) call, and returns its (K1, ..., K6) launches."""
    import torch
    from dawn_tpu_torch.models.dm.flow_diffusion import FlowDiffusion, FlowDiffusionConfig

    torch.backends.cudnn.allow_tf32 = True      # PyTorch's default for convs
    cfg = FlowDiffusionConfig(img_size=img_size, lfg_decode_chunk=decode_chunk)
    torch.manual_seed(SEED)
    model = FlowDiffusion(cfg)
    inp = inputs_for(t, img_size, SEED + 3)

    def run():
        g = torch.Generator(device="cuda").manual_seed(SEED + 4)
        out = model.sample_one_video(**inp, generator=g)
        torch.cuda.synchronize()
        return out

    cold = None
    if timed:
        t0 = time.perf_counter()
        run()
        cold = time.perf_counter() - t0
    torch.cuda.reset_peak_memory_stats()
    _reset_counts()
    t0 = time.perf_counter()
    out = run()
    secs = time.perf_counter() - t0
    launches = _counts()
    vid = out["sample_out_vid"]
    shape = (1, t, img_size, img_size, 3)
    check(tuple(vid.shape) == shape, f"video shape {tuple(vid.shape)} != {shape}")
    check(bool(torch.isfinite(vid).all()), "video has non-finite values")
    lo, hi = vid.min().item(), vid.max().item()
    check(0.0 <= lo and hi <= 1.0, f"video range [{lo}, {hi}]")
    kernel = 0 if t <= 256 else 2                 # K1, or K3 past the packed range
    want = tuple(200 if i == kernel else 0 for i in range(6))
    check(launches == want, f"launches (K1-K6) {launches} != {want}")
    peak_gb = torch.cuda.max_memory_allocated() / 2**30
    what = "path" + ("" if t == 200 else f" T={t}") + ("" if img_size == 128 else f" {img_size}^2")
    print(f"{what} [{card}]: {img_size}^2 T={t} 20 DDIM steps UNet bf16 LFG f32 decode chunk "
          f"{decode_chunk or 'all'}: video {tuple(vid.shape)} in [{lo:.4f}, {hi:.4f}], "
          f"launches K1 {launches[0]}, K2 {launches[1]}, K3 {launches[2]}, K4 {launches[3]}; "
          + (f"cold call {cold:.2f} s, warm call " if timed else "one call (cold) ")
          + f"{secs:.3f} s = {t / secs:.2f} frames/s, peak memory {peak_gb:.2f} GiB", flush=True)
    if timed:
        profile(run, card, "profile" + ("" if t == 200 else f" T={t}"))
    del model, out, vid
    torch.cuda.empty_cache()
    return launches


def _stripe(x, r, ranks, w):
    """Rank r's haloed stripe of a whole (N, T, HD) sequence split over
    ``ranks``: its T/ranks rows and w rows on each side (zeros past the
    ends), as the halo exchange assembles it."""
    import torch.nn.functional as F
    t_loc = x.shape[1] // ranks
    return F.pad(x, (0, 0, w, w))[:, r * t_loc:r * t_loc + t_loc + 2 * w].contiguous()


def stripe_pairs(t_loc, w, left, right):
    """(query, key) pairs a stripe attends: query i over key rows [i, i + 2w]
    cut to [w, ...] at the left edge and to [..., w + t_loc - 1] at the right."""
    kmin, kmax = (w if left else 0), (w + t_loc - 1 if right else t_loc + 2 * w - 1)
    return sum(min(i + 2 * w, kmax) - max(i, kmin) + 1 for i in range(t_loc))


def stripe_key_rows(t_loc, w, left, right):
    """Haloed key rows a stripe reads: a masked halo is never needed."""
    return t_loc + 2 * w - (w if left else 0) - (w if right else 0)


def _stripe_inputs(gen, n, t_loc, w, dtype, bias=True):
    """q (pre-scaled), haloed k, v and g of 8 heads x 32, and a (8, 2w+1)
    f32 bias vector."""
    import torch
    q, g = (torch.randn(n, t_loc, 256, device="cuda", generator=gen) for _ in range(2))
    kx, vx = (torch.randn(n, t_loc + 2 * w, 256, device="cuda", generator=gen)
              for _ in range(2))
    vec = torch.randn(8, 2 * w + 1, device="cuda", generator=gen) if bias else None
    return (q * 32 ** -0.5).to(dtype), kx.to(dtype), vx.to(dtype), g.to(dtype), vec


def kernel_k5(card, rates):
    """Phase: K5 against its plain version on edge and interior stripes;
    stripes of one whole sequence composed on the card against K1 and K3;
    timings at the 2-rank split of the 128^2 top level."""
    import numpy as np
    import torch
    import torch.nn.functional as F
    from dawn_tpu_torch.ops import local_attention as la

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    gen = torch.Generator(device="cuda").manual_seed(SEED + 50)
    f32, bf16 = torch.float32, torch.bfloat16

    def plain(q, kx, vx, vec, w, left, right):
        bias = la.stripe_bias(8, q.shape[1], w, vec, left_edge=left, right_edge=right,
                              device="cuda")
        return la.local_attention_packed_stripe_plain(q, kx, vx, bias, 8)

    # the 2- and 4-rank splits of the 128^2 top level at T=200 (N = 32^2
    # sequences, 8 x 32, w = 40: t_loc 100 and 50), both edges (a forced
    # single shard of 200 frames), t_loc = w (11), odd t_loc, no bias.
    # Tolerances as K1's: f32 1e-4, bf16 2e-2 (one ulp of outputs in [2, 4)).
    cases = [("2-rank rank 0 f32", 1024, 100, 40, f32, True, False, True, 1e-4),
             ("2-rank rank 1 f32", 1024, 100, 40, f32, False, True, True, 1e-4),
             ("2-rank rank 0 bf16", 1024, 100, 40, bf16, True, False, True, 2e-2),
             ("2-rank rank 1 bf16", 1024, 100, 40, bf16, False, True, True, 2e-2),
             ("4-rank rank 1 interior f32", 1024, 50, 40, f32, False, False, True, 1e-4),
             ("4-rank rank 2 interior bf16", 1024, 50, 40, bf16, False, False, True, 2e-2),
             ("4-rank rank 3 bf16", 1024, 50, 40, bf16, False, True, True, 2e-2),
             ("both edges t_loc=200", 64, 200, 40, f32, True, True, True, 1e-4),
             ("t_loc=w=11 interior", 64, 11, 11, f32, False, False, True, 1e-4),
             ("t_loc=13 w=5 left", 64, 13, 5, f32, True, False, True, 1e-4),
             ("no bias interior", 64, 100, 40, f32, False, False, False, 1e-4),
             ("both edges t_loc=200 bf16", 64, 200, 40, bf16, True, True, True, 2e-2),
             ("t_loc=w=11 interior bf16", 64, 11, 11, bf16, False, False, True, 2e-2),
             ("t_loc=13 w=5 left bf16", 64, 13, 5, bf16, True, False, True, 2e-2),
             ("no bias interior bf16", 64, 100, 40, bf16, False, False, False, 2e-2)]
    errs = {}
    for name, n, t_loc, w, dtype, left, right, bias, tol in cases:
        q, kx, vx, _, vec = _stripe_inputs(gen, n, t_loc, w, dtype, bias)
        got = la.local_attention_packed_stripe(q, kx, vx, vec, w, 8, left, right)
        err = (got.float() - plain(q, kx, vx, vec, w, left, right).float()).abs().max().item()
        torch.cuda.synchronize()
        errs[name] = err
        print(f"kernel K5 {name}: N={n} t_loc={t_loc} keys={t_loc + 2 * w} 8x32 w={w} "
              f"{str(dtype)[6:]} max_abs_err={err:.3e} tol={tol:g}", flush=True)
        check(err <= tol and np.isfinite(err), f"K5 {name} error {err} > {tol}")
        del q, kx, vx, got

    # one whole sequence cut into stripes (halo by slicing, edge flags by
    # position), K5 on each, against the whole-sequence kernel: the same
    # terms summed, f32 to 1e-5
    for t, ranks, w in ((200, 2, 40), (200, 4, 40), (400, 2, 40)):
        n = 1024
        q, k, v, _, _ = _stripe_inputs(gen, n, t, 0, f32, bias=False)
        vec = torch.randn(8, 2 * w + 1, device="cuda", generator=gen)
        t_loc = t // ranks
        got = torch.cat([la.local_attention_packed_stripe(
            q[:, r * t_loc:(r + 1) * t_loc].contiguous(), _stripe(k, r, ranks, w),
            _stripe(v, r, ranks, w), vec, w, 8, r == 0, r == ranks - 1)
            for r in range(ranks)], dim=1)
        if t <= la.PACKED_MAX_T:
            ref, what = la.local_attention_packed(q, k, v, vec, w, 8), "K1"
        else:
            split = lambda x: x.view(n, t, 8, 32).transpose(1, 2).contiguous()  # noqa: E731
            ref = la.local_attention_tiled(split(q), split(k), split(v), vec, w)
            ref, what = ref.transpose(1, 2).reshape(n, t, 256), "K3"
        err = (got - ref).abs().max().item()
        print(f"kernel K5 composed: T={t} over {ranks} stripes of {t_loc} (keys "
              f"{t_loc + 2 * w}), N={n} f32, against {what} on the whole sequence: "
              f"max_abs_err={err:.3e} tol=1e-5", flush=True)
        check(err <= 1e-5, f"K5 composed T={t} x {ranks} error {err}")
        del q, k, v, got, ref
        torch.cuda.empty_cache()
    # the same in bf16 (the tensor-core body) against the plain version of
    # the whole sequence: K1's bf16 tolerance, one ulp of outputs in [2, 4)
    for t, ranks, w in ((200, 2, 40), (200, 4, 40), (400, 2, 40)):
        n = 256
        q, k, v, _, _ = _stripe_inputs(gen, n, t, 0, bf16, bias=False)
        vec = torch.randn(8, 2 * w + 1, device="cuda", generator=gen)
        t_loc = t // ranks
        got = torch.cat([la.local_attention_packed_stripe(
            q[:, r * t_loc:(r + 1) * t_loc].contiguous(), _stripe(k, r, ranks, w),
            _stripe(v, r, ranks, w), vec, w, 8, r == 0, r == ranks - 1)
            for r in range(ranks)], dim=1)
        ref = la.local_attention_packed_plain(q, k, v, vec, w, 8)
        err = (got.float() - ref.float()).abs().max().item()
        print(f"kernel K5 composed bf16: T={t} over {ranks} stripes of {t_loc} (keys "
              f"{t_loc + 2 * w}), N={n}, against the plain version on the whole sequence: "
              f"max_abs_err={err:.3e} tol=2e-2", flush=True)
        check(err <= 2e-2 and np.isfinite(err), f"K5 composed bf16 T={t} x {ranks} error {err}")
        del q, k, v, got, ref
        torch.cuda.empty_cache()

    n, t_loc, w = 1024, 100, 40                # rank 0 of the 2-rank split
    q, kx, vx, _, vec = _stripe_inputs(gen, n, t_loc, w, bf16)
    ms = time_ms(lambda: la.local_attention_packed_stripe(q, kx, vx, vec, w, 8, True, False), 20)
    plain_ms = time_ms(lambda: plain(q, kx, vx, vec, w, True, False), 5)
    heads4 = lambda x: x.view(n, x.shape[1], 8, 32).transpose(1, 2).contiguous()  # noqa: E731
    q4, k4, v4 = heads4(q), heads4(kx), heads4(vx)
    mask = la.stripe_bias(8, t_loc, w, vec, left_edge=True).to(bf16)[None]   # (1, H, TQ, TK)
    lib = lambda: F.scaled_dot_product_attention(q4, k4, v4, attn_mask=mask, scale=1.0)  # noqa
    library_ms = time_ms(lib, 20)
    lib_err = (lib().transpose(1, 2).reshape(n, t_loc, 256).float()
               - plain(q, kx, vx, vec, w, True, False).float()).abs().max().item()
    # q read and out written once; k and v only over the rows the left edge
    # leaves
    bytes_moved = (2 * q.numel() + 2 * n * stripe_key_rows(t_loc, w, True, False) * 256
                   ) * 2 + vec.numel() * 4
    flops = 4 * 32 * stripe_pairs(t_loc, w, True, False) * n * 8
    bound_ms, bound_by = _bound(bytes_moved, flops, rates)
    print(f"kernel K5 timing [{card}] 2-rank top-level stripe bf16 (N={n} t_loc={t_loc} keys "
          f"{t_loc + 2 * w} 8x32 w={w}, rank 0): kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
          f"library (sdpa with the (H, TQ, TK) bias, err {lib_err:.3e}) {library_ms:.4f} ms, "
          f"bound {bound_ms:.4f} ms by {bound_by} ({bytes_moved / 1e6:.1f} MB, "
          f"{flops / 1e9:.2f} GFLOP)", flush=True)
    return dict(max_abs_err=errs["2-rank rank 0 bf16"], ms=ms, plain_ms=plain_ms,
                bound_ms=bound_ms, bound_by=bound_by, library_ms=library_ms)


def kernel_k6(card, rates):
    """Phase: K6 against its plain version; stripe gradients composed into
    the whole sequence's against K2; autograd through LocalAttentionStripe on
    CUDA tensors; timings at the 2-rank split of the stage-2 top level."""
    import numpy as np
    import torch
    import torch.nn.functional as F
    from dawn_tpu_torch.ops import local_attention as la

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    gen = torch.Generator(device="cuda").manual_seed(SEED + 60)
    f32, bf16 = torch.float32, torch.bfloat16

    def compare(name, n, t_loc, w, dtype, got, ref):
        # K2's tolerances: on max|err| / max(1, max|ref|), f32 1e-4; bf16 2e-2
        # for dq/dk/dv (stored in bf16), 1e-3 for the f32 dvec
        parts = []
        for label, a, b in zip(("dq", "dk", "dv", "dvec"), got, ref):
            if b is None:
                check(a is None, f"K6 {name}: {label} should be None")
                continue
            tol = 1e-3 if label == "dvec" and dtype == bf16 else (
                2e-2 if dtype == bf16 else 1e-4)
            err = (a.float() - b.float()).abs().max().item()
            rel = err / max(1.0, b.float().abs().max().item())
            parts.append(f"{label} {err:.3e} (rel {rel:.3e}, tol {tol:g})")
            check(np.isfinite(err) and rel <= tol, f"K6 {name} {label} error {rel} > {tol}")
        print(f"kernel K6 {name}: N={n} t_loc={t_loc} keys={t_loc + 2 * w} 8x32 w={w} "
              f"{str(dtype)[6:]} " + ", ".join(parts), flush=True)

    # the stage-2 clip of 40 diffused frames (w = 20) over 2 ranks (t_loc 20,
    # 60 keys) and an interior rank of 4; both edges (a forced single shard);
    # the 2-rank sampling stripe (180 keys); t_loc = w; odd t_loc; no bias;
    # 256 keys; 320 keys (t_loc 240, w 40: more than one block could hold
    # whole); each in f32 and bf16
    cases = [("stage-2 2-rank rank 0 f32", 1024, 20, 20, f32, True, False, True),
             ("stage-2 2-rank rank 0 bf16", 1024, 20, 20, bf16, True, False, True),
             ("stage-2 2-rank rank 1 bf16", 1024, 20, 20, bf16, False, True, True),
             ("4-rank interior f32", 256, 20, 20, f32, False, False, True),
             ("both edges t_loc=40", 256, 40, 20, f32, True, True, True),
             ("sampling 2-rank rank 0 f32", 64, 100, 40, f32, True, False, True),
             ("t_loc=w=11 interior", 64, 11, 11, f32, False, False, True),
             ("t_loc=13 w=5 right", 64, 13, 5, f32, False, True, True),
             ("no bias interior", 64, 20, 20, f32, False, False, False),
             ("256 keys interior", 64, 176, 40, f32, False, False, True),
             ("320 keys interior", 64, 240, 40, f32, False, False, True),
             ("stage-2 2-rank rank 1 f32", 1024, 20, 20, f32, False, True, True),
             ("4-rank interior bf16", 256, 20, 20, bf16, False, False, True),
             ("both edges t_loc=40 bf16", 256, 40, 20, bf16, True, True, True),
             ("sampling 2-rank rank 0 bf16", 64, 100, 40, bf16, True, False, True),
             ("t_loc=w=11 interior bf16", 64, 11, 11, bf16, False, False, True),
             ("t_loc=13 w=5 right bf16", 64, 13, 5, bf16, False, True, True),
             ("no bias interior bf16", 64, 20, 20, bf16, False, False, False),
             ("256 keys interior bf16", 64, 176, 40, bf16, False, False, True),
             ("320 keys interior bf16", 64, 240, 40, bf16, False, False, True)]
    for name, n, t_loc, w, dtype, left, right, bias in cases:
        q, kx, vx, g, vec = _stripe_inputs(gen, n, t_loc, w, dtype, bias)
        compare(name, n, t_loc, w, dtype,
                la.local_attention_packed_stripe_bwd(q, kx, vx, g, vec, w, 8, left, right),
                la.local_attention_packed_stripe_bwd_plain(q, kx, vx, g, vec, w, 8, left, right))

    # stripe gradients of one whole sequence: the halo rows' dk, dv added back
    # to their owners, dvec summed over stripes, against K2 on the whole
    # sequence; f32, to 1e-5 of each tensor's largest magnitude (the halo
    # rows' sums add in another order)
    for t, ranks, w in ((40, 2, 20), (80, 4, 20)):
        n = 256
        q, k, v, g, _ = _stripe_inputs(gen, n, t, 0, f32, bias=False)
        vec = torch.randn(8, 2 * w + 1, device="cuda", generator=gen)
        t_loc = t // ranks
        dq, dk, dv = (torch.zeros(n, t + 2 * w, 256, device="cuda") for _ in range(3))
        dvec = torch.zeros_like(vec)
        for r in range(ranks):
            rows = slice(r * t_loc, (r + 1) * t_loc)
            a, b, c, d = la.local_attention_packed_stripe_bwd(
                q[:, rows].contiguous(), _stripe(k, r, ranks, w), _stripe(v, r, ranks, w),
                g[:, rows].contiguous(), vec, w, 8, r == 0, r == ranks - 1)
            dq[:, w + r * t_loc:w + (r + 1) * t_loc] = a
            dk[:, r * t_loc:r * t_loc + t_loc + 2 * w] += b
            dv[:, r * t_loc:r * t_loc + t_loc + 2 * w] += c
            dvec += d
        got = [x[:, w:w + t] for x in (dq, dk, dv)] + [dvec]
        ref = la.local_attention_packed_bwd(q, k, v, g, vec, w, 8)
        errs = [((a - b).abs().max() / b.abs().max()).item() for a, b in zip(got, ref)]
        print(f"kernel K6 composed: T={t} over {ranks} stripes of {t_loc}, N={n} f32, halo "
              f"gradients added to their owners, against K2 on the whole sequence: dq "
              f"{errs[0]:.3e}, dk {errs[1]:.3e}, dv {errs[2]:.3e}, dvec {errs[3]:.3e} of "
              f"max|ref| (tol 1e-5)", flush=True)
        check(max(errs) <= 1e-5, f"K6 composed T={t} x {ranks} errors {errs}")

    # stripes of 320 keys (t_loc 240, w 40) composed into one sequence of
    # 480 frames, against the plain backward of the whole sequence: f32 to
    # 1e-5 of each tensor's largest magnitude (sum order), bf16 to 2e-2 of it
    # (K4's bf16 tolerance: each halo row adds two bf16 partials)
    for dtype, tol in ((f32, 1e-5), (bf16, 2e-2)):
        n, t, ranks, w = 16, 480, 2, 40
        q, k, v, g, _ = _stripe_inputs(gen, n, t, 0, dtype, bias=False)
        vec = torch.randn(8, 2 * w + 1, device="cuda", generator=gen)
        t_loc = t // ranks
        dq, dk, dv = (torch.zeros(n, t + 2 * w, 256, device="cuda") for _ in range(3))
        dvec = torch.zeros_like(vec)
        for r in range(ranks):
            rows = slice(r * t_loc, (r + 1) * t_loc)
            a, b, c, d = la.local_attention_packed_stripe_bwd(
                q[:, rows].contiguous(), _stripe(k, r, ranks, w), _stripe(v, r, ranks, w),
                g[:, rows].contiguous(), vec, w, 8, r == 0, r == ranks - 1)
            dq[:, w + r * t_loc:w + (r + 1) * t_loc] = a.float()
            dk[:, r * t_loc:r * t_loc + t_loc + 2 * w] += b.float()
            dv[:, r * t_loc:r * t_loc + t_loc + 2 * w] += c.float()
            dvec += d
        got = [x[:, w:w + t] for x in (dq, dk, dv)] + [dvec]
        ref = la.local_attention_packed_bwd_plain(q, k, v, g, vec, w, 8)
        errs = [((a - b.float()).abs().max() / b.float().abs().max()).item()
                for a, b in zip(got, ref)]
        print(f"kernel K6 composed {str(dtype)[6:]}: T={t} over {ranks} stripes of {t_loc} "
              f"({t_loc + 2 * w} keys), N={n}, against the plain version on the whole "
              f"sequence: dq {errs[0]:.3e}, dk {errs[1]:.3e}, dv {errs[2]:.3e}, dvec "
              f"{errs[3]:.3e} of max|ref| (tol {tol:g})", flush=True)
        check(np.isfinite(max(errs)) and max(errs) <= tol,
              f"K6 composed {dtype} T={t} errors {errs}")
        del q, k, v, g, dq, dk, dv, got, ref
        torch.cuda.empty_cache()

    # a loss through local_attention_packed_stripe on CUDA tensors must reach
    # q, k, v and the bias vector through K5 forward and K6 backward
    n, t_loc, w = 64, 20, 20
    q, kx, vx, g, vec = _stripe_inputs(gen, n, t_loc, w, f32)
    leaves = [x.clone().requires_grad_() for x in (q, kx, vx, vec)]
    _reset_counts()
    out = la.local_attention_packed_stripe(*leaves, w, 8, True, False)
    got = torch.autograd.grad(out, leaves, g)
    check(_counts() == (0, 0, 0, 0, 1, 1), f"stripe autograd launches (K1-K6) {_counts()}")
    bias = la.stripe_bias(8, t_loc, w, leaves[3], left_edge=True)
    ref = torch.autograd.grad(la.local_attention_packed_stripe_plain(*leaves[:3], bias, 8),
                              leaves, g)
    err = max((a - b).abs().max().item() for a, b in zip(got, ref))
    print(f"kernel K6 autograd: grad of local_attention_packed_stripe on the card (K5 + K6) "
          f"vs autograd of the plain version, N={n} t_loc={t_loc} f32, left edge: "
          f"max_abs_err={err:.3e} tol=1e-4", flush=True)
    check(err <= 1e-4, f"K6 autograd error {err}")

    n, t_loc, w = 1024, 20, 20                 # rank 0 of the stage-2 2-rank split
    q, kx, vx, g, vec = _stripe_inputs(gen, n, t_loc, w, bf16)
    def call():
        return la.local_attention_packed_stripe_bwd(q, kx, vx, g, vec, w, 8, True, False)
    first, second = call(), call()
    check(all(torch.equal(a, b) for a, b in zip(first, second)),
          "two K6 calls gave different bits")
    print("kernel K6 bf16: two calls give the same bits", flush=True)
    ms = time_ms(lambda: la.local_attention_packed_stripe_bwd(q, kx, vx, g, vec, w, 8, True,
                                                              False), 20)
    plain_ms = time_ms(lambda: la.local_attention_packed_stripe_bwd_plain(
        q, kx, vx, g, vec, w, 8, True, False), 5)
    heads4 = lambda x: x.view(n, x.shape[1], 8, 32).transpose(1, 2).contiguous()  # noqa: E731
    q4, k4, v4 = (heads4(x).requires_grad_() for x in (q, kx, vx))
    mask = la.stripe_bias(8, t_loc, w, vec, left_edge=True).to(bf16)[None]
    lib_out = F.scaled_dot_product_attention(q4, k4, v4, attn_mask=mask, scale=1.0)
    library_ms = time_ms(lambda: torch.autograd.grad(lib_out, (q4, k4, v4), heads4(g),
                                                     retain_graph=True), 20)
    # q and g read, dq written; k and v read over the rows the left edge
    # leaves; dk and dv written over every haloed row; vec read, dvec written
    bytes_moved = (3 * q.numel() + 2 * n * stripe_key_rows(t_loc, w, True, False) * 256
                   + 2 * kx.numel()) * 2 + 2 * vec.numel() * 4
    flops = 10 * 32 * stripe_pairs(t_loc, w, True, False) * n * 8
    bound_ms, bound_by = _bound(bytes_moved, flops, rates)
    got = la.local_attention_packed_stripe_bwd(q, kx, vx, g, vec, w, 8, True, False)
    ref = la.local_attention_packed_stripe_bwd_plain(q, kx, vx, g, vec, w, 8, True, False)
    err = max((a.float() - b.float()).abs().max().item() for a, b in zip(got[:3], ref[:3]))
    print(f"kernel K6 timing [{card}] stage-2 2-rank stripe bf16 (N={n} t_loc={t_loc} keys "
          f"{t_loc + 2 * w} 8x32 w={w}, rank 0): kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
          f"library (sdpa backward with the (H, TQ, TK) bias, dq/dk/dv only) "
          f"{library_ms:.4f} ms, bound {bound_ms:.4f} ms by {bound_by} "
          f"({bytes_moved / 1e6:.1f} MB, {flops / 1e9:.2f} GFLOP)", flush=True)
    return dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                bound_by=bound_by, library_ms=library_ms)


def window_limits():
    """Phase: each kernel's largest window (its launch's shared memory, from
    dawn_local_attn_max_window) in f32 and bf16, and one past it raising the
    ValueError that names the kernel, the limit and the dtype, before any
    launch. Tiny tensors: nothing runs on the card."""
    import torch
    from dawn_tpu_torch.ops import local_attention as la

    def packed(t, w, dtype, keys=None):
        x = [torch.zeros(1, t, 256, device="cuda", dtype=dtype)]
        x += [torch.zeros(1, keys or t, 256, device="cuda", dtype=dtype)] * 2
        return x + [torch.zeros(8, 2 * w + 1, device="cuda")]

    def split(t, w, dtype):
        return [torch.zeros(1, 8, t, 32, device="cuda", dtype=dtype)] * 3 + [
            torch.zeros(8, 2 * w + 1, device="cuda")]

    # (kernel, source, T (K5, K6: t_loc), the call at window w)
    calls = [
        (1, "local_attention", 256, lambda w, dt: la.local_attention_packed(
            *packed(256, w, dt), w, 8)),
        (2, "local_attention_tiled_bwd", 256, lambda w, dt: la.local_attention_packed_bwd(
            *packed(256, w, dt)[:3], packed(256, w, dt)[0], packed(256, w, dt)[3], w, 8)),
        (3, "local_attention", 1024, lambda w, dt: la.local_attention_tiled(
            *split(1024, w, dt), w)),
        (4, "local_attention_tiled_bwd", 1024, lambda w, dt: la.local_attention_tiled_bwd(
            *split(1024, w, dt)[:3], split(1024, w, dt)[0], split(1024, w, dt)[3], w)),
        (5, "local_attention", 128, lambda w, dt: la.local_attention_packed_stripe(
            *packed(128, w, dt, 128 + 2 * w), w, 8, False, False)),
        (6, "local_attention_tiled_bwd", 128, lambda w, dt: la.local_attention_packed_stripe_bwd(
            *packed(128, w, dt, 128 + 2 * w)[:3], packed(128, w, dt)[0],
            packed(128, w, dt)[3], w, 8, False, False))]
    parts = []
    for kernel, source, t, call in calls:
        for dtype in (torch.float32, torch.bfloat16):
            name = str(dtype)[6:]
            limit = la._max_window(source, kernel, t, la._DTYPE_FLAG[dtype],
                                   kernel in (2, 4, 6), torch.cuda.current_device())
            if kernel == 2:     # no limit at any T <= 256, with a bias gradient
                limits = {la._max_window(source, 2, tt, la._DTYPE_FLAG[dtype], True,
                                         torch.cuda.current_device()) for tt in range(1, 257)}
                check(limits == {2 ** 31 - 1}, f"K2 {name} reports window limits {limits}")
                parts.append(f"K2 {name} none at every T <= 256")
                continue
            if limit == 2 ** 31 - 1:
                check(kernel == 1 and dtype == torch.bfloat16,
                      f"K{kernel} {name} reports no window limit")
                parts.append(f"K{kernel} {name} none")
                continue
            before = _counts()
            try:
                call(limit + 1, dtype)
                raised = ""
            except ValueError as e:
                raised = str(e)
            check(f"K{kernel} in {name}" in raised and f"w={limit} " in raised,
                  f"K{kernel} {name} at w={limit + 1} did not raise its limit: {raised!r}")
            check(_counts() == before, f"K{kernel} {name} launched past its window limit")
            parts.append(f"K{kernel} {name} w <= {limit} at T={t}")
    print("window limits: " + "; ".join(parts) + " (one past each raised its ValueError, "
          "nothing launched)", flush=True)


def seq_sampling(card, mesh):
    """Phase: the seq sampler on a one-rank NCCL mesh with the stripe
    forced (halo exchange, K5, the GroupNorm all-reduce and the quantile
    all-gather through NCCL): f32 parity at T=40 against sample_one_video
    (K1), then the 200-frame, 20-step bf16 video. Returns the (K1-K6)
    launches of the 200-frame call."""
    import torch
    from dawn_tpu_torch.models.dm.flow_diffusion import FlowDiffusion, FlowDiffusionConfig
    from dawn_tpu_torch.parallel.mesh import gather_frames

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t, steps = 40, 2
    cfg = FlowDiffusionConfig(sampling_timesteps=steps, dtype=torch.float32)
    torch.manual_seed(SEED)
    model = FlowDiffusion(cfg)
    inp = inputs_for(t, cfg.img_size, SEED + 1)
    noise = torch.randn((steps + 1, 1, t, cfg.latent_size, cfg.latent_size, 3),
                        generator=torch.Generator().manual_seed(SEED + 2))
    _reset_counts()
    ref = model.sample_one_video(**inp, noise_seq=noise)["sample_out_vid"]
    ref_launches = _counts()
    model.unet.seq.force_stripe = True
    _reset_counts()
    got = gather_frames(model.make_seq_sampler(mesh)(**inp, noise_seq=noise)["sample_out_vid"],
                        mesh)
    launches = _counts()
    check(ref_launches == (10 * steps, 0, 0, 0, 0, 0) and launches == (0, 0, 0, 0, 10 * steps, 0),
          f"seq parity launches (K1-K6) {ref_launches} / {launches}")
    err = (got - ref).abs().max().item()
    print(f"seq parity: make_seq_sampler on a one-rank NCCL mesh, stripe forced (K5 x "
          f"{launches[4]}), vs sample_one_video (K1 x {ref_launches[0]}), T={t} steps={steps} "
          f"f32 full width, same weights and noise, TF32 off: max_abs_err={err:.3e} tol=1e-3",
          flush=True)
    check(err <= 1e-3, f"seq parity error {err}")
    del model, ref, got
    torch.cuda.empty_cache()

    torch.backends.cudnn.allow_tf32 = True      # PyTorch's default for convs
    t = 200
    torch.manual_seed(SEED)
    model = FlowDiffusion(FlowDiffusionConfig())
    model.unet.seq.force_stripe = True
    sampler = model.make_seq_sampler(mesh)
    inp = inputs_for(t, 128, SEED + 3)

    def run():
        out = sampler(**inp, generator=torch.Generator(device="cuda").manual_seed(SEED + 4))
        torch.cuda.synchronize()
        return out

    t0 = time.perf_counter()
    run()
    cold = time.perf_counter() - t0
    torch.cuda.reset_peak_memory_stats()
    _reset_counts()
    t0 = time.perf_counter()
    vid = run()["sample_out_vid"]
    secs = time.perf_counter() - t0
    launches = _counts()
    check(tuple(vid.shape) == (1, t, 128, 128, 3), f"seq video shape {tuple(vid.shape)}")
    check(bool(torch.isfinite(vid).all()), "seq video has non-finite values")
    lo, hi = vid.min().item(), vid.max().item()
    check(0.0 <= lo and hi <= 1.0, f"seq video range [{lo}, {hi}]")
    check(launches == (0, 0, 0, 0, 200, 0), f"seq path launches (K1-K6) {launches}")
    peak_gb = torch.cuda.max_memory_allocated() / 2**30
    print(f"seq path [{card}]: make_seq_sampler, one-rank NCCL mesh, stripe forced, 128^2 "
          f"T={t} 20 DDIM steps UNet bf16 LFG f32: video {tuple(vid.shape)} in [{lo:.4f}, "
          f"{hi:.4f}], launches K5 {launches[4]} (K1 {launches[0]}, K3 {launches[2]}); cold "
          f"call {cold:.2f} s, warm call {secs:.3f} s = {t / secs:.2f} frames/s, peak memory "
          f"{peak_gb:.2f} GiB", flush=True)
    profile(run, card, "seq profile")
    del model, sampler, vid
    torch.cuda.empty_cache()
    return launches


def seq_training(card, mesh):
    """Phase: DMTrainer.make_sharded_step on the one-rank NCCL mesh with the
    stripe forced: f32 parity against the unsharded step on the card, then
    two full-width bf16 stage-2 steps. Returns the (K1-K6) launches of the
    stage-2 steps."""
    import numpy as np
    import torch
    from dawn_tpu_torch.train.train_dm import DMTrainConfig, DMTrainer

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    # 20 frames, the stage-1 clip: a stripe must hold at least win_width
    # frames (JAX's assertion), so fewer frames cannot take the stripe
    b, t, lr = 1, 20, 2e-4
    cfg = DMTrainConfig(win_width=20, lr=lr)
    torch.manual_seed(SEED)
    plain_tr, seq_tr = DMTrainer(cfg), DMTrainer(cfg)
    for a, c in ((plain_tr.unet, seq_tr.unet), (plain_tr.flow_ae, seq_tr.flow_ae),
                 (plain_tr.face_loc, seq_tr.face_loc)):
        c.load_state_dict(a.state_dict())
    seq_tr.ema = [e.clone() for e in plain_tr.ema]
    seq_tr.unet.seq.force_stripe = True
    r = np.random.RandomState(SEED + 9)
    ls = cfg.latent_size
    draws = {"t": np.array([371]), "noise": r.randn(b, t, ls, ls, 3).astype(np.float32),
             "drop": r.rand(b, t) < 0.1,
             "jitter": {k: torch.tensor([v]) for k, v in (
                 ("brightness", 1.1), ("contrast", 0.9), ("saturation", 1.2), ("hue", 0.02))}}
    batch = _train_batch(b, t, cfg.img_size, SEED + 10)
    before = [p.detach().clone() for p in plain_tr.unet.parameters()]
    _reset_counts()
    want = plain_tr.train_step(batch, draws)
    ref_launches = _counts()
    _reset_counts()
    got = seq_tr.make_sharded_step(mesh)(batch, draws)
    launches = _counts()
    check(ref_launches == (10, 10, 0, 0, 0, 0) and launches == (0, 0, 0, 0, 10, 10),
          f"seq train-parity launches (K1-K6) {ref_launches} / {launches}")
    for k in ("loss", "floss", "mouth_loss", "total"):
        check(abs(got[k] - want[k]) <= 1e-4 * max(1.0, abs(want[k])),
              f"seq train-parity {k}: {got[k]} vs {want[k]}")
    pairs = list(zip(seq_tr.unet.parameters(), plain_tr.unet.parameters(), before))
    mu = [(seq_tr.optimizer.state[a]["mu"], plain_tr.optimizer.state[c]["mu"])
          for a, c, _ in pairs]
    mu_max = max(m.abs().max().item() for _, m in mu)
    mu_err = max((g - c).abs().max().item() for g, c in mu) / mu_max
    upd_err = clear_err = 0.0
    for (a, c, old), (_, m) in zip(pairs, mu):
        diff = (a.detach() - c.detach()).abs()
        upd_err = max(upd_err, diff.max().item())
        clear = m.abs() > 1e-3 * mu_max
        if clear.any():
            clear_err = max(clear_err, (diff[clear] - 1e-6 * old[clear].abs()).max().item())
    print(f"seq train-parity: make_sharded_step on a one-rank NCCL mesh, stripe forced (K5 x "
          f"{launches[4]}, K6 x {launches[5]}), vs train_step (K1 x {ref_launches[0]}, K2 x "
          f"{ref_launches[1]}), stage 1 f32 full width bs {b} T={t}, TF32 off: total "
          f"{got['total']:.6f} vs {want['total']:.6f} (tol 1e-4 rel, every term); grad norm "
          f"{got['grad_norm']:.5f} vs {want['grad_norm']:.5f}; Adam mu max err {mu_err:.3e} "
          f"of its max (tol 1e-3); update max err {upd_err:.3e} (tol {2 * lr + 1e-7:.3g}), "
          f"where |mu| > 1e-3 max {clear_err:.3e} (tol 1e-7)", flush=True)
    check(mu_err <= 1e-3, f"seq train-parity gradient error {mu_err}")
    check(upd_err <= 2 * lr + 1e-7 and clear_err <= 1e-7,
          f"seq train-parity update error {upd_err} / {clear_err}")
    del plain_tr, seq_tr
    torch.cuda.empty_cache()

    torch.backends.cudnn.allow_tf32 = True
    cfg2 = DMTrainConfig(win_width=20, stage=2, compute_dtype=torch.bfloat16)
    torch.manual_seed(SEED)
    trainer = DMTrainer(cfg2)
    trainer.unet.seq.force_stripe = True
    step = trainer.make_sharded_step(mesh)
    batches = [_train_batch(4, 41, 128, SEED + 11 + i) for i in range(2)]
    torch.cuda.reset_peak_memory_stats()
    _reset_counts()
    times, totals = [], []
    for bt in batches:
        t0 = time.perf_counter()
        m = step(bt)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        totals.append(m["total"])
        check(np.isfinite(m["total"]) and m["grads_finite"] == 1.0, "seq train loss not finite")
    launches = _counts()
    check(launches == (0, 0, 0, 0, 20, 20), f"seq train launches (K1-K6) {launches}")
    peak_gb = torch.cuda.max_memory_allocated() / 2**30
    print(f"seq train path [{card}]: make_sharded_step, one-rank NCCL mesh, stripe forced, "
          f"stage 2 bs 4 x 40 diffused frames, 128^2 full width bf16, 2 steps: totals "
          f"{[round(x, 4) for x in totals]}, step times {[round(x, 3) for x in times]} s "
          f"(warm {times[-1]:.3f} s = {4 / times[-1]:.2f} examples/s), K5 x {launches[4]}, "
          f"K6 x {launches[5]}, peak memory {peak_gb:.2f} GiB", flush=True)
    del trainer
    torch.cuda.empty_cache()
    return launches


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

    start = t0 = time.perf_counter()
    logs = build.build_all()
    print(f"build: {', '.join(build.sources())} in {time.perf_counter() - t0:.1f} s", flush=True)
    for name, log in logs.items():       # ptxas -v: each kernel's registers, as printed
        for line in log.splitlines():
            if "Compiling entry function" in line or "registers" in line:
                print(f"build: {name}.cu {line.strip()}", flush=True)
    hmma = sass_mma_counts(build)
    for fn, count in sorted(hmma.items()):
        print(f"build: sass {fn}: {count} HMMA", flush=True)
    # the forward body in both layouts and walks (bf16 K1 and K5 packed with
    # one walk, K3 split with two) and both layouts' passes (K4 split; K2 and
    # K6 packed), each for 4-warp and 2-warp blocks
    for entry, built in (("attn_fwd_mma_kernel", 4), ("bwd_query_mma_kernel", 4),
                         ("bwd_key_mma_kernel", 4)):
        counts = [c for fn, c in hmma.items() if entry in fn]
        check(not hmma or (len(counts) == built and min(counts) > 0),
              f"{entry}: {len(counts)} instantiations, HMMA counts {counts}")

    def phase(fn, *args, **kw):
        t0 = time.perf_counter()
        out = fn(*args, **kw)
        print(f"phase {fn.__name__} done in {time.perf_counter() - t0:.1f} s "
              f"({time.perf_counter() - start:.1f} s since start)", flush=True)
        return out

    phase(kernel_routes)
    k1 = phase(kernel_k1, smi, rates)
    phase(parity)
    sample = phase(video_path, smi, 200, timed=True)
    k2 = phase(kernel_k2, smi, rates)
    phase(train_parity)
    train = phase(train_path, smi)
    k3 = phase(kernel_k3, smi, rates)
    k4 = phase(kernel_k4, smi, rates)
    grad_t400 = phase(temporal_attention_grad, smi)
    phase(parity, 264)
    k5 = phase(kernel_k5, smi, rates)
    k6 = phase(kernel_k6, smi, rates)
    phase(window_limits)
    # a one-rank NCCL process group through a file store (no network)
    import tempfile
    import torch.distributed as dist
    from dawn_tpu_torch.parallel.mesh import make_mesh
    store = tempfile.mkdtemp(prefix="dawn_nccl_")
    torch.cuda.set_device(0)
    dist.init_process_group("nccl", init_method=f"file://{os.path.join(store, 'store')}",
                            world_size=1, rank=0)
    mesh = make_mesh()
    seq_sample = phase(seq_sampling, smi, mesh)
    seq_train = phase(seq_training, smi, mesh)
    dist.destroy_process_group()
    shutil.rmtree(store)
    paths = {"sample": sample, "train": train, "seq_sample": seq_sample,
             "seq_train": seq_train,
             "sample_T400": phase(video_path, smi, 400, timed=True),
             "sample_T800": phase(video_path, smi, 800, decode_chunk=32),
             "sample_256_T400": phase(video_path, smi, 400, img_size=256, decode_chunk=16),
             "temporal_attention_grad_T400": grad_t400}
    # (name, source, replaced TPU kernel, measurements, the path whose count is `launches`)
    rows = [("K1 local_attention_packed", "local_attention.cu", 299, k1, "sample"),
            ("K2 local_attention_packed_bwd", "local_attention_tiled_bwd.cu", 743, k2,
             "train"),
            ("K3 local_attention_tiled", "local_attention.cu", 116, k3, "sample_T400"),
            ("K4 local_attention_tiled_bwd", "local_attention_tiled_bwd.cu", 876, k4,
             "temporal_attention_grad_T400"),
            ("K5 local_attention_packed_stripe", "local_attention.cu", 446, k5, "seq_sample"),
            ("K6 local_attention_packed_stripe_bwd", "local_attention_tiled_bwd.cu", 516, k6,
             "seq_train")]
    kernels = [{"name": name, "route": "cuda", "source": f"dawn_tpu_torch/csrc/{src}",
                "replaces": f"dawn_tpu/ops/local_attention.py:{line}",
                "launches": paths[main_path][i], **measured,
                "launches_by_path": {p: c[i] for p, c in paths.items()}}
               for i, (name, src, line, measured, main_path) in enumerate(rows)]
    check(train[1] > 0, "K2 never launched on the training path")
    check(seq_sample[4] > 0 and seq_train[5] > 0, "K5 or K6 never launched on its path")
    print(json.dumps({"kernels": kernels}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
