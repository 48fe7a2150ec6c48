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
   layouts and its three ways of forming P, and of the two backward passes
   in both layouts must have some).
   routes  - bf16 K1, K1p, K3, K6 and K2 called for half a second each under
   the profiler: K1, K1p and K3 must run the tensor-core forward and not the
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
   kernel K1p - K1 with the exponent's argument rounded to bf16 (the JAX
   kernel's prob_dtype) against its plain version on dyadic inputs (exact
   scores), f32 and bf16: the main shape, T=20 w=20, T=77, no bias, w=300 at
   T=200, w=40 at T=37; f32 within 1e-5 of max|ref|, bf16 within one ulp
   but for the flips of P's rounding that exp's last bit causes (at most
   1e-3 of the entries, which K1's kernel exceeds); at the main shape the
   kernel, the plain version, SDPA and the bound, and K1p's MSE against K1.
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
   pipeline parity - the pipeline's other models, card against CPU, f32,
   TF32 off, the same weights: HuBERT-large at full width on 2 s of audio
   (max error within 1e-3 of max|ref|) and the two reemb6 PBnets' pose and
   blink drives at T=200 with the same z (atol 1e-4).
   face prep parity - stage 1, card against CPU, f32, TF32 off, on seeded
   assets at the release files' shapes: FaceBoxes on a 607 x 1080 input and
   MobileNet-V1 on 120^2 crops (1e-4 of max|ref|), then extract_init_states
   on a 1080p portrait stage by stage (the first box, the ROI's integers, the
   62 parameters from the same box, the states from the same parameters,
   end to end when the integers agree), cold and warm seconds.
   pipeline path - the whole pipeline through the CLI's entry point
   (``python -m dawn_tpu_torch.pipeline.generator``'s ``main()``) on a
   synthetic 8 s 44.1 kHz WAV and a 128^2 portrait, assetless (random
   HuBERT-large, random reemb6 x 2, the 128^2 DAWN at 20 DDIM steps, UNet
   bf16, LFG f32): the cache files' shapes, a finite (200, 128, 128, 3)
   video in [0, 1], 200 PNGs and a 200-frame mp4, exactly 200 K1 launches
   and no other kernel; each stage's seconds of the cold CLI call and of a
   warm second run, frames/s end to end, peak memory, stage 4's sampling
   timed once more alone (against stage 4: the file writes, within the
   sampling call's spread), and the warm run under the profiler; then two
   more runs with seeded face assets, so that stage 1 runs FaceBoxes and
   the 3DDFA MobileNet (init_pose not the default; each stage's seconds,
   the first run loading the assets).
   eval parity - the evaluation networks, card against CPU, f32, TF32 off,
   the same seeded weights: I3D at the released widths (1024 features, 400
   logits) on 2 x 16 x 224^2 (1e-4 of max|ref|; then its card time per
   batch, cuDNN TF32 on); the STGCN recognizer at full width (256 features)
   on 'dawn_head' and 'openpose', 64 x 100 frames (1e-5); the released
   128^2 LFG generator's frame features on 2 x 8 frames (1e-4).
   eval path - the evaluation CLIs' ``main()`` on the card: ``ood_test
   --metrics`` over 2 pairs (an 8 s WAV and a 128^2 portrait each,
   assetless, 20 DDIM steps): exactly 400 K1 and no other kernel, each
   pair's seconds, peak memory, a finite metrics.json; ``ood_test`` again
   over the pairs reversed, for each pair's warm seconds; ``eval_quality
   --released`` over the same pairs against the first run's PNG frames
   saved as ``<tag>.npy``, with a seeded released-width I3D as
   ``--i3d-ckpt``: exactly 400 K1, a finite report, ``per_video_l1`` 0
   (same weights, seed and inputs; otherwise the differing PNG values are
   printed and the phase fails); ``eval_pbnet --stgcn`` (seeded reemb6, 8
   held-out videos, 2 seeds) and ``eval_lfg`` (a seeded FlowAE at the 128^2
   widths, 4 videos at 128^2) on a seeded tree: no kernel, finite metrics.
   ancestral parity - the ancestral sampler (p_sample_loop) through
   sample_one_video at full width with a GaussianDiffusion of 3 train steps
   swapped in, T=40, f32, TF32 off, card (exactly 30 K1) against CPU, same
   weights and noise, tolerance 1e-3; then GaussianDiffusion.interpolate at
   t=2 of two latent videos with the full-width UNet (20 K1), the same.
   ancestral path - the main path's model (128^2, T=200, UNet bf16) sampled
   ancestrally over 50 train steps (GaussianDiffusion(50, 50) swapped in:
   the released 1000 cut to 50, the loop being the host's): cold and warm
   seconds, ms a step, peak memory, a finite video in [0, 1], exactly 500
   K1; then FlowDiffusionConfig(sampling_timesteps=1000) with a stub UNet
   counting its calls: 1 + 1000, at train steps 999 to 0.
   fuse_cond - one full-width Unet3D call (32^2 latent, T=40, f32) with
   fuse_cond=True against False, same weights, tolerance 1e-4 (the port
   computes both as the three separate branches); then a 2-step T=40 bf16
   video with it (20 K1, in [0, 1]).
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
   dm trainer extras - the DM trainer's options at that recipe point: remat
   'none', 'dots' and 'full' from one state, batch and set of draws, their
   f32 gradients (bs 2, TF32 off, cuDNN deterministic) within 1e-6 of the
   largest of 'none' (predicted bit-equal), then each mode's K1 and K2
   launches a step (K1 twice under remat: its forward runs again in the
   backward; K2 as without), warm step and peak memory at bs 4 in bf16;
   the CLI with --teacher-cache (stride 20 over 4 videos of 40 frames, so
   clips recur) and --sample-every 2 for 4 steps: hit rate above 0, the
   7-panel PNG, 40 K1 + 40 K2 + the snapshot's 10 K1; the cached step
   against the uncached one, alternated, and the teacher pass alone; the
   snapshot's launches (10 K1, w=20 past T=4); --prefetch against the
   plain CLI (batches on the card equal, losses bit-equal at every step
   under cuDNN's deterministic algorithms, step walls); one use_fft_floss
   step at bs 1 x 20 frames (an rfft of length 20), card against CPU in
   f32 (rtol 1e-4).
   lfg train parity - one f32 LFGTrainer step (train-mode BatchNorm, the
   VGG19 perceptual pyramid, the TPS equivariance) at the full
   configs/lfg_hdtf128.yaml widths, B=2 at 128^2, seeded VGG19, card against
   CPU, TF32 off, same weights and warp draws: loss terms, running
   statistics, Adam's first moment per net (and both f32 gradients against
   a float64 one, per net and per leaf, with each net's worst leaf) and the
   update, each with its error and tolerance; the covariances' singular-
   value ratio, held below 0.95.
   lfg train path - warm LFGTrainer steps at the config's batch size 100,
   128^2, f32 (cuDNN TF32): ms per step, examples/s, peak memory, the
   device's busy share under the profiler; finite losses, running
   statistics moved.
   pbnet train parity - one PBnetTrainer step (the CVAE loss with KL
   annealing and the 1-D PatchGAN), reemb6 at the shipped width, dropout 0,
   B=4 at T=40 with ragged lengths, card against CPU: metrics, G's and D's
   first moments and updates.
   pbnet train path - pose and blink at the JAX script's defaults (batch 32
   x 100 frames, dropout on): ms per step and peak memory.
   trainer clis - ``python -m dawn_tpu_torch.scripts.train_lfg`` (batch 8)
   and ``... train_pbnet --kind pose|blink`` for 3 steps each on a synthetic
   HDTF tree; their checkpoints read back strictly by the inference loaders
   on the card (FlowAE.load_reference_checkpoint, load_lfg_generator into
   a FlowDiffusion, load_pbnet_with_opt), the PBnets' drives finite. No
   kernel of the port lies on these paths: every count stays 0.
   lfg variants - every LFG architecture flag set otherwise than the DAWN
   configs (bg_type zero, shift, perspective; the FOMM regression head;
   no estimate_affine; use_covar_heatmap, use_deformed_source,
   estimate_occlusion_map and skips off): FlowAE.motion_transfer at the
   configs/lfg_hdtf128.yaml widths, batch 2 at 128^2, card against CPU,
   f32, TF32 off (1e-3); one LFGTrainer step with bg 'perspective' and the
   FOMM head (finite); AVDNetwork card against CPU, eval and train mode
   (1e-4 of max|ref|).
   pbnet archs - every PBnet architecture of the registry at the opt
   defaults' widths: CVAE.generate of 32 x 100 frames (mlp 96) card against
   CPU (1e-4 of max|ref|), one PBnetTrainer step each (finite); 'gru' pose
   and blink models written as release-layout checkpoint_*.pth.tar +
   opt.yaml and read back by generate_drives_separate, card against CPU.
   face viz - the face visualisations on the dense BFM mesh: stage 1's nets
   on the card on seeded assets over a 1080p portrait give the 62
   parameters, the 38,365 dense vertices and the 68 landmarks; the seeded
   assets carry no triangle list, so the mesh is the Delaunay triangulation
   of the vertices' image positions. The rasteriser's load (its g++ build
   at first use), then render_depth, render_mesh_overlay, pncc, uv_tex
   (uv_coords: the vertices' normalised image positions with seeded
   jitter), viz_pose and draw_landmarks on the whole frame and ser_to_ply /
   ser_to_obj of two faces, merged and not, each timed: finite, in range,
   something drawn, every vertex and face written.
   Then the host rasteriser (csrc/host/render.cpp, g++) against its numpy
   versions on a cut of the mesh, by the JAX tests' rule.
   golden - the port's frozen sampler (dawn_tpu_torch/scripts/make_golden.py,
   f32 at the released topology, 128^2 x 8 frames x 4 steps and 256^2 x 8 x
   2) on the card, TF32 off, against tests/golden/torch_golden_{128,256}.npz
   (made on the CPU): pixels and flow grids within 5e-4, exactly 40 and 20
   K1.
   scripts - each probe script's main() at full width on the card:
   smoke_e2e (128^2, 200 frames, 20 steps, --attn local; its cold and warm
   calls, 200 K1 each), profile_sample (128^2, T=200: the DDIM and decode
   phases apart, their sum against the whole warm call, the counted
   operations and their share of the bf16 peak), probe_unet_phases
   (--modules --extras) and probe_micro at 128^2 and T=200,
   probe_train_phases (configs/dm_train_stage1.yaml, bs 4, 20 frames, bf16,
   --modules: K1 and K2) and probe_packed_compile (nvcc of the K1 source,
   first and warm launches, one launch against four chunks); the splits on
   their lines, and every kernel launch of each run counted and checked.
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
   bench attention - on that process group, ``python -m
   dawn_tpu_torch.scripts.bench_attention``'s main() at the sampling top
   level with --prob-dtype bf16 --stripe 2 --seq-composed: every line of
   the JAX script's printed, K1p, K1, K3, K5 and K6 launched.
   pbnet sharded losses - on that process group, PBnetTrainer's
   make_sharded_step with every loss (rc, rcw, reg, kl, ssim, var, mmd, hp:
   the MIN/MAX all-reduces and the gathered z on NCCL) against the
   unsharded step, shipped width, dropout 0.1: metrics rtol 1e-5, first
   moments 1e-5 of their max.
   cached cli nccl - on that process group, the DM CLI with an f16
   --teacher-cache and --sample-every 2 for 4 steps at bs 2 in bf16: the
   sharded step and TeacherCache.convert_batch_shared (barriers on NCCL);
   finite losses, hit rate above 0, f16 entries, the PNG, 40 K1 + 40 K2 +
   the snapshot's 10 K1 (one 'seq' rank: K1/K2, not the stripe route).
19. kernels - one JSON line listing every ported kernel (K1-K6, K1p) with
   its numbers and its launches on every path (K1's ``launches``: the
   pipeline path's CLI call; the paths ancestral and interpolate of the
   ancestral phases; K1p's: the bench attention call, K1p's only
   caller; the trainer paths lfg_train, pbnet_train, pbnet_sharded and
   trainer_clis with 0 for every kernel; the DM options' paths
   train_remat_none, train_remat_dots, train_remat_full, train_uncached,
   train_cached, snapshot, train_prefetch, train_fft_floss and
   train_cached_nccl; the evaluation CLIs' paths ood_test and
   eval_quality_released, 400 K1 each; golden and the probe scripts'
   paths smoke_e2e, profile_sample, probe_unet_phases, probe_micro,
   probe_train_phases and probe_packed_compile).

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
    """Phase: which kernels bf16 K1, K1p, K3, K6 and K2 launch, under the
    profiler at the start of the run: K1, K1p and K3 the tensor-core forward
    and not the CUDA-core one, K6 and K2 the two tensor-core passes and not the f32 ones.
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
    ran = kernels_run(lambda: la.local_attention_packed(q, k, v, vec, w, 8,
                                                        prob_dtype=torch.bfloat16))
    print(f"kernel routes: bf16 K1p under the profiler: {sorted(ran)}", flush=True)
    check(any("attn_fwd_mma_kernel" in x for x in ran)
          and not any("local_attn_fwd_kernel" in x for x in ran),
          f"bf16 K1p did not run the tensor-core body alone: {sorted(ran)}")
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
    from dawn_tpu_torch.utils.profiling import band_pairs

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
    flops = 4 * d * band_pairs(t, w) * n * heads
    bound_ms, bound_by = _bound(bytes_moved, flops, rates)
    print(f"kernel K1 timing [{card}] main shape bf16: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
          f"library (sdpa, err {lib_err:.3e}) {library_ms:.4f} ms, bound {bound_ms:.4f} ms "
          f"by {bound_by} ({bytes_moved / 1e6:.1f} MB, {flops / 1e9:.2f} GFLOP)", flush=True)
    return dict(max_abs_err=errs["main bf16"], ms=ms, plain_ms=plain_ms,
                bound_ms=bound_ms, bound_by=bound_by, library_ms=library_ms)


def dyadic_packed(gen, n, t, heads, w, dtype, bias=True):
    """q, k, v (N, T, heads*32) and the (heads, 2w+1) bias vector on the
    card, q and k on a dyadic grid (q in multiples of 1/16 in [-1, 1], k of
    1/8 in [-2, 2], the bias of 1/64 in [-2, 2]): every score is exact in f32
    whatever the order of its sum, so the bf16 rounding of s - m is the same
    in the kernel and its plain version."""
    import torch
    shape = (n, t, heads * 32)
    q = torch.randint(-16, 17, shape, device="cuda", generator=gen) / 16.0
    k = torch.randint(-16, 17, shape, device="cuda", generator=gen) / 8.0
    v = torch.randn(shape, device="cuda", generator=gen)
    vec = (torch.randint(-128, 129, (heads, 2 * w + 1), device="cuda", generator=gen) / 64.0
           if bias else None)
    return q.to(dtype), k.to(dtype), v.to(dtype), vec


def kernel_k1p(card, rates):
    """Phase: K1p (K1 with the exponent's argument rounded to bf16) against
    its plain version on dyadic inputs, f32 and bf16; timings at the main
    shape. f32 (the CUDA-core body): within 1e-5 of max|ref|. bf16 (the
    tensor-core body): every entry within one bf16 ulp of itself plus 2^-14
    of max|ref|, except where exp's last f32 bit, taken by two
    implementations (the kernel's expf, PyTorch's exp), flips the bf16
    rounding of a p: one flip moves an output by at most 2^-8 max|v| (a p
    below 1 has a bf16 ulp of at most 2^-8, and the row sum is at least 1),
    so all entries within one ulp of max|ref| plus 2^-7 max|v| (two flips in
    a row) and at most 1e-3 of them past one ulp. K1's kernel on the same inputs, held against
    K1p's plain version the same way, must fail the one-ulp share."""
    import numpy as np
    import torch
    import torch.nn.functional as F
    from dawn_tpu_torch.ops import local_attention as la
    from dawn_tpu_torch.utils.profiling import band_pairs

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    gen = torch.Generator(device="cuda").manual_seed(SEED + 80)
    f32, bf16 = torch.float32, torch.bfloat16
    cases = [("main", 1024, 200, 40, True), ("T=20 w=20", 1024, 20, 20, True),
             ("T=77 w=20", 256, 77, 20, True), ("no bias", 256, 200, 40, False),
             ("w=300 T=200", 64, 200, 300, True), ("w=40 T=37", 256, 37, 40, True)]

    def past_ulp(got, ref):
        """Share of entries further from ref than one bf16 ulp of ref plus
        2^-14 of max|ref|, and the largest error."""
        err = (got.float() - ref.float()).abs()
        tol = 2.0 ** -7 * ref.float().abs() + 2.0 ** -14 * ref.float().abs().max()
        return (err > tol).float().mean().item(), err.max().item()

    errs = {}
    for name, n, t, w, bias in cases:
        for dtype in (f32, bf16):
            q, k, v, vec = dyadic_packed(gen, n, t, 8, w, dtype, bias)
            got = la.local_attention_packed(q, k, v, vec, w, 8, prob_dtype=bf16)
            ref = la.local_attention_packed_plain(q, k, v, vec, w, 8, prob_dtype=bf16)
            torch.cuda.synchronize()
            scale = ref.float().abs().max().item()
            share, err = past_ulp(got, ref)
            label = f"kernel K1p {name}: N={n} T={t} 8 x 32 w={w} {str(dtype)[6:]}"
            if dtype == f32:
                ok = err <= 1e-5 * scale
                print(f"{label} max_abs_err={err:.3e} = {err / scale:.3e} of max|ref| "
                      f"{scale:.3e}, tol 1e-5 of max|ref|", flush=True)
            else:
                bound = 2.0 ** -7 * (scale + v.float().abs().max().item())
                share_k1, _ = past_ulp(la.local_attention_packed(q, k, v, vec, w, 8), ref)
                ok = err <= bound and share <= 1e-3 and share_k1 > 1e-3
                print(f"{label} max_abs_err={err:.3e} (tol {bound:.3e}: one ulp of max|ref| + "
                      f"2^-7 max|v|), entries past one bf16 ulp {share:.2e} (tol 1e-3); K1's "
                      f"kernel against K1p's plain version: {share_k1:.2e} past one ulp "
                      f"(must exceed 1e-3)", flush=True)
            errs[f"{name} {str(dtype)[6:]}"] = err
            check(ok and np.isfinite(err), f"{label}: error {err}, past one ulp {share}")

    n, t, w = 1024, 200, 40
    q, k, v, vec = dyadic_packed(gen, n, t, 8, w, bf16)
    k1p = lambda: la.local_attention_packed(q, k, v, vec, w, 8, prob_dtype=bf16)  # noqa: E731
    ms = time_ms(k1p, 20)
    plain_ms = time_ms(lambda: la.local_attention_packed_plain(q, k, v, vec, w, 8,
                                                               prob_dtype=bf16), 5)
    k1_ms = time_ms(lambda: la.local_attention_packed(q, k, v, vec, w, 8), 20)
    q4, k4, v4 = (x.view(n, t, 8, 32).transpose(1, 2).contiguous() for x in (q, k, v))
    mask = la.windowed_bias(t, w, vec, "cuda").to(bf16)[None]    # (1, H, T, T)
    library_ms = time_ms(lambda: F.scaled_dot_product_attention(q4, k4, v4, attn_mask=mask,
                                                                scale=1.0), 20)
    mse_k1 = ((k1p().float() - la.local_attention_packed(q, k, v, vec, w, 8).float()) ** 2
              ).mean().item()
    bytes_moved = 4 * n * t * 8 * 32 * 2 + vec.numel() * 4
    flops = 4 * 32 * band_pairs(t, w) * n * 8
    bound_ms, bound_by = _bound(bytes_moved, flops, rates)
    print(f"kernel K1p timing [{card}] main shape bf16: kernel {ms:.4f} ms (K1 {k1_ms:.4f} ms), "
          f"plain {plain_ms:.4f} ms, library (sdpa with the (H, T, T) bias) {library_ms:.4f} "
          f"ms, bound {bound_ms:.4f} ms by {bound_by} ({bytes_moved / 1e6:.1f} MB, "
          f"{flops / 1e9:.2f} GFLOP); MSE of K1p against K1 {mse_k1:.3e}", flush=True)
    return dict(max_abs_err=errs["main bfloat16"], ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                bound_by=bound_by, library_ms=library_ms)


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


BFM_VERTICES = 38365     # the dense vertices of bfm_noneck_v3.pkl


def write_face_assets(root, seed, layout="flat", faceboxes_sd=None, tddfa_sd=None):
    """Seeded random stage-1 assets at the release files' shapes, in the
    layout ``load_face_assets`` reads: ``flat`` puts the four files at the
    top of ``root`` (FaceBoxesProd.pth a bare state_dict, mb1_120x120.pth a
    ``{'state_dict'}`` with ``module.`` names), ``3ddfa`` as a 3DDFA-V2
    checkout keeps them (FaceBoxes/weights/, weights/, configs/; FaceBoxes'
    names ``module.``-prefixed too). The nets are seeded port modules with
    random BatchNorm statistics, or the given state_dicts; the BFM bases
    (3 * 38365, 40 + 10) and the parameters' mean and std put the face's
    vertices around the middle of the 120^2 crop. Returns ``root``."""
    import pickle
    import numpy as np
    import torch
    from dawn_tpu_torch.models.face3d.faceboxes_net import FaceBoxesNet
    from dawn_tpu_torch.models.face3d.mobilenet import MobileNetV1

    rng = np.random.RandomState(seed)
    sds = []
    for net, given in ((FaceBoxesNet, faceboxes_sd), (MobileNetV1, tddfa_sd)):
        if given is not None:
            sds.append({k: torch.as_tensor(np.asarray(v)) for k, v in given.items()})
            continue
        with torch.random.fork_rng(devices=[]):
            torch.manual_seed(seed)
            sd = net(device="cpu").state_dict()
        for k, v in sd.items():
            if k.endswith("running_mean"):
                sd[k] = torch.from_numpy(0.1 * rng.randn(*v.shape).astype(np.float32))
            elif k.endswith("running_var"):
                sd[k] = torch.from_numpy(0.5 + rng.rand(*v.shape).astype(np.float32))
        if net is FaceBoxesNet:
            # random weights may score no anchor as a face: lift every
            # anchor's class-1 logit so that some pass the 0.2 threshold
            for i in range(3):
                sd[f"conf.{i}.bias"][1::2] += 2.0
        sds.append(sd)
    fb, mb = sds
    n = 3 * BFM_VERTICES
    kp = rng.choice(BFM_VERTICES, 68, replace=False)
    bfm = {"u": (30.0 * rng.randn(n, 1)).astype(np.float32),
           "w_shp": rng.randn(n, 40).astype(np.float32),
           "w_exp": rng.randn(n, 10).astype(np.float32),
           "keypoints": (3 * kp[:, None] + np.arange(3)).reshape(-1).astype(np.int64)}
    mean, std = np.zeros(62, np.float32), np.ones(62, np.float32)
    mean[:12] = [1, 0, 0, 60, 0, 1, 0, 60, 0, 0, 1, 0]     # R ~ I, the crop's middle
    std[:12] = [0.05, 0.05, 0.05, 2.0] * 3

    def module(sd):
        return {f"module.{k}": v for k, v in sd.items()}

    if layout == "flat":
        files = {"FaceBoxesProd.pth": fb, "mb1_120x120.pth": {"state_dict": module(mb)},
                 "bfm_noneck_v3.pkl": bfm,
                 "param_mean_std_62d_120x120.pkl": {"mean": mean, "std": std}}
    else:
        files = {os.path.join("FaceBoxes", "weights", "FaceBoxesProd.pth"): module(fb),
                 os.path.join("weights", "mb1_120x120.pth"): {"state_dict": module(mb)},
                 os.path.join("configs", "bfm_noneck_v3.pkl"): bfm,
                 os.path.join("configs", "param_mean_std_62d_120x120.pkl"):
                     {"mean": mean, "std": std}}
    for rel, obj in files.items():
        path = os.path.join(root, rel)
        os.makedirs(os.path.dirname(path), exist_ok=True)
        if rel.endswith(".pth"):
            torch.save(obj, path)
        else:
            with open(path, "wb") as f:
                pickle.dump(obj, f)
    return root


def kernel_k2(card, rates):
    """Phase: K2 against its plain version, the autograd Function on the
    card against the plain version's autograd, timings at the stage-1 shape."""
    import numpy as np
    import torch
    import torch.nn.functional as F
    from dawn_tpu_torch.ops import local_attention as la
    from dawn_tpu_torch.utils.profiling import band_pairs

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
                             4 * d * band_pairs(t, w) * n * heads, rates)

    bytes_moved = 7 * n * t * heads * d * 2 + 2 * vec.numel() * 4
    flops = 10 * d * band_pairs(t, w) * n * heads
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
    want = tuple(10 * steps if i == kernel else 0 for i in range(7))
    check(launches == want, f"parity launches (K1-K6, K1p) {launches} != {want}")
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


def pipeline_parity():
    """Phase: the pipeline's other models, card against CPU, f32, TF32 off,
    the same weights: HuBERT-large at full width on 2 s of audio (max error
    within 1e-3 of max|ref|), and the two reemb6 PBnets' drives at T=200
    with the same z (atol 1e-4, the pose in its normalized units)."""
    import numpy as np
    import torch
    from dawn_tpu_torch.models.hubert import HubertConfig, HubertModel
    from dawn_tpu_torch.models.pbnet import CVAE, PBnetParams
    from dawn_tpu_torch.pipeline.audio import zero_mean_unit_var
    from dawn_tpu_torch.pipeline.pose_blink import (DEFAULT_BLINK_2, DEFAULT_POSE_6,
                                                    MAX_VALS_8, MIN_VALS_8, drives_separate)

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    rng = np.random.RandomState(SEED + 20)
    torch.manual_seed(SEED + 20)
    cpu = HubertModel(HubertConfig.large(), device="cpu")
    gpu = HubertModel(HubertConfig.large(), device="cuda")
    gpu.load_state_dict(cpu.state_dict())
    wav = torch.from_numpy(zero_mean_unit_var(rng.randn(32000).astype(np.float32))[None])
    ref = cpu(wav)
    got = gpu(wav).cpu()
    err = (got - ref).abs().max().item()
    scale = ref.abs().max().item()
    print(f"pipeline parity: HuBERT-large (24 layers x 1024, random weights) on 2 s of audio, "
          f"card vs CPU, f32, TF32 off: output {tuple(got.shape)}, max_abs_err={err:.3e} "
          f"= {err / scale:.3e} of max|ref| {scale:.3e}, tol 1e-3 of max|ref|", flush=True)
    check(tuple(got.shape) == (1, 99, 1024) and err <= 1e-3 * scale,
          f"HuBERT parity error {err} (max|ref| {scale})")
    del cpu, gpu
    torch.cuda.empty_cache()

    t = 200
    models = {}
    for kind, dim in (("pose", 6), ("blink", 2)):
        cpu = CVAE(PBnetParams(pos_dim=dim), device="cpu")
        gpu = CVAE(PBnetParams(pos_dim=dim), device="cuda")
        gpu.load_state_dict(cpu.state_dict())
        models[kind] = cpu, gpu
    audio = rng.randn(t, 1024).astype(np.float32)
    z_pose, z_blink = (rng.randn(1, t, 256).astype(np.float32) for _ in range(2))
    want, got = (drives_separate(models["pose"][i], models["blink"][i], audio, DEFAULT_POSE_6,
                                 DEFAULT_BLINK_2, z_pose=z_pose, z_blink=z_blink)
                 for i in (0, 1))
    span = MAX_VALS_8[:6] - MIN_VALS_8[:6]
    errs = [float(np.abs((g - w) / s).max()) for g, w, s in zip(got, want, (span, 1.0))]
    print(f"pipeline parity: reemb6 pose and blink drives, T={t}, same z, card vs CPU, f32: "
          f"max_abs_err pose {errs[0]:.3e} (normalized units), blink {errs[1]:.3e}, tol 1e-4",
          flush=True)
    check(got[0].shape == (t, 6) and got[1].shape == (t, 2) and max(errs) <= 1e-4,
          f"PBnet drive errors {errs}")
    del models
    torch.cuda.empty_cache()


def write_pipeline_inputs(root, seconds, size, seed):
    """A synthetic speech-like WAV (44.1 kHz int16: a 120-240 Hz voiced
    buzz with a syllable envelope, plus noise) and a smooth size^2 portrait
    PNG; returns their paths."""
    import numpy as np
    from PIL import Image
    from scipy.io import wavfile

    rng = np.random.RandomState(seed)
    sr = 44100
    tt = np.arange(int(sr * seconds)) / sr
    f0 = 180 + 60 * np.sin(2 * np.pi * 0.7 * tt)
    voice = np.sign(np.sin(2 * np.pi * np.cumsum(f0) / sr)) * (0.5 + 0.5 * np.sin(
        2 * np.pi * 4 * tt)) ** 2
    wav = 0.3 * voice + 0.02 * rng.randn(tt.size)
    wav_path = os.path.join(root, "speech.wav")
    wavfile.write(wav_path, sr, (wav * 32767).astype(np.int16))
    yy, xx = np.mgrid[0:size, 0:size] / size
    face = np.stack([0.6 + 0.3 * np.exp(-((xx - 0.5) ** 2 + (yy - 0.45) ** 2) / 0.08),
                     0.4 + 0.2 * xx, 0.3 + 0.2 * yy], axis=-1)
    img_path = os.path.join(root, "portrait.png")
    Image.fromarray((np.clip(face, 0, 1) * 255).astype(np.uint8)).save(img_path)
    return wav_path, img_path


def pipeline_path(card):
    """Phase: the whole pipeline through the port's CLI entry point
    (``python -m dawn_tpu_torch.pipeline.generator``'s ``main()``) on an 8 s
    44.1 kHz WAV and a 128^2 portrait, assetless: random HuBERT-large,
    random reemb6 x 2, the 128^2 DAWN at 20 DDIM steps (UNet bf16, LFG f32).
    Checks the cache files, a finite (200, 128, 128, 3) video in [0, 1],
    200 PNGs and a 200-frame mp4, and exactly 200 K1 launches and no other
    kernel; then a warm second run of the same generator (again 200 K1),
    stage 4's sampling alone, and a run under the profiler. Returns the
    (K1-K6, K1p) launches of the CLI's run."""
    import tempfile
    import cv2
    import numpy as np
    import torch
    from dawn_tpu_torch.pipeline import generator

    torch.backends.cudnn.allow_tf32 = True      # PyTorch's default for convs
    root = tempfile.mkdtemp(prefix="dawn_pipeline_")
    wav, img = write_pipeline_inputs(root, 8.0, 128, SEED + 30)
    out_dir, cache = os.path.join(root, "out"), os.path.join(root, "cache")
    config = os.path.join(os.path.dirname(os.path.abspath(__file__)), "configs", "dawn_128.yaml")
    argv = ["--audio_path", wav, "--image_path", img, "--output_path", out_dir,
            "--cache_path", cache, "--config", config]
    t = 200

    def checked_run(run):
        _reset_counts()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        gen = run()
        secs = time.perf_counter() - t0
        launches = _counts()
        check(launches == (t, 0, 0, 0, 0, 0, 0), f"pipeline launches (K1-K6, K1p) {launches}")
        return gen, secs, launches, torch.cuda.max_memory_allocated() / 2**30

    gen, cold, launches, cold_peak = checked_run(lambda: generator.main(argv))
    cold_stages = dict(gen.stage_seconds)
    for name, shape in (("init_pose", (1, 7)), ("init_eye_bbox", (1, 8)),
                        ("target_audio", (t, 1024)), ("dri_pose", (t, 6)),
                        ("dri_blink", (t, 2))):
        arr = np.load(os.path.join(cache, f"{name}.npy"))
        check(arr.shape == shape and np.isfinite(arr).all(),
              f"{name}.npy: shape {arr.shape} (want {shape}), finite {np.isfinite(arr).all()}")
    vid = gen.frames
    check(vid.shape == (t, 128, 128, 3) and np.isfinite(vid).all(),
          f"pipeline video {vid.shape}, finite {np.isfinite(vid).all()}")
    lo, hi = float(vid.min()), float(vid.max())
    check(0.0 <= lo and hi <= 1.0, f"pipeline video range [{lo}, {hi}]")
    name = os.path.splitext(os.path.basename(img))[0]
    pngs = len(os.listdir(os.path.join(out_dir, name, "img")))
    cap = cv2.VideoCapture(os.path.join(out_dir, name, "video", f"{name}_silent.mp4"))
    mp4_frames = int(cap.get(cv2.CAP_PROP_FRAME_COUNT))
    cap.release()
    check(pngs == t and mp4_frames == t, f"{pngs} PNGs, {mp4_frames} mp4 frames (want {t})")

    gen, warm, _, warm_peak = checked_run(lambda: (gen.run(), gen)[1])
    t0 = time.perf_counter()            # stage 4's sampling alone, to split off its file writes
    gen.sample_video()
    torch.cuda.synchronize()
    sample_s = time.perf_counter() - t0

    def stages(sec):
        return ", ".join(f"{k} {v:.3f} s" for k, v in sec.items())

    print(f"pipeline path [{card}]: generator.main() on an 8 s 44.1 kHz WAV + 128^2 portrait, "
          f"assetless (random HuBERT-large, reemb6 x 2, 128^2 DAWN 20 DDIM steps UNet bf16 LFG "
          f"f32): cache files (1, 7), (1, 8), ({t}, 1024), ({t}, 6), ({t}, 2); video "
          f"{vid.shape} in [{lo:.4f}, {hi:.4f}], {pngs} PNGs, {mp4_frames}-frame mp4 (ffmpeg "
          f"{'found' if shutil.which('ffmpeg') else 'absent: silent mp4, no mux'}); launches "
          f"K1 {launches[0]}, K3 {launches[2]} (others 0)", flush=True)
    print(f"pipeline path [{card}]: cold CLI call {cold:.3f} s ({stages(cold_stages)}), peak "
          f"memory {cold_peak:.2f} GiB", flush=True)
    print(f"pipeline path [{card}]: warm call {warm:.3f} s = {t / warm:.2f} frames/s end to "
          f"end ({stages(gen.stage_seconds)}), peak memory {warm_peak:.2f} GiB; stage 4's "
          f"sampling alone (sample_video: cache files in, frames on the host out) "
          f"{sample_s:.3f} s, stage 4 minus it "
          f"{gen.stage_seconds['generate_final_video'] - sample_s:+.3f} s (the 200 PNGs and "
          f"the mp4, plus the difference between two sampling calls)", flush=True)
    profile(gen.run, card, "pipeline profile")

    # stage 1 with face assets: seeded random nets and BFM bases at the
    # release files' shapes, so that it runs FaceBoxes and the 3DDFA MobileNet
    gen.paths.tddfa_onnx_dir = write_face_assets(os.path.join(root, "face_assets"), SEED + 31)
    gen, face_cold, _, _ = checked_run(lambda: (gen.run(), gen)[1])
    face_cold_stages = dict(gen.stage_seconds)
    gen, face_warm, _, face_peak = checked_run(lambda: (gen.run(), gen)[1])
    pose = np.load(os.path.join(cache, "init_pose.npy"))
    eye_bbox = np.load(os.path.join(cache, "init_eye_bbox.npy"))
    check(pose.shape == (1, 7) and eye_bbox.shape == (1, 8) and np.isfinite(pose).all()
          and np.isfinite(eye_bbox).all() and not np.array_equal(pose, generator.DEFAULT_POSE),
          f"stage 1 with face assets: pose {pose}, eye_bbox {eye_bbox}")
    print(f"pipeline path [{card}]: with face assets (seeded FaceBoxes, MobileNet-V1, BFM): "
          f"init_pose {pose.round(4).tolist()}, init_eye_bbox {eye_bbox.round(4).tolist()}; "
          f"first call {face_cold:.3f} s ({stages(face_cold_stages)}; stage 1 loads the "
          f"assets), warm {face_warm:.3f} s ({stages(gen.stage_seconds)}), peak memory "
          f"{face_peak:.2f} GiB; K1 x 200 each", flush=True)
    del gen
    shutil.rmtree(root)
    torch.cuda.empty_cache()
    return launches


def portrait_1080p(rng):
    """A 1920 x 1080 BGR uint8 frame with a bright blob where a face would
    be, plus noise drawn from ``rng``."""
    import numpy as np
    h, w = 1080, 1920
    yy, xx = np.mgrid[0:h, 0:w] / h
    face = np.stack([0.35 + 0.3 * np.exp(-((xx - 0.9) ** 2 + (yy - 0.45) ** 2) / 0.06),
                     0.45 + 0.2 * yy, 0.5 + 0.1 * xx], axis=-1)
    return np.clip(255 * face + 6 * rng.randn(h, w, 3), 0, 255).astype(np.uint8)


def face_prep_parity(card):
    """Phase: stage 1, card against CPU, f32, TF32 off, on the same seeded
    assets (``write_face_assets``: the release files' shapes and layouts).
    FaceBoxes on a 607 x 1080 input (a 1920 x 1080 frame after the 720 x 1080
    cap) and MobileNet-V1 on eight 120^2 crops: loc, conf and the 62
    parameters within 1e-4 of max|ref|. Then ``extract_init_states`` on that
    1080p portrait stage by stage: the first box within 1e-4 of max|ref|; the
    ROI's integers (``int(old_size * 1.58)``, the crop's rounded bounds, which
    turn a 1e-6 difference of a box into a whole pixel) compared and printed;
    the 62 parameters from the CPU's box on both sides within 1e-4 of
    max|ref|; pose, eye ratios and bbox from the CPU's parameters equal (host
    code); and end to end (pose and eye ratios within 1e-4 of max|ref|, the
    bbox equal) when the ROI's integers agree. The card's stage 1, cold and
    warm."""
    import tempfile
    import cv2
    import numpy as np
    import torch
    from dawn_tpu_torch.pipeline import face_prep as fp
    from dawn_tpu_torch.weights.checkpoints import load_face_assets

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    root = tempfile.mkdtemp(prefix="dawn_face_")
    write_face_assets(root, SEED + 90)
    gpu, cpu = load_face_assets(root, "cuda"), load_face_assets(root, "cpu")
    rng = np.random.RandomState(SEED + 91)
    path = os.path.join(root, "portrait_1080p.png")
    cv2.imwrite(path, portrait_1080p(rng))
    img = cv2.imread(path)

    def rel(got, ref):
        got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
        return float(np.abs(got - ref).max() / max(np.abs(ref).max(), 1e-30))

    x = (cv2.resize(img, (1080, 607)).astype(np.float32) - fp.BGR_MEAN).transpose(2, 0, 1)[None]
    (loc, conf), (ref_loc, ref_conf) = fp.run_net(gpu.faceboxes)(x), fp.run_net(cpu.faceboxes)(x)
    crops = ((rng.rand(8, 3, 120, 120) * 255 - 127.5) / 128).astype(np.float32)
    par, ref_par = fp.run_net(gpu.tddfa)(crops), fp.run_net(cpu.tddfa)(crops)
    errs = [rel(loc, ref_loc), rel(conf, ref_conf), rel(par, ref_par)]
    print(f"face prep parity: FaceBoxes on (1, 3, 607, 1080) -> loc {loc.shape}, conf "
          f"{conf.shape}; MobileNet-V1 on (8, 3, 120, 120) -> {par.shape}; card vs CPU, f32, "
          f"TF32 off: max err / max|ref| loc {errs[0]:.3e}, conf {errs[1]:.3e}, 62 params "
          f"{errs[2]:.3e} (tol 1e-4)", flush=True)
    check(loc.shape == (1, 13781, 4) and conf.shape == (1, 13781, 2) and max(errs) <= 1e-4,
          f"face nets card vs CPU: {errs}")

    boxes = fp.detect_faces(img, fp.run_net(gpu.faceboxes))
    ref_boxes = fp.detect_faces(img, fp.run_net(cpu.faceboxes))
    check(len(boxes) > 0 and len(ref_boxes) > 0, f"boxes: card {len(boxes)}, CPU {len(ref_boxes)}")
    box_err = rel(boxes[0], ref_boxes[0])

    def roi_integers(box):
        roi = fp.parse_roi_box_from_bbox(box)
        old = (box[2] - box[0] + box[3] - box[1]) / 2
        return int(old * 1.58), [int(round(v)) for v in roi]

    same_roi = roi_integers(boxes[0]) == roi_integers(ref_boxes[0])
    ref_params, ref_rois = fp.regress_3dmm(img, ref_boxes[:1], fp.run_net(cpu.tddfa),
                                           param_mean=cpu.param_mean, param_std=cpu.param_std)
    params, rois = fp.regress_3dmm(img, ref_boxes[:1], fp.run_net(gpu.tddfa),
                                   param_mean=gpu.param_mean, param_std=gpu.param_std)
    param_err = rel(params[0], ref_params[0])
    states = fp.states_from_params(img.shape, ref_params, ref_rois, gpu.bfm)
    ref_states = fp.states_from_params(img.shape, ref_params, ref_rois, cpu.bfm)
    states_equal = all(np.array_equal(a, b) for a, b in zip(states, ref_states))
    print(f"face prep parity: 1080p portrait: {len(boxes)} boxes on the card, {len(ref_boxes)} "
          f"on the CPU; first box {np.round(ref_boxes[0], 2).tolist()}, max err / max|ref| "
          f"{box_err:.3e} (tol 1e-4); ROI integers {roi_integers(ref_boxes[0])} "
          f"{'agree' if same_roi else 'DIFFER: ' + str(roi_integers(boxes[0]))}; 62 params "
          f"from the CPU's box {param_err:.3e} (tol 1e-4); pose, eye ratios and bbox from the "
          f"CPU's params {'equal' if states_equal else 'UNEQUAL'}", flush=True)
    check(box_err <= 1e-4 and param_err <= 1e-4 and states_equal,
          f"stage 1 card vs CPU: box {box_err}, params {param_err}")
    t0 = time.perf_counter()
    pose, eye_bbox = fp.extract_init_states(path, gpu)
    cold = time.perf_counter() - t0
    t0 = time.perf_counter()
    fp.extract_init_states(path, gpu)
    warm = time.perf_counter() - t0
    ref_pose, ref_eye_bbox = fp.extract_init_states(path, cpu)
    if same_roi:
        end = [rel(pose, ref_pose), rel(eye_bbox[:, :2], ref_eye_bbox[:, :2])]
        print(f"face prep parity: extract_init_states end to end, card vs CPU: pose "
              f"{pose.round(4).tolist()}, max err / max|ref| pose {end[0]:.3e}, eye ratios "
              f"{end[1]:.3e} (tol 1e-4), bbox {eye_bbox[0, 2:].tolist()} "
              f"{'equal' if np.array_equal(eye_bbox[:, 2:], ref_eye_bbox[:, 2:]) else 'UNEQUAL'}",
              flush=True)
        check(max(end) <= 1e-4 and np.array_equal(eye_bbox[:, 2:], ref_eye_bbox[:, 2:]),
              f"extract_init_states card vs CPU: {end}")
    else:
        print("face prep parity: the ROI integers differ, so the end-to-end states are not "
              "compared", flush=True)
    print(f"face prep parity [{card}]: extract_init_states on the 1080p portrait on the card "
          f"(FaceBoxes and MobileNet-V1 there, the rest on the host) cold {cold:.3f} s, warm "
          f"{warm:.3f} s", flush=True)
    shutil.rmtree(root)
    del gpu
    torch.cuda.empty_cache()


def _rel_err(got, ref):
    import numpy as np
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    return float(np.abs(got - ref).max() / np.abs(ref).max())


def eval_parity(card):
    """Phase: the evaluation networks, card against CPU, f32, TF32 off, the
    same seeded weights: I3D at the released widths (1024 features, 400
    logits) on 2 x 16 x 224^2 within 1e-4 of max|ref| (then its card time
    per batch with CUDA events, TF32 as PyTorch's default leaves it for
    convolutions); the STGCN recognizer at full width (256 features) on
    'dawn_head' (V=8, C=1) and 'openpose' (V=18, C=3), 64 x 100 frames,
    within 1e-5; the LFG frame features (``lfg_frame_features``) of the
    released 128^2 LFG generator on 2 x 8 frames within 1e-4."""
    import numpy as np
    import torch
    from dawn_tpu_torch.evaluate.i3d import InceptionI3d
    from dawn_tpu_torch.evaluate.quality import lfg_frame_features
    from dawn_tpu_torch.models.lfg.generator import LFGGenerator
    from dawn_tpu_torch.models.pbnet.stgcn import STGCN, build_graph

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    rng = np.random.RandomState(SEED + 130)

    def seeded_stats(model):
        with torch.no_grad():
            for m in model.modules():
                if isinstance(m, torch.nn.modules.batchnorm._BatchNorm):
                    m.running_mean.normal_(0, 0.1)
                    m.running_var.uniform_(0.5, 1.5)
        return model.eval()

    def both(make):
        torch.manual_seed(SEED + 131)
        cpu = seeded_stats(make())
        gpu = make().to("cuda").eval()
        gpu.load_state_dict(cpu.state_dict())
        return cpu, gpu

    cpu, gpu = both(InceptionI3d)
    video = torch.from_numpy(rng.uniform(-1, 1, (2, 16, 224, 224, 3)).astype(np.float32))
    errs = {}
    with torch.no_grad():
        for features in (True, False):
            ref = cpu(video, features=features)
            got = gpu(video.cuda(), features=features).cpu()
            check(ref.shape == (2, 1024 if features else 400), f"I3D shape {tuple(ref.shape)}")
            errs["features" if features else "logits"] = _rel_err(got, ref)
        torch.backends.cudnn.allow_tf32 = True
        x = video.cuda()
        ms = time_ms(lambda: gpu(x), 10)
        torch.backends.cudnn.allow_tf32 = False
    print(f"eval parity: I3D released widths (1024 features, 400 logits) on 2 x 16 x 224^2, "
          f"card vs CPU f32, max err / max|ref|: features {errs['features']:.3e}, logits "
          f"{errs['logits']:.3e} (tol 1e-4)", flush=True)
    print(f"eval parity [{card}]: I3D forward on 2 x 16 x 224^2 (features, cuDNN TF32 on, "
          f"PyTorch's default for convolutions): {ms:.3f} ms per batch", flush=True)
    check(max(errs.values()) <= 1e-4, f"I3D card vs CPU {errs}")
    del cpu, gpu, x

    for layout, (v, c) in (("dawn_head", (8, 1)), ("openpose", (18, 3))):
        cpu, gpu = both(lambda: STGCN(c, 10, build_graph(layout, "spatial")))
        with torch.no_grad():
            for p_cpu, p_gpu in zip(cpu.edge_importance, gpu.edge_importance):
                p_cpu.uniform_(0.5, 1.5)
                p_gpu.copy_(p_cpu)
            x = torch.from_numpy(rng.randn(64, 100, v, c).astype(np.float32))
            ref, got = cpu(x), gpu(x.cuda())
        e = {k: _rel_err(got[k].cpu(), ref[k]) for k in ("features", "yhat")}
        print(f"eval parity: STGCN '{layout}' (V={v}, C={c}) full width, 64 x 100 frames, card "
              f"vs CPU f32: features {tuple(ref['features'].shape)} {e['features']:.3e}, "
              f"logits {e['yhat']:.3e} (tol 1e-5)", flush=True)
        check(max(e.values()) <= 1e-5, f"STGCN {layout} card vs CPU {e}")

    cpu, gpu = both(LFGGenerator)
    frames = rng.rand(2, 8, 128, 128, 3).astype(np.float32)
    err = _rel_err(lfg_frame_features(gpu, frames), lfg_frame_features(cpu, frames))
    print(f"eval parity: LFG frame features (released 128^2 generator, 2 x 8 frames, mean ++ "
          f"std of the 256-channel bottleneck), card vs CPU f32: {err:.3e} (tol 1e-4)",
          flush=True)
    check(err <= 1e-4, f"LFG frame features card vs CPU {err}")
    del cpu, gpu
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = True
    torch.cuda.empty_cache()


def _finite(report):
    """Every number in a (nested) report is finite."""
    import math
    if isinstance(report, dict):
        return all(_finite(v) for v in report.values())
    if isinstance(report, (list, tuple)):
        return all(_finite(v) for v in report)
    return not isinstance(report, float) or math.isfinite(report)


def eval_path(card):
    """Phase: the evaluation CLIs' ``main()`` on the card. ``ood_test
    --metrics`` over 2 pairs, each an 8 s 44.1 kHz WAV (T=200) and a 128^2
    portrait, assetless (random HuBERT-large, reemb6 x 2, the 128^2 DAWN
    at 20 DDIM steps): exactly 400 K1 and no other kernel, each pair's
    seconds, peak memory, a finite metrics.json; then ``ood_test`` once more
    over the pairs in the other order, so that each pair has a warm run
    (the models resident). Then ``eval_quality --released`` over the same
    pairs against a reference dir of the first run's PNG frames as
    ``<tag>.npy``, with ``--i3d-ckpt`` a seeded released-width I3D written
    by ``torch.save``: exactly 400 K1 and nothing else, a finite report,
    and ``per_video_l1`` 0 (the same weights, seed and inputs). Then
    ``eval_pbnet --stgcn`` (a seeded reemb6 pose checkpoint, 8 held-out
    videos of 120 frames in 100-frame windows, 2 seeds) and ``eval_lfg`` (a
    seeded FlowAE at the 128^2 widths in the reference layout, 4 videos of
    120 frames at 128^2):
    no kernel, finite metrics. Returns the (K1-K6, K1p) launches of the
    ood_test and eval_quality --released calls."""
    import tempfile
    import numpy as np
    import torch
    from dawn_tpu_torch.evaluate.i3d import InceptionI3d
    from dawn_tpu_torch.models.lfg.flow_ae import FlowAE
    from dawn_tpu_torch.pipeline.pose_blink import build_for, load_pbnet_with_opt
    from dawn_tpu_torch.scripts import eval_lfg, eval_pbnet, eval_quality, ood_test
    from dawn_tpu_torch.train.data import HDTF_TEST_SPLIT
    from dawn_tpu_torch.weights.checkpoints import lfg_reference_state, save_pbnet_checkpoint

    torch.backends.cudnn.allow_tf32 = True
    root = tempfile.mkdtemp(prefix="dawn_eval_")
    t = 200
    lines = []
    for i in range(2):
        d = os.path.join(root, f"inputs{i}")
        os.makedirs(d)
        wav, img = write_pipeline_inputs(d, 8.0, 128, SEED + 140 + i)
        wav2, img2 = os.path.join(d, f"speech{i}.wav"), os.path.join(d, f"portrait{i}.png")
        os.rename(wav, wav2)
        os.rename(img, img2)
        lines.append(f"{img2} {wav2}\n")
    pairs, reverse = os.path.join(root, "pairs.txt"), os.path.join(root, "pairs_reverse.txt")
    with open(pairs, "w") as f:
        f.writelines(lines)
    with open(reverse, "w") as f:
        f.writelines(lines[::-1])
    tags = [f"portrait{i}_speech{i}" for i in range(2)]

    def counted(fn):
        _reset_counts()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0, _counts(), torch.cuda.max_memory_allocated() / 2**30

    base = ["--resolution", "128", "--sampling-step", "20", "--win-width", "40"]
    out_dir = os.path.join(root, "ood")
    ood, ood_s, ood_launches, ood_peak = counted(lambda: ood_test.main(
        ["--pairs", pairs, "--output", out_dir, "--cache", os.path.join(root, "cache"),
         "--metrics", *base]))
    check(ood_launches == (2 * t, 0, 0, 0, 0, 0, 0), f"ood_test launches {ood_launches}")
    report = ood["report"]
    check(_finite(report) and set(report["per_identity"]) == {0, 1}
          and os.path.exists(os.path.join(out_dir, "metrics.json")), "ood_test metrics.json")
    refs = os.path.join(root, "refs")
    os.makedirs(refs)
    first = {}
    for i, tag in enumerate(tags):
        frames = ood_test.load_frames(os.path.join(out_dir, tag, f"portrait{i}", "img"), 128)
        check(frames.shape == (t, 128, 128, 3), f"ood_test {tag} frames {frames.shape}")
        first[tag] = frames
        np.save(os.path.join(refs, f"{tag}.npy"), np.round(frames * 255).astype(np.uint8))
    rev, _, _, _ = counted(lambda: ood_test.main(
        ["--pairs", reverse, "--output", os.path.join(root, "ood_rev"), "--cache",
         os.path.join(root, "cache_rev"), *base]))
    warm = {tags[1]: ood["seconds"][1], tags[0]: rev["seconds"][1]}
    print(f"eval path [{card}]: ood_test.main() --metrics over 2 pairs (8 s 44.1 kHz WAV + "
          f"128^2 portrait each, assetless, 20 DDIM steps) in {ood_s:.3f} s: pairs "
          f"{', '.join(f'{s:.3f} s' for s in ood['seconds'])} (the first builds HuBERT-large, "
          f"the PBnets and the DAWN model), peak memory {ood_peak:.2f} GiB; launches K1 "
          f"{ood_launches[0]} (others 0); warm seconds of each pair (models resident): "
          f"{', '.join(f'{k} {v:.3f} s' for k, v in warm.items())}", flush=True)
    print(f"eval path [{card}]: ood_test metrics: " + ", ".join(
        f"{k} {v:.6g}" for k, v in report.items() if isinstance(v, float)), flush=True)

    torch.manual_seed(SEED + 141)
    i3d_path = os.path.join(root, "rgb_seeded.pt")
    torch.save(InceptionI3d().state_dict(), i3d_path)
    rel_out = os.path.join(root, "released.json")
    rel, rel_s, rel_launches, rel_peak = counted(lambda: eval_quality.main(
        ["--released", "--pairs", pairs, "--reference-dir", refs, "--i3d-ckpt", i3d_path,
         "--output", os.path.join(root, "rel"), "--cache", os.path.join(root, "cache_rel"),
         "--out", rel_out, *base]))
    check(rel_launches == (2 * t, 0, 0, 0, 0, 0, 0), f"eval_quality launches {rel_launches}")
    check(_finite(rel) and os.path.exists(rel_out), "eval_quality --released report finite")
    l1 = rel["per_video_l1"]
    print(f"eval path [{card}]: eval_quality.main() --released over the same pairs with "
          f"--i3d-ckpt (seeded released-width I3D) in {rel_s:.3f} s, peak memory "
          f"{rel_peak:.2f} GiB, launches K1 {rel_launches[0]} (others 0): " + ", ".join(
              f"{k} {v:.6g}" for k, v in rel.items() if isinstance(v, float))
          + f"; per_video_l1 {l1}", flush=True)
    if any(v != 0.0 for v in l1.values()):
        for i, tag in enumerate(tags):
            again = ood_test.load_frames(os.path.join(root, "rel", tag, f"portrait{i}", "img"),
                                         128)
            diff = np.abs(again - first[tag])
            print(f"eval path: {tag}: {int((diff > 0).sum())} of {diff.size} values differ "
                  f"between the two runs' PNGs, at most {diff.max() * 255:.0f}/255 (frames "
                  f"{sorted(set(np.nonzero(diff)[0].tolist()))[:10]})", flush=True)
    check(all(v == 0.0 for v in l1.values()), f"per_video_l1 against ood_test's frames {l1}")

    names = list(HDTF_TEST_SPLIT[:8])
    flags = write_hdtf_tree(os.path.join(root, "data"), {n: 120 for n in names}, 128,
                            SEED + 142)
    dirs = dict(f[2:].split("=", 1) for f in flags)
    torch.manual_seed(SEED + 143)
    os.makedirs(os.path.join(root, "pose"))
    ckpt = os.path.join(root, "pose", "checkpoint_1.pth.tar")
    save_pbnet_checkpoint(build_for({}, 6, 0, "cpu"), ckpt)
    with open(os.path.join(root, "pose", "opt.yaml"), "w") as f:
        f.write("archiname: transformerreemb6\n")
    pb, pb_s, pb_launches, _ = counted(lambda: eval_pbnet.main(
        ["--ckpt", ckpt, *[f"--{k}={dirs[k]}" for k in ("hubert-dir", "pose-dir", "eye-dir",
                                                        "length-dict")],
         "--workdir", os.path.join(root, "pbnet_eval"), "--niter", "2", "--stgcn"]))
    load_pbnet_with_opt.cache_clear()
    check(len(pb) == 2 and _finite(pb) and len(pb[0]) == 16, f"eval_pbnet metrics {pb}")
    dumps = os.listdir(os.path.join(root, "pbnet_eval", "eval_pred", "1"))
    check(len(dumps) == len(names), f"eval_pbnet dumps {dumps}")
    print(f"eval path [{card}]: eval_pbnet.main() --stgcn (reemb6 pose, {len(names)} held-out "
          f"videos x 120 frames in 100-frame windows, 2 seeds, the seeded dawn_head recognizer) "
          f"in {pb_s:.3f} s, "
          f"launches {pb_launches}: seed 0 " + ", ".join(
              f"{k} {v:.6g}" for k, v in pb[0].items()), flush=True)
    torch.manual_seed(SEED + 144)
    lfg_path = os.path.join(root, "LFG_seeded.pth")
    torch.save(lfg_reference_state(FlowAE()), lfg_path)
    lfg, lfg_s, lfg_launches, lfg_peak = counted(lambda: eval_lfg.main(
        ["--lfg-ckpt", lfg_path, "--frames-dir", dirs["frames-dir"], "--img-size", "128",
         "--num-videos", "4", "--workdir", os.path.join(root, "lfg_eval"), "--write-videos"]))
    check(len(lfg) == 4 and _finite(lfg), f"eval_lfg losses {lfg}")
    check(pb_launches == lfg_launches == (0,) * 7,
          f"eval_pbnet / eval_lfg launches {pb_launches} {lfg_launches}")
    print(f"eval path [{card}]: eval_lfg.main() (seeded FlowAE at the 128^2 widths, 4 videos x "
          f"120 frames at 128^2, side-by-side mp4s) in {lfg_s:.3f} s, peak memory "
          f"{lfg_peak:.2f} GiB, launches {lfg_launches}: L1 {lfg}", flush=True)
    shutil.rmtree(root)
    torch.cuda.empty_cache()
    return ood_launches, rel_launches


def bench_attention(card):
    """Phase: the port's attention micro-benchmark, ``python -m
    dawn_tpu_torch.scripts.bench_attention``'s ``main()`` once at the sampling
    top level (N=1024, T=200, 8 x 32, w=40, bf16) with ``--prob-dtype bf16
    --stripe 2 --seq-composed``, on the open one-rank process group: every
    line printed, K1p, K1, K3, K5 and K6 launched, the MSEs of equal
    functions below 1e-4 and K1p's against K1 below 1e-3. Returns the
    launches (K1-K6, K1p) of that call."""
    import contextlib
    import io
    import math
    import torch
    from dawn_tpu_torch.scripts import bench_attention as bench

    out = io.StringIO()
    _reset_counts()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(out):
        res = bench.main(["--prob-dtype", "bf16", "--stripe", "2", "--seq-composed"])
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    launches = _counts()
    text = out.getvalue()
    for line in text.splitlines():
        print(f"bench attention [{card}]: {line}", flush=True)
    lines = ("banded :", "pallas :", "pallas-vs-banded MSE", "packed :", "packed bf16-prob-tiles",
             "stripe pallas (", "stripe einsum", "stripe pallas-vs-einsum MSE",
             "stripe fused fwd+bwd", "seq-composed fwd", "packed whole-T reference",
             "composed-vs-packed MSE", "seq-composed fused fwd+bwd", "full   :",
             "pallas-vs-full MSE")
    missing = [x for x in lines if x not in text]
    k1, _, k3, _, k5, k6, k1p = launches
    print(f"bench attention [{card}]: main() in {secs:.1f} s, launches K1 {k1}, K3 {k3}, K5 "
          f"{k5}, K6 {k6}, K1p {k1p} (K2 {launches[1]}, K4 {launches[3]})", flush=True)
    check(not missing, f"bench attention lines missing: {missing}")
    check(min(k1p, k1, k3, k5, k6) > 0, f"bench attention launches (K1-K6, K1p) {launches}")
    mses = [res[k] for k in ("pallas_vs_banded_mse", "stripe_mse", "composed_mse")]
    check(all(math.isfinite(m) and m < 1e-4 for m in mses) and res["prob_vs_packed_mse"] < 1e-3,
          f"bench attention MSEs {mses}, K1p vs K1 {res['prob_vs_packed_mse']}")
    torch.cuda.empty_cache()
    return launches


def _wrappers():
    """The kernel wrappers K1-K6 and K1p, each with its launch count."""
    from dawn_tpu_torch.ops import local_attention as la
    return (la.local_attention_packed, la.local_attention_packed_bwd,
            la.local_attention_tiled, la.local_attention_tiled_bwd,
            la.local_attention_packed_stripe, la.local_attention_packed_stripe_bwd,
            la.local_attention_packed_prob)


def _reset_counts():
    for fn in _wrappers():
        fn.launches = 0


def _counts():
    """(K1, ..., K6, K1p) launches since the last reset."""
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
    check(launches == (10, 10, 0, 0, 0, 0, 0),
          f"train-parity launches (K1-K6, K1p) {launches} != (10, 10, 0, 0, 0, 0, 0)")
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
    check(launches1 == (10 * steps, 10 * steps, 0, 0, 0, 0, 0),
          f"stage-1 launches (K1-K6, K1p) {launches1} != {10 * steps} K1 and K2")
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
    check(launches2 == (10 * steps2, 10 * steps2, 0, 0, 0, 0, 0),
          f"stage-2 launches (K1-K6, K1p) {launches2} != {10 * steps2} K1 and K2")
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


def dm_trainer_extras(card):
    """Phase: the DM trainer's options at the stage-1 per-chip recipe point.
    remat 'none', 'dots' and 'full' from one state, batch and set of draws:
    the f32 gradients (TF32 off, cuDNN deterministic) of 'dots' and 'full'
    against 'none', then each mode's K1/K2 launches, warm step and peak
    memory at bs 4 in bf16; the CLI with --teacher-cache over two passes of
    a small tree (hit rate, snapshot PNG), the cached step against the
    uncached one and the snapshot's launches; --prefetch against the same
    run without it (batches, losses, step walls); one use_fft_floss step,
    card against CPU in f32. Returns {path: (K1, ..., K6, K1p) launches}."""
    import tempfile
    import numpy as np
    import torch
    import yaml
    from PIL import Image
    from dawn_tpu_torch.scripts import train_dm as cli
    from dawn_tpu_torch.train.data import HDTFVideoDataset, TeacherCache
    from dawn_tpu_torch.train.train_dm import REMAT, DMTrainConfig, DMTrainer

    paths = {}
    jitter = {k: torch.tensor([v, v]) for k, v in (
        ("brightness", 1.1), ("contrast", 0.9), ("saturation", 1.2), ("hue", 0.02))}

    # remat: f32 gradients of one state, batch and set of draws
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cudnn.deterministic = True
    b, t = 2, 20
    torch.manual_seed(SEED)
    trainer = DMTrainer(DMTrainConfig(win_width=20))
    r = np.random.RandomState(SEED + 40)
    ls = trainer.config.latent_size
    draws = {"t": np.array([371, 802]), "noise": r.randn(b, t, ls, ls, 3).astype(np.float32),
             "drop": r.rand(b, t) < 0.1, "jitter": jitter}
    batch = trainer._batch(_train_batch(b, t, 128, SEED + 41))
    grads, counts = {}, {}
    for remat in REMAT:
        trainer.config.remat = remat
        trainer.unet.zero_grad(set_to_none=True)
        _reset_counts()
        total, _ = trainer.loss_fn(batch, draws)
        total.backward()
        counts[remat] = _counts()
        grads[remat] = (total.item(), [p.grad for p in trainer.unet.parameters()])
    torch.backends.cudnn.deterministic = False
    top = max(g.abs().max().item() for g in grads["none"][1])
    errs = {m: max((a - c).abs().max().item() for a, c in zip(grads[m][1], grads["none"][1]))
            / top for m in ("dots", "full")}
    same = {m: all(torch.equal(a, c) for a, c in zip(grads[m][1], grads["none"][1]))
            and grads[m][0] == grads["none"][0] for m in ("dots", "full")}
    print(f"dm trainer extras [{card}] remat f32 (TF32 off, cuDNN deterministic), stage 1 bs "
          f"{b} x {t} frames, full width, one state, batch and draws: loss none "
          f"{grads['none'][0]:.7f}, dots {grads['dots'][0]:.7f}, full {grads['full'][0]:.7f}; "
          f"gradients against 'none': dots max err {errs['dots']:.3e}, full {errs['full']:.3e} "
          f"of their max {top:.4e} (tol 1e-6), bit-equal dots {same['dots']}, full "
          f"{same['full']}; K1/K2 launches none {counts['none'][:2]}, dots "
          f"{counts['dots'][:2]}, full {counts['full'][:2]}", flush=True)
    check(max(errs.values()) <= 1e-6, f"remat gradients differ from 'none': {errs}")
    check(counts["none"] == (10, 10, 0, 0, 0, 0, 0)
          and counts["dots"] == counts["full"] == (20, 10, 0, 0, 0, 0, 0),
          f"remat launches (K1-K6, K1p) {counts}")
    del trainer, grads, batch
    torch.cuda.empty_cache()

    # remat at the recipe point: bs 4, bf16, cuDNN TF32 (PyTorch's default)
    torch.backends.cudnn.allow_tf32 = True
    torch.manual_seed(SEED)
    trainer = DMTrainer(DMTrainConfig(win_width=20, compute_dtype=torch.bfloat16))
    batches = [_train_batch(4, 20, 128, SEED + 42 + i) for i in range(2)]
    timing = {}
    for remat in REMAT:
        trainer.config.remat = remat
        trainer.train_step(batches[0])
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        times = []
        for i in range(2):
            _reset_counts()
            t0 = time.perf_counter()
            m = trainer.train_step(batches[(i + 1) % 2])
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
            check(np.isfinite(m["total"]) and m["grads_finite"] == 1.0,
                  f"remat {remat} loss not finite")
        paths[f"train_remat_{remat}"] = _counts()
        timing[remat] = (1e3 * min(times), 1e3 * max(times),
                         torch.cuda.max_memory_allocated() / 2**30)
    print(f"dm trainer extras [{card}] remat bs 4 x 20 frames, 128^2, full width, bf16, warm "
          f"step ms (min-max of 2) and peak memory: " + "; ".join(
              f"{m} {a:.1f}-{z:.1f} ms, {g:.2f} GiB, K1 x {paths[f'train_remat_{m}'][0]}, K2 x "
              f"{paths[f'train_remat_{m}'][1]}" for m, (a, z, g) in timing.items()), flush=True)
    check(paths["train_remat_dots"] == paths["train_remat_full"] == (20, 10, 0, 0, 0, 0, 0),
          f"remat bf16 launches {paths}")
    del trainer
    torch.cuda.empty_cache()

    # the CLI: teacher cache over two passes of 4 videos x 2 clip starts,
    # the snapshot every 2 steps; then --prefetch against the same run
    root = os.path.dirname(os.path.abspath(__file__))
    tmp = tempfile.mkdtemp(prefix="dawn_extras_")
    flags = write_hdtf_tree(os.path.join(tmp, "data"),
                            {f"vid_{i:03d}": 40 for i in range(4)}, 128, SEED + 44)
    with open(os.path.join(root, "configs", "dm_train_stage1.yaml")) as f:
        cfg = yaml.safe_load(f)
    cfg.update(batch_size=4, compute_dtype="bfloat16")
    config = os.path.join(tmp, "stage1.yaml")
    with open(config, "w") as f:
        yaml.safe_dump(cfg, f)
    base = [f"--config={config}", *flags, "--log-every=1"]
    cache_dir, work = os.path.join(tmp, "cache"), os.path.join(tmp, "cached")
    _reset_counts()
    t0 = time.perf_counter()
    trainer = cli.main(base + ["--steps=4", f"--teacher-cache={cache_dir}",
                               "--teacher-cache-stride=20", "--sample-every=2",
                               f"--workdir={work}"])
    secs = time.perf_counter() - t0
    launches = _counts()
    lines = [json.loads(x) for x in open(os.path.join(work, "metrics.jsonl"))]
    rates = [x["teacher_cache_hit_rate"] for x in lines]
    png = os.path.join(work, "imgshots", "step_0000002.png")
    with Image.open(png) as im:
        size = im.size
    check(all(np.isfinite(x["total"]) for x in lines) and rates[-1] > 0,
          f"teacher-cache run: hit rates {rates}")
    check(size == (4 * 128, 7 * 128), f"snapshot PNG size {size}")
    check(launches == (50, 40, 0, 0, 0, 0, 0),
          f"cached CLI launches (K1-K6, K1p) {launches} != 4 steps x 10 + one snapshot's 10 K1")
    print(f"dm trainer extras [{card}] CLI --teacher-cache (stride 20: 8 clips of 4 videos), bs "
          f"4, bf16, 4 steps + a snapshot at step 2 in {secs:.2f} s: hit rates {rates}, step "
          f"walls (s) {[round(x['wall'], 3) for x in lines]}, {len(os.listdir(cache_dir))} "
          f"cache entries, {png[len(tmp) + 1:]} {size[0]}x{size[1]}; K1 x {launches[0]}, K2 x "
          f"{launches[1]}", flush=True)

    dirs = dict(f[2:].split("=", 1) for f in flags)
    ds = HDTFVideoDataset(dirs["frames-dir"], dirs["hubert-dir"], dirs["pose-dir"],
                          dirs["eye-dir"], dirs["length-dict"], lmk_dir=dirs["lmk-dir"],
                          num_frames=20, seed=SEED, start_stride=20)
    raw, meta = next(ds.batches(4, 1, with_meta=True))
    cache = TeacherCache(os.path.join(tmp, "cache2"))
    cached = cache.convert_batch(raw, meta, trainer.teacher_precompute)
    step_ms, teacher_ms = {}, []
    for _ in range(3):
        for label, bt in (("uncached", raw), ("cached", cached)):
            for _ in range(3):
                _reset_counts()
                t0 = time.perf_counter()
                trainer.train_step(bt)
                torch.cuda.synchronize()
                step_ms.setdefault(label, []).append(1e3 * (time.perf_counter() - t0))
            paths[f"train_{label}"] = _counts()
        t0 = time.perf_counter()
        trainer.teacher_precompute(raw["video"])
        torch.cuda.synchronize()
        teacher_ms.append(1e3 * (time.perf_counter() - t0))
    _reset_counts()
    t0 = time.perf_counter()
    snaps = trainer.snapshot(raw)
    snap_secs = time.perf_counter() - t0
    paths["snapshot"] = _counts()
    check(sorted(snaps) == sorted(("real_frames", "real_decode", "fake_decode", "real_flow_fig",
                                   "fake_flow_fig", "real_conf_fig", "fake_conf_fig"))
          and all(v.shape == (4, 128, 128, 3) and np.isfinite(v.astype(np.float32)).all()
                  for v in snaps.values()), "snapshot panels")
    check(paths["snapshot"] == (10, 0, 0, 0, 0, 0, 0) and paths["train_cached"] == (10, 10, 0,
                                                                                      0, 0, 0, 0),
          f"snapshot / cached-step launches {paths['snapshot']} {paths['train_cached']}")
    print(f"dm trainer extras [{card}] bs 4 x 20 frames bf16 warm train_step, 3 rounds of 3 "
          f"each, alternating: "
          f"uncached (teacher + color jitter) {[round(x, 1) for x in step_ms['uncached']]} ms, "
          f"median {np.median(step_ms['uncached']):.1f}; cached (teacher tensors from the cache)"
          f" {[round(x, 1) for x in step_ms['cached']]} ms, median "
          f"{np.median(step_ms['cached']):.1f}; the teacher pass alone "
          f"{[round(x, 1) for x in teacher_ms]} ms; snapshot (EMA weights, T=4, w=20 past T) "
          f"{1e3 * snap_secs:.1f} ms, K1 x {paths['snapshot'][0]}", flush=True)
    del trainer, snaps
    torch.cuda.empty_cache()

    pre_batches = list(ds.batches_prefetched(4, 3, device="cuda"))
    ds_plain = HDTFVideoDataset(dirs["frames-dir"], dirs["hubert-dir"], dirs["pose-dir"],
                                dirs["eye-dir"], dirs["length-dict"], lmk_dir=dirs["lmk-dir"],
                                num_frames=20, seed=SEED, start_stride=20)
    next(ds_plain.batches(4, 1))          # the batch drawn above, so both streams align
    plain_batches = list(ds_plain.batches(4, 3))
    check(all(v.is_cuda for bt in pre_batches for v in bt.values())
          and all(np.array_equal(p[k], q[k].cpu().numpy()) for p, q in
                  zip(plain_batches, pre_batches) for k in p),
          "prefetched batches differ from the plain ones")
    # cuDNN's deterministic algorithms: the same batches then give the same
    # updates, so every step's losses are bit-equal, not only step 0's
    runs = {}
    torch.backends.cudnn.deterministic = True
    for label, extra in (("plain", []), ("prefetch", ["--prefetch"])):
        _reset_counts()
        cli.main(base + ["--steps=3", "--sample-every=0",
                         f"--workdir={os.path.join(tmp, label)}", *extra])
        paths[f"train_{label}"] = _counts()
        runs[label] = [json.loads(x) for x in open(os.path.join(tmp, label, "metrics.jsonl"))]
    torch.backends.cudnn.deterministic = False
    diffs = [max(abs(a[k] - c[k]) / max(abs(c[k]), 1e-6) for k in ("total", "loss", "floss"))
             for a, c in zip(runs["prefetch"], runs["plain"])]
    print(f"dm trainer extras [{card}] --prefetch vs plain CLI, bs 4, bf16, 3 steps: 3 "
          f"prefetched batches on the card equal the plain ones; totals "
          f"{[round(x['total'], 6) for x in runs['prefetch']]} vs "
          f"{[round(x['total'], 6) for x in runs['plain']]}, rel diffs "
          f"{[f'{d:.2e}' for d in diffs]} (cuDNN deterministic, tol 0); step walls (s) "
          f"prefetch {[round(x['wall'], 3) for x in runs['prefetch']]}, plain "
          f"{[round(x['wall'], 3) for x in runs['plain']]}", flush=True)
    check(max(diffs) == 0, f"prefetch losses differ: {diffs}")
    check(paths["train_prefetch"] == paths["train_plain"] == (30, 30, 0, 0, 0, 0, 0),
          f"prefetch launches {paths['train_prefetch']} {paths['train_plain']}")
    del paths["train_plain"]
    shutil.rmtree(tmp)
    torch.cuda.empty_cache()

    # one use_fft_floss step, the card against the CPU, f32, TF32 off, at the
    # recipe's 20 frames: an rfft of length 20 (11 bins, mixed radix)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = DMTrainConfig(win_width=20, use_fft_floss=True)
    torch.manual_seed(SEED)
    gpu = DMTrainer(cfg, device="cuda")
    cpu = DMTrainer(cfg, device="cpu")
    for a, c in ((gpu.unet, cpu.unet), (gpu.flow_ae, cpu.flow_ae), (gpu.face_loc, cpu.face_loc)):
        c.load_state_dict(a.state_dict())
    r = np.random.RandomState(SEED + 45)
    draws = {"t": np.array([503]), "noise": r.randn(1, 20, ls, ls, 3).astype(np.float32),
             "drop": r.rand(1, 20) < 0.1, "jitter": {k: v[:1] for k, v in jitter.items()}}
    batch = _train_batch(1, 20, 128, SEED + 46)
    _reset_counts()
    got = gpu.train_step(batch, draws)
    paths["train_fft_floss"] = _counts()
    want = cpu.train_step(batch, draws)
    err = max(abs(got[k] - want[k]) / max(abs(want[k]), 1e-6)
              for k in ("loss", "floss", "mouth_loss", "total"))
    print(f"dm trainer extras [{card}] use_fft_floss train_step f32 full width bs 1 T=20, card "
          f"vs CPU, TF32 off: floss {got['floss']:.6f} vs {want['floss']:.6f}, total "
          f"{got['total']:.6f} vs {want['total']:.6f}, max rel err {err:.3e} (tol 1e-4); K1 x "
          f"{paths['train_fft_floss'][0]}, K2 x {paths['train_fft_floss'][1]}", flush=True)
    check(err <= 1e-4, f"fft floss card vs CPU {err}")
    check(paths["train_fft_floss"] == (10, 10, 0, 0, 0, 0, 0),
          f"fft floss launches {paths['train_fft_floss']}")
    del gpu, cpu
    torch.cuda.empty_cache()
    return paths


def cached_cli_nccl(card):
    """Phase: the DM CLI with an f16 --teacher-cache on the one-rank NCCL
    group, so that the sharded step and TeacherCache.convert_batch_shared
    (its barriers on NCCL) run, with --sample-every 2: 4 steps at bs 2 in
    bf16 over 2 videos of 40 frames (stride 20: 4 clips recur). Finite
    losses, a hit rate above 0, one f16 entry per clip drawn, the PNG.
    Returns the (K1, ..., K6, K1p) launches."""
    import tempfile
    import numpy as np
    import yaml
    from dawn_tpu_torch.scripts import train_dm as cli

    root = os.path.dirname(os.path.abspath(__file__))
    tmp = tempfile.mkdtemp(prefix="dawn_cached_nccl_")
    flags = write_hdtf_tree(os.path.join(tmp, "data"), {"vid_000": 40, "vid_001": 40}, 128,
                            SEED + 49)
    with open(os.path.join(root, "configs", "dm_train_stage1.yaml")) as f:
        cfg = yaml.safe_load(f)
    cfg.update(batch_size=2, compute_dtype="bfloat16")
    config, cache, work = (os.path.join(tmp, n) for n in ("stage1.yaml", "cache", "run"))
    with open(config, "w") as f:
        yaml.safe_dump(cfg, f)
    _reset_counts()
    t0 = time.perf_counter()
    cli.main([f"--config={config}", *flags, "--log-every=1", "--steps=4",
              f"--teacher-cache={cache}", "--teacher-cache-stride=20", "--teacher-cache-f16",
              "--sample-every=2", f"--workdir={work}"])
    secs = time.perf_counter() - t0
    launches = _counts()
    lines = [json.loads(x) for x in open(os.path.join(work, "metrics.jsonl"))]
    rates = [x["teacher_cache_hit_rate"] for x in lines]
    entries = sorted(os.listdir(cache))
    with np.load(os.path.join(cache, entries[0])) as z:
        f16 = all(z[k].dtype == np.float16 for k in z.files)
    print(f"cached cli nccl [{card}]: DM CLI on a one-rank NCCL mesh (sharded step, shared "
          f"teacher cache, f16), bs 2 x 20 frames, bf16, 4 steps in {secs:.2f} s: totals "
          f"{[round(x['total'], 6) for x in lines]}, hit rates {rates}, entries {entries}; "
          f"launches (K1-K6, K1p) {launches}", flush=True)
    check(all(np.isfinite(x["total"]) and x["grads_finite"] == 1.0 for x in lines)
          and rates[-1] > 0 and f16 and len(entries) <= 4
          and os.path.isfile(os.path.join(work, "imgshots", "step_0000002.png")),
          f"cached CLI on NCCL: hit rates {rates}, entries {entries}, f16 {f16}")
    check(launches == (50, 40, 0, 0, 0, 0, 0),
          f"cached CLI on NCCL launches (K1-K6, K1p) {launches} != 4 steps x 10 + one "
          f"snapshot's 10 K1")
    shutil.rmtree(tmp)
    return launches


def pbnet_sharded_losses(card, mesh):
    """Phase: PBnetTrainer.make_sharded_step on the one-rank NCCL mesh with
    the losses rc, rcw, reg, kl, ssim, var, mmd and hp (MIN/MAX all-reduces,
    the differentiable all-gather of z, whole-batch draws on NCCL) against
    the unsharded step on the card, shipped width, dropout 0.1, B=4 x T=40
    with ragged lengths, the same seed: metrics rtol 1e-5, Adam's first
    moments to 1e-5 of each model's largest."""
    import numpy as np
    import torch
    from dawn_tpu_torch.models.pbnet.cvae import PBnetParams
    from dawn_tpu_torch.train.train_pbnet import PBnetTrainConfig, PBnetTrainer

    torch.backends.cuda.matmul.allow_tf32 = False
    lambdas = {k: 1.0 for k in ("rc", "rcw", "reg", "kl", "ssim", "var", "mmd", "hp")}
    batch = _pbnet_batch(np.random.RandomState(SEED + 47), 4, 40, 6, [40, 33, 27, 40])
    trainers = []
    for _ in range(2):
        torch.manual_seed(SEED + 48)
        trainers.append(PBnetTrainer(PBnetTrainConfig(kind="pose"),
                                     hp=PBnetParams(dropout=0.1, lambdas=lambdas)))
    _reset_counts()
    want = trainers[0].train_step(batch)
    got = trainers[1].make_sharded_step(mesh)(batch)
    launches = _counts()
    err = max(abs(got[k] - want[k]) / max(abs(want[k]), 1e-6) for k in want)
    mu_err = []
    for i in range(2):
        sharded, plain = trainers[1].optimizers[i], trainers[0].optimizers[i]
        pairs = [(sharded.state[a]["mu"], plain.state[c]["mu"])
                 for a, c in zip(sharded.param_groups[0]["params"],
                                 plain.param_groups[0]["params"])]
        top = max(c.abs().max().item() for _, c in pairs)
        mu_err.append(max((a - c).abs().max().item() for a, c in pairs) / top)
    print(f"pbnet sharded losses [{card}]: make_sharded_step on a one-rank NCCL mesh vs "
          f"train_step, lambdas {sorted(lambdas)}, shipped width, dropout 0.1, B=4 T=40: "
          + ", ".join(f"{k} {got[k]:.6f}" for k in ("ssim", "var", "mmd", "hp", "g_total"))
          + f"; max rel err {err:.3e} (tol 1e-5); Adam mu err G {mu_err[0]:.3e}, D "
          f"{mu_err[1]:.3e} of their max (tol 1e-5)", flush=True)
    check(set(lambdas) <= set(got), f"sharded PBnet metrics {sorted(got)}")
    check(err <= 1e-5 and max(mu_err) <= 1e-5, f"sharded PBnet losses {err} {mu_err}")
    check(launches == (0,) * 7, f"pbnet sharded launches (K1-K6, K1p) {launches}")
    del trainers
    torch.cuda.empty_cache()
    return launches


def _update_errors(pairs, before, mu, lr, clear_of_max):
    """(max |mu_card - mu_cpu| over the largest |mu_cpu|, the largest update
    difference, and that difference where |mu| is above ``clear_of_max`` of
    the largest, less 1e-6 of the old value) over (card, cpu) parameter
    pairs: Adam's first step is about lr * sign(g), so elements with a
    clear gradient agree to 1e-7 and the rest to 2 lr + 1e-7."""
    top = max(m_cpu.abs().max().item() for _, m_cpu in mu)
    mu_err = max((a.cpu() - c).abs().max().item() for a, c in mu) / top
    upd_err = clear_err = 0.0
    for (a, c), old, (_, m) in zip(pairs, before, mu):
        diff = (a.detach().cpu() - c.detach()).abs()
        upd_err = max(upd_err, diff.max().item())
        clear = m.abs() > clear_of_max * top
        if clear.any():
            clear_err = max(clear_err, (diff[clear] - 1e-6 * old[clear].abs()).max().item())
    return mu_err, upd_err, clear_err


def lfg_train_parity():
    """Phase: one f32 LFGTrainer step at the full configs/lfg_hdtf128.yaml
    widths, B=2 at 128^2, seeded VGG19, the card against the CPU, TF32 off,
    the same weights and warp draws (frames uniform in [0, 1] from
    RandomState(SEED + 31)): loss terms (rtol 1e-4), running statistics
    (1e-4 of each buffer's largest magnitude), the gradient per net (Adam's
    first moment, 0.5 g) and the update (1e-7 where |mu| is above 3e-2 of
    the largest, else 2 lr + 1e-7).

    A float64 gradient of the same loss on the card is the reference both
    f32 gradients are held to. The region predictor, the flow predictor
    and the background predictor take their gradient through a softmax
    (the region heatmaps over 32x32 positions at temperature 0.1, the flow
    predictor's mask over the 11 motions, which weighs the background
    motion), whose backward is a difference of nearly equal terms; f32
    rounding leaves up to about 1.6e-2 of such a net's largest entry, most
    at the heads next to the softmax. So: within 3e-2 of the net's largest
    entry for those three nets, 3e-3 for the generator, card against CPU
    and each against float64; and every leaf whose float64 gradient is not
    zero (above 1e-6 of the net's largest: conv biases before train-mode
    BatchNorm and the background encoder behind its zero-initialised fc
    have none) within 0.15 of its own largest entry. The closed-form SVD's
    gradient grows as the two singular values of a covariance meet, so the
    phase asserts every covariance of the three region-predictor passes
    keeps its smaller singular value below 0.95 of its larger."""
    import numpy as np
    import torch
    from dawn_tpu_torch.train.train_lfg import LFGTrainConfig, LFGTrainer

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = LFGTrainConfig()
    torch.manual_seed(SEED + 30)
    cpu = LFGTrainer(cfg, device="cpu")
    gpu = LFGTrainer(cfg, device="cuda")
    gpu.flow_ae.load_state_dict(cpu.flow_ae.state_dict())
    gpu.vgg.load_state_dict(cpu.vgg.state_dict())
    r = np.random.RandomState(SEED + 31)
    batch = {k: r.rand(2, 128, 128, 3).astype(np.float32) for k in ("source", "driving")}
    draws = {"affine": r.randn(2, 2, 3).astype(np.float32),
             "tps": r.randn(2, 1, 25).astype(np.float32)}
    before = {n: p.detach().clone() for n, p in cpu.flow_ae.named_parameters()}
    ref = LFGTrainer(cfg, device="cuda")          # the float64 gradient, no step
    ref.flow_ae.load_state_dict(cpu.flow_ae.state_dict())
    ref.vgg.load_state_dict(cpu.vgg.state_dict())
    ref.flow_ae.double()
    ref.vgg.double()
    for m in ref.flow_ae.modules():               # the blocks' compute dtype
        if isinstance(getattr(m, "dtype", None), torch.dtype):
            m.dtype = torch.float64
    covars = []                                   # the three region-predictor passes
    hook = ref.flow_ae.region_predictor.register_forward_hook(
        lambda module, args, out: covars.append(out["covar"].detach()))
    total64, _ = ref.loss_fn(*({k: torch.from_numpy(v).to("cuda", torch.float64)
                                for k, v in d.items()} for d in (batch, draws)))
    hook.remove()
    total64.backward()
    g64 = {n: p.grad.cpu() for n, p in ref.flow_ae.named_parameters()}
    sv = [torch.linalg.svdvals(c) for c in covars]
    ratios = [float((s[..., 1] / s[..., 0]).max()) for s in sv]
    del ref, total64, covars
    _reset_counts()
    got = gpu.train_step(batch, draws)
    launches = _counts()
    want = cpu.train_step(batch, draws)
    check(launches == (0,) * 7, f"lfg train launches (K1-K6, K1p) {launches}")
    loss_err = max(abs(got[k] - want[k]) / abs(want[k]) for k in want)
    stats_err = max((a.cpu().float() - c.float()).abs().max().item()
                    / max(c.float().abs().max().item(), 1e-12)
                    for (n, a), c in zip(gpu.flow_ae.state_dict().items(),
                                         cpu.flow_ae.state_dict().values()) if "running" in n)
    errs = {}
    for net in ("generator", "region_predictor", "bg_predictor", "pixelwise_flow_predictor"):
        pa, pc = (list(getattr(t.flow_ae, net).parameters()) for t in (gpu, cpu))
        old = [before[f"{net}.{n}"] for n, _ in getattr(cpu.flow_ae, net).named_parameters()]
        mu = [(gpu.optimizer.state[a]["mu"], cpu.optimizer.state[c]["mu"])
              for a, c in zip(pa, pc)]
        names = [n for n, _ in getattr(cpu.flow_ae, net).named_parameters()]
        ref64 = [g64[f"{net}.{n}"] for n in names]
        top = max(g.abs().max().item() for g in ref64)
        f64_errs = []    # per device: (largest error over top, its leaf, over the leaf's own)
        for i in (0, 1):
            err = {n: (m[i].cpu().double() / 0.5 - g).abs().max().item()
                   for n, m, g in zip(names, mu, ref64)}
            own = {n: err[n] / g.abs().max().item()
                   for n, g in zip(names, ref64) if g.abs().max().item() > 1e-6 * top}
            worst, worst_own = max(err, key=err.get), max(own, key=own.get)
            f64_errs.append((err[worst] / top, worst, own[worst_own], worst_own))
        errs[net] = _update_errors(list(zip(pa, pc)), old, mu, cfg.lr, 3e-2) + tuple(f64_errs)
    print(f"lfg train parity: LFGTrainer.train_step f32, configs/lfg_hdtf128.yaml widths, "
          f"B=2 at 128^2, seeded VGG19, card vs CPU, TF32 off: total {got['total']:.6f} vs "
          f"{want['total']:.6f}, perceptual {got['perceptual']:.6f} vs {want['perceptual']:.6f},"
          f" equivariance shift {got['equivariance_shift']:.6f} vs "
          f"{want['equivariance_shift']:.6f}, affine {got['equivariance_affine']:.6f} vs "
          f"{want['equivariance_affine']:.6f}: max rel err {loss_err:.3e} (tol 1e-4); running "
          f"statistics max err {stats_err:.3e} of a buffer's max (tol 1e-4); no kernel "
          f"launched", flush=True)
    print(f"lfg train parity: covariance singular-value ratio s1/s0, largest per "
          f"region-predictor pass (source, driving, TPS-warped): "
          f"{', '.join(f'{r:.4f}' for r in ratios)} (limit 0.95)", flush=True)
    tols = {"generator": 3e-3}                    # the other three: 3e-2 (see above)
    for net, (mu_err, upd_err, clear_err, card64, cpu64) in errs.items():
        print(f"lfg train parity: {net}: gradient card vs CPU max err {mu_err:.3e} of its max, "
              f"card f32 vs f64 {card64[0]:.3e} (worst leaf {card64[1]}), CPU f32 vs f64 "
              f"{cpu64[0]:.3e} ({cpu64[1]}) (tol {tols.get(net, 3e-2):.0e} each); per leaf "
              f"of its own max, card {card64[2]:.3e} ({card64[3]}), CPU {cpu64[2]:.3e} "
              f"({cpu64[3]}) (tol 0.15); update max err {upd_err:.3e} (tol "
              f"{2 * cfg.lr + 1e-7:.3g}), where |mu| > 3e-2 max {clear_err:.3e} (tol 1e-7)",
              flush=True)
    check(max(ratios) < 0.95, f"lfg train parity covariances near the SVD's degenerate "
          f"point: ratios {ratios}")
    check(loss_err <= 1e-4 and stats_err <= 1e-4, f"lfg train parity {loss_err} {stats_err}")
    check(all(max(m, a[0], b[0]) <= tols.get(net, 3e-2) and max(a[2], b[2]) <= 0.15
              and u <= 2 * cfg.lr + 1e-7 and c <= 1e-7
              for net, (m, u, c, a, b) in errs.items()),
          f"lfg train parity gradient or update errors {errs}")
    del cpu, gpu
    torch.cuda.empty_cache()


def lfg_train_path(card):
    """Phase: warm LFGTrainer steps at configs/lfg_hdtf128.yaml's batch size
    100, 128^2, f32 (cuDNN's TF32, PyTorch's default), resident batches;
    returns the (K1, ..., K6, K1p) launches of its steps."""
    import numpy as np
    import torch
    import yaml
    from dawn_tpu_torch.train.train_lfg import LFGTrainConfig, LFGTrainer

    torch.backends.cudnn.allow_tf32 = True
    root = os.path.dirname(os.path.abspath(__file__))
    with open(os.path.join(root, "configs", "lfg_hdtf128.yaml")) as f:
        bs = yaml.safe_load(f)["train_params"]["batch_size"]
    torch.manual_seed(SEED + 32)
    trainer = LFGTrainer(LFGTrainConfig(), device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(SEED + 33)
    batches = [{k: torch.rand(bs, 128, 128, 3, generator=gen, device="cuda")
                for k in ("source", "driving")} for _ in range(2)]
    stats0 = {n: b.clone() for n, b in trainer.flow_ae.named_buffers() if "running" in n}
    torch.cuda.reset_peak_memory_stats()
    _reset_counts()
    t0 = time.perf_counter()
    first = trainer.train_step(batches[0])
    cold = time.perf_counter() - t0
    times, metrics = [], []
    for i in range(3):
        t0 = time.perf_counter()
        metrics.append(trainer.train_step(batches[i % 2]))      # ends in a host read
        times.append(time.perf_counter() - t0)
    launches = _counts()
    peak_gb = torch.cuda.max_memory_allocated() / 2**30
    moved = sum(not torch.equal(b, stats0[n]) for n, b in trainer.flow_ae.named_buffers()
                if "running" in n)
    check(all(np.isfinite(v) for m in [first] + metrics for v in m.values()),
          "lfg train losses not finite")
    check(moved == len(stats0), f"running statistics moved in {moved} of {len(stats0)} buffers")
    check(launches == (0,) * 7, f"lfg train launches (K1-K6, K1p) {launches}")
    warm = float(np.median(times))
    print(f"lfg train path [{card}]: LFGTrainer.train_step, configs/lfg_hdtf128.yaml, bs {bs} "
          f"at 128^2, f32 (cuDNN TF32), seeded VGG19, resident batches: cold {cold:.3f} s, warm "
          f"{[round(1e3 * x, 1) for x in times]} ms, median {1e3 * warm:.1f} ms = "
          f"{bs / warm:.1f} examples/s; totals {[round(m['total'], 4) for m in metrics]}; "
          f"{moved}/{len(stats0)} running statistics moved; peak memory {peak_gb:.2f} GiB; "
          f"no kernel launched", flush=True)
    profile(lambda: trainer.train_step(batches[0]), card, "lfg train profile")
    del trainer, batches
    torch.cuda.empty_cache()
    return launches


def _pbnet_batch(rng, b, t, dim, lengths=None):
    import numpy as np
    x = (0.5 + 0.1 * rng.randn(b, t, dim)).astype(np.float32)
    hubert = rng.randn(b, t, 1024).astype(np.float32)
    batch = {"x": x, "hubert": hubert}
    if lengths is not None:
        for i, n in enumerate(lengths):
            x[i, n:] = 0.0
            hubert[i, n:] = 0.0
        batch["lengths"] = np.asarray(lengths)
    return batch


def pbnet_train_parity():
    """Phase: one PBnetTrainer step, reemb6 at the shipped width, dropout 0,
    B=4 at T=40 with ragged lengths, the card against the CPU, f32, TF32
    off, the same weights and z noise: the metrics (rtol 1e-4), Adam's first
    moments of G and D (1e-3 of each one's largest) and the update (1e-7
    where |mu| is above 1e-3 of the largest, else 2 lr + 1e-7)."""
    import numpy as np
    import torch
    from dawn_tpu_torch.models.pbnet.cvae import PBnetParams
    from dawn_tpu_torch.train.train_pbnet import PBnetTrainConfig, PBnetTrainer

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = PBnetTrainConfig(kind="pose")
    torch.manual_seed(SEED + 34)
    cpu = PBnetTrainer(cfg, hp=PBnetParams(dropout=0.0), device="cpu")
    gpu = PBnetTrainer(cfg, hp=PBnetParams(dropout=0.0), device="cuda")
    gpu.model.load_state_dict(cpu.model.state_dict())
    gpu.disc.load_state_dict(cpu.disc.state_dict())
    r = np.random.RandomState(SEED + 35)
    batch = _pbnet_batch(r, 4, 40, 6, [40, 33, 27, 40])
    draws = {"eps": r.randn(4, 40, 256).astype(np.float32)}
    modules = [(gpu.model, cpu.model, 0), (gpu.disc, cpu.disc, 1)]
    before = [[p.detach().clone() for p in c.parameters()] for _, c, _ in modules]
    _reset_counts()
    got = gpu.train_step(batch, 0, draws)
    launches = _counts()
    want = cpu.train_step(batch, 0, draws)
    check(launches == (0,) * 7, f"pbnet train launches (K1-K6, K1p) {launches}")
    loss_err = max(abs(got[k] - want[k]) / max(abs(want[k]), 1e-6) for k in want)
    errs = []
    for (a, c, i), old in zip(modules, before):
        pairs = list(zip(a.parameters(), c.parameters()))
        mu = [(gpu.optimizers[i].state[pa]["mu"], cpu.optimizers[i].state[pc]["mu"])
              for pa, pc in pairs]
        errs.append(_update_errors(pairs, old, mu, cfg.lr, 1e-3))
    print(f"pbnet train parity: PBnetTrainer.train_step, reemb6 shipped width (latent 256, 2 "
          f"layers, ff 128, 4 heads), dropout 0, B=4 T=40 lengths [40, 33, 27, 40], card vs "
          f"CPU, f32, TF32 off: g_total {got['g_total']:.6f} vs {want['g_total']:.6f}, d_loss "
          f"{got['d_loss']:.6f} vs {want['d_loss']:.6f}, rc {got['rc']:.6f} vs {want['rc']:.6f}:"
          f" max rel err {loss_err:.3e} (tol 1e-4); G: Adam mu err {errs[0][0]:.3e} of its max "
          f"(tol 1e-3), update {errs[0][1]:.3e} (tol {2 * cfg.lr + 1e-7:.3g}), clear "
          f"{errs[0][2]:.3e} (tol 1e-7); D: {errs[1][0]:.3e}, {errs[1][1]:.3e}, "
          f"{errs[1][2]:.3e}; no kernel launched", flush=True)
    check(loss_err <= 1e-4, f"pbnet train parity loss error {loss_err}")
    check(all(m <= 1e-3 and u <= 2 * cfg.lr + 1e-7 and c <= 1e-7 for m, u, c in errs),
          f"pbnet train parity gradient or update errors {errs}")
    del cpu, gpu
    torch.cuda.empty_cache()


def pbnet_train_path(card):
    """Phase: PBnetTrainer steps for the pose and the blink model at the JAX
    script's defaults (batch 32 x 100 frames, dropout 0.1, the shipped
    width); returns the (K1, ..., K6, K1p) launches of its steps."""
    import numpy as np
    import torch
    from dawn_tpu_torch.train.train_pbnet import PBnetTrainConfig, PBnetTrainer

    torch.backends.cuda.matmul.allow_tf32 = False
    r = np.random.RandomState(SEED + 36)
    _reset_counts()
    for kind, dim in (("pose", 6), ("blink", 2)):
        torch.manual_seed(SEED + 37)
        trainer = PBnetTrainer(PBnetTrainConfig(kind=kind), device="cuda")
        batches = [_pbnet_batch(r, 32, 100, dim) for _ in range(2)]
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        first = trainer.train_step(batches[0])
        cold = time.perf_counter() - t0
        times, metrics = [], []
        for i in range(4):
            t0 = time.perf_counter()
            metrics.append(trainer.train_step(batches[i % 2], 0))
            times.append(time.perf_counter() - t0)
        peak_gb = torch.cuda.max_memory_allocated() / 2**30
        check(trainer.model.training and all(np.isfinite(v) for m in [first] + metrics
                                             for v in m.values()),
              f"pbnet {kind} losses not finite")
        warm = float(np.median(times))
        print(f"pbnet train path [{card}]: {kind}, PBnetTrainer.train_step, batch 32 x 100 "
              f"frames, dropout 0.1, f32: cold {1e3 * cold:.1f} ms, warm "
              f"{[round(1e3 * x, 1) for x in times]} ms, median {1e3 * warm:.1f} ms = "
              f"{32 / warm:.1f} sequences/s; g_total {[round(m['g_total'], 4) for m in metrics]}"
              f"; peak memory {peak_gb:.2f} GiB", flush=True)
        del trainer
    launches = _counts()
    check(launches == (0,) * 7, f"pbnet train launches (K1-K6, K1p) {launches}")
    torch.cuda.empty_cache()
    return launches


def trainer_clis(card):
    """Phase: ``python -m dawn_tpu_torch.scripts.train_lfg`` (configs/lfg_hdtf128.yaml,
    batch 8) and ``... train_pbnet --kind pose|blink`` (the script's defaults)
    for 3 steps each on the card, on a synthetic HDTF tree; then the
    inference loaders read their checkpoints strictly on the card:
    ``FlowAE.load_reference_checkpoint`` and ``load_lfg_generator`` into a
    FlowDiffusion, ``load_pbnet_with_opt`` for both PBnets, whose drives
    must be finite. Returns the (K1, ..., K6, K1p) launches of the runs."""
    import tempfile
    import numpy as np
    import torch
    from dawn_tpu_torch.models.dm.flow_diffusion import FlowDiffusion
    from dawn_tpu_torch.models.lfg.flow_ae import FlowAE
    from dawn_tpu_torch.pipeline.pose_blink import (DEFAULT_BLINK_2, DEFAULT_POSE_6,
                                                    drives_separate, load_pbnet_with_opt)
    from dawn_tpu_torch.scripts import train_lfg, train_pbnet
    from dawn_tpu_torch.weights.checkpoints import load_lfg_generator

    torch.backends.cudnn.allow_tf32 = True
    root = os.path.dirname(os.path.abspath(__file__))
    tmp = tempfile.mkdtemp(prefix="dawn_clis_")
    flags = write_hdtf_tree(os.path.join(tmp, "data"),
                            {f"vid_{i:03d}": 100 for i in range(4)}, 128, SEED + 38)
    dirs = dict(f[2:].split("=", 1) for f in flags)
    _reset_counts()
    t0 = time.perf_counter()
    lfg = train_lfg.main([f"--config={os.path.join(root, 'configs', 'lfg_hdtf128.yaml')}",
                          f"--frames-dir={dirs['frames-dir']}", "--steps=3", "--batch-size=8",
                          "--log-every=1", f"--workdir={os.path.join(tmp, 'lfg')}"])
    lfg_secs = time.perf_counter() - t0
    path = train_lfg.latest_checkpoint(os.path.join(tmp, "lfg", "ckpt"))
    lines = [json.loads(x) for x in open(os.path.join(tmp, "lfg", "metrics.jsonl"))]
    check(lfg.step == 3 and [x["step"] for x in lines] == [0, 1, 2]
          and all(np.isfinite(x["total"]) for x in lines), "LFG CLI run")
    flow_ae = FlowAE().to("cuda")
    flow_ae.load_reference_checkpoint(path)
    check(all(torch.equal(v, lfg.flow_ae.state_dict()[k])
              for k, v in flow_ae.state_dict().items()), "LFG checkpoint round trip")
    fd = FlowDiffusion(device="cuda")
    skipped = load_lfg_generator(fd, path)
    check(all(torch.equal(v, lfg.flow_ae.generator.state_dict()[k])
              for k, v in fd.generator.state_dict().items())
          and all(k.startswith("pixelwise_flow_predictor.") for k in skipped),
          "LFG generator into FlowDiffusion")
    del lfg, flow_ae, fd
    t0 = time.perf_counter()
    models = {}
    for kind, dims in (("pose", (6, 0)), ("blink", (2, 0))):
        work = os.path.join(tmp, "pbnet")
        pb = train_pbnet.main([f"--kind={kind}", *[f"--{k}={dirs[k]}" for k in (
            "hubert-dir", "pose-dir", "eye-dir", "length-dict")], "--steps=3", "--log-every=1",
            f"--workdir={work}"])
        ckpt = os.path.join(work, kind, "checkpoint_3.pth.tar")
        models[kind] = load_pbnet_with_opt(ckpt, *dims, "cuda")
        check(pb.step == 3 and all(torch.equal(v, pb.model.state_dict()[k])
                                   for k, v in models[kind].state_dict().items()),
              f"PBnet {kind} checkpoint round trip")
    pb_secs = time.perf_counter() - t0
    r = np.random.RandomState(SEED + 39)
    pose, blink = drives_separate(models["pose"], models["blink"],
                                  r.randn(100, 1024).astype(np.float32), DEFAULT_POSE_6,
                                  DEFAULT_BLINK_2)
    launches = _counts()
    check(pose.shape == (100, 6) and blink.shape == (100, 2) and np.isfinite(pose).all()
          and np.isfinite(blink).all(), "drives from the trained PBnets")
    check(launches == (0,) * 7, f"trainer CLI launches (K1-K6, K1p) {launches}")
    print(f"trainer clis [{card}]: train_lfg 3 steps (lfg_hdtf128, batch 8, 128^2) in "
          f"{lfg_secs:.2f} s, totals {[round(x['total'], 4) for x in lines]}; "
          f"LFG_0000003.pth read strictly by FlowAE.load_reference_checkpoint and "
          f"load_lfg_generator (FlowDiffusion, {len(skipped)} flow-predictor entries skipped);"
          f" train_pbnet pose + blink 3 steps each (batch 32 x 100) in {pb_secs:.2f} s, "
          f"checkpoint_3.pth.tar + opt.yaml read by load_pbnet_with_opt, finite drives "
          f"{pose.shape} {blink.shape}", flush=True)
    load_pbnet_with_opt.cache_clear()
    del models
    torch.cuda.empty_cache()
    shutil.rmtree(tmp)
    return launches


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
    from dawn_tpu_torch.utils.profiling import band_pairs

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
                                    4 * 32 * band_pairs(t, w) * n * heads, rates)
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
    from dawn_tpu_torch.utils.profiling import band_pairs

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
    check(_counts() == (0, 0, 1, 1, 0, 0, 0), f"autograd launches (K1-K6, K1p) {_counts()}")
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
    check(_counts() == (0, 0, 1, 1, 0, 0, 0), f"bf16 autograd launches (K1-K6, K1p) {_counts()}")
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
                                    10 * 32 * band_pairs(t, w) * n * heads, rates)
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
    check(launches == (0, 0, 1, 1, 0, 0, 0), f"TemporalAttention launches (K1-K6, K1p) {launches}")
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
    want = tuple(200 if i == kernel else 0 for i in range(7))
    check(launches == want, f"launches (K1-K6, K1p) {launches} != {want}")
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
    check(_counts() == (0, 0, 0, 0, 1, 1, 0), f"stripe autograd launches (K1-K6, K1p) {_counts()}")
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
    (K1), then the 200-frame, 20-step bf16 video. Returns the (K1-K6, K1p)
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
    check(ref_launches == (10 * steps, 0, 0, 0, 0, 0, 0)
          and launches == (0, 0, 0, 0, 10 * steps, 0, 0),
          f"seq parity launches (K1-K6, K1p) {ref_launches} / {launches}")
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
    check(launches == (0, 0, 0, 0, 200, 0, 0), f"seq path launches (K1-K6, K1p) {launches}")
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
    two full-width bf16 stage-2 steps. Returns the (K1-K6, K1p) launches of the
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
    check(ref_launches == (10, 10, 0, 0, 0, 0, 0) and launches == (0, 0, 0, 0, 10, 10, 0),
          f"seq train-parity launches (K1-K6, K1p) {ref_launches} / {launches}")
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
    check(launches == (0, 0, 0, 0, 20, 20, 0), f"seq train launches (K1-K6, K1p) {launches}")
    peak_gb = torch.cuda.max_memory_allocated() / 2**30
    print(f"seq train path [{card}]: make_sharded_step, one-rank NCCL mesh, stripe forced, "
          f"stage 2 bs 4 x 40 diffused frames, 128^2 full width bf16, 2 steps: totals "
          f"{[round(x, 4) for x in totals]}, step times {[round(x, 3) for x in times]} s "
          f"(warm {times[-1]:.3f} s = {4 / times[-1]:.2f} examples/s), K5 x {launches[4]}, "
          f"K6 x {launches[5]}, peak memory {peak_gb:.2f} GiB", flush=True)
    del trainer
    torch.cuda.empty_cache()
    return launches


def _interpolate(model, inp, x1, x2, noise, t):
    """GaussianDiffusion.interpolate of two latent videos with the model's
    UNet and the conditioning of ``sample_one_video``'s inputs (image
    feature, face mask, condition), on the model's device."""
    import torch
    from dawn_tpu_torch.models.dm.flow_diffusion import generate_bbox_mask

    dev, cfg = model.device, model.config
    inp = {k: v.to(dev, torch.float32) for k, v in inp.items()}
    b, frames = inp["audio_hubert"].shape[:2]
    ls = cfg.latent_size
    with torch.no_grad():
        cond = model.build_condition(inp["audio_hubert"], inp["pose"], inp["eye"],
                                     inp["pose"][:, 0], inp["eye"][:, 0])
        fea = model.generator.compute_fea(inp["sample_img"])[:, None]
        mask = model.face_loc(generate_bbox_mask(inp["bbox"], cfg.img_size))[:, None]
        return model.diffusion.interpolate(
            model.unet, x1.to(dev), x2.to(dev), fea.expand(b, frames, ls, ls, -1),
            mask.expand(b, frames, ls, ls, -1), cond, t=t, lam=0.3, noise_seq=noise.to(dev))


def ancestral_parity():
    """Phase: the ancestral sampler at full width, the card (K1) against the
    CPU (plain path), f32, TF32 off, the same weights and noise:
    sample_one_video through p_sample_loop with a GaussianDiffusion of 3
    train steps swapped in (exactly 30 K1), then interpolate at t=2 (20
    K1); tolerance 1e-3, as ``parity``. Returns interpolate's (K1, ...,
    K6, K1p) launches."""
    import torch
    from dawn_tpu_torch.models.dm.diffusion import GaussianDiffusion
    from dawn_tpu_torch.models.dm.flow_diffusion import FlowDiffusion, FlowDiffusionConfig

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t, steps = 40, 3
    cfg = FlowDiffusionConfig(dtype=torch.float32)
    torch.manual_seed(SEED + 40)
    gpu = FlowDiffusion(cfg, device="cuda")
    cpu = FlowDiffusion(cfg, device="cpu")
    cpu.load_state_dict(gpu.state_dict())
    for m in (gpu, cpu):
        m.diffusion = GaussianDiffusion(timesteps=steps, sampling_timesteps=steps)
    inp = inputs_for(t, cfg.img_size, SEED + 41)
    ls = cfg.latent_size
    g = torch.Generator().manual_seed(SEED + 42)
    noise = torch.randn((steps + 1, 1, t, ls, ls, 3), generator=g)
    _reset_counts()
    out_gpu = gpu.sample_one_video(**inp, noise_seq=noise)["sample_out_vid"].cpu()
    launches = _counts()
    check(launches == (10 * steps, 0, 0, 0, 0, 0, 0),
          f"ancestral parity launches (K1-K6, K1p) {launches}")
    t0 = time.perf_counter()
    out_cpu = cpu.sample_one_video(**inp, noise_seq=noise)["sample_out_vid"]
    cpu_s = time.perf_counter() - t0
    err = (out_gpu - out_cpu).abs().max().item()
    print(f"ancestral parity: sample_one_video through p_sample_loop (GaussianDiffusion("
          f"timesteps={steps}, sampling_timesteps={steps}) swapped in), T={t} f32 full width, "
          f"card (K1 x {launches[0]}) vs CPU (plain, {cpu_s:.1f} s), TF32 off: "
          f"max_abs_err={err:.3e} tol=1e-3", flush=True)
    check(err <= 1e-3, f"ancestral parity error {err}")

    for m in (gpu, cpu):
        m.diffusion = GaussianDiffusion()
    x1, x2 = (torch.randn((1, t, ls, ls, 3), generator=g) for _ in range(2))
    noise = torch.randn((2 + 2, 1, t, ls, ls, 3), generator=g)
    _reset_counts()
    got = _interpolate(gpu, inp, x1, x2, noise, 2).cpu()
    interp = _counts()
    want = _interpolate(cpu, inp, x1, x2, noise, 2)
    err = (got - want).abs().max().item()
    check(interp == (20, 0, 0, 0, 0, 0, 0), f"interpolate launches (K1-K6, K1p) {interp}")
    check(bool(torch.isfinite(got).all()), "interpolate gave non-finite values")
    print(f"ancestral parity: GaussianDiffusion.interpolate (1000-step schedule, t=2, lam 0.3) "
          f"of two T={t} latent videos with the full-width UNet, card (K1 x {interp[0]}) vs "
          f"CPU, f32, TF32 off: latent {tuple(got.shape)}, max_abs_err={err:.3e} tol=1e-3",
          flush=True)
    check(err <= 1e-3, f"interpolate parity error {err}")
    del gpu, cpu
    torch.cuda.empty_cache()
    return interp


def ancestral_path(card):
    """Phase: the ancestral sampler on the main path's model (128^2, T=200,
    UNet bf16, LFG f32) with GaussianDiffusion(timesteps=50,
    sampling_timesteps=50) swapped in, 50 of the released 1000 train steps:
    a cold and a warm call, exactly 500 K1 in the warm one, a finite video
    in [0, 1]. Then the released setting's dispatch: sample_one_video with
    ``sampling_timesteps=1000`` and the UNet replaced by a stub that counts
    its calls (1 for the step-constant part, then one a train step, 999 to
    0), 8 frames. Returns the warm call's (K1, ..., K6, K1p) launches."""
    import torch
    from dawn_tpu_torch.models.dm.diffusion import GaussianDiffusion
    from dawn_tpu_torch.models.dm.flow_diffusion import FlowDiffusion, FlowDiffusionConfig

    torch.backends.cudnn.allow_tf32 = True
    t, steps = 200, 50
    torch.manual_seed(SEED)
    model = FlowDiffusion(FlowDiffusionConfig())
    model.diffusion = GaussianDiffusion(timesteps=steps, sampling_timesteps=steps)
    inp = inputs_for(t, 128, SEED + 3)

    def run():
        out = model.sample_one_video(
            **inp, generator=torch.Generator(device="cuda").manual_seed(SEED + 4))
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
    check(tuple(vid.shape) == (1, t, 128, 128, 3), f"ancestral video shape {tuple(vid.shape)}")
    check(bool(torch.isfinite(vid).all()), "ancestral video has non-finite values")
    lo, hi = vid.min().item(), vid.max().item()
    check(0.0 <= lo and hi <= 1.0, f"ancestral video range [{lo}, {hi}]")
    check(launches == (10 * steps, 0, 0, 0, 0, 0, 0),
          f"ancestral path launches (K1-K6, K1p) {launches}")
    peak_gb = torch.cuda.max_memory_allocated() / 2**30
    print(f"ancestral path [{card}]: 128^2 T={t}, p_sample_loop over {steps} train steps (cut "
          f"from the released 1000), UNet bf16 LFG f32: video {tuple(vid.shape)} in [{lo:.4f}, "
          f"{hi:.4f}], launches K1 {launches[0]}; cold call {cold:.2f} s, warm call {secs:.3f} s "
          f"= {secs / steps * 1e3:.1f} ms a step, {t / secs:.2f} frames/s, peak memory "
          f"{peak_gb:.2f} GiB", flush=True)
    del model, vid
    torch.cuda.empty_cache()

    frames = 8
    model = FlowDiffusion(FlowDiffusionConfig(sampling_timesteps=1000))
    calls = []

    def stub(x, time_=None, cond=None, drop=None, static_feat=None, precompute_static=False):
        calls.append(None if precompute_static else int(time_[0]))
        shape = x.shape[:-1] + ((64,) if precompute_static else (3,))
        return torch.zeros(shape, dtype=x.dtype, device=x.device)

    model.unet.forward = stub
    _reset_counts()
    vid = model.sample_one_video(**inputs_for(frames, 128, SEED + 5),
                                 generator=torch.Generator(device="cuda").manual_seed(SEED))
    check(calls == [None] + list(range(999, -1, -1)),
          f"sampling_timesteps=1000 made {len(calls)} denoiser calls, not 1 + 1000 ancestral")
    check(bool(torch.isfinite(vid["sample_out_vid"]).all()) and _counts() == (0,) * 7,
          "the stub dispatch run")
    print(f"ancestral path: FlowDiffusionConfig(sampling_timesteps=1000) dispatches to "
          f"p_sample_loop: {len(calls) - 1} denoiser calls at train steps 999..0 (a stub "
          f"UNet, {frames} frames), as the reference", flush=True)
    del model
    torch.cuda.empty_cache()
    return launches


def fuse_cond(card):
    """Phase: ``fuse_cond=True`` at full width: one Unet3D call (128^2 model,
    32^2 latent, T=40, f32, TF32 off) fused against unfused with the same
    weights (tolerance 1e-4; the port computes both as the three separate
    condition branches, the JAX package's fusion being the same function up
    to f32 rounding), then a 2-step T=40 bf16 video through
    sample_one_video with it (20 K1, finite, in [0, 1])."""
    import torch
    from dawn_tpu_torch.models.dm.flow_diffusion import FlowDiffusion, FlowDiffusionConfig
    from dawn_tpu_torch.models.dm.unet3d import Unet3D

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t = 40
    kw = dict(dim=64, channels=275, dim_mults=(1, 2, 4, 8), cond_pose=6, win_width=40,
              attn_mode="local")
    torch.manual_seed(SEED + 43)
    nets = {f: Unet3D(fuse_cond=f, **kw).cuda().eval() for f in (False, True)}
    nets[True].load_state_dict(nets[False].state_dict())
    g = torch.Generator(device="cuda").manual_seed(SEED + 44)
    x = torch.randn(1, t, 32, 32, 275, generator=g, device="cuda")
    cond = torch.randn(1, t, 1032, generator=g, device="cuda")
    time_ = torch.tensor([431], device="cuda")
    drop = torch.arange(t, device="cuda")[None] % 5 == 0
    with torch.no_grad():
        out = {f: net(x, time_, cond, drop) for f, net in nets.items()}
    err = (out[True] - out[False]).abs().max().item()
    print(f"fuse_cond: Unet3D at full width (dim 64, mults (1,2,4,8)), 32^2 latent T={t}, f32, "
          f"TF32 off, every 5th frame's condition dropped: fused vs unfused, same weights, "
          f"max_abs_err={err:.3e} (max|out| {out[False].abs().max().item():.3e}) tol=1e-4",
          flush=True)
    check(err <= 1e-4, f"fuse_cond error {err}")
    del nets, out
    torch.cuda.empty_cache()

    torch.backends.cudnn.allow_tf32 = True
    torch.manual_seed(SEED)
    model = FlowDiffusion(FlowDiffusionConfig(sampling_timesteps=2, fuse_cond=True))
    _reset_counts()
    t0 = time.perf_counter()
    vid = model.sample_one_video(**inputs_for(t, 128, SEED + 3),
                                 generator=torch.Generator(device="cuda").manual_seed(SEED + 4)
                                 )["sample_out_vid"]
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    launches = _counts()
    lo, hi = vid.min().item(), vid.max().item()
    check(bool(torch.isfinite(vid).all()) and 0.0 <= lo and hi <= 1.0,
          f"fuse_cond video range [{lo}, {hi}]")
    check(launches == (20, 0, 0, 0, 0, 0, 0), f"fuse_cond video launches {launches}")
    print(f"fuse_cond [{card}]: sample_one_video, fuse_cond=True, 128^2 T={t} 2 DDIM steps UNet "
          f"bf16: video {tuple(vid.shape)} in [{lo:.4f}, {hi:.4f}], K1 x {launches[0]}, one "
          f"call (cold) {secs:.2f} s", flush=True)
    del model, vid
    torch.cuda.empty_cache()


# the LFG architecture flags of the JAX nets, each set otherwise than in
# configs/lfg_hdtf128.yaml: (label, FlowAE keyword dicts' changes)
LFG_VARIANTS = [
    ("bg zero", {"bg_kw": {"bg_type": "zero"}}),
    ("bg shift", {"bg_kw": {"bg_type": "shift"}}),
    ("bg perspective", {"bg_kw": {"bg_type": "perspective"}}),
    ("FOMM head (pca_based off)", {"region_kw": {"pca_based": False}}),
    ("no estimate_affine", {"region_kw": {"estimate_affine": False},
                            "flow_kw": {"use_covar_heatmap": False}}),
    ("use_covar_heatmap off", {"flow_kw": {"use_covar_heatmap": False}}),
    ("use_deformed_source off", {"flow_kw": {"use_deformed_source": False}}),
    ("estimate_occlusion_map off", {"flow_kw": {"estimate_occlusion_map": False}}),
    ("skips off", {"generator_kw": {"skips": False}}),
]


def lfg_variants(card):
    """Phase: the LFG flags at configs/lfg_hdtf128.yaml's widths: FlowAE's
    motion_transfer of a batch of 2 at 128^2, the card against the CPU, f32,
    TF32 off, the same weights (each net's heads set off the identity, so
    that every head moves the output), for each of LFG_VARIANTS (prediction
    and flow within 1e-3; the occlusion map too where there is one); one
    LFGTrainer step on the card with bg 'perspective' and the FOMM head
    (finite losses); AVDNetwork card vs CPU in eval and train mode
    (1e-4 of max|ref|)."""
    import numpy as np
    import torch
    from dawn_tpu_torch.models.lfg.avd_network import AVDNetwork
    from dawn_tpu_torch.models.lfg.flow_ae import FlowAE
    from dawn_tpu_torch.train.train_lfg import LFGTrainConfig, LFGTrainer

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    g = torch.Generator().manual_seed(SEED + 45)
    src, drv = (torch.rand(2, 128, 128, 3, generator=g) for _ in range(2))
    parts = []
    for label, change in LFG_VARIANTS:
        torch.manual_seed(SEED + 46)
        cpu = FlowAE(**change)
        with torch.no_grad():
            for name in ("bg_predictor.fc.weight", "region_predictor.jacobian.weight"):
                p = dict(cpu.named_parameters()).get(name)
                if p is not None:
                    p.copy_(1e-3 * torch.randn(p.shape, generator=g))
        gpu = FlowAE(**change).cuda()
        gpu.load_state_dict(cpu.state_dict())
        with torch.no_grad():
            want = cpu.motion_transfer(src, drv)
            got = gpu.motion_transfer(src.cuda(), drv.cuda())
        keys = [k for k in ("prediction", "optical_flow", "occlusion_map")
                if want.get(k) is not None]
        check((got["occlusion_map"] is None) == (want["occlusion_map"] is None),
              f"lfg variant {label}: the occlusion map on one side only")
        errs = {k: (got[k].cpu() - want[k]).abs().max().item() for k in keys}
        check(all(np.isfinite(e) and e <= 1e-3 for e in errs.values()),
              f"lfg variant {label}: errors {errs}")
        parts.append(f"{label} " + "/".join(f"{e:.2e}" for e in errs.values()))
        del cpu, gpu
    print(f"lfg variants: FlowAE.motion_transfer at configs/lfg_hdtf128.yaml widths, 2 x 128^2, "
          f"card vs CPU, f32, TF32 off, max_abs_err of prediction/flow(/occlusion), tol 1e-3: "
          + "; ".join(parts), flush=True)

    torch.backends.cudnn.allow_tf32 = True
    bn = dict(train_bn=True)
    torch.manual_seed(SEED + 47)
    trainer = LFGTrainer(LFGTrainConfig(), FlowAE(
        generator_kw=bn, region_kw=dict(bn, pca_based=False),
        bg_kw=dict(bn, bg_type="perspective"), flow_kw=bn), device="cuda")
    _reset_counts()
    t0 = time.perf_counter()
    m = trainer.train_step({"source": src, "driving": drv})
    secs = time.perf_counter() - t0
    check(all(np.isfinite(v) for v in m.values()) and "equivariance_affine" in m
          and _counts() == (0,) * 7, f"lfg variant step metrics {m}")
    print(f"lfg variants [{card}]: LFGTrainer.train_step with bg 'perspective' and the FOMM "
          f"head, batch 2 at 128^2, f32 (cuDNN TF32): "
          + ", ".join(f"{k} {v:.4f}" for k, v in m.items()) + f"; cold step {secs:.2f} s",
          flush=True)
    del trainer
    torch.cuda.empty_cache()

    torch.backends.cudnn.allow_tf32 = False
    torch.manual_seed(SEED + 48)
    cpu = AVDNetwork()
    with torch.no_grad():
        for name, b in cpu.named_buffers():
            if name.endswith("running_mean"):
                b.copy_(0.1 * torch.randn(b.shape, generator=g))
            elif name.endswith("running_var"):
                b.copy_(0.5 + torch.rand(b.shape, generator=g))
    gpu = AVDNetwork().cuda()
    gpu.load_state_dict(cpu.state_dict())
    params = [{"shift": 0.6 * torch.rand(16, 10, 2, generator=g) - 0.3,
               "affine": torch.eye(2) + 0.2 * torch.randn(16, 10, 2, 2, generator=g)}
              for _ in range(2)]
    errs = []
    for train in (False, True):
        with torch.no_grad():
            want = cpu(*params, train=train)
            got = gpu(*({k: v.cuda() for k, v in p.items()} for p in params), train=train)
        errs.append(max((got[k].cpu() - want[k]).abs().max().item()
                        / max(want[k].abs().max().item(), 1e-6) for k in want))
    print(f"lfg variants: AVDNetwork (10 regions, bottlenecks 64), 16 pairs of region "
          f"parameters, card vs CPU, f32, TF32 off: max err eval {errs[0]:.3e}, train "
          f"{errs[1]:.3e} of max|ref| (tol 1e-4)", flush=True)
    check(max(errs) <= 1e-4, f"AVD errors {errs}")
    del cpu, gpu
    torch.cuda.empty_cache()


def pbnet_archs(card):
    """Phase: every architecture of the PBnet registry at the opt defaults'
    widths (latent 256, pose latent 64, ff 128, 2 layers, 4 heads): CVAE.
    generate of 32 sequences of 100 frames (mlp: 96, a multiple of 8), the
    card against the CPU, f32, TF32 off, the same weights and z (1e-4 of
    max|ref|); one PBnetTrainer step on the card (finite losses); then
    generate_drives_separate with 'gru' pose and blink models read back
    from release-layout checkpoint_*.pth.tar files and their opt.yaml,
    card against CPU (1e-4)."""
    import tempfile

    import numpy as np
    import torch
    import yaml
    from dawn_tpu_torch.models.pbnet.cvae import ARCHINAMES, CVAE, PBnetParams
    from dawn_tpu_torch.pipeline.pose_blink import generate_drives_separate
    from dawn_tpu_torch.train.train_pbnet import PBnetTrainConfig, PBnetTrainer
    from dawn_tpu_torch.weights.checkpoints import save_pbnet_checkpoint

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    r = np.random.RandomState(SEED + 49)
    parts = []
    _reset_counts()
    for arch in ARCHINAMES:
        t = 96 if arch == "mlp" else 100
        hp = PBnetParams(archiname=arch, num_frames=t)
        torch.manual_seed(SEED + 50)
        cpu = CVAE(hp, device="cpu")
        gpu = CVAE(hp, device="cuda")
        gpu.load_state_dict(cpu.state_dict())
        init = torch.from_numpy((0.5 + 0.1 * r.randn(32, 6)).astype(np.float32))
        audio = torch.from_numpy(r.randn(32, t, 1024).astype(np.float32))
        z = torch.from_numpy(r.randn(*cpu._z_shape(32, t)).astype(np.float32))
        want = cpu.generate(init, audio, z=z)
        t0 = time.perf_counter()
        got = gpu.generate(init, audio, z=z)
        torch.cuda.synchronize()
        gen_ms = 1e3 * (time.perf_counter() - t0)
        err = (got.cpu() - want).abs().max().item() / max(want.abs().max().item(), 1e-6)
        check(tuple(got.shape) == (32, t, 6) and err <= 1e-4,
              f"pbnet {arch} generate error {err} shape {tuple(got.shape)}")
        trainer = PBnetTrainer(PBnetTrainConfig(kind="pose"), hp=hp, device="cuda")
        m = trainer.train_step({"x": (0.5 + 0.1 * r.randn(32, t, 6)).astype(np.float32),
                                "hubert": r.randn(32, t, 1024).astype(np.float32)})
        check(all(np.isfinite(v) for v in m.values()), f"pbnet {arch} step metrics {m}")
        parts.append(f"{arch} {err:.2e} ({gen_ms:.0f} ms, g_total {m['g_total']:.4f})")
        del cpu, gpu, trainer
    check(_counts() == (0,) * 7, f"pbnet archs launched kernels {_counts()}")
    print(f"pbnet archs [{card}]: CVAE.generate, 32 x 100 frames (mlp 96), opt defaults' "
          f"widths, card vs CPU, f32, TF32 off, max err of max|ref| (tol 1e-4), the card's "
          f"cold call, one PBnetTrainer step's g_total: " + "; ".join(parts), flush=True)

    root = tempfile.mkdtemp(prefix="dawn_pbnet_")
    ckpts = {}
    for kind, dim in (("pose", 6), ("blink", 2)):
        hp = PBnetParams(archiname="gru", pos_dim=dim)
        torch.manual_seed(SEED + 51)
        model = CVAE(hp, device="cpu")
        os.makedirs(os.path.join(root, kind))
        ckpts[kind] = os.path.join(root, kind, "checkpoint_1.pth.tar")
        save_pbnet_checkpoint(model, ckpts[kind])
        with open(os.path.join(root, kind, "opt.yaml"), "w") as f:
            yaml.safe_dump({"modeltype": "cvae", "archiname": "gru", "latent_dim": 256,
                            "ff_size": 128, "num_layers": 2, "num_heads": 4,
                            "audio_dim": 1024, "pos_dim": dim, "eye_dim": 0}, f)
    audio = r.randn(100, 1024).astype(np.float32)
    init_pose = np.array([[3.0, -2.0, 1.0, 4.79e-04, 56.5, 64.9]], np.float32)
    init_blink = np.array([[0.3, 0.28]], np.float32)
    drives = {dev: generate_drives_separate(ckpts["pose"], ckpts["blink"], audio, init_pose,
                                            init_blink, seed=7, device=dev)
              for dev in ("cpu", "cuda")}
    errs = [float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-6))
            for a, b in zip(drives["cuda"], drives["cpu"])]
    check(drives["cuda"][0].shape == (100, 6) and drives["cuda"][1].shape == (100, 2)
          and all(np.isfinite(d).all() for d in drives["cuda"]) and max(errs) <= 1e-4,
          f"gru drives errors {errs}")
    print(f"pbnet archs: generate_drives_separate with 'gru' pose and blink checkpoints "
          f"(release layout: checkpoint_1.pth.tar + opt.yaml), T=100, card vs CPU: pose "
          f"{drives['cuda'][0].shape} err {errs[0]:.2e}, blink {drives['cuda'][1].shape} err "
          f"{errs[1]:.2e} of max|ref| (tol 1e-4)", flush=True)
    shutil.rmtree(root)
    torch.cuda.empty_cache()


def mesh_counts(path):
    """(vertices, faces) written in a .ply or .obj file."""
    lines = open(path).read().splitlines()
    if path.endswith(".obj"):
        return (sum(ln.startswith("v ") for ln in lines),
                sum(ln.startswith("f ") for ln in lines))
    body = [ln.split() for ln in lines[lines.index("end_header") + 1:] if ln]
    return sum(len(f) == 3 for f in body), sum(len(f) == 4 and f[0] == "3" for f in body)


def face_viz(card, device="cuda"):
    """Phase: the face visualisations on the dense BFM mesh of a 1080p
    portrait (stage 1's nets on ``device``, everything after on the host),
    each timed and checked, then the host rasteriser against its numpy
    versions on a cut of the mesh by the JAX tests' rule: depth within
    1e-5 where both cover and at most 4 pixels covered by one only,
    colours off by more than 1e-4 on under 2 % of the covered pixels."""
    import tempfile
    import numpy as np
    from scipy.spatial import Delaunay
    from dawn_tpu_torch.pipeline import face_prep as fp
    from dawn_tpu_torch.pipeline import face_viz as fv
    from dawn_tpu_torch.pipeline import mesh_io
    from dawn_tpu_torch.runtime import native
    from dawn_tpu_torch.weights.checkpoints import load_face_assets

    root = tempfile.mkdtemp(prefix="dawn_viz_")
    assets = load_face_assets(write_face_assets(root, SEED + 95), device)
    img = portrait_1080p(np.random.RandomState(SEED + 96))
    h, w = img.shape[:2]
    boxes = fp.detect_faces(img, fp.run_net(assets.faceboxes))
    check(len(boxes) > 0, "face viz: no face box")
    params, rois = fp.regress_3dmm(img, boxes[:1], fp.run_net(assets.tddfa),
                                   param_mean=assets.param_mean, param_std=assets.param_std)
    ver = assets.bfm.recon_vers(params[0], rois[0], fp.CROP_SIZE, dense=True)
    lmk = assets.bfm.recon_vers(params[0], rois[0], fp.CROP_SIZE, dense=False)
    tri = Delaunay(ver[:2].T).simplices.astype(np.int32)
    check(ver.shape == (3, BFM_VERTICES) and lmk.shape == (3, 68) and np.isfinite(ver).all(),
          f"face viz: vertices {ver.shape}, landmarks {lmk.shape}")
    ms = {}

    def timed(name, fn):
        t0 = time.perf_counter()
        out = fn()
        ms[name] = 1e3 * (time.perf_counter() - t0)
        return out

    inside = (ver[0] >= 0) & (ver[0] < w) & (ver[1] >= 0) & (ver[1] < h)
    timed("render.cpp load (g++ at first use)", native.load_render)
    depth = timed("render_depth", lambda: fv.render_depth(ver, tri, h, w))
    check(np.isfinite(depth).all() and depth.min() >= 0 and depth.max() <= 1
          and (depth > 0).sum() > 1000, "face viz: depth not in [0, 1] or empty")
    overlay = timed("render_mesh_overlay", lambda: fv.render_mesh_overlay(img, ver, tri))
    ncc = fv.calc_ncc_code(assets.bfm.u.reshape(-1))
    pncc = timed("pncc", lambda: fv.pncc(img, [ver], tri, ncc))
    # a face's UV map unwraps it smoothly (BFM_UV.mat is not in the repository):
    # the vertices' normalised image positions, jittered by a seeded draw
    xy = (ver[:2] - ver[:2].min(1, keepdims=True)) / np.ptp(ver[:2], axis=1, keepdims=True)
    uv = np.clip(xy.T + 1e-3 * np.random.RandomState(SEED + 97).randn(ver.shape[1], 2), 0, 1)
    tex = timed("uv_tex", lambda: fv.uv_tex(img, [ver], tri, uv))
    pose_png = os.path.join(root, "pose.png")
    posed = timed("viz_pose", lambda: fv.viz_pose(img.copy(), params[:1], [lmk], wfp=pose_png))
    marked = timed("draw_landmarks", lambda: fv.draw_landmarks(img.copy(), lmk))
    for name, out in (("overlay", overlay), ("pncc", pncc), ("pose", posed),
                      ("landmarks", marked)):
        check(out.dtype == np.uint8 and out.shape == img.shape and (out != img).any(),
              f"face viz: {name} drew nothing")
    check(tex.shape == (256, 256, 3) and (tex > 0).mean() > 0.01 and os.path.getsize(pose_png),
          "face viz: uv texture empty or pose PNG missing")
    faces = [ver, ver + np.array([[60.0], [0.0], [0.0]])]
    rgb = img[..., ::-1]
    for merge in (False, True):
        for kind, writer, args in (("ply", mesh_io.ser_to_ply, (faces, tri, h)),
                                   ("obj", mesh_io.ser_to_obj, (rgb, faces, tri, h))):
            paths = timed(f"ser_to_{kind}{' merged' if merge else ''}", lambda: writer(
                *args, os.path.join(root, f"mesh_{merge}.{kind}"), merge=merge))
            counts = [mesh_counts(p) for p in paths]
            n_v, n_f = (sum(c[i] for c in counts) for i in (0, 1))
            check(len(paths) == (1 if merge else 2) and n_f == 2 * len(tri)
                  and n_v == 2 * ver.shape[1],
                  f"face viz: {kind} merge={merge}: {n_v} vertices, {n_f} faces")

    cut = tri[:3000]
    lib, plain = fv.render_depth(ver, cut, h, w), fv.render_depth_plain(ver, cut, h, w)
    both = (lib > 0) & (plain > 0)
    depth_err = float(np.abs(lib - plain)[both].max())
    depth_miss = int(((lib > 0) != (plain > 0)).sum())
    bg = img.astype(np.float32) / 255.0
    lib_c = fv.rasterize_colors(np.ascontiguousarray(ver.T), cut, ncc, bg)
    plain_c = fv.rasterize_colors_plain(np.ascontiguousarray(ver.T), cut, ncc, bg)
    covered = (lib_c != bg).any(-1) | (plain_c != bg).any(-1)
    colour_off = float((np.abs(lib_c - plain_c).max(-1) > 1e-4)[covered].mean())
    print(f"face viz [{card}]: 1080p portrait, stage 1's nets on {device}: {len(boxes)} boxes, "
          f"{ver.shape[1]} dense vertices ({int(inside.sum())} inside the frame), "
          f"{len(tri)} Delaunay triangles, 68 landmarks; host ms: "
          + ", ".join(f"{k} {v:.1f}" for k, v in ms.items())
          + f"; depth covers {int((depth > 0).sum())} px, uv texture "
          f"{100 * (tex > 0).mean():.1f} % non-zero", flush=True)
    print(f"face viz: render.cpp against its numpy versions on {len(cut)} triangles: depth "
          f"{int(both.sum())} px both, max err {depth_err:.2e} (tol 1e-5), {depth_miss} px "
          f"one only (tol 4); colours {int(covered.sum())} px covered, {100 * colour_off:.3f} % "
          f"off by > 1e-4 (tol 2 %)", flush=True)
    check(both.sum() > 100 and depth_err < 1e-5 and depth_miss <= 4 and colour_off < 0.02,
          "face viz: the rasteriser disagrees with its numpy versions")
    shutil.rmtree(root)


def golden(card):
    """Phase: the port's frozen f32 sampler on the card, TF32 off, against
    the fixtures ``dawn_tpu_torch/scripts/make_golden.py`` wrote on the CPU
    (pixels and flow grids within 5e-4, as the golden tests); returns its
    (K1, ..., K6, K1p) launches."""
    import numpy as np
    import torch
    from dawn_tpu_torch.scripts import make_golden as mg

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    total = (0,) * 7
    for size, (_, t, steps, _) in mg.CASES.items():
        model = mg.golden_model(size, "cuda")
        _reset_counts()
        got = mg.strided(size, model.sample_one_video(**mg.golden_inputs(size)))
        launches = _counts()
        want = np.load(os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests",
                                    "golden", f"torch_golden_{size}.npz"))
        errs = {k: float(np.abs(got[k] - want[k]).max()) for k in ("pixels", "grid")}
        rel = abs(float(got["checksum"]) - float(want["checksum"])) / float(want["checksum"])
        print(f"golden: {size}^2 x {t} frames x {steps} steps, f32, card (TF32 off) against "
              f"tests/golden/torch_golden_{size}.npz (CPU): max err pixels "
              f"{errs['pixels']:.3e}, grid {errs['grid']:.3e} (tol 5e-4); checksum rel diff "
              f"{rel:.2e}; K1 x {launches[0]}", flush=True)
        check(max(errs.values()) <= 5e-4, f"golden {size}: {errs}")
        check(launches == (10 * steps, 0, 0, 0, 0, 0, 0), f"golden {size} launches {launches}")
        total = tuple(a + b for a, b in zip(total, launches))
        del model
    torch.cuda.empty_cache()
    return total


def probe_scripts(card):
    """Phase: every probe script's main() at full width on the card, each
    run's kernel launches counted; returns {script: (K1, ..., K6, K1p)}."""
    import tempfile
    import torch
    from dawn_tpu_torch.scripts import (probe_micro, probe_packed_compile, probe_train_phases,
                                        probe_unet_phases, profile_sample, smoke_e2e)

    torch.backends.cudnn.allow_tf32 = True      # PyTorch's default for convs
    out = os.path.join(tempfile.mkdtemp(prefix="dawn_smoke_"), "frames")
    runs = [
        (smoke_e2e, ["--img-size", "128", "--frames", "200", "--steps", "20", "--attn",
                     "local", "--out", out], (400, 0)),
        # ddim and the whole call: cold, 2 timed; the count: 1 and 2 steps
        (profile_sample, ["--img-size", "128", "--frames", "200", "--repeats", "2"],
         (6 * 200 + 30, 0)),
        # (1 + repeats) calls of the UNet (10 K1) and of 4 level attentions
        (probe_unet_phases, ["--img-size", "128", "--frames", "200", "--modules", "--extras",
                             "--repeats", "2"], (3 * 14, 0)),
        (probe_micro, ["--img-size", "128", "--frames", "200", "--repeats", "2"], (3, 0)),
        # full step, B and C: 3 calls each of 10 K1; full step and C: 10 K2
        (probe_train_phases, ["--batch", "4", "--frames", "20", "--dtype", "bf16",
                              "--modules", "--repeats", "2"], (90, 60)),
        # 4 calls of each launch row, 4 x 4 chunked
        (probe_packed_compile, ["--repeats", "3"], (28, 0)),
    ]
    launches = {}
    for module, argv, (k1, k2) in runs:
        name = module.__name__.rsplit(".", 1)[1]
        _reset_counts()
        t0 = time.perf_counter()
        res = module.main(argv)
        secs = time.perf_counter() - t0
        launches[name] = _counts()
        print(f"scripts [{card}]: {name} {' '.join(argv)}: {secs:.1f} s, launches (K1-K6, K1p) "
              f"{launches[name]}", flush=True)
        check(launches[name] == (k1, k2, 0, 0, 0, 0, 0),
              f"{name} launches {launches[name]} != {k1} K1, {k2} K2")
        if module is smoke_e2e:
            check(res["k1_launches"] == (200, 200), f"smoke_e2e K1 per call {res['k1_launches']}")
            print(f"scripts: smoke_e2e 128^2 T=200 f32: cold call {res['first_s']:.2f} s, warm "
                  f"{res['second_s']:.3f} s, 200 K1 each", flush=True)
        elif module is profile_sample:
            print(f"scripts: profile_sample split: DDIM {res['ddim_ms']:.1f} ms + decode "
                  f"{res['decode_ms']:.1f} ms = {res['ddim_ms'] + res['decode_ms']:.1f} ms "
                  f"against the whole warm call {res['whole_ms']:.1f} ms", flush=True)
        elif module is probe_train_phases:
            print("scripts: probe_train_phases split (ms): " + ", ".join(
                f"{k.strip()} {v:.1f}" for k, v in res.items()), flush=True)
    shutil.rmtree(os.path.dirname(out))
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
    from dawn_tpu_torch.utils.profiling import card_peaks

    kind = torch.cuda.get_device_name(0)
    peak_name, rates = card_peaks(kind)
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
    # the forward body in both layouts and its three ways of forming P (bf16
    # K1 and K5 packed with one walk, K3 split with two, K1p packed with two)
    # and both layouts' passes (K4 split; K2 and K6 packed), each for 4-warp
    # and 2-warp blocks
    for entry, built in (("attn_fwd_mma_kernel", 6), ("bwd_query_mma_kernel", 4),
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
    k1p = phase(kernel_k1p, smi, rates)
    phase(parity)
    sample = phase(video_path, smi, 200, timed=True)
    interpolate = phase(ancestral_parity)
    ancestral = phase(ancestral_path, smi)
    phase(fuse_cond, smi)
    phase(pipeline_parity)
    phase(face_prep_parity, smi)
    pipeline = phase(pipeline_path, smi)
    phase(eval_parity, smi)
    ood, released = phase(eval_path, smi)
    k2 = phase(kernel_k2, smi, rates)
    phase(train_parity)
    train = phase(train_path, smi)
    extras = phase(dm_trainer_extras, smi)
    phase(lfg_train_parity)
    lfg_train = phase(lfg_train_path, smi)
    phase(pbnet_train_parity)
    pbnet_train = phase(pbnet_train_path, smi)
    clis = phase(trainer_clis, smi)
    phase(lfg_variants, smi)
    phase(pbnet_archs, smi)
    phase(face_viz, smi)
    gold = phase(golden, smi)
    scripts = phase(probe_scripts, smi)
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
    pbnet_sharded = phase(pbnet_sharded_losses, smi, mesh)
    cached_nccl = phase(cached_cli_nccl, smi)
    bench = phase(bench_attention, smi)
    dist.destroy_process_group()
    shutil.rmtree(store)
    paths = {"pipeline": pipeline, "sample": sample, "ancestral": ancestral,
             "interpolate": interpolate, "train": train, "seq_sample": seq_sample,
             "seq_train": seq_train,
             "sample_T400": phase(video_path, smi, 400, timed=True),
             "sample_T800": phase(video_path, smi, 800, decode_chunk=32),
             "sample_256_T400": phase(video_path, smi, 400, img_size=256, decode_chunk=16),
             "temporal_attention_grad_T400": grad_t400, "bench_attention": bench,
             "lfg_train": lfg_train, "pbnet_train": pbnet_train, "trainer_clis": clis,
             "pbnet_sharded": pbnet_sharded, "train_cached_nccl": cached_nccl,
             "ood_test": ood, "eval_quality_released": released, **extras,
             "golden": gold, **scripts}
    # (name, source, replaced TPU kernel, measurements, the path whose count is `launches`)
    rows = [("K1 local_attention_packed", "local_attention.cu", 299, k1, "pipeline"),
            ("K2 local_attention_packed_bwd", "local_attention_tiled_bwd.cu", 743, k2,
             "train"),
            ("K3 local_attention_tiled", "local_attention.cu", 116, k3, "sample_T400"),
            ("K4 local_attention_tiled_bwd", "local_attention_tiled_bwd.cu", 876, k4,
             "temporal_attention_grad_T400"),
            ("K5 local_attention_packed_stripe", "local_attention.cu", 446, k5, "seq_sample"),
            ("K6 local_attention_packed_stripe_bwd", "local_attention_tiled_bwd.cu", 516, k6,
             "seq_train"),
            ("K1p local_attention_packed_prob", "local_attention.cu", 334, k1p,
             "bench_attention")]
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
