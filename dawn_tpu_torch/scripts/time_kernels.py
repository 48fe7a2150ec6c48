"""Time the hand-written kernels K1-K6 in bf16 on one card, at the shapes
``chip_smoke.py`` times them, with CUDA events (20 launches after 2 warm-up
ones, the mean per call).

    python dawn_tpu_torch/scripts/time_kernels.py [--root DIR] [--label NAME]

Run it as a file, not with ``-m``: ``--root`` names the checkout whose
``dawn_tpu_torch`` is imported (default: the one holding this script), so
one command can time two checkouts in turns on the same card (parent,
change, change, parent). It uses only the kernels' wrappers, which keep
their signatures from one checkout to the next. Prints the card's name and
power limit, then one line per kernel.
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys

# (name, shape): K1 at the sampling and stage-1 top levels, K2 at stage 1,
# K3 at the 128^2 top level of a 400- and an 800-frame video, K4 at the
# first, K5 at rank 0 of the 2-rank sampling split, K6 at rank 0 of the
# 2-rank stage-2 split
CASES = [("K1", dict(n=1024, t=200, w=40)), ("K1", dict(n=4096, t=20, w=20)),
         ("K2", dict(n=4096, t=20, w=20)), ("K3", dict(n=1024, t=400, w=40)),
         ("K3", dict(n=1024, t=800, w=40)), ("K4", dict(n=1024, t=400, w=40)),
         ("K5", dict(n=1024, t=100, w=40)), ("K6", dict(n=1024, t=20, w=20))]


def time_ms(fn, iters=20):
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


def call_for(la, name, n, t, w, gen):
    """A no-argument call of kernel ``name`` on seeded bf16 inputs (8 heads
    x 32; K5/K6: t query rows over t + 2w haloed keys, left edge)."""
    import torch
    bf16 = torch.bfloat16

    def rnd(*shape):
        return torch.randn(*shape, device="cuda", generator=gen).to(bf16)

    vec = torch.randn(8, 2 * w + 1, device="cuda", generator=gen)
    if name in ("K1", "K2"):
        q, k, v, g = (rnd(n, t, 256) for _ in range(4))
        if name == "K1":
            return lambda: la.local_attention_packed(q, k, v, vec, w, 8)
        return lambda: la.local_attention_packed_bwd(q, k, v, g, vec, w, 8)
    if name in ("K3", "K4"):
        q, k, v, g = (rnd(n, 8, t, 32) for _ in range(4))
        if name == "K3":
            return lambda: la.local_attention_tiled(q, k, v, vec, w)
        return lambda: la.local_attention_tiled_bwd(q, k, v, g, vec, w)
    q, g = rnd(n, t, 256), rnd(n, t, 256)
    kx, vx = rnd(n, t + 2 * w, 256), rnd(n, t + 2 * w, 256)
    if name == "K5":
        return lambda: la.local_attention_packed_stripe(q, kx, vx, vec, w, 8, True, False)
    return lambda: la.local_attention_packed_stripe_bwd(q, kx, vx, g, vec, w, 8, True, False)


def main(argv=None) -> int:
    here = os.path.dirname(os.path.abspath(__file__))
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=os.path.dirname(os.path.dirname(here)))
    ap.add_argument("--label", default="")
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("time_kernels: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.abspath(args.root))
    from dawn_tpu_torch.ops import local_attention as la

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(f"time_kernels [{smi}] {args.label or args.root}: {la.__file__}", flush=True)
    gen = torch.Generator(device="cuda").manual_seed(0)
    for name, shape in CASES:
        ms = time_ms(call_for(la, name, gen=gen, **shape))
        print(f"time_kernels {args.label}: {name} bf16 N={shape['n']} T={shape['t']} "
              f"w={shape['w']}: {ms:.4f} ms", flush=True)
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
