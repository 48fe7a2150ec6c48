"""What a new K1 shape costs cold: the port's counterpart of
``scripts/probe_packed_compile.py``.

    python -m dawn_tpu_torch.scripts.probe_packed_compile [--t 200] [--big 1024] \\
        [--chunk 256] [--h 8] [--d 32] [--window 40] [--dtype bf16|f32] [--device cpu]

The JAX script asks whether one canonical shape of the packed Pallas kernel
cuts the sampler's cold compile: on the TPU each distinct shape (n = 1024 and
n = 256 sequences at 128^2) pays its own Mosaic compile. On the card a
kernel is compiled once per source, not per shape, so the same question has
three answers here:

1. ``nvcc``: the build of ``csrc/local_attention.cu`` (K1 and its kin) with
   the port's flags, into a temporary directory (the package's ``_build/``
   is not touched): the one-time cost of every shape;
2. the first and the warm launch of K1 at n = ``--big`` and at n =
   ``--chunk`` (the first launch in a process also loads the library and
   sets each kernel's shared-memory limit);
3. K1 at n = ``--big`` as ``--big / --chunk`` launches of ``--chunk``
   sequences against one launch (the cost of the canonical-shape rewrite).

Times are CUDA events on the current stream (host clock on the CPU, where
the wrapper runs K1's plain version and nothing is built). ``main`` returns
the times.
"""

from __future__ import annotations

import argparse
import os
import shutil
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

from dawn_tpu_torch import build, resolve_device
from dawn_tpu_torch.ops.local_attention import local_attention_packed
from dawn_tpu_torch.ops.t5bias import t5_bias_windowed_vector
from dawn_tpu_torch.utils.profiling import time_ms


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--t", type=int, default=200)
    ap.add_argument("--big", type=int, default=1024)
    ap.add_argument("--chunk", type=int, default=256)
    ap.add_argument("--h", type=int, default=8)
    ap.add_argument("--d", type=int, default=32)
    ap.add_argument("--window", type=int, default=40)
    ap.add_argument("--dtype", default="bf16", choices=["f32", "bf16"])
    ap.add_argument("--repeats", type=int, default=5)
    ap.add_argument("--device", default=None, help="torch device (default: the card)")
    return ap.parse_args(argv)


def nvcc_seconds(name: str = "local_attention"):
    """Seconds of one ``nvcc`` build of ``csrc/<name>.cu`` with the port's
    flags into a temporary directory, or None without nvcc."""
    try:
        nvcc = build._nvcc()
    except RuntimeError:
        return None
    tmp = tempfile.mkdtemp(prefix="dawn_nvcc_")
    try:
        t0 = time.perf_counter()
        subprocess.run([nvcc, *build.NVCC_FLAGS, "-o", os.path.join(tmp, f"{name}.so"),
                        os.path.join(build.CSRC_DIR, f"{name}.cu")],
                       check=True, capture_output=True, text=True)
        return time.perf_counter() - t0
    finally:
        shutil.rmtree(tmp)


def main(argv=None):
    args = parse_args(argv)
    device = resolve_device(args.device)
    if args.big % args.chunk:
        raise ValueError(f"--big {args.big} is not a multiple of --chunk {args.chunk}")
    dt = torch.bfloat16 if args.dtype == "bf16" else torch.float32
    name = torch.cuda.get_device_name(device) if device.type == "cuda" else "CPU"
    print(f"device={device} ({name}) t={args.t} h={args.h} d={args.d} w={args.window} "
          f"dtype={args.dtype}", file=sys.stderr)
    res = {}

    secs = nvcc_seconds() if device.type == "cuda" else None
    res["nvcc_s"] = secs
    print(f"nvcc csrc/local_attention.cu (every K1 shape): "
          + (f"{secs:.1f}s" if secs is not None else "not measured (no card)"))

    rng = np.random.RandomState(0)
    t, h, hd = args.t, args.h, args.h * args.d
    vec = t5_bias_windowed_vector(torch.as_tensor(rng.randn(32, h), dtype=torch.float32,
                                                  device=device), args.window, 32, 32)

    def mk(n):
        return torch.as_tensor(rng.randn(n, t, hd), dtype=dt, device=device)

    xb, xs = mk(args.big), mk(args.chunk)

    def attn(x):
        return local_attention_packed(x, x, x, vec, args.window, h)

    for label, x in (("C2: packed(big)", xb), ("C1: packed(chunk)", xs)):
        first, best, _ = time_ms(lambda: attn(x), device, args.repeats)
        res[label] = (first, best)
        print(f"{label + f' n={x.shape[0]}':34s} first launch {first:8.2f} ms   "
              f"warm {best:8.3f} ms")

    chunks = xb.split(args.chunk)
    _, one, _ = time_ms(lambda: attn(xb), device, args.repeats)
    _, split, _ = time_ms(lambda: torch.cat([attn(c) for c in chunks]), device, args.repeats)
    res.update(one_ms=one, chunked_ms=split)
    print(f"n={args.big} t={t} one launch {one:8.3f} ms   {len(chunks)} x {args.chunk} "
          f"{split:8.3f} ms   overhead {100 * (split / one - 1):+.1f}%")
    return res


if __name__ == "__main__":
    main()
