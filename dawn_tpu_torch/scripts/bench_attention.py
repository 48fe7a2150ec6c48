"""Micro-benchmark of the windowed temporal attention kernels: the port's
counterpart of ``scripts/bench_attention.py``.

    python -m dawn_tpu_torch.scripts.bench_attention [--t 200] [--n 1024] [--dtype bf16] \\
        [--prob-dtype bf16] [--stripe 2] [--seq-composed] [--device cpu]

The defaults are the DAWN UNet's temporal attention at the top level of the
128^2 model (the 32x32 latent folded into the batch: n = 1024 sequences, 8
heads x 32, T = 200 frames, window 40), the inputs the JAX script draws
(``numpy.random.RandomState(0)``). The same lines and MSEs as the JAX script:

- ``banded``: the plain banded form (:func:`local_attention_banded`);
- ``pallas``: K3 (:func:`local_attention_tiled`), with its MSE against banded;
- ``packed``: K1 (:func:`local_attention_packed`), T <= 256;
- ``packed bf16-prob-tiles`` (``--prob-dtype bf16``): K1p, K1 with the
  exponent's argument rounded to bf16, with its MSE against K1;
- ``stripe`` (``--stripe SHARDS``): K5 on the stripe of one rank of a
  SHARDS-way split (t/SHARDS queries over t/SHARDS + 2w keys, no edge
  masked), its plain version and their MSE, then the fused forward and
  backward (K5 + K6) of the gradient with respect to q;
- ``seq-composed``: :func:`seq_sharded_local_attention` with the stripe
  forced on a one-rank process group (NCCL on the card, gloo on the CPU):
  the halo exchange of an edge rank and K5, with its MSE against K1, then
  forward and backward (K6);
- ``full``: the windowed-full plain attention (T5 bias matrix plus window
  mask), with its MSE against K3 (or K1 with ``--skip-pallas``).

Each time is the mean of ``ITERS`` calls after two warm-up calls, with CUDA
events on the card (the JAX script amortises over a ``lax.scan`` of 10
calls instead); on the CPU (``--device cpu``) the host clock times the plain
versions that the kernels' wrappers take there. ``--block-q`` and
``--g-rows`` of the JAX script size the Pallas grid and have no counterpart.
``main`` returns the times and MSEs as a dict.
"""

from __future__ import annotations

import argparse
import contextlib
import os
import shutil
import sys
import tempfile
import time

import numpy as np
import torch
import torch.distributed as dist

from dawn_tpu_torch import resolve_device
from dawn_tpu_torch.ops import local_attention as la
from dawn_tpu_torch.ops.t5bias import t5_bias_matrix, t5_bias_windowed_vector, window_mask

ITERS = 10


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--n", type=int, default=1024)
    ap.add_argument("--h", type=int, default=8)
    ap.add_argument("--t", type=int, default=200)
    ap.add_argument("--d", type=int, default=32)
    ap.add_argument("--window", type=int, default=40)
    ap.add_argument("--dtype", default="bf16", choices=["f32", "bf16"])
    ap.add_argument("--prob-dtype", default=None, choices=["bf16"],
                    help="also time K1p, the packed kernel with the exponent's argument "
                         "rounded to this dtype, with its MSE against K1")
    ap.add_argument("--stripe", type=int, default=0, metavar="SHARDS",
                    help="also time K5 (and K6 in the fused backward) at the stripe of one "
                         "rank of a SHARDS-way split of the frames")
    ap.add_argument("--seq-composed", action="store_true",
                    help="also run seq_sharded_local_attention with the stripe forced on a "
                         "one-rank process group, forward and backward")
    ap.add_argument("--skip-full", action="store_true")
    ap.add_argument("--skip-banded", action="store_true")
    ap.add_argument("--skip-pallas", action="store_true")
    ap.add_argument("--device", default=None,
                    help="default: the card; 'cpu' for the plain versions on the CPU")
    return ap.parse_args(argv)


def timeit(fn, device, iters: int = ITERS):
    """(ms per call, the last call's output): CUDA events on the card, the
    host clock on the CPU, after two warm-up calls."""
    for _ in range(2):
        out = fn()
    if device.type == "cuda":
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        torch.cuda.synchronize(device)
        start.record()
        for _ in range(iters):
            out = fn()
        end.record()
        torch.cuda.synchronize(device)
        return start.elapsed_time(end) / iters, out
    t0 = time.perf_counter()
    for _ in range(iters):
        out = fn()
    return (time.perf_counter() - t0) * 1e3 / iters, out


def mse(a: torch.Tensor, b: torch.Tensor) -> float:
    return float(((a.float() - b.float()) ** 2).mean())


@contextlib.contextmanager
def one_rank_mesh(device):
    """A mesh of one rank on a process group: the one already open (of
    world size 1), else a one-rank group through a file store (NCCL on the
    card, gloo on the CPU), closed on exit."""
    from dawn_tpu_torch.parallel.mesh import make_mesh
    if dist.is_initialized():
        if dist.get_world_size() != 1:
            raise ValueError(f"--seq-composed runs on one rank, the open process group has "
                             f"{dist.get_world_size()}")
        yield make_mesh()
        return
    store = tempfile.mkdtemp(prefix="dawn_bench_attention_")
    if device.type == "cuda":
        torch.cuda.set_device(device)
    dist.init_process_group("nccl" if device.type == "cuda" else "gloo",
                            init_method=f"file://{os.path.join(store, 'store')}",
                            world_size=1, rank=0)
    try:
        yield make_mesh()
    finally:
        dist.destroy_process_group()
        shutil.rmtree(store, ignore_errors=True)


def main(argv=None) -> dict:
    args = parse_args(argv)
    device = resolve_device(args.device)
    n, h, t, d, w = args.n, args.h, args.t, args.d, args.window
    dt = torch.bfloat16 if args.dtype == "bf16" else torch.float32
    where = torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"
    print(f"device={where} n={n} h={h} t={t} d={d} w={w} dtype={args.dtype}", file=sys.stderr)
    res = {}

    rng = np.random.RandomState(0)

    def draw():
        return torch.from_numpy(rng.randn(n, h, t, d).astype(np.float32)).to(device, dt)

    q = draw() * (d ** -0.5)
    k, v = draw(), draw()
    emb = torch.from_numpy(rng.randn(32, h).astype(np.float32)).to(device)
    vec = t5_bias_windowed_vector(emb, w, 32, 32)

    def pack(x):                    # (n, h, t, d) -> (n, t, h*d)
        return x.transpose(1, 2).reshape(n, t, h * d).contiguous()

    tb = ob = op = None
    if not args.skip_banded:
        tb, ob = timeit(lambda: la.local_attention_banded(q, k, v, vec, w), device)
        res["banded_ms"] = tb
        print(f"banded : {tb:8.2f} ms/op")
    if not args.skip_pallas:
        tp, op = timeit(lambda: la.local_attention_tiled(q, k, v, vec, w), device)
        res["pallas_ms"] = tp
        vs = f"   speedup vs banded: {tb / tp:.2f}x" if tb else ""
        print(f"pallas : {tp:8.2f} ms/op{vs}")
        if ob is not None:
            res["pallas_vs_banded_mse"] = mse(op, ob)
            print(f"pallas-vs-banded MSE: {res['pallas_vs_banded_mse']:.3e}")

    qp, kp, vp = pack(q), pack(k), pack(v)
    if t <= la.PACKED_MAX_T:
        tpk, opk = timeit(lambda: la.local_attention_packed(qp, kp, vp, vec, w, h), device)
        res["packed_ms"] = tpk
        vs = f"   speedup vs banded: {tb / tpk:.2f}x" if tb else ""
        print(f"packed : {tpk:8.2f} ms/op{vs}")
        if args.prob_dtype == "bf16":
            tpb, opb = timeit(lambda: la.local_attention_packed(
                qp, kp, vp, vec, w, h, prob_dtype=torch.bfloat16), device)
            res["prob_ms"], res["prob_vs_packed_mse"] = tpb, mse(opb, opk)
            print(f"packed bf16-prob-tiles: {tpb:8.2f} ms/op   "
                  f"MSE vs f32 tiles: {res['prob_vs_packed_mse']:.3e}")
        if op is None:
            op = opk.reshape(n, t, h, d).transpose(1, 2)

    if args.stripe:
        sh = args.stripe
        t_loc = t // sh
        if t_loc < w:
            raise ValueError(f"--stripe {sh}: a stripe of {t_loc} frames cannot cover the "
                             f"window {w}")
        t_k = t_loc + 2 * w
        qs, ks, vs2 = (x[:, :rows].contiguous() for x, rows in ((qp, t_loc), (kp, t_k),
                                                                (vp, t_k)))
        bias = la.stripe_bias(h, t_loc, w, vec)
        tsp, osp = timeit(lambda: la.local_attention_packed_stripe(
            qs, ks, vs2, vec, w, h, False, False), device)
        tse, ose = timeit(lambda: la.local_attention_packed_stripe_plain(qs, ks, vs2, bias, h),
                          device)
        res.update(stripe_ms=tsp, stripe_plain_ms=tse, stripe_mse=mse(osp, ose))
        print(f"stripe pallas ({sh}-shard, t_q={t_loc}, t_k={t_k}): {tsp:8.2f} ms/op")
        print(f"stripe einsum:                        {tse:8.2f} ms/op")
        print(f"stripe pallas-vs-einsum MSE: {res['stripe_mse']:.3e}")

        def stripe_grad():
            qg = qs.detach().requires_grad_(True)
            out = la.local_attention_packed_stripe(qg, ks, vs2, vec, w, h, False, False)
            return torch.autograd.grad(out.float().square().sum(), qg)[0]

        res["stripe_fwd_bwd_ms"], _ = timeit(stripe_grad, device)
        print(f"stripe fused fwd+bwd (grad q):        {res['stripe_fwd_bwd_ms']:8.2f} ms/op")

    if args.seq_composed:
        with one_rank_mesh(device) as mesh1:
            def composed(qq):
                return la.seq_sharded_local_attention(qq, kp, vp, vec, w, h, mesh1,
                                                      force_stripe=True)

            tc, oc = timeit(lambda: composed(qp), device)
            tpk2, opk2 = timeit(lambda: la.local_attention_packed(qp, kp, vp, vec, w, h),
                                device)
            res.update(composed_ms=tc, composed_packed_ms=tpk2, composed_mse=mse(oc, opk2))
            print(f"seq-composed fwd (halo+stripe, 1 shard): {tc:8.2f} ms/op")
            print(f"packed whole-T reference:             {tpk2:8.2f} ms/op")
            print(f"composed-vs-packed MSE: {res['composed_mse']:.3e}")

            def composed_grad():
                qg = qp.detach().requires_grad_(True)
                return torch.autograd.grad(composed(qg).float().square().sum(), qg)[0]

            res["composed_fwd_bwd_ms"], _ = timeit(composed_grad, device)
            print(f"seq-composed fused fwd+bwd (grad q):  "
                  f"{res['composed_fwd_bwd_ms']:8.2f} ms/op")

    if not args.skip_full and t <= 512:
        bias_full = t5_bias_matrix(emb, t, 32, 32) + window_mask(t, w).to(device)
        tf_, of = timeit(lambda: la.windowed_full_attention(q, k, v, bias_full), device)
        res["full_ms"] = tf_
        print(f"full   : {tf_:8.2f} ms/op")
        if op is not None:
            res["pallas_vs_full_mse"] = mse(of, op)
            print(f"pallas-vs-full MSE: {res['pallas_vs_full_mse']:.3e}")
        else:
            print("pallas-vs-full MSE: skipped (no pallas/packed output at this shape)")
    return res


if __name__ == "__main__":
    main()
