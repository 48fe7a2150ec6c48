"""Write the port's golden-output fixtures: its own frozen sampler.

    python -m dawn_tpu_torch.scripts.make_golden [--sizes 128 256] [--out tests/golden]

The port's counterpart of ``scripts/make_golden.py``: perf work must not
silently change what ``sample_one_video`` computes. This freezes the port's
sampler at the released topology (UNet dim 64, mults (1, 2, 4, 8), channels
275; LFG block_expansion 64 / max_features 512 / 6 bottleneck blocks; win
40, 'local' attention, f32 everywhere) at the JAX script's cases (``CASES``,
a copy of ``scripts/make_golden.py:34``: image size, frames, DDIM steps and
the stride of the stored pixels). The weights are torch's initialisation
drawn from a torch generator seeded with ``WEIGHT_SEED``; the inputs and the
``noise_seq`` come from ``numpy.random.RandomState(INPUT_SEED)``. The run is
on the CPU with ``THREADS`` torch threads. Each ``torch_golden_<size>.npz``
holds strided pixels, strided flow grids and the video's float64 checksum in
the JAX fixture's layout.

``tests/test_torch_golden_port.py`` reruns :func:`generate` on the CPU and
asserts the same bits; ``chip_smoke.py`` runs the same sampler in f32 on the
card (TF32 off) against them at 5e-4. After an intentional change of the
sampler's numbers, regenerate with this script in the test environment
and commit the new fixtures with the change that explains them.
"""

from __future__ import annotations

import argparse
import os
from typing import Dict

import numpy as np
import torch

from dawn_tpu_torch.models.dm.flow_diffusion import FlowDiffusion, FlowDiffusionConfig

GOLDEN_DIR = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))), "tests", "golden")
# (img_size, frames, ddim steps, spatial stride of the committed pixels)
CASES = {128: (128, 8, 4, 16), 256: (256, 8, 2, 32)}
WEIGHT_SEED, INPUT_SEED = 7, 42
THREADS = 4


def golden_model(size: int, device="cpu") -> FlowDiffusion:
    """The fixture's f32 model at ``size`` on ``device``: torch's
    initialisation drawn from ``WEIGHT_SEED`` (``FlowDiffusion`` builds its
    modules on the CPU, then moves them). The caller's random state is left
    as it was."""
    s, _, steps, _ = CASES[size]
    cfg = FlowDiffusionConfig(img_size=s, sampling_timesteps=steps, win_width=40,
                              attn_mode="local", lfg_decode_chunk=0, dtype=torch.float32,
                              lfg_dtype=torch.float32)
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(WEIGHT_SEED)
        return FlowDiffusion(cfg, device=device)


def golden_inputs(size: int) -> Dict[str, torch.Tensor]:
    """The fixture's inputs and ``noise_seq`` (CPU float32 tensors)."""
    s, t, steps, _ = CASES[size]
    b, ls = 1, s // 4
    rng = np.random.RandomState(INPUT_SEED)
    arrays = dict(sample_img=rng.rand(b, s, s, 3), audio_hubert=rng.randn(b, t, 1024) * 0.5,
                  pose=rng.randn(b, t, 6) * 0.1, eye=rng.rand(b, t, 2),
                  bbox=np.asarray([[s * .25, s * .75, s * .25, s * .75, s, s]]),
                  noise_seq=rng.randn(steps + 1, b, t, ls, ls, 3))
    return {k: torch.as_tensor(v, dtype=torch.float32) for k, v in arrays.items()}


def strided(size: int, out: Dict[str, torch.Tensor]) -> Dict[str, np.ndarray]:
    """The fixture's entries from a ``sample_one_video`` output."""
    stride = CASES[size][3]
    vid = out["sample_out_vid"].cpu().numpy()              # (1, t, s, s, 3)
    grid = out["sample_vid_grid"].cpu().numpy()            # (1, t, ls, ls, 2)
    g = max(1, stride // 4)
    return {"pixels": vid[:, :, ::stride, ::stride, :].astype(np.float32),
            "grid": grid[:, :, ::g, ::g, :].astype(np.float32),
            "checksum": np.float64(vid.astype(np.float64).sum())}


def generate(size: int) -> Dict[str, np.ndarray]:
    """The fixture at ``size``, computed on the CPU with ``THREADS`` torch
    threads (the thread count is restored afterwards)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(THREADS)
    try:
        model = golden_model(size)
        out = model.sample_one_video(**golden_inputs(size))
    finally:
        torch.set_num_threads(threads)
    return strided(size, out)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--sizes", type=int, nargs="+", default=list(CASES), choices=list(CASES))
    ap.add_argument("--out", default=GOLDEN_DIR)
    args = ap.parse_args(argv)
    os.makedirs(args.out, exist_ok=True)
    for size in args.sizes:
        data = generate(size)
        path = os.path.join(args.out, f"torch_golden_{size}.npz")
        np.savez_compressed(path, **data)
        print(f"{path}: pixels {data['pixels'].shape} checksum {float(data['checksum']):.6f}")


if __name__ == "__main__":
    main()
