"""Standalone PBnet pose/blink drive generation, separate and joint.

Port of ``dawn_tpu/pipeline/pose_blink.py`` (the reference's
tvae_eval_single_both_eye_pose.py:43-152): load a PBnet checkpoint with its
sibling opt.yaml, normalize the init state with the 8-d min/max constants,
generate with a fixed seed, add the init state back, de-normalize, and write
dri_pose.npy (T, 6) and dri_blink.npy (T, 2).

Two checkpoint layouts:
- joint ('both'): one reemb5 CVAE over the 8-d [pose(6), blink(2)] vector;
- separate: two CVAEs (pose 6-d, blink 2-d), the unified generator's layout.

The latents come from a CPU ``torch.Generator`` seeded with ``seed`` (pose's
draw first, then blink's), so a seed gives the same drives on any device;
``z=`` / ``z_pose=`` / ``z_blink=`` replace the draws.
"""

from __future__ import annotations

import functools
import os
from typing import Optional, Tuple

import numpy as np
import torch

# 8-d joint normalization constants (tvae_eval_single_both_eye_pose.py:20-23)
MAX_VALS_8 = np.array([90, 90, 90, 1, 720, 1080, 1, 1], np.float32)
MIN_VALS_8 = np.array([-90, -90, -90, 0, 0, 0, 0, 0], np.float32)
# 3DDFA-failure fallbacks (:73-77)
DEFAULT_POSE_6 = np.array([[0, 0, 0, 4.79e-04, 5.65e+01, 6.49e+01]], np.float32)
DEFAULT_BLINK_2 = np.array([[0.3, 0.3]], np.float32)


def inv_transform(x: np.ndarray, min_vals: np.ndarray, max_vals: np.ndarray):
    """Normalized units -> physical units."""
    return x * (max_vals - min_vals) + min_vals


def _load_init(init_dir: str) -> Tuple[np.ndarray, np.ndarray]:
    try:
        pose = np.load(os.path.join(init_dir, "init_pose.npy"))[:, :6]
        blink = np.load(os.path.join(init_dir, "init_eye_bbox.npy"))[:, :2]
        return pose.astype(np.float32), blink.astype(np.float32)
    except Exception:
        return DEFAULT_POSE_6, DEFAULT_BLINK_2


def read_opt(ckpt_path: str) -> dict:
    """The opt.yaml beside a PBnet checkpoint, read with PyYAML's safe loader
    plus Python tuples (which a dumped argparse namespace may hold): a tag
    that would build any other Python object raises, so a downloaded file
    cannot run code."""
    import yaml

    class OptLoader(yaml.SafeLoader):
        pass

    OptLoader.add_constructor("tag:yaml.org,2002:python/tuple",
                              lambda loader, node: tuple(loader.construct_sequence(node)))
    with open(os.path.join(os.path.dirname(ckpt_path), "opt.yaml"), "rb") as f:
        return dict(yaml.load(f, Loader=OptLoader))


def build_for(opt: dict, pos_dim: int, eye_dim: int, device=None):
    """A CVAE from an opt dict with the reference's dim overrides (the
    unified generator's :79-92)."""
    from dawn_tpu_torch.models.pbnet import build_pbnet
    opt = dict(opt, audio_dim=1024, pos_dim=pos_dim, eye_dim=eye_dim)
    return build_pbnet(opt, device=device)


@functools.lru_cache(maxsize=4)
def load_pbnet_with_opt(ckpt_path: str, pos_dim: int, eye_dim: int, device=None):
    """A CVAE with its checkpoint's weights. lru-cached: batch callers call
    the generate functions once per (pair, sample)."""
    from dawn_tpu_torch.weights.checkpoints import load_pbnet_checkpoint
    model = build_for(read_opt(ckpt_path), pos_dim, eye_dim, device)
    load_pbnet_checkpoint(model, ckpt_path)
    return model


def _drive(model, init_state: np.ndarray, audio: np.ndarray, generator, z, fact):
    out = model.generate(torch.from_numpy(np.asarray(init_state, np.float32)),
                         torch.from_numpy(np.asarray(audio, np.float32)[None]),
                         fact=fact, generator=generator,
                         z=None if z is None else torch.from_numpy(np.array(z, np.float32)))
    return out[0].cpu().numpy()


def generate_drives_joint(ckpt_path: str, audio: np.ndarray, init_pose: np.ndarray,
                          init_blink: np.ndarray, seed: int = 1234, fact: float = 1.0,
                          z=None, device=None) -> Tuple[np.ndarray, np.ndarray]:
    """Joint 8-d generation (the 'both' checkpoint). audio (T, 1024);
    init_pose (1, 6); init_blink (1, 2). Returns (dri_pose (T, 6),
    dri_blink (T, 2)) in physical units."""
    model = load_pbnet_with_opt(ckpt_path, 6, 2, device)
    init8 = np.concatenate([init_pose[:, :6], init_blink[:, :2]], axis=-1)
    init8n = (init8 - MIN_VALS_8) / (MAX_VALS_8 - MIN_VALS_8)
    gen = torch.Generator().manual_seed(seed)
    out = _drive(model, init8n, audio, gen, z, fact)
    out = inv_transform(out + init8n, MIN_VALS_8, MAX_VALS_8)
    return out[:, :6], out[:, 6:]


def drives_separate(model_p, model_b, audio: np.ndarray, init_pose: np.ndarray,
                    init_blink: np.ndarray, seed: int = 1234, fact: float = 1.0,
                    z_pose=None, z_blink=None) -> Tuple[np.ndarray, np.ndarray]:
    """Separate pose and blink models (unified_video_generator.py:252-302):
    the pose is normalized with the 6-d constants, the blink is not."""
    pose_max, pose_min = MAX_VALS_8[:6], MIN_VALS_8[:6]
    init_pose_n = (init_pose[:, :6] - pose_min) / (pose_max - pose_min)
    gen = torch.Generator().manual_seed(seed)
    out_p = _drive(model_p, init_pose_n, audio, gen, z_pose, fact)
    out_b = _drive(model_b, init_blink[:, :2], audio, gen, z_blink, fact)
    return inv_transform(out_p + init_pose_n, pose_min, pose_max), out_b + init_blink[:, :2]


def generate_drives_separate(pose_ckpt: str, blink_ckpt: str, audio: np.ndarray,
                             init_pose: np.ndarray, init_blink: np.ndarray,
                             seed: int = 1234, fact: float = 1.0, z_pose=None, z_blink=None,
                             device=None) -> Tuple[np.ndarray, np.ndarray]:
    """Separate pose/blink checkpoints."""
    return drives_separate(load_pbnet_with_opt(pose_ckpt, 6, 0, device),
                           load_pbnet_with_opt(blink_ckpt, 2, 0, device),
                           audio, init_pose, init_blink, seed, fact, z_pose, z_blink)


def run(audio_path: str, init_dir: str, output_dir: str, ckpt: Optional[str] = None,
        pose_ckpt: Optional[str] = None, blink_ckpt: Optional[str] = None,
        seed: int = 1234, device=None) -> None:
    """CLI entry: target_audio .npy + init dir -> dri_pose/dri_blink .npy."""
    audio = np.load(audio_path).astype(np.float32)
    init_pose, init_blink = _load_init(init_dir)
    if ckpt:
        pose, blink = generate_drives_joint(ckpt, audio, init_pose, init_blink, seed,
                                            device=device)
    else:
        pose, blink = generate_drives_separate(pose_ckpt, blink_ckpt, audio, init_pose,
                                               init_blink, seed, device=device)
    os.makedirs(output_dir, exist_ok=True)
    np.save(os.path.join(output_dir, "dri_pose.npy"), pose)
    np.save(os.path.join(output_dir, "dri_blink.npy"), blink)
    print(f"wrote dri_pose.npy {pose.shape} / dri_blink.npy {blink.shape} to {output_dir}")


def main(argv=None):
    import argparse
    p = argparse.ArgumentParser(description="PBnet drive generation "
                                "(tvae_eval_single_both_eye_pose parity)")
    p.add_argument("--audio_path", required=True, help="target_audio.npy (T, 1024)")
    p.add_argument("--init_pose_blink", required=True,
                   help="dir with init_pose.npy / init_eye_bbox.npy")
    p.add_argument("--output", required=True)
    p.add_argument("--ckpt", default=None, help="joint 'both' checkpoint")
    p.add_argument("--pose_ckpt", default=None)
    p.add_argument("--blink_ckpt", default=None)
    p.add_argument("--seed", type=int, default=1234)
    p.add_argument("--device", default=None, help="default: the card; 'cpu' to run on the CPU")
    a = p.parse_args(argv)
    if not a.ckpt and not (a.pose_ckpt and a.blink_ckpt):
        p.error("give --ckpt (joint) or both --pose_ckpt and --blink_ckpt")
    run(a.audio_path, a.init_pose_blink, a.output, a.ckpt, a.pose_ckpt, a.blink_ckpt, a.seed,
        a.device)


if __name__ == "__main__":
    main()
