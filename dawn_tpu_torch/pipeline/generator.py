"""The unified inference API and CLI: one portrait + one speech WAV -> video.

Port of ``dawn_tpu/pipeline/generator.py``: the same four stages
(extract_pose -> process_audio -> generate_pose_blink ->
generate_final_video), the same cache files (init_pose.npy (1, 7),
init_eye_bbox.npy (1, 8), target_audio.npy (T, 1024), dri_pose.npy (T, 6),
dri_blink.npy (T, 2)), the same PNG frames and mp4, and the same CLI flags
plus ``--device``:

    python -m dawn_tpu_torch.pipeline.generator --audio_path X.wav --image_path Y.png

Every model runs on the card unless ``device="cpu"``: HuBERT-large, the two
PBnet CVAEs, and ``FlowDiffusion.sample_one_video``, whose temporal
attentions run K1 (200 launches for a 200-frame, 20-step video). Released
checkpoints load through :mod:`dawn_tpu_torch.weights.checkpoints`; without
them every model falls back to seeded random weights of its deployed
topology, as the JAX generator does. Stage 1 reads the portrait's face
(:mod:`dawn_tpu_torch.pipeline.face_prep`: FaceBoxes and the 3DDFA
MobileNet on the card, the BFM and pose math on the host) when
``GeneratorPaths.tddfa_onnx_dir`` names the face assets; unset, it writes
the documented default state. Where the JAX generator prints a failure of
that stage and falls back to the default, the port raises it.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import os
import time
from typing import Dict, Optional

import numpy as np
import torch

from dawn_tpu_torch import resolve_device
from dawn_tpu_torch.pipeline.pose_blink import DEFAULT_BLINK_2, DEFAULT_POSE_6

# 3DDFA-failure fallbacks (unified_video_generator.py:275-278, :338-341): the
# 7-d pose is the 6-d one and a trailing 0, the 8-d eye_bbox the blink and
# a default face box [x0, x1, y0, y1, H, W]
DEFAULT_POSE = np.concatenate([DEFAULT_POSE_6, np.zeros((1, 1), np.float32)], axis=1)
DEFAULT_EYE_BBOX = np.concatenate(
    [DEFAULT_BLINK_2, np.array([[64, 64, 192, 192, 256, 256]], np.float32)], axis=1)


def pad_to_bucket(arrays, t: int, bucket: int, max_n_frames: int):
    """Edge-pad (T, D) conditioning arrays so T rounds up to a multiple of
    ``bucket`` (capped at max_n_frames); returns (padded_arrays, t_padded)."""
    t_pad = min(max_n_frames, -(-t // bucket) * bucket)
    if t_pad <= t:
        return list(arrays), t
    pad = ((0, t_pad - t), (0, 0))
    return [np.pad(a, pad, mode="edge") for a in arrays], t_pad


def _resolve_asset(path: Optional[str], default: Optional[str], kind: str) -> Optional[str]:
    """A missing DEFAULT asset location degrades to the random-weight
    fallback; an explicitly given path that does not exist raises."""
    if not path:
        return None
    if os.path.exists(path):
        return path
    if path == default:
        print(f"[{kind}] default asset missing ({path}) — random-weight fallback")
        return None
    raise FileNotFoundError(f"{kind}: {path} does not exist")


@contextlib.contextmanager
def _seeded(seed: int):
    """Build random-weight fallbacks from ``seed`` (modules initialise on
    the CPU's generator, then move), leaving the caller's RNG as it was."""
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(seed)
        yield


@dataclasses.dataclass
class GeneratorPaths:
    """Model asset locations (all optional; stages degrade gracefully)."""
    hubert_dir: Optional[str] = "./pretrain_models/hubert-large-ls960-ft"
    pbnet_pose_ckpt: Optional[str] = "./pretrain_models/pbnet_seperate/pose/checkpoint_40000.pth.tar"
    pbnet_blink_ckpt: Optional[str] = "./pretrain_models/pbnet_seperate/blink/checkpoint_95000.pth.tar"
    dawn_ckpt: Optional[str] = None       # DAWN_{128,256}.pth
    lfg_ckpt: Optional[str] = None        # LFG_*.pth
    tddfa_onnx_dir: Optional[str] = None  # stage 1's face assets (load_face_assets)


class VideoGenerator:
    """One image + one WAV -> talking-head video.

    The models are built once and kept (``_hubert``, ``_pbnet['pose' |
    'blink']``, ``_video_model``), so a second ``run`` is warm. After ``run``,
    ``frames`` holds the video (T, H, W, 3) in [0, 1] and ``stage_seconds``
    each stage's host-clock seconds (the card synchronized)."""

    def __init__(self, audio_path: str, image_path: str, output_path: str, cache_path: str,
                 resolution: int = 128, paths: Optional[GeneratorPaths] = None,
                 max_n_frames: int = 200, win_width: int = 40, sampling_step: int = 20,
                 ddim_sampling_eta: float = 1.0, cond_scale: float = 1.0,
                 attn_mode: str = "local", seed: int = 1234, bucket_frames: int = 25,
                 device=None):
        self.audio_path = audio_path
        self.image_path = image_path
        self.output_path = output_path
        self.cache_path = cache_path
        self.resolution = resolution
        self.paths = paths if paths is not None else GeneratorPaths()
        self.max_n_frames = max_n_frames
        self.win_width = win_width
        self.sampling_step = sampling_step
        self.ddim_sampling_eta = ddim_sampling_eta
        self.cond_scale = cond_scale
        # 'pallas' names the JAX package's kernel path: the same function as
        # 'local', which runs K1 here
        self.attn_mode = "local" if attn_mode == "pallas" else attn_mode
        self.seed = seed
        # T rounds up to a multiple of bucket_frames (conditioning padded with
        # the last frame, output trimmed), as the JAX generator pads to reuse
        # its compiled program (DEVIATIONS #3); 0 = exact length
        self.bucket_frames = bucket_frames
        self.device = resolve_device(device)
        os.makedirs(cache_path, exist_ok=True)
        os.makedirs(output_path, exist_ok=True)
        self._hubert = None
        self._pbnet: Dict[str, torch.nn.Module] = {}
        self._video_model = None
        self._face_assets = None
        self.frames: Optional[np.ndarray] = None
        self.stage_seconds: Dict[str, float] = {}

    @classmethod
    def from_config(cls, config_path: str, audio_path: str, image_path: str,
                    output_path: str, cache_path: str,
                    paths_override: Optional[Dict[str, str]] = None, **overrides):
        """Build from a reference-style DAWN yaml (input_size, max_n_frames,
        win_width, sampling_step, ddim_sampling_eta, cond_scale, random_seed,
        model_config checkpoint paths). Keyword arguments override the yaml;
        ``paths_override`` replaces single GeneratorPaths fields (explicit,
        strict). The yaml's checkpoint paths are default-like: absent, they
        fall back to random weights."""
        import yaml
        with open(config_path) as f:
            cfg = yaml.safe_load(f) or {}
        mc = cfg.get("model_config") or {}
        paths = overrides.pop("paths", None)
        if paths is None:
            fields = dict(
                dawn_ckpt=_resolve_asset(mc.get("diffusion_pretrained_pth"),
                                         mc.get("diffusion_pretrained_pth"), "config dawn_ckpt"),
                lfg_ckpt=_resolve_asset(mc.get("ae_pretrained_pth"),
                                        mc.get("ae_pretrained_pth"), "config lfg_ckpt"))
            fields.update({k: v for k, v in (paths_override or {}).items() if v})
            paths = GeneratorPaths(**fields)
        kw = dict(resolution=cfg.get("input_size", 128),
                  max_n_frames=cfg.get("max_n_frames", 200),
                  win_width=cfg.get("win_width", 40),
                  sampling_step=cfg.get("sampling_step", 20),
                  ddim_sampling_eta=cfg.get("ddim_sampling_eta", 1.0),
                  cond_scale=cfg.get("cond_scale", 1.0),
                  attn_mode=cfg.get("attn_mode", "local"),
                  seed=cfg.get("random_seed", 1234))
        kw.update(overrides)
        return cls(audio_path, image_path, output_path, cache_path, paths=paths, **kw)

    def _cache(self, name: str) -> str:
        return os.path.join(self.cache_path, name)

    # ------------------------------------------------------------ stage 1
    def extract_pose(self) -> None:
        """Face -> init_pose.npy (1, 7) + init_eye_bbox.npy (1, 8). With
        ``paths.tddfa_onnx_dir`` set, the portrait's first face through
        :func:`face_prep.extract_init_states` (the nets on this generator's
        device, loaded once); a failure raises. Unset, the reference's
        documented default state (:275-278)."""
        if not self.paths.tddfa_onnx_dir:
            pose, eye_bbox = DEFAULT_POSE, DEFAULT_EYE_BBOX
        else:
            from dawn_tpu_torch.pipeline.face_prep import extract_init_states
            from dawn_tpu_torch.weights.checkpoints import load_face_assets

            if self._face_assets is None:
                self._face_assets = load_face_assets(self.paths.tddfa_onnx_dir, self.device)
            pose, eye_bbox = extract_init_states(self.image_path, self._face_assets)
        np.save(self._cache("init_pose.npy"), pose)
        np.save(self._cache("init_eye_bbox.npy"), eye_bbox)

    # ------------------------------------------------------------ stage 2
    def _hubert_model(self):
        if self._hubert is None:
            from dawn_tpu_torch.models.hubert import HubertConfig, HubertModel
            from dawn_tpu_torch.weights.checkpoints import load_hubert_dir

            hub_dir = _resolve_asset(self.paths.hubert_dir, GeneratorPaths.hubert_dir, "hubert")
            if hub_dir:
                self._hubert, _ = load_hubert_dir(hub_dir, self.device)
            else:
                print("[process_audio] no HuBERT checkpoint dir — random hubert-large weights")
                with _seeded(self.seed):
                    self._hubert = HubertModel(HubertConfig.large(), device=self.device)
        return self._hubert

    def process_audio(self) -> None:
        """WAV -> target_audio.npy (T, 1024) 25 fps HuBERT features."""
        from dawn_tpu_torch.pipeline.audio import process_audio
        model = self._hubert_model()
        feats = process_audio(self.audio_path,
                              lambda w: model(torch.from_numpy(w)).cpu().numpy())
        np.save(self._cache("target_audio.npy"), feats)

    # ------------------------------------------------------------ stage 3
    def _pbnet_model(self, kind: str):
        if kind not in self._pbnet:
            from dawn_tpu_torch.pipeline.pose_blink import build_for, load_pbnet_with_opt

            pose = kind == "pose"
            default = GeneratorPaths.pbnet_pose_ckpt if pose else GeneratorPaths.pbnet_blink_ckpt
            ckpt = _resolve_asset(self.paths.pbnet_pose_ckpt if pose
                                  else self.paths.pbnet_blink_ckpt, default, f"pbnet-{kind}")
            pos_dim = 6 if pose else 2
            if ckpt:
                model = load_pbnet_with_opt(ckpt, pos_dim, 0, self.device)
            else:
                print(f"[generate_pose_blink] no PBnet {kind} checkpoint — "
                      f"random transformerreemb6 weights")
                with _seeded(self.seed):
                    model = build_for({}, pos_dim, 0, self.device)
            self._pbnet[kind] = model
        return self._pbnet[kind]

    def generate_pose_blink(self, z_pose=None, z_blink=None) -> None:
        """audio + init state -> dri_pose.npy (T, 6) + dri_blink.npy (T, 2).
        The latents come from ``seed`` unless ``z_pose`` / ``z_blink``
        ((1, T, 256) each) are given."""
        from dawn_tpu_torch.pipeline.pose_blink import drives_separate

        audio = np.load(self._cache("target_audio.npy"))
        try:
            init_pose = np.load(self._cache("init_pose.npy"))[:, :6]
            init_blink = np.load(self._cache("init_eye_bbox.npy"))[:, :2]
        except Exception:
            init_pose, init_blink = DEFAULT_POSE[:, :6], DEFAULT_EYE_BBOX[:, :2]
        pose, blink = drives_separate(self._pbnet_model("pose"), self._pbnet_model("blink"),
                                      audio, init_pose, init_blink, self.seed,
                                      z_pose=z_pose, z_blink=z_blink)
        np.save(self._cache("dri_pose.npy"), pose)
        np.save(self._cache("dri_blink.npy"), blink)

    # ------------------------------------------------------------ stage 4
    def _init_video_model(self):
        if self._video_model is None:
            from dawn_tpu_torch.models.dm.flow_diffusion import (FlowDiffusion,
                                                                 FlowDiffusionConfig)
            from dawn_tpu_torch.weights.checkpoints import (load_dawn_checkpoint,
                                                            load_lfg_generator)

            cfg = FlowDiffusionConfig(img_size=self.resolution, pose_dim=6,
                                      win_width=self.win_width,
                                      sampling_timesteps=self.sampling_step,
                                      ddim_sampling_eta=self.ddim_sampling_eta,
                                      attn_mode=self.attn_mode)
            # the FaceLocEncoder is never checkpointed: seeded (DEVIATIONS #2)
            with _seeded(self.seed):
                model = FlowDiffusion(cfg, device=self.device)
            if self.paths.dawn_ckpt:
                load_dawn_checkpoint(model.unet, self.paths.dawn_ckpt)
            else:
                print("[video_model] no DAWN checkpoint given — random UNet weights")
            if self.paths.lfg_ckpt:
                load_lfg_generator(model, self.paths.lfg_ckpt)
            else:
                print("[video_model] no LFG checkpoint given — random decoder weights")
            self._video_model = model
        return self._video_model

    def sample_video(self, noise_seq: Optional[torch.Tensor] = None) -> np.ndarray:
        """The cache files and the portrait -> the video (T, H, W, 3) in
        [0, 1], T = min(max_n_frames, audio frames). The DDIM noise comes
        from ``seed`` unless ``noise_seq`` ((steps + 1, 1, T_bucket, h, w, 3))
        is given."""
        from PIL import Image

        s = self.resolution
        image = Image.open(self.image_path).convert("RGB").resize((s, s), Image.BILINEAR)
        img = np.asarray(image, np.float32) / 255.0
        hubert = np.load(self._cache("target_audio.npy"))
        t = min(self.max_n_frames, hubert.shape[0])
        hubert = hubert[:t]
        pose = np.load(self._cache("dri_pose.npy"))[:t]
        blink = np.load(self._cache("dri_blink.npy"))[:t]
        if self.bucket_frames > 0:
            (hubert, pose, blink), _ = pad_to_bucket((hubert, pose, blink), t,
                                                     self.bucket_frames, self.max_n_frames)
        try:
            real_pose = np.load(self._cache("init_pose.npy"))
            eye_bbox = np.load(self._cache("init_eye_bbox.npy"))
        except Exception:
            real_pose, eye_bbox = np.zeros((1, 7), np.float32), DEFAULT_EYE_BBOX

        model = self._init_video_model()
        gen = None
        if noise_seq is None:
            gen = torch.Generator(device=self.device).manual_seed(self.seed)

        def tensor(a):
            return torch.from_numpy(np.ascontiguousarray(a, np.float32))

        out = model.sample_one_video(
            tensor(img[None]), tensor(hubert[None]), tensor(pose[None]), tensor(blink[None]),
            tensor(eye_bbox[:, 2:8]), init_pose=tensor(real_pose[:, :6]),
            init_eye=tensor(eye_bbox[:, :2]), cond_scale=self.cond_scale,
            noise_seq=noise_seq, generator=gen)
        return out["sample_out_vid"][0, :t].float().cpu().numpy()

    def generate_final_video(self, noise_seq: Optional[torch.Tensor] = None) -> str:
        """Sample the video, write its PNG frames and mp4 (muxed with the
        audio when ffmpeg exists); returns the mp4's path."""
        import cv2

        s = self.resolution
        name = os.path.splitext(os.path.basename(self.image_path))[0]
        video_dir = os.path.join(self.output_path, name, "video")
        img_dir = os.path.join(self.output_path, name, "img")
        os.makedirs(video_dir, exist_ok=True)
        os.makedirs(img_dir, exist_ok=True)

        self.frames = frames = self.sample_video(noise_seq)
        t = frames.shape[0]
        silent_path = os.path.join(video_dir, f"{name}_silent.mp4")
        writer = cv2.VideoWriter(silent_path, cv2.VideoWriter_fourcc(*"mp4v"), 25, (s, s))
        for i in range(t):
            bgr = cv2.cvtColor((np.clip(frames[i], 0, 1) * 255).astype(np.uint8),
                               cv2.COLOR_RGB2BGR)
            writer.write(bgr)
            cv2.imwrite(os.path.join(img_dir, f"{i:03d}.png"), bgr)
        writer.release()

        final_path = os.path.join(video_dir, f"{name}.mp4")
        if not self._mux_audio(silent_path, final_path, t):
            final_path = silent_path
        print(f"[generate_final_video] wrote {final_path} ({t} frames)")
        return final_path

    def _mux_audio(self, video_path: str, out_path: str, num_frames: int) -> bool:
        """ffmpeg audio mux when the binary exists (:567-586); else skip.
        The reference's trailing '-shortest' is dropped: '-t' bounds the
        duration, and ffmpeg >= 7 rejects trailing options."""
        import shutil
        import subprocess
        if shutil.which("ffmpeg") is None:
            return False
        cmd = ["ffmpeg", "-y", "-i", self.audio_path, "-i", video_path, "-vcodec", "copy",
               "-t", f"{num_frames / 25.0:.3f}", "-pix_fmt", "yuv420p", out_path]
        return subprocess.run(cmd, capture_output=True).returncode == 0

    # ----------------------------------------------------------------- run
    def run(self, z_pose=None, z_blink=None, noise_seq=None) -> str:
        """The four stages; returns the mp4's path. ``z_pose``, ``z_blink``
        and ``noise_seq`` replace stage 3's and stage 4's draws."""
        stages = (("extract_pose", "1. Extracting pose information...", {}),
                  ("process_audio", "2. Processing audio...", {}),
                  ("generate_pose_blink", "3. Generating pose and blink data...",
                   dict(z_pose=z_pose, z_blink=z_blink)),
                  ("generate_final_video", "4. Generating final video...",
                   dict(noise_seq=noise_seq)))
        self.stage_seconds = {}
        for stage, message, kw in stages:
            print(message)
            t0 = time.perf_counter()
            out = getattr(self, stage)(**kw)
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
            self.stage_seconds[stage] = time.perf_counter() - t0
        return out


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="DAWN unified video generator (PyTorch/CUDA)")
    p.add_argument("--audio_path", default="WRA_MarcoRubio_000.wav")
    p.add_argument("--image_path", default="real_female_1.jpeg")
    p.add_argument("--output_path", default="output")
    p.add_argument("--cache_path", default="cache/tmp")
    p.add_argument("--resolution", type=int, default=None,
                   help="128 or 256 (default: the config's input_size, else 128); "
                        "explicit values override the config")
    p.add_argument("--config", default=None,
                   help="reference-style DAWN yaml (default: configs/dawn_{resolution}.yaml "
                        "when that file exists)")
    p.add_argument("--hubert_dir", default=None)
    p.add_argument("--pbnet_pose_ckpt", default=None)
    p.add_argument("--pbnet_blink_ckpt", default=None)
    p.add_argument("--dawn_ckpt", default=None)
    p.add_argument("--lfg_ckpt", default=None)
    p.add_argument("--attn", default=None, choices=["full", "local", "pallas"],
                   help="default: the config's attn_mode, else 'local' ('pallas' = 'local')")
    p.add_argument("--bucket_frames", type=int, default=25,
                   help="round the video length up to this multiple (0 = exact; default 25, "
                        "the JAX generator's)")
    p.add_argument("--device", default=None,
                   help="default: the card; 'cpu' to run on the CPU")
    return p.parse_args(argv)


def main(argv=None) -> VideoGenerator:
    """The CLI; returns the generator it ran (its models stay built)."""
    args = parse_args(argv)
    resolution = args.resolution if args.resolution is not None else 128
    config = args.config
    if config is None:
        default_cfg = os.path.join("configs", f"dawn_{resolution}.yaml")
        config = default_cfg if os.path.exists(default_cfg) else None
    # explicit CLI paths (strict: a typo raises); unset fields fall through
    # to the yaml's model_config / GeneratorPaths defaults
    user_paths = {k: v for k, v in dict(
        hubert_dir=args.hubert_dir, pbnet_pose_ckpt=args.pbnet_pose_ckpt,
        pbnet_blink_ckpt=args.pbnet_blink_ckpt, dawn_ckpt=args.dawn_ckpt,
        lfg_ckpt=args.lfg_ckpt).items() if v}
    overrides = dict(bucket_frames=args.bucket_frames, device=args.device)
    if args.attn is not None:
        overrides["attn_mode"] = args.attn
    if config is not None:
        if args.resolution is not None:
            overrides["resolution"] = args.resolution
        gen = VideoGenerator.from_config(config, args.audio_path, args.image_path,
                                         args.output_path, args.cache_path,
                                         paths_override=user_paths, **overrides)
    else:
        gen = VideoGenerator(args.audio_path, args.image_path, args.output_path,
                             args.cache_path, resolution, paths=GeneratorPaths(**user_paths),
                             **overrides)
    gen.run()
    return gen


if __name__ == "__main__":
    main()
