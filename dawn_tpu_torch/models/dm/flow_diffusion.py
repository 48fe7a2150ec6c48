"""FlowDiffusion: the DAWN model proper, a UNet3D diffusion over LFG flow space.

Port of ``dawn_tpu/models/dm/flow_diffusion.py``. ``sample_one_video`` is
stage 4 of the pipeline: build the condition (HuBERT ++ d-pose ++ d-eye), encode
the source image with LFG ``compute_fea`` and the face-location mask with
``FaceLocEncoder``, precompute the step-constant part of the UNet's init conv
once, run the sampler over ``Unet3D`` (DDIM, or the ancestral loop when
``sampling_timesteps`` reaches the 1000 train steps), then decode every
frame with one batched LFG flow-warp pass (or in chunks of
``lfg_decode_chunk`` frames).

Inputs and outputs keep the JAX package's channels-last layouts. The model
lives on the card unless the caller passes ``device="cpu"``.

Across processes (:mod:`dawn_tpu_torch.parallel`): ``make_batch_sampler``
splits a batch of identities over the mesh's 'data' ranks and
``make_seq_sampler`` the frames of one video over its 'seq' ranks. Every
rank receives the whole inputs and keeps its own part; the noise is drawn at
the whole batch's shape from the same seed and cut, so the ranks' parts
together are the video of one unsharded call.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from dawn_tpu_torch import resolve_device
from dawn_tpu_torch.models.dm.diffusion import GaussianDiffusion
from dawn_tpu_torch.models.dm.unet3d import Unet3D
from dawn_tpu_torch.models.lfg.blocks import conv
from dawn_tpu_torch.models.lfg.generator import LFGGenerator
from dawn_tpu_torch.parallel.mesh import Mesh
from dawn_tpu_torch.utils import profiling


class FaceLocEncoder(nn.Module):
    """Two stride-2 convs embedding the binary face-location mask. The
    reference never trains nor checkpoints this module (it runs with fresh
    random weights), so its weights come from the caller's seed."""

    def __init__(self):
        super().__init__()
        self.conv1 = nn.Conv2d(1, 8, 3, stride=2, padding=1)
        self.conv2 = nn.Conv2d(8, 16, 3, stride=2, padding=1)

    def forward(self, x):
        x = F.relu(conv(x, self.conv1, torch.float32))
        return F.relu(conv(x, self.conv2, torch.float32))


def generate_bbox_mask(bbox: torch.Tensor, size: int) -> torch.Tensor:
    """Rasterize the face bbox to a (B, size, size, 1) binary mask.

    bbox: (B, 6) = [x_min, x_max, y_min, y_max, H, W] in image pixels. As the
    reference does, x is normalized by element 4 (H) and y by element 5 (W),
    and the corners are truncated to int32."""
    bbox = bbox.float()
    x = bbox[:, 0:2] / bbox[:, 4:5] * size
    y = bbox[:, 2:4] / bbox[:, 5:6] * size
    x0, x1 = x[:, 0].to(torch.int32), (x[:, 1] + 1).to(torch.int32)
    y0, y1 = y[:, 0].to(torch.int32), (y[:, 1] + 1).to(torch.int32)
    idx = torch.arange(size, device=bbox.device)
    rows, cols = idx[None, :, None], idx[None, None, :]
    mask = ((rows >= y0[:, None, None]) & (rows <= y1[:, None, None])
            & (cols >= x0[:, None, None]) & (cols <= x1[:, None, None]))
    return mask.float()[..., None]


@dataclasses.dataclass
class FlowDiffusionConfig:
    img_size: int = 128
    pose_dim: int = 6
    win_width: int = 40
    sampling_timesteps: int = 20          # >= 1000: the ancestral p_sample_loop
    ddim_sampling_eta: float = 1.0
    attn_mode: str = "local"              # 'local' (K1) | 'full'
    fuse_cond: bool = False               # JAX's fused condition branches: same function
    dim_mults: Tuple[int, ...] = (1, 2, 4, 8)
    dtype: torch.dtype = torch.bfloat16   # UNet compute dtype
    lfg_dtype: torch.dtype = torch.float32
    lfg_max_features: int = 512
    lfg_num_bottleneck: int = 6
    lfg_decode_chunk: int = 0             # decode frames in chunks (0 = all)

    @property
    def latent_size(self) -> int:
        return self.img_size // 4


class FlowDiffusion(nn.Module):
    """Bundles the UNet, the diffusion math, the frozen LFG generator and
    the mask encoder. Parameters are random (torch's default init) until
    weights are loaded, e.g. with
    :func:`dawn_tpu_torch.weights.jax_bridge.load_flow_diffusion_variables`."""

    def __init__(self, config: FlowDiffusionConfig = FlowDiffusionConfig(),
                 device=None):
        super().__init__()
        self.config = config
        self.device = resolve_device(device)
        self.unet = Unet3D(dim=64, channels=3 + 256 + 16,
                           dim_mults=tuple(config.dim_mults), cond_pose=config.pose_dim,
                           win_width=config.win_width, attn_mode=config.attn_mode,
                           fuse_cond=config.fuse_cond, dtype=config.dtype)
        self.diffusion = GaussianDiffusion(
            timesteps=1000, sampling_timesteps=config.sampling_timesteps,
            ddim_sampling_eta=config.ddim_sampling_eta)
        self.generator = LFGGenerator(max_features=config.lfg_max_features,
                                      num_bottleneck_blocks=config.lfg_num_bottleneck,
                                      dtype=config.lfg_dtype)
        self.face_loc = FaceLocEncoder()
        self.to(self.device)
        self.eval()

    def build_condition(self, audio_hubert, pose, eye, init_pose, init_eye):
        """cond = [hubert, pose - init_pose, eye - init_eye]; pose is padded
        with init_pose's last column when it has fewer dims (pose_dim=7
        checkpoints driven with 6-d poses)."""
        p = self.config.pose_dim
        init_pose, pose = init_pose[:, :p], pose[..., :p]
        init_pose_b = init_pose[:, None].expand(pose.shape[0], pose.shape[1], -1)
        if pose.shape[-1] != init_pose.shape[-1]:
            pose = torch.cat([pose, init_pose_b[..., -1:]], dim=-1)
        return torch.cat([audio_hubert, pose - init_pose_b, eye - init_eye[:, None]],
                         dim=-1)

    def sample_one_video(self, sample_img: torch.Tensor, audio_hubert: torch.Tensor,
                         pose: torch.Tensor, eye: torch.Tensor, bbox: torch.Tensor,
                         init_pose: Optional[torch.Tensor] = None,
                         init_eye: Optional[torch.Tensor] = None,
                         cond_scale: float = 1.0,
                         noise_seq: Optional[torch.Tensor] = None,
                         generator: Optional[torch.Generator] = None
                         ) -> Dict[str, torch.Tensor]:
        """One image + conditions -> video.

        sample_img: (B, H, W, 3) in [0, 1]; audio_hubert: (B, T, 1024); pose:
        (B, T, P); eye: (B, T, 2); bbox: (B, 6). init_pose / init_eye default to
        frame 0 of the driving signals. Noise comes from ``noise_seq``
        ((steps+1, B, T, h, w, 3)) when given, else from ``generator``.
        Returns (B, T, ...) 'sample_vid_grid', 'sample_vid_conf',
        'sample_out_vid' and 'sample_warped_vid'."""
        return self._sample(sample_img, audio_hubert, pose, eye, bbox, init_pose, init_eye,
                            cond_scale, noise_seq, generator)

    def make_batch_sampler(self, mesh: Mesh, cond_scale: float = 1.0):
        """Multi-identity sampler with the batch over the mesh's 'data' axis
        (``dawn_tpu/models/dm/flow_diffusion.py:257-275``). Returns a
        callable with ``sample_one_video``'s inputs, each of the whole batch;
        it returns this rank's rows ((B / data, T, ...) leaves; the whole
        batch with :func:`dawn_tpu_torch.parallel.mesh.gather_rows`)."""
        def sampler(sample_img, audio_hubert, pose, eye, bbox, init_pose=None,
                    init_eye=None, noise_seq=None, generator=None):
            return self._sample(sample_img, audio_hubert, pose, eye, bbox, init_pose,
                                init_eye, cond_scale, noise_seq, generator,
                                rows=mesh.rows(audio_hubert.shape[0]))
        return sampler

    def make_seq_sampler(self, mesh: Mesh, cond_scale: float = 1.0):
        """Sequence-parallel sampler of one video with the frame axis over
        the mesh's 'seq' axis (``dawn_tpu/models/dm/flow_diffusion.py:
        277-322``): the UNet runs sharded (:meth:`Unet3D.sharded_over`: halo
        exchange and K5 in every temporal attention, the GroupNorm and
        dynamic-thresholding statistics over the whole video), the decode
        runs on the rank's frames. T must divide over the 'seq' ranks and
        T / ranks must cover win_width. Returns a callable with
        ``sample_one_video``'s inputs, each of the whole video; it returns
        this rank's frames ((B, T / seq, ...) leaves; the whole video with
        :func:`dawn_tpu_torch.parallel.mesh.gather_frames`)."""
        def sampler(sample_img, audio_hubert, pose, eye, bbox, init_pose=None,
                    init_eye=None, noise_seq=None, generator=None):
            return self._sample(sample_img, audio_hubert, pose, eye, bbox, init_pose,
                                init_eye, cond_scale, noise_seq, generator, seq_mesh=mesh)
        return sampler

    @torch.no_grad()
    def _sample(self, sample_img, audio_hubert, pose, eye, bbox, init_pose, init_eye,
                cond_scale, noise_seq, generator, rows: slice = slice(None),
                seq_mesh: Optional[Mesh] = None) -> Dict[str, torch.Tensor]:
        """sample_one_video on the batch rows ``rows`` and, with
        ``seq_mesh``, on this rank's frames of them; the condition's
        reference (frame 0) and the noise are those of the whole inputs. The
        top-level call of the tracing recorder (``dawn::sample``)."""
        with profiling.call("sample"):
            pred = self.sample_latents(sample_img, audio_hubert, pose, eye, bbox, init_pose,
                                       init_eye, cond_scale, noise_seq, generator, rows,
                                       seq_mesh)
            return self.decode_latents(sample_img.to(self.device, torch.float32)[rows], pred)

    @torch.no_grad()
    def sample_latents(self, sample_img, audio_hubert, pose, eye, bbox, init_pose=None,
                       init_eye=None, cond_scale: float = 1.0, noise_seq=None,
                       generator=None, rows: slice = slice(None),
                       seq_mesh: Optional[Mesh] = None) -> torch.Tensor:
        """The first phase of :meth:`sample_one_video` (its arguments, and
        ``rows``/``seq_mesh`` as in ``_sample``): the condition, the source
        feature and mask embedding, the step-constant init conv, then the
        sampler over the UNet. Returns the (B, T, h, w, 3) latent video:
        flow (2 channels) and occlusion logit."""
        cfg, dev = self.config, self.device
        b_all, t_all = audio_hubert.shape[:2]
        sample_img, audio_hubert, pose, eye, bbox = (
            z.to(dev, torch.float32)[rows] for z in (sample_img, audio_hubert, pose, eye, bbox))
        b = audio_hubert.shape[0]
        ls = cfg.latent_size
        init_pose = pose[:, 0] if init_pose is None else init_pose.to(dev, torch.float32)[rows]
        init_eye = eye[:, 0] if init_eye is None else init_eye.to(dev, torch.float32)[rows]
        frames = seq_mesh.frames(t_all) if seq_mesh is not None else slice(None)
        cond = self.build_condition(audio_hubert, pose, eye, init_pose, init_eye)[:, frames]
        t = cond.shape[1]

        fea = self.generator.compute_fea(sample_img)                   # (B, ls, ls, 256)
        mask_emb = self.face_loc(generate_bbox_mask(bbox, cfg.img_size))  # (B, ls, ls, 16)
        # fea and mask are constant over the DDIM steps and over frames: their
        # init_conv contribution is computed once, on one frame
        static = self.unet(torch.cat([fea[:, None], mask_emb[:, None]], dim=-1),
                           None, precompute_static=True).expand(b, t, -1, -1, -1)

        def denoise(x, tvec, c, drop):
            return self.unet(x, tvec, c, drop, static_feat=static)

        with self.unet.sharded_over(seq_mesh):
            return self.diffusion.sample(denoise, (b_all, t_all, ls, ls, 3), cond, cond_scale,
                                         noise_seq, generator, dev, view=(rows, frames),
                                         group=self.unet.seq.group())

    @torch.no_grad()
    def decode_latents(self, sample_img: torch.Tensor, pred: torch.Tensor
                       ) -> Dict[str, torch.Tensor]:
        """The second phase of :meth:`sample_one_video`: the LFG decode of
        every frame of ``pred`` ((B, T, h, w, 3), :meth:`sample_latents`)
        from the (B, H, W, 3) sources on this model's device, all frames at
        once or in chunks of ``lfg_decode_chunk``. Returns its dict."""
        t = pred.shape[1]
        grid = pred[..., :2]
        conf = (pred[..., 2:3] + 1.0) * 0.5
        ck = self.config.lfg_decode_chunk if self.config.lfg_decode_chunk else t
        skips = self.generator.encode(sample_img)
        decoded = [self.generator.decode_shared(sample_img, skips, grid[:, i:i + ck],
                                                conf[:, i:i + ck])
                   for i in range(0, t, ck)]
        return {
            "sample_vid_grid": grid,
            "sample_vid_conf": conf,
            "sample_out_vid": torch.cat([d["prediction"] for d in decoded], dim=1),
            "sample_warped_vid": torch.cat([d["deformed"] for d in decoded], dim=1),
        }
