"""FlowAE: the four LFG nets, as the DM trainer's frozen teacher.

Port of ``dawn_tpu/models/lfg/flow_ae.py``: the generator, region, background
and pixelwise-flow predictors under the JAX variables' names
(``generator``, ``region_predictor``, ``bg_predictor``,
``pixelwise_flow_predictor``), and ``teacher_outputs``, the deduplicated
teacher pass of the training loss. Defaults are the 128^2 LFG widths of
``configs/lfg_hdtf128.yaml``. BatchNorm runs in train mode only in the nets
whose keyword dict holds ``train_bn=True`` (the LFG trainer's); the teacher
and the pipeline build theirs without it, whatever ``.train()`` says.
``motion_transfer`` reconstructs driving frames by warping their sources,
and ``reconstruct_video`` runs it over a clip against its reference frame
(the DM training snapshot's real decode); the LFG trainer composes the nets
itself.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import torch
from torch import nn

from dawn_tpu_torch.models.lfg.bg_predictor import BGMotionPredictor
from dawn_tpu_torch.models.lfg.generator import LFGGenerator
from dawn_tpu_torch.models.lfg.pixelwise_flow import PixelwiseFlowPredictor
from dawn_tpu_torch.models.lfg.region_predictor import RegionPredictor
from dawn_tpu_torch.models.lfg.warp import anti_alias_downsample


class FlowAE(nn.Module):
    def __init__(self, num_regions: int = 10, revert_axis_swap: bool = True,
                 generator_kw: Optional[Dict[str, Any]] = None,
                 region_kw: Optional[Dict[str, Any]] = None,
                 bg_kw: Optional[Dict[str, Any]] = None,
                 flow_kw: Optional[Dict[str, Any]] = None):
        super().__init__()
        self.generator = LFGGenerator(**(generator_kw or {}))
        self.region_predictor = RegionPredictor(num_regions=num_regions, **(region_kw or {}))
        self.bg_predictor = BGMotionPredictor(**(bg_kw or {}))
        self.pixelwise_flow_predictor = PixelwiseFlowPredictor(
            num_regions=num_regions, revert_axis_swap=revert_axis_swap, **(flow_kw or {}))

    def load_reference_checkpoint(self, path: str) -> None:
        """Load a reference ``LFG_*.pth`` ({'generator', 'region_predictor',
        'bg_predictor'} state_dicts; the flow predictor sits under
        ``generator.pixelwise_flow_predictor``). Every parameter and running
        statistic of the port must be in the file; its other entries (the
        anti-alias kernels the port builds itself) are skipped."""
        from dawn_tpu_torch.weights.checkpoints import load_strict

        ckpt = torch.load(path, map_location="cpu", weights_only=True)
        flow_prefix = "pixelwise_flow_predictor."
        gen = ckpt["generator"]
        parts = {
            self.generator: {k: v for k, v in gen.items() if not k.startswith(flow_prefix)},
            self.pixelwise_flow_predictor: {k[len(flow_prefix):]: v for k, v in gen.items()
                                            if k.startswith(flow_prefix)},
            self.region_predictor: ckpt["region_predictor"],
            self.bg_predictor: ckpt["bg_predictor"],
        }
        for module, sd in parts.items():
            load_strict(module, sd, path)

    def motion_transfer(self, source: torch.Tensor, driving: torch.Tensor
                        ) -> Dict[str, torch.Tensor]:
        """Reconstruction of the (N, H, W, 3) ``driving`` frames by warping
        their ``source`` frames: 'optical_flow', 'occlusion_map',
        'prediction', 'deformed', 'bottle_neck_feat' and the region and
        background parameters."""
        src_params = self.region_predictor(source)
        drv_params = self.region_predictor(driving)
        bg = self.bg_predictor(source, driving)
        motion = self.pixelwise_flow_predictor(source, drv_params, src_params, bg)
        out = self.generator(source, motion)
        return {**out, "source_region_params": src_params,
                "driving_region_params": drv_params, "bg_params": bg}

    def reconstruct_video(self, ref_img: torch.Tensor, video: torch.Tensor
                          ) -> Dict[str, torch.Tensor]:
        """:meth:`motion_transfer` of every frame of a (B, T, H, W, 3) video
        from its (B, H, W, 3) reference, all B*T frames in one batch: the
        teacher tensors of :meth:`teacher_outputs` plus 'real_out_vid' and
        'real_warped_vid' (B, T, H, W, 3)."""
        b, t, h, w, c = video.shape
        src = ref_img[:, None].expand(b, t, h, w, c).reshape(b * t, h, w, c)
        out = self.motion_transfer(src, video.reshape(b * t, h, w, c))
        ls = out["optical_flow"].shape[1]
        return {
            "real_vid_grid": out["optical_flow"].reshape(b, t, ls, ls, 2),
            "real_vid_conf": out["occlusion_map"].reshape(b, t, ls, ls, 1),
            "real_out_vid": out["prediction"].reshape(b, t, h, w, c),
            "real_warped_vid": out["deformed"].reshape(b, t, h, w, c),
            "ref_img_fea": out["bottle_neck_feat"].reshape(b, t, ls, ls, -1)[:, 0],
        }

    def teacher_outputs(self, ref_img: torch.Tensor, video: torch.Tensor
                        ) -> Dict[str, torch.Tensor]:
        """The three teacher tensors of the DM training loss for a (B, T, H,
        W, 3) video in [0, 1] and its (B, H, W, 3) reference frames:
        'real_vid_grid' (B, T, h, w, 2), 'real_vid_conf' (B, T, h, w, 1) and
        'ref_img_fea' (B, h, w, 256).

        The per-video work runs once per video, not once per frame: the
        region parameters of the reference, its anti-aliased downsample for
        the flow predictor, and its generator feature (``compute_fea``). The
        per-frame work (driving regions, background transform, dense flow)
        runs on all B*T frames at once."""
        b, t, h, w, c = video.shape
        drv = video.reshape(b * t, h, w, c)
        src_rep = ref_img[:, None].expand(b, t, h, w, c).reshape(b * t, h, w, c)
        src_params = {k: v.repeat_interleave(t, dim=0)
                      for k, v in self.region_predictor(ref_img).items()}
        drv_params = self.region_predictor(drv)
        bg = self.bg_predictor(src_rep, drv)
        sf = self.pixelwise_flow_predictor.scale_factor
        src_small = anti_alias_downsample(ref_img, sf) if sf != 1 else ref_img
        motion = self.pixelwise_flow_predictor(
            src_small.repeat_interleave(t, dim=0), drv_params, src_params, bg,
            source_downsampled=True)
        fea = self.generator.compute_fea(ref_img)
        ls = motion["optical_flow"].shape[1]
        return {
            "real_vid_grid": motion["optical_flow"].reshape(b, t, ls, ls, 2),
            "real_vid_conf": motion["occlusion_map"].reshape(b, t, ls, ls, 1),
            "ref_img_fea": fea,
        }
