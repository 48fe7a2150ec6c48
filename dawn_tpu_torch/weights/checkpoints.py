"""Load the released checkpoints into the port's modules.

Every file is read with ``torch.load(weights_only=True)``; nothing needs
``transformers``. Each loader is strict about what the port models: an
entry of the module that the file lacks raises ``KeyError`` naming it. File
entries the port does not model are skipped, and each loader returns their
names (the reference's rotary ``freqs`` buffers, the recomputed sinusoidal
``pe`` tables, HuBERT's CTC head).

- HuBERT: an HF model directory (``config.json`` + ``pytorch_model.bin``),
  a ``HubertModel`` or ``HubertForCTC`` checkpoint (``hubert.`` prefix
  stripped, ``lm_head.*`` and ``masked_spec_embed`` skipped); the position
  conv's weight norm in either layout (``weight_g``/``weight_v`` or
  ``parametrizations.weight.original0/1``) folded into its kernel.
- PBnet: ``checkpoint_*.pth.tar``, a bare CVAE state_dict beside its
  ``opt.yaml``.
- DAWN: ``DAWN_*.pth``, the UNet under ``['diffusion']`` with the
  ``denoise_fn.`` prefix.
- LFG: ``LFG_*.pth``, the generator's part only (``['generator']``), as
  sampling runs no other LFG net.
"""

from __future__ import annotations

import json
import os
from typing import Any, Dict, List, Mapping, Tuple

import numpy as np
import torch

from dawn_tpu_torch.models.hubert.model import HubertConfig, HubertModel

# entries of the reference files that the port computes itself
_RECOMPUTED = ("rotary_emb.freqs", ".pe")


def load_strict(module: torch.nn.Module, sd: Mapping[str, Any], source: str,
                extra_ok: bool = True) -> List[str]:
    """Copy ``sd`` (tensors, or numpy arrays taken as f32) into ``module``:
    every entry of the module must be in ``sd`` with its shape (BatchNorm's
    ``num_batches_tracked`` may be absent; a channel LayerNorm ``gamma`` may
    come in any shape of the same size, as the reference keeps (1, C, ...)).
    Returns the entries of ``sd`` the module does not hold, sorted; with
    ``extra_ok=False`` they raise ``KeyError`` instead."""
    own = module.state_dict()
    missing = [k for k in own if k not in sd and not k.endswith("num_batches_tracked")]
    extra = sorted(k for k in sd if k not in own)
    if missing or (extra and not extra_ok):
        raise KeyError(f"{source}: missing {len(missing)} entries, e.g. {missing[:8]}"
                       + (f"; unexpected {extra[:8]}" if extra and not extra_ok else ""))
    with torch.no_grad():
        for k, mine in own.items():
            if k not in sd:
                continue
            v = sd[k]
            v = v if isinstance(v, torch.Tensor) else torch.from_numpy(
                np.array(v, dtype=np.float32))
            if v.shape != mine.shape and not (k.endswith(".gamma")
                                              and v.numel() == mine.numel()):
                raise ValueError(f"{source}: {k} has shape {tuple(v.shape)}, "
                                 f"the port {tuple(mine.shape)}")
            mine.copy_(v.reshape(mine.shape))
    return extra


def _report(source: str, skipped: List[str]) -> List[str]:
    if skipped:
        recomputed = [k for k in skipped if k.endswith(_RECOMPUTED)]
        other = [k for k in skipped if k not in recomputed]
        print(f"[weights] {source}: skipped {len(recomputed)} recomputed buffers"
              + (f" and {len(other)} entries the port does not model: {other[:8]}"
                 if other else ""))
    return skipped


# ------------------------------------------------------------------ HuBERT

_HUBERT_FIELDS = ("hidden_size", "num_hidden_layers", "num_attention_heads",
                  "intermediate_size", "conv_dim", "conv_kernel", "conv_stride", "conv_bias",
                  "feat_extract_norm", "do_stable_layer_norm", "num_conv_pos_embeddings",
                  "num_conv_pos_embedding_groups", "layer_norm_eps")


def hubert_config_from_json(cfg: Mapping) -> HubertConfig:
    """An HF ``config.json`` dict -> HubertConfig (absent fields keep the
    hubert-large defaults)."""
    kw = {k: (tuple(cfg[k]) if isinstance(cfg[k], list) else cfg[k])
          for k in _HUBERT_FIELDS if k in cfg}
    return HubertConfig(**kw)


def hubert_state_dict_from_hf(sd: Mapping[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """An HF HubertModel / HubertForCTC state_dict -> the port's names: the
    ``hubert.`` prefix stripped and the position conv's weight norm folded
    (w = g * v / |v|, the norm over all but the kernel axis, HF's dim=2).
    Other entries pass through for :func:`load_strict` to skip."""
    out = {(k[len("hubert."):] if k.startswith("hubert.") else k): v for k, v in sd.items()}
    conv = "encoder.pos_conv_embed.conv"
    for g_key, v_key in ((f"{conv}.weight_g", f"{conv}.weight_v"),
                         (f"{conv}.parametrizations.weight.original0",
                          f"{conv}.parametrizations.weight.original1")):
        if v_key in out:
            g, v = out.pop(g_key).float(), out.pop(v_key).float()
            out[f"{conv}.weight"] = g * v / v.square().sum(dim=(0, 1), keepdim=True).sqrt()
    return out


def load_hubert_dir(model_dir: str, device=None) -> Tuple[HubertModel, List[str]]:
    """An HF HuBERT directory -> (the port's HubertModel with its weights,
    the skipped entries)."""
    with open(os.path.join(model_dir, "config.json")) as f:
        config = hubert_config_from_json(json.load(f))
    path = os.path.join(model_dir, "pytorch_model.bin")
    sd = hubert_state_dict_from_hf(torch.load(path, map_location="cpu", weights_only=True))
    model = HubertModel(config, device=device)
    return model, _report(path, load_strict(model, sd, path))


# ------------------------------------------------------------------- PBnet

def load_pbnet_checkpoint(model: torch.nn.Module, path: str) -> List[str]:
    """A PBnet ``checkpoint_*.pth.tar`` (bare state_dict) into a port CVAE;
    returns the skipped entries (the sinusoidal ``pe`` tables, rotary
    ``freqs``)."""
    sd = torch.load(path, map_location="cpu", weights_only=True)
    return _report(path, load_strict(model, sd, path))


# -------------------------------------------------------------- DAWN, LFG

def load_dawn_checkpoint(unet: torch.nn.Module, path: str) -> List[str]:
    """A ``DAWN_*.pth`` into the port's Unet3D: ``['diffusion']``'s
    ``denoise_fn.*`` entries (the schedule buffers beside them are
    recomputed); returns the skipped entries (the rotary ``freqs``)."""
    ckpt = torch.load(path, map_location="cpu", weights_only=True)
    prefix = "denoise_fn."
    sd = {k[len(prefix):]: v for k, v in ckpt["diffusion"].items() if k.startswith(prefix)}
    return _report(path, load_strict(unet, sd, path))


def load_lfg_generator(model: torch.nn.Module, path: str) -> List[str]:
    """The ``['generator']`` entry of an ``LFG_*.pth`` into a port
    FlowDiffusion's generator, the only LFG net sampling runs; returns the
    skipped entries (the flow predictor the reference nests there as
    ``pixelwise_flow_predictor.*``)."""
    ckpt = torch.load(path, map_location="cpu", weights_only=True)
    return _report(path, load_strict(model.generator, ckpt["generator"], path))
