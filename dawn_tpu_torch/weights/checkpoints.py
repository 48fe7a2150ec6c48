"""Load the released checkpoints into the port's modules, and write the
two that the port's trainers make in the same layouts.

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
  ``opt.yaml`` (written by :func:`save_pbnet_checkpoint`).
- DAWN: ``DAWN_*.pth``, the UNet under ``['diffusion']`` with the
  ``denoise_fn.`` prefix.
- LFG: ``LFG_*.pth``, the generator's part only (``['generator']``), as
  sampling runs no other LFG net; the whole file is
  :func:`lfg_reference_state`'s layout.
- Stage 1's face assets (:func:`load_face_assets`): the 3DDFA-V2 and
  FaceBoxes release files ``FaceBoxesProd.pth``, ``mb1_120x120.pth`` (its
  ``state_dict`` entry unwrapped, ``module.`` stripped), and the two
  pickles ``bfm_noneck_v3.pkl`` and ``param_mean_std_62d_120x120.pkl``,
  read with an unpickler that admits numpy's array reconstruction and
  nothing else. The JAX stage reads the ``.onnx`` graphs exported from them
  through onnxruntime; the port reads the files themselves.
"""

from __future__ import annotations

import json
import os
import pickle
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


def save_pbnet_checkpoint(model: torch.nn.Module, path: str) -> None:
    """A CVAE's state_dict as a bare ``checkpoint_*.pth.tar`` (on the CPU,
    written through a temporary file)."""
    torch.save({k: v.cpu() for k, v in model.state_dict().items()}, path + ".tmp")
    os.replace(path + ".tmp", path)


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


def lfg_reference_state(flow_ae: torch.nn.Module) -> Dict[str, Dict[str, torch.Tensor]]:
    """A port FlowAE's nets in the reference ``LFG_*.pth`` layout:
    {'generator' (with the flow predictor nested as
    ``pixelwise_flow_predictor.*``), 'region_predictor', 'bg_predictor'},
    on the CPU. ``FlowAE.load_reference_checkpoint`` and
    :func:`load_lfg_generator` read it back."""
    def cpu(module, prefix=""):
        return {prefix + k: v.detach().cpu() for k, v in module.state_dict().items()}

    return {"generator": {**cpu(flow_ae.generator),
                          **cpu(flow_ae.pixelwise_flow_predictor, "pixelwise_flow_predictor.")},
            "region_predictor": cpu(flow_ae.region_predictor),
            "bg_predictor": cpu(flow_ae.bg_predictor)}


# ------------------------------------------------------- stage 1's face assets

# the release files, and where a 3DDFA-V2 checkout keeps them
FACE_FILES = {"faceboxes": "FaceBoxesProd.pth", "tddfa": "mb1_120x120.pth",
              "bfm": "bfm_noneck_v3.pkl", "param_mean_std": "param_mean_std_62d_120x120.pkl"}
FACE_DIRS = ("", "weights", os.path.join("FaceBoxes", "weights"), "configs")
# the numpy globals a pickle of arrays needs (numpy 1's and numpy 2's names)
_NUMPY_GLOBALS = {(mod, name) for mod in ("numpy.core.multiarray", "numpy._core.multiarray")
                  for name in ("_reconstruct", "scalar")} | {("numpy", "ndarray"),
                                                             ("numpy", "dtype")}


class _ArrayUnpickler(pickle.Unpickler):
    """Admits numpy's array reconstruction and no other global, so a pickle
    can build arrays, dicts and lists but call nothing else."""

    def find_class(self, module: str, name: str):
        if (module, name) not in _NUMPY_GLOBALS:
            raise pickle.UnpicklingError(f"global {module}.{name} is not allowed in a "
                                         "pickle of numpy arrays")
        return super().find_class(module, name)


def read_array_pickle(path: str) -> Any:
    """A pickle of numpy arrays (dicts, lists, arrays), refusing any other
    global; ``latin1`` reads the arrays of Python 2 pickles."""
    with open(path, "rb") as f:
        return _ArrayUnpickler(f, encoding="latin1").load()


def find_face_files(root: str) -> Dict[str, str]:
    """{asset: path} of the four release files under ``root`` (its top, or
    a 3DDFA-V2 checkout's ``weights/``, ``FaceBoxes/weights/`` and
    ``configs/``); raises FileNotFoundError naming those it lacks."""
    found, missing = {}, []
    for key, name in FACE_FILES.items():
        hits = [os.path.join(root, sub, name) for sub in FACE_DIRS
                if os.path.isfile(os.path.join(root, sub, name))]
        if hits:
            found[key] = hits[0]
        else:
            missing.append(name)
    if missing:
        onnx = sorted(f for f in os.listdir(root) if f.endswith(".onnx")) \
            if os.path.isdir(root) else []
        raise FileNotFoundError(
            f"face assets in {root}: missing {missing}; stage 1 reads the release files "
            f"{sorted(FACE_FILES.values())} at the top of the directory or in a 3DDFA-V2 "
            f"checkout's {[d for d in FACE_DIRS if d]}"
            + (f" (the .onnx graphs {onnx} are not read)" if onnx else ""))
    return found


def _release_state_dict(path: str) -> Dict[str, torch.Tensor]:
    """A release ``.pth``: its ``state_dict`` entry if it has one, with the
    ``module.`` prefix of a DataParallel save stripped."""
    sd = torch.load(path, map_location="cpu", weights_only=True)
    if "state_dict" in sd:
        sd = sd["state_dict"]
    return {(k[len("module."):] if k.startswith("module.") else k): v for k, v in sd.items()}


def load_face_assets(root: str, device=None):
    """Stage 1's assets from the release files under ``root``
    (:func:`find_face_files`) -> a ``pipeline.face_prep.FaceAssets``: the
    FaceBoxes and MobileNet-V1 nets on ``device`` (the card by default),
    the BFM bases (the first 40 shape and 10 expression columns, as the
    reference's BFMModel takes them) and the parameters' mean and std."""
    from dawn_tpu_torch.models.face3d.bfm import BFMReconstructor
    from dawn_tpu_torch.models.face3d.faceboxes_net import FaceBoxesNet
    from dawn_tpu_torch.models.face3d.mobilenet import MobileNetV1
    from dawn_tpu_torch.pipeline.face_prep import FaceAssets

    files = find_face_files(root)
    nets = {}
    for key, module in (("faceboxes", FaceBoxesNet(device=device)),
                        ("tddfa", MobileNetV1(device=device))):
        path = files[key]
        _report(path, load_strict(module, _release_state_dict(path), path))
        nets[key] = module
    bfm = read_array_pickle(files["bfm"])
    ms = read_array_pickle(files["param_mean_std"])
    return FaceAssets(
        faceboxes=nets["faceboxes"], tddfa=nets["tddfa"],
        bfm=BFMReconstructor(np.asarray(bfm["u"]), np.asarray(bfm["w_shp"])[..., :40],
                             np.asarray(bfm["w_exp"])[..., :10], bfm.get("keypoints")),
        param_mean=np.asarray(ms["mean"], np.float32),
        param_std=np.asarray(ms["std"], np.float32))
