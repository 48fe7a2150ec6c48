"""Carry the JAX package's FlowDiffusion variables into the port.

``load_flow_diffusion_variables(model, variables)`` takes the variables as
nested dicts of numpy arrays, ``{'unet': {'params'}, 'generator': {'params',
'batch_stats'}, 'face_loc': {'params'}}``, and fills a port ``FlowDiffusion``.
``load_flow_ae_variables`` fills a port ``FlowAE`` from the JAX FlowAE
variables (generator, region, background and pixelwise-flow predictors), and
``load_dm_trainer_variables`` a port ``DMTrainer`` from the UNet params, the
frozen teacher and mask-encoder variables and, optionally, the EMA params of
a JAX trainer state. ``load_lfg_trainer_variables`` fills a port LFGTrainer
from the LFG trainer's params, batch_stats and VGG variables
(``vgg19_state_dict``: torchvision's names), and
``load_pbnet_trainer_variables`` a port PBnetTrainer from the PBnet G and
``PatchGAN1D`` variables. ``hubert_state_dict`` and ``pbnet_state_dict`` turn
the JAX HuBERT params and PBnet CVAE variables into the port's state_dicts,
and
``faceboxes_state_dict``, ``mobilenet_state_dict``,
``mobilenet_v3_state_dict`` and ``resnet22_state_dict`` stage 1's face nets
(params and batch_stats) into the release files' layouts.
It is the inverse of the reference-checkpoint converters of the JAX package
(``dawn_tpu/weights/torch_convert.py``, ``hubert_convert.py``), written anew
here:

- Dense (in, out) -> Linear.weight (out, in); LayerNorm scale, bias ->
  weight, bias;
- HWIO conv -> OIHW, or (O, I, 1, kh, kw) for the UNet's per-frame Conv3d;
  (k, I, O) conv1d -> (O, I, k);
- the pre-flipped HWIO Upsample kernel -> ConvTranspose3d (I, O, 1, kh, kw);
- GroupNorm / BatchNorm scale, bias -> weight, bias; BatchNorm mean, var ->
  running_mean, running_var;
- channel LayerNorm gamma -> (1, C, 1, 1, 1) ``gamma`` or (C,) ``g``.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping, Optional

import numpy as np
import torch

from dawn_tpu_torch.models.lfg.vgg import VGG19_CONVS
from dawn_tpu_torch.ops.convs import unflip_conv_transpose_weight
from dawn_tpu_torch.weights.checkpoints import load_strict

StateDict = Dict[str, np.ndarray]


def _dense(p: Mapping[str, Any]) -> StateDict:
    sd = {"weight": np.asarray(p["kernel"]).T}
    if "bias" in p:
        sd["bias"] = np.asarray(p["bias"])
    return sd


def _conv2d(p: Mapping[str, Any]) -> StateDict:
    sd = {"weight": np.transpose(np.asarray(p["kernel"]), (3, 2, 0, 1))}
    if "bias" in p:
        sd["bias"] = np.asarray(p["bias"])
    return sd


def _conv3d(p: Mapping[str, Any]) -> StateDict:
    sd = _conv2d(p)
    sd["weight"] = sd["weight"][:, :, None]
    return sd


def _norm(p: Mapping[str, Any]) -> StateDict:
    return {"weight": np.asarray(p["scale"]), "bias": np.asarray(p["bias"])}


def _under(prefix: str, sd: StateDict) -> StateDict:
    return {f"{prefix}.{k}": v for k, v in sd.items()}


def _cross_attn(p: Mapping[str, Any]) -> StateDict:
    sd = {"norm.g": np.asarray(p["norm"]["gamma"]),
          "to_out.1.g": np.asarray(p["out_norm"]["gamma"]),
          **_under("to_q", _dense(p["to_q"])), **_under("to_kv", _dense(p["to_kv"])),
          **_under("to_out.0", _dense(p["to_out"]))}
    for name in ("null_kv", "q_scale", "k_scale"):
        sd[name] = np.asarray(p[name])
    return sd


def _resnet(p: Mapping[str, Any]) -> StateDict:
    sd: StateDict = {}
    for blk in ("block1", "block2"):
        sd.update(_under(f"{blk}.proj", _conv3d(p[blk]["proj"])))
        sd.update(_under(f"{blk}.norm", _norm(p[blk]["norm"])))
    for mlp in ("time_mlp", "audio_mlp", "pose_mlp", "eye_mlp"):
        if mlp in p:
            sd.update(_under(f"{mlp}.1", _dense(p[mlp])))
    for branch in ("aud", "pose", "eye"):
        if f"cross_attn_{branch}" in p:
            sd.update(_under(f"cross_attn_{branch}", _cross_attn(p[f"cross_attn_{branch}"])))
    if "res_conv" in p:
        sd.update(_under("res_conv", _conv3d(p["res_conv"])))
    return sd


def attention_block_state_dict(p: Mapping[str, Any]) -> StateDict:
    """Params of the JAX ``PreNormResidualTemporal`` / ``PreNormResidualSpatialFull``
    -> the port's Residual(PreNorm(ToTokens(attention))) block."""
    return {"fn.norm.gamma": np.asarray(p["norm"]["gamma"]).reshape(1, -1, 1, 1, 1),
            **_under("fn.fn.fn.to_qkv", _dense(p["attn"]["to_qkv"])),
            **_under("fn.fn.fn.to_out", _dense(p["attn"]["to_out"]))}


def _spatial_linear(p: Mapping[str, Any]) -> StateDict:
    return {"fn.norm.gamma": np.asarray(p["norm"]["gamma"]).reshape(1, -1, 1, 1, 1),
            **_under("fn.fn.to_qkv", _conv2d(p["attn"]["to_qkv"])),
            **_under("fn.fn.to_out", _conv2d(p["attn"]["to_out"]))}


def unet_state_dict(params: Mapping[str, Any]) -> StateDict:
    """The JAX Unet3D params -> the port's (reference-named) state_dict."""
    sd: StateDict = {
        "time_rel_pos_bias.relative_attention_bias.weight":
            np.asarray(params["time_rel_pos_bias"]),
        **_under("init_conv", _conv3d(params["init_conv"])),
        **_under("init_temporal_attn",
                 attention_block_state_dict(params["init_temporal_attn"])),
        **_under("time_mlp.1", _dense(params["time_mlp_1"])),
        **_under("time_mlp.3", _dense(params["time_mlp_2"])),
        **_under("mid_block1", _resnet(params["mid_block1"])),
        **_under("mid_spatial_attn", attention_block_state_dict(params["mid_spatial_attn"])),
        **_under("mid_temporal_attn",
                 attention_block_state_dict(params["mid_temporal_attn"])),
        **_under("mid_block2", _resnet(params["mid_block2"])),
        **_under("final_conv.0", _resnet(params["final_block"])),
        **_under("final_conv.1", _conv3d(params["final_conv"])),
        **_under("occlusion_map.0", _resnet(params["occlusion_block"])),
        **_under("occlusion_map.1", _conv3d(params["occlusion_conv"])),
    }
    i = 0
    while f"down_{i}_block1" in params:
        for side, key in (("down", "downs"), ("up", "ups")):
            sd.update(_under(f"{key}.{i}.0", _resnet(params[f"{side}_{i}_block1"])))
            sd.update(_under(f"{key}.{i}.1", _resnet(params[f"{side}_{i}_block2"])))
            sd.update(_under(f"{key}.{i}.2", _spatial_linear(params[f"{side}_{i}_spatial"])))
            sd.update(_under(f"{key}.{i}.3",
                             attention_block_state_dict(params[f"{side}_{i}_temporal"])))
        if f"down_{i}_downsample" in params:
            sd.update(_under(f"downs.{i}.4", _conv3d(params[f"down_{i}_downsample"]["conv"])))
        if f"up_{i}_upsample" in params:
            up = params[f"up_{i}_upsample"]
            sd[f"ups.{i}.4.weight"] = unflip_conv_transpose_weight(up["kernel"])[:, :, None]
            sd[f"ups.{i}.4.bias"] = np.asarray(up["bias"])
        i += 1
    return sd


def _lfg_block(p: Mapping[str, Any], s: Mapping[str, Any]) -> StateDict:
    sd: StateDict = {}
    for name in p:
        if name.startswith("conv"):
            sd.update(_under(name, _conv2d(p[name])))
        else:
            sd.update(_under(name, _norm(p[name])))
            sd[f"{name}.running_mean"] = np.asarray(s[name]["mean"])
            sd[f"{name}.running_var"] = np.asarray(s[name]["var"])
    return sd


def generator_state_dict(variables: Mapping[str, Any]) -> StateDict:
    """LFGGenerator {params, batch_stats} -> the port's state_dict."""
    params, stats = variables["params"], variables["batch_stats"]
    sd: StateDict = {}
    for name in params:
        if name == "final":
            sd.update(_under("final", _conv2d(params[name])))
            continue
        prefix, _, idx = name.rpartition("_")
        key = {"down_blocks": f"down_blocks.{idx}", "up_blocks": f"up_blocks.{idx}",
               "bottleneck": f"bottleneck.r{idx}"}.get(prefix, name)
        sd.update(_under(key, _lfg_block(params[name], stats[name])))
    return sd


def _hourglass(p: Mapping[str, Any], s: Mapping[str, Any]) -> StateDict:
    """JAX Hourglass / HourglassEncoder {'encoder': {'down_i'}, 'decoder':
    {'up_j'}} -> encoder.down_blocks.{i}, decoder.up_blocks.{j}."""
    sd: StateDict = {}
    for part, blocks, name in (("encoder", "down_blocks", "down"),
                               ("decoder", "up_blocks", "up")):
        for key in p.get(part, {}):
            idx = key.rpartition("_")[2]
            sd.update(_under(f"{part}.{blocks}.{idx}",
                             _lfg_block(p[part][key], s[part][key])))
    return sd


def region_predictor_state_dict(variables: Mapping[str, Any]) -> StateDict:
    p, s = variables["params"], variables["batch_stats"]
    return {**_under("predictor", _hourglass(p["predictor"], s["predictor"])),
            **_under("regions", _conv2d(p["regions"]))}


def bg_predictor_state_dict(variables: Mapping[str, Any]) -> StateDict:
    p, s = variables["params"], variables["batch_stats"]
    return {**_hourglass({"encoder": p["encoder"]}, {"encoder": s["encoder"]}),
            **_under("fc", _dense(p["fc"]))}


def pixelwise_flow_state_dict(variables: Mapping[str, Any]) -> StateDict:
    p, s = variables["params"], variables["batch_stats"]
    return {**_under("hourglass", _hourglass(p["hourglass"], s["hourglass"])),
            **_under("mask", _conv2d(p["mask"])),
            **_under("occlusion", _conv2d(p["occlusion"]))}


def vgg19_state_dict(variables: Mapping[str, Any]) -> StateDict:
    """The JAX Vgg19Features variables {'params': {'conv_<pos>'}} ->
    torchvision's ``features.<pos>.*`` names (the inverse of
    ``convert_vgg19_features``)."""
    sd: StateDict = {}
    for pos, _ in VGG19_CONVS:
        sd.update(_under(f"features.{pos}", _conv2d(variables["params"][f"conv_{pos}"])))
    return sd


def face_loc_state_dict(variables: Mapping[str, Any]) -> StateDict:
    return {**_under("conv1", _conv2d(variables["params"]["conv1"])),
            **_under("conv2", _conv2d(variables["params"]["conv2"]))}


def _conv1d(p: Mapping[str, Any]) -> StateDict:
    sd = {"weight": np.transpose(np.asarray(p["kernel"]), (2, 1, 0))}
    if "bias" in p:
        sd["bias"] = np.asarray(p["bias"])
    return sd


def hubert_state_dict(params: Mapping[str, Any]) -> StateDict:
    """The JAX HubertModel params -> the port's (HF-named) state_dict; the
    position conv's kernel is the effective one (no weight norm)."""
    fe = params["feature_extractor"]
    sd: StateDict = {
        **_under("feature_projection.layer_norm", _norm(params["fp_layer_norm"])),
        **_under("feature_projection.projection", _dense(params["fp_projection"])),
        **_under("encoder.pos_conv_embed.conv", _conv1d(params["pos_conv_embed"]["conv"])),
        **_under("encoder.layer_norm", _norm(params["encoder_layer_norm"])),
    }
    i = 0
    while f"conv_{i}" in fe:
        pfx = f"feature_extractor.conv_layers.{i}"
        sd.update(_under(f"{pfx}.conv", _conv1d(fe[f"conv_{i}"])))
        norm = fe.get(f"layer_norm_{i}", fe.get("group_norm") if i == 0 else None)
        if norm is not None:
            sd.update(_under(f"{pfx}.layer_norm", _norm(norm)))
        i += 1
    i = 0
    while f"layers_{i}" in params:
        lp, pfx = params[f"layers_{i}"], f"encoder.layers.{i}"
        for name in ("q_proj", "k_proj", "v_proj", "out_proj"):
            sd.update(_under(f"{pfx}.attention.{name}", _dense(lp[name])))
        for name in ("intermediate_dense", "output_dense"):
            sd.update(_under(f"{pfx}.feed_forward.{name}", _dense(lp[name])))
        for name in ("layer_norm", "final_layer_norm"):
            sd.update(_under(f"{pfx}.{name}", _norm(lp[name])))
        i += 1
    return sd


def _pbnet_encoder(p: Mapping[str, Any]) -> StateDict:
    sd: StateDict = {}
    for name in ("firstposeEmbedding", "poseEmbedding", "audioEmbedding", "mu_layer",
                 "sigma_layer"):
        sd.update(_under(name, _dense(p[name])))
    i = 0
    while f"layers_{i}" in p:
        lp, pfx = p[f"layers_{i}"], f"seqTransEncoder.layers.{i}"
        sd[f"{pfx}.self_attn.in_proj_weight"] = np.asarray(lp["in_proj"]["kernel"]).T
        sd[f"{pfx}.self_attn.in_proj_bias"] = np.asarray(lp["in_proj"]["bias"])
        sd.update(_under(f"{pfx}.self_attn.out_proj", _dense(lp["out_proj"])))
        for name in ("linear1", "linear2"):
            sd.update(_under(f"{pfx}.{name}", _dense(lp[name])))
        for name in ("norm1", "norm2"):
            sd.update(_under(f"{pfx}.{name}", _norm(lp[name])))
        i += 1
    return sd


def _pbnet_decoder(p: Mapping[str, Any]) -> StateDict:
    sd: StateDict = {"init_temporal_attn.fn.norm.gamma": np.asarray(p["init_attn_norm_gamma"])}
    for name in ("firstposeEmbedding", "audioEmbedding", "ztimelinear", "init_proj",
                 "finallayer"):
        sd.update(_under(name, _dense(p[name])))
    for name in ("time_rel_pos_bias_tgt", "time_rel_pos_bias_mem"):
        sd[f"{name}.relative_attention_bias.weight"] = np.asarray(
            p[name]["relative_attention_bias"])
    for name in ("to_qkv", "to_out"):
        sd.update(_under(f"init_temporal_attn.fn.fn.{name}",
                         _dense(p["init_temporal_attn"][name])))
    i = 0
    while f"decoder_layers_{i}" in p:
        lp, pfx = p[f"decoder_layers_{i}"], f"seqTransDecoder.decoder_layers.{i}"
        for name in ("to_qkv", "to_out"):
            sd.update(_under(f"{pfx}.self_attn.{name}", _dense(lp["self_attn"][name])))
        for name in ("to_q", "to_k", "to_v", "to_out"):
            sd.update(_under(f"{pfx}.multihead_attn.{name}",
                             _dense(lp["multihead_attn"][name])))
        for j in (1, 2):
            sd.update(_under(f"{pfx}.ffn.linear{j}", _dense(lp[f"ffn_linear{j}"])))
        for j in (1, 2, 3):
            sd.update(_under(f"{pfx}.layer_norm{j}", _norm(lp[f"layer_norm{j}"])))
        i += 1
    return sd


def pbnet_state_dict(variables: Mapping[str, Any]) -> StateDict:
    """The JAX PBnet CVAE variables {'encoder': {'params'}, 'decoder':
    {'params'}} (the reemb family) -> the port's (reference-named)
    state_dict."""
    return {**_under("encoder", _pbnet_encoder(variables["encoder"]["params"])),
            **_under("decoder", _pbnet_decoder(variables["decoder"]["params"]))}


def patchgan_state_dict(variables: Mapping[str, Any]) -> StateDict:
    """The JAX ``PatchGAN1D`` variables {'params': {'conv1'..'conv4',
    'norm2', 'norm3'}} -> the port's state_dict."""
    p = variables["params"]
    sd = {**_under("norm2", _norm(p["norm2"])), **_under("norm3", _norm(p["norm3"]))}
    for i in range(1, 5):
        sd.update(_under(f"conv{i}", _conv1d(p[f"conv{i}"])))
    return sd


# ------------------------------------------------------- stage 1's face nets

def _bn(p: Mapping[str, Any], s: Mapping[str, Any]) -> StateDict:
    """Flax BatchNorm params + batch_stats -> BatchNorm2d's entries."""
    return {**_norm(p), "running_mean": np.asarray(s["mean"]),
            "running_var": np.asarray(s["var"])}


def _conv_bn(p: Mapping[str, Any], s: Mapping[str, Any], conv: str, bn: str,
             to_conv: str, to_bn: str) -> StateDict:
    return {**_under(to_conv, _conv2d(p[conv])), **_under(to_bn, _bn(p[bn], s[bn]))}


def faceboxes_state_dict(variables: Mapping[str, Any]) -> StateDict:
    """The JAX FaceBoxesNet {params, batch_stats} -> the port's (the release
    file's) state_dict: conv1/conv2 ``convbn`` -> ``conv1.conv``/``.bn``,
    inception branches and conv3_*/conv4_* ``conv``/``bn``, ``loc_i`` ->
    ``loc.i``, ``conf_i`` -> ``conf.i``."""
    p, s = variables["params"], variables["batch_stats"]
    sd: StateDict = {}
    for name in ("conv1", "conv2"):
        sd.update(_under(name, _conv_bn(p[name]["convbn"], s[name]["convbn"], "conv", "bn",
                                        "conv", "bn")))
    for name in p:
        if name.startswith("inception"):
            for br in p[name]:
                sd.update(_under(f"{name}.{br}",
                                 _conv_bn(p[name][br], s[name][br], "conv", "bn", "conv", "bn")))
        elif name.startswith(("conv3_", "conv4_")):
            sd.update(_under(name, _conv_bn(p[name], s[name], "conv", "bn", "conv", "bn")))
        elif name.startswith(("loc_", "conf_")):
            head, _, i = name.partition("_")
            sd.update(_under(f"{head}.{i}", _conv2d(p[name])))
    return sd


def mobilenet_state_dict(variables: Mapping[str, Any]) -> StateDict:
    """The JAX MobileNetV1 {params, batch_stats} -> the reference
    ``mobilenet_1`` state_dict (any widen factor): the inverse of
    ``convert_mobilenet``."""
    p, s = variables["params"], variables["batch_stats"]
    sd = {**_under("conv1", _conv2d(p["conv1"])), **_under("bn1", _bn(p["bn1"], s["bn1"])),
          **_under("fc", _dense(p["fc"]))}
    for name in p:
        if name.startswith("dw"):
            for conv, bn in (("conv_dw", "bn_dw"), ("conv_sep", "bn_sep")):
                sd.update(_under(name, _conv_bn(p[name], s[name], conv, bn, conv, bn)))
    return sd


def mobilenet_v3_state_dict(variables: Mapping[str, Any]) -> StateDict:
    """The JAX MobileNetV3 {params, batch_stats} -> the reference
    state_dict (small or large): the inverse of ``convert_mobilenet_v3``."""
    p, s = variables["params"], variables["batch_stats"]
    blocks = sum(1 for name in p if name.startswith("b") and name[1:].isdigit())
    t = 1 + blocks
    sd = {**_conv_bn(p, s, "stem", "stem_bn", "features.0.0", "features.0.1"),
          **_conv_bn(p, s, "tail", "tail_bn", f"features.{t}.0", f"features.{t}.1"),
          **_under(f"features.{t + 2}", _conv2d(p["head"])), **_under("fc", _dense(p["fc"]))}
    for i in range(blocks):
        bp, bs, pre = p[f"b{i}"], s[f"b{i}"], f"features.{1 + i}.conv"
        for conv, idx in (("pw", 0), ("dw", 3), ("pw_lin", 7)):
            sd.update(_conv_bn(bp, bs, conv, f"{conv}_bn", f"{pre}.{idx}", f"{pre}.{idx + 1}"))
        if "se" in bp:
            sd[f"{pre}.5.fc.0.weight"] = np.asarray(bp["se"]["fc1"]["kernel"]).T
            sd[f"{pre}.5.fc.2.weight"] = np.asarray(bp["se"]["fc2"]["kernel"]).T
    return sd


def resnet22_state_dict(variables: Mapping[str, Any]) -> StateDict:
    """The JAX ResNet22 {params, batch_stats} -> the reference state_dict:
    the inverse of ``convert_resnet22``."""
    p, s = variables["params"], variables["batch_stats"]
    sd = {**_conv_bn(p, s, "conv1", "bn1", "conv1", "bn1"),
          **_conv_bn(p, s, "conv2", "bn2", "conv2", "bn2"),
          **_under("conv_param", _conv2d(p["conv_param"]))}
    for name in p:
        if name.startswith("layer"):
            layer, _, bi = name.partition("_")
            pre = f"{layer}.{bi}"
            for conv, bn in (("conv1", "bn1"), ("conv2", "bn2")):
                sd.update(_under(pre, _conv_bn(p[name], s[name], conv, bn, conv, bn)))
            if "down_conv" in p[name]:
                sd.update(_under(pre, _conv_bn(p[name], s[name], "down_conv", "down_bn",
                                               "downsample.0", "downsample.1")))
    return sd


def load_state(module: torch.nn.Module, sd: StateDict) -> None:
    """Copy ``sd`` into ``module``; every parameter and statistic must be
    covered (only BatchNorm's num_batches_tracked has no JAX counterpart),
    and ``sd`` may hold nothing else."""
    load_strict(module, sd, "JAX parameters", extra_ok=False)


def load_flow_diffusion_variables(model, variables: Mapping[str, Any]) -> None:
    """Fill a port FlowDiffusion in place from the JAX variables tree."""
    load_state(model.unet, unet_state_dict(variables["unet"]["params"]))
    load_state(model.generator, generator_state_dict(variables["generator"]))
    load_state(model.face_loc, face_loc_state_dict(variables["face_loc"]))


def load_flow_ae_variables(flow_ae, variables: Mapping[str, Any]) -> None:
    """Fill a port FlowAE in place from the JAX FlowAE variables tree
    {generator, region_predictor, bg_predictor, pixelwise_flow_predictor}."""
    load_state(flow_ae.generator, generator_state_dict(variables["generator"]))
    load_state(flow_ae.region_predictor,
               region_predictor_state_dict(variables["region_predictor"]))
    load_state(flow_ae.bg_predictor, bg_predictor_state_dict(variables["bg_predictor"]))
    load_state(flow_ae.pixelwise_flow_predictor,
               pixelwise_flow_state_dict(variables["pixelwise_flow_predictor"]))


def load_lfg_trainer_variables(trainer, params: Mapping[str, Any],
                               batch_stats: Mapping[str, Any],
                               vgg_variables: Optional[Mapping[str, Any]] = None) -> None:
    """Fill a port LFGTrainer from a JAX LFG trainer state: ``state['params']``
    and ``state['batch_stats']`` (per net) and, when given, ``state['vgg']``."""
    load_flow_ae_variables(trainer.flow_ae, {k: {"params": params[k],
                                                 "batch_stats": batch_stats[k]}
                                             for k in params})
    if vgg_variables is not None:
        load_state(trainer.vgg, vgg19_state_dict(vgg_variables))


def load_pbnet_trainer_variables(trainer, g_variables: Mapping[str, Any],
                                 d_variables: Mapping[str, Any]) -> None:
    """Fill a port PBnetTrainer from the JAX PBnet trainer's G (the CVAE
    variables; the JAX state keeps them raveled: pass them unraveled) and D
    (``PatchGAN1D``) variables."""
    load_state(trainer.model, pbnet_state_dict(g_variables))
    load_state(trainer.disc, patchgan_state_dict(d_variables))


def load_dm_trainer_variables(trainer, unet_params: Mapping[str, Any],
                              lfg_variables: Mapping[str, Any],
                              face_loc_variables: Mapping[str, Any],
                              ema_params: Optional[Mapping[str, Any]] = None) -> None:
    """Fill a port DMTrainer from a JAX trainer state: the UNet params tree
    (the JAX state keeps them raveled; pass them unraveled), the frozen
    ``state['frozen']['lfg']`` and ``['face_loc']`` variables and, when
    given, the unraveled EMA params."""
    load_state(trainer.unet, unet_state_dict(unet_params))
    load_flow_ae_variables(trainer.flow_ae, lfg_variables)
    load_state(trainer.face_loc, face_loc_state_dict(face_loc_variables))
    if ema_params is not None and trainer.ema is not None:
        sd = unet_state_dict(ema_params)
        names = [name for name, _ in trainer.unet.named_parameters()]
        with torch.no_grad():
            for e, name in zip(trainer.ema, names):
                e.copy_(torch.from_numpy(np.ascontiguousarray(sd[name], dtype=np.float32)))
