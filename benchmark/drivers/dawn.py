"""The program side of a DAWN cell: ``dawn_tpu_torch``'s ``FlowDiffusion``
built from a configuration file, the benchmark's weights loaded into it,
the timed call (``sample_one_video``), and the spans of a traced run.

The spans are set from outside the program: ``sample_latents`` and
``decode_latents`` wrapped on the instance (host clock, card
synchronised), a forward-hook pair on ``model.unet`` (CUDA events; the
step-constant precompute call is left out), and a wrapper around the two
temporal-attention entries that ``Unet3D`` calls, which counts each call's
operations and bytes from its shapes.
"""

from __future__ import annotations

import contextlib
from typing import Dict

import torch

from benchmark.arith import attention_bytes, attention_flops
from dawn_tpu_torch.models.dm import flow_diffusion, unet3d

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}
COMPARED = ("sample_vid_grid", "sample_vid_conf", "sample_out_vid")


def set_precision(config: dict) -> None:
    """The TF32 switches the configuration states."""
    p = config["precision"]
    torch.backends.cudnn.allow_tf32 = p["conv_tf32"]
    torch.backends.cuda.matmul.allow_tf32 = p["matmul_tf32"]


def build(config: dict, state_dict: Dict[str, torch.Tensor], device):
    """The port's model with its parameters made on ``device``, then
    ``state_dict`` loaded (every name, every shape)."""
    p, u, lfg = config["precision"], config["unet"], config["lfg"]
    cfg = flow_diffusion.FlowDiffusionConfig(
        img_size=config["img_size"], pose_dim=config["pose_dim"], win_width=config["win_width"],
        sampling_timesteps=config["sampling_timesteps"],
        ddim_sampling_eta=config["ddim_sampling_eta"], attn_mode=config["attn_mode"],
        dim_mults=tuple(u["dim_mults"]), dtype=DTYPES[p["unet"]], lfg_dtype=DTYPES[p["lfg"]],
        lfg_max_features=lfg["max_features"], lfg_num_bottleneck=lfg["num_bottleneck_blocks"],
        lfg_decode_chunk=config["lfg_decode_chunk"])
    with torch.device(device):
        model = flow_diffusion.FlowDiffusion(cfg, device=device)
    model.load_state_dict(state_dict, strict=True)
    return model


def call(model, config: dict, inputs: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """The timed call; returns the outputs the run compares."""
    out = model.sample_one_video(inputs["sample_img"], inputs["audio_hubert"], inputs["pose"],
                                 inputs["eye"], inputs["bbox"], cond_scale=config["cond_scale"],
                                 noise_seq=inputs["noise_seq"])
    return {k: out[k] for k in COMPARED}


def failed_items(out: Dict[str, torch.Tensor]) -> int:
    """Clips of a call whose video holds a value that is not finite (reads
    the card, so it also waits for the call)."""
    return int((~torch.isfinite(out["sample_out_vid"])).flatten(1).any(1).sum())


def _attention_wrapper(fn, spans, packed: bool):
    def wrapped(q, k, v, bias_vec, window, *args, **kwargs):
        if packed:
            n, t, hd = q.shape
            heads = args[0] if args else kwargs["heads"]
            d = hd // heads
        else:
            n, heads, t, d = q.shape
        bias = 0 if bias_vec is None else bias_vec.numel()
        spans.count("temporal_attn", attention_flops(n, t, heads, d, window),
                    attention_bytes(n, t, heads, d, q.element_size(), bias))
        with torch.profiler.record_function("bench::temporal_attn"):
            return fn(q, k, v, bias_vec, window, *args, **kwargs)
    return wrapped


@contextlib.contextmanager
def traced(model, spans):
    """For the duration, the layers of ``model`` report to ``spans``."""
    latents, decode = model.sample_latents, model.decode_latents

    def sample_latents(*args, **kwargs):
        with spans.host("ddim"):
            return latents(*args, **kwargs)

    def decode_latents(*args, **kwargs):
        with spans.host("decode"):
            return decode(*args, **kwargs)

    def pre(module, args, kwargs):
        if not kwargs.get("precompute_static", False):
            spans.begin("unet")

    def post(module, args, kwargs, out):
        if not kwargs.get("precompute_static", False):
            spans.end("unet")

    entries = {"local_attention_packed": True, "local_attention": False}
    saved = {name: getattr(unet3d, name) for name in entries}
    hooks = [model.unet.register_forward_pre_hook(pre, with_kwargs=True),
             model.unet.register_forward_hook(post, with_kwargs=True)]
    model.sample_latents, model.decode_latents = sample_latents, decode_latents
    for name, packed in entries.items():
        setattr(unet3d, name, _attention_wrapper(saved[name], spans, packed))
    try:
        yield
    finally:
        for h in hooks:
            h.remove()
        del model.sample_latents, model.decode_latents
        for name, fn in saved.items():
            setattr(unet3d, name, fn)
