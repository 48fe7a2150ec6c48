"""The port's HuBERT and audio stage against the JAX package, on the CPU.

A tiny config (hidden 64, 2 layers, 4 heads, conv_dim (32, 32, 32), kernels
(10, 3, 2), strides (5, 2, 2), position conv 16 in 4 groups), the same numpy
parameters on both sides (``jax.eval_shape`` + a seeded fill, carried into
the port by ``hubert_state_dict``), for the 'layer' and 'group' feature
norms, at atol 1e-4 (f32, outputs of order one). Also: the bridge inverts
``convert_hubert``; the HF-directory loader reads a ``HubertForCTC`` layout
with weight norm and raises on a missing entry; the clip bookkeeping and
``process_audio`` on a 1.5 s 44.1 kHz WAV match JAX's (there the tiny model
keeps the real 7-conv stack of stride 320, which the bookkeeping assumes).
"""

import dataclasses
import json

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from dawn_tpu.models.hubert.model import HubertConfig as JaxConfig, HubertModel as JaxHubert
from dawn_tpu.pipeline import audio as jax_audio
from dawn_tpu.weights.hubert_convert import convert_hubert
from dawn_tpu_torch.models.hubert import HubertConfig, HubertModel
from dawn_tpu_torch.pipeline import audio
from dawn_tpu_torch.weights.checkpoints import load_hubert_dir
from dawn_tpu_torch.weights.jax_bridge import hubert_state_dict, load_state
from test_torch_util import leaves_with_paths, random_tree, one_torch_thread  # noqa: F401

TINY = dict(hidden_size=64, num_hidden_layers=2, num_attention_heads=4, intermediate_size=128,
            conv_dim=(32, 32, 32), conv_kernel=(10, 3, 2), conv_stride=(5, 2, 2),
            num_conv_pos_embeddings=16, num_conv_pos_embedding_groups=4)
STRIDE_320 = dict(TINY, conv_dim=(32,) * 7, conv_kernel=HubertConfig.conv_kernel,
                  conv_stride=HubertConfig.conv_stride)


@pytest.fixture(scope="module")
def pair():
    """(norm, config) -> (JAX variables, jitted JAX forward, port model)."""
    cache = {}

    def get(norm, config=TINY):
        key = norm, tuple(config.items())
        if key not in cache:
            jm = JaxHubert(JaxConfig(feat_extract_norm=norm, **config))
            shapes = jax.eval_shape(jm.init, jax.random.PRNGKey(0), jnp.zeros((1, 1600)))
            variables = random_tree(shapes, 3)
            port = HubertModel(HubertConfig(feat_extract_norm=norm, **config), device="cpu")
            load_state(port, hubert_state_dict(variables["params"]))
            fwd = jax.jit(lambda w: jm.apply(variables, w))
            cache[key] = variables, fwd, port
        return cache[key]

    return get


@pytest.mark.parametrize("norm", ["layer", "group"])
def test_hubert_matches_jax(pair, norm):
    _, fwd, port = pair(norm)
    wav = np.random.RandomState(0).randn(2, 1600).astype(np.float32)
    want = np.asarray(fwd(jnp.asarray(wav)))
    got = port(torch.from_numpy(wav)).numpy()
    assert got.shape == want.shape == (2, 79, 64)
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)


def test_bridge_inverts_convert_hubert(pair):
    variables, _, port = pair("layer")
    sd = {k: v.numpy() for k, v in port.state_dict().items()}
    back = leaves_with_paths(convert_hubert(sd, JaxConfig(**TINY)))
    want = leaves_with_paths(variables)
    assert back.keys() == want.keys()
    for k in want:
        np.testing.assert_array_equal(np.asarray(back[k]), want[k], err_msg=k)


def _hf_state_dict(port, layout):
    """The port's weights in an HF HubertForCTC file's layout: 'hubert.'
    prefix, the CTC head, and the position conv weight-normed (dim=2)."""
    conv = "encoder.pos_conv_embed.conv"
    sd = {f"hubert.{k}": v.clone() for k, v in port.state_dict().items()}
    w = sd.pop(f"hubert.{conv}.weight")
    v = 0.5 * w                                           # any v with w = g * v / |v|
    g = w.square().sum(dim=(0, 1), keepdim=True).sqrt()
    names = {"g/v": ("weight_g", "weight_v"),
             "parametrizations": ("parametrizations.weight.original0",
                                  "parametrizations.weight.original1")}[layout]
    sd[f"hubert.{conv}.{names[0]}"], sd[f"hubert.{conv}.{names[1]}"] = g, v
    sd["hubert.masked_spec_embed"] = torch.zeros(64)
    sd["lm_head.weight"], sd["lm_head.bias"] = torch.zeros(32, 64), torch.zeros(32)
    return sd


@pytest.mark.parametrize("layout", ["g/v", "parametrizations"])
def test_load_hubert_dir(pair, tmp_path, layout):
    _, _, port = pair("layer")
    cfg = {k: list(v) if isinstance(v, tuple) else v
           for k, v in dataclasses.asdict(HubertConfig(**TINY)).items()}
    cfg["vocab_size"] = 32                                # an HF field the port ignores
    (tmp_path / "config.json").write_text(json.dumps(cfg))
    sd = _hf_state_dict(port, layout)
    torch.save(sd, tmp_path / "pytorch_model.bin")
    loaded, skipped = load_hubert_dir(str(tmp_path), device="cpu")
    assert skipped == ["lm_head.bias", "lm_head.weight", "masked_spec_embed"]
    assert loaded.config == port.config
    for k, v in port.state_dict().items():
        torch.testing.assert_close(loaded.state_dict()[k], v, rtol=1e-6, atol=1e-7, msg=k)

    del sd["hubert.encoder.layers.1.feed_forward.output_dense.bias"]
    torch.save(sd, tmp_path / "pytorch_model.bin")
    with pytest.raises(KeyError, match="output_dense.bias"):
        load_hubert_dir(str(tmp_path), device="cpu")


@pytest.mark.parametrize("total", [0, 399, 400, 16000, 320079, 320080, 320000 * 2 + 5000,
                                   320000 * 3 + 399])
def test_clip_bounds_match_jax(total):
    assert audio.hubert_clip_bounds(total) == jax_audio.hubert_clip_bounds(total)


def test_process_audio_matches_jax(pair, tmp_path):
    """1.5 s at 44.1 kHz int16 -> resample, normalise, one tail chunk,
    interpolate to 37 frames; the tiny model's features (width 64)."""
    from scipy.io import wavfile
    _, fwd, port = pair("layer", STRIDE_320)
    rng = np.random.RandomState(5)
    path = str(tmp_path / "speech.wav")
    wavfile.write(path, 44100, (rng.randn(int(44100 * 1.5)) * 3000).astype(np.int16))
    want = jax_audio.process_audio(path, lambda w: np.asarray(fwd(jnp.asarray(w))))
    got = audio.process_audio(path, lambda w: port(torch.from_numpy(w)).numpy())
    assert got.shape == want.shape == (37, 64)
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)
