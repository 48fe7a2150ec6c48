"""The port's PBnet CVAE and drive generation against the JAX package.

reemb6 (separate pose / blink, eval window 100) and reemb5 (joint 8-d,
window 200) at the shipped PBnet width (2 layers, 4 heads, ff 128, latents
64 / 256, T5 buckets and distance 128), the same numpy parameters on both
sides (``jax.eval_shape`` + a seeded fill, into the port through
``pbnet_state_dict``), f32 at atol 1e-4. T = 40, and T = 230, past both
windows, so the eval mask matters. ``generate_drives_joint`` reads the same
``.pth.tar`` + ``opt.yaml`` on both sides (JAX through
``convert_pbnet_checkpoint``, the port through its strict loader), with
JAX's latent draw replayed into the port's ``z``; the drives are compared in
the models' normalized units (pose over the 8-d min/max constants, blink as
it is), where the models work. ``generate_drives_separate`` is held against
JAX's stage 3 in ``test_torch_pipeline.py``. The opt.yaml is read with the
safe loader.
"""

import numpy as np
import pytest
import torch
import yaml
import jax

from dawn_tpu.models.pbnet import CVAE as JaxCVAE, PBnetParams as JaxParams
from dawn_tpu.pipeline import pose_blink as jax_pose_blink
from dawn_tpu_torch.models.pbnet import CVAE, PBnetParams, get_model
from dawn_tpu_torch.pipeline import pose_blink
from dawn_tpu_torch.weights.checkpoints import load_pbnet_checkpoint
from dawn_tpu_torch.weights.jax_bridge import load_state, pbnet_state_dict
from test_torch_util import random_tree, one_torch_thread  # noqa: F401

# archiname -> feature width (reemb5: joint pose 6 + blink 2)
ARCHS = {"transformerreemb6": (6, 0), "transformerreemb5": (6, 2)}


def _variables(arch, pos_dim, eye_dim, seed):
    jm = JaxCVAE(JaxParams(archiname=arch, pos_dim=pos_dim, eye_dim=eye_dim), deterministic=True)
    shapes = jax.eval_shape(lambda r: jm.init_variables(r), jax.random.PRNGKey(0))
    return jm, random_tree(shapes, seed)


def _port(arch, pos_dim, eye_dim, variables):
    port = CVAE(PBnetParams(archiname=arch, pos_dim=pos_dim, eye_dim=eye_dim), device="cpu")
    load_state(port, pbnet_state_dict(variables))
    return port


@pytest.fixture(scope="module")
def models():
    """archiname -> (JAX CVAE, variables, jitted encode, jitted decode, port)."""
    out = {}
    for i, (arch, dims) in enumerate(ARCHS.items()):
        jm, variables = _variables(arch, *dims, seed=20 + i)
        out[arch] = (jm, variables, jax.jit(lambda v, x, y, m, jm=jm: jm.encode(v, x, y, m)),
                     jax.jit(lambda v, x, z, y, m, jm=jm: jm.decode(v, x, z, y, m)),
                     _port(arch, *dims, variables))
    return out


def _inputs(t, d, seed):
    rng = np.random.RandomState(seed)
    mask = np.ones((2, t), bool)
    mask[1, t - 7:] = False                       # one padded sequence
    return (rng.rand(2, t, d).astype(np.float32), rng.randn(2, t, 256).astype(np.float32),
            rng.randn(2, t, 1024).astype(np.float32), mask)


@pytest.mark.parametrize("arch", list(ARCHS))
@pytest.mark.parametrize("t", [40, 230])
def test_encode_decode_match_jax(models, arch, t):
    _, variables, enc, dec, port = models[arch]
    x, z, y, mask = _inputs(t, sum(ARCHS[arch]), seed=t)
    want = enc(variables, x, y, mask)
    got = port.encode(*map(torch.from_numpy, (x, y, mask)))
    for key in ("mu", "logvar", "x_delta"):
        np.testing.assert_allclose(got[key].numpy(), np.asarray(want[key]), atol=1e-4, rtol=0,
                                   err_msg=key)
    want = np.asarray(dec(variables, x, z, y, mask))
    got = port.decode(*map(torch.from_numpy, (x, z, y, mask))).numpy()
    assert got.shape == (2, t, sum(ARCHS[arch]))
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)


def _checkpoint(tmp_path, name, arch, port):
    """A reference-layout checkpoint of ``port``'s weights (with the
    sinusoidal table and a rotary buffer the port recomputes) and its
    opt.yaml; returns (path, state_dict)."""
    sd = dict(port.state_dict())
    sd["encoder.sequence_pos_encoder.pe"] = torch.zeros(8, 1, 384)
    sd["decoder.init_temporal_attn.fn.fn.rotary_emb.freqs"] = torch.ones(2)
    folder = tmp_path / name
    folder.mkdir()
    torch.save(sd, folder / "checkpoint_1.pth.tar")
    (folder / "opt.yaml").write_text(yaml.dump({"archiname": arch, "num_layers": 2,
                                                "num_heads": 4, "audio_latent_dim": 256}))
    return str(folder / "checkpoint_1.pth.tar"), sd


def test_strict_loader(models, tmp_path):
    path, sd = _checkpoint(tmp_path, "pose", "transformerreemb6",
                           models["transformerreemb6"][-1])
    port = CVAE(PBnetParams(), device="cpu")
    skipped = load_pbnet_checkpoint(port, path)
    assert skipped == ["decoder.init_temporal_attn.fn.fn.rotary_emb.freqs",
                       "encoder.sequence_pos_encoder.pe"]
    for k, v in port.state_dict().items():
        torch.testing.assert_close(v, sd[k], rtol=0, atol=0, msg=k)
    del sd["decoder.seqTransDecoder.decoder_layers.1.ffn.linear2.weight"]
    torch.save(sd, path)
    with pytest.raises(KeyError, match="ffn.linear2.weight"):
        load_pbnet_checkpoint(port, path)


@pytest.mark.parametrize("value,want", [("!!python/tuple [1, 2]", (1, 2)),
                                        ("!!python/object/apply:os.getcwd []", None)])
def test_opt_yaml_is_read_safely(tmp_path, value, want):
    """Python tuples load; a tag that would build another Python object
    (and so could run code) raises."""
    (tmp_path / "opt.yaml").write_text(f"archiname: transformerreemb6\nfield: {value}\n")
    ckpt = str(tmp_path / "checkpoint_1.pth.tar")
    if want is None:
        with pytest.raises(yaml.constructor.ConstructorError, match="python/object/apply"):
            pose_blink.read_opt(ckpt)
    else:
        assert pose_blink.read_opt(ckpt) == {"archiname": "transformerreemb6", "field": want}


def test_unported_arch_raises():
    with pytest.raises(NotImplementedError, match="item 15"):
        get_model({"modelname": "cvae_gru_rc_kl"}, device="cpu")


def test_drives_match_jax(models, tmp_path):
    """The joint reemb5 drives from one checkpoint file (the separate reemb6
    drives are held against JAX by test_torch_pipeline.py)."""
    t, seed = 50, 1234
    rng = np.random.RandomState(40)
    audio = rng.randn(t, 1024).astype(np.float32)
    init_pose = np.array([[10.0, -5.0, 3.0, 4.8e-4, 56.5, 64.9]], np.float32)
    init_blink = np.array([[0.28, 0.31]], np.float32)
    both_ckpt, _ = _checkpoint(tmp_path, "both", "transformerreemb5",
                               models["transformerreemb5"][-1])
    want = jax_pose_blink.generate_drives_joint(both_ckpt, audio, init_pose, init_blink, seed)
    z = np.asarray(jax.random.normal(jax.random.PRNGKey(seed), (1, t, 256)))
    got = pose_blink.generate_drives_joint(both_ckpt, audio, init_pose, init_blink, seed, z=z,
                                           device="cpu")
    assert_drives_close(got, want)


def assert_drives_close(got, want):
    """Pose in the 8-d constants' normalized units, blink as it is, at 1e-4."""
    span = pose_blink.MAX_VALS_8[:6] - pose_blink.MIN_VALS_8[:6]
    for g, w, scale, name in zip(got, want, (span, 1.0), ("pose", "blink")):
        assert g.shape == w.shape
        np.testing.assert_allclose(g / scale, np.asarray(w) / scale, atol=1e-4, rtol=0,
                                   err_msg=name)
