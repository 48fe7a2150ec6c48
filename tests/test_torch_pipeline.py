"""The slice as a whole: the port's VideoGenerator on the CPU, held stage by
stage against the JAX package's.

A synthetic 1 s WAV (44.1 kHz int16) and a 32x32 PNG go through both
generators, each with tiny models put in its caches: a HuBERT of hidden
width 1024 with one layer and a 7-conv stack of width 32 (stride 320, as the
audio bookkeeping needs), the two reemb6 PBnets at their shipped width, and
on the port's side the tiny FlowDiffusion of ``test_torch_flow_diffusion.py``
in f32. HuBERT and PBnet get the same numpy parameters on both sides. The
cache files are compared: init_pose (1, 7) and init_eye_bbox (1, 8) equal,
target_audio (25, 1024) at atol 1e-4, dri_pose (in the pose's normalized
units) and dri_blink at atol 1e-4 with JAX's latent draws replayed. The
frames must equal the port's ``sample_one_video`` on the cache arrays with
the same ``noise_seq`` (held against JAX to 1e-3 by
``test_torch_flow_diffusion.py``); 25 frames padded to the 10-frame bucket
(30) and trimmed back; 25 PNGs and a 25-frame mp4. The stage-3 PBnets,
saved as reference checkpoints, give JAX's stage-3 drives through
``pose_blink.generate_drives_separate``. Also ``from_config``,
missing explicit assets, stage 1 with face-prep assets, the DAWN and LFG
checkpoint loaders, and the CLI's ``main()`` on its seeded random-weight
fallbacks.
"""

import os

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from dawn_tpu.models.hubert.model import HubertConfig as JaxHubertConfig, HubertModel as JaxHubert
from dawn_tpu.models.pbnet import CVAE as JaxCVAE, PBnetParams as JaxParams
from dawn_tpu.pipeline import generator as jax_generator
from dawn_tpu_torch.models.dm.flow_diffusion import FlowDiffusion, FlowDiffusionConfig
from dawn_tpu_torch.models.hubert import HubertConfig, HubertModel
from dawn_tpu_torch.models.pbnet import CVAE, PBnetParams
from dawn_tpu_torch.pipeline import generator, pose_blink
from dawn_tpu_torch.pipeline.generator import GeneratorPaths, VideoGenerator
from dawn_tpu_torch.pipeline.pose_blink import MAX_VALS_8, MIN_VALS_8
from dawn_tpu_torch.weights.checkpoints import load_dawn_checkpoint, load_lfg_generator
from dawn_tpu_torch.weights.jax_bridge import hubert_state_dict, load_state, pbnet_state_dict
from test_torch_util import random_tree, one_torch_thread  # noqa: F401

HUBERT = dict(hidden_size=1024, num_hidden_layers=1, num_attention_heads=16,
              intermediate_size=128, conv_dim=(32,) * 7, num_conv_pos_embeddings=16,
              num_conv_pos_embedding_groups=16)
VIDEO = dict(img_size=32, dim_mults=(1, 2), lfg_max_features=256, lfg_num_bottleneck=1,
             sampling_timesteps=2, attn_mode="local", dtype=torch.float32)
T, T_BUCKET, SEED = 25, 30, 1234
NO_ASSETS = dict(hubert_dir=None, pbnet_pose_ckpt=None, pbnet_blink_ckpt=None)


def _tiny_video_model(seed=7):
    torch.manual_seed(seed)
    return FlowDiffusion(FlowDiffusionConfig(**VIDEO), device="cpu")


def _jax_stage3_draws():
    """JAX stage 3's pose and blink latents (split of PRNGKey(seed))."""
    rp, rb = jax.random.split(jax.random.PRNGKey(SEED))
    return tuple(np.asarray(jax.random.normal(r, (1, T, 256))) for r in (rp, rb))


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Both generators' stages 1-3 and the port's stage 4 on the same inputs;
    returns (JAX cache dir, port generator, noise_seq)."""
    from PIL import Image
    from scipy.io import wavfile

    root = tmp_path_factory.mktemp("pipeline")
    rng = np.random.RandomState(0)
    wav, png = str(root / "speech.wav"), str(root / "face.png")
    wavfile.write(wav, 44100, (rng.randn(44100) * 3000).astype(np.int16))
    Image.fromarray((rng.rand(32, 32, 3) * 255).astype(np.uint8)).save(png)

    jh = JaxHubert(JaxHubertConfig(**HUBERT))
    hub_vars = random_tree(jax.eval_shape(jh.init, jax.random.PRNGKey(0), jnp.zeros((1, 4000))), 1)
    hub_fwd = jax.jit(lambda w: jh.apply(hub_vars, w))
    pbnets = {}
    for seed, (kind, dim) in enumerate((("pose", 6), ("blink", 2))):
        jm = JaxCVAE(JaxParams(pos_dim=dim), deterministic=True)
        variables = random_tree(jax.eval_shape(lambda r, jm=jm: jm.init_variables(r),
                                               jax.random.PRNGKey(0)), 2 + seed)
        port = CVAE(PBnetParams(pos_dim=dim), device="cpu")
        load_state(port, pbnet_state_dict(variables))
        pbnets[kind] = (jm, variables, port)

    with pytest.MonkeyPatch.context() as mp:          # no compile cache outside the tree
        mp.setattr("dawn_tpu.utils.compile_cache.enable_compile_cache", lambda *a, **k: None)
        jgen = jax_generator.VideoGenerator(
            wav, png, str(root / "jax_out"), str(root / "jax_cache"), resolution=32,
            paths=jax_generator.GeneratorPaths(**NO_ASSETS), seed=SEED)
    jgen._hubert = lambda w: np.asarray(hub_fwd(jnp.asarray(w)))
    for kind, (jm, variables, _) in pbnets.items():
        jgen._pbnet[kind] = (jm, variables,
                             jax.jit(lambda v, r, i, a, jm=jm: jm.generate(v, r, i, a)))
    jgen.extract_pose()
    jgen.process_audio()
    jgen.generate_pose_blink()

    gen = VideoGenerator(wav, png, str(root / "out"), str(root / "cache"), resolution=32,
                         paths=GeneratorPaths(**NO_ASSETS), seed=SEED, bucket_frames=10,
                         device="cpu")
    gen._hubert = HubertModel(HubertConfig(**HUBERT), device="cpu")
    load_state(gen._hubert, hubert_state_dict(hub_vars["params"]))
    gen._pbnet = {kind: port for kind, (_, _, port) in pbnets.items()}
    gen._video_model = _tiny_video_model()
    z_pose, z_blink = _jax_stage3_draws()
    noise = torch.from_numpy(rng.randn(3, 1, T_BUCKET, 8, 8, 3).astype(np.float32))
    final = gen.run(z_pose=z_pose, z_blink=z_blink, noise_seq=noise)
    return str(root / "jax_cache"), gen, noise, final


def test_cache_files_match_jax(runs):
    jax_cache, gen, _, _ = runs
    span = MAX_VALS_8[:6] - MIN_VALS_8[:6]
    for name, shape, scale in (("init_pose", (1, 7), None), ("init_eye_bbox", (1, 8), None),
                               ("target_audio", (T, 1024), 1.0), ("dri_pose", (T, 6), span),
                               ("dri_blink", (T, 2), 1.0)):
        got = np.load(os.path.join(gen.cache_path, f"{name}.npy"))
        want = np.load(os.path.join(jax_cache, f"{name}.npy"))
        assert got.shape == want.shape == shape, name
        if scale is None:
            np.testing.assert_array_equal(got, want, err_msg=name)
        else:
            np.testing.assert_allclose(got / scale, want / scale, atol=1e-4, rtol=0,
                                       err_msg=name)


def test_frames_are_sample_one_video(runs):
    """The bucket-padded conditioning through sample_one_video, trimmed to
    T; the PNGs are its frames quantized, the mp4 has T frames."""
    import cv2
    from PIL import Image
    _, gen, noise, final = runs
    cache = {n: np.load(os.path.join(gen.cache_path, f"{n}.npy"))
             for n in ("target_audio", "dri_pose", "dri_blink", "init_pose", "init_eye_bbox")}
    padded, t_pad = generator.pad_to_bucket(
        [cache[n] for n in ("target_audio", "dri_pose", "dri_blink")], T, 10, 200)
    assert t_pad == T_BUCKET and padded[0].shape == (T_BUCKET, 1024)
    img = np.asarray(Image.open(gen.image_path).convert("RGB"), np.float32) / 255.0
    eye = cache["init_eye_bbox"]
    out = gen._init_video_model().sample_one_video(
        *(torch.from_numpy(np.ascontiguousarray(a[None], np.float32)) for a in [img] + padded),
        torch.from_numpy(eye[:, 2:8]), init_pose=torch.from_numpy(cache["init_pose"][:, :6]),
        init_eye=torch.from_numpy(eye[:, :2]), noise_seq=noise)
    want = out["sample_out_vid"][0, :T].numpy()
    assert gen.frames.shape == (T, 32, 32, 3)
    np.testing.assert_array_equal(gen.frames, want)

    name = os.path.splitext(os.path.basename(gen.image_path))[0]
    img_dir = os.path.join(gen.output_path, name, "img")
    pngs = sorted(os.listdir(img_dir))
    assert len(pngs) == T
    quantized = (np.clip(want, 0, 1) * 255).astype(np.uint8)
    for i in (0, T - 1):
        rgb = cv2.cvtColor(cv2.imread(os.path.join(img_dir, pngs[i])), cv2.COLOR_BGR2RGB)
        np.testing.assert_array_equal(rgb, quantized[i])
    cap = cv2.VideoCapture(final)
    assert int(cap.get(cv2.CAP_PROP_FRAME_COUNT)) == T
    cap.release()
    assert set(gen.stage_seconds) == {"extract_pose", "process_audio", "generate_pose_blink",
                                      "generate_final_video"}


def test_drives_from_checkpoints_match_jax(runs, tmp_path):
    """``pose_blink.generate_drives_separate`` on the stage-3 PBnets saved
    as reference checkpoints (``.pth.tar`` + ``opt.yaml``) reproduces JAX's
    stage 3 from JAX's target_audio and init files, with its draws."""
    jax_cache, gen, _, _ = runs
    ckpts = []
    for kind in ("pose", "blink"):
        (tmp_path / kind).mkdir()
        torch.save(gen._pbnet[kind].state_dict(), tmp_path / kind / "checkpoint_1.pth.tar")
        (tmp_path / kind / "opt.yaml").write_text("archiname: transformerreemb6\n")
        ckpts.append(str(tmp_path / kind / "checkpoint_1.pth.tar"))
    z_pose, z_blink = _jax_stage3_draws()
    got = pose_blink.generate_drives_separate(
        *ckpts, np.load(os.path.join(jax_cache, "target_audio.npy")),
        *pose_blink._load_init(jax_cache), SEED, z_pose=z_pose, z_blink=z_blink, device="cpu")
    span = MAX_VALS_8[:6] - MIN_VALS_8[:6]
    for g, name, scale in zip(got, ("dri_pose", "dri_blink"), (span, 1.0)):
        want = np.load(os.path.join(jax_cache, f"{name}.npy"))
        assert g.shape == want.shape
        np.testing.assert_allclose(g / scale, want / scale, atol=1e-4, rtol=0, err_msg=name)


@pytest.mark.parametrize("res", [128, 256])
def test_from_config(tmp_path, res):
    gen = VideoGenerator.from_config(f"configs/dawn_{res}.yaml", "a.wav", "i.png",
                                     str(tmp_path / "out"), str(tmp_path / "cache"),
                                     device="cpu", attn_mode="pallas")
    assert (gen.resolution, gen.max_n_frames, gen.win_width, gen.sampling_step) == (res, 200,
                                                                                    40, 20)
    assert (gen.ddim_sampling_eta, gen.cond_scale, gen.seed) == (1.0, 1.0, 1234)
    assert gen.attn_mode == "local"
    assert gen.paths.dawn_ckpt is None and gen.paths.lfg_ckpt is None   # absent: random


def test_missing_assets_raise(tmp_path):
    with pytest.raises(FileNotFoundError):
        generator._resolve_asset(str(tmp_path / "typo.pth.tar"), None, "pbnet-pose")
    assert generator._resolve_asset(GeneratorPaths.hubert_dir, GeneratorPaths.hubert_dir,
                                    "hubert") is None
    gen = VideoGenerator("a.wav", "i.png", str(tmp_path / "out"), str(tmp_path / "cache"),
                         paths=GeneratorPaths(hubert_dir=str(tmp_path / "nope"),
                                              tddfa_onnx_dir=str(tmp_path)), device="cpu")
    with pytest.raises(FileNotFoundError, match="nope"):
        gen.process_audio()
    # stage 1 with a face-asset directory that holds none of the release files
    with pytest.raises(FileNotFoundError, match="FaceBoxesProd.pth"):
        gen.extract_pose()


def test_dawn_and_lfg_loaders(tmp_path):
    src, dst = _tiny_video_model(), _tiny_video_model(seed=8)
    diffusion = {f"denoise_fn.{k}": v for k, v in src.unet.state_dict().items()}
    diffusion["denoise_fn.downs.0.3.fn.fn.fn.rotary_emb.freqs"] = torch.ones(16)
    diffusion["betas"] = torch.ones(1000)
    torch.save({"diffusion": diffusion, "example": 0}, tmp_path / "DAWN.pth")
    assert load_dawn_checkpoint(dst.unet, str(tmp_path / "DAWN.pth")) == [
        "downs.0.3.fn.fn.fn.rotary_emb.freqs"]
    for k, v in src.unet.state_dict().items():
        torch.testing.assert_close(dst.unet.state_dict()[k], v, rtol=0, atol=0, msg=k)

    gen_sd = {**src.generator.state_dict(),
              "pixelwise_flow_predictor.down.weight": torch.ones(3, 1, 13, 13)}
    lfg = {"generator": gen_sd, "region_predictor": {}, "bg_predictor": {}}
    torch.save(lfg, tmp_path / "LFG.pth")
    assert load_lfg_generator(dst, str(tmp_path / "LFG.pth")) == [
        "pixelwise_flow_predictor.down.weight"]
    for k, v in src.generator.state_dict().items():
        torch.testing.assert_close(dst.generator.state_dict()[k], v, rtol=0, atol=0, msg=k)

    del diffusion["denoise_fn.mid_block1.block1.proj.weight"]
    torch.save({"diffusion": diffusion}, tmp_path / "DAWN.pth")
    with pytest.raises(KeyError, match="mid_block1.block1.proj.weight"):
        load_dawn_checkpoint(dst.unet, str(tmp_path / "DAWN.pth"))
    del gen_sd["final.weight"]
    torch.save(lfg, tmp_path / "LFG.pth")
    with pytest.raises(KeyError, match="final.weight"):
        load_lfg_generator(dst, str(tmp_path / "LFG.pth"))


def test_cli_main_assetless(tmp_path, monkeypatch):
    """``python -m dawn_tpu_torch.pipeline.generator``'s ``main()`` with no
    assets: every model from its seeded fallback (HuBERT shrunk to the tiny
    config above, as tests/test_pipeline_e2e.py does for JAX; the PBnets
    and the DAWN model at full width), a 32^2 2-step config, on the CPU."""
    from PIL import Image
    from scipy.io import wavfile
    monkeypatch.setattr(HubertConfig, "large", classmethod(lambda cls: cls(**HUBERT)))
    monkeypatch.chdir(tmp_path)                       # default asset paths are relative
    rng = np.random.RandomState(3)
    wavfile.write("speech.wav", 16000, (rng.randn(16000) * 3000).astype(np.int16))
    Image.fromarray((rng.rand(48, 48, 3) * 255).astype(np.uint8)).save("face.png")
    (tmp_path / "tiny.yaml").write_text("input_size: 32\nsampling_step: 2\nattn_mode: pallas\n")
    argv = ["--audio_path", "speech.wav", "--image_path", "face.png", "--output_path", "out",
            "--cache_path", "cache", "--config", "tiny.yaml", "--device", "cpu"]
    gen = generator.main(argv)
    assert (gen.resolution, gen.sampling_step, gen.attn_mode, gen.bucket_frames) == (32, 2,
                                                                                      "local", 25)
    assert gen.frames.shape == (T, 32, 32, 3) and np.isfinite(gen.frames).all()
    assert len(os.listdir("out/face/img")) == T
    for name, shape in (("target_audio", (T, 1024)), ("dri_pose", (T, 6)), ("dri_blink", (T, 2))):
        assert np.load(f"cache/{name}.npy").shape == shape
