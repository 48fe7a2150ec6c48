"""The port's quality harness and LFG reconstruction test against the JAX
package's, on the tiny FlowAE of ``test_torch_lfg_teacher.py`` (generator
8/32 with one bottleneck block, the predictors 4/16), JAX variables from
``jax.eval_shape`` plus a seeded numpy fill, carried to the port by
``jax_bridge``; 32^2 frames.

- ``lfg_frame_features`` (the bottleneck's spatial mean and population std
  per frame) within 1e-5 of the largest feature, in batches that leave a
  remainder;
- ``evaluate_quality`` with mouth landmarks and audio features, and
  ``evaluate_generated_batch`` (two identities, two clips each, with real
  videos), key by key at rtol 1e-4 (the Frechet distances of 72 frames'
  features and of 4 videos, the L1s, the mouth L1 and SSIM, the AV-sync
  correlations, offsets and margins, diversity, multimodality, the
  identity accuracy and confusion);
- ``evaluate_reconstruction``: the per-video L1 JSON at rtol 1e-4 and one
  side-by-side mp4 per video.
"""

import functools
import json
import os

import numpy as np
import pytest
import torch
import jax

from dawn_tpu.evaluate import lfg_recon as jax_recon
from dawn_tpu.evaluate import quality as jax_quality
from dawn_tpu.models.lfg.flow_ae import FlowAE as JaxFlowAE
from dawn_tpu_torch.evaluate import lfg_recon, quality
from dawn_tpu_torch.models.lfg.flow_ae import FlowAE
from dawn_tpu_torch.weights.jax_bridge import load_flow_ae_variables
from test_torch_lfg_teacher import TINY
from test_torch_util import random_tree, one_torch_thread  # noqa: F401 (autouse fixture)

S = 32


@pytest.fixture(scope="module")
def pair():
    jae = JaxFlowAE(**TINY)
    shapes = jax.eval_shape(functools.partial(jae.init_variables, img_size=S),
                            jax.random.PRNGKey(0))
    variables = random_tree(shapes, 21)
    port = FlowAE(**TINY).eval()
    load_flow_ae_variables(port, variables)
    return jae, variables, port


def _videos(seed, n, t):
    return (np.random.RandomState(seed).rand(n, t, S, S, 3) * 0.6 + 0.2).astype(np.float32)


def _mouth(seed, n, t):
    rng = np.random.RandomState(seed)
    centre = np.array([16.0, 22.0]) + rng.randn(n, t, 1, 2)
    return (centre + 3.0 * rng.randn(n, t, 20, 2)).astype(np.float32)


def _compare(ours, theirs, path=""):
    if isinstance(theirs, dict):
        assert sorted(map(str, ours)) == sorted(map(str, theirs)), path
        for k in theirs:
            _compare(ours[k], theirs[k], f"{path}/{k}")
    elif isinstance(theirs, (str, type(None))):
        assert ours == theirs, path
    else:
        np.testing.assert_allclose(np.asarray(ours, np.float64), np.asarray(theirs, np.float64),
                                   rtol=1e-4, atol=1e-7, err_msg=path)


def test_lfg_frame_features_match_jax(pair):
    jae, variables, port = pair
    videos = _videos(0, 2, 5)
    got = quality.lfg_frame_features(port.generator, videos, batch=4)
    want = jax_quality.lfg_frame_features(jae.generator, variables["generator"], videos, batch=4)
    assert got.shape == want.shape == (10, 64) and got.dtype == np.float32
    assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()


def test_evaluate_quality_matches_jax(pair):
    jae, variables, port = pair
    real, t = _videos(1, 3, 24), 24
    fake = np.clip(real + 0.05 * np.random.RandomState(2).randn(*real.shape), 0, 1)
    fake = fake.astype(np.float32)
    mouth, audio = _mouth(3, 3, t), np.random.RandomState(4).randn(3, t, 16).astype(np.float32)
    ours = quality.evaluate_quality(port.generator, real, fake, mouth, audio)
    theirs = jax_quality.evaluate_quality(jae.generator, variables["generator"], real, fake,
                                          mouth, audio)
    assert {"fvd_lfg_frames", "fvd_lfg_videos", "l1", "mouth_l1", "mouth_ssim", "av_corr",
            "av_offset", "av_margin"} == set(theirs)
    _compare(ours, theirs)


def test_evaluate_generated_batch_matches_jax(pair):
    jae, variables, port = pair
    videos, real = _videos(5, 4, 10), _videos(6, 4, 10)
    labels, sources = np.array([0, 0, 1, 1]), _videos(7, 2, 1)[:, 0]
    audio = np.random.RandomState(8).randn(4, 10, 16).astype(np.float32)
    ours = quality.evaluate_generated_batch(port.generator, videos, labels, sources,
                                            real_videos=real, audio_feats=audio)
    theirs = jax_quality.evaluate_generated_batch(jae.generator, variables["generator"], videos,
                                                  labels, sources, real_videos=real,
                                                  audio_feats=audio)
    assert ours["multimodality"] > 0 and set(ours["per_identity"]) == {0, 1}
    _compare(json.loads(json.dumps(ours)), json.loads(json.dumps(theirs)))


def test_evaluate_reconstruction_matches_jax(pair, tmp_path):
    jae, variables, port = pair
    vids = [(f"v{i}", _videos(10 + i, 1, 3)[0]) for i in range(3)]
    ours = lfg_recon.evaluate_reconstruction(port, iter(vids), str(tmp_path / "ours.json"),
                                             video_dir=str(tmp_path / "videos"), max_videos=2)
    theirs = jax_recon.evaluate_reconstruction(jae, variables, iter(vids),
                                               str(tmp_path / "theirs.json"), max_videos=2)
    assert sorted(ours) == ["v0", "v1"]
    with open(tmp_path / "ours.json") as f:
        _compare(json.load(f), theirs)
    assert sorted(os.listdir(tmp_path / "videos")) == ["v0.mp4", "v1.mp4"]
    import cv2
    cap = cv2.VideoCapture(str(tmp_path / "videos" / "v0.mp4"))
    assert (int(cap.get(cv2.CAP_PROP_FRAME_COUNT)), int(cap.get(cv2.CAP_PROP_FRAME_WIDTH))) == (
        3, 2 * S)
    cap.release()
    assert torch.is_grad_enabled()
