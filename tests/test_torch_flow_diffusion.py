"""The slice as a whole: FlowDiffusion.sample_one_video, port against JAX.

Tiny config (32x32 image, 8x8 latent, dim_mults (1, 2), LFG max_features 256
with one bottleneck block, T=12, 2 DDIM steps, eta 1, 'local' attention, f32),
the same numpy weights on both sides through the bridge, and the same
``noise_seq``. Tolerance 1e-3: each DDIM step divides by the dynamic
threshold (a data-dependent quantile) and the decode warps by the sampled
flow, so the UNet's 5e-4 agreement compounds over the two steps and the
warp; the outputs themselves are of order one.
The port also decodes in ragged chunks of 5 frames (5 + 5 + 2), which must
give the same video: decoding is per frame. A third case runs T=260 frames,
past K1's packed range of 256.
"""

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from dawn_tpu.models.dm.flow_diffusion import FlowDiffusion as JaxFlowDiffusion
from dawn_tpu.models.dm.flow_diffusion import FlowDiffusionConfig as JaxConfig
from dawn_tpu_torch.models.dm.flow_diffusion import FlowDiffusion, FlowDiffusionConfig
from dawn_tpu_torch.weights.jax_bridge import load_flow_diffusion_variables
from test_torch_util import random_tree, one_torch_thread  # noqa: F401 (autouse fixture)

KW = dict(img_size=32, dim_mults=(1, 2), lfg_max_features=256, lfg_num_bottleneck=1,
          sampling_timesteps=2, attn_mode="local")
B, T = 1, 12


def _inputs(t):
    rng = np.random.RandomState(11)
    return dict(
        sample_img=rng.rand(B, 32, 32, 3).astype(np.float32),
        audio_hubert=rng.randn(B, t, 1024).astype(np.float32),
        pose=rng.randn(B, t, 6).astype(np.float32),
        eye=rng.randn(B, t, 2).astype(np.float32),
        bbox=np.array([[5.0, 20.0, 6.0, 25.0, 32.0, 32.0]], np.float32),
        noise_seq=rng.randn(3, B, t, 8, 8, 3).astype(np.float32))


@pytest.fixture(scope="module")
def reference():
    """The JAX video for T frames, computed once per T."""
    jfd = JaxFlowDiffusion(JaxConfig(**KW))
    variables = random_tree(jax.eval_shape(jfd.init_variables, jax.random.PRNGKey(0)), 9)
    sample = jax.jit(lambda v, a: jfd.sample_one_video(v, jax.random.PRNGKey(0), **a))
    cache = {}

    def get(t):
        if t not in cache:
            inp = _inputs(t)
            out = sample(variables, {k: jnp.asarray(v) for k, v in inp.items()})
            cache[t] = variables, inp, {k: np.asarray(v) for k, v in out.items()}
        return cache[t]

    return get


# T=260 is past K1's packed range: every temporal attention takes the
# split-heads local_attention route (the banded form here, K3 on the card)
@pytest.mark.parametrize("t,decode_chunk", [pytest.param(T, 0, id="0"),
                                            pytest.param(T, 5, id="5"),
                                            pytest.param(260, 0, id="T260")])
def test_sample_one_video_matches_jax(reference, t, decode_chunk):
    variables, inp, ref = reference(t)
    port = FlowDiffusion(FlowDiffusionConfig(dtype=torch.float32, lfg_decode_chunk=decode_chunk,
                                             **KW), device="cpu")
    load_flow_diffusion_variables(port, variables)
    out = port.sample_one_video(**{k: torch.from_numpy(v) for k, v in inp.items()})
    for key in ("sample_vid_grid", "sample_vid_conf", "sample_out_vid"):
        assert out[key].shape == ref[key].shape, key
        np.testing.assert_allclose(out[key].numpy(), ref[key], atol=1e-3, rtol=0,
                                   err_msg=key)
