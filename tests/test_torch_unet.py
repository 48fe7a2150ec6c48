"""One forward of a tiny Unet3D: the port against dawn_tpu on the CPU.

Tiny config: dim 16, dim_mults (1, 2), T=12, 8x8 latent, win_width 3, f32.
The JAX side runs in 'local' mode (its banded path on the CPU) once; the
port runs 'local' (K1's plain version), 'full', and the split init conv
(precompute_static + static_feat) of the sampler. Tolerance 5e-4, the one
tests/test_parity_reference.py holds the JAX UNet to against the reference.
"""

import numpy as np
import pytest
import torch
import jax

from dawn_tpu.models.dm.unet3d import Unet3D as JaxUnet3D
from dawn_tpu_torch.models.dm.unet3d import Unet3D
from dawn_tpu_torch.weights.jax_bridge import load_state, unet_state_dict
from test_torch_util import random_tree, one_torch_thread  # noqa: F401 (autouse fixture)

KW = dict(dim=16, dim_mults=(1, 2), channels=275, win_width=3)
B, T, S = 1, 12, 8


@pytest.fixture(scope="module")
def reference():
    rng = np.random.RandomState(0)
    x = rng.randn(B, T, S, S, 275).astype(np.float32)
    x[:, 1:, ..., 3:] = x[:, :1, ..., 3:]     # feature/mask channels: as in sampling
    cond = rng.randn(B, T, 1032).astype(np.float32)
    time = np.array([512], np.int32)
    jnet = JaxUnet3D(attn_mode="local", **KW)
    shapes = jax.eval_shape(jnet.init, jax.random.PRNGKey(0), x, time, cond)
    variables = random_tree(shapes, 1)
    ref = np.asarray(jax.jit(jnet.apply)(variables, x, time, cond))
    return variables, (x, time, cond), ref


@pytest.mark.parametrize("form", ["local", "full", "split_init_conv"])
def test_unet_forward_matches_jax(reference, form):
    variables, (x, time, cond), ref = reference
    net = Unet3D(attn_mode="full" if form == "full" else "local", **KW).eval()
    load_state(net, unet_state_dict(variables["params"]))
    x, time, cond = torch.from_numpy(x), torch.from_numpy(time).long(), torch.from_numpy(cond)
    with torch.no_grad():
        if form == "split_init_conv":
            static = net(x[:, :1, ..., 3:], None, precompute_static=True)
            got = net(x[..., :3], time, cond, static_feat=static.expand(B, T, -1, -1, -1))
        else:
            got = net(x, time, cond)
    assert got.shape == (B, T, S, S, 3)
    np.testing.assert_allclose(got.numpy(), ref, atol=5e-4, rtol=0)
