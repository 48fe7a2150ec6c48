"""The weight bridge round trip, exact.

JAX variables go into the port through dawn_tpu_torch.weights.jax_bridge;
the JAX package's reference-checkpoint converters
(dawn_tpu/weights/torch_convert.py) read the port's state_dicts back, and
every leaf must come out bit-identical. This pins the port's module names to
the reference DAWN-pytorch state_dict layout that those converters read.
"""

import numpy as np
import pytest
import torch
import jax

from dawn_tpu.models.dm.flow_diffusion import FlowDiffusion as JaxFlowDiffusion
from dawn_tpu.models.dm.flow_diffusion import FlowDiffusionConfig as JaxConfig
from dawn_tpu.weights.torch_convert import (convert_face_loc, convert_lfg_generator,
                                            convert_unet3d)
from dawn_tpu_torch.models.dm.flow_diffusion import FlowDiffusion, FlowDiffusionConfig
from dawn_tpu_torch.weights.jax_bridge import load_flow_diffusion_variables
from test_torch_util import leaves_with_paths, random_tree, one_torch_thread  # noqa: F401 (autouse fixture)


@pytest.fixture(scope="module")
def pair():
    kw = dict(img_size=32, dim_mults=(1, 2), lfg_max_features=256, lfg_num_bottleneck=1)
    shapes = jax.eval_shape(JaxFlowDiffusion(JaxConfig(**kw)).init_variables,
                            jax.random.PRNGKey(0))
    variables = random_tree(shapes, 5)
    port = FlowDiffusion(FlowDiffusionConfig(dtype=torch.float32, **kw), device="cpu")
    load_flow_diffusion_variables(port, variables)
    return variables, port


@pytest.mark.parametrize("part", ["unet", "generator", "face_loc"])
def test_round_trip_is_exact(pair, part):
    variables, port = pair
    if part == "unet":
        back = convert_unet3d(port.unet.state_dict(), num_levels=2)
    elif part == "generator":
        back = convert_lfg_generator(port.generator.state_dict(), num_bottleneck=1)["generator"]
    else:
        back = convert_face_loc(port.face_loc.state_dict())
    want, got = leaves_with_paths(variables[part]), leaves_with_paths(back)
    assert sorted(got) == sorted(want)
    for path, leaf in want.items():
        np.testing.assert_array_equal(np.asarray(got[path]), leaf, err_msg=path)
