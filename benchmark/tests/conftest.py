"""Fixtures of the benchmark's own tests: a cell of the real configuration
family cut to a size the CPU runs in seconds."""

import copy

import pytest

from benchmark import manifest

# Set as the cells' limits are, from readings at this size on the CPU
# (seeds 1-5, 7, 8, 2**31 + 99; the control on the first four): the
# program's largest 0.0078 (latent), 4.8e-08 (decode: no TF32 on the CPU)
# and 0.0046 (video), the control's smallest 0.057, 4.2e-05 and 0.030.
TINY_LIMITS = {"latent_err": {"limit": 0.025}, "decode_err": {"limit": 3e-06},
               "video_err": {"limit": 0.014}}


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs a CUDA card; skips without one")


@pytest.fixture
def tiny_cell():
    """dawn128.b4.t200's configuration and traffic at 32x32, two UNet levels,
    two DDIM steps, 2 clips of 8 frames."""
    cell = manifest.resolve("dawn128.b4.t200")
    config = copy.deepcopy(cell.config)
    config.update(img_size=32, win_width=4, sampling_timesteps=2)
    config["unet"]["dim_mults"] = [1, 2]
    cell.config = config
    cell.traffic = dict(cell.traffic, batch=2, frames=8, trace_calls=1)
    cell.limits = copy.deepcopy(TINY_LIMITS)
    return cell
