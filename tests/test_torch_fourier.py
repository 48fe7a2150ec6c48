"""``dawn_tpu_torch/ops/fourier.py`` against ``dawn_tpu/ops/fourier.py`` on
the CPU, on seeded inputs, rtol 1e-5 (atol 1e-6 for entries near zero):
hf_loss_2 along the frames of a flow video (the DM trainer's FFT floss, and
its gradient), hf_loss with a rFFT-bin mask, the temporal and the 2-D
low-pass filters, the threshold filter and the Kalman smoother along either
axis; the 2-D filter refuses frames that are not square, as JAX asserts."""

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from dawn_tpu.ops import fourier as J
from dawn_tpu_torch.ops import fourier as P

RTOL, ATOL = 1e-5, 1e-6


def _close(got, want):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=RTOL, atol=ATOL)


@pytest.fixture(scope="module")
def flows():
    r = np.random.RandomState(0)
    return (r.uniform(-1, 1, (2, 7, 5, 5, 2)).astype(np.float32),
            r.uniform(-1, 1, (2, 7, 5, 5, 2)).astype(np.float32))


def test_hf_loss_2_and_its_gradient(flows):
    pred, target = flows
    _close(P.hf_loss_2(torch.from_numpy(pred), torch.from_numpy(target), dim=1),
           J.hf_loss_2(jnp.asarray(pred), jnp.asarray(target), axis=1))
    want = jax.grad(lambda p: J.hf_loss_2(p, jnp.asarray(target), axis=1).mean())(
        jnp.asarray(pred))
    p = torch.from_numpy(pred).requires_grad_()
    P.hf_loss_2(p, torch.from_numpy(target), dim=1).mean().backward()
    _close(p.grad, want)


def test_hf_loss(flows):
    fea, _ = flows
    mask = np.random.RandomState(1).rand(1, 4, 1, 1, 1).astype(np.float32)
    _close(P.hf_loss(torch.from_numpy(fea), torch.from_numpy(mask), dim=1),
           J.hf_loss(jnp.asarray(fea), jnp.asarray(mask), axis=1))


@pytest.mark.parametrize("axis", [0, 1])
def test_fourier_filter_1d(axis):
    x = np.random.RandomState(2).randn(9, 12, 3).astype(np.float32)
    _close(P.fourier_filter_1d(torch.from_numpy(x), dim=axis),
           J.fourier_filter_1d(jnp.asarray(x), axis=axis))


def test_fourier_filter_2d():
    x = np.random.RandomState(3).randn(3, 8, 8, 2).astype(np.float32)
    _close(P.fourier_filter_2d(torch.from_numpy(x)), J.fourier_filter_2d(jnp.asarray(x)))
    with pytest.raises(ValueError, match="square"):
        P.fourier_filter_2d(torch.zeros(1, 8, 6, 2))


def test_naive_filter():
    x = (np.random.RandomState(4).randn(4, 6, 2) / 40).astype(np.float32)
    _close(P.naive_filter(torch.from_numpy(x)), J.naive_filter(jnp.asarray(x)))


@pytest.mark.parametrize("axis", [0, 1])
def test_kalman_filter_1d(axis):
    x = np.random.RandomState(5).randn(10, 6, 2).astype(np.float32)
    _close(P.kalman_filter_1d(torch.from_numpy(x), q=0.02, r=0.2, dim=axis),
           J.kalman_filter_1d(jnp.asarray(x), q=0.02, r=0.2, axis=axis))
