"""The backward of windowed temporal attention (K2's function) against
dawn_tpu on the CPU.

K2's plain version, ``local_attention_packed_bwd_plain`` (what a CPU tensor
runs, and what chip_smoke.py holds the CUDA kernel against on the card), is
held against the JAX package's Pallas backward ``_packed_bwd_pallas`` in
interpret mode on the cases of tests/test_torch_local_attention.py: dq, dk,
dv and the bias-vector gradient at atol 1e-5 (dvec: 1e-4, a sum over every
query of the sequence). Two bf16 cases on cancelling inputs
(``test_torch_util.cancelling_inputs``) hold dq, dk, dv at one bf16 ulp of
each entry plus 2^-14 of the largest (``assert_bf16_close``; the f32 dvec
likewise): the plain version rounds P and dS to bf16 before the products,
as the Pallas kernel does. The autograd Function LocalAttentionPacked on CPU
tensors (plain forward, plain backward, no kernel launch) is held against
torch.autograd through the plain forward at atol 1e-5.
"""

import numpy as np
import pytest
import torch
import jax

from dawn_tpu.ops.local_attention import _packed_bwd_pallas
from dawn_tpu.ops.t5bias import t5_bias_windowed_vector
from dawn_tpu_torch.ops.local_attention import (LocalAttentionPacked, _widen_bias_grad,
                                                local_attention_packed,
                                                local_attention_packed_bwd,
                                                local_attention_packed_bwd_plain,
                                                local_attention_packed_plain)
import jax.numpy as jnp
from test_torch_util import (assert_bf16_close, cancelling_inputs,
                             one_torch_thread)  # noqa: F401 (autouse fixture)

# (n, heads, T, dh, window, with T5 bias), as in test_torch_local_attention.py,
# and stage 1's top level cut to 4 heads: w = 20 >= T = 20, where K2 clamps
# its band to T - 1 and widens the bias gradient (_widen_bias_grad)
CASES = [(1, 8, 200, 32, 40, True), (1, 4, 77, 32, 20, True),
         (1, 4, 160, 32, 40, True), (1, 4, 136, 32, 20, True),
         (1, 4, 256, 32, 40, True), (1, 2, 50, 16, 10, False),
         (1, 4, 20, 32, 20, True)]
# bf16 twins of the odd-T, no-bias and stage-1 cases, on cancelling inputs
BF16_CASES = [(1, 4, 77, 32, 20, True), (1, 2, 50, 16, 10, False), (1, 4, 20, 32, 20, True)]


def _inputs(n, h, t, d, w, bias, seed=0):
    rng = np.random.RandomState(seed + n * 131 + h * 17 + t + d)
    q = (rng.randn(n, t, h * d) * d ** -0.5).astype(np.float32)
    k, v, g = (rng.randn(n, t, h * d).astype(np.float32) for _ in range(3))
    vec = (np.asarray(t5_bias_windowed_vector(rng.randn(32, h).astype(np.float32), w, 32, 32))
           if bias else None)
    return q, k, v, g, vec


@pytest.mark.parametrize("n,h,t,d,w,bias,dtype", [
    pytest.param(*case, "float32", id="-".join(map(str, case))) for case in CASES] + [
    pytest.param(*case, "bfloat16", id="-".join(map(str, case)) + "-bf16")
    for case in BF16_CASES])
def test_plain_backward_matches_pallas(n, h, t, d, w, bias, dtype):
    if dtype == "bfloat16":
        return _bf16_case(n, h, t, d, w, bias)
    q, k, v, g, vec = _inputs(n, h, t, d, w, bias)
    want = jax.jit(lambda *a: _packed_bwd_pallas(*a, w, h, interpret=True))(q, k, v, g, vec)
    got = local_attention_packed_bwd_plain(*map(torch.from_numpy, (q, k, v, g)),
                                           None if vec is None else torch.from_numpy(vec), w, h)
    for label, a, b in zip(("dq", "dk", "dv", "dvec"), got, want):
        if b is None:
            assert a is None
            continue
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0, err_msg=label,
                                   atol=1e-4 if label == "dvec" else 1e-5)


def _bf16_case(n, h, t, d, w, bias):
    rng = np.random.RandomState(13 + t)
    xs = cancelling_inputs(rng, (n, t, h * d), (n, t, h * d), row_axis=1)
    vec = (np.asarray(t5_bias_windowed_vector(rng.randn(32, h).astype(np.float32), w, 32, 32))
           if bias else None)
    want = jax.jit(lambda *a: _packed_bwd_pallas(*a, w, h, interpret=True))(
        *(jnp.asarray(x).astype(jnp.bfloat16) for x in xs), vec)
    got = local_attention_packed_bwd_plain(*(torch.from_numpy(x).bfloat16() for x in xs),
                                           None if vec is None else torch.from_numpy(vec), w, h)
    for label, a, b in zip(("dq", "dk", "dv", "dvec"), got, want):
        if b is None:
            assert a is None
            continue
        assert a.dtype == (torch.float32 if label == "dvec" else torch.bfloat16)
        assert_bf16_close(a, b, label)


@pytest.mark.parametrize("bias", [True, False])
def test_autograd_function_on_cpu(bias):
    """Gradients through local_attention_packed with grad on go through
    LocalAttentionPacked; on CPU tensors no kernel is launched."""
    n, h, t, d, w = 3, 4, 37, 32, 6
    q, k, v, g, vec = _inputs(n, h, t, d, w, bias, seed=5)
    leaves = [torch.from_numpy(x).requires_grad_() for x in (q, k, v, vec) if x is not None]
    args = leaves if bias else leaves + [None]
    launches = local_attention_packed.launches, local_attention_packed_bwd.launches
    out = local_attention_packed(*args, w, h)
    assert out.grad_fn is not None and "LocalAttentionPacked" in type(out.grad_fn).__name__
    got = torch.autograd.grad(out, leaves, torch.from_numpy(g))
    want = torch.autograd.grad(local_attention_packed_plain(*args, w, h), leaves,
                               torch.from_numpy(g))
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=1e-5, rtol=0)
    assert (local_attention_packed.launches, local_attention_packed_bwd.launches) == launches
    # without grad the call is the plain forward itself
    with torch.no_grad():
        np.testing.assert_array_equal(local_attention_packed(*args, w, h).numpy(),
                                      local_attention_packed_plain(*args, w, h).numpy())
    assert issubclass(LocalAttentionPacked, torch.autograd.Function)


@pytest.mark.parametrize("t,w", [(20, 20), (7, 30), (20, 19), (50, 10)])
def test_widen_bias_grad(t, w):
    """K2's bias gradient over its band clamped to b = min(w, T - 1), widened
    to (H, 2w+1): the plain version's dvec has nothing outside the entries
    [w - b, w + b], and widening those entries gives it back exactly."""
    n, h, d = 2, 3, 32
    q, k, v, g, vec = _inputs(n, h, t, d, w, True, seed=7)
    dvec = local_attention_packed_bwd_plain(*map(torch.from_numpy, (q, k, v, g, vec)), w, h)[3]
    b = min(w, t - 1)
    assert dvec.shape == (h, 2 * w + 1)
    assert not dvec[:, :w - b].any() and not dvec[:, w + b + 1:].any()
    middle = dvec[:, w - b:w + b + 1].clone()
    widened = _widen_bias_grad(middle, w)
    assert widened.shape == (h, 2 * w + 1) and widened.dtype == torch.float32
    np.testing.assert_array_equal(widened.numpy(), dvec.numpy())
    if b == w:
        assert widened is middle
