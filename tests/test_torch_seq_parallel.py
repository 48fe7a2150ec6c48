"""Sequence parallelism of the port against the JAX package on the CPU.

- The stripe forward (K5's plain version, with :func:`stripe_bias`) against
  JAX ``local_attention_packed_stripe(interpret=True)`` and
  ``_stripe_attn_einsum`` over the cases of ``TestStripeKernel``
  (``tests/test_local_attention.py:281-410``), atol 2e-5 as there; the
  stripe backward (K6's plain version) against ``_stripe_bwd_pallas(
  interpret=True)`` at atol 2e-4 as there, its dvec against the diagonal
  sums of JAX's dbias tile; ``LocalAttentionStripe`` on CPU tensors
  against torch autograd of the plain forward (1e-5).
- ``seq_sharded_local_attention`` in 2 and 4 gloo processes
  (``tests/torch_seq_worker.py``), forward and the gradients of sum(out *
  g) with respect to q, k, v and the T5 table, against JAX
  ``seq_sharded_local_attention`` (einsum stripe) on the 8-device CPU
  mesh with the same 'seq' (and 'data') split, over the cases of
  ``tests/test_local_attention.py:485-530`` (48 frames / w 10 / 4 heads;
  44 / 11 without bias, so t_loc = w at 4 shards; 32 / 8, the gradient
  case; the forced single shard at 50 / 12; one 2 x 2 'data' x 'seq'
  mesh). Batch sizes divide the 'data' ranks. atol 1e-5 as there (the
  table gradient, a sum over every stripe: 1e-4).
- ``make_seq_sampler`` in 2 and 4 processes against JAX
  ``make_seq_sampler`` on a 2-device 'seq' mesh (JAX 32x32, T 8, w 2, 2
  DDIM steps, the UNet of ``tests/test_multichip_inference.py:24-38``, LFG
  width 256 with one bottleneck block), the same numpy weights, and the
  noise JAX draws from its key, handed to the port as ``noise_seq``;
  tolerance 1e-3 as in ``tests/test_torch_flow_diffusion.py`` (the DDIM
  divides by a data-dependent quantile and the decode warps by the sampled
  flow). ``make_batch_sampler`` over 2 'data' ranks, one row each, against
  JAX ``make_batch_sampler`` on a 2-device 'data' mesh with the same 2-row
  inputs and the noise JAX draws for them: 1e-4 (measured 7.6e-5 at most,
  in the decoded video).

The workers import torch and the port only; the JAX references are
computed here while they run. Each process count runs all its cases in one
launch.
"""

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from dawn_tpu.models.dm.flow_diffusion import FlowDiffusion as JaxFlowDiffusion
from dawn_tpu.models.dm.flow_diffusion import FlowDiffusionConfig as JaxConfig
from dawn_tpu.models.dm.unet3d import Unet3D as JaxUnet3D
from dawn_tpu.ops import local_attention as jla
from dawn_tpu.ops.t5bias import t5_bias_windowed_vector as jax_t5_vector
from dawn_tpu.parallel.mesh import make_mesh as jax_make_mesh
from dawn_tpu_torch.models.dm.flow_diffusion import FlowDiffusion, FlowDiffusionConfig
from dawn_tpu_torch.models.dm.unet3d import Unet3D
from dawn_tpu_torch.ops import local_attention as la
from dawn_tpu_torch.ops.t5bias import t5_bias_windowed_vector as port_t5_vector
from dawn_tpu_torch.weights.jax_bridge import load_flow_diffusion_variables
from test_torch_util import random_tree, start_ranks, one_torch_thread  # noqa: F401


# ------------------------------------------------------------ stripe pieces

def _stripe_inputs(n, heads, dh, t_q, t_k, seed):
    rng = np.random.RandomState(100 + seed)
    q = (rng.randn(n, t_q, heads * dh) * dh ** -0.5).astype(np.float32)
    k, v = (rng.randn(n, t_k, heads * dh).astype(np.float32) for _ in range(2))
    emb = rng.randn(32, heads).astype(np.float32)
    return q, k, v, emb


def _pads(t_q, t_k):
    return jla.PACKED_TQ_MULTIPLE * -(-t_q // jla.PACKED_TQ_MULTIPLE), 128 * -(-t_k // 128)


def _port_vec(emb, w):
    return port_t5_vector(torch.from_numpy(emb), w, 32, 32)


def _jax_bias(heads, t_loc, w, vec, tq, tk, left, right):
    """JAX's stripe bias with its global-edge masks
    (``dawn_tpu/ops/local_attention.py:688-717``)."""
    bias = jla._stripe_bias(heads, t_loc, w, vec, tq, tk)
    jj = np.arange(tk)[None, :]
    if left:
        bias = bias + jnp.asarray(np.where(jj < w, jla.NEG_INF, 0.0).astype(np.float32))[None]
    if right:
        bias = bias + jnp.asarray(np.where((jj >= w + t_loc) & (jj < t_loc + 2 * w),
                                           jla.NEG_INF, 0.0).astype(np.float32))[None]
    return bias


# (n, heads, dh, t_loc, w, left edge, halo keys set to +-1e3): the
# rectangular stripe, odd lengths with 3 heads (96 lanes), the left-edge
# mask with its halo keys at +-1e3 (they must get exactly no weight)
STRIPES = {"rect": (4, 8, 32, 24, 8, False, False),
           "odd": (2, 3, 32, 13, 5, False, False),
           "left_edge_halo_1e3": (2, 4, 32, 16, 4, True, True)}


@pytest.mark.parametrize("case", list(STRIPES))
def test_stripe_forward_matches_jax(case):
    n, heads, dh, t_loc, w, left, poison = STRIPES[case]
    t_k = t_loc + 2 * w
    q, k, v, emb = _stripe_inputs(n, heads, dh, t_loc, t_k, len(case))
    if poison:
        k[:, :w], v[:, :w] = 1e3, -1e3
    tq, tk = _pads(t_loc, t_k)
    bias = _jax_bias(heads, t_loc, w, jax_t5_vector(jnp.asarray(emb), w, 32, 32), tq, tk,
                     left, False)
    want = np.asarray(jla.local_attention_packed_stripe(jnp.asarray(q), jnp.asarray(k),
                                                        jnp.asarray(v), bias, heads,
                                                        interpret=True))
    einsum = np.asarray(jla._stripe_attn_einsum(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                                bias, heads))
    port_bias = la.stripe_bias(heads, t_loc, w, _port_vec(emb, w), tq, tk, left_edge=left)
    np.testing.assert_allclose(port_bias.numpy(), np.asarray(bias), atol=0, rtol=0)
    tq_, kq, vq = (torch.from_numpy(x) for x in (q, k, v))
    got = la.local_attention_packed_stripe_plain(tq_, kq, vq, port_bias, heads).numpy()
    np.testing.assert_allclose(got, want, atol=2e-5, rtol=0)
    np.testing.assert_allclose(got, einsum, atol=2e-5, rtol=0)
    # the wrapper on CPU tensors builds the same bias from the vector and flag
    wrapped = la.local_attention_packed_stripe(tq_, kq, vq, _port_vec(emb, w), w, heads,
                                               left, False).numpy()
    np.testing.assert_allclose(wrapped, want, atol=2e-5, rtol=0)


# (n, heads, dh, t_loc, w, left edge, right edge, bias): JAX's backward case
# as an interior stripe, then with each edge and both, and without a bias
STRIPE_BWD = {"interior": (2, 4, 32, 20, 6, False, False, True),
              "left": (2, 4, 32, 20, 6, True, False, True),
              "right": (2, 4, 32, 20, 6, False, True, True),
              "both_edges": (2, 4, 32, 13, 5, True, True, True),
              "no_bias": (2, 4, 32, 20, 6, True, False, False)}


@pytest.mark.parametrize("case", list(STRIPE_BWD))
def test_stripe_backward_matches_jax(case):
    n, heads, dh, t_loc, w, left, right, with_bias = STRIPE_BWD[case]
    t_k = t_loc + 2 * w
    q, k, v, emb = _stripe_inputs(n, heads, dh, t_loc, t_k, 7 + len(case))
    g = np.random.RandomState(9).randn(n, t_loc, heads * dh).astype(np.float32)
    tq, tk = _pads(t_loc, t_k)
    vec = torch_vec = None
    if with_bias:
        vec, torch_vec = jax_t5_vector(jnp.asarray(emb), w, 32, 32), _port_vec(emb, w)
    bias = _jax_bias(heads, t_loc, w, vec, tq, tk, left, right)
    np.testing.assert_allclose(la.stripe_bias(heads, t_loc, w, torch_vec, tq, tk, left, right)
                               .numpy(), np.asarray(bias), atol=0, rtol=0)
    dq, dk, dv, dbias = (np.asarray(x) for x in jla._stripe_bwd_pallas(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), bias, jnp.asarray(g), heads,
        interpret=True))
    got = la.local_attention_packed_stripe_bwd_plain(
        *(torch.from_numpy(x) for x in (q, k, v, g)), torch_vec, w, heads, left, right)
    for name, a, b in zip(("dq", "dk", "dv"), got, (dq, dk, dv)):
        np.testing.assert_allclose(a.numpy(), b, atol=2e-4, rtol=0, err_msg=name)
    if not with_bias:
        assert got[3] is None
        return
    diag = np.stack([[sum(dbias[h, i, i + r] for i in range(t_loc) if i + r < t_k)
                      for r in range(2 * w + 1)] for h in range(heads)])
    np.testing.assert_allclose(got[3].numpy(), diag, atol=2e-4, rtol=0, err_msg="dvec")


def test_stripe_autograd_on_cpu():
    """LocalAttentionStripe (the plain forward and backward on CPU tensors)
    against torch autograd of the plain forward, edges on."""
    n, heads, dh, t_loc, w = 2, 4, 8, 12, 5
    q, k, v, emb = _stripe_inputs(n, heads, dh, t_loc, t_loc + 2 * w, 3)
    g = torch.from_numpy(np.random.RandomState(4).randn(n, t_loc, heads * dh)
                         .astype(np.float32))
    leaves = [torch.from_numpy(x).requires_grad_() for x in (q, k, v)]
    table = torch.from_numpy(emb).requires_grad_()
    vec = port_t5_vector(table, w, 32, 32)
    out = la.local_attention_packed_stripe(*leaves, vec, w, heads, True, True)
    assert "LocalAttentionStripe" in type(out.grad_fn).__name__
    got = torch.autograd.grad(out, leaves + [table], g)
    bias = la.stripe_bias(heads, t_loc, w, port_t5_vector(table, w, 32, 32),
                          left_edge=True, right_edge=True)
    ref = torch.autograd.grad(la.local_attention_packed_stripe_plain(*leaves, bias, heads),
                              leaves + [table], g)
    for a, b in zip(got, ref):
        torch.testing.assert_close(a, b, atol=1e-5, rtol=0)


# ----------------------------------------------------- gloo processes vs JAX

# (n, heads, dh, t, w, bias, seq shards, data ranks, force_stripe)
ATTENTION = {
    2: {"t48_w10_seq2": (4, 4, 8, 48, 10, True, 2, 1, False),
        "t32_w8_seq2": (2, 2, 8, 32, 8, True, 2, 1, False),
        "forced_single_shard_t50_w12": (4, 4, 8, 50, 12, True, 1, 2, True)},
    4: {"t48_w10_seq4": (4, 4, 8, 48, 10, True, 4, 1, False),
        "t44_w11_no_bias_seq4": (2, 2, 16, 44, 11, False, 4, 1, False),
        "t32_w8_seq4": (2, 2, 8, 32, 8, True, 4, 1, False),
        "t48_w10_data2_seq2": (4, 4, 8, 48, 10, True, 2, 2, False)},
}
IMG, T, STEPS = 32, 8, 2
FD_KW = dict(img_size=IMG, pose_dim=6, win_width=2, sampling_timesteps=STEPS,
             attn_mode="local", dim_mults=(1, 2), lfg_max_features=256, lfg_num_bottleneck=1)
UNET_KW = dict(dim=8, dim_mults=(1, 2), channels=275, cond_pose=6, win_width=2, attn_heads=2,
               attn_dim_head=8, attn_mode="local")


def _attention_inputs(n, heads, dh, t, seed):
    rng = np.random.RandomState(211 + seed)
    hd = heads * dh
    q = (rng.randn(n, t, hd) * dh ** -0.5).astype(np.float32)
    k, v, g = (rng.randn(n, t, hd).astype(np.float32) for _ in range(3))
    return q, k, v, g, rng.randn(32, heads).astype(np.float32)


def _jax_attention(case):
    """JAX seq_sharded_local_attention's output and the gradients of
    sum(out * g) (einsum stripe, the CPU mesh split as the port's)."""
    n, heads, dh, t, w, with_bias, seq, data, force = case
    q, k, v, g, emb = _attention_inputs(n, heads, dh, t, t + w)
    mesh = jax_make_mesh(seq * data, seq_parallel=seq)

    def loss(p):
        vec = jax_t5_vector(p["emb"], w, 32, 32) if with_bias else None
        out = jla.seq_sharded_local_attention(p["q"], p["k"], p["v"], vec, w, heads, mesh,
                                              use_pallas=False, force_stripe=force)
        return jnp.sum(out * g), out

    params = {"q": q, "k": k, "v": v, "emb": emb}
    (_, out), grads = jax.jit(jax.value_and_grad(loss, has_aux=True))(params)
    want = {"out": out, "dq": grads["q"], "dk": grads["k"], "dv": grads["v"]}
    if with_bias:
        want["demb"] = grads["emb"]
    return {key: np.asarray(x) for key, x in want.items()}


def _sampler_inputs(b):
    rng = np.random.RandomState(0)
    return {"sample_img": rng.rand(b, IMG, IMG, 3).astype(np.float32),
            "audio_hubert": rng.randn(b, T, 1024).astype(np.float32),
            "pose": rng.randn(b, T, 6).astype(np.float32),
            "eye": rng.rand(b, T, 2).astype(np.float32),
            "bbox": np.tile([8, 24, 8, 24, IMG, IMG], (b, 1)).astype(np.float32)}


def _jax_noise(key, shape):
    """The gaussians JAX's ddim_sample draws from ``key``: x_T, then one per
    step (``dawn_tpu/models/dm/diffusion.py:141-175``)."""
    rng, rinit = jax.random.split(key)
    out = [jax.random.normal(rinit, shape)]
    for _ in range(STEPS):
        rng, rstep = jax.random.split(rng)
        out.append(jax.random.normal(rstep, shape))
    return np.stack([np.asarray(x) for x in out])


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Both process counts' port results (launched first) and the JAX
    references (computed while the workers run)."""
    jfd = JaxFlowDiffusion(JaxConfig(**FD_KW))
    jfd.unet = JaxUnet3D(**UNET_KW)
    variables = random_tree(jax.eval_shape(jfd.init_variables, jax.random.PRNGKey(0)), 9)
    port = FlowDiffusion(FlowDiffusionConfig(dtype=torch.float32, **FD_KW), device="cpu")
    port.unet = Unet3D(**UNET_KW)
    load_flow_diffusion_variables(port, variables)
    state = port.state_dict()
    noise1 = _jax_noise(jax.random.PRNGKey(2), (1, T, IMG // 4, IMG // 4, 3))
    noise2 = _jax_noise(jax.random.PRNGKey(3), (2, T, IMG // 4, IMG // 4, 3))
    sampler = dict(kind="sampler", config=FD_KW, unet=UNET_KW, state=state, data=1)

    def as_torch(d):
        return {k: torch.from_numpy(np.asarray(x, np.float32)) for k, x in d.items()}

    waits = {}
    for world, cases in ATTENTION.items():
        specs = []
        for name, case in cases.items():
            n, heads, dh, t, w, with_bias, seq, _, force = case
            q, k, v, g, emb = _attention_inputs(n, heads, dh, t, t + w)
            specs.append(dict(name=name, kind="attention", seq=seq, window=w, heads=heads,
                              force_stripe=force, emb=torch.from_numpy(emb) if with_bias
                              else None, **as_torch(dict(q=q, k=k, v=v, g=g))))
        specs.append(dict(sampler, name=f"seq_sampler_{world}", seq=world, kind_of="seq",
                          inputs=as_torch(_sampler_inputs(1)),
                          noise_seq=torch.from_numpy(noise1)))
        if world == 2:
            specs.append(dict(sampler, name="batch_sampler_2", seq=1, kind_of="batch",
                              inputs=as_torch(_sampler_inputs(2)),
                              noise_seq=torch.from_numpy(noise2)))
        waits[world] = start_ranks(specs, world, str(tmp_path_factory.mktemp(f"ranks{world}")))

    want = {name: _jax_attention(case) for cases in ATTENTION.values()
            for name, case in cases.items()}
    inp = {k: jnp.asarray(x) for k, x in _sampler_inputs(1).items()}
    jax_mesh = jax_make_mesh(2, seq_parallel=2)
    with jax_mesh:
        out = jfd.make_seq_sampler(jax_mesh)(variables, jax.random.PRNGKey(2), *inp.values(),
                                             inp["pose"][:, 0], inp["eye"][:, 0])
        want["seq_sampler"] = {k: np.asarray(x) for k, x in out.items()}
    inp = {k: jnp.asarray(x) for k, x in _sampler_inputs(2).items()}
    data_mesh = jax_make_mesh(2)
    with data_mesh:
        out = jfd.make_batch_sampler(data_mesh)(variables, jax.random.PRNGKey(3),
                                                *inp.values(), inp["pose"][:, 0],
                                                inp["eye"][:, 0])
        want["batch_sampler_2"] = {k: np.asarray(x) for k, x in out.items()}
    return {world: wait() for world, wait in waits.items()}, want


def _check_ranks_agree(results, name):
    """Every rank gathered the same whole tensors."""
    for r, res in enumerate(results[1:], 1):
        for key, x in res[name].items():
            torch.testing.assert_close(x, results[0][name][key], atol=0, rtol=0,
                                       msg=f"rank {r} {name} {key}")


@pytest.mark.parametrize("world,name", [(w, n) for w, cases in ATTENTION.items()
                                        for n in cases])
def test_seq_sharded_attention_matches_jax(runs, world, name):
    results, want = runs
    _check_ranks_agree(results[world], name)
    got = results[world][0][name]
    assert sorted(got) == sorted(want[name])
    for key in want[name]:
        np.testing.assert_allclose(got[key].numpy(), want[name][key], rtol=0,
                                   atol=1e-4 if key == "demb" else 1e-5, err_msg=key)


@pytest.mark.parametrize("world", [2, 4])
def test_seq_sampler_matches_jax(runs, world):
    results, want = runs
    name = f"seq_sampler_{world}"
    _check_ranks_agree(results[world], name)
    for key, x in results[world][0][name].items():
        assert x.shape == want["seq_sampler"][key].shape, key
        np.testing.assert_allclose(x.numpy(), want["seq_sampler"][key], atol=1e-3, rtol=0,
                                   err_msg=key)


def test_batch_sampler_matches_one_process(runs):
    """The 2-rank batch sampler (one row a rank) against JAX's
    ``make_batch_sampler``, which computes what one process samples for
    both rows."""
    results, want = runs
    _check_ranks_agree(results[2], "batch_sampler_2")
    for key, x in results[2][0]["batch_sampler_2"].items():
        assert x.shape == want["batch_sampler_2"][key].shape, key
        np.testing.assert_allclose(x.numpy(), want["batch_sampler_2"][key], atol=1e-4, rtol=0,
                                   err_msg=key)
