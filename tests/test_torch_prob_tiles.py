"""K1p, the packed kernel with bf16 probability tiles, against dawn_tpu on the CPU.

The port's plain K1p (``local_attention_packed_plain(..., prob_dtype=
torch.bfloat16)``, what a CPU tensor runs through ``local_attention_packed``)
is held against the JAX package's ``local_attention_packed(prob_dtype=
jnp.bfloat16, interpret=True)``, its Pallas body in interpret mode.

The inputs lie on a dyadic grid: q in multiples of 1/16 in [-1, 1], k in
multiples of 1/8 in [-2, 2], the bias vector in multiples of 1/64 in [-2,
2]. Every score is then exact in f32 whatever the order of its sum, so the
bf16 rounding of s - m is the same in every implementation. (On Gaussian
inputs one f32 ulp of a score can flip that rounding and move an entry of p
by 2^-8 |s - m|, as much as K1p differs from K1, so such inputs cannot tell a
right model of the rounding from a wrong one.) Tolerances: f32 within 1e-5
of max|ref|, bf16 within one bf16 ulp of each entry plus 2^-14 of max|ref|
(``assert_bf16_close``). In f32 both wrong readings of the JAX code fail
that tolerance: rounding the exp's result to bf16 as well, and no rounding
(K1's function). The CUDA kernel runs only on the card (chip_smoke.py's
``kernel K1p`` holds it against this plain version there).
"""

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from dawn_tpu.ops.local_attention import local_attention_packed as jax_packed
from dawn_tpu_torch.ops import local_attention as la
from dawn_tpu_torch.scripts import bench_attention
from test_torch_util import assert_bf16_close, one_torch_thread  # noqa: F401 (autouse fixture)

HEADS = 4
# (T, window, with bias): 2-warp rows (T=20) and an odd T, a window inside T
# and one past it
CASES = [(t, w, True) for t in (20, 37) for w in (5, 40)] + [(20, 5, False), (37, 40, False)]


def _dyadic(t: int, w: int, bias: bool, seed: int):
    rng = np.random.RandomState(seed)
    hd = HEADS * 32
    q = (rng.randint(-16, 17, size=(2, t, hd)) / 16.0).astype(np.float32)
    k = (rng.randint(-16, 17, size=(2, t, hd)) / 8.0).astype(np.float32)
    v = rng.randn(2, t, hd).astype(np.float32)
    vec = (rng.randint(-128, 129, size=(HEADS, 2 * w + 1)) / 64.0).astype(np.float32)
    return q, k, v, (vec if bias else None)


def _round_exp_too(q, k, v, vec, w):
    """The wrong reading that rounds exp's result to bf16 as well."""
    n, t, hd = q.shape

    def split(x):
        return x.float().reshape(n, t, HEADS, 32).transpose(1, 2)

    s = split(q) @ split(k).transpose(-1, -2) + la.windowed_bias(t, w, vec, "cpu")[None]
    s = s - s.amax(dim=-1, keepdim=True)
    p = torch.exp(s.to(torch.bfloat16).float()).to(torch.bfloat16).float()
    o = (p @ split(v)) / p.sum(dim=-1, keepdim=True)
    return o.transpose(1, 2).reshape(n, t, hd)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("t,w,bias", CASES, ids=lambda x: str(x))
def test_plain_k1p_matches_jax_interpret(t, w, bias, dtype):
    q, k, v, vec = _dyadic(t, w, bias, seed=t * 7 + w)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    ref = np.asarray(jax.jit(lambda a, b, c, d: jax_packed(
        a, b, c, d, w, heads=HEADS, prob_dtype=jnp.bfloat16, interpret=True))(
        *(jnp.asarray(x, jdt) for x in (q, k, v)),
        None if vec is None else jnp.asarray(vec))).astype(np.float32)
    tq, tk, tv = (torch.from_numpy(x).to(tdt) for x in (q, k, v))
    tvec = None if vec is None else torch.from_numpy(vec)
    got = la.local_attention_packed_plain(tq, tk, tv, tvec, w, HEADS, prob_dtype=torch.bfloat16)
    # on a CPU tensor the wrapper is the plain version, with no launch
    launches = la.local_attention_packed_prob.launches
    wrapped = la.local_attention_packed(tq, tk, tv, tvec, w, HEADS, prob_dtype=torch.bfloat16)
    assert torch.equal(wrapped, got) and la.local_attention_packed_prob.launches == launches
    if dtype == "bfloat16":
        assert_bf16_close(got, ref, f"K1p T={t} w={w} bias={bias}")
        return
    tol = 1e-5 * float(np.abs(ref).max())
    np.testing.assert_allclose(got.numpy(), ref, atol=tol, rtol=0)
    wrong = {"exp result rounded too": _round_exp_too(tq, tk, tv, tvec, w),
             "no rounding (K1)": la.local_attention_packed_plain(tq, tk, tv, tvec, w, HEADS)}
    for name, out in wrong.items():
        err = float(np.abs(out.numpy() - ref).max())
        assert err > tol, f"the reading '{name}' passes the tolerance: {err} <= {tol}"


def test_k1p_refuses_autograd_and_other_dtypes():
    q, k, v, vec = (torch.from_numpy(x) for x in _dyadic(20, 5, True, seed=1))
    with pytest.raises(RuntimeError, match="no backward"):
        la.local_attention_packed(q.requires_grad_(True), k, v, vec, 5, HEADS,
                                  prob_dtype=torch.bfloat16)
    with torch.no_grad():       # no graph: the forward runs
        assert la.local_attention_packed(q, k, v, vec, 5, HEADS,
                                         prob_dtype=torch.bfloat16).shape == q.shape
    with pytest.raises(ValueError, match="prob_dtype"):
        la.local_attention_packed(q.detach(), k, v, vec, 5, HEADS, prob_dtype=torch.float16)


def test_bench_attention_script_on_cpu():
    args = bench_attention.parse_args(["--prob-dtype", "bf16", "--stripe", "2",
                                       "--seq-composed", "--skip-banded"])
    assert (args.n, args.h, args.t, args.d, args.window, args.dtype) == (1024, 8, 200, 32, 40,
                                                                         "bf16")
    assert args.prob_dtype == "bf16" and args.stripe == 2 and args.seq_composed
    assert args.skip_banded and not args.skip_pallas and args.device is None
    res = bench_attention.main(["--device", "cpu", "--n", "2", "--h", "2", "--t", "24",
                                "--window", "4", "--prob-dtype", "bf16", "--stripe", "2",
                                "--seq-composed"])
    assert set(res) == {"banded_ms", "pallas_ms", "pallas_vs_banded_mse", "packed_ms",
                        "prob_ms", "prob_vs_packed_mse", "stripe_ms", "stripe_plain_ms",
                        "stripe_mse", "stripe_fwd_bwd_ms", "composed_ms",
                        "composed_packed_ms", "composed_mse", "composed_fwd_bwd_ms",
                        "full_ms", "pallas_vs_full_mse"}
    # on the CPU every line is a plain version: K3's is the banded form, K5's
    # the stripe form, the composed stripe on one rank is K1's function
    assert res["pallas_vs_banded_mse"] == 0 and res["stripe_mse"] == 0
    assert res["composed_mse"] < 1e-10
    assert 0 < res["prob_vs_packed_mse"] < 1e-3
