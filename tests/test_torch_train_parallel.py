"""The data-parallel LFG and PBnet steps of the port in 2 gloo processes
against the unsharded step on the whole batch, on the CPU.

The ranks are tests/torch_seq_worker.py processes (torch and the port only)
started by test_torch_util.start_ranks over localhost; each builds its
trainer from the case's seed, as this process builds the unsharded one, and
receives the whole batch and draws. The unsharded steps run here meanwhile.

- LFG: the tiny FlowAE of tests/test_trainers.py with train-mode BatchNorm,
  32x32, B=4 (2 rows a rank), scales (1, 0.5). BatchNorm's statistics are
  summed over the ranks, so the running statistics after the step are the
  whole batch's: rtol 1e-4, atol 1e-6. The loss terms: rtol 1e-5. Adam's
  first moment to 1e-2 of each net's largest magnitude and the update by
  Adam's first-step rule above that (2 * lr + 1e-7 below it): the f32
  gradient of this loss moves by up to 3.5e-3 of a net's largest entry
  under rounding alone (tests/test_torch_train_lfg_step.py), and the ranks'
  sums round in another order.
- PBnet: reemb6 at 1 layer, latent 16, ff 32, 2 heads, B=4 at T=16 with
  ragged lengths; the masked means' frame counts are all-reduced, so each
  rank's loss is its share of the whole batch's. Twice: dropout 0 with the
  z noise given, and dropout 0.1 with the z noise and the dropout masks
  drawn by the trainers' generators. Every rank draws them for the whole
  batch and keeps its rows, so the sharded step must match the unsharded
  one there too (ranks that drew masks for their own rows alone would give
  rank 1's rows rank 0's masks, and another step). The metrics: rtol 1e-5;
  Adam's first moments to 1e-4 of each model's largest; the parameters by
  AdamW's first-step rule at 1e-3.
- PBnet with the losses that need more than the whole batch's counts,
  dropout 0.1, every draw made by the trainers' generators: ssim's joint
  min and max are all-reduced (MIN, MAX, the gradient to the rank that
  holds the extreme), var's gate reads the whole batch's mean, mmd runs on
  the gathered z (its gradient back to each rank's rows) and hp's
  directions are the whole batch's, its max all-reduced. Lambdas rc, kl,
  ssim, var and mmd: the metrics to rtol 1e-5 and Adam's first moment to
  1e-5 of each leaf's largest magnitude (of 1e-3 of the model's largest for
  a leaf below that: the decoder's target T5 table gets a gradient of 1e-11,
  4e-10 of the model's largest, f32 rounding alone). With hp too: hp is a variance of second differences
  over epsilon^2 = 0.01 of the encoder's output, which rounds otherwise at
  2 rows than at 4, so the f32 rounding grows about 100-fold (measured on
  this case: 1.3e-4 relative on hp and on a leaf's first moment); there
  the terms with hp in them and the first moments are held to 1e-3.
"""

import functools

import numpy as np
import pytest
import torch

from dawn_tpu_torch.models.lfg.flow_ae import FlowAE
from dawn_tpu_torch.models.pbnet.cvae import PBnetParams
from dawn_tpu_torch.train.train_lfg import LFGTrainConfig, LFGTrainer
from dawn_tpu_torch.train.train_pbnet import PBnetTrainConfig, PBnetTrainer
from test_torch_util import start_ranks, one_torch_thread  # noqa: F401 (autouse fixture)

TINY_BN = dict(generator_kw=dict(block_expansion=8, max_features=32, num_bottleneck_blocks=1,
                                 train_bn=True),
               region_kw=dict(block_expansion=4, max_features=16, num_blocks=2, train_bn=True),
               bg_kw=dict(block_expansion=4, max_features=16, num_blocks=2, train_bn=True),
               flow_kw=dict(block_expansion=4, max_features=16, num_blocks=2, train_bn=True))
LFG_CONFIG = dict(scales=(1, 0.5), lr=2e-4)
HP = dict(pos_dim=6, eye_dim=0, latent_dim=16, ff_size=32, num_layers=1, num_heads=2,
          dropout=0.0)
PB_CONFIG = dict(kind="pose", lr=1e-4, total_steps=1000)
B, S, T = 4, 32, 16
ALL_LOSSES = {"rc": 1.0, "kl": 1.0, "ssim": 1.0, "var": 1.0, "mmd": 1.0, "hp": 1.0}
WHOLE_BATCH_LOSSES = {"pbnet_losses": {k: v for k, v in ALL_LOSSES.items() if k != "hp"},
                      "pbnet_losses_hp": ALL_LOSSES}


def _cases():
    r = np.random.RandomState(0)
    lfg_batch = {k: torch.from_numpy(r.rand(B, S, S, 3).astype(np.float32))
                 for k in ("source", "driving")}
    lfg_draws = {k: torch.from_numpy(r.randn(*shape).astype(np.float32))
                 for k, shape in (("affine", (B, 2, 3)), ("tps", (B, 1, 25)))}
    lengths = np.array([16, 12, 14, 16])
    x = (0.5 + 0.1 * r.randn(B, T, 6)).astype(np.float32)
    hubert = r.randn(B, T, 1024).astype(np.float32)
    for i, n in enumerate(lengths):
        x[i, n:] = 0.0
        hubert[i, n:] = 0.0
    pb_batch = {"x": torch.from_numpy(x), "hubert": torch.from_numpy(hubert),
                "lengths": torch.from_numpy(lengths)}
    pb_draws = {"eps": torch.from_numpy(r.randn(B, T, 16).astype(np.float32))}
    return [dict(name="lfg", kind="lfg_train", seq=1, seed=3, config=LFG_CONFIG, lfg=TINY_BN,
                 batch=lfg_batch, draws=lfg_draws),
            dict(name="pbnet", kind="pbnet_train", seq=1, seed=4, config=PB_CONFIG, hp=HP,
                 batch=pb_batch, draws=pb_draws, epoch=0),
            dict(name="pbnet_dropout", kind="pbnet_train", seq=1, seed=4, config=PB_CONFIG,
                 hp=dict(HP, dropout=0.1), batch=pb_batch, draws={}, epoch=0),
            *[dict(name=name, kind="pbnet_train", seq=1, seed=5, config=PB_CONFIG,
                   hp=dict(HP, dropout=0.1, lambdas=lambdas), batch=pb_batch, draws={},
                   epoch=0) for name, lambdas in WHOLE_BATCH_LOSSES.items()]]


def _update_rule(got, want, before, mu, lr, clear_of_max):
    """Adam's first step is about lr * sign(g): where |mu| is above
    ``clear_of_max`` of the largest the two updates agree to 1e-7 (+1e-6
    relative), elsewhere to 2 * lr + 1e-7."""
    top = max(m.abs().max().item() for m in mu)
    for g, w, b, m in zip(got, want, before, mu):
        diff = (g - w).abs()
        clear = m.abs() > clear_of_max * top
        assert diff.max() <= 2 * lr + 1e-7
        assert (diff[clear] <= 1e-7 + 1e-6 * b[clear].abs()).all()


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """The cases and a function that waits once for the two ranks' results
    (the ranks run while the tests compute their unsharded steps)."""
    cases = _cases()
    wait = start_ranks(cases, 2, str(tmp_path_factory.mktemp("ranks")))
    return {c["name"]: c for c in cases}, functools.lru_cache(maxsize=1)(wait)


def test_lfg_sharded_step_matches_unsharded(ranks):
    cases, wait = ranks
    lfg = cases["lfg"]
    torch.manual_seed(lfg["seed"])
    trainer = LFGTrainer(LFGTrainConfig(**LFG_CONFIG), flow_ae=FlowAE(**TINY_BN), device="cpu")
    lfg_before = [p.detach().clone() for p in trainer.flow_ae.parameters()]
    lfg_metrics = trainer.train_step(lfg["batch"], lfg["draws"])
    lfg_mu = [trainer.optimizer.state[p]["mu"] for p in trainer.flow_ae.parameters()]
    lfg_state = trainer.flow_ae.state_dict()
    for rank in wait():
        got = rank["lfg"]
        for k, v in lfg_metrics.items():
            np.testing.assert_allclose(got["metrics"][k], v, rtol=1e-5, err_msg=k)
        for k, v in lfg_state.items():
            if "running" in k:
                np.testing.assert_allclose(got["state"][k].numpy(), v.numpy(), rtol=1e-4,
                                           atol=1e-6, err_msg=k)
            elif k.endswith("num_batches_tracked"):
                assert torch.equal(got["state"][k], v), k
        names = [n for n, _ in trainer.flow_ae.named_parameters()]
        for net in ("generator", "region_predictor", "bg_predictor", "pixelwise_flow_predictor"):
            idx = [i for i, n in enumerate(names) if n.startswith(net + ".")]
            top = max(lfg_mu[i].abs().max().item() for i in idx)
            for i in idx:
                torch.testing.assert_close(got["mu"][i], lfg_mu[i], rtol=0, atol=1e-2 * top)
            _update_rule([got["state"][names[i]] for i in idx],
                         [lfg_state[names[i]] for i in idx], [lfg_before[i] for i in idx],
                         [lfg_mu[i] for i in idx], LFG_CONFIG["lr"], 1e-2)


@pytest.mark.parametrize("name", ["pbnet", "pbnet_dropout"])
def test_pbnet_sharded_step_matches_unsharded(ranks, name):
    cases, wait = ranks
    pb = cases[name]
    torch.manual_seed(pb["seed"])
    pbt = PBnetTrainer(PBnetTrainConfig(**PB_CONFIG), hp=PBnetParams(**pb["hp"]), device="cpu")
    pb_params = list(pbt.model.parameters()) + list(pbt.disc.parameters())
    pb_before = [p.detach().clone() for p in pb_params]
    pb_metrics = pbt.train_step(pb["batch"], 0, pb["draws"])
    pb_mu = [opt.state[p]["mu"] for opt in pbt.optimizers for p in opt.param_groups[0]["params"]]
    for rank in wait():
        got = rank[name]
        for k, v in pb_metrics.items():
            np.testing.assert_allclose(got["metrics"][k], v, rtol=1e-5, err_msg=k)
        n_g = len(list(pbt.model.parameters()))
        for part in (slice(0, n_g), slice(n_g, None)):
            top = max(m.abs().max().item() for m in pb_mu[part])
            for a, b in zip(got["mu"][part], pb_mu[part]):
                torch.testing.assert_close(a, b, rtol=0, atol=1e-4 * top)
            _update_rule(got["params"][part], [p.detach() for p in pb_params[part]],
                         pb_before[part], pb_mu[part], PB_CONFIG["lr"], 1e-3)


@pytest.mark.parametrize("name", list(WHOLE_BATCH_LOSSES))
def test_pbnet_sharded_whole_batch_losses_match_unsharded(ranks, name):
    cases, wait = ranks
    pb = cases[name]
    torch.manual_seed(pb["seed"])
    pbt = PBnetTrainer(PBnetTrainConfig(**PB_CONFIG), hp=PBnetParams(**pb["hp"]), device="cpu")
    metrics = pbt.train_step(pb["batch"], 0, pb["draws"])
    assert set(pb["hp"]["lambdas"]) <= set(metrics)
    with_hp = "hp" in pb["hp"]["lambdas"]
    mu = [opt.state[p]["mu"] for opt in pbt.optimizers for p in opt.param_groups[0]["params"]]
    top = max(m.abs().max().item() for m in mu)
    tol = 1e-3 if with_hp else 1e-5
    for rank in wait():
        got = rank[name]
        for k, v in metrics.items():
            rtol = tol if k in ("hp", "mixed", "g_total") else 1e-5
            np.testing.assert_allclose(got["metrics"][k], v, rtol=rtol, err_msg=k)
        for i, (a, b) in enumerate(zip(got["mu"], mu)):
            scale = max(b.abs().max().item(), 1e-3 * top)
            torch.testing.assert_close(a, b, rtol=0, atol=tol * scale,
                                       msg=lambda m, i=i: f"leaf {i}: {m}")
