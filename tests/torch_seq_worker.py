"""One rank of the port's sequence-parallel CPU tests (gloo), as a process.

    DAWN_COORDINATOR=localhost:PORT DAWN_NUM_PROCESSES=N DAWN_PROCESS_ID=R \\
        python tests/torch_seq_worker.py SPEC.pt OUT_DIR

Imports torch and the port only, never JAX: the tests compute the JAX
references in their own process. ``SPEC.pt`` holds a list of cases (plain
tensors, numbers and strings); the rank runs each on the mesh the case
names, collects the sharded results into whole tensors, and writes
``OUT_DIR/rank<R>.pt`` with one dict of results per case. Kinds:

- ``attention``: ``seq_sharded_local_attention`` of (N, T, H*D) q, k, v
  with the T5 table's vector, forward and the gradients of sum(out * g)
  with respect to q, k, v and the table;
- ``sampler``: ``FlowDiffusion.make_seq_sampler`` or ``make_batch_sampler``
  on the case's weights, inputs and noise;
- ``train``: one ``DMTrainer.make_sharded_step`` step on the case's weights,
  batch and draws: the metrics, Adam's moments, the parameters and the EMA
  after the step;
- ``dm_cli``: ``python -m dawn_tpu_torch.scripts.train_dm`` with the case's
  ``argv`` on every rank: the trainer's generator state, parameters and
  step after the run;
- ``lfg_train`` and ``pbnet_train``: one ``LFGTrainer`` or ``PBnetTrainer``
  ``make_sharded_step`` step of a trainer built from the case's seed, on its
  batch and draws: the metrics, Adam's first moments and the state after
  the step (the LFG's running statistics included).
"""

import os
import sys

import torch
import torch.distributed as dist

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from dawn_tpu_torch.parallel.distributed import maybe_initialize_distributed  # noqa: E402
from dawn_tpu_torch.parallel.mesh import (all_reduce_sum, gather_frames,  # noqa: E402
                                          gather_rows, make_mesh)


def gather(x, mesh):
    return gather_rows(gather_frames(x, mesh), mesh)


def attention(case, mesh):
    from dawn_tpu_torch.ops.local_attention import seq_sharded_local_attention
    from dawn_tpu_torch.ops.t5bias import t5_bias_windowed_vector

    rows, frames = mesh.rows(case["q"].shape[0]), mesh.frames(case["q"].shape[1])
    q, k, v = (case[n][rows, frames].clone().requires_grad_() for n in ("q", "k", "v"))
    emb = case["emb"].clone().requires_grad_() if case["emb"] is not None else None
    w, heads = case["window"], case["heads"]
    vec = t5_bias_windowed_vector(emb, w, 32, 32) if emb is not None else None
    out = seq_sharded_local_attention(q, k, v, vec, w, heads, mesh,
                                      force_stripe=case["force_stripe"])
    leaves = [x for x in (q, k, v, emb) if x is not None]
    grads = torch.autograd.grad((out * case["g"][rows, frames]).sum(), leaves)
    res = {"out": gather(out.detach(), mesh)}
    res.update({f"d{n}": gather(x, mesh) for n, x in zip("qkv", grads)})
    if emb is not None:
        res["demb"] = all_reduce_sum(grads[3], mesh.group(None))
    return res


def sampler(case, mesh):
    from dawn_tpu_torch.models.dm.flow_diffusion import FlowDiffusion, FlowDiffusionConfig
    from dawn_tpu_torch.models.dm.unet3d import Unet3D

    model = FlowDiffusion(FlowDiffusionConfig(dtype=torch.float32, **case["config"]),
                          device="cpu")
    if case["unet"] is not None:
        model.unet = Unet3D(**case["unet"])
    model.load_state_dict(case["state"])
    make = model.make_seq_sampler if case["kind_of"] == "seq" else model.make_batch_sampler
    out = make(mesh)(**case["inputs"], noise_seq=case["noise_seq"])
    return {k: gather(out[k], mesh) for k in ("sample_vid_grid", "sample_vid_conf",
                                              "sample_out_vid")}


def train(case, mesh):
    from dawn_tpu_torch.models.lfg.flow_ae import FlowAE
    from dawn_tpu_torch.train.train_dm import DMTrainConfig, DMTrainer

    trainer = DMTrainer(DMTrainConfig(**case["config"]), flow_ae=FlowAE(**case["lfg"]),
                        unet_kw=case["unet_kw"], device="cpu")
    for module, key in ((trainer.unet, "unet"), (trainer.flow_ae, "flow_ae"),
                        (trainer.face_loc, "face_loc")):
        module.load_state_dict(case[key])
    trainer.ema = [e.clone() for e in case["ema"]]
    metrics = trainer.make_sharded_step(mesh)(case["batch"], case["draws"])
    params = list(trainer.unet.parameters())
    moments = {k: [trainer.optimizer.state[p][k] for p in params] for k in ("mu", "nu")}
    return {"metrics": metrics, **moments, "params": [p.detach() for p in params],
            "ema": trainer.ema, "step": trainer.step}


def dm_cli(case, mesh):
    from dawn_tpu_torch.scripts import train_dm

    trainer = train_dm.main(case["argv"])
    return {"generator": trainer.generator.get_state(), "step": trainer.step,
            "params": [p.detach() for p in trainer.unet.parameters()]}


def lfg_train(case, mesh):
    from dawn_tpu_torch.models.lfg.flow_ae import FlowAE
    from dawn_tpu_torch.train.train_lfg import LFGTrainConfig, LFGTrainer

    torch.manual_seed(case["seed"])
    trainer = LFGTrainer(LFGTrainConfig(**case["config"]), flow_ae=FlowAE(**case["lfg"]),
                         device="cpu")
    metrics = trainer.make_sharded_step(mesh)(case["batch"], case["draws"])
    return {"metrics": metrics, "state": trainer.flow_ae.state_dict(),
            "mu": [trainer.optimizer.state[p]["mu"] for p in trainer.flow_ae.parameters()]}


def pbnet_train(case, mesh):
    from dawn_tpu_torch.models.pbnet.cvae import PBnetParams
    from dawn_tpu_torch.train.train_pbnet import PBnetTrainConfig, PBnetTrainer

    torch.manual_seed(case["seed"])
    trainer = PBnetTrainer(PBnetTrainConfig(**case["config"]), hp=PBnetParams(**case["hp"]),
                           device="cpu")
    metrics = trainer.make_sharded_step(mesh)(case["batch"], case["epoch"], case["draws"])
    params = list(trainer.model.parameters()) + list(trainer.disc.parameters())
    mu = [opt.state[p]["mu"] for opt in trainer.optimizers for p in opt.param_groups[0]["params"]]
    return {"metrics": metrics, "params": [p.detach() for p in params], "mu": mu}


def main(spec_path, out_dir):
    torch.set_num_threads(1)
    maybe_initialize_distributed(device="cpu")
    cases = torch.load(spec_path, weights_only=True)
    results = {}
    for case in cases:
        mesh = make_mesh(seq_parallel=case["seq"])
        results[case["name"]] = {"attention": attention, "sampler": sampler, "train": train,
                                 "dm_cli": dm_cli, "lfg_train": lfg_train,
                                 "pbnet_train": pbnet_train}[case["kind"]](case, mesh)
    torch.save(results, os.path.join(out_dir, f"rank{dist.get_rank()}.pt"))
    dist.destroy_process_group()


if __name__ == "__main__":
    main(*sys.argv[1:3])
