"""STGCN-feature evaluation — accuracy / FID / diversity / multimodality
scored in a recognizer's feature space.

Port of ``dawn_tpu/evaluate/stgcn_eval.py`` (PBnet/src/evaluate/stgcn/
evaluate.py:10-102: per-loader accuracy, activation statistics,
diversity/multimodality, FID against the ground-truth loader's statistics,
flattened ``{metric}_{key}_{set}`` result keys) on the port's
:class:`~dawn_tpu_torch.models.pbnet.stgcn.STGCN` and the metric functions
of :mod:`dawn_tpu_torch.evaluate.metrics`.

A released recognizer ``.tar`` (a state dict in the reference's layout)
loads through :func:`load_stgcn`. :func:`make_dawn_head_stgcn` builds the
random-feature recognizer over the 8-node 'dawn_head' graph from a seeded
``torch.Generator``, with torch's default initialisation (the reference's).
A torch generator cannot reproduce the JAX package's ``PRNGKey`` init, so
this recognizer's weights are the port's own: the port and the JAX package
give the same features only from the same weights, which the tests pass
across with the JAX package's ``convert_stgcn`` of the port's state dict.

Motions are (N, T, V, C) numpy arrays; ``loaders`` is
{key: {"train": (motions, labels), "test": ...}} with a "gt" key that
supplies the FID reference statistics.
"""

from __future__ import annotations

import math
from typing import Dict, Mapping, Optional, Tuple

import numpy as np
import torch

from dawn_tpu_torch import resolve_device
from dawn_tpu_torch.evaluate.metrics import (activation_statistics, diversity_multimodality,
                                             frechet_from_stats, recognition_accuracy)
from dawn_tpu_torch.models.pbnet.stgcn import STGCN, build_graph


def load_stgcn(ckpt_path: str, in_channels: Optional[int] = None,
               num_class: Optional[int] = None, device=None) -> STGCN:
    """A reference recognizer checkpoint -> the port's STGCN in eval mode.

    ``in_channels`` and ``num_class`` come from the checkpoint itself (the
    width of data_bn over V gives C, the fcn weight the class count); pass
    them only to assert an expectation: a mismatch raises here instead of
    failing later at a reshape. The graph is the checkpoint's 'A' buffer.
    The state dict loads strictly."""
    sd = torch.load(ckpt_path, map_location="cpu", weights_only=True)
    v = int(sd["A"].shape[1])
    ckpt_c = int(sd["data_bn.weight"].shape[0]) // v
    ckpt_classes = int(sd["fcn.weight"].shape[0])
    if in_channels is not None and in_channels != ckpt_c:
        raise ValueError(
            f"checkpoint expects (V={v}, C={ckpt_c}) motions — feature dim "
            f"{in_channels} does not match C={ckpt_c}; motion dumps must "
            f"reshape to the checkpoint's V*C={v * ckpt_c} per frame")
    if num_class is not None and num_class != ckpt_classes:
        raise ValueError(f"checkpoint has {ckpt_classes} classes, requested {num_class}")
    model = STGCN(ckpt_c, ckpt_classes, sd["A"].numpy(),
                  edge_importance_weighting=any(k.startswith("edge_importance") for k in sd))
    model.load_state_dict(sd, strict=True)
    return model.to(resolve_device(device)).eval()


def make_dawn_head_stgcn(num_class: int, generator: torch.Generator, device=None) -> STGCN:
    """A fresh recognizer over the 8-node DAWN head graph (pose 6 + blink 2
    as V=8, C=1, the 'spatial' partitions), in eval mode. Every conv weight
    and bias is drawn from ``generator`` (a CPU generator) uniformly in
    +-1/sqrt(fan_in), torch's default; BatchNorms and edge importances start
    at their defaults. So a seed gives the same recognizer on any device."""
    model = STGCN(1, num_class, build_graph("dawn_head", "spatial"))
    with torch.no_grad():
        for module in model.modules():
            if isinstance(module, torch.nn.Conv2d):
                bound = 1.0 / math.sqrt(module.weight[0].numel())
                for p in (module.weight, module.bias):
                    p.copy_((torch.rand(p.shape, generator=generator) * 2 - 1) * bound)
    return model.to(resolve_device(device)).eval()


@torch.no_grad()
def compute_features(model: STGCN, motions: np.ndarray, batch_size: int = 64
                     ) -> Tuple[np.ndarray, np.ndarray]:
    """(N, T, V, C) motions -> (features (N, 256), logits (N, num_class))
    as f32 numpy, batched through the model on its device
    (evaluate.py:35-45 compute_features)."""
    device = model.A.device
    feats, logits = [], []
    for i in range(0, motions.shape[0], batch_size):
        x = torch.as_tensor(np.asarray(motions[i:i + batch_size], np.float32), device=device)
        out = model(x)
        feats.append(out["features"].float().cpu().numpy())
        logits.append(out["yhat"].float().cpu().numpy())
    return np.concatenate(feats), np.concatenate(logits)


class STGCNEvaluation:
    """evaluate/stgcn/evaluate.py::Evaluation over numpy loaders.

    loaders: {key: {"train": (motions, labels), "test": (motions, labels)}}
    with motions (N, T, V, C) float and labels (N,) int; it must hold a "gt"
    key, whose activation statistics anchor every FID (evaluate.py:88-96)."""

    def __init__(self, model: STGCN, num_classes: int, seed: int = 0, batch_size: int = 64):
        self.model = model
        self.num_classes = num_classes
        self.seed = seed
        self.batch_size = batch_size

    def evaluate(self, loaders: Mapping[str, Mapping[str, tuple]]) -> Dict[str, float]:
        metrics_all: Dict[str, Dict[str, float]] = {}
        for sets in ("train", "test"):
            computed: Dict[str, tuple] = {}
            metrics: Dict[str, float] = {}
            for key, loader_sets in loaders.items():
                motions, labels = loader_sets[sets]
                feats, logits = compute_features(self.model, motions, self.batch_size)
                metrics[f"accuracy_{key}"], _ = recognition_accuracy(logits, labels)
                computed[key] = activation_statistics(feats)
                div, mult = diversity_multimodality(feats, labels, self.num_classes,
                                                    seed=self.seed)
                metrics[f"diversity_{key}"] = div
                metrics[f"multimodality_{key}"] = mult
            gt_stats = computed["gt"]
            for key, stats in computed.items():
                metrics[f"fid_{key}"] = frechet_from_stats(gt_stats, stats)
            metrics_all[sets] = metrics
        return {f"{k}_{sets}": v for sets in ("train", "test")
                for k, v in metrics_all[sets].items()}
