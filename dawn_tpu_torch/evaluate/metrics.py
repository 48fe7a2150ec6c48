"""Evaluation metrics for generated motion and video (host numpy).

A copy of ``dawn_tpu/evaluate/metrics.py``, kept here so that the port
imports nothing of the JAX package; the same inputs and seeds give the same
numbers, bit for bit (``np.random.RandomState`` draws included), except
where the JAX package's ``sqrtm(disp=False)`` sets off its eps retry by
SciPy 1.17's deprecation warning alone: this copy calls ``sqrtm`` without
``disp``, so that every SciPy version takes the reference's path (the plain
root, the eps retry only for a product without a finite, warning-free
root), and differs there by the retry's offset, under 1e-4. The ACTOR
suite of PBnet/src/evaluate:

- frechet_distance and frechet_from_stats: FID on feature distributions
  (action2motion/fid.py:6-60 calculate_frechet_distance), with the
  eps-regularised, warning-proof sqrtm;
- diversity and diversity_multimodality (action2motion/diversity.py);
- recognition_accuracy and nearest_centroid_probs (accuracy.py);
- temporal_smoothness, mean_acceleration (othermetrics/acceleration.py)
  and l1_reconstruction.
"""

from __future__ import annotations

import warnings

import numpy as np
from scipy import linalg


def activation_statistics(feats: np.ndarray):
    mu = feats.mean(axis=0)
    sigma = np.cov(feats, rowvar=False)
    return mu, sigma


def regularized_sqrtm_trace(s1: np.ndarray, s2: np.ndarray,
                            eps: float = 1e-6) -> float:
    """trace(sqrtm(s1 @ s2)) with the reference's eps regularization
    (PBnet/src/evaluate/action2motion/fid.py:6-30) made WARNING-PROOF:
    degenerate (rank-deficient) covariances make scipy's sqrtm emit
    LinAlgWarning/RuntimeWarning and can return finite-but-garbage values
    without tripping the isfinite fallback. Here any warning from the
    unregularized solve triggers the eps-offset retry, and the retry itself
    runs warning-silenced (the offset makes the product numerically
    full-rank; residual scipy chatter is not actionable)."""
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        try:
            covmean = linalg.sqrtm(s1.dot(s2))
            if not np.isfinite(covmean).all():
                raise FloatingPointError("non-finite sqrtm")
        except (Warning, FloatingPointError, linalg.LinAlgError):
            offset = np.eye(s1.shape[0]) * eps
            with warnings.catch_warnings():
                warnings.simplefilter("ignore")
                covmean = linalg.sqrtm((s1 + offset).dot(s2 + offset))
    if np.iscomplexobj(covmean):
        covmean = covmean.real
    return float(np.trace(covmean))


def frechet_from_stats(stats_a, stats_b, eps: float = 1e-6) -> float:
    """Frechet distance between two gaussians given as (mu, sigma) pairs
    (stgcn/fid.py:6-61), so that statistics computed once can be reused."""
    mu1, s1 = stats_a
    mu2, s2 = stats_b
    diff = mu1 - mu2
    tr_covmean = regularized_sqrtm_trace(s1, s2, eps)
    # the eps offset shifts the trace by ~2*D*eps, which can push a
    # near-zero distance slightly negative; FD is non-negative by definition
    return float(max(0.0, diff.dot(diff) + np.trace(s1) + np.trace(s2)
                     - 2 * tr_covmean))


def frechet_distance(feats_a: np.ndarray, feats_b: np.ndarray,
                     eps: float = 1e-6) -> float:
    """Frechet distance between gaussian fits of two feature sets (N, D)."""
    return frechet_from_stats(activation_statistics(feats_a),
                              activation_statistics(feats_b), eps)


def diversity(feats: np.ndarray, num_pairs: int = 10000,
              seed: int = 0) -> float:
    """Mean euclidean distance between random feature pairs."""
    rng = np.random.RandomState(seed)
    n = feats.shape[0]
    i = rng.randint(n, size=num_pairs)
    j = rng.randint(n, size=num_pairs)
    return float(np.linalg.norm(feats[i] - feats[j], axis=-1).mean())


def diversity_multimodality(activations: np.ndarray, labels: np.ndarray,
                            num_labels: int, diversity_times: int = 200,
                            multimodality_times: int = 20,
                            seed: int = 0):
    """action2motion diversity + multimodality, exactly the reference
    algorithm (PBnet/src/evaluate/action2motion/diversity.py:6-46).

    activations: (N, D) per-sample features; labels: (N,) int condition ids
    (for DAWN: the audio/identity a sample was generated from — samples that
    share a label are re-generations of the same conditioning, so
    multimodality measures within-condition variation).
    """
    rng = np.random.RandomState(seed)
    labels = np.asarray(labels, np.int64)
    n = len(labels)

    first = rng.randint(0, n, diversity_times)
    second = rng.randint(0, n, diversity_times)
    div = float(np.mean(np.linalg.norm(
        activations[first] - activations[second], axis=-1)))

    multimodality = 0.0
    quotas = np.repeat(multimodality_times, num_labels)
    # labels with no samples can never be drawn — zero their quota up front
    # or the rejection loop below spins forever (the reference assumes every
    # class id occurs; real eval dumps can have holes)
    present = np.bincount(labels, minlength=num_labels) > 0
    quotas[~present] = 0
    if not present.any():
        return div, 0.0
    while np.any(quotas > 0):
        i = rng.randint(0, n)
        li = labels[i]
        if not quotas[li]:
            continue
        j = rng.randint(0, n)
        while labels[j] != li:
            j = rng.randint(0, n)
        quotas[li] -= 1
        multimodality += float(np.linalg.norm(activations[i] - activations[j]))
    # reference divides by times*num_labels; with absent labels that would
    # deflate the mean, so normalize by the labels actually sampled
    multimodality /= multimodality_times * int(present.sum())
    return div, multimodality


def recognition_accuracy(probs: np.ndarray, labels: np.ndarray):
    """Classifier accuracy + confusion matrix
    (action2motion/accuracy.py:4-15), classifier-agnostic: ``probs`` is any
    (N, num_labels) score matrix. The reference's classifier is an
    SMPL-body STGCN (inapplicable to 6-d head pose, DEVIATIONS); use
    ``nearest_centroid_probs`` for a feature-space stand-in."""
    labels = np.asarray(labels, np.int64)
    num = probs.shape[1]
    pred = probs.argmax(axis=1)
    confusion = np.zeros((num, num), np.int64)
    for y, p in zip(labels, pred):
        confusion[y][p] += 1
    return float(np.trace(confusion) / max(confusion.sum(), 1)), confusion


def nearest_centroid_probs(train_feats: np.ndarray, train_labels: np.ndarray,
                           feats: np.ndarray, num_labels: int) -> np.ndarray:
    """Negative-distance-to-class-centroid scores: the in-repo recognition
    stand-in (real samples define centroids; a generated sample is
    'recognized' if it lands nearest its own condition's centroid)."""
    cent = np.stack([train_feats[train_labels == c].mean(axis=0)
                     for c in range(num_labels)])
    d = np.linalg.norm(feats[:, None] - cent[None], axis=-1)
    return -d


def temporal_smoothness(seq: np.ndarray) -> float:
    """Mean |x_t - x_{t+1}| over a (T, D) or (B, T, D) sequence."""
    d = np.diff(seq, axis=-2)
    return float(np.abs(d).mean())


def mean_acceleration(motions, lengths=None) -> float:
    """Mean L2 acceleration norm over a motion batch — the othermetrics
    smoothness metric (PBnet/src/evaluate/othermetrics/acceleration.py:7-29):
    second temporal difference, normed over the feature axis, averaged over
    the (length - 2) valid acceleration frames of each sequence.

    motions: (N, T, J, F) or (N, T, D) (D treated as one joint's features);
    lengths: optional (N,) valid frame counts (default: full T).
    """
    total = count = 0.0
    for i, m in enumerate(motions):          # list of (T_i, ...) allowed
        m = np.asarray(m)
        if m.ndim == 2:
            m = m[:, None, :]
        t = int(lengths[i]) if lengths is not None else m.shape[0]
        acc = np.diff(np.diff(m[:t], axis=0), axis=0)     # (t-2, J, F)
        if acc.shape[0] <= 0:
            continue
        normed = np.linalg.norm(acc, axis=2)              # (t-2, J)
        total += normed.sum()
        count += normed.size
    return float(total / count) if count else float("nan")


def l1_reconstruction(pred: np.ndarray, target: np.ndarray) -> float:
    return float(np.abs(pred - target).mean())
