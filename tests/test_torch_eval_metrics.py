"""The port's host metrics, LaTeX tables and rotation conversions against
the JAX package's.

``dawn_tpu_torch/evaluate/metrics.py`` and ``tables.py`` are copies of the
JAX package's numpy modules: every metric function gives the same number
for the same seeded arrays, bit for bit (the ``RandomState`` pair draws of
diversity and multimodality included; the degenerate-covariance Frechet
through its eps retry), except where the JAX package's ``sqrtm(disp=False)``
takes the eps retry for SciPy 1.17's deprecation warning alone: the port
calls ``sqrtm`` without ``disp`` and takes the plain root there, within 1e-4
of JAX's. ``make_table`` and ``tables.main`` write the
same LaTeX. ``models/pbnet/rotations.py`` is torch: every conversion is
held to JAX's within 1e-6 in f32 on seeded rotations and on the edge
inputs (the identity, 180-degree turns about each axis, where
``matrix_to_quaternion`` takes ``copysign`` of a zero difference, and
angles under the small-angle series' 1e-6 rad).
"""

import json

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from dawn_tpu.evaluate import metrics as jax_metrics
from dawn_tpu.evaluate import tables as jax_tables
from dawn_tpu.models.pbnet import rotations as jr
from dawn_tpu_torch.evaluate import metrics, tables
from dawn_tpu_torch.models.pbnet import rotations as tr
from test_torch_util import one_torch_thread  # noqa: F401 (autouse fixture)


def _feats(seed, n=40, d=6, shift=0.0):
    return np.random.RandomState(seed).randn(n, d) + shift


def _metric_cases():
    rng = np.random.RandomState(0)
    labels = rng.randint(0, 4, 60)
    labels[labels == 2] = 1                           # an absent label
    motions = [rng.randn(t, 3, 6) for t in (12, 9, 2, 15)]
    degenerate = np.concatenate([rng.randn(30, 3), np.ones((30, 5))], axis=1)
    return {
        "activation_statistics": ("activation_statistics", (_feats(1),), {}),
        "frechet_distance": ("frechet_distance", (_feats(2), _feats(3, shift=0.5)), {}),
        "frechet_degenerate": ("frechet_distance", (degenerate, degenerate * 1.5 + 1), {}),
        "frechet_self": ("frechet_distance", (_feats(4), _feats(4)), {}),
        "sqrtm_trace": ("regularized_sqrtm_trace",
                        (np.cov(_feats(5), rowvar=False), np.cov(_feats(6), rowvar=False)), {}),
        "diversity": ("diversity", (_feats(7, n=80),), dict(num_pairs=500, seed=3)),
        "diversity_multimodality": ("diversity_multimodality",
                                    (_feats(8, n=60), labels, 4), dict(seed=5)),
        "recognition_accuracy": ("recognition_accuracy", (_feats(9, n=60, d=4), labels), {}),
        "nearest_centroid_probs": ("nearest_centroid_probs",
                                   (_feats(10, n=8), np.arange(8) % 4, _feats(11, n=20), 4),
                                   {}),
        "temporal_smoothness": ("temporal_smoothness", (rng.randn(3, 20, 6),), {}),
        "mean_acceleration": ("mean_acceleration", (motions,), {}),
        "mean_acceleration_lengths": ("mean_acceleration", (rng.randn(4, 16, 6),),
                                      dict(lengths=[16, 3, 2, 10])),
        "l1_reconstruction": ("l1_reconstruction", (rng.randn(5, 7), rng.randn(5, 7)), {}),
    }


CASES = _metric_cases()
# well-conditioned roots: JAX's retry comes from SciPy 1.17's ``disp``
# deprecation warning alone, the port's plain root differs by its eps offset
RETRIED_BY_JAX_ONLY = {"frechet_distance", "sqrtm_trace"}


def _assert_same(ours, theirs, what):
    if isinstance(ours, tuple):
        assert isinstance(theirs, tuple) and len(ours) == len(theirs), what
        for a, b in zip(ours, theirs):
            _assert_same(a, b, what)
        return
    np.testing.assert_array_equal(np.asarray(ours), np.asarray(theirs), err_msg=what)


@pytest.mark.parametrize("case", sorted(CASES))
def test_metric_matches_jax_bit_for_bit(case):
    name, args, kw = CASES[case]
    ours = getattr(metrics, name)(*args, **kw)
    theirs = getattr(jax_metrics, name)(*args, **kw)
    if case in RETRIED_BY_JAX_ONLY:
        assert abs(ours - theirs) < 1e-4, (case, ours, theirs)
    else:
        _assert_same(ours, theirs, case)


FORMAT_CASES = [(0.0234, None, "rc"), (1.7, None, "l1"), (0.0, None, "rc"),
                (4.2, 5.0, "diversity"), (0.5, 5.0, "diversity"), (0.004, 0.005, "diversity"),
                (0.02, 0.5, "multimodality"), (0.9, None, "accuracy"), (0.1, None, "accuracy"),
                (1e-3, 1.05e-3, "acceleration"), (5e-3, 1e-3, "acceleration"),
                (12.34, None, "fid"), (0.0, 1.0, "diversity")]


def test_tables_match_jax(tmp_path):
    for case in FORMAT_CASES:
        assert tables.format_table(*case) == jax_tables.format_table(*case), case
    runs = {"run_a": {"fid": 1.25, "diversity_pred": 3.0, "diversity_gt": 3.5,
                      "accuracy_gen_test": 0.7, "accuracy_gt_test": 0.9, "l1": 0.03},
            "run_b": {"fid": 0.5, "diversity_pred": 1.0, "diversity_gt": 3.5, "l1": 1.2,
                      "acceleration_pred": 2e-3, "acceleration_gt": 1e-3}}
    assert tables.make_table(runs, "T") == jax_tables.make_table(runs, "T")
    paths = []
    for name, seeds in (("run_a", {"0": runs["run_a"], "1": dict(runs["run_a"], fid=2.0)}),
                        ("run_b", runs["run_b"])):
        (tmp_path / name).mkdir()
        paths.append(str(tmp_path / name / "metrics.json"))
        (tmp_path / name / "metrics.json").write_text(json.dumps(seeds))
    ours, theirs = str(tmp_path / "ours.tex"), str(tmp_path / "theirs.tex")
    assert tables.main(paths + ["-o", ours, "--title", "Eval"]) == ours
    jax_tables.main(paths + ["-o", theirs, "--title", "Eval"])
    with open(ours) as a, open(theirs) as b:
        assert a.read() == b.read()


# ----------------------------------------------------------------- rotations

def _rotmats(n=12, seed=0):
    q = np.random.RandomState(seed).randn(n, 4)
    q /= np.linalg.norm(q, axis=-1, keepdims=True)
    return np.array(jr.quaternion_to_matrix(jnp.asarray(q, jnp.float32)))


EDGE_MATS = np.stack([np.eye(3), np.diag([1.0, -1, -1]), np.diag([-1.0, 1, -1]),
                      np.diag([-1.0, -1, 1])]).astype(np.float32)


def _rot_inputs():
    rng = np.random.RandomState(1)
    mats = np.concatenate([_rotmats(), EDGE_MATS]).reshape(2, 8, 3, 3)
    quats = rng.randn(2, 5, 4).astype(np.float32)
    axis_angle = np.concatenate([rng.randn(6, 3), np.zeros((1, 3)), 1e-8 * rng.randn(2, 3),
                                 np.array([[np.pi, 0, 0], [0, 0, -np.pi]])]).astype(np.float32)
    unit_q = quats / np.linalg.norm(quats, axis=-1, keepdims=True)
    unit_q[0, 0] = [1, 0, 0, 0]                        # the identity: the small-angle branch
    return {
        "quaternion_to_matrix": (quats,),
        "matrix_to_quaternion": (mats,),
        "euler_angles_to_matrix_XYZ": (rng.uniform(-3, 3, (4, 3)).astype(np.float32), "XYZ"),
        "euler_angles_to_matrix_ZYX": (rng.uniform(-3, 3, (4, 3)).astype(np.float32), "ZYX"),
        "matrix_to_euler_angles_XYZ": (mats, "XYZ"),
        "matrix_to_euler_angles_ZXY": (_rotmats(seed=3), "ZXY"),
        "matrix_to_euler_angles_XYX": (_rotmats(seed=4), "XYX"),
        "axis_angle_to_quaternion": (axis_angle,),
        "quaternion_to_axis_angle": (unit_q,),
        "axis_angle_to_matrix": (axis_angle,),
        "matrix_to_axis_angle": (np.concatenate([_rotmats(seed=5), EDGE_MATS[:1]]),),
        "rotation_6d_to_matrix": (rng.randn(3, 2, 6).astype(np.float32),),
        "matrix_to_rotation_6d": (mats,),
        "quaternion_multiply": (quats, rng.randn(2, 5, 4).astype(np.float32)),
        "quaternion_invert": (quats,),
        "quaternion_apply": (unit_q, rng.randn(2, 5, 3).astype(np.float32)),
    }


ROT = _rot_inputs()


@pytest.mark.parametrize("case", sorted(ROT))
def test_rotation_matches_jax(case):
    fn = case[:-4] if case[-4] == "_" and case[-3:].isupper() else case
    args = ROT[case]
    arrays = [a for a in args if isinstance(a, np.ndarray)]
    extra = [a for a in args if not isinstance(a, np.ndarray)]
    ours = getattr(tr, fn)(*[torch.from_numpy(a) for a in arrays], *extra)
    theirs = np.asarray(getattr(jr, fn)(*[jnp.asarray(a) for a in arrays], *extra))
    assert ours.dtype == torch.float32 and ours.shape == theirs.shape, case
    np.testing.assert_allclose(ours.numpy(), theirs, rtol=0, atol=1e-6, err_msg=case)


def test_copysign_of_zero_difference_and_small_angles():
    """180 degrees about x: w = 0 and m21 - m12 = +0, so x keeps +1 (torch's
    and jnp's copysign read the sign bit alike); a zero axis-angle is the
    identity quaternion through the series branch, and back."""
    q = tr.matrix_to_quaternion(torch.from_numpy(EDGE_MATS[1]))
    assert q.tolist() == [0.0, 1.0, 0.0, 0.0]
    ident = tr.axis_angle_to_quaternion(torch.zeros(3))
    assert ident.tolist() == [1.0, 0.0, 0.0, 0.0]
    assert tr.quaternion_to_axis_angle(ident).tolist() == [0.0, 0.0, 0.0]
    tiny = torch.tensor([1e-8, -2e-8, 0.5e-8])
    torch.testing.assert_close(tr.matrix_to_axis_angle(tr.axis_angle_to_matrix(tiny)),
                               torch.zeros(3), atol=1e-7, rtol=0)


def test_frechet_without_sqrtm_disp(monkeypatch):
    """The port never passes sqrtm's ``disp`` (SciPy 1.17 deprecates it, 1.18
    removed it), so every version takes one path: under a SciPy without
    ``disp`` a well-conditioned product gives the same distance as here, the
    plain root, within 1e-4 of the eps retry that JAX's 1.17 warning forces;
    a rank-deficient one still goes through the retry, finite and without a
    warning."""
    import warnings
    from scipy import linalg

    plain = linalg.sqrtm

    def sqrtm_without_disp(a, **kw):
        if kw:
            raise TypeError(f"sqrtm() got an unexpected keyword argument {next(iter(kw))!r}")
        return plain(a)

    a, b = _feats(20, n=200), _feats(21, n=200, shift=0.3)
    here = metrics.frechet_distance(a, b)
    assert abs(here - jax_metrics.frechet_distance(a, b)) < 1e-4
    monkeypatch.setattr(linalg, "sqrtm", sqrtm_without_disp)
    assert metrics.frechet_distance(a, b) == here
    degenerate = np.concatenate([_feats(22, n=30, d=3), np.ones((30, 5))], axis=1)
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        d = metrics.frechet_distance(degenerate, degenerate * 1.5 + 1)
    assert np.isfinite(d) and d > 0
