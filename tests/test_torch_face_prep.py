"""Stage 1 of the port (face detection, 3DMM regression, pose/eye/bbox)
against dawn_tpu on the CPU.

- The numpy modules the port copies (anchors, box decoding, NMS, pose, BFM,
  ROI and crop) give exactly the JAX package's results.
- FaceBoxes (128^2 and 200 x 300), its JAX variables made with
  ``jax.eval_shape`` plus a seeded fill and carried into the port by the
  bridge; the 3DMM regressors (MobileNet-V1 at widen 1.0 and 0.5,
  MobileNetV3 small and large, ResNet22), the port's seeded weights carried
  into JAX by the JAX package's ``convert_*`` functions and back by the
  bridge bit for bit. Outputs within 1e-4 of max|ref|.
- ``extract_init_states`` on seeded full-size assets (the release files'
  shapes and layouts, written by ``chip_smoke.write_face_assets`` from the
  JAX nets' variables) against the JAX pieces composed as the JAX stage
  composes them: ``detect_faces`` with the Flax FaceBoxes, ``regress_3dmm``
  with the Flax MobileNet, ``BFMReconstructor.recon_vers(dense=True)`` and
  ``get_pose``/``calculate_eye``/``calculate_bbox``. Stage by stage: the
  first box within 1e-4 of max|ref| and JAX's loc/conf giving JAX's boxes
  exactly; given JAX's boxes, the 62 parameters within 1e-4 of max|ref|;
  given JAX's parameters, pose, eye ratios and bbox equal. The ROI's
  integers (``int(old_size * 1.58)``, the crop's rounded bounds) turn a
  1e-6 difference of a box into a whole pixel, so the end-to-end results
  are compared after checking that those integers agree.
- The asset loader (flat and 3DDFA-V2 layouts, ``module.`` names, a
  directory of ``.onnx`` graphs only, a pickle carrying ``os.system``) and
  ``VideoGenerator``'s stage 1 writing the JAX pieces' two files.
"""

import os
import pickle

import cv2
import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from dawn_tpu.models.face3d import bfm as jax_bfm
from dawn_tpu.models.face3d import pose as jax_pose
from dawn_tpu.models.face3d import priors as jax_priors
from dawn_tpu.models.face3d.backbones import get_backbone as jax_backbone
from dawn_tpu.models.face3d.faceboxes_net import FaceBoxesNet as JaxFaceBoxes
from dawn_tpu.models.face3d.nms import nms_numpy as jax_nms_numpy
from dawn_tpu.pipeline import face_prep as jax_fp
from dawn_tpu_torch.models.face3d import bfm, nms, pose, priors
from dawn_tpu_torch.models.face3d.backbones import get_backbone
from dawn_tpu_torch.models.face3d.faceboxes_net import FaceBoxesNet
from dawn_tpu_torch.pipeline import face_prep
from dawn_tpu_torch.pipeline.generator import GeneratorPaths, VideoGenerator
from dawn_tpu_torch.weights import checkpoints
from dawn_tpu_torch.weights.jax_bridge import (faceboxes_state_dict, load_state,
                                               mobilenet_state_dict, mobilenet_v3_state_dict,
                                               resnet22_state_dict)
from chip_smoke import write_face_assets
from test_torch_util import random_tree, one_torch_thread  # noqa: F401 (autouse fixture)

IMG_H, IMG_W = 200, 300


def _close(got, ref, label, rel=1e-4):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    assert got.shape == ref.shape, (label, got.shape, ref.shape)
    err, scale = float(np.abs(got - ref).max()), float(np.abs(ref).max())
    assert err <= rel * scale, f"{label}: max error {err} > {rel} of max|ref| {scale}"


def _variables(net, shape, seed):
    shapes = jax.eval_shape(lambda: net.init(jax.random.PRNGKey(0), jnp.zeros(shape)))
    return random_tree(shapes, seed)


# XLA's CPU backend with its expensive passes off: these nets compile in a
# fraction of the time and compute the same function
FAST_COMPILE = {"xla_backend_optimization_level": 0, "xla_llvm_disable_expensive_passes": True}


@pytest.fixture(scope="module")
def jax_apply():
    """The JAX nets' compiled applies, one per (net, input shape), shared by
    the tests of this file."""
    return {}


def _jit(jax_apply, key, net):
    def apply(variables, x):
        if (key, x.shape) not in jax_apply:
            jax_apply[key, x.shape] = jax.jit(net.apply).lower(variables, x).compile(
                FAST_COMPILE)
        return jax_apply[key, x.shape](variables, x)
    return apply


def _nhwc(x):
    return jnp.asarray(np.transpose(x, (0, 2, 3, 1)))


def test_copied_numpy_modules_match_jax():
    rng = np.random.RandomState(0)
    for size in ((607, 1080), (IMG_H, IMG_W), (128, 128)):
        np.testing.assert_array_equal(priors.prior_boxes(size), jax_priors.prior_boxes(size))
    anchors = priors.prior_boxes((IMG_H, IMG_W))
    loc = rng.randn(len(anchors), 4).astype(np.float32)
    np.testing.assert_array_equal(priors.decode_boxes(loc, anchors),
                                  jax_priors.decode_boxes(loc, anchors))
    xy = rng.rand(400, 2) * 200
    dets = np.hstack([xy, xy + 10 + rng.rand(400, 2) * 60, rng.rand(400, 1)]).astype(np.float32)
    np.testing.assert_array_equal(nms.nms(dets, 0.3), jax_nms_numpy(dets, 0.3))
    for _ in range(4):
        param = rng.randn(62).astype(np.float32)
        for name in ("pose_from_param",):
            for a, b in zip(getattr(pose, name)(param), getattr(jax_pose, name)(param)):
                np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(pose.get_pose([param]), jax_pose.get_pose([param]))
        for a, b in zip(bfm.parse_param_62(param), jax_bfm.parse_param_62(param)):
            np.testing.assert_array_equal(a, b)
    for gimbal in (0.999, -0.999, 0.3):      # both guards and the general branch
        R = np.eye(3)
        R[2, 0] = gimbal
        assert pose.matrix2angle(R) == jax_pose.matrix2angle(R)
    u, ws, we = rng.randn(300, 1), rng.randn(300, 40), rng.randn(300, 10)
    kp = np.arange(30)
    ver = bfm.BFMReconstructor(u, ws, we, kp).recon_vers(param, [10.5, 20.25, 130.0, 150.5])
    jver = jax_bfm.BFMReconstructor(u, ws, we, kp).recon_vers(param, [10.5, 20.25, 130.0, 150.5])
    np.testing.assert_array_equal(ver, jver)
    np.testing.assert_array_equal(
        bfm.BFMReconstructor(u, ws, we, kp).recon_vers(param, [0, 0, 120, 120], dense=False),
        jax_bfm.BFMReconstructor(u, ws, we, kp).recon_vers(param, [0, 0, 120, 120], dense=False))
    lmk = 100 * rng.rand(3, 68).astype(np.float32)
    assert pose.calculate_eye(lmk) == jax_pose.calculate_eye(lmk)
    assert pose.calculate_bbox((IMG_H, IMG_W, 3), lmk) == jax_pose.calculate_bbox(
        (IMG_H, IMG_W, 3), lmk)
    img = rng.randint(0, 255, size=(IMG_H, IMG_W, 3)).astype(np.uint8)
    for box in ([40.3, 30.7, 120.2, 140.9], [-30.0, -20.5, 80.0, 60.0], [250.0, 150.0, 340.0,
                                                                           260.0]):
        roi = face_prep.parse_roi_box_from_bbox(box)
        np.testing.assert_array_equal(roi, jax_fp.parse_roi_box_from_bbox(box))
        np.testing.assert_array_equal(face_prep.crop_img(img, roi), jax_fp.crop_img(img, roi))


@pytest.mark.parametrize("h,w", [(128, 128), (IMG_H, IMG_W)])
def test_faceboxes_matches_jax(jax_apply, h, w):
    net = JaxFaceBoxes()
    variables = _variables(net, (1, h, w, 3), seed=h + w)
    port = FaceBoxesNet(device="cpu")
    load_state(port, faceboxes_state_dict(variables))
    x = (np.random.RandomState(1).rand(1, 3, h, w) * 255 - 117).astype(np.float32)
    ref_loc, ref_conf = _jit(jax_apply, "faceboxes", net)(variables, _nhwc(x))
    loc, conf = face_prep.run_net(port)(x)
    assert loc.shape == (1, len(priors.prior_boxes((h, w))), 4)
    _close(loc, ref_loc, "FaceBoxes loc")
    _close(conf, ref_conf, "FaceBoxes conf")


REGRESSORS = [("mobilenet", {}, mobilenet_state_dict), ("mobilenet", {"widen_factor": 0.5},
                                                        mobilenet_state_dict),
              ("mobilenet_v3", {"mode": "small"}, mobilenet_v3_state_dict),
              ("mobilenet_v3", {"mode": "large"}, mobilenet_v3_state_dict),
              ("resnet22", {}, resnet22_state_dict)]


def _seeded_port(arch, kw, seed):
    """A port regressor with seeded weights and random BatchNorm statistics,
    and its (reference-layout) state_dict."""
    torch.manual_seed(seed)
    port = get_backbone(arch, device="cpu", **kw)
    rng = np.random.RandomState(seed)
    sd = port.state_dict()
    for k, v in sd.items():
        if k.endswith("running_mean"):
            v.copy_(torch.from_numpy(0.1 * rng.randn(*v.shape)))
        elif k.endswith("running_var"):
            v.copy_(torch.from_numpy(0.5 + rng.rand(*v.shape)))
    return port, sd


@pytest.mark.parametrize("arch,kw,bridge", REGRESSORS,
                         ids=["mb1", "mb05", "v3-small", "v3-large", "resnet22"])
def test_regressors_match_jax(jax_apply, arch, kw, bridge):
    jnet, convert = jax_backbone(arch, **kw)
    x = np.random.RandomState(3).randn(1, 3, 96, 96).astype(np.float32)
    # the port's weights (the reference layout) into JAX through its convert_*
    port, sd = _seeded_port(arch, kw, seed=6)
    variables = convert(sd)
    _close(face_prep.run_net(port)(x), _jit(jax_apply, arch + str(kw), jnet)(variables, _nhwc(x)),
           f"{arch} {kw}")
    # and back through the bridge: every entry the port holds, bit for bit
    back = bridge(jax.tree_util.tree_map(np.asarray, variables))
    assert sorted(back) == sorted(k for k in sd if not k.endswith("num_batches_tracked"))
    for k, v in back.items():
        np.testing.assert_array_equal(v, sd[k].numpy(), err_msg=k)
    load_state(get_backbone(arch, device="cpu", **kw), back)


@pytest.fixture(scope="module")
def face_case(tmp_path_factory, jax_apply):
    """Seeded full-size assets written from JAX nets' variables, a 200 x 300
    portrait, and the JAX pieces' stage-by-stage results on it."""
    root = tmp_path_factory.mktemp("face_prep")
    fb_net, (mb_net, convert) = JaxFaceBoxes(), jax_backbone("mobilenet")
    fb_vars = _variables(fb_net, (1, IMG_H, IMG_W, 3), seed=21)
    _, mb_sd = _seeded_port("mobilenet", {}, seed=22)
    mb_vars = convert(mb_sd)
    params = fb_vars["params"]
    for i in range(3):
        # heads scaled so that scores neither saturate nor tie and boxes stay
        # near their anchors; class 1 lifted so that faces are found
        params[f"loc_{i}"]["kernel"] *= 0.05
        params[f"conf_{i}"]["kernel"] *= 0.02
        params[f"conf_{i}"]["bias"][1::2] += 2.0
    assets = write_face_assets(str(root / "assets"), 23,
                               faceboxes_sd=faceboxes_state_dict(fb_vars), tddfa_sd=mb_sd)
    yy, xx = np.mgrid[0:IMG_H, 0:IMG_W] / IMG_H
    rng = np.random.RandomState(24)
    img = np.stack([90 + 80 * np.exp(-((xx - 0.7) ** 2 + (yy - 0.45) ** 2) / 0.05),
                    110 + 40 * xx, 130 - 50 * yy], axis=-1) + 8 * rng.randn(IMG_H, IMG_W, 3)
    image_path = str(root / "portrait.png")
    cv2.imwrite(image_path, np.clip(img, 0, 255).astype(np.uint8))

    fb_apply, mb_apply = _jit(jax_apply, "faceboxes", fb_net), _jit(jax_apply, "mb1", mb_net)

    def jax_faceboxes(x):
        return tuple(np.asarray(o) for o in fb_apply(fb_vars, _nhwc(x)))

    def jax_tddfa(x):
        return np.asarray(mb_apply(mb_vars, _nhwc(x)))

    img = cv2.imread(image_path)
    ms = checkpoints.read_array_pickle(os.path.join(assets, "param_mean_std_62d_120x120.pkl"))
    b = checkpoints.read_array_pickle(os.path.join(assets, "bfm_noneck_v3.pkl"))
    recon = jax_bfm.BFMReconstructor(b["u"], b["w_shp"], b["w_exp"], b["keypoints"])
    boxes = jax_fp.detect_faces(img, jax_faceboxes)
    params, rois = jax_fp.regress_3dmm(img, boxes[:1], jax_tddfa, param_mean=ms["mean"],
                                       param_std=ms["std"])
    ver = recon.recon_vers(params[0], rois[0], 120, dense=True)
    eye_bbox = np.zeros((1, 8), np.float32)
    eye_bbox[0, :2] = jax_pose.calculate_eye(ver)
    eye_bbox[0, 2:] = jax_pose.calculate_bbox(img.shape, ver)
    return dict(assets=assets, image=image_path, img=img, faceboxes=jax_faceboxes,
                boxes=boxes, params=params, rois=rois,
                pose=jax_pose.get_pose(params).reshape(1, 7).astype(np.float32),
                eye_bbox=eye_bbox)


def _roi_integers(box):
    left, top, right, bottom = box[:4]
    roi = jax_fp.parse_roi_box_from_bbox(box)
    return int((right - left + bottom - top) / 2 * 1.58), [int(round(v)) for v in roi]


def test_extract_init_states_matches_jax_pieces(face_case):
    c = face_case
    assets = checkpoints.load_face_assets(c["assets"], "cpu")
    img = c["img"]
    assert len(c["boxes"]) > 0
    # boxes: JAX's loc/conf give JAX's boxes exactly; the port's nets the same first box
    np.testing.assert_array_equal(face_prep.detect_faces(img, c["faceboxes"]), c["boxes"])
    boxes = face_prep.detect_faces(img, face_prep.run_net(assets.faceboxes))
    _close(boxes[0], c["boxes"][0], "first box")
    # the 62 parameters from JAX's boxes
    params, rois = face_prep.regress_3dmm(img, c["boxes"][:1], face_prep.run_net(assets.tddfa),
                                          param_mean=assets.param_mean,
                                          param_std=assets.param_std)
    np.testing.assert_array_equal(rois[0], c["rois"][0])
    _close(params[0], c["params"][0], "62 parameters")
    # pose, eye ratios and bbox from JAX's parameters
    got_pose, got_eye_bbox = face_prep.states_from_params(img.shape, c["params"], c["rois"],
                                                          assets.bfm)
    np.testing.assert_array_equal(got_pose, c["pose"])
    np.testing.assert_array_equal(got_eye_bbox, c["eye_bbox"])
    # end to end, once the ROI integers of the two first boxes agree
    assert _roi_integers(boxes[0]) == _roi_integers(c["boxes"][0]), (
        "a whole-pixel step of the ROI differs between the port's and JAX's first box: "
        f"{_roi_integers(boxes[0])} vs {_roi_integers(c['boxes'][0])}")
    got_pose, got_eye_bbox = face_prep.extract_init_states(c["image"], assets)
    _close(got_pose, c["pose"], "pose")
    _close(got_eye_bbox[:, :2], c["eye_bbox"][:, :2], "eye ratios")
    np.testing.assert_array_equal(got_eye_bbox[:, 2:], c["eye_bbox"][:, 2:])


def test_video_generator_stage1_writes_the_jax_pieces_files(face_case, tmp_path):
    c = face_case
    gen = VideoGenerator("a.wav", c["image"], str(tmp_path / "out"), str(tmp_path / "cache"),
                         paths=GeneratorPaths(tddfa_onnx_dir=c["assets"]), device="cpu")
    gen.extract_pose()
    init_pose = np.load(tmp_path / "cache" / "init_pose.npy")
    init_eye_bbox = np.load(tmp_path / "cache" / "init_eye_bbox.npy")
    assert init_pose.shape == (1, 7) and init_eye_bbox.shape == (1, 8)
    _close(init_pose, c["pose"], "init_pose.npy")
    _close(init_eye_bbox[:, :2], c["eye_bbox"][:, :2], "init_eye_bbox.npy eye ratios")
    np.testing.assert_array_equal(init_eye_bbox[:, 2:], c["eye_bbox"][:, 2:])


def test_face_asset_loader_layouts_and_refusals(tmp_path):
    flat = checkpoints.load_face_assets(write_face_assets(str(tmp_path / "flat"), 5), "cpu")
    tree = checkpoints.load_face_assets(
        write_face_assets(str(tmp_path / "tree"), 5, layout="3ddfa"), "cpu")
    assert os.path.isfile(tmp_path / "tree" / "FaceBoxes" / "weights" / "FaceBoxesProd.pth")
    for a, b in ((flat.faceboxes, tree.faceboxes), (flat.tddfa, tree.tddfa)):
        for (k, v), (k2, v2) in zip(a.state_dict().items(), b.state_dict().items()):
            assert k == k2 and torch.equal(v, v2), k
    sd = torch.load(tmp_path / "tree" / "weights" / "mb1_120x120.pth", weights_only=True)
    assert all(k.startswith("module.") for k in sd["state_dict"])
    assert torch.equal(flat.tddfa.fc.weight, sd["state_dict"]["module.fc.weight"])
    assert flat.bfm.w_shp.shape == (3 * 38365, 40) and flat.bfm.w_exp.shape == (3 * 38365, 10)
    assert flat.param_mean.shape == flat.param_std.shape == (62,)

    onnx = tmp_path / "onnx"
    onnx.mkdir()
    for name in ("FaceBoxesProd.onnx", "mb1_120x120.onnx", "bfm_noneck_v3.onnx"):
        (onnx / name).write_bytes(b"")
    with pytest.raises(FileNotFoundError, match="FaceBoxesProd.pth.*bfm_noneck_v3.onnx"):
        checkpoints.load_face_assets(str(onnx), "cpu")

    class Payload:
        def __reduce__(self):
            return os.system, ("true",)

    bad = tmp_path / "flat" / "param_mean_std_62d_120x120.pkl"
    with open(bad, "wb") as f:
        pickle.dump({"mean": np.zeros(62), "std": Payload()}, f)
    with pytest.raises(pickle.UnpicklingError, match="system"):
        checkpoints.load_face_assets(str(tmp_path / "flat"), "cpu")
