"""Stage 1: portrait -> face box -> 3DMM parameters -> init pose, eye ratios
and face box.

Port of ``dawn_tpu/pipeline/face_prep.py``, the reference's layer-1 stack
(extract_init_states/): FaceBoxes detection (the image scaled to at most 720
x 1080 with ``cv2.resize``, the BGR mean subtracted, anchors, decode, score
above 0.05, top 5000, NMS at 0.3, keep 750, score at least 0.2 —
FaceBoxes_ONNX.py:56-143), the 3DDFA 120x120 crop (``cv2.resize``,
INTER_LINEAR) normalised as (x - 127.5) / 128 and regressed to the 62
parameters (TDDFA_ONNX.py:74-103), the dense BFM reconstruction, and the
pose/eye/bbox math. The host steps are copies of the JAX package's; the two
CNNs run on their modules' device in f32 (:func:`run_net`). The pieces take
the nets as callables (NCHW float32 numpy in, numpy out), as the JAX
functions do, so either package's nets can serve. The nets and bases come
from the release files through
:func:`dawn_tpu_torch.weights.checkpoints.load_face_assets`.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Sequence, Tuple

import numpy as np
import torch

from dawn_tpu_torch.models.face3d.bfm import BFMReconstructor
from dawn_tpu_torch.models.face3d.nms import nms
from dawn_tpu_torch.models.face3d.pose import calculate_bbox, calculate_eye, get_pose
from dawn_tpu_torch.models.face3d.priors import decode_boxes, prior_boxes

MAX_H, MAX_W = 720, 1080
BGR_MEAN = np.array([104.0, 117.0, 123.0], np.float32)
CONF_THRESH = 0.05
TOP_K = 5000
NMS_THRESH = 0.3
KEEP_TOP_K = 750
VIS_THRESH = 0.2
CROP_SIZE = 120


@dataclasses.dataclass
class FaceAssets:
    """What stage 1 reads: the FaceBoxes detector, the 3DDFA regressor, the
    BFM bases and the 62 parameters' mean and std."""
    faceboxes: torch.nn.Module
    tddfa: torch.nn.Module
    bfm: BFMReconstructor
    param_mean: np.ndarray
    param_std: np.ndarray


def run_net(net: torch.nn.Module) -> Callable:
    """A module as a numpy callable: an NCHW float32 array in, on the
    module's device in f32, every output back as a numpy array."""
    def call(x: np.ndarray):
        with torch.no_grad():
            out = net(torch.from_numpy(np.ascontiguousarray(x, np.float32)))
        if isinstance(out, tuple):
            return tuple(o.float().cpu().numpy() for o in out)
        return out.float().cpu().numpy()
    return call


def detect_faces(img_bgr: np.ndarray,
                 backbone: Callable[[np.ndarray], Tuple[np.ndarray, np.ndarray]]
                 ) -> np.ndarray:
    """FaceBoxes post-processing pipeline. backbone: NCHW float -> (loc, conf).

    Returns (N, 5) [x1, y1, x2, y2, score] boxes above VIS_THRESH in original
    image coordinates.
    """
    h, w = img_bgr.shape[:2]
    scale = 1.0
    if h > MAX_H:
        scale = MAX_H / h
    if w * scale > MAX_W:
        scale *= MAX_W / (w * scale)
    if scale != 1.0:
        import cv2
        img_bgr = cv2.resize(img_bgr, (int(scale * w), int(scale * h)))
    hs, ws = img_bgr.shape[:2]

    x = img_bgr.astype(np.float32) - BGR_MEAN
    x = np.transpose(x, (2, 0, 1))[None]
    loc, conf = backbone(x)
    loc, conf = np.asarray(loc)[0], np.asarray(conf)[0]

    priors = prior_boxes((hs, ws))
    boxes = decode_boxes(loc, priors)
    boxes = boxes * np.array([ws, hs, ws, hs], np.float32) / scale
    scores = conf[:, 1]

    keep = scores > CONF_THRESH
    boxes, scores = boxes[keep], scores[keep]
    order = scores.argsort()[::-1][:TOP_K]
    boxes, scores = boxes[order], scores[order]

    dets = np.hstack([boxes, scores[:, None]]).astype(np.float32)
    keep_ids = nms(dets, NMS_THRESH)
    dets = dets[keep_ids][:KEEP_TOP_K]
    return dets[dets[:, 4] >= VIS_THRESH]


def parse_roi_box_from_bbox(bbox: Sequence[float]) -> np.ndarray:
    """Square ROI box around a detection (utils/functions.py:65-82)."""
    left, top, right, bottom = bbox[:4]
    old_size = (right - left + bottom - top) / 2
    center_x = right - (right - left) / 2.0
    center_y = bottom - (bottom - top) / 2.0 + old_size * 0.14
    size = int(old_size * 1.58)
    roi = np.zeros(4)
    roi[0] = center_x - size / 2
    roi[1] = center_y - size / 2
    roi[2] = roi[0] + size
    roi[3] = roi[1] + size
    return roi


def crop_img(img: np.ndarray, roi_box: Sequence[float]) -> np.ndarray:
    """Zero-padded crop (utils/functions.py:23-63)."""
    h, w = img.shape[:2]
    sx, sy, ex, ey = [int(round(v)) for v in roi_box[:4]]
    dh, dw = ey - sy, ex - sx
    res = (np.zeros((dh, dw, 3), dtype=img.dtype) if img.ndim == 3
           else np.zeros((dh, dw), dtype=img.dtype))
    if sx < 0:
        sx, dsx = 0, -sx
    else:
        dsx = 0
    if ex > w:
        ex, dex = w, dw - (ex - w)
    else:
        dex = dw
    if sy < 0:
        sy, dsy = 0, -sy
    else:
        dsy = 0
    if ey > h:
        ey, dey = h, dh - (ey - h)
    else:
        dey = dh
    res[dsy:dey, dsx:dex] = img[sy:ey, sx:ex]
    return res


def regress_3dmm(img_bgr: np.ndarray, boxes: np.ndarray,
                 backbone: Callable[[np.ndarray], np.ndarray],
                 size: int = CROP_SIZE,
                 param_mean: Optional[np.ndarray] = None,
                 param_std: Optional[np.ndarray] = None):
    """Per-face 62-param regression (TDDFA_ONNX.__call__, :74-103)."""
    import cv2
    params, rois = [], []
    for box in boxes:
        roi = parse_roi_box_from_bbox(box)
        crop = crop_img(img_bgr, roi)
        crop = cv2.resize(crop, (size, size), interpolation=cv2.INTER_LINEAR)
        inp = (crop.astype(np.float32) - 127.5) / 128.0
        inp = np.transpose(inp, (2, 0, 1))[None]
        param = np.asarray(backbone(inp)).reshape(-1).astype(np.float32)
        if param_mean is not None:
            param = param * param_std + param_mean
        params.append(param)
        rois.append(roi)
    return params, rois


def states_from_params(img_shape, params, rois, bfm: BFMReconstructor
                       ) -> Tuple[np.ndarray, np.ndarray]:
    """The first face's 62 parameters and ROI -> (pose (1, 7), eye_bbox (1,
    8)): the 7-d pose, then the eye-open ratios and the face box [x_min,
    x_max, y_min, y_max, H, W] of the dense vertices in the image
    (``dawn_tpu/pipeline/face_prep.py:191-204``)."""
    ver = bfm.recon_vers(params[0], rois[0], CROP_SIZE, dense=True)
    pose = get_pose(params[:1]).reshape(1, 7)
    left, right = calculate_eye(ver)
    bbox = calculate_bbox(img_shape, ver)
    eye_bbox = np.zeros((1, 8), np.float32)
    eye_bbox[0, 0] = np.sum(left)
    eye_bbox[0, 1] = np.sum(right)
    eye_bbox[0, 2:] = np.asarray(bbox, np.float32)
    return pose.astype(np.float32), eye_bbox


def extract_init_states(image_path: str, assets: FaceAssets
                        ) -> Tuple[np.ndarray, np.ndarray]:
    """Image -> (pose (1, 7), eye_bbox (1, 8)) of its first (highest-scoring)
    face. Raises ValueError when no face is found."""
    import cv2
    img = cv2.imread(image_path)
    if img is None:
        raise FileNotFoundError(f"cannot read the image {image_path}")
    if img.shape[2] == 4:
        img = cv2.cvtColor(img, cv2.COLOR_RGBA2RGB)
    boxes = detect_faces(img, run_net(assets.faceboxes))
    if len(boxes) == 0:
        raise ValueError(f"no face detected in {image_path}")
    params, rois = regress_3dmm(img, boxes[:1], run_net(assets.tddfa),
                                param_mean=assets.param_mean, param_std=assets.param_std)
    return states_from_params(img.shape, params, rois, assets.bfm)
