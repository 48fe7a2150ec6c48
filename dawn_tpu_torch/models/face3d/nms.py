"""Greedy hard NMS (host numpy).

A copy of ``dawn_tpu/models/face3d/nms.py::nms_numpy``, the function of the
reference's FaceBoxes/utils/nms/py_cpu_nms.py. The JAX package dispatches
to a C++ build of the same loop (``dawn_tpu/runtime/native.py``); that is
host code, not a TPU kernel, and the port keeps the numpy loop alone.
"""

from __future__ import annotations

import numpy as np


def nms(dets: np.ndarray, thresh: float) -> np.ndarray:
    """Greedy hard NMS. dets (N, 5) = [x1, y1, x2, y2, score]. Returns keep ids."""
    x1, y1, x2, y2, scores = dets[:, 0], dets[:, 1], dets[:, 2], dets[:, 3], dets[:, 4]
    areas = (x2 - x1 + 1) * (y2 - y1 + 1)
    order = scores.argsort()[::-1]
    keep = []
    while order.size > 0:
        i = order[0]
        keep.append(int(i))
        xx1 = np.maximum(x1[i], x1[order[1:]])
        yy1 = np.maximum(y1[i], y1[order[1:]])
        xx2 = np.minimum(x2[i], x2[order[1:]])
        yy2 = np.minimum(y2[i], y2[order[1:]])
        w = np.maximum(0.0, xx2 - xx1 + 1)
        h = np.maximum(0.0, yy2 - yy1 + 1)
        ovr = (w * h) / (areas[i] + areas[order[1:]] - w * h)
        order = order[1:][ovr <= thresh]
    return np.asarray(keep, dtype=np.int64)
