"""Greedy hard NMS and soft-NMS (host numpy).

Copies of ``dawn_tpu/models/face3d/nms.py``'s ``nms_numpy`` (the function of
the reference's FaceBoxes/utils/nms/py_cpu_nms.py) and ``soft_nms_numpy``
(cpu_nms.pyx's ``cpu_soft_nms``). The JAX package dispatches hard NMS to a
C++ build of the same loop (``dawn_tpu/runtime/native.py``); that is host
code, not a TPU kernel, and the port keeps the numpy loop alone.
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


def soft_nms(dets: np.ndarray, sigma: float = 0.5, nt: float = 0.3,
             threshold: float = 0.001, method: int = 1) -> np.ndarray:
    """Soft-NMS (linear method=1 / gaussian method=2 / hard otherwise).

    Exactly cpu_soft_nms (cpu_nms.pyx:70-163) including the in-loop pruning:
    a box decayed below ``threshold`` is swapped out and stops suppressing
    later boxes (a batch variant that keeps decaying with dead boxes keeps
    suppressing faces the reference would retain). The reference returns
    range(N) into its in-place-mutated array; here the original row indices
    of the kept boxes are returned instead (selection order), which is the
    same set of boxes but usable against the caller's ORIGINAL ``dets``.
    """
    boxes = dets.astype(np.float32, copy=True)
    idx = np.arange(boxes.shape[0])
    n = boxes.shape[0]
    i = 0
    while i < n:
        maxpos = i + int(np.argmax(boxes[i:n, 4]))
        boxes[[i, maxpos]] = boxes[[maxpos, i]]
        idx[[i, maxpos]] = idx[[maxpos, i]]
        tx1, ty1, tx2, ty2 = boxes[i, :4]
        pos = i + 1
        while pos < n:
            x1, y1, x2, y2 = boxes[pos, :4]
            iw = min(tx2, x2) - max(tx1, x1) + 1
            ih = min(ty2, y2) - max(ty1, y1) + 1
            if iw > 0 and ih > 0:
                area = (x2 - x1 + 1) * (y2 - y1 + 1)
                ua = (tx2 - tx1 + 1) * (ty2 - ty1 + 1) + area - iw * ih
                ov = iw * ih / ua
                if method == 1:        # linear
                    weight = 1.0 - ov if ov > nt else 1.0
                elif method == 2:      # gaussian
                    weight = float(np.exp(-(ov * ov) / sigma))
                else:                  # original hard
                    weight = 0.0 if ov > nt else 1.0
                boxes[pos, 4] *= weight
                if boxes[pos, 4] < threshold:
                    boxes[pos] = boxes[n - 1]
                    idx[pos] = idx[n - 1]
                    n -= 1
                    pos -= 1
            pos += 1
        i += 1
    return idx[:n].copy()
