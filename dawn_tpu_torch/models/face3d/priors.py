"""FaceBoxes anchors and box decoding (host numpy).

A copy of ``dawn_tpu/models/face3d/priors.py``: the anchors of the
reference's FaceBoxes/utils/prior_box.py (densified for min_size 32 and 64,
steps 32, 64, 128), in the order of the loc/conf heads' channels (row-major
over the feature map's cells, then each cell's densified anchors), and
box_utils.decode (:177-195).
"""

from __future__ import annotations

from math import ceil
from typing import Sequence, Tuple

import numpy as np

MIN_SIZES = ([32, 64, 128], [256], [512])
STEPS = (32, 64, 128)
VARIANCE = (0.1, 0.2)


def prior_boxes(image_size: Tuple[int, int]) -> np.ndarray:
    """(N, 4) anchors in center form (cx, cy, w, h), normalized."""
    im_h, im_w = image_size
    anchors = []
    for k, step in enumerate(STEPS):
        fh, fw = ceil(im_h / step), ceil(im_w / step)
        for i in range(fh):
            for j in range(fw):
                for min_size in MIN_SIZES[k]:
                    s_kx = min_size / im_w
                    s_ky = min_size / im_h
                    if min_size == 32:
                        offs = (0.0, 0.25, 0.5, 0.75)
                    elif min_size == 64:
                        offs = (0.0, 0.5)
                    else:
                        offs = (0.5,)
                    for oy in offs:
                        for ox in offs:
                            anchors.append(((j + ox) * step / im_w,
                                            (i + oy) * step / im_h,
                                            s_kx, s_ky))
    return np.asarray(anchors, dtype=np.float32)


def decode_boxes(loc: np.ndarray, priors: np.ndarray,
                 variances: Sequence[float] = VARIANCE) -> np.ndarray:
    """Regression offsets + anchors -> corner boxes (box_utils.py:177-195)."""
    centers = priors[:, :2] + loc[:, :2] * variances[0] * priors[:, 2:]
    sizes = priors[:, 2:] * np.exp(loc[:, 2:] * variances[1])
    boxes = np.concatenate([centers - sizes / 2, centers + sizes / 2], axis=1)
    return boxes
