"""Basel Face Model reconstruction: the 62-param 3DMM as plain matmuls
(host numpy, f64).

A copy of ``dawn_tpu/models/face3d/bfm.py`` (the reference's
extract_init_states/utils/tddfa_util.py _parse_param :80-104 and
similar_transform :64-78, bfm/bfm.py u + w_shp @ alpha + w_exp @ beta
:22-40). The dense basis of bfm_noneck_v3.pkl is (3 * 38365, 40 + 10), so
the product stays on the host, as in the JAX package.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np


def parse_param_62(param: np.ndarray) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """62-d param -> (R (3,3), offset (3,1), alpha_shp (40,1), alpha_exp (10,1)).

    Also handles the 72- and 141-d variants as the reference does.
    """
    n = param.shape[0]
    dims = {62: (12, 40, 10), 72: (12, 40, 20), 141: (12, 100, 29)}
    if n not in dims:
        raise ValueError(f"unsupported param length {n}")
    trans_dim, shape_dim, _ = dims[n]
    r = param[:trans_dim].reshape(3, -1)
    R = r[:, :3]
    offset = r[:, -1].reshape(3, 1)
    alpha_shp = param[trans_dim:trans_dim + shape_dim].reshape(-1, 1)
    alpha_exp = param[trans_dim + shape_dim:].reshape(-1, 1)
    return R, offset, alpha_shp, alpha_exp


def similar_transform(pts3d: np.ndarray, roi_box: Sequence[float],
                      size: int) -> np.ndarray:
    """Map (3, N) crop-space vertices back into image space (:64-78)."""
    pts3d = np.array(pts3d, dtype=np.float64)
    pts3d[0, :] -= 1
    pts3d[2, :] -= 1
    pts3d[1, :] = size - pts3d[1, :]

    sx, sy, ex, ey = roi_box[:4]
    scale_x = (ex - sx) / size
    scale_y = (ey - sy) / size
    pts3d[0, :] = pts3d[0, :] * scale_x + sx
    pts3d[1, :] = pts3d[1, :] * scale_y + sy
    s = (scale_x + scale_y) / 2
    pts3d[2, :] *= s
    pts3d[2, :] -= np.min(pts3d[2, :])
    return np.array(pts3d, dtype=np.float32)


class BFMReconstructor:
    """u + w_shp @ alpha_shp + w_exp @ alpha_exp, sparse (68 lmk) or dense.

    Built from the BFM arrays (u, w_shp, w_exp each (3N, k)) and the
    68-landmark index list of bfm_noneck_v3.pkl.
    """

    def __init__(self, u: np.ndarray, w_shp: np.ndarray, w_exp: np.ndarray,
                 keypoints: Optional[np.ndarray] = None):
        self.u = u.astype(np.float64)
        self.w_shp = w_shp.astype(np.float64)
        self.w_exp = w_exp.astype(np.float64)
        if keypoints is not None:
            kp = np.asarray(keypoints).reshape(-1)
            self.u_base = self.u[kp]
            self.w_shp_base = self.w_shp[kp]
            self.w_exp_base = self.w_exp[kp]
        else:
            self.u_base = self.w_shp_base = self.w_exp_base = None

    def recon_vers(self, param: np.ndarray, roi_box: Sequence[float],
                   size: int = 120, dense: bool = True) -> np.ndarray:
        """62-param + roi box -> (3, N) image-space vertices
        (TDDFA_ONNX.recon_vers, TDDFA_ONNX.py:105-125)."""
        R, offset, alpha_shp, alpha_exp = parse_param_62(param)
        if dense or self.u_base is None:
            u, ws, we = self.u, self.w_shp, self.w_exp
        else:
            u, ws, we = self.u_base, self.w_shp_base, self.w_exp_base
        pts3d = (u + ws @ alpha_shp + we @ alpha_exp).reshape(-1, 3).T
        pts3d = R @ pts3d + offset
        return similar_transform(pts3d, roi_box, size)
