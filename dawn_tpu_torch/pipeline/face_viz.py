"""3DDFA-style face visualisation: landmarks, pose box, depth, shaded mesh,
PNCC and UV texture.

Port of ``dawn_tpu/pipeline/face_viz.py`` (host numpy and cv2 line drawing,
as there; the port imports nothing of the JAX package). The reference's
paths are extract_init_states/utils/pose.py:140-216 (calc_pose /
build_camera_box / plot_pose_box / viz_pose), utils/depth.py (z as colour),
the render.c shaded overlay (utils/render_ctypes.py), utils/pncc.py and
utils/uv.py (the Sim3DR ``rasterize``).

The rasterising functions (:func:`render_depth`, :func:`render_mesh_overlay`,
:func:`rasterize_colors` and through it :func:`pncc` and :func:`uv_tex`) run
the port's host C++ rasteriser, ``csrc/host/render.cpp``, which
:mod:`dawn_tpu_torch.runtime.native` builds with g++ at first use. They
raise when it cannot be built or loaded: the JAX module's silent numpy
fallbacks are not carried over. Those fallbacks are kept as
:func:`render_depth_plain` and :func:`rasterize_colors_plain`, the plain
versions the tests hold the library against.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np

from dawn_tpu_torch.models.face3d.pose import P2sRt, matrix2angle
from dawn_tpu_torch.runtime import native


def calc_pose(param: np.ndarray) -> Tuple[np.ndarray, list]:
    """62-d 3DMM param -> (P (3,4) without scale, [yaw, pitch, roll] deg)
    (pose.py:140-148)."""
    P = param[:12].reshape(3, -1)
    s, R, t3d = P2sRt(P)
    P = np.concatenate((R, t3d.reshape(3, -1)), axis=1)
    return P, [a * 180.0 / np.pi for a in matrix2angle(R)]


def calc_hypotenuse(pts: np.ndarray) -> float:
    """Face-size scale from the 68 landmarks (tddfa utils)."""
    bbox = [pts[0, :].min(), pts[1, :].min(), pts[0, :].max(), pts[1, :].max()]
    center = [(bbox[0] + bbox[2]) / 2, (bbox[1] + bbox[3]) / 2]
    radius = max(bbox[2] - bbox[0], bbox[3] - bbox[1]) / 2
    bbox = [center[0] - radius, center[1] - radius,
            center[0] + radius, center[1] + radius]
    llength = np.sqrt((bbox[2] - bbox[0]) ** 2 + (bbox[3] - bbox[1]) ** 2)
    return llength / 3


def build_camera_box(rear_size: float = 90.0) -> np.ndarray:
    """The 10-point 3D pose box polyline (pose.py:150-169)."""
    rear_depth = 0
    front_size = int(4 / 3 * rear_size)
    front_depth = int(4 / 3 * rear_size)
    pts = [(-rear_size, -rear_size, rear_depth),
           (-rear_size, rear_size, rear_depth),
           (rear_size, rear_size, rear_depth),
           (rear_size, -rear_size, rear_depth),
           (-rear_size, -rear_size, rear_depth),
           (-front_size, -front_size, front_depth),
           (-front_size, front_size, front_depth),
           (front_size, front_size, front_depth),
           (front_size, -front_size, front_depth),
           (-front_size, -front_size, front_depth)]
    return np.asarray(pts, np.float32).reshape(-1, 3)


def plot_pose_box(img: np.ndarray, P: np.ndarray, ver: np.ndarray,
                  color=(40, 255, 0), line_width: int = 2) -> np.ndarray:
    """Draw the 3D pose box (pose.py:171-199). ver: (3, 68) landmarks."""
    import cv2

    point_3d = build_camera_box(calc_hypotenuse(ver))
    point_3d_homo = np.hstack((point_3d, np.ones([point_3d.shape[0], 1])))
    point_2d = point_3d_homo.dot(P.T)[:, :2]
    point_2d[:, 1] = -point_2d[:, 1]
    point_2d[:, :2] = (point_2d[:, :2] - np.mean(point_2d[:4, :2], 0)
                       + np.mean(ver[:2, :27], 1))
    point_2d = np.int32(point_2d.reshape(-1, 2))

    cv2.polylines(img, [point_2d], True, color, line_width, cv2.LINE_AA)
    for a, b in ((1, 6), (2, 7), (3, 8)):
        cv2.line(img, tuple(point_2d[a]), tuple(point_2d[b]), color,
                 line_width, cv2.LINE_AA)
    return img


def viz_pose(img: np.ndarray, param_lst: Sequence[np.ndarray],
             ver_lst: Sequence[np.ndarray],
             wfp: Optional[str] = None) -> np.ndarray:
    """Pose boxes for every detected face (pose.py:201-216)."""
    import cv2

    for param, ver in zip(param_lst, ver_lst):
        P, _ = calc_pose(param)
        img = plot_pose_box(img, P, ver)
    if wfp is not None:
        cv2.imwrite(wfp, img)
    return img


def draw_landmarks(img: np.ndarray, ver: np.ndarray, color=(0, 255, 0),
                   radius: int = 1) -> np.ndarray:
    """Draw the 68 sparse landmarks. ver: (3, 68) or (2, 68)."""
    import cv2

    for x, y in zip(ver[0], ver[1]):
        cv2.circle(img, (int(round(x)), int(round(y))), radius, color, -1)
    return img


def render_depth(vertices: np.ndarray, triangles: np.ndarray,
                 h: int, w: int) -> np.ndarray:
    """Z-buffer depth image (utils/depth.py equivalent): barycentric-
    interpolated per-pixel z, normalized to [0,1], 0 where uncovered.
    vertices: (3, N) image coords; triangles: (M, 3). Runs
    ``render.cpp::dawn_render_depth``."""
    return native.render_depth(np.ascontiguousarray(vertices.T), triangles, h, w)


def render_depth_plain(vertices: np.ndarray, triangles: np.ndarray,
                       h: int, w: int) -> np.ndarray:
    """:func:`render_depth` in numpy (the JAX module's fallback, float64
    barycentrics): the plain version the tests hold the library against."""
    depth = np.zeros((h, w), np.float32)
    zbuf = np.full((h, w), -np.inf, np.float32)
    v = vertices.astype(np.float32)
    z = v[2]
    zmin, zmax = z.min(), z.max()
    znorm = (z - zmin) / max(zmax - zmin, 1e-8)
    for tri in triangles:
        xs, ys, zs = v[0, tri], v[1, tri], znorm[tri]
        x0, x1 = max(int(np.ceil(xs.min())), 0), min(int(np.floor(xs.max())), w - 1)
        y0, y1 = max(int(np.ceil(ys.min())), 0), min(int(np.floor(ys.max())), h - 1)
        if x1 < x0 or y1 < y0:
            continue
        denom = ((ys[1] - ys[2]) * (xs[0] - xs[2])
                 + (xs[2] - xs[1]) * (ys[0] - ys[2]))
        if abs(denom) < 1e-12:
            continue
        gy, gx = np.mgrid[y0:y1 + 1, x0:x1 + 1]
        b0 = ((ys[1] - ys[2]) * (gx - xs[2]) + (xs[2] - xs[1]) * (gy - ys[2])) / denom
        b1 = ((ys[2] - ys[0]) * (gx - xs[2]) + (xs[0] - xs[2]) * (gy - ys[2])) / denom
        b2 = 1.0 - b0 - b1
        inside = (b0 >= 0) & (b1 >= 0) & (b2 >= 0)
        zpix = b0 * zs[0] + b1 * zs[1] + b2 * zs[2]
        win_z = zbuf[y0:y1 + 1, x0:x1 + 1]
        upd = inside & (zpix > win_z)
        win_z[upd] = zpix[upd]
        depth[y0:y1 + 1, x0:x1 + 1][upd] = zpix[upd]
    return depth


def render_mesh_overlay(img: np.ndarray, vertices: np.ndarray,
                        triangles: np.ndarray, alpha: float = 0.6
                        ) -> np.ndarray:
    """Shaded 3DMM mesh over the image (``render.cpp::dawn_render_mesh``;
    reference render.c + render_ctypes.py). vertices: (3, N)."""
    base = np.ascontiguousarray(img.astype(np.float32) / 255.0
                                if img.dtype == np.uint8 else img)
    shaded = native.render_mesh(np.ascontiguousarray(vertices.T), triangles, base.copy())
    out = (1 - alpha) * base + alpha * shaded
    if img.dtype == np.uint8:
        return (np.clip(out, 0, 1) * 255).astype(np.uint8)
    return out


# ------------------------------------------------------------ pncc / uv-tex
# The reference's remaining 3DDFA visualization modes (utils/pncc.py,
# utils/uv.py): per-vertex-color rasterization through
# render.cpp::dawn_render_colors, the Sim3DR `rasterize` those files call.


def rasterize_colors_plain(vertices: np.ndarray, triangles: np.ndarray,
                           colors: np.ndarray, bg: np.ndarray) -> np.ndarray:
    """:func:`rasterize_colors` in numpy (the JAX module's fallback, float64
    barycentrics): the plain version the tests hold the library against."""
    out = bg.astype(np.float32)
    zbuf = np.full(bg.shape[:2], -np.inf, np.float32)
    v = vertices.astype(np.float32)
    h, w = bg.shape[:2]
    for tri in triangles:
        xs, ys, zs = v[tri, 0], v[tri, 1], v[tri, 2]
        x0, x1 = max(int(np.ceil(xs.min())), 0), min(int(np.floor(xs.max())), w - 1)
        y0, y1 = max(int(np.ceil(ys.min())), 0), min(int(np.floor(ys.max())), h - 1)
        if x1 < x0 or y1 < y0:
            continue
        denom = ((ys[1] - ys[2]) * (xs[0] - xs[2])
                 + (xs[2] - xs[1]) * (ys[0] - ys[2]))
        if abs(denom) < 1e-12:
            continue
        gy, gx = np.mgrid[y0:y1 + 1, x0:x1 + 1]
        b0 = ((ys[1] - ys[2]) * (gx - xs[2]) + (xs[2] - xs[1]) * (gy - ys[2])) / denom
        b1 = ((ys[2] - ys[0]) * (gx - xs[2]) + (xs[0] - xs[2]) * (gy - ys[2])) / denom
        b2 = 1.0 - b0 - b1
        zpix = b0 * zs[0] + b1 * zs[1] + b2 * zs[2]
        win_z = zbuf[y0:y1 + 1, x0:x1 + 1]
        upd = (b0 >= 0) & (b1 >= 0) & (b2 >= 0) & (zpix > win_z)
        win_z[upd] = zpix[upd]
        cpix = (b0[..., None] * colors[tri[0]] + b1[..., None] * colors[tri[1]]
                + b2[..., None] * colors[tri[2]])
        out[y0:y1 + 1, x0:x1 + 1][upd] = cpix[upd]
    return out


def rasterize_colors(vertices: np.ndarray, triangles: np.ndarray,
                     colors: np.ndarray, bg: np.ndarray) -> np.ndarray:
    """Z-buffered barycentric interpolation of per-vertex colors over bg.
    vertices: (N, 3) image coords; colors: (N, 3); bg: (H, W, 3), left
    unchanged (the result is a float32 copy)."""
    return native.render_colors(vertices, triangles, colors, bg.astype(np.float32))


def calc_ncc_code(u: np.ndarray) -> np.ndarray:
    """Normalized coordinate code from the BFM mean shape: per-axis min-max
    normalization of u (3N,) or (N, 3) -> (N, 3) RGB in [0,1]
    (utils/pncc.py:21-31; the reference caches this as ncc_code.npy)."""
    u = np.asarray(u, np.float64)
    xyz = u.reshape(-1, 3) if u.ndim == 1 else u
    lo, hi = xyz.min(axis=0), xyz.max(axis=0)
    return ((xyz - lo) / np.maximum(hi - lo, 1e-12)).astype(np.float32)


def pncc(img: np.ndarray, ver_lst, triangles: np.ndarray,
         ncc_code: np.ndarray, with_bg_flag: bool = True) -> np.ndarray:
    """Projected Normalized Coordinate Code visualization (utils/pncc.py:34):
    render each face's vertices colored by the mean-shape NCC over the image
    (or black). ver_lst: iterable of (3, N) image-space vertex arrays."""
    base = img.astype(np.float32) / 255.0 if img.dtype == np.uint8 else img
    out = base.astype(np.float32) if with_bg_flag else np.zeros_like(
        base, dtype=np.float32)
    for ver in ver_lst:
        out = rasterize_colors(np.ascontiguousarray(ver.T), triangles,
                               ncc_code, out)
    if img.dtype == np.uint8:
        return (np.clip(out, 0, 1) * 255).astype(np.uint8)
    return out


def get_colors(img: np.ndarray, ver: np.ndarray) -> np.ndarray:
    """Nearest-neighbor per-vertex image colors (utils/uv.py:41-49).
    ver: (3, N) image coords; returns (N, 3)."""
    h, w = img.shape[:2]
    x = np.clip(np.round(ver[0]).astype(np.int32), 0, w - 1)
    y = np.clip(np.round(ver[1]).astype(np.int32), 0, h - 1)
    return img[y, x]


def process_uv(uv_coords: np.ndarray, uv_h: int = 256,
               uv_w: int = 256) -> np.ndarray:
    """UV coords in [0,1] -> UV-image vertex positions with flipped v and a
    zero z column (utils/uv.py:28-33)."""
    uv = np.asarray(uv_coords, np.float32).copy()
    uv[:, 0] = uv[:, 0] * (uv_w - 1)
    uv[:, 1] = uv_h - uv[:, 1] * (uv_h - 1) - 1
    return np.hstack([uv, np.zeros((len(uv), 1), np.float32)])


def uv_tex(img: np.ndarray, ver_lst, triangles: np.ndarray,
           uv_coords: np.ndarray, uv_h: int = 256,
           uv_w: int = 256) -> np.ndarray:
    """UV texture extraction (utils/uv.py:82-104): sample the image at each
    projected vertex, then rasterize those colors in UV space. uv_coords:
    (N, 2) in [0,1]; the reference loads these from configs/BFM_UV.mat,
    which is not in the repository, so the caller supplies them."""
    base = img.astype(np.float32) / 255.0 if img.dtype == np.uint8 else img
    uv_ver = process_uv(uv_coords, uv_h, uv_w)
    out = np.zeros((uv_h, uv_w, 3), np.float32)
    for ver in ver_lst:
        colors = get_colors(base, ver)
        out = rasterize_colors(uv_ver, triangles, colors, out)
    if img.dtype == np.uint8:
        return (np.clip(out, 0, 1) * 255).astype(np.uint8)
    return out
