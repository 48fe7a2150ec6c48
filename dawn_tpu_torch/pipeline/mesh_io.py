"""3DMM mesh export: .ply and textured .obj writers.

A copy of ``dawn_tpu/pipeline/mesh_io.py`` (host numpy, as there; the port
imports nothing of the JAX package): the same meshes give the same files,
byte for byte.

Capability parity with extract_init_states/utils/serialization.py
(ser_to_ply_{single,multiple} :22-84, ser_to_obj_{single,multiple} :93-141):
image-space vertices written y-flipped (height - y) with reversed triangle
winding so the mesh is upright and front-facing in standard viewers; obj
vertices carry per-vertex colors sampled nearest-neighbor from the photo.
Differences: one writer per format with a ``merge`` flag instead of two
near-duplicate functions; vertex/face blocks are formatted with numpy in one
pass instead of a per-vertex Python loop; ``img`` is RGB (the rest of this
package's convention) where the reference takes cv2 BGR and swaps channels
at write time (:108) — byte-identical output for the same visual image.
"""

from __future__ import annotations

import os
from typing import Sequence

import numpy as np

_PLY_HEADER = """ply
format ascii 1.0
element vertex {}
property float x
property float y
property float z
element face {}
property list uchar int vertex_indices
end_header
"""


def _fmt_vertices(ver: np.ndarray, height: float) -> np.ndarray:
    """(3, N) image-space -> N strings 'x y z' with y flipped, 2 decimals
    (serialization.py:37)."""
    v = np.asarray(ver, np.float64)
    cols = np.stack([v[0], height - v[1], v[2]], axis=1)
    return np.array([" ".join(f"{c:.2f}" for c in row) for row in cols])


def _fmt_faces(tri: np.ndarray, offset: int, prefix: str,
               plus_one: bool) -> np.ndarray:
    """Reversed winding (idx3 idx2 idx1, serialization.py:42-45,110-111)."""
    t = np.asarray(tri, np.int64) + offset + (1 if plus_one else 0)
    return np.array([f"{prefix}{c} {b} {a}" for a, b, c in t])


def _expand_path(wfp: str, i: int) -> str:
    root, suffix = os.path.splitext(wfp)
    return f"{root}_{i + 1}{suffix}"


def sample_vertex_colors(img: np.ndarray, ver: np.ndarray) -> np.ndarray:
    """Nearest-neighbor per-vertex colors in [0,1] from an RGB image
    (serialization.py get_colors :86-90). ver: (3, N)."""
    h, w = img.shape[:2]
    x = np.clip(np.round(np.asarray(ver)[0]).astype(np.int32), 0, w - 1)
    y = np.clip(np.round(np.asarray(ver)[1]).astype(np.int32), 0, h - 1)
    colors = img[y, x].astype(np.float64)
    if img.dtype == np.uint8:
        colors = colors / 255.0
    return colors


def ser_to_ply(ver_lst: Sequence[np.ndarray], tri: np.ndarray, height: float,
               wfp: str, merge: bool = False) -> list:
    """Write face meshes as ascii .ply. merge=False writes one file per face
    with an _{i+1} suffix (ser_to_ply_single); merge=True concatenates all
    faces into one element block (ser_to_ply_multiple). Returns the paths
    written."""
    tri = np.asarray(tri, np.int64)
    paths = []
    if merge:
        if len(ver_lst) == 0:
            return paths
        n_vertex = ver_lst[0].shape[1]
        verts = [_fmt_vertices(v, height) for v in ver_lst]
        faces = [_fmt_faces(tri, i * n_vertex, "3 ", False)
                 for i in range(len(ver_lst))]
        with open(wfp, "w") as f:
            f.write(_PLY_HEADER.format(n_vertex * len(ver_lst),
                                       len(tri) * len(ver_lst)) + "\n")
            f.write("\n".join(np.concatenate(verts + faces)) + "\n")
        return [wfp]
    for i, ver in enumerate(ver_lst):
        path = _expand_path(wfp, i)
        with open(path, "w") as f:
            f.write(_PLY_HEADER.format(ver.shape[1], len(tri)) + "\n")
            f.write("\n".join(_fmt_vertices(ver, height)) + "\n")
            f.write("\n".join(_fmt_faces(tri, 0, "3 ", False)) + "\n")
        paths.append(path)
    return paths


def ser_to_obj(img: np.ndarray, ver_lst: Sequence[np.ndarray],
               tri: np.ndarray, height: float, wfp: str,
               merge: bool = False) -> list:
    """Write textured .obj: 'v x y z r g b' vertices (colors sampled from
    the RGB photo) + 1-based reversed-winding 'f' lines
    (ser_to_obj_{single,multiple})."""
    tri = np.asarray(tri, np.int64)

    def _vlines(ver):
        colors = sample_vertex_colors(img, ver)
        v = np.asarray(ver, np.float64)
        rows = np.concatenate(
            [np.stack([v[0], height - v[1], v[2]], axis=1), colors], axis=1)
        return np.array(["v " + " ".join(f"{c:.2f}" for c in row)
                         for row in rows])

    paths = []
    if merge:
        if len(ver_lst) == 0:
            return paths
        n_vertex = ver_lst[0].shape[1]
        verts = [_vlines(v) for v in ver_lst]
        faces = [_fmt_faces(tri, i * n_vertex, "f ", True)
                 for i in range(len(ver_lst))]
        with open(wfp, "w") as f:
            f.write("\n".join(np.concatenate(verts + faces)) + "\n")
        return [wfp]
    for i, ver in enumerate(ver_lst):
        path = _expand_path(wfp, i)
        with open(path, "w") as f:
            f.write("\n".join(_vlines(ver)) + "\n")
            f.write("\n".join(_fmt_faces(tri, 0, "f ", True)) + "\n")
        paths.append(path)
    return paths
