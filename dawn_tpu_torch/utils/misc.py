"""The logging, seeding and monitoring helpers of the training scripts.

Port of ``dawn_tpu/utils/misc.py``'s ``Logger`` and ``setup_seed``
(reference misc.py:86-96) and its figures of the DM training snapshot
(``:66-166``): the optical-flow color wheel, flow and confidence maps as
uint8 images, the deformation-grid drawing, and the PNG grid of a
snapshot's panels. cv2 and PIL are imported only when a figure needs them.
"""

from __future__ import annotations

import os
import random
import sys

import numpy as np
import torch


class Logger:
    """Tee a stream (stdout by default) to a file, flushed on every write."""

    def __init__(self, path: str, stream=None):
        self.terminal = stream or sys.stdout
        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
        self.log = open(path, "a")

    def write(self, message: str):
        self.terminal.write(message)
        self.log.write(message)
        self.log.flush()

    def flush(self):
        self.terminal.flush()
        self.log.flush()

    def close(self):
        self.log.close()


def setup_seed(seed: int = 1234):
    """Seed the host generators (python, numpy) and torch's default
    generators, which draw the port's initial weights."""
    random.seed(seed)
    np.random.seed(seed)
    torch.manual_seed(seed)
    os.environ["PYTHONHASHSEED"] = str(seed)


# ------------------------------------------------------------ visualization

def _flow_colorwheel() -> np.ndarray:
    """The 55-color optical-flow wheel (Baker et al.)."""
    ry, yg, gc, cb, bm, mr = 15, 6, 4, 11, 13, 6
    cols = ([[255, 255 * i / ry, 0] for i in range(ry)]
            + [[255 - 255 * i / yg, 255, 0] for i in range(yg)]
            + [[0, 255, 255 * i / gc] for i in range(gc)]
            + [[0, 255 - 255 * i / cb, 255] for i in range(cb)]
            + [[255 * i / bm, 0, 255] for i in range(bm)]
            + [[255, 0, 255 - 255 * i / mr] for i in range(mr)])
    return np.asarray(cols, np.float32)


def flow_to_color(flow: np.ndarray) -> np.ndarray:
    """(H, W, 2) flow -> (H, W, 3) uint8: hue from the direction, saturation
    from the magnitude over the largest."""
    wheel = _flow_colorwheel()
    ncols = wheel.shape[0]
    u, v = flow[..., 0], flow[..., 1]
    rad = np.sqrt(u * u + v * v)
    rad = rad / max(rad.max(), 1e-6)
    a = np.arctan2(-v, -u) / np.pi
    fk = (a + 1) / 2 * (ncols - 1)
    k0 = np.floor(fk).astype(int)
    k1 = (k0 + 1) % ncols
    f = (fk - k0)[..., None]
    col = wheel[k0] * (1 - f) + wheel[k1] * f
    col = 255 - rad[..., None] * (255 - col)
    return col.astype(np.uint8)


def grid2fig(warped_grid: np.ndarray, grid_size: int = 32, img_size: int = 256) -> np.ndarray:
    """The lines of a deformation grid, black on white (reference
    misc.py:44-66)."""
    img = np.full((img_size, img_size, 3), 255, np.uint8)
    g = (warped_grid + 1) / 2 * (img_size - 1)
    g = np.clip(g.reshape(grid_size, grid_size, 2).astype(int), 0, img_size - 1)
    for i in range(grid_size):
        for j in range(grid_size - 1):
            _line(img, g[i, j], g[i, j + 1])
            _line(img, g[j, i], g[j + 1, i])
    return img


def _line(img, p0, p1):
    n = int(max(abs(int(p1[0]) - int(p0[0])), abs(int(p1[1]) - int(p0[1]))) + 1)
    xs = np.linspace(p0[0], p1[0], n).astype(int)
    ys = np.linspace(p0[1], p1[1], n).astype(int)
    img[ys, xs] = (0, 0, 0)


def flow2fig(flow: np.ndarray, grid_size: int = 32, img_size: int = 256) -> np.ndarray:
    """A normalized (h, h, 2) sampling grid as the color image of its
    displacement from the identity grid, resized (nearest) to ``img_size``
    (misc.py:68-77)."""
    h = flow.shape[0]
    ident = np.stack(np.meshgrid(np.linspace(-1, 1, h), np.linspace(-1, 1, h),
                                 indexing="xy"), axis=-1)
    img = flow_to_color(flow - ident)
    if img_size != h:
        import cv2
        img = cv2.resize(img, (img_size, img_size), interpolation=cv2.INTER_NEAREST)
    return img


def conf2fig(conf: np.ndarray, img_size: int = 256) -> np.ndarray:
    """An occlusion or confidence map in [0, 1] as a gray uint8 image,
    resized (nearest) to ``img_size`` (misc.py:79-84)."""
    img = (np.clip(conf.squeeze(), 0, 1) * 255).astype(np.uint8)
    img = np.repeat(img[..., None], 3, axis=-1)
    if img.shape[0] != img_size:
        import cv2
        img = cv2.resize(img, (img_size, img_size), interpolation=cv2.INTER_NEAREST)
    return img


def save_snapshot_grid(path: str, panels: "dict[str, np.ndarray]") -> None:
    """Write a snapshot's panels as one PNG: a row per panel, a column per
    frame. Each panel is (T, H, W, 3), float in [0, 1] or uint8; shorter
    rows are padded with black."""
    from PIL import Image

    rows = []
    for frames in panels.values():
        fr = np.asarray(frames)
        if fr.dtype != np.uint8:
            fr = (np.clip(fr, 0.0, 1.0) * 255).astype(np.uint8)
        rows.append(np.concatenate(list(fr), axis=1))       # (H, T*W, 3)
    h = max(r.shape[0] for r in rows)
    w = max(r.shape[1] for r in rows)
    rows = [np.pad(r, ((0, h - r.shape[0]), (0, w - r.shape[1]), (0, 0))) for r in rows]
    Image.fromarray(np.concatenate(rows, axis=0)).save(path)
