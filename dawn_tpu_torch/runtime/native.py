"""ctypes bindings of the port's host C++ (``csrc/host/``).

Port of ``dawn_tpu/runtime/native.py``:

- ``NpyPrefetcher`` (``npy_prefetch.cpp``): a pool of C++ threads reads the
  payloads of submitted .npy files (headers stripped) into a bounded queue;
  ``next`` hands back one finished read and its tag.
- ``render_mesh``, ``render_depth`` and ``render_colors`` (``render.cpp``):
  the z-buffered triangle rasteriser of the face visualisations, with the
  JAX bindings' arguments (``dawn_tpu/runtime/native.py:70-131``) less the
  library handle, which each function loads itself.

Each library is built with g++ by :func:`dawn_tpu_torch.build.load_host` at
first use; when it cannot be built, the caller raises.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import numpy as np

_lib: Optional[ctypes.CDLL] = None


def load() -> ctypes.CDLL:
    """The reader's library, built if needed, with its C signatures."""
    global _lib
    if _lib is None:
        from dawn_tpu_torch import build
        lib = build.load_host("npy_prefetch")
        lib.dawn_prefetch_create.restype = ctypes.c_void_p
        lib.dawn_prefetch_create.argtypes = [ctypes.c_int32, ctypes.c_int32]
        lib.dawn_prefetch_submit.restype = None
        lib.dawn_prefetch_submit.argtypes = [ctypes.c_void_p, ctypes.c_char_p, ctypes.c_int64]
        lib.dawn_prefetch_next.restype = ctypes.c_int64
        lib.dawn_prefetch_next.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64,
                                           ctypes.POINTER(ctypes.c_int64)]
        lib.dawn_prefetch_destroy.restype = None
        lib.dawn_prefetch_destroy.argtypes = [ctypes.c_void_p]
        _lib = lib
    return _lib


_F32P = ctypes.POINTER(ctypes.c_float)
_I32P = ctypes.POINTER(ctypes.c_int32)
_I32 = ctypes.c_int32


def load_render() -> ctypes.CDLL:
    """The rasteriser's library, built if needed, with its C signatures."""
    from dawn_tpu_torch import build
    lib = build.load_host("render")
    lib.dawn_render_mesh.restype = None
    lib.dawn_render_mesh.argtypes = [_F32P, _I32, _I32P, _I32, _F32P, _I32, _I32, _F32P,
                                     ctypes.c_float, ctypes.c_float]
    lib.dawn_render_depth.restype = None
    lib.dawn_render_depth.argtypes = [_F32P, _I32, _I32P, _I32, _F32P, _I32, _I32]
    lib.dawn_render_colors.restype = None
    lib.dawn_render_colors.argtypes = [_F32P, _I32, _I32P, _I32, _F32P, _F32P, _I32, _I32]
    return lib


def _mesh(vertices: np.ndarray, triangles: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Contiguous (N, 3) float32 vertices and (M, 3) int32 triangles whose
    indices lie in [0, N); raises otherwise (the C code does not check)."""
    vertices = np.ascontiguousarray(vertices, dtype=np.float32)
    triangles = np.ascontiguousarray(triangles, dtype=np.int32)
    if vertices.ndim != 2 or vertices.shape[1] != 3:
        raise ValueError(f"vertices must be (N, 3), got {vertices.shape}")
    if triangles.ndim != 2 or triangles.shape[1] != 3:
        raise ValueError(f"triangles must be (M, 3), got {triangles.shape}")
    if triangles.size and (triangles.min() < 0 or triangles.max() >= vertices.shape[0]):
        raise ValueError(f"triangle indices outside [0, {vertices.shape[0]})")
    return vertices, triangles


def _image(image: np.ndarray) -> np.ndarray:
    image = np.ascontiguousarray(image, dtype=np.float32)
    if image.ndim != 3 or image.shape[2] != 3:
        raise ValueError(f"image must be (H, W, 3), got {image.shape}")
    return image


def render_mesh(vertices: np.ndarray, triangles: np.ndarray, image: np.ndarray,
                light_dir=(0.0, 0.0, 1.0), ambient: float = 0.6,
                diffuse: float = 0.4) -> np.ndarray:
    """Shade ``image`` (H, W, 3 float32 in [0, 1]) where the mesh covers:
    in place when it is already contiguous float32, else a copy; returns it.
    vertices: (N, 3) image-space xyz; triangles: (M, 3)."""
    vertices, triangles = _mesh(vertices, triangles)
    image = _image(image)
    light = np.ascontiguousarray(light_dir, dtype=np.float32)
    load_render().dawn_render_mesh(
        vertices.ctypes.data_as(_F32P), vertices.shape[0],
        triangles.ctypes.data_as(_I32P), triangles.shape[0],
        image.ctypes.data_as(_F32P), image.shape[0], image.shape[1],
        light.ctypes.data_as(_F32P), ambient, diffuse)
    return image


def render_depth(vertices: np.ndarray, triangles: np.ndarray, h: int, w: int) -> np.ndarray:
    """Barycentric z-buffered depth map: (H, W) float32, z normalized to
    [0, 1] over the vertices where the mesh covers, 0 elsewhere."""
    vertices, triangles = _mesh(vertices, triangles)
    out = np.empty((h, w), dtype=np.float32)
    load_render().dawn_render_depth(
        vertices.ctypes.data_as(_F32P), vertices.shape[0],
        triangles.ctypes.data_as(_I32P), triangles.shape[0], out.ctypes.data_as(_F32P), h, w)
    return out


def render_colors(vertices: np.ndarray, triangles: np.ndarray, colors: np.ndarray,
                  image: np.ndarray) -> np.ndarray:
    """Barycentric per-vertex-colour rasterisation into ``image`` (H, W, 3
    float32, the background; written where the mesh covers, in place when
    already contiguous float32, else a copy); returns it. colors: (N, 3)."""
    vertices, triangles = _mesh(vertices, triangles)
    colors = np.ascontiguousarray(colors, dtype=np.float32)
    if colors.shape != vertices.shape:
        raise ValueError(f"colors must be {vertices.shape}, got {colors.shape}")
    image = _image(image)
    load_render().dawn_render_colors(
        vertices.ctypes.data_as(_F32P), vertices.shape[0],
        triangles.ctypes.data_as(_I32P), triangles.shape[0], colors.ctypes.data_as(_F32P),
        image.ctypes.data_as(_F32P), image.shape[0], image.shape[1])
    return image


class NpyPrefetcher:
    """A bounded-queue threaded reader of .npy payload bytes."""

    def __init__(self, n_threads: int = 4, queue_cap: int = 8):
        self._lib = load()
        self._h = self._lib.dawn_prefetch_create(n_threads, queue_cap)

    def submit(self, path: str, tag: int = 0) -> None:
        """Queue a read of ``path``'s payload under ``tag``."""
        self._lib.dawn_prefetch_submit(self._h, path.encode(), tag)

    def next(self, nbytes: int) -> Tuple[np.ndarray, int]:
        """The next finished read (uint8 payload, at most ``nbytes``) and its
        tag, waiting for one; raises IOError on a failed read."""
        out = np.empty(nbytes, dtype=np.uint8)
        tag = ctypes.c_int64(0)
        got = self._lib.dawn_prefetch_next(self._h, out.ctypes.data, nbytes, ctypes.byref(tag))
        if got < 0:
            raise IOError(f"npy prefetch read failed ({got}) for tag {tag.value}")
        return out[:got], tag.value

    def close(self) -> None:
        if self._h:
            self._lib.dawn_prefetch_destroy(self._h)
            self._h = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass
