"""ctypes binding of the threaded .npy reader (``csrc/host/npy_prefetch.cpp``).

Port of ``dawn_tpu/runtime/native.py``'s ``NpyPrefetcher``: a pool of C++
threads reads the payloads of submitted .npy files (headers stripped) into a
bounded queue; ``next`` hands back one finished read and its tag. The
library is built with g++ by :func:`dawn_tpu_torch.build.load_host` at first
use; when it cannot be built, the constructor raises.
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
