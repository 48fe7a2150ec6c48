"""Build and load the hand-written CUDA kernels under ``csrc/`` and the host
library under ``csrc/host/``.

Each ``csrc/<name>.cu`` exposes a plain C interface and is compiled by
``nvcc`` for ``sm_90a`` into ``_build/<name>-<hash>.so`` (git-ignored), keyed
on a hash of the source, every shared header ``csrc/*.cuh`` and the flags,
then loaded with ``ctypes``. The build happens on first use; :func:`build_all`
starts one ``nvcc`` per source at once. :func:`sources` and
:func:`build_all` cover the kernels only.

Each ``csrc/host/<name>.cpp`` (the threaded .npy reader of the training
input pipeline, the mesh rasteriser of the face visualisations) is compiled
by ``g++ -O3 -fPIC -std=c++17 -shared -pthread`` into
``_build/host-<name>-<hash>.so``, keyed on its source and the flags, at
first use (:func:`load_host`). Nothing here runs at import time.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from typing import Dict, List

PKG_DIR = os.path.dirname(os.path.abspath(__file__))
CSRC_DIR = os.path.join(PKG_DIR, "csrc")
BUILD_DIR = os.path.join(PKG_DIR, "_build")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

HOST_DIR = os.path.join(CSRC_DIR, "host")
HOST_FLAGS = ["-O3", "-fPIC", "-std=c++17", "-shared", "-pthread"]

_loaded: Dict[str, ctypes.CDLL] = {}


def sources() -> List[str]:
    """Names of the kernel sources (``csrc/<name>.cu``)."""
    return sorted(f[:-3] for f in os.listdir(CSRC_DIR) if f.endswith(".cu"))


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit")
    return path


def _library_path(name: str) -> str:
    """Where ``<name>.cu``'s library lives: keyed on the source, every header
    (any source may include any of them) and the flags."""
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    headers = sorted(f for f in os.listdir(CSRC_DIR) if f.endswith(".cuh"))
    for f in [f"{name}.cu", *headers]:
        with open(os.path.join(CSRC_DIR, f), "rb") as fh:
            digest.update(f.encode() + b"\0" + fh.read())
    return os.path.join(BUILD_DIR, f"{name}-{digest.hexdigest()[:16]}.so")


def _start_build(name: str):
    """Start nvcc for one source unless its library exists; returns
    (popen or None, temporary output, final path)."""
    out = _library_path(name)
    if os.path.exists(out):
        return None, None, out
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{out}.{os.getpid()}.tmp"
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, os.path.join(CSRC_DIR, f"{name}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                            text=True)
    return proc, tmp, out


def _finish_build(name: str, proc, tmp: str, out: str) -> str:
    """Wait for nvcc; returns its output (ptxas's registers per kernel)."""
    if proc is None:
        return ""
    log, _ = proc.communicate()
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for csrc/{name}.cu:\n{log}")
    os.replace(tmp, out)
    return log


def build_all() -> Dict[str, str]:
    """Compile every source that has no library yet, all in parallel;
    returns nvcc's output per source (empty for one already built)."""
    started = [(name, *_start_build(name)) for name in sources()]
    return {name: _finish_build(name, proc, tmp, out) for name, proc, tmp, out in started}


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, built if needed."""
    lib = _loaded.get(name)
    if lib is None:
        proc, tmp, out = _start_build(name)
        _finish_build(name, proc, tmp, out)
        lib = _loaded[name] = ctypes.CDLL(out)
    return lib


def _host_library_path(name: str) -> str:
    digest = hashlib.sha256(" ".join(HOST_FLAGS).encode())
    with open(os.path.join(HOST_DIR, f"{name}.cpp"), "rb") as fh:
        digest.update(fh.read())
    return os.path.join(BUILD_DIR, f"host-{name}-{digest.hexdigest()[:16]}.so")


def load_host(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/host/<name>.cpp``, built with g++ if
    needed; raises when it cannot be built."""
    key = f"host/{name}"
    lib = _loaded.get(key)
    if lib is None:
        out = _host_library_path(name)
        if not os.path.exists(out):
            cxx = shutil.which("g++") or shutil.which("c++")
            if cxx is None:
                raise RuntimeError(f"no C++ compiler (g++) to build csrc/host/{name}.cpp")
            os.makedirs(BUILD_DIR, exist_ok=True)
            tmp = f"{out}.{os.getpid()}.tmp"
            proc = subprocess.run([cxx, *HOST_FLAGS, "-o", tmp,
                                   os.path.join(HOST_DIR, f"{name}.cpp")],
                                  capture_output=True, text=True)
            if proc.returncode != 0:
                raise RuntimeError(f"g++ failed for csrc/host/{name}.cpp:\n{proc.stderr}")
            os.replace(tmp, out)
        lib = _loaded[key] = ctypes.CDLL(out)
    return lib
