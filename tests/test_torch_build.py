"""The kernel build's cache key (``dawn_tpu_torch/build.py``): a library is
named by a hash of its source, every shared header under ``csrc/`` and the
nvcc flags, so an edited header never loads a stale library. Needs no nvcc
and no card: it only computes paths, on a copy of ``csrc/`` in a temporary
directory. Also the wrappers' alignment rule for the bf16 tensor-core
kernels, which reads only addresses."""

import shutil

import pytest
import torch

from dawn_tpu_torch import build
from dawn_tpu_torch.ops import local_attention as la


def test_library_path_follows_headers(tmp_path, monkeypatch):
    csrc = tmp_path / "csrc"
    shutil.copytree(build.CSRC_DIR, csrc)
    monkeypatch.setattr(build, "CSRC_DIR", str(csrc))
    monkeypatch.setattr(build, "BUILD_DIR", str(tmp_path / "_build"))
    headers = sorted(csrc.glob("*.cuh"))
    assert headers, "csrc/ has no shared header"
    names = build.sources()
    before = {name: build._library_path(name) for name in names}
    assert len(set(before.values())) == len(names)
    assert before == {name: build._library_path(name) for name in names}   # stable

    headers[0].write_text(headers[0].read_text() + "\n// edited\n")
    after = {name: build._library_path(name) for name in names}
    assert all(after[name] != before[name] for name in names)

    src = csrc / f"{names[0]}.cu"
    src.write_text(src.read_text() + "\n// edited\n")
    edited = {name: build._library_path(name) for name in names}
    assert edited[names[0]] != after[names[0]]
    assert all(edited[name] == after[name] for name in names[1:])


def test_bf16_kernels_refuse_unaligned_inputs():
    # K4 and K5 stage 16-byte rows: a view one element into a buffer is
    # refused by name, an allocation's start is taken
    buf = torch.zeros(4 * 256 + 8, dtype=torch.bfloat16)
    la._check_aligned("K5", (("q", buf[:1024]),))
    with pytest.raises(ValueError, match="K5 in bf16 needs kx 16-byte aligned"):
        la._check_aligned("K5", (("q", buf[:1024]), ("kx", buf[1:1025])))
