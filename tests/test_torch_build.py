"""The kernel build's cache key (``dawn_tpu_torch/build.py``): a library is
named by a hash of its source, every shared header under ``csrc/`` and the
nvcc flags, so an edited header never loads a stale library. Needs no nvcc
and no card: it only computes paths, on a copy of ``csrc/`` in a temporary
directory; one case edits the first source, the other the source that holds
K4 and K6. Also the wrappers' alignment rule for the bf16 tensor-core
kernels, which reads only addresses."""

import shutil

import pytest
import torch

from dawn_tpu_torch import build
from dawn_tpu_torch.ops import local_attention as la


# the first source, and the one that holds both K4 and K6
@pytest.mark.parametrize("edited", ["local_attention", "local_attention_tiled_bwd"])
def test_library_path_follows_headers(tmp_path, monkeypatch, edited):
    csrc = tmp_path / "csrc"
    shutil.copytree(build.CSRC_DIR, csrc)
    monkeypatch.setattr(build, "CSRC_DIR", str(csrc))
    monkeypatch.setattr(build, "BUILD_DIR", str(tmp_path / "_build"))
    headers = sorted(csrc.glob("*.cuh"))
    assert headers, "csrc/ has no shared header"
    names = build.sources()
    assert edited in names
    before = {name: build._library_path(name) for name in names}
    assert len(set(before.values())) == len(names)
    assert before == {name: build._library_path(name) for name in names}   # stable

    headers[0].write_text(headers[0].read_text() + "\n// edited\n")
    after = {name: build._library_path(name) for name in names}
    assert all(after[name] != before[name] for name in names)

    src = csrc / f"{edited}.cu"
    src.write_text(src.read_text() + "\n// edited\n")
    edited_paths = {name: build._library_path(name) for name in names}
    assert edited_paths[edited] != after[edited]
    assert all(edited_paths[name] == after[name] for name in names if name != edited)


def test_bf16_kernels_refuse_unaligned_inputs():
    # K1-K6 stage 16-byte rows in bf16: a view one element into a buffer is
    # refused by name, an allocation's start is taken
    buf = torch.zeros(4 * 256 + 8, dtype=torch.bfloat16)
    la._check_aligned("K5", (("q", buf[:1024]),))
    with pytest.raises(ValueError, match="K5 in bf16 needs kx 16-byte aligned"):
        la._check_aligned("K5", (("q", buf[:1024]), ("kx", buf[1:1025])))
    for kernel, name in (("K2", "g"), ("K3", "v")):
        with pytest.raises(ValueError, match=f"{kernel} in bf16 needs {name} 16-byte aligned"):
            la._check_aligned(kernel, (("q", buf[:1024]), (name, buf[1:1025])))
