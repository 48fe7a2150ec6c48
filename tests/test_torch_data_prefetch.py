"""The port's DM input pipeline on the CPU: the threaded C++ chunk reader,
the prefetching batch iterator and the teacher cache.

The reader (``dawn_tpu_torch/csrc/host/npy_prefetch.cpp``) is built here
with g++, as on the card's machine; the tests skip only where g++ is
missing. On chip_smoke.py's synthetic chunked-npy tree:

- ``NativeChunkReader`` gives exactly ``np.load``'s arrays (uint8 frames,
  f32 features, a Fortran-ordered array, a version-2 header), and
  ``read_block_range`` through it the same frames across chunk borders;
- ``batches_prefetched`` gives batch for batch what ``batches`` gives, and
  both what the JAX package's ``HDTFVideoDataset.batches`` gives for the same
  seed and ``start_stride`` (the clip keys too); a worker's error is raised
  on the consumer's side; a consumer that stops early stops the worker;
- ``TeacherCache`` round-trips f32 entries exactly and f16 entries to f16
  rounding, counts hits and misses as the JAX cache does, and each
  package reads the other's files.
"""

import os
import shutil

import numpy as np
import pytest

from chip_smoke import write_hdtf_tree
from dawn_tpu.train.data import HDTFVideoDataset as JaxDataset
from dawn_tpu.train.data import TeacherCache as JaxCache
from dawn_tpu_torch.train.data import (HDTFVideoDataset, NativeChunkReader, TeacherCache,
                                       read_block_range)

pytestmark = pytest.mark.skipif(shutil.which("g++") is None and shutil.which("c++") is None,
                                reason="no C++ compiler to build the chunk reader")

S = 16
LENGTHS = {"vid_000": 60, "vid_001": 30, "vid_002": 12, "vid_003": 51}


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("hdtf"))
    write_hdtf_tree(root, LENGTHS, S, seed=4)
    dirs = [os.path.join(root, k) for k in ("frames", "hubert", "pose", "eye")]
    return root, dirs + [os.path.join(root, "length_dict.pkl")]


@pytest.fixture(scope="module")
def reader():
    r = NativeChunkReader(n_threads=3)
    yield r
    r.close()


def test_reader_matches_np_load(tree, reader, tmp_path):
    root, _ = tree
    paths = [os.path.join(root, kind, "vid_000", f"chunk_{i:04d}.npy")
             for kind in ("frames", "hubert", "lmk") for i in range(3)]
    fortran = str(tmp_path / "fortran.npy")
    np.save(fortran, np.asfortranarray(np.arange(60, dtype=np.float64).reshape(6, 10)))
    v2 = str(tmp_path / "v2.npy")
    with open(v2, "wb") as f:
        np.lib.format.write_array(f, np.arange(7, dtype=np.int16), version=(2, 0))
    paths += [fortran, v2]
    for path, got in zip(paths, reader.read_many(paths)):
        want = np.load(path)
        assert got.dtype == want.dtype and got.shape == want.shape, path
        np.testing.assert_array_equal(got, want, err_msg=path)


@pytest.mark.parametrize("start,end", [(24, 52), (0, 25), (50, 60), (3, 4)])
def test_read_block_range_with_reader(tree, reader, start, end):
    root, _ = tree
    d = os.path.join(root, "hubert", "vid_000")
    np.testing.assert_array_equal(read_block_range(d, start, end, reader),
                                  read_block_range(d, start, end))


@pytest.mark.parametrize("stride", [None, 5])
def test_prefetched_batches_match_batches_and_jax(tree, stride):
    root, args = tree
    kw = dict(lmk_dir=os.path.join(root, "lmk"), num_frames=20, seed=7, start_stride=stride)
    plain = list(HDTFVideoDataset(*args, **kw).batches(3, 4, with_meta=True))
    pre = list(HDTFVideoDataset(*args, **kw).batches_prefetched(3, 4, n_threads=3,
                                                                with_meta=True))
    jax_side = list(JaxDataset(*args, **kw).batches(3, 4, with_meta=True))
    assert len(plain) == len(pre) == len(jax_side) == 4
    for (a, ma), (b, mb), (c, mc) in zip(plain, pre, jax_side):
        assert ma == mb == mc
        if stride:
            assert all(start % stride == 0 for _, start in ma)
        assert sorted(a) == sorted(b) == sorted(c)
        for k in a:
            assert a[k].dtype == b[k].dtype == c[k].dtype, k
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
            np.testing.assert_array_equal(a[k], c[k], err_msg=k)


def test_prefetched_raises_worker_errors(tree):
    _, args = tree
    ds = HDTFVideoDataset(*args, num_frames=20, seed=0)
    ds.dirs["hubert"] = ds.dirs["hubert"] + "_missing"
    with pytest.raises(FileNotFoundError):
        list(ds.batches_prefetched(1, 2))


def test_prefetched_consumer_stops_early(tree):
    _, args = tree
    it = HDTFVideoDataset(*args, num_frames=20, seed=0).batches_prefetched(2, 50, depth=1)
    first = next(it)
    assert first["video"].shape == (2, 20, S, S, 3)
    it.close()          # joins the worker, which must not wait on a full queue


def _entry(seed, t=3):
    r = np.random.RandomState(seed)
    return {"real_vid_grid": r.uniform(-1, 1, (t, 4, 4, 2)).astype(np.float32),
            "real_vid_conf": r.uniform(0, 1, (t, 4, 4, 1)).astype(np.float32),
            "ref_img_fea": r.randn(4, 4, 8).astype(np.float32)}


@pytest.mark.parametrize("dtype", [np.float32, np.float16])
def test_teacher_cache_round_trips_both_ways(tmp_path, dtype):
    ours, theirs = (TeacherCache(str(tmp_path / n), dtype=dtype) for n in ("port", "jax"))
    ours.put("vid_a", 10, _entry(1))
    theirs.put("vid_b", 0, _entry(2))
    assert os.listdir(tmp_path / "port") == ["vid_a__000010.npz"]
    for name, start, seed, root in (("vid_a", 10, 1, "port"), ("vid_b", 0, 2, "jax")):
        want = _entry(seed)
        for reader in (TeacherCache(str(tmp_path / root)), JaxCache(str(tmp_path / root))):
            got = reader.get(name, start)
            assert sorted(got) == sorted(want)
            for k, v in want.items():
                assert got[k].dtype == np.float32, k
                np.testing.assert_array_equal(got[k], v.astype(dtype).astype(np.float32), k)
    assert ours.get("vid_a", 5) is None


def test_teacher_cache_convert_batch_matches_jax(tmp_path):
    r = np.random.RandomState(3)
    batch = {"video": (r.rand(2, 3, 8, 8, 3) * 255).astype(np.uint8),
             "hubert": r.randn(2, 3, 16).astype(np.float32)}
    meta = [("vid_a", 0), ("vid_b", 25)]

    def compute(calls):
        def fn(video):
            calls.append(video.shape)
            base = np.asarray(video, np.float32).mean(axis=(2, 3, 4))
            return {"real_vid_grid": np.tile(base[..., None, None, None], (1, 1, 4, 4, 2)),
                    "real_vid_conf": np.tile(base[..., None, None, None], (1, 1, 4, 4, 1)),
                    "ref_img_fea": np.tile(base[:, :1, None], (1, 4, 8))}
        return fn

    outs = {}
    for label, cls in (("port", TeacherCache), ("jax", JaxCache)):
        cache, calls = cls(str(tmp_path / label)), []
        first = cache.convert_batch(batch, meta, compute(calls))
        again = cache.convert_batch(batch, meta, compute(calls))
        assert len(calls) == 1 and (cache.hits, cache.misses) == (2, 2)
        assert "video" not in first and "video" not in again
        outs[label] = (first, again)
    port_cache = TeacherCache(str(tmp_path / "port"))
    assert port_cache.hit_rate is None
    port_cache.convert_batch(batch, [("vid_a", 0), ("vid_c", 5)], compute([]))
    assert port_cache.hit_rate == 0.5
    for a, b in zip(outs["port"], outs["jax"]):
        assert sorted(a) == sorted(b)
        for k in a:
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
