"""The port's face visualisation, mesh export, host rasteriser and soft-NMS
against the JAX package's.

- ``pipeline/mesh_io.py``: the same .ply and .obj files, byte for byte,
  per face and merged.
- ``models/face3d/nms.py::soft_nms``: the same kept rows as
  ``soft_nms_numpy`` for the linear, gaussian and hard methods.
- ``csrc/host/render.cpp`` (built with g++ by ``build.load_host``): the same
  bits as the JAX package's ``libdawn_rt.so`` for its three C entries. Both
  are the same source built with ``-O3 -fPIC -std=c++17`` for x86-64, which
  contracts no multiply-add.
- the plain numpy versions against the library by the JAX tests' rule
  (``tests/test_viz_and_profiling.py``): depth within 1e-5 where both cover,
  at most 4 pixels covered by one only; colours off by more than 1e-4 on
  under 2 % of the pixels (float64 against float32 barycentrics at the
  triangles' edges).
- every public function of ``pipeline/face_viz.py`` equal to JAX's on a
  small seeded mesh, and the library's refusal to fall back.
"""

import os

import numpy as np
import pytest

from dawn_tpu.models.face3d.nms import soft_nms_numpy
from dawn_tpu.pipeline import face_viz as jax_viz
from dawn_tpu.pipeline import mesh_io as jax_mesh_io
from dawn_tpu.runtime import native as jax_native
from dawn_tpu_torch import build
from dawn_tpu_torch.models.face3d.nms import soft_nms
from dawn_tpu_torch.pipeline import face_viz, mesh_io
from dawn_tpu_torch.runtime import native

N_VER, N_TRI, SIZE = 60, 90, 96


@pytest.fixture(scope="module")
def jax_lib():
    lib = jax_native.load()
    if lib is None:
        pytest.fail("the JAX package's libdawn_rt.so does not load")
    return lib


@pytest.fixture()
def mesh():
    """Seeded (3, N) image-space faces, their triangles, a uint8 RGB image
    and a 62-d 3DMM param with a small rotation."""
    rng = np.random.RandomState(7)
    ver_lst = [np.stack([rng.uniform(10, SIZE - 10, N_VER), rng.uniform(10, SIZE - 10, N_VER),
                         rng.uniform(-5, 5, N_VER)]).astype(np.float32) for _ in range(2)]
    tri = rng.randint(0, N_VER, (N_TRI, 3)).astype(np.int32)
    img = rng.randint(0, 255, (SIZE, SIZE, 3)).astype(np.uint8)
    param = np.zeros(62, np.float32)
    c, s = np.cos(0.2), np.sin(0.2)
    rot = np.array([[c, 0, s], [0, 1, 0], [-s, 0, c]], np.float32) * 0.001
    param[:12] = np.hstack([rot, [[48.], [48.], [0.]]]).ravel()
    return ver_lst, tri, img, param


@pytest.mark.parametrize("merge", [False, True])
def test_mesh_io_files_byte_identical(mesh, tmp_path, merge):
    ver_lst, tri, img, _ = mesh
    for writer, args in (("ser_to_ply", (ver_lst, tri, SIZE)),
                         ("ser_to_obj", (img, ver_lst, tri, SIZE))):
        ext = ".ply" if writer == "ser_to_ply" else ".obj"
        want = getattr(jax_mesh_io, writer)(*args, str(tmp_path / f"jax{ext}"), merge=merge)
        got = getattr(mesh_io, writer)(*args, str(tmp_path / f"port{ext}"), merge=merge)
        assert len(got) == len(want) == (1 if merge else 2)
        for g, w in zip(got, want):
            assert os.path.basename(g).replace("port", "jax") == os.path.basename(w)
            assert open(g, "rb").read() == open(w, "rb").read()


@pytest.mark.parametrize("method", [0, 1, 2])
def test_soft_nms_matches_jax(method):
    rng = np.random.RandomState(method)
    xy = rng.uniform(0, 200, (40, 2))
    wh = rng.uniform(20, 80, (40, 2))
    dets = np.hstack([xy, xy + wh, rng.rand(40, 1)]).astype(np.float32)
    for sigma, nt, threshold in ((0.5, 0.3, 0.001), (0.3, 0.5, 0.2)):
        want = soft_nms_numpy(dets, sigma, nt, threshold, method)
        got = soft_nms(dets, sigma, nt, threshold, method)
        np.testing.assert_array_equal(got, want)
        assert 0 < len(got) <= len(dets)
        if threshold == 0.2:            # the in-loop pruning drops boxes
            assert len(got) < len(dets)


def _raster_inputs(seed):
    rng = np.random.RandomState(seed)
    v = np.column_stack([rng.uniform(-4, 68, 300), rng.uniform(-4, 68, 300),
                         rng.uniform(-5, 5, 300)]).astype(np.float32)
    t = rng.randint(0, 300, (400, 3)).astype(np.int32)
    return v, t, rng.rand(300, 3).astype(np.float32), rng.rand(64, 72, 3).astype(np.float32)


@pytest.mark.parametrize("entry", ["render_mesh", "render_depth", "render_colors"])
def test_render_library_bit_equal_to_jax(jax_lib, entry):
    v, t, colors, img = _raster_inputs(3)
    if entry == "render_mesh":
        want = jax_native.render_mesh(jax_lib, v, t, img.copy(), (0.3, -0.2, 1.0), 0.5, 0.45)
        got = native.render_mesh(v, t, img.copy(), (0.3, -0.2, 1.0), 0.5, 0.45)
    elif entry == "render_depth":
        want = jax_native.render_depth(jax_lib, v, t, 64, 72)
        got = native.render_depth(v, t, 64, 72)
    else:
        want = jax_native.render_colors(jax_lib, v, t, colors, img.copy())
        got = native.render_colors(v, t, colors, img.copy())
    assert got.dtype == np.float32 and (got != (img if got.ndim == 3 else 0)).any()
    np.testing.assert_array_equal(got, want)


def test_render_library_validates_inputs():
    v, t, colors, img = _raster_inputs(4)
    with pytest.raises(ValueError, match="triangle indices"):
        native.render_depth(v, np.array([[0, 1, 300]], np.int32), 8, 8)
    with pytest.raises(ValueError, match="colors"):
        native.render_colors(v, t, colors[:10], img)
    with pytest.raises(ValueError, match="vertices"):
        native.render_depth(v.T, t, 8, 8)


def test_plain_depth_against_library():
    """The JAX test's case (one triangle, z across it) and a seeded mesh."""
    verts = np.array([[2, 2, 0.0], [12, 2, 1.0], [2, 12, 2.0]], np.float32)
    d = face_viz.render_depth(verts.T, np.array([[0, 1, 2]], np.int32), 16, 16)
    assert d[15, 15] == 0.0 and 0 < d[3, 3] < d[3, 8] and d[3, 3] < d[10, 3]
    v, t, _, _ = _raster_inputs(5)
    for ver, tri, h, w in ((verts.T, np.array([[0, 1, 2]]), 16, 16), (v.T, t, 64, 72)):
        lib = face_viz.render_depth(ver, tri, h, w)
        plain = face_viz.render_depth_plain(ver, tri, h, w)
        both = (lib > 0) & (plain > 0)
        assert both.sum() > 10
        assert np.abs(lib - plain)[both].max() < 1e-5
        assert ((lib > 0) != (plain > 0)).sum() <= 4


def test_plain_colors_against_library():
    rng = np.random.RandomState(3)       # the JAX test's inputs
    verts = np.column_stack([rng.uniform(0, 31, 12), rng.uniform(0, 31, 12),
                             rng.uniform(0, 4, 12)]).astype(np.float32)
    tris = rng.randint(0, 12, (8, 3)).astype(np.int32)
    colors = rng.rand(12, 3).astype(np.float32)
    bg = rng.rand(32, 32, 3).astype(np.float32)
    v, t, c, img = _raster_inputs(6)
    for args in ((verts, tris, colors, bg), (v, t, c, img)):
        lib = face_viz.rasterize_colors(*args)
        plain = face_viz.rasterize_colors_plain(*args)
        assert (lib != args[3]).any()
        assert (np.abs(lib - plain).max(axis=-1) > 1e-4).mean() < 0.02


def test_face_viz_matches_jax(mesh, jax_lib, tmp_path):
    ver_lst, tri, img, param = mesh
    ver = ver_lst[0]
    P, angles = face_viz.calc_pose(param)
    P_j, angles_j = jax_viz.calc_pose(param)
    np.testing.assert_array_equal(P, P_j)
    assert angles == angles_j
    assert face_viz.calc_hypotenuse(ver) == jax_viz.calc_hypotenuse(ver)
    np.testing.assert_array_equal(face_viz.build_camera_box(33.0), jax_viz.build_camera_box(33.0))
    box = face_viz.plot_pose_box(img.copy(), P, ver)
    assert (box != img).any()
    np.testing.assert_array_equal(box, jax_viz.plot_pose_box(img.copy(), P_j, ver))
    np.testing.assert_array_equal(face_viz.draw_landmarks(img.copy(), ver),
                                  jax_viz.draw_landmarks(img.copy(), ver))
    wfp, wfp_j = str(tmp_path / "pose.png"), str(tmp_path / "pose_jax.png")
    out = face_viz.viz_pose(img.copy(), [param, param], ver_lst, wfp=wfp)
    np.testing.assert_array_equal(out, jax_viz.viz_pose(img.copy(), [param, param], ver_lst,
                                                        wfp=wfp_j))
    assert open(wfp, "rb").read() == open(wfp_j, "rb").read()
    np.testing.assert_array_equal(face_viz.render_depth(ver, tri, SIZE, SIZE),
                                  jax_viz.render_depth(ver, tri, SIZE, SIZE))
    for image in (img, img.astype(np.float32) / 255.0):
        np.testing.assert_array_equal(face_viz.render_mesh_overlay(image, ver, tri, 0.5),
                                      jax_viz.render_mesh_overlay(image, ver, tri, 0.5))

    rng = np.random.RandomState(1)
    u = rng.randn(N_VER * 3)
    ncc = face_viz.calc_ncc_code(u)
    np.testing.assert_array_equal(ncc, jax_viz.calc_ncc_code(u))
    for bg in (True, False):
        got = face_viz.pncc(img, ver_lst, tri, ncc, with_bg_flag=bg)
        assert got.dtype == np.uint8 and (got != (img if bg else 0)).any()
        np.testing.assert_array_equal(got, jax_viz.pncc(img, ver_lst, tri, ncc, with_bg_flag=bg))
    uv = rng.rand(N_VER, 2).astype(np.float32)
    np.testing.assert_array_equal(face_viz.process_uv(uv, 40, 48), jax_viz.process_uv(uv, 40, 48))
    np.testing.assert_array_equal(face_viz.get_colors(img, ver), jax_viz.get_colors(img, ver))
    for image in (img, img.astype(np.float32) / 255.0):
        got = face_viz.uv_tex(image, ver_lst, tri, uv, uv_h=40, uv_w=48)
        assert got.shape == (40, 48, 3) and got.any()
        np.testing.assert_array_equal(got, jax_viz.uv_tex(image, ver_lst, tri, uv, uv_h=40,
                                                          uv_w=48))


def test_face_viz_raises_without_library(monkeypatch, mesh):
    """No silent fallback: a library that cannot be built fails the call."""
    ver_lst, tri, img, _ = mesh

    def no_compiler(name):
        raise RuntimeError(f"no C++ compiler (g++) to build csrc/host/{name}.cpp")

    monkeypatch.setattr(build, "load_host", no_compiler)
    for call in (lambda: face_viz.render_depth(ver_lst[0], tri, SIZE, SIZE),
                 lambda: face_viz.render_mesh_overlay(img, ver_lst[0], tri),
                 lambda: face_viz.pncc(img, ver_lst, tri, np.ones((N_VER, 3), np.float32))):
        with pytest.raises(RuntimeError, match="g\\+\\+"):
            call()
