// Z-buffered triangle-mesh rasterizer with per-vertex diffuse lighting: the
// host side of the face visualisations (dawn_tpu_torch/pipeline/face_viz.py).
//
// A copy of dawn_tpu/runtime/src/render.cpp's three C entries, with the same
// C interface and the same arithmetic, so both builds give the same images
// bit for bit. The reference's equivalent is the ctypes-bound CPU renderer
// extract_init_states/utils/asset/render.c. Vertex normals are accumulated
// from face normals, shading is n.l, and the inside test is barycentric with
// a per-pixel depth buffer. Built with g++ by dawn_tpu_torch/build.py
// (load_host) at first use.

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <limits>
#include <vector>

namespace {

inline void cross3(const float* a, const float* b, float* out) {
  out[0] = a[1] * b[2] - a[2] * b[1];
  out[1] = a[2] * b[0] - a[0] * b[2];
  out[2] = a[0] * b[1] - a[1] * b[0];
}

inline void normalize3(float* v) {
  float n = std::sqrt(v[0] * v[0] + v[1] * v[1] + v[2] * v[2]);
  if (n > 1e-12f) {
    v[0] /= n; v[1] /= n; v[2] /= n;
  }
}

}  // namespace

extern "C" {

// vertices: (nver, 3) xyz image-space; triangles: (ntri, 3) int32 indices;
// image: (h, w, 3) float32 RGB in [0,1], overwritten where the mesh covers;
// light: (3,) direction; ambient/diffuse: shading factors.
void dawn_render_mesh(const float* vertices, int32_t nver,
                      const int32_t* triangles, int32_t ntri,
                      float* image, int32_t h, int32_t w,
                      const float* light_dir, float ambient, float diffuse) {
  std::vector<float> normals(static_cast<size_t>(nver) * 3, 0.f);
  for (int32_t t = 0; t < ntri; ++t) {
    const int32_t* tri = triangles + t * 3;
    const float* v0 = vertices + tri[0] * 3;
    const float* v1 = vertices + tri[1] * 3;
    const float* v2 = vertices + tri[2] * 3;
    float e1[3] = {v1[0] - v0[0], v1[1] - v0[1], v1[2] - v0[2]};
    float e2[3] = {v2[0] - v0[0], v2[1] - v0[1], v2[2] - v0[2]};
    float fn[3];
    cross3(e1, e2, fn);
    for (int k = 0; k < 3; ++k) {
      float* nv = normals.data() + tri[k] * 3;
      nv[0] += fn[0]; nv[1] += fn[1]; nv[2] += fn[2];
    }
  }
  std::vector<float> shade(nver);
  float l[3] = {light_dir[0], light_dir[1], light_dir[2]};
  normalize3(l);
  for (int32_t v = 0; v < nver; ++v) {
    float* nv = normals.data() + v * 3;
    normalize3(nv);
    float ndl = std::fabs(nv[0] * l[0] + nv[1] * l[1] + nv[2] * l[2]);
    shade[v] = std::min(1.f, ambient + diffuse * ndl);
  }

  std::vector<float> zbuf(static_cast<size_t>(h) * w,
                          -std::numeric_limits<float>::infinity());
  for (int32_t t = 0; t < ntri; ++t) {
    const int32_t* tri = triangles + t * 3;
    const float* v0 = vertices + tri[0] * 3;
    const float* v1 = vertices + tri[1] * 3;
    const float* v2 = vertices + tri[2] * 3;
    int x0 = std::max(0, (int)std::ceil(std::min({v0[0], v1[0], v2[0]})));
    int x1 = std::min(w - 1, (int)std::floor(std::max({v0[0], v1[0], v2[0]})));
    int y0 = std::max(0, (int)std::ceil(std::min({v0[1], v1[1], v2[1]})));
    int y1 = std::min(h - 1, (int)std::floor(std::max({v0[1], v1[1], v2[1]})));
    if (x0 > x1 || y0 > y1) continue;
    float denom = (v1[1] - v2[1]) * (v0[0] - v2[0]) +
                  (v2[0] - v1[0]) * (v0[1] - v2[1]);
    if (std::fabs(denom) < 1e-12f) continue;
    for (int y = y0; y <= y1; ++y) {
      for (int x = x0; x <= x1; ++x) {
        float b0 = ((v1[1] - v2[1]) * (x - v2[0]) +
                    (v2[0] - v1[0]) * (y - v2[1])) / denom;
        float b1 = ((v2[1] - v0[1]) * (x - v2[0]) +
                    (v0[0] - v2[0]) * (y - v2[1])) / denom;
        float b2 = 1.f - b0 - b1;
        if (b0 < 0 || b1 < 0 || b2 < 0) continue;
        float z = b0 * v0[2] + b1 * v1[2] + b2 * v2[2];
        size_t idx = static_cast<size_t>(y) * w + x;
        if (z <= zbuf[idx]) continue;
        zbuf[idx] = z;
        float s = b0 * shade[tri[0]] + b1 * shade[tri[1]] + b2 * shade[tri[2]];
        float* px = image + idx * 3;
        px[0] = std::min(1.f, px[0] * s);
        px[1] = std::min(1.f, px[1] * s);
        px[2] = std::min(1.f, px[2] * s);
      }
    }
  }
}

// Per-pixel z-buffered DEPTH rasterization (reference utils/depth.py
// semantics: per-vertex scalar = z, barycentric-interpolated where the mesh
// covers). vertices: (nver, 3); out: (h, w) float32, 0 where uncovered.
void dawn_render_depth(const float* vertices, int32_t nver,
                       const int32_t* triangles, int32_t ntri,
                       float* out, int32_t h, int32_t w) {
  std::vector<float> zbuf(static_cast<size_t>(h) * w,
                          -std::numeric_limits<float>::infinity());
  float zmin = std::numeric_limits<float>::infinity();
  float zmax = -std::numeric_limits<float>::infinity();
  for (int32_t v = 0; v < nver; ++v) {
    zmin = std::min(zmin, vertices[v * 3 + 2]);
    zmax = std::max(zmax, vertices[v * 3 + 2]);
  }
  const float zrange = std::max(zmax - zmin, 1e-8f);
  std::memset(out, 0, sizeof(float) * static_cast<size_t>(h) * w);
  for (int32_t t = 0; t < ntri; ++t) {
    const int32_t* tri = triangles + t * 3;
    const float* v0 = vertices + tri[0] * 3;
    const float* v1 = vertices + tri[1] * 3;
    const float* v2 = vertices + tri[2] * 3;
    int x0 = std::max(0, (int)std::ceil(std::min({v0[0], v1[0], v2[0]})));
    int x1 = std::min(w - 1, (int)std::floor(std::max({v0[0], v1[0], v2[0]})));
    int y0 = std::max(0, (int)std::ceil(std::min({v0[1], v1[1], v2[1]})));
    int y1 = std::min(h - 1, (int)std::floor(std::max({v0[1], v1[1], v2[1]})));
    if (x0 > x1 || y0 > y1) continue;
    float denom = (v1[1] - v2[1]) * (v0[0] - v2[0]) +
                  (v2[0] - v1[0]) * (v0[1] - v2[1]);
    if (std::fabs(denom) < 1e-12f) continue;
    for (int y = y0; y <= y1; ++y) {
      for (int x = x0; x <= x1; ++x) {
        float b0 = ((v1[1] - v2[1]) * (x - v2[0]) +
                    (v2[0] - v1[0]) * (y - v2[1])) / denom;
        float b1 = ((v2[1] - v0[1]) * (x - v2[0]) +
                    (v0[0] - v2[0]) * (y - v2[1])) / denom;
        float b2 = 1.f - b0 - b1;
        if (b0 < 0 || b1 < 0 || b2 < 0) continue;
        float z = b0 * v0[2] + b1 * v1[2] + b2 * v2[2];
        size_t idx = static_cast<size_t>(y) * w + x;
        if (z <= zbuf[idx]) continue;
        zbuf[idx] = z;
        out[idx] = (z - zmin) / zrange;
      }
    }
  }
}

// Per-vertex-COLOR z-buffered rasterization (the Sim3DR `rasterize` the
// reference's pncc/uv visualizations call, extract_init_states/utils/
// pncc.py:44 and uv.py:86): colors (nver, 3) barycentric-interpolated into
// `image` (h, w, 3, pre-filled with the background) where the mesh covers.
void dawn_render_colors(const float* vertices, int32_t nver,
                        const int32_t* triangles, int32_t ntri,
                        const float* colors,
                        float* image, int32_t h, int32_t w) {
  (void)nver;
  std::vector<float> zbuf(static_cast<size_t>(h) * w,
                          -std::numeric_limits<float>::infinity());
  for (int32_t t = 0; t < ntri; ++t) {
    const int32_t* tri = triangles + t * 3;
    const float* v0 = vertices + tri[0] * 3;
    const float* v1 = vertices + tri[1] * 3;
    const float* v2 = vertices + tri[2] * 3;
    int x0 = std::max(0, (int)std::ceil(std::min({v0[0], v1[0], v2[0]})));
    int x1 = std::min(w - 1, (int)std::floor(std::max({v0[0], v1[0], v2[0]})));
    int y0 = std::max(0, (int)std::ceil(std::min({v0[1], v1[1], v2[1]})));
    int y1 = std::min(h - 1, (int)std::floor(std::max({v0[1], v1[1], v2[1]})));
    if (x0 > x1 || y0 > y1) continue;
    float denom = (v1[1] - v2[1]) * (v0[0] - v2[0]) +
                  (v2[0] - v1[0]) * (v0[1] - v2[1]);
    if (std::fabs(denom) < 1e-12f) continue;
    const float* c0 = colors + tri[0] * 3;
    const float* c1 = colors + tri[1] * 3;
    const float* c2 = colors + tri[2] * 3;
    for (int y = y0; y <= y1; ++y) {
      for (int x = x0; x <= x1; ++x) {
        float b0 = ((v1[1] - v2[1]) * (x - v2[0]) +
                    (v2[0] - v1[0]) * (y - v2[1])) / denom;
        float b1 = ((v2[1] - v0[1]) * (x - v2[0]) +
                    (v0[0] - v2[0]) * (y - v2[1])) / denom;
        float b2 = 1.f - b0 - b1;
        if (b0 < 0 || b1 < 0 || b2 < 0) continue;
        float z = b0 * v0[2] + b1 * v1[2] + b2 * v2[2];
        size_t idx = static_cast<size_t>(y) * w + x;
        if (z <= zbuf[idx]) continue;
        zbuf[idx] = z;
        float* px = image + idx * 3;
        for (int k = 0; k < 3; ++k)
          px[k] = b0 * c0[k] + b1 * c1[k] + b2 * c2[k];
      }
    }
  }
}

}  // extern "C"
