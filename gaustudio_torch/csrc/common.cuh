// Shared constants and device helpers of the render kernels (binning.cu,
// composite.cu, composite_bwd.cu, composite_surfel.cu,
// composite_surfel_bwd.cu).
//
// Built as one shared library with a plain C interface (see
// gaustudio_torch/utils/kernels.py); every entry point launches on the
// caller's stream, allocates nothing, and returns cudaGetLastError().
//
// The plain PyTorch versions of these kernels round once per tensor op. The
// arithmetic behind a decision (the tile cull of binning.cu; the skip, stop
// and median tests of the four compositors) is therefore written
// with __fmul_rn / __fadd_rn, which nvcc never fuses into a multiply-add, so
// each kernel decides exactly as its plain version does. Everything else may
// fuse.
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

#define GS_TILE 16
#define GS_BLOCK (GS_TILE * GS_TILE)

#define GS_API extern "C" __attribute__((visibility("default")))

static inline int gs_last_error() { return static_cast<int>(cudaGetLastError()); }

// -0.5 (a dx dx + c dy dy) - b dx dy of conic (a, b, c), unfused. It decides
// skip, stop and median in the forward (K3) and which entries the backward
// (K4) re-walks; one function keeps the two bit-identical, so the backward's
// T, rebuilt by division, retraces the forward exactly.
__device__ __forceinline__ float gs_power(float a, float b, float c, float dx, float dy) {
  return __fsub_rn(
      __fmul_rn(-0.5f, __fadd_rn(__fmul_rn(__fmul_rn(a, dx), dx),
                                 __fmul_rn(__fmul_rn(c, dy), dy))),
      __fmul_rn(__fmul_rn(b, dx), dy));
}

// One 2DGS surfel against one pixel (K5 composite_surfel.cu and K6
// composite_surfel_bwd.cu; the plain version is
// gaustudio_torch/ops/composite_surfel.py _surfel_hit). The camera ray of
// pixel (px, py) meets the splat's plane where both planes
//   hu = px Mw - Mx,  hv = py Mw - My   (M rows over (u, v, 1))
// vanish: s = hu x hv, (u, v) = (s0, s1) / s2, with s2 guarded to 1e-9.
//   rho = min(u^2 + v^2, |c - p|^2 / 2)   (3D branch, or the 2D low-pass);
//   alpha = min(0.99, op exp(-rho / 2)), 0 where alpha < 1/255 or the hit's
//   depth (Dk . (u, v, 1) on the 3D branch, Dk2 on the 2D one) is <= 0.2.
// Every operation is unfused and in the plain version's order: at global
// pixel coordinates the cross product cancels badly, and a contracted
// multiply-add there would flip use3d, the alpha cut or the T test, so the
// backward's T rebuilt by division would stop retracing the forward.
struct GsSurfelHit {
  float hu[3], hv[3];
  float sz;  // s2, guarded
  bool guarded;
  float u, v;
  float dx, dy;  // centre - pixel
  bool use3d;
  float G;
  float alpha;  // 0: the entry is skipped at this pixel
  float depth;
};

// m: Mx0..2, My0..2, Mw0..2; dk: Dk0..2; c: the centre (cx, cy).
__device__ __forceinline__ GsSurfelHit gs_surfel_hit(const float* m, const float* dk,
                                                     float cx, float cy, float op,
                                                     float px, float py) {
  GsSurfelHit h;
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    h.hu[k] = __fsub_rn(__fmul_rn(px, m[6 + k]), m[k]);
    h.hv[k] = __fsub_rn(__fmul_rn(py, m[6 + k]), m[3 + k]);
  }
  const float s0 = __fsub_rn(__fmul_rn(h.hu[1], h.hv[2]), __fmul_rn(h.hu[2], h.hv[1]));
  const float s1 = __fsub_rn(__fmul_rn(h.hu[2], h.hv[0]), __fmul_rn(h.hu[0], h.hv[2]));
  const float s2 = __fsub_rn(__fmul_rn(h.hu[0], h.hv[1]), __fmul_rn(h.hu[1], h.hv[0]));
  h.guarded = fabsf(s2) < 1e-9f;
  h.sz = h.guarded ? 1e-9f : s2;
  h.u = __fdiv_rn(s0, h.sz);
  h.v = __fdiv_rn(s1, h.sz);
  const float rho3d = __fadd_rn(__fmul_rn(h.u, h.u), __fmul_rn(h.v, h.v));
  h.dx = __fsub_rn(cx, px);
  h.dy = __fsub_rn(cy, py);
  const float rho2d = __fdiv_rn(__fadd_rn(__fmul_rn(h.dx, h.dx), __fmul_rn(h.dy, h.dy)), 2.0f);
  h.use3d = rho3d <= rho2d;
  h.G = expf(__fmul_rn(-0.5f, h.use3d ? rho3d : rho2d));
  const float alpha = fminf(0.99f, __fmul_rn(op, h.G));
  h.depth = h.use3d ? __fadd_rn(__fadd_rn(__fmul_rn(dk[0], h.u), __fmul_rn(dk[1], h.v)), dk[2])
                    : dk[2];
  h.alpha = (h.depth <= 0.2f || alpha < 1.0f / 255.0f) ? 0.0f : alpha;
  return h;
}

// A surfel entry staged in shared memory by K5 and K6: its geometry row
// (M 9, Dk 3, cx, cy, opacity), colour, view normal and Gaussian index.
#define GS_SURFEL_GEO 15

__device__ __forceinline__ void stage_surfel(
    int t, int g, const float* __restrict__ M, const float* __restrict__ Dk,
    const float* __restrict__ mean2d, const float* __restrict__ opacity,
    const float* __restrict__ colors, const float* __restrict__ normals,
    float (*s_geo)[GS_SURFEL_GEO], float (*s_rgb)[3], float (*s_nrm)[3], int* s_id) {
  s_id[t] = g;
#pragma unroll
  for (int k = 0; k < 9; ++k) s_geo[t][k] = M[9 * g + k];
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    s_geo[t][9 + k] = Dk[3 * g + k];
    s_rgb[t][k] = colors[3 * g + k];
    s_nrm[t][k] = normals[3 * g + k];
  }
  s_geo[t][12] = mean2d[2 * g];
  s_geo[t][13] = mean2d[2 * g + 1];
  s_geo[t][14] = opacity[g];
}
