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
// The backward compositors (K4, K6) walk two vertically adjacent pixels a
// thread, so that a warp's reduction of an entry's gradients serves 64
// pixels: a block of GS_BWD_THREADS threads covers a tile.
#define GS_BWD_PIX 2
#define GS_BWD_THREADS (GS_BLOCK / GS_BWD_PIX)
static_assert(GS_TILE % GS_BWD_PIX == 0, "a thread's pixels are whole rows of its column");

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
  // x * 0.5 rounds exactly as x / 2 (the plain version's division by the
  // filter variance 2), and is one multiply where a division is a sequence
  const float rho2d = __fmul_rn(__fadd_rn(__fmul_rn(h.dx, h.dx), __fmul_rn(h.dy, h.dy)), 0.5f);
  h.use3d = rho3d <= rho2d;
  h.G = expf(__fmul_rn(-0.5f, h.use3d ? rho3d : rho2d));
  const float alpha = fminf(0.99f, __fmul_rn(op, h.G));
  h.depth = h.use3d ? __fadd_rn(__fadd_rn(__fmul_rn(dk[0], h.u), __fmul_rn(dk[1], h.v)), dk[2])
                    : dk[2];
  h.alpha = (h.depth <= 0.2f || alpha < 1.0f / 255.0f) ? 0.0f : alpha;
  return h;
}

// Warp reduce-scatter of the backward compositors (K4 composite_bwd.cu, K6
// composite_surfel_bwd.cu). Every lane holds V values; they sit in the slots
// of a power-of-two array of N <= 32 that the compile-time mask LIVE marks
// (the others hold 0). Recursive halving with __shfl_xor_sync: at each level
// a lane sends the half of its live slots that it will not keep and adds the
// half that it receives. A pair of slots that holds only zeros in every lane
// costs nothing, so the mask spreads the V values to halve evenly: V = 21 in
// 32 slots costs 11+6+3+2+1 = 23 shuffles, V = 10 in 16 slots
// 5+3+2+1 and one butterfly step, 12, where a shuffle tree per value costs
// 5 V. Afterwards the first lane of each group of 32 / N holds the warp's sum
// of one value (gs_reduce_scatter_value says which). The sums are taken in
// another order than a tree's, so they differ from it by rounding.
__host__ __device__ constexpr int gs_rank(unsigned live, int slot) {  // live slots below slot
  int r = 0;
  for (int s = 0; s < slot; ++s) r += (live >> s) & 1u;
  return r;
}

template <int N, int OFF, unsigned LIVE, int M>
__device__ __forceinline__ void gs_reduce_scatter_level(float (&v)[M], int lane) {
  if constexpr (N > 1) {
    const bool upper = (lane & OFF) != 0;
#pragma unroll
    for (int i = 0; i < N / 2; ++i) {
      if (((LIVE >> i) | (LIVE >> (i + N / 2))) & 1u) {  // folded at compile time
        const float lo = v[i], hi = v[i + N / 2];
        v[i] = (upper ? hi : lo) + __shfl_xor_sync(0xffffffffu, upper ? lo : hi, OFF);
      }
    }
    gs_reduce_scatter_level<N / 2, OFF / 2, (LIVE | (LIVE >> (N / 2))) & ((1u << (N / 2)) - 1u)>(
        v, lane);
  } else {
#pragma unroll
    for (int off = OFF; off > 0; off >>= 1) v[0] += __shfl_xor_sync(0xffffffffu, v[0], off);
  }
}

// v[S..N) <- the values of g in the live slots, 0 in the others; every index
// is a constant, so both arrays stay in registers.
template <unsigned LIVE, int S, int N, int V>
__device__ __forceinline__ void gs_place_slots(float (&v)[N], const float (&g)[V]) {
  if constexpr (S < N) {
    if constexpr ((LIVE >> S) & 1u) {
      constexpr int k = gs_rank(LIVE, S);
      v[S] = g[k];
    } else {
      v[S] = 0.0f;
    }
    gs_place_slots<LIVE, S + 1>(v, g);
  }
}

// g: this lane's V values in order; returns the warp's sum of value
// gs_reduce_scatter_value<N, LIVE>(lane) (meaningless where that is -1).
template <int N, unsigned LIVE, int V>
__device__ __forceinline__ float gs_warp_reduce_scatter(const float (&g)[V], int lane) {
  static_assert(N >= 1 && N <= 32 && (N & (N - 1)) == 0, "N must be a power of two <= 32");
  static_assert(gs_rank(LIVE, N) == V && (N == 32 || (LIVE >> N) == 0u),
                "LIVE must mark V slots of N");
  float v[N];
  gs_place_slots<LIVE, 0>(v, g);
  gs_reduce_scatter_level<N, 16, LIVE>(v, lane);
  return v[0];
}

// The value whose sum lane holds after gs_warp_reduce_scatter<N, LIVE>, or -1.
template <int N, unsigned LIVE>
__device__ __forceinline__ int gs_reduce_scatter_value(int lane) {
  const int slot = lane / (32 / N);
  if (lane % (32 / N) != 0 || !((LIVE >> slot) & 1u)) return -1;
  return __popc(LIVE & ((1u << slot) - 1u));
}

// The per-tile sums of K4 and K6. Each warp adds its sum of value k of staged
// entry e into s_grad[e][k] with a shared-memory atomic and marks the entry in
// s_touched; after the batch's walk and a __syncthreads() the block's THREADS
// threads add each touched row into the entry's Gaussian row of rows [N, V]
// in device memory: V global atomics per (entry, tile), where one row per
// warp would be one per warp. Neighbouring threads take neighbouring values
// of a row.
template <int V, int THREADS>
__device__ __forceinline__ void gs_flush_rows(int batch, const int* s_id, const int* s_touched,
                                              float (*s_grad)[V], float* __restrict__ rows) {
  for (int i = threadIdx.x; i < batch * V; i += THREADS) {
    const int e = i / V;
    const int k = i - e * V;
    if (s_touched[e]) atomicAdd(&rows[(size_t)V * s_id[e] + k], s_grad[e][k]);
  }
}

// A surfel entry staged in shared memory by K5: its geometry row
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
