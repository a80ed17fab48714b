// K1 duplicate_with_keys and K2 identify_tile_ranges: tile binning.
//
// K1 replaces the TPU kernel gaustudio_tpu/ops/binning_fast.py
// _fused_expand_kernel. That kernel recovers each entry slot's owning
// Gaussian from a prefix-sum row with one-hot matmuls, because a TPU has no
// fast random gather. On the card each Gaussian's thread walks its own tile
// rect instead, in two passes around a prefix sum taken by the caller:
//   count pass: kept tiles per Gaussian, after the exact max-alpha cull
//               (tile_max_alpha_keep, a port of binning_fast.py
//               _tile_max_alpha_keep);
//   write pass: at the Gaussian's offset, one int64 key
//               tile << 32 | float_bits(depth) and one int32 Gaussian index
//               per kept tile, in row-major rect order.
// Depth is > 0.2 after the near cull, so its bits order like its value, and a
// stable sort of the keys gives (tile, depth) order with ties in Gaussian
// order. Both passes are bound by the cull arithmetic of the largest rects
// (one thread walks a whole rect) and by the 12 bytes written per entry.
//
// K2 replaces gaustudio_tpu/ops/binning_fast.py _ranges_kernel, a sequential
// boundary walk over the sorted keys. Here one thread per sorted entry
// compares its tile with its neighbour's and writes the run's start or end:
// one coalesced read of the keys, bound by memory bandwidth.

#include "common.cuh"

// True iff the Gaussian's max alpha over the 16x16 pixel box of tile
// (tx, ty) can reach 1/255: minimise d^T Q d over the box (0 inside, else
// the clamped vertex of the 1-D quadratic on each of the four edges).
// Unfused, in the plain version's operation order (see common.cuh).
__device__ __forceinline__ bool tile_max_alpha_keep(
    float mx, float my, float a, float b, float c, float op, int tx, int ty) {
  const float x0 = __fmul_rn((float)tx, GS_TILE);
  const float x1 = __fadd_rn(x0, GS_TILE - 1);
  const float y0 = __fmul_rn((float)ty, GS_TILE);
  const float y1 = __fadd_rn(y0, GS_TILE - 1);
  const bool inside = (mx >= x0) && (mx <= x1) && (my >= y0) && (my <= y1);

  const float dx0 = mx - x1;
  const float dx1 = mx - x0;
  const float dy0 = my - y1;
  const float dy1 = my - y0;
  const float safe_a = fabsf(a) > 1e-12f ? a : 1e-12f;
  const float safe_c = fabsf(c) > 1e-12f ? c : 1e-12f;

  auto q = [&](float dx, float dy) {  // a dx dx + 2 b dx dy + c dy dy
    return __fadd_rn(__fadd_rn(__fmul_rn(__fmul_rn(a, dx), dx),
                               __fmul_rn(__fmul_rn(__fmul_rn(2.0f, b), dx), dy)),
                     __fmul_rn(__fmul_rn(c, dy), dy));
  };
  auto edge_y = [&](float dy) {  // minimise over dx in [dx0, dx1] at fixed dy
    const float v = fminf(fmaxf(-b * dy / safe_a, dx0), dx1);
    return q(v, dy);
  };
  auto edge_x = [&](float dx) {  // minimise over dy in [dy0, dy1] at fixed dx
    const float v = fminf(fmaxf(-b * dx / safe_c, dy0), dy1);
    return q(dx, v);
  };
  const float m = fminf(fminf(edge_y(dy0), edge_y(dy1)),
                        fminf(edge_x(dx0), edge_x(dx1)));
  const float min_q = inside ? 0.0f : m;
  const float thresh = 2.0f * logf(fmaxf(op, 1e-12f) * 255.0f);
  return (min_q <= thresh) && (op * 255.0f >= 1.0f);
}

struct Splat {
  float mx, my, a, b, c, op;
  int x0, y0, x1, y1;
};

__device__ __forceinline__ Splat load_splat(
    int g, const float* means2d, const float* conic, const float* opacity,
    const int* rect_min, const int* rect_max) {
  Splat s;
  s.mx = means2d[2 * g];
  s.my = means2d[2 * g + 1];
  s.a = conic[3 * g];
  s.b = conic[3 * g + 1];
  s.c = conic[3 * g + 2];
  s.op = opacity[g];
  s.x0 = rect_min[2 * g];
  s.y0 = rect_min[2 * g + 1];
  s.x1 = rect_max[2 * g];
  s.y1 = rect_max[2 * g + 1];
  return s;
}

__global__ void count_tiles_kernel(
    int n, const float* __restrict__ means2d, const float* __restrict__ conic,
    const float* __restrict__ opacity, const int* __restrict__ rect_min,
    const int* __restrict__ rect_max, const int* __restrict__ tiles_touched,
    int* __restrict__ counts) {
  const int g = blockIdx.x * blockDim.x + threadIdx.x;
  if (g >= n) return;
  int cnt = 0;
  if (tiles_touched[g] > 0) {
    const Splat s = load_splat(g, means2d, conic, opacity, rect_min, rect_max);
    for (int ty = s.y0; ty < s.y1; ++ty)
      for (int tx = s.x0; tx < s.x1; ++tx)
        cnt += tile_max_alpha_keep(s.mx, s.my, s.a, s.b, s.c, s.op, tx, ty);
  }
  counts[g] = cnt;
}

__global__ void write_keys_kernel(
    int n, int grid_x, const float* __restrict__ means2d,
    const float* __restrict__ conic, const float* __restrict__ opacity,
    const int* __restrict__ rect_min, const int* __restrict__ rect_max,
    const float* __restrict__ depths, const int* __restrict__ counts,
    const int64_t* __restrict__ offsets, int64_t* __restrict__ keys,
    int* __restrict__ gids) {
  const int g = blockIdx.x * blockDim.x + threadIdx.x;
  if (g >= n || counts[g] == 0) return;
  const Splat s = load_splat(g, means2d, conic, opacity, rect_min, rect_max);
  const int64_t dbits = (int64_t)__float_as_uint(depths[g]);
  int64_t off = offsets[g] - counts[g];  // offsets is the inclusive sum
  for (int ty = s.y0; ty < s.y1; ++ty) {
    for (int tx = s.x0; tx < s.x1; ++tx) {
      if (!tile_max_alpha_keep(s.mx, s.my, s.a, s.b, s.c, s.op, tx, ty)) continue;
      keys[off] = ((int64_t)(ty * grid_x + tx) << 32) | dbits;
      gids[off] = g;
      ++off;
    }
  }
}

__global__ void identify_tile_ranges_kernel(
    int num_entries, const int64_t* __restrict__ keys, int* __restrict__ ranges) {
  const int idx = blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= num_entries) return;
  const int tile = (int)(keys[idx] >> 32);
  if (idx == 0) {
    ranges[2 * tile] = 0;
  } else {
    const int prev = (int)(keys[idx - 1] >> 32);
    if (tile != prev) {
      ranges[2 * prev + 1] = idx;
      ranges[2 * tile] = idx;
    }
  }
  if (idx == num_entries - 1) ranges[2 * tile + 1] = num_entries;
}

static inline int blocks_for(int n, int threads) { return (n + threads - 1) / threads; }

GS_API int gs_count_tiles(int n, const float* means2d, const float* conic,
                          const float* opacity, const int* rect_min,
                          const int* rect_max, const int* tiles_touched,
                          int* counts, void* stream) {
  if (n > 0)
    count_tiles_kernel<<<blocks_for(n, 256), 256, 0, (cudaStream_t)stream>>>(
        n, means2d, conic, opacity, rect_min, rect_max, tiles_touched, counts);
  return gs_last_error();
}

GS_API int gs_write_keys(int n, int grid_x, const float* means2d,
                         const float* conic, const float* opacity,
                         const int* rect_min, const int* rect_max,
                         const float* depths, const int* counts,
                         const int64_t* offsets, int64_t* keys, int* gids,
                         void* stream) {
  if (n > 0)
    write_keys_kernel<<<blocks_for(n, 256), 256, 0, (cudaStream_t)stream>>>(
        n, grid_x, means2d, conic, opacity, rect_min, rect_max, depths, counts,
        offsets, keys, gids);
  return gs_last_error();
}

GS_API int gs_identify_tile_ranges(int num_entries, const int64_t* keys,
                                   int* ranges, void* stream) {
  if (num_entries > 0)
    identify_tile_ranges_kernel<<<blocks_for(num_entries, 256), 256, 0,
                                  (cudaStream_t)stream>>>(num_entries, keys, ranges);
  return gs_last_error();
}
