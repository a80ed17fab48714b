// K4 render_tiles_backward: the reverse walk of each 16x16 tile, with the
// per-Gaussian reduction of its gradients.
//
// Replaces three TPU kernels:
//   B4 gaustudio_tpu/ops/rasterize_pallas_bwd.py _backward_kernel (per-entry
//      gradients of a reverse walk over 256-aligned entry blocks),
//   B5 gaustudio_tpu/ops/rasterize_pallas_bwd.py _segreduce_kernel (sums of
//      the slot-ordered per-entry gradients per Gaussian), and
//   B6 gaustudio_tpu/ops/binning_fast.py _realign_kernel (copies each tile's
//      run into 256-aligned blocks for the training compositor).
// B6's job goes away: like K3, K4 reads each tile's run in place through the
// [start, end) ranges of K2. B5's job is done inside K4, as in K6 (the
// helpers are in common.cuh): a thread adds its pixels' ten gradient values;
// for a staged entry that some pixel of a warp applied, the warp sums them
// with one reduce-scatter (12 __shfl_xor_sync), ten lanes add the sums into
// the tile's shared row of the entry at once, and after the batch the block
// adds each touched row into the Gaussian's row of the [N, 10] output
// (d_mean 2, d_conic 3, d_opacity, d_colour 3, d_depth), which the wrapper
// zeroes and splits. Float sums therefore land in a varying order and K4 is
// not bitwise reproducible from run to run.
//
// The rules are those of gaustudio_tpu/ops/rasterize_ref.py _composite_bwd.
// One block owns one 16x16 tile; its 128 threads walk two vertically
// adjacent pixels each. The block stages entries in batches of 256 from the
// tile's largest n_contrib backwards, gathering each entry's data by
// Gaussian index as K3 does. A warp (4 rows of the tile) skips the
// positions at or above the largest n_contrib of its 64 pixels, and a
// pixel those >= its own n_contrib. A pixel recomputes power bit for bit as
// K3 did (gs_power in common.cuh), skips power > 0 or alpha < 1/255 as K3
// did, rebuilds T by division, T <- T / (1 - alpha), and keeps the suffix
// sums of colour, depth and weight of the entries behind it. Then
//   dL/dalpha = Tb (c.dC) - (S.dC)/(1-a) + Tb d dD - SD/(1-a) dD
//             + Tb dO - SO/(1-a) dO - T_final/(1-a) (bg.dC),  dO = -dL/dT_final;
//   the median-depth cotangent goes to d_depth where Tb > 0.5 > Tb (1-a);
//   d_opacity = G dL/dalpha (no 0.99-clamp gate, no extra final-opacity term);
//   dpow = G op dL/dalpha drives the mean and conic gradients.
// If one entry were decided otherwise than in the forward, every earlier T
// would be off by 1/(1-alpha): hence the shared power function.
//
// Bound: operations. Per pixel and evaluated entry one exp, a division and
// ~60 operations of gradient arithmetic (1 / (1 - alpha), which feeds only
// gradients, is a fast approximate division); per entry that a warp
// applied, the reduce-scatter and ten shared atomics for 64 pixels; per
// (entry, tile) ten global atomics, which pile onto Gaussians that cover
// many tiles. A shuffle tree per value and pixel would spend 50 shuffles
// per 32 pixels and entry, and atomics from each warp to device memory ten
// serial ones from lane 0 and up to 8 x 10 per entry and tile. The
// per-pixel cotangents are read once; the gathers of staging are random.

#include "common.cuh"

#define GS_NGRAD 10
// the reduce-scatter's 16 slots and the 10 of them that hold values
#define GS_NSLOT 16
#define GS_LIVE 0x3737u

__global__ void __launch_bounds__(GS_BWD_THREADS) render_tiles_backward_kernel(
    int grid_x, int W, int H, const int* __restrict__ ranges,
    const int* __restrict__ point_list, const float* __restrict__ means2d,
    const float* __restrict__ conic, const float* __restrict__ opacity,
    const float* __restrict__ colors, const float* __restrict__ depths,
    const float* __restrict__ bg, const float* __restrict__ final_T,
    const int* __restrict__ n_contrib, const float* __restrict__ dL_dcolor,
    const float* __restrict__ dL_ddepth, const float* __restrict__ dL_dfinal_T,
    const float* __restrict__ dL_dmedian, float* __restrict__ grads) {
  __shared__ int s_id[GS_BLOCK];
  __shared__ float2 s_xy[GS_BLOCK];
  __shared__ float4 s_conic_op[GS_BLOCK];
  __shared__ float s_rgb[GS_BLOCK * 3];
  __shared__ float s_depth[GS_BLOCK];
  __shared__ float s_grad[GS_BLOCK][GS_NGRAD];
  __shared__ int s_touched[GS_BLOCK];
  __shared__ int s_last;

  const int tile = blockIdx.x;
  const int t = threadIdx.x;
  const int lane = t & 31;
  const int px = (tile % grid_x) * GS_TILE + t % GS_TILE;
  const int py0 = (tile / grid_x) * GS_TILE + GS_BWD_PIX * (t / GS_TILE);  // rows py0, py0 + 1
  const float pxf = (float)px;

  // per pixel; pixels outside the image keep nc = 0 and never contribute
  int nc[GS_BWD_PIX];
  float pyf[GS_BWD_PIX], T[GS_BWD_PIX], T_final[GS_BWD_PIX], dC[GS_BWD_PIX][3];
  float dD[GS_BWD_PIX], dO[GS_BWD_PIX], dMed[GS_BWD_PIX], bg_dot[GS_BWD_PIX];
  // suffix sums of w * colour, w * depth and w
  float S[GS_BWD_PIX][3], SD[GS_BWD_PIX], SO[GS_BWD_PIX];
  int nc_max = 0;
#pragma unroll
  for (int p = 0; p < GS_BWD_PIX; ++p) {
    const int py = py0 + p;
    pyf[p] = (float)py;
    nc[p] = 0;
    T[p] = 1.0f;
    T_final[p] = dD[p] = dO[p] = dMed[p] = bg_dot[p] = SD[p] = SO[p] = 0.0f;
#pragma unroll
    for (int c = 0; c < 3; ++c) dC[p][c] = S[p][c] = 0.0f;
    if (px < W && py < H) {
      const int pix = py * W + px;
      const int plane = H * W;
      nc[p] = n_contrib[pix];
      T_final[p] = final_T[pix];
      T[p] = T_final[p];
#pragma unroll
      for (int c = 0; c < 3; ++c) dC[p][c] = dL_dcolor[c * plane + pix];
      dD[p] = dL_ddepth[pix];
      dO[p] = -dL_dfinal_T[pix];
      dMed[p] = dL_dmedian[pix];
      bg_dot[p] = bg[0] * dC[p][0] + bg[1] * dC[p][1] + bg[2] * dC[p][2];
    }
    nc_max = max(nc_max, nc[p]);
  }
  if (t == 0) s_last = 0;
  __syncthreads();
  if (nc_max > 0) atomicMax(&s_last, nc_max);
  __syncthreads();
  const int start = ranges[2 * tile];
  const int last = s_last;  // the tile's positions [0, last) are walked backwards
  const int warp_last = __reduce_max_sync(0xffffffffu, nc_max);  // and this warp's [0, warp_last)
  const int k_sum = gs_reduce_scatter_value<GS_NSLOT, GS_LIVE>(lane);  // the sum this lane adds

  for (int hi = last; hi > 0; hi -= GS_BLOCK) {
    const int batch = min(GS_BLOCK, hi);
    __syncthreads();  // the previous batch has been read and flushed
    for (int e = t; e < batch; e += GS_BWD_THREADS) {
      const int g = point_list[start + hi - 1 - e];
      s_id[e] = g;
      s_xy[e] = make_float2(means2d[2 * g], means2d[2 * g + 1]);
      s_conic_op[e] = make_float4(conic[3 * g], conic[3 * g + 1], conic[3 * g + 2], opacity[g]);
      s_rgb[3 * e] = colors[3 * g];
      s_rgb[3 * e + 1] = colors[3 * g + 1];
      s_rgb[3 * e + 2] = colors[3 * g + 2];
      s_depth[e] = depths[g];
#pragma unroll
      for (int k = 0; k < GS_NGRAD; ++k) s_grad[e][k] = 0.0f;
      s_touched[e] = 0;
    }
    __syncthreads();

    // staged entry j sits at position hi - 1 - j; the warp starts at its own last
    for (int j = max(0, hi - warp_last); j < batch; ++j) {
      const int pos = hi - 1 - j;
      const float4 co = s_conic_op[j];
      const float2 xy = s_xy[j];
      float v[GS_NGRAD];  // the sums over this thread's pixels
#pragma unroll
      for (int i = 0; i < GS_NGRAD; ++i) v[i] = 0.0f;
      bool contrib = false;
#pragma unroll
      for (int p = 0; p < GS_BWD_PIX; ++p) {
        if (pos >= nc[p]) continue;
        const float dx = xy.x - pxf;
        const float dy = xy.y - pyf[p];
        const float power = gs_power(co.x, co.y, co.z, dx, dy);
        const float G = expf(power);
        const float alpha = fminf(0.99f, co.w * G);
        if (!(power <= 0.0f && alpha >= 1.0f / 255.0f)) continue;
        contrib = true;
        const float one_m_a = 1.0f - alpha;
        const float Tb = T[p] / one_m_a;  // T before this entry
        const float w = alpha * Tb;
        const float c0 = s_rgb[3 * j], c1 = s_rgb[3 * j + 1], c2 = s_rgb[3 * j + 2];
        const float dep = s_depth[j];
        const float inv = __fdividef(1.0f, one_m_a);  // feeds only gradients
        const float dL_dalpha =
            Tb * (c0 * dC[p][0] + c1 * dC[p][1] + c2 * dC[p][2]) -
            (S[p][0] * dC[p][0] + S[p][1] * dC[p][1] + S[p][2] * dC[p][2]) * inv +
            Tb * dep * dD[p] - SD[p] * inv * dD[p] + Tb * dO[p] - SO[p] * inv * dO[p] -
            T_final[p] * inv * bg_dot[p];
        const bool cross = Tb > 0.5f && __fmul_rn(Tb, one_m_a) < 0.5f;
        const float dpow = G * co.w * dL_dalpha;
        v[0] -= dpow * (co.x * dx + co.y * dy);  // d_mean
        v[1] -= dpow * (co.z * dy + co.y * dx);
        v[2] -= 0.5f * dpow * dx * dx;  // d_conic
        v[3] -= dpow * dx * dy;
        v[4] -= 0.5f * dpow * dy * dy;
        v[5] += G * dL_dalpha;  // d_opacity
        v[6] += w * dC[p][0];  // d_colour
        v[7] += w * dC[p][1];
        v[8] += w * dC[p][2];
        v[9] += w * dD[p] + (cross ? dMed[p] : 0.0f);  // d_depth
        S[p][0] += w * c0;
        S[p][1] += w * c1;
        S[p][2] += w * c2;
        SD[p] += w * dep;
        SO[p] += w;
        T[p] = Tb;
      }
      if (__any_sync(0xffffffffu, contrib)) {
        const float sum = gs_warp_reduce_scatter<GS_NSLOT, GS_LIVE>(v, lane);
        if (k_sum >= 0) atomicAdd(&s_grad[j][k_sum], sum);
        if (lane == 0) s_touched[j] = 1;
      }
    }
    __syncthreads();
    gs_flush_rows<GS_NGRAD, GS_BWD_THREADS>(batch, s_id, s_touched, s_grad, grads);
  }
}

GS_API int gs_render_tiles_backward(
    int grid_x, int grid_y, int W, int H, const int* ranges, const int* point_list,
    const float* means2d, const float* conic, const float* opacity,
    const float* colors, const float* depths, const float* bg,
    const float* final_T, const int* n_contrib, const float* dL_dcolor,
    const float* dL_ddepth, const float* dL_dfinal_T, const float* dL_dmedian,
    float* grads, void* stream) {
  const int num_tiles = grid_x * grid_y;
  if (num_tiles > 0)
    render_tiles_backward_kernel<<<num_tiles, GS_BWD_THREADS, 0, (cudaStream_t)stream>>>(
        grid_x, W, H, ranges, point_list, means2d, conic, opacity, colors, depths, bg, final_T,
        n_contrib, dL_dcolor, dL_ddepth, dL_dfinal_T, dL_dmedian, grads);
  return gs_last_error();
}
