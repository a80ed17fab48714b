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
// [start, end) ranges of K2. B5's job is done inside K4: for every staged
// entry each warp sums its 32 pixels' ten gradient values with
// __shfl_down_sync, and lane 0 atomicAdds them into the per-Gaussian
// outputs, which the wrapper zeroes. Float sums therefore land in a varying
// order and K4 is not bitwise reproducible from run to run.
//
// The rules are those of gaustudio_tpu/ops/rasterize_ref.py _composite_bwd.
// One 256-thread block owns one tile and one thread one pixel. The block
// stages entries in batches of 256 from the tile's largest n_contrib
// backwards, gathering each entry's data by Gaussian index as K3 does. A
// pixel skips positions >= its own n_contrib, recomputes power bit for bit as
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
// Bound: per pixel and staged entry one exp, a division and the gradient
// arithmetic, plus 50 warp shuffles and up to 10 atomics per warp and entry
// (compute and the atomics to hot Gaussians); the per-pixel cotangents are
// read once and the gathers of staging are random.

#include "common.cuh"

#define GS_NGRAD 10

__global__ void __launch_bounds__(GS_BLOCK) render_tiles_backward_kernel(
    int grid_x, int W, int H, const int* __restrict__ ranges,
    const int* __restrict__ point_list, const float* __restrict__ means2d,
    const float* __restrict__ conic, const float* __restrict__ opacity,
    const float* __restrict__ colors, const float* __restrict__ depths,
    const float* __restrict__ bg, const float* __restrict__ final_T,
    const int* __restrict__ n_contrib, const float* __restrict__ dL_dcolor,
    const float* __restrict__ dL_ddepth, const float* __restrict__ dL_dfinal_T,
    const float* __restrict__ dL_dmedian, float* __restrict__ d_means2d,
    float* __restrict__ d_conic, float* __restrict__ d_opacity,
    float* __restrict__ d_colors, float* __restrict__ d_depths) {
  __shared__ int s_id[GS_BLOCK];
  __shared__ float2 s_xy[GS_BLOCK];
  __shared__ float4 s_conic_op[GS_BLOCK];
  __shared__ float s_rgb[GS_BLOCK * 3];
  __shared__ float s_depth[GS_BLOCK];
  __shared__ int s_last;

  const int tile = blockIdx.x;
  const int t = threadIdx.x;
  const int lane = t & 31;
  const int px = (tile % grid_x) * GS_TILE + t % GS_TILE;
  const int py = (tile / grid_x) * GS_TILE + t / GS_TILE;
  const bool inside = px < W && py < H;
  const float pxf = (float)px;
  const float pyf = (float)py;

  // pixels outside the image keep nc = 0 and never contribute
  int nc = 0;
  float T = 1.0f, T_final = 0.0f;
  float dC[3] = {0.0f, 0.0f, 0.0f};
  float dD = 0.0f, dO = 0.0f, dMed = 0.0f, bg_dot = 0.0f;
  if (inside) {
    const int pix = py * W + px;
    const int plane = H * W;
    nc = n_contrib[pix];
    T_final = final_T[pix];
    T = T_final;
    dC[0] = dL_dcolor[pix];
    dC[1] = dL_dcolor[plane + pix];
    dC[2] = dL_dcolor[2 * plane + pix];
    dD = dL_ddepth[pix];
    dO = -dL_dfinal_T[pix];
    dMed = dL_dmedian[pix];
    bg_dot = bg[0] * dC[0] + bg[1] * dC[1] + bg[2] * dC[2];
  }
  if (t == 0) s_last = 0;
  __syncthreads();
  if (nc > 0) atomicMax(&s_last, nc);
  __syncthreads();
  const int start = ranges[2 * tile];
  const int last = s_last;  // the tile's positions [0, last) are walked backwards

  float S[3] = {0.0f, 0.0f, 0.0f};
  float SD = 0.0f, SO = 0.0f;
  for (int hi = last; hi > 0; hi -= GS_BLOCK) {
    const int batch = min(GS_BLOCK, hi);
    __syncthreads();  // the previous batch has been read by every pixel
    if (t < batch) {
      const int g = point_list[start + hi - 1 - t];
      s_id[t] = g;
      s_xy[t] = make_float2(means2d[2 * g], means2d[2 * g + 1]);
      s_conic_op[t] = make_float4(conic[3 * g], conic[3 * g + 1], conic[3 * g + 2], opacity[g]);
      s_rgb[3 * t] = colors[3 * g];
      s_rgb[3 * t + 1] = colors[3 * g + 1];
      s_rgb[3 * t + 2] = colors[3 * g + 2];
      s_depth[t] = depths[g];
    }
    __syncthreads();

    for (int j = 0; j < batch; ++j) {
      float v[GS_NGRAD];
#pragma unroll
      for (int i = 0; i < GS_NGRAD; ++i) v[i] = 0.0f;
      bool contrib = false;
      if (hi - 1 - j < nc) {
        const float dx = s_xy[j].x - pxf;
        const float dy = s_xy[j].y - pyf;
        const float4 co = s_conic_op[j];
        const float power = gs_power(co.x, co.y, co.z, dx, dy);
        const float G = expf(power);
        const float alpha = fminf(0.99f, co.w * G);
        if (power <= 0.0f && alpha >= 1.0f / 255.0f) {
          contrib = true;
          const float one_m_a = 1.0f - alpha;
          const float Tb = T / one_m_a;  // T before this entry
          const float w = alpha * Tb;
          const float c0 = s_rgb[3 * j], c1 = s_rgb[3 * j + 1], c2 = s_rgb[3 * j + 2];
          const float dep = s_depth[j];
          const float inv = 1.0f / one_m_a;
          const float dL_dalpha =
              Tb * (c0 * dC[0] + c1 * dC[1] + c2 * dC[2]) -
              (S[0] * dC[0] + S[1] * dC[1] + S[2] * dC[2]) * inv +
              Tb * dep * dD - SD * inv * dD + Tb * dO - SO * inv * dO -
              T_final * inv * bg_dot;
          const bool cross = Tb > 0.5f && __fmul_rn(Tb, one_m_a) < 0.5f;
          v[0] = w * dC[0];
          v[1] = w * dC[1];
          v[2] = w * dC[2];
          v[3] = w * dD + (cross ? dMed : 0.0f);
          v[4] = G * dL_dalpha;
          const float dpow = G * co.w * dL_dalpha;
          v[5] = -dpow * (co.x * dx + co.y * dy);
          v[6] = -dpow * (co.z * dy + co.y * dx);
          v[7] = -0.5f * dpow * dx * dx;
          v[8] = -dpow * dx * dy;
          v[9] = -0.5f * dpow * dy * dy;
          S[0] += w * c0;
          S[1] += w * c1;
          S[2] += w * c2;
          SD += w * dep;
          SO += w;
          T = Tb;
        }
      }
      if (__any_sync(0xffffffffu, contrib)) {
#pragma unroll
        for (int off = 16; off > 0; off >>= 1) {
#pragma unroll
          for (int i = 0; i < GS_NGRAD; ++i) v[i] += __shfl_down_sync(0xffffffffu, v[i], off);
        }
        if (lane == 0) {
          const int g = s_id[j];
          atomicAdd(&d_colors[3 * g], v[0]);
          atomicAdd(&d_colors[3 * g + 1], v[1]);
          atomicAdd(&d_colors[3 * g + 2], v[2]);
          atomicAdd(&d_depths[g], v[3]);
          atomicAdd(&d_opacity[g], v[4]);
          atomicAdd(&d_means2d[2 * g], v[5]);
          atomicAdd(&d_means2d[2 * g + 1], v[6]);
          atomicAdd(&d_conic[3 * g], v[7]);
          atomicAdd(&d_conic[3 * g + 1], v[8]);
          atomicAdd(&d_conic[3 * g + 2], v[9]);
        }
      }
    }
  }
}

GS_API int gs_render_tiles_backward(
    int grid_x, int grid_y, int W, int H, const int* ranges, const int* point_list,
    const float* means2d, const float* conic, const float* opacity,
    const float* colors, const float* depths, const float* bg,
    const float* final_T, const int* n_contrib, const float* dL_dcolor,
    const float* dL_ddepth, const float* dL_dfinal_T, const float* dL_dmedian,
    float* d_means2d, float* d_conic, float* d_opacity, float* d_colors,
    float* d_depths, void* stream) {
  const int num_tiles = grid_x * grid_y;
  if (num_tiles > 0)
    render_tiles_backward_kernel<<<num_tiles, GS_BLOCK, 0, (cudaStream_t)stream>>>(
        grid_x, W, H, ranges, point_list, means2d, conic, opacity, colors, depths,
        bg, final_T, n_contrib, dL_dcolor, dL_ddepth, dL_dfinal_T, dL_dmedian,
        d_means2d, d_conic, d_opacity, d_colors, d_depths);
  return gs_last_error();
}
