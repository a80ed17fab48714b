// K3 render_tiles: front-to-back compositing of each 16x16 tile.
//
// Replaces the TPU kernel gaustudio_tpu/ops/rasterize_pallas.py
// _composite_kernel, which walks [16, K] attribute-major entry tables in
// 256-entry blocks and writes a [T, 16, 256] tile layout. Here one 256-thread
// block owns one tile and one thread owns one pixel. The block stages batches
// of 256 entries in shared memory, gathering each entry's mean, conic,
// opacity, colour and depth by Gaussian index, and every pixel walks the
// batch in order with the rules of gaustudio_tpu/ops/rasterize_ref.py:
//   alpha = min(0.99, op * exp(power)); skip if power > 0 or alpha < 1/255;
//   apply iff T * (1 - alpha) >= 1e-4, else the pixel is done;
//   median depth / weight / id at the 0.5 crossing of T (default depth 15).
// The block leaves early once every pixel is done (__syncthreads_count).
// Pixels outside the image start done: they load and vote but never write.
// The background is not composited in the forward, as in the reference.
//
// Bound: the per-pixel exp and blend over every staged entry (compute), and
// the random gathers of staging; the outputs are written once, [C, H, W].

#include "common.cuh"

__global__ void __launch_bounds__(GS_BLOCK) render_tiles_kernel(
    int grid_x, int W, int H, const int* __restrict__ ranges,
    const int* __restrict__ point_list, const float* __restrict__ means2d,
    const float* __restrict__ conic, const float* __restrict__ opacity,
    const float* __restrict__ colors, const float* __restrict__ depths,
    float* __restrict__ out_color, float* __restrict__ out_depth,
    float* __restrict__ out_med_depth, float* __restrict__ out_med_weight,
    int* __restrict__ out_med_id, float* __restrict__ out_final_T,
    int* __restrict__ out_n_contrib) {
  __shared__ int s_id[GS_BLOCK];
  __shared__ float2 s_xy[GS_BLOCK];
  __shared__ float4 s_conic_op[GS_BLOCK];
  __shared__ float s_rgb[GS_BLOCK * 3];
  __shared__ float s_depth[GS_BLOCK];

  const int tile = blockIdx.x;
  const int t = threadIdx.x;
  const int px = (tile % grid_x) * GS_TILE + t % GS_TILE;
  const int py = (tile / grid_x) * GS_TILE + t / GS_TILE;
  const bool inside = px < W && py < H;
  const float pxf = (float)px;
  const float pyf = (float)py;

  const int start = ranges[2 * tile];
  const int end = ranges[2 * tile + 1];
  const int rounds = (end - start + GS_BLOCK - 1) / GS_BLOCK;
  int todo = end - start;

  bool done = !inside;
  float T = 1.0f;
  float C[3] = {0.0f, 0.0f, 0.0f};
  float D = 0.0f;
  float med_d = 15.0f, med_w = 0.0f;
  int med_i = 0;
  int contributor = 0, last_contributor = 0;

  for (int r = 0; r < rounds; ++r, todo -= GS_BLOCK) {
    if (__syncthreads_count(done) == GS_BLOCK) break;
    const int k = start + r * GS_BLOCK + t;
    if (k < end) {
      const int g = point_list[k];
      s_id[t] = g;
      s_xy[t] = make_float2(means2d[2 * g], means2d[2 * g + 1]);
      s_conic_op[t] = make_float4(conic[3 * g], conic[3 * g + 1], conic[3 * g + 2], opacity[g]);
      s_rgb[3 * t] = colors[3 * g];
      s_rgb[3 * t + 1] = colors[3 * g + 1];
      s_rgb[3 * t + 2] = colors[3 * g + 2];
      s_depth[t] = depths[g];
    }
    __syncthreads();

    const int batch = min(GS_BLOCK, todo);
    for (int j = 0; !done && j < batch; ++j) {
      ++contributor;
      const float dx = s_xy[j].x - pxf;
      const float dy = s_xy[j].y - pyf;
      const float4 co = s_conic_op[j];
      // unfused: it decides skip, stop and median, which must match the plain
      // version and K4's re-walk (see common.cuh)
      const float power = gs_power(co.x, co.y, co.z, dx, dy);
      if (power > 0.0f) continue;
      const float alpha = fminf(0.99f, co.w * expf(power));
      if (alpha < 1.0f / 255.0f) continue;
      const float test_T = T * (1.0f - alpha);
      if (test_T < 1e-4f) {
        done = true;
        continue;
      }
      const float w = alpha * T;
      C[0] += s_rgb[3 * j] * w;
      C[1] += s_rgb[3 * j + 1] * w;
      C[2] += s_rgb[3 * j + 2] * w;
      D += s_depth[j] * w;
      if (T > 0.5f && test_T < 0.5f) {
        med_d = s_depth[j];
        med_w = w;
        med_i = s_id[j];
      }
      T = test_T;
      last_contributor = contributor;
    }
  }

  if (inside) {
    const int pix = py * W + px;
    const int plane = H * W;
    out_color[pix] = C[0];
    out_color[plane + pix] = C[1];
    out_color[2 * plane + pix] = C[2];
    out_depth[pix] = D;
    out_med_depth[pix] = med_d;
    out_med_weight[pix] = med_w;
    out_med_id[pix] = med_i;
    out_final_T[pix] = T;
    out_n_contrib[pix] = last_contributor;
  }
}

GS_API int gs_render_tiles(int grid_x, int grid_y, int W, int H,
                           const int* ranges, const int* point_list,
                           const float* means2d, const float* conic,
                           const float* opacity, const float* colors,
                           const float* depths, float* out_color,
                           float* out_depth, float* out_med_depth,
                           float* out_med_weight, int* out_med_id,
                           float* out_final_T, int* out_n_contrib,
                           void* stream) {
  const int num_tiles = grid_x * grid_y;
  if (num_tiles > 0)
    render_tiles_kernel<<<num_tiles, GS_BLOCK, 0, (cudaStream_t)stream>>>(
        grid_x, W, H, ranges, point_list, means2d, conic, opacity, colors,
        depths, out_color, out_depth, out_med_depth, out_med_weight, out_med_id,
        out_final_T, out_n_contrib);
  return gs_last_error();
}
