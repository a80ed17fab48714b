// K3 render_tiles: front-to-back compositing of each 16x16 tile.
//
// Replaces the TPU kernel gaustudio_tpu/ops/rasterize_pallas.py
// _composite_kernel, which walks [16, K] attribute-major entry tables in
// 256-entry blocks and writes a [T, 16, 256] tile layout. Here one block owns
// one tile, and each of its 128 threads two vertically adjacent pixels. The
// block stages batches of the tile's run [start, end) (K2's ranges) in shared
// memory, gathering each entry's mean, conic, opacity, colour and depth by
// Gaussian index, and every pixel walks the batch in order with the rules of
// gaustudio_tpu/ops/rasterize_ref.py:
//   alpha = min(0.99, op * exp(power)); skip if power > 0 or alpha < 1/255;
//   apply iff T * (1 - alpha) >= 1e-4, else the pixel is done;
//   median depth / weight / id at the 0.5 crossing of T (default depth 15);
//   n_contrib is 1 + the in-tile position of the last applied entry.
// A thread leaves the walk once both its pixels are done, and the block once
// every thread has (__syncthreads_count). Pixels outside the image start
// done: they never write (a tile's second pixel lies below the image where
// the tile holds an odd number of the image's rows). The background is not
// composited in the forward, as in the reference.
//
// Bound: instruction throughput. Per (entry, pixel) pair the arithmetic is ~20
// operations (power, exp, alpha, tests; the blend where applied), and the
// one-pixel-a-thread design spent as much again on shared loads (six scalar
// ones a pair), loop bookkeeping and done lanes. Here an entry is staged as
// three float4 records, so a thread reads it in two 16-byte loads (the
// colour's third only where a pixel applies it), and the loads, the loop
// bookkeeping and gs_power's terms of dx alone (a dx dx and b dx, shared by
// the pair's one column) serve both pixels. Most pairs miss: a pair whose
// power lies below -gs_alpha_cut(opacity) (common.cuh; staged with the
// entry) is skipped before the exp, where the exact test would skip it too.
// The decision arithmetic stays unfused in gs_power's order (common.cuh), so
// K4 and the plain version decide alike; the blend may fuse. The gathers of
// staging are random (40 bytes an entry); the outputs are written once,
// [C, H, W]. 48 registers, 13,312 B of shared memory: ten 128-thread blocks
// an SM, bound by the registers.
#include "common.cuh"

// entries staged at a time: two a thread
#define GS_FWD_BATCH 256

__global__ void __launch_bounds__(GS_PAIR_THREADS) render_tiles_kernel(
    int grid_x, int W, int H, const int* __restrict__ ranges,
    const int* __restrict__ point_list, const float* __restrict__ means2d,
    const float* __restrict__ conic, const float* __restrict__ opacity,
    const float* __restrict__ colors, const float* __restrict__ depths,
    float* __restrict__ out_color, float* __restrict__ out_depth,
    float* __restrict__ out_med_depth, float* __restrict__ out_med_weight,
    int* __restrict__ out_med_id, float* __restrict__ out_final_T,
    int* __restrict__ out_n_contrib) {
  __shared__ int s_id[GS_FWD_BATCH];
  __shared__ float4 s_geo[GS_FWD_BATCH];  // mean x, y, conic a, b
  __shared__ float4 s_cod[GS_FWD_BATCH];  // conic c, opacity, depth, gs_alpha_cut(opacity)
  __shared__ float4 s_rgb[GS_FWD_BATCH];  // colour, -

  const int tile = blockIdx.x;
  const int t = threadIdx.x;
  const int px = (tile % grid_x) * GS_TILE + t % GS_TILE;
  const int py0 = (tile / grid_x) * GS_TILE + GS_PIX * (t / GS_TILE);  // rows py0, py0 + 1
  const float pxf = (float)px;

  float pyf[GS_PIX], T[GS_PIX], C[GS_PIX][3], D[GS_PIX], med_d[GS_PIX], med_w[GS_PIX];
  int med_i[GS_PIX], n_con[GS_PIX];
  bool done[GS_PIX];
#pragma unroll
  for (int p = 0; p < GS_PIX; ++p) {
    pyf[p] = (float)(py0 + p);
    done[p] = !(px < W && py0 + p < H);
    T[p] = 1.0f;
    C[p][0] = C[p][1] = C[p][2] = D[p] = med_w[p] = 0.0f;
    med_d[p] = 15.0f;
    med_i[p] = n_con[p] = 0;
  }
  bool all_done = gs_all(done);

  const int start = ranges[2 * tile];
  const int end = ranges[2 * tile + 1];
  for (int base = start; base < end; base += GS_FWD_BATCH) {
    if (__syncthreads_count(all_done) == GS_PAIR_THREADS) break;
    const int batch = min(GS_FWD_BATCH, end - base);
    for (int e = t; e < batch; e += GS_PAIR_THREADS) {
      const int g = point_list[base + e];
      s_id[e] = g;
      s_geo[e] = make_float4(means2d[2 * g], means2d[2 * g + 1], conic[3 * g], conic[3 * g + 1]);
      const float op = opacity[g];
      s_cod[e] = make_float4(conic[3 * g + 2], op, depths[g], gs_alpha_cut(op));
      s_rgb[e] = make_float4(colors[3 * g], colors[3 * g + 1], colors[3 * g + 2], 0.0f);
    }
    __syncthreads();

    for (int j = 0; !all_done && j < batch; ++j) {
      const float4 q0 = s_geo[j];
      const float4 q1 = s_cod[j];
      // unfused: it decides skip, stop and median, which must match the plain
      // version and K4's re-walk (see common.cuh)
      const GsPowerCol col = gs_power_col(q0.z, q0.w, q0.x - pxf);
#pragma unroll
      for (int p = 0; p < GS_PIX; ++p) {
        if (done[p]) continue;
        const float power = gs_power_row(col, q1.x, q0.y - pyf[p]);
        if (power > 0.0f || power < -q1.w) continue;  // the second: alpha < 1/255, exactly
        const float alpha = fminf(0.99f, q1.y * expf(power));
        if (alpha < 1.0f / 255.0f) continue;
        const float test_T = T[p] * (1.0f - alpha);
        if (test_T < 1e-4f) {
          done[p] = true;
          continue;
        }
        const float w = alpha * T[p];
        const float4 rgb = s_rgb[j];
        C[p][0] += rgb.x * w;
        C[p][1] += rgb.y * w;
        C[p][2] += rgb.z * w;
        D[p] += q1.z * w;
        if (T[p] > 0.5f && test_T < 0.5f) {
          med_d[p] = q1.z;
          med_w[p] = w;
          med_i[p] = s_id[j];
        }
        T[p] = test_T;
        n_con[p] = base - start + j + 1;
      }
      all_done = gs_all(done);
    }
  }

  const int plane = H * W;
#pragma unroll
  for (int p = 0; p < GS_PIX; ++p) {
    if (px >= W || py0 + p >= H) continue;
    const int pix = (py0 + p) * W + px;
    out_color[pix] = C[p][0];
    out_color[plane + pix] = C[p][1];
    out_color[2 * plane + pix] = C[p][2];
    out_depth[pix] = D[p];
    out_med_depth[pix] = med_d[p];
    out_med_weight[pix] = med_w[p];
    out_med_id[pix] = med_i[p];
    out_final_T[pix] = T[p];
    out_n_contrib[pix] = n_con[p];
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
    render_tiles_kernel<<<num_tiles, GS_PAIR_THREADS, 0, (cudaStream_t)stream>>>(
        grid_x, W, H, ranges, point_list, means2d, conic, opacity, colors,
        depths, out_color, out_depth, out_med_depth, out_med_weight, out_med_id,
        out_final_T, out_n_contrib);
  return gs_last_error();
}
