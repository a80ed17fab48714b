// K5 render_surfel_tiles: front-to-back compositing of 2DGS surfels, one
// 16x16 tile per block.
//
// Replaces the TPU kernel gaustudio_tpu/ops/rasterize_surfel_pallas.py
// _surfel_kernel (B7). B7 walks 24-row attribute-major entry tables copied
// into 256-aligned blocks (train) or f16 / RGB10 / 10-bit-normal packed
// tables read through a window roll (inference), with entries on sublanes,
// pixels on lanes and a prefix product over the entry axis. None of that
// carries over. Here one block owns one tile, and each of its 128 threads two
// vertically adjacent pixels, as in K3 (composite.cu). The block stages
// batches of the tile's run [start, end) (K2's ranges) in shared memory,
// gathering each entry's homography M (9), depth coefficients Dk (3),
// centre, opacity, colour, view normal and id by Gaussian index, in full
// float32. Every pixel walks the batch in order with the rules of
// gaustudio_tpu/ops/rasterize_surfel.py composite_surfel:
//   (alpha, depth) from gs_surfel_hit (common.cuh); skip where alpha == 0;
//   apply iff T (1 - alpha) >= 1e-4, else the pixel is done;
//   colour, depth sum (= m1), view normal and m2 = sum w depth^2 accumulate
//   w = alpha T; the median depth / weight / id is taken where T crosses
//   0.5 (defaults 0); n_contrib is 1 + the last applied position.
// A thread leaves the walk once both its pixels are done, and the block once
// every thread has (__syncthreads_count). Pixels outside the image start
// done and never write. The background is composited in the loss.
//
// Bound: instruction throughput. Each (entry, pixel) pair costs the intersection
// (about 30 unfused float operations and two IEEE divisions, see
// gs_surfel_hit), an exp and the 13-value blend, about 45 operations; the
// one-pixel-a-thread design added some 21 scalar shared loads a pair (a
// 60-byte entry stride, not 16-byte aligned) and the loop's bookkeeping.
// Here an entry is staged as K6 stages it, six float4 records
// (gs_stage_surfel), read in four 16-byte loads for the hit and two more
// where a pixel applies it; the loads, the loop bookkeeping and the terms
// of px alone (hu = px Mw - Mx, cx - px and its square: gs_surfel_col)
// serve both pixels of a thread. Most pairs miss: gs_surfel_certain_miss
// skips a pair before the two divisions and the exp where both rho bounds
// exceed 2 gs_alpha_cut(opacity), and only where the exact path would cut
// alpha too. The decision arithmetic stays unfused in gs_surfel_hit's
// order, so K6 and the plain version decide alike; only the blend may fuse.
// The staging gathers (88 bytes per entry) are random. 72 registers,
// 12,800 B of shared memory: seven 128-thread blocks an SM, bound by the
// registers (a cap at eight spilled).
#include "common.cuh"

// entries staged at a time: one a thread
#define GS_SURFEL_FWD_BATCH 128

__global__ void __launch_bounds__(GS_PAIR_THREADS) render_surfel_tiles_kernel(
    int grid_x, int W, int H, const int* __restrict__ ranges,
    const int* __restrict__ point_list, const float* __restrict__ M,
    const float* __restrict__ Dk, const float* __restrict__ mean2d,
    const float* __restrict__ opacity, const float* __restrict__ colors,
    const float* __restrict__ normals, float* __restrict__ out_color,
    float* __restrict__ out_depth_sum, float* __restrict__ out_normal,
    float* __restrict__ out_med_depth, float* __restrict__ out_med_weight,
    int* __restrict__ out_med_id, float* __restrict__ out_final_T,
    float* __restrict__ out_m2, int* __restrict__ out_n_contrib) {
  __shared__ int s_id[GS_SURFEL_FWD_BATCH];
  __shared__ float4 s_geo[GS_SURFEL_FWD_BATCH][4];
  __shared__ float4 s_cn[GS_SURFEL_FWD_BATCH][2];

  const int tile = blockIdx.x;
  const int t = threadIdx.x;
  const int px = (tile % grid_x) * GS_TILE + t % GS_TILE;
  const int py0 = (tile / grid_x) * GS_TILE + GS_PIX * (t / GS_TILE);  // rows py0, py0 + 1
  const float pxf = (float)px;

  float pyf[GS_PIX], T[GS_PIX], C[GS_PIX][3], N[GS_PIX][3], D[GS_PIX], M2[GS_PIX];
  float med_d[GS_PIX], med_w[GS_PIX];
  int med_i[GS_PIX], n_con[GS_PIX];
  bool done[GS_PIX];
#pragma unroll
  for (int p = 0; p < GS_PIX; ++p) {
    pyf[p] = (float)(py0 + p);
    done[p] = !(px < W && py0 + p < H);
    T[p] = 1.0f;
#pragma unroll
    for (int c = 0; c < 3; ++c) C[p][c] = N[p][c] = 0.0f;
    D[p] = M2[p] = med_d[p] = med_w[p] = 0.0f;
    med_i[p] = n_con[p] = 0;
  }
  bool all_done = gs_all(done);

  const int start = ranges[2 * tile];
  const int end = ranges[2 * tile + 1];
  for (int base = start; base < end; base += GS_SURFEL_FWD_BATCH) {
    if (__syncthreads_count(all_done) == GS_PAIR_THREADS) break;
    const int batch = min(GS_SURFEL_FWD_BATCH, end - base);
    for (int e = t; e < batch; e += GS_PAIR_THREADS)
      gs_stage_surfel<true>(e, point_list[base + e], M, Dk, mean2d, opacity, colors, normals,
                            s_id, s_geo, s_cn);
    __syncthreads();

    for (int j = 0; !all_done && j < batch; ++j) {
      const float4 q0 = s_geo[j][0], q1 = s_geo[j][1], q2 = s_geo[j][2], q3 = s_geo[j][3];
      const float m[9] = {q0.x, q0.y, q0.z, q0.w, q1.x, q1.y, q1.z, q1.w, q2.x};
      const float dk[3] = {q2.y, q2.z, q2.w};
      const GsSurfelCol col = gs_surfel_col(m, q3.x, pxf);
#pragma unroll
      for (int p = 0; p < GS_PIX; ++p) {
        if (done[p]) continue;
        const GsSurfelCross x = gs_surfel_cross(col, m, q3.y, pyf[p]);
        if (gs_surfel_certain_miss(x, q3.w)) continue;  // alpha < 1/255, exactly
        const GsSurfelHit h = gs_surfel_finish(col, x, dk, q3.z);
        if (!(h.alpha > 0.0f)) continue;
        const float test_T = T[p] * (1.0f - h.alpha);
        if (test_T < 1e-4f) {
          done[p] = true;
          continue;
        }
        const float w = h.alpha * T[p];
        const float4 cn0 = s_cn[j][0], cn1 = s_cn[j][1];  // colour, normal
        C[p][0] += cn0.x * w;
        C[p][1] += cn0.y * w;
        C[p][2] += cn0.z * w;
        N[p][0] += cn0.w * w;
        N[p][1] += cn1.x * w;
        N[p][2] += cn1.y * w;
        D[p] += h.depth * w;
        M2[p] += h.depth * h.depth * w;
        if (T[p] > 0.5f && test_T < 0.5f) {
          med_d[p] = h.depth;
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
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      out_color[c * plane + pix] = C[p][c];
      out_normal[c * plane + pix] = N[p][c];
    }
    out_depth_sum[pix] = D[p];
    out_med_depth[pix] = med_d[p];
    out_med_weight[pix] = med_w[p];
    out_med_id[pix] = med_i[p];
    out_final_T[pix] = T[p];
    out_m2[pix] = M2[p];
    out_n_contrib[pix] = n_con[p];
  }
}

GS_API int gs_render_surfel_tiles(
    int grid_x, int grid_y, int W, int H, const int* ranges, const int* point_list,
    const float* M, const float* Dk, const float* mean2d, const float* opacity,
    const float* colors, const float* normals, float* out_color, float* out_depth_sum,
    float* out_normal, float* out_med_depth, float* out_med_weight, int* out_med_id,
    float* out_final_T, float* out_m2, int* out_n_contrib, void* stream) {
  const int num_tiles = grid_x * grid_y;
  if (num_tiles > 0)
    render_surfel_tiles_kernel<<<num_tiles, GS_PAIR_THREADS, 0, (cudaStream_t)stream>>>(
        grid_x, W, H, ranges, point_list, M, Dk, mean2d, opacity, colors, normals,
        out_color, out_depth_sum, out_normal, out_med_depth, out_med_weight, out_med_id,
        out_final_T, out_m2, out_n_contrib);
  return gs_last_error();
}
