// K5 render_surfel_tiles: front-to-back compositing of 2DGS surfels, one
// 16x16 tile per block.
//
// Replaces the TPU kernel gaustudio_tpu/ops/rasterize_surfel_pallas.py
// _surfel_kernel (B7). B7 walks 24-row attribute-major entry tables copied
// into 256-aligned blocks (train) or f16 / RGB10 / 10-bit-normal packed
// tables read through a window roll (inference), with entries on sublanes,
// pixels on lanes and a prefix product over the entry axis. None of that
// carries over. Here one 256-thread block owns one tile and one thread one
// pixel, as in K3 (composite.cu). The block stages batches of 256 entries of
// the tile's run [start, end) (K2's ranges) in shared memory, gathering each
// entry's homography M (9), depth coefficients Dk (3), centre, opacity,
// colour, view normal and id by Gaussian index, in full float32. Every pixel
// walks the batch in order with the rules of gaustudio_tpu/ops/
// rasterize_surfel.py composite_surfel:
//   (alpha, depth) from gs_surfel_hit (common.cuh); skip where alpha == 0;
//   apply iff T (1 - alpha) >= 1e-4, else the pixel is done;
//   colour, depth sum (= m1), view normal and m2 = sum w depth^2 accumulate
//   w = alpha T; the median depth / weight / id is taken where T crosses
//   0.5 (defaults 0); n_contrib is 1 + the last applied position.
// The block leaves once every pixel is done (__syncthreads_count). Pixels
// outside the image start done. The background is composited in the loss.
//
// Bound: compute. Each (entry, pixel) pair costs the intersection (about 30
// unfused float operations and two divisions, see gs_surfel_hit), an exp and
// the 13-value blend, about 45 operations; the staging gathers (88 bytes per
// entry) are random. Against that, each entry is gathered once per block and
// read from shared memory by all 256 pixels, and the block stops as soon as
// every pixel is done. The decision arithmetic stays unfused so that K6 and
// the plain version decide alike; only the blend may fuse.

#include "common.cuh"

__global__ void __launch_bounds__(GS_BLOCK) render_surfel_tiles_kernel(
    int grid_x, int W, int H, const int* __restrict__ ranges,
    const int* __restrict__ point_list, const float* __restrict__ M,
    const float* __restrict__ Dk, const float* __restrict__ mean2d,
    const float* __restrict__ opacity, const float* __restrict__ colors,
    const float* __restrict__ normals, float* __restrict__ out_color,
    float* __restrict__ out_depth_sum, float* __restrict__ out_normal,
    float* __restrict__ out_med_depth, float* __restrict__ out_med_weight,
    int* __restrict__ out_med_id, float* __restrict__ out_final_T,
    float* __restrict__ out_m2, int* __restrict__ out_n_contrib) {
  __shared__ int s_id[GS_BLOCK];
  __shared__ float s_geo[GS_BLOCK][GS_SURFEL_GEO];
  __shared__ float s_rgb[GS_BLOCK][3];
  __shared__ float s_nrm[GS_BLOCK][3];

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
  float N[3] = {0.0f, 0.0f, 0.0f};
  float D = 0.0f, M2 = 0.0f;
  float med_d = 0.0f, med_w = 0.0f;
  int med_i = 0;
  int contributor = 0, last_contributor = 0;

  for (int r = 0; r < rounds; ++r, todo -= GS_BLOCK) {
    if (__syncthreads_count(done) == GS_BLOCK) break;
    const int k = start + r * GS_BLOCK + t;
    if (k < end)
      stage_surfel(t, point_list[k], M, Dk, mean2d, opacity, colors, normals, s_geo, s_rgb,
                   s_nrm, s_id);
    __syncthreads();

    const int batch = min(GS_BLOCK, todo);
    for (int j = 0; !done && j < batch; ++j) {
      ++contributor;
      const float* e = s_geo[j];
      const GsSurfelHit h = gs_surfel_hit(e, e + 9, e[12], e[13], e[14], pxf, pyf);
      if (!(h.alpha > 0.0f)) continue;
      const float test_T = T * (1.0f - h.alpha);
      if (test_T < 1e-4f) {
        done = true;
        continue;
      }
      const float w = h.alpha * T;
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        C[c] += s_rgb[j][c] * w;
        N[c] += s_nrm[j][c] * w;
      }
      D += h.depth * w;
      M2 += h.depth * h.depth * w;
      if (T > 0.5f && test_T < 0.5f) {
        med_d = h.depth;
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
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      out_color[c * plane + pix] = C[c];
      out_normal[c * plane + pix] = N[c];
    }
    out_depth_sum[pix] = D;
    out_med_depth[pix] = med_d;
    out_med_weight[pix] = med_w;
    out_med_id[pix] = med_i;
    out_final_T[pix] = T;
    out_m2[pix] = M2;
    out_n_contrib[pix] = last_contributor;
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
    render_surfel_tiles_kernel<<<num_tiles, GS_BLOCK, 0, (cudaStream_t)stream>>>(
        grid_x, W, H, ranges, point_list, M, Dk, mean2d, opacity, colors, normals,
        out_color, out_depth_sum, out_normal, out_med_depth, out_med_weight, out_med_id,
        out_final_T, out_m2, out_n_contrib);
  return gs_last_error();
}
