// K6 render_surfel_tiles_backward: the reverse walk of 2DGS surfels, one
// 16x16 tile per block, with the per-Gaussian reduction of the gradients.
//
// Replaces two TPU kernels:
//   B8 gaustudio_tpu/ops/rasterize_surfel_pallas_bwd.py _surfel_bwd_kernel
//      (per-entry gradients [24, K] of a reverse walk over flat entry blocks,
//      read-modify-written block by block in a sequential grid), and
//   B5 gaustudio_tpu/ops/rasterize_pallas_bwd.py _segreduce_kernel, as
//      reduce_surfel_entry_grads uses it (per-Gaussian sums of those rows).
// As in K4 (composite_bwd.cu) one 256-thread block owns one tile and one
// thread one pixel. The block stages the tile's entries in batches of 256
// from the tile's largest n_contrib backwards, gathering by Gaussian index
// as K5 does. A pixel skips positions >= its own n_contrib, re-decides each
// entry with gs_surfel_hit (common.cuh), bit for bit as K5 did, skips alpha
// == 0, rebuilds T by division, T <- T / (1 - alpha), and keeps one suffix
// sum Sq of w * payload over the entries behind it, with B8's payload
//   payload = col . dC + depth dDs + depth^2 dm2 + nrm . dN + dA
// (dDs carries the cotangents of the depth sum and of m1, which are one
// output; dA = -dL/dT_final; no background term). Then, with B8's branch
// masks:
//   dL/dalpha = Tb payload - Sq / (1 - alpha);
//   d_op = G dL/dalpha and drho = -G op dL/dalpha / 2 (no 0.99-clamp gate);
//   ddepth = w dDs + 2 depth w dm2, plus dMed where T crosses 0.5; it flows
//   through (u, v) only on the 3D branch; d_Dk = (u, v, 1) ddepth there;
//   (du, dv) -> ds = (du, dv, -(u du + v dv)) / s2, ds2 = 0 where guarded;
//   the cross-product VJP dhu = hv x ds, dhv = ds x hu gives
//   dMx = -dhu, dMy = -dhv, dMw = px dhu + py dhv;
//   the centre gets drho (c - p) only on the 2D branch.
// Each warp sums its 32 pixels' 21 values per staged entry with
// __shfl_down_sync (only when some lane contributed) and lane 0 atomicAdds
// them into the per-Gaussian rows [N, 21] (M 9, Dk 3, opacity, colour 3,
// normal 3, centre 2), which the wrapper zeroes. Sums land in a varying
// order, so K6 is not bitwise reproducible from run to run.
//
// Bound: compute, as K5, plus the VJP (about 60 more operations per pair),
// 105 shuffles and up to 21 atomics per warp and entry (hot Gaussians
// contend); the per-pixel cotangents are read once. Against that, the walk
// starts at the tile's largest n_contrib rather than its run's end, a warp
// whose lanes all skipped an entry does no shuffles or atomics for it, and
// the atomics land once per warp, not once per pixel.

#include "common.cuh"

#define GS_SURFEL_NGRAD 21

__global__ void __launch_bounds__(GS_BLOCK) render_surfel_tiles_backward_kernel(
    int grid_x, int W, int H, const int* __restrict__ ranges,
    const int* __restrict__ point_list, const float* __restrict__ M,
    const float* __restrict__ Dk, const float* __restrict__ mean2d,
    const float* __restrict__ opacity, const float* __restrict__ colors,
    const float* __restrict__ normals, const float* __restrict__ final_T,
    const int* __restrict__ n_contrib, const float* __restrict__ dL_dcolor,
    const float* __restrict__ dL_ddepth_sum, const float* __restrict__ dL_dm2,
    const float* __restrict__ dL_dnormal, const float* __restrict__ dL_dfinal_T,
    const float* __restrict__ dL_dmedian, float* __restrict__ grads) {
  __shared__ int s_id[GS_BLOCK];
  __shared__ float s_geo[GS_BLOCK][GS_SURFEL_GEO];
  __shared__ float s_rgb[GS_BLOCK][3];
  __shared__ float s_nrm[GS_BLOCK][3];
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
  float T = 1.0f;
  float dC[3] = {0.0f, 0.0f, 0.0f}, dN[3] = {0.0f, 0.0f, 0.0f};
  float dDs = 0.0f, dM2 = 0.0f, dA = 0.0f, dMed = 0.0f;
  if (inside) {
    const int pix = py * W + px;
    const int plane = H * W;
    nc = n_contrib[pix];
    T = final_T[pix];
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      dC[c] = dL_dcolor[c * plane + pix];
      dN[c] = dL_dnormal[c * plane + pix];
    }
    dDs = dL_ddepth_sum[pix];
    dM2 = dL_dm2[pix];
    dA = -dL_dfinal_T[pix];  // alpha = 1 - T_final
    dMed = dL_dmedian[pix];
  }
  if (t == 0) s_last = 0;
  __syncthreads();
  if (nc > 0) atomicMax(&s_last, nc);
  __syncthreads();
  const int start = ranges[2 * tile];
  const int last = s_last;  // the tile's positions [0, last) are walked backwards

  float Sq = 0.0f;  // sum of w * payload over the applied entries behind
  for (int hi = last; hi > 0; hi -= GS_BLOCK) {
    const int batch = min(GS_BLOCK, hi);
    __syncthreads();  // the previous batch has been read by every pixel
    if (t < batch)
      stage_surfel(t, point_list[start + hi - 1 - t], M, Dk, mean2d, opacity, colors, normals,
                   s_geo, s_rgb, s_nrm, s_id);
    __syncthreads();

    for (int j = 0; j < batch; ++j) {
      float v[GS_SURFEL_NGRAD];
#pragma unroll
      for (int i = 0; i < GS_SURFEL_NGRAD; ++i) v[i] = 0.0f;
      bool contrib = false;
      if (hi - 1 - j < nc) {
        const float* e = s_geo[j];
        const GsSurfelHit h = gs_surfel_hit(e, e + 9, e[12], e[13], e[14], pxf, pyf);
        if (h.alpha > 0.0f) {
          contrib = true;
          const float one_m_a = 1.0f - h.alpha;
          const float Tb = T / one_m_a;  // T before this entry
          const float w = h.alpha * Tb;
          const float dep = h.depth;
          const float payload = s_rgb[j][0] * dC[0] + s_rgb[j][1] * dC[1] +
                                s_rgb[j][2] * dC[2] + dep * dDs + dep * dep * dM2 +
                                s_nrm[j][0] * dN[0] + s_nrm[j][1] * dN[1] +
                                s_nrm[j][2] * dN[2] + dA;
          const float dL_dalpha = Tb * payload - Sq / one_m_a;
          const bool cross = Tb > 0.5f && __fmul_rn(Tb, one_m_a) < 0.5f;
          const float op = e[14];
          const float drho = -0.5f * h.G * (op * dL_dalpha);
          const float ddep = w * dDs + 2.0f * dep * w * dM2 + (cross ? dMed : 0.0f);
          const float ddep3 = h.use3d ? ddep : 0.0f;
          const float du = (h.use3d ? 2.0f * h.u * drho : 0.0f) + e[9] * ddep3;
          const float dv = (h.use3d ? 2.0f * h.v * drho : 0.0f) + e[10] * ddep3;
          const float ds0 = du / h.sz;
          const float ds1 = dv / h.sz;
          const float ds2 = h.guarded ? 0.0f : -(h.u * du + h.v * dv) / h.sz;
          const float dhu[3] = {h.hv[1] * ds2 - h.hv[2] * ds1, h.hv[2] * ds0 - h.hv[0] * ds2,
                                h.hv[0] * ds1 - h.hv[1] * ds0};
          const float dhv[3] = {ds1 * h.hu[2] - ds2 * h.hu[1], ds2 * h.hu[0] - ds0 * h.hu[2],
                                ds0 * h.hu[1] - ds1 * h.hu[0]};
#pragma unroll
          for (int k = 0; k < 3; ++k) {
            v[k] = -dhu[k];
            v[3 + k] = -dhv[k];
            v[6 + k] = pxf * dhu[k] + pyf * dhv[k];
          }
          v[9] = h.u * ddep3;
          v[10] = h.v * ddep3;
          v[11] = ddep;
          v[12] = h.G * dL_dalpha;
#pragma unroll
          for (int c = 0; c < 3; ++c) {
            v[13 + c] = w * dC[c];
            v[16 + c] = w * dN[c];
          }
          const float drho2 = h.use3d ? 0.0f : drho;
          v[19] = drho2 * h.dx;  // d rho2d / dc = 2 (c - p) / 2
          v[20] = drho2 * h.dy;
          Sq += w * payload;
          T = Tb;
        }
      }
      if (__any_sync(0xffffffffu, contrib)) {
#pragma unroll
        for (int off = 16; off > 0; off >>= 1) {
#pragma unroll
          for (int i = 0; i < GS_SURFEL_NGRAD; ++i)
            v[i] += __shfl_down_sync(0xffffffffu, v[i], off);
        }
        if (lane == 0) {
          float* row = grads + (size_t)GS_SURFEL_NGRAD * s_id[j];
#pragma unroll
          for (int i = 0; i < GS_SURFEL_NGRAD; ++i) atomicAdd(&row[i], v[i]);
        }
      }
    }
  }
}

GS_API int gs_render_surfel_tiles_backward(
    int grid_x, int grid_y, int W, int H, const int* ranges, const int* point_list,
    const float* M, const float* Dk, const float* mean2d, const float* opacity,
    const float* colors, const float* normals, const float* final_T, const int* n_contrib,
    const float* dL_dcolor, const float* dL_ddepth_sum, const float* dL_dm2,
    const float* dL_dnormal, const float* dL_dfinal_T, const float* dL_dmedian,
    float* grads, void* stream) {
  const int num_tiles = grid_x * grid_y;
  if (num_tiles > 0)
    render_surfel_tiles_backward_kernel<<<num_tiles, GS_BLOCK, 0, (cudaStream_t)stream>>>(
        grid_x, W, H, ranges, point_list, M, Dk, mean2d, opacity, colors, normals, final_T,
        n_contrib, dL_dcolor, dL_ddepth_sum, dL_dm2, dL_dnormal, dL_dfinal_T, dL_dmedian,
        grads);
  return gs_last_error();
}
