// K6 render_surfel_tiles_backward: the reverse walk of 2DGS surfels, one
// 16x16 tile per block, with the per-Gaussian reduction of the gradients.
//
// Replaces two TPU kernels:
//   B8 gaustudio_tpu/ops/rasterize_surfel_pallas_bwd.py _surfel_bwd_kernel
//      (per-entry gradients [24, K] of a reverse walk over flat entry blocks,
//      read-modify-written block by block in a sequential grid), and
//   B5 gaustudio_tpu/ops/rasterize_pallas_bwd.py _segreduce_kernel, as
//      reduce_surfel_entry_grads uses it (per-Gaussian sums of those rows).
// As in K4 (composite_bwd.cu) one block owns one 16x16 tile; its 128
// threads walk two vertically adjacent pixels each. The block stages the
// tile's entries in batches of 128 from the tile's largest n_contrib
// backwards, gathering by Gaussian index as K5 does. A warp (4 rows of the
// tile) skips the positions at or above the largest n_contrib of its 64
// pixels, and a pixel those >= its own. A pixel re-decides each entry with
// gs_surfel_hit (common.cuh), bit for bit as K5 did, skips alpha == 0,
// rebuilds T by division, T <- T / (1 - alpha), and keeps one suffix sum Sq
// of w * payload over the entries behind it, with B8's payload
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
// A thread adds its two pixels' 21 values; for a staged entry that some
// pixel of the warp applied, the warp sums them with one reduce-scatter (23
// __shfl_xor_sync, common.cuh), 21 lanes add the sums into the tile's shared
// row of the entry at once, and after the batch the block adds each touched
// row into the Gaussian's row of the [N, 21] output (M 9, Dk 3, opacity,
// colour 3, normal 3, centre 2), which the wrapper zeroes. Sums land in a
// varying order, so K6 is not bitwise reproducible from run to run.
//
// Bound: operations, as K5, plus the VJP (about 60 more operations per
// pair); the per-pixel cotangents are read once. A shuffle tree per value
// and pixel would spend 105 shuffles per 32 pixels and entry, and atomics
// from each warp to device memory 21 serial ones from lane 0 and up to
// 8 x 21 per entry and tile, piled onto hot Gaussians. Here one
// reduce-scatter (23 shuffles) and one parallel shared atomic serve 64
// pixels, and the tile spends 21 global atomics per entry. An entry is read
// from shared memory in six 16-byte loads (the staging keeps its 21 floats
// in float4s). The quotients that feed only gradients (Sq / (1 - alpha) and
// 1 / s2) are fast approximate divisions. Registers bound occupancy: 105 a
// thread, no spills, four 128-thread blocks an SM; the staging and s_grad
// take 24,068 B of shared memory a block.

#include "common.cuh"

#define GS_SURFEL_NGRAD 21
// the reduce-scatter's 32 slots and the 21 of them that hold values (23 shuffles)
#define GS_SURFEL_LIVE 0x17773777u
// entries staged at a time
#define GS_SURFEL_BATCH 128

__global__ void __launch_bounds__(GS_BWD_THREADS) render_surfel_tiles_backward_kernel(
    int grid_x, int W, int H, const int* __restrict__ ranges,
    const int* __restrict__ point_list, const float* __restrict__ M,
    const float* __restrict__ Dk, const float* __restrict__ mean2d,
    const float* __restrict__ opacity, const float* __restrict__ colors,
    const float* __restrict__ normals, const float* __restrict__ final_T,
    const int* __restrict__ n_contrib, const float* __restrict__ dL_dcolor,
    const float* __restrict__ dL_ddepth_sum, const float* __restrict__ dL_dm2,
    const float* __restrict__ dL_dnormal, const float* __restrict__ dL_dfinal_T,
    const float* __restrict__ dL_dmedian, float* __restrict__ grads) {
  // an entry's geometry in four float4 (M 9, Dk 3, centre 2, opacity) and its
  // colour and normal in two, so that a warp reads it in six 16-byte loads
  __shared__ int s_id[GS_SURFEL_BATCH];
  __shared__ float4 s_geo[GS_SURFEL_BATCH][4];
  __shared__ float4 s_cn[GS_SURFEL_BATCH][2];
  __shared__ float s_grad[GS_SURFEL_BATCH][GS_SURFEL_NGRAD];
  __shared__ int s_touched[GS_SURFEL_BATCH];
  __shared__ int s_last;

  const int tile = blockIdx.x;
  const int t = threadIdx.x;
  const int lane = t & 31;
  const int px = (tile % grid_x) * GS_TILE + t % GS_TILE;
  const int py0 = (tile / grid_x) * GS_TILE + GS_BWD_PIX * (t / GS_TILE);  // rows py0, py0 + 1
  const float pxf = (float)px;

  // per pixel; pixels outside the image keep nc = 0 and never contribute
  int nc[GS_BWD_PIX];
  float pyf[GS_BWD_PIX], T[GS_BWD_PIX], Sq[GS_BWD_PIX], dC[GS_BWD_PIX][3], dN[GS_BWD_PIX][3];
  float dDs[GS_BWD_PIX], dM2[GS_BWD_PIX], dA[GS_BWD_PIX], dMed[GS_BWD_PIX];
  int nc_max = 0;
#pragma unroll
  for (int p = 0; p < GS_BWD_PIX; ++p) {
    const int py = py0 + p;
    pyf[p] = (float)py;
    nc[p] = 0;
    T[p] = 1.0f;
    Sq[p] = 0.0f;  // sum of w * payload over the applied entries behind
    dDs[p] = dM2[p] = dA[p] = dMed[p] = 0.0f;
#pragma unroll
    for (int c = 0; c < 3; ++c) dC[p][c] = dN[p][c] = 0.0f;
    if (px < W && py < H) {
      const int pix = py * W + px;
      const int plane = H * W;
      nc[p] = n_contrib[pix];
      T[p] = final_T[pix];
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        dC[p][c] = dL_dcolor[c * plane + pix];
        dN[p][c] = dL_dnormal[c * plane + pix];
      }
      dDs[p] = dL_ddepth_sum[pix];
      dM2[p] = dL_dm2[pix];
      dA[p] = -dL_dfinal_T[pix];  // alpha = 1 - T_final
      dMed[p] = dL_dmedian[pix];
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
  const int k_sum = gs_reduce_scatter_value<32, GS_SURFEL_LIVE>(lane);  // the sum this lane adds

  for (int hi = last; hi > 0; hi -= GS_SURFEL_BATCH) {
    const int batch = min(GS_SURFEL_BATCH, hi);
    __syncthreads();  // the previous batch has been read and flushed
    for (int e = t; e < batch; e += GS_BWD_THREADS) {
      const int g = point_list[start + hi - 1 - e];
      const float* m = M + 9 * g;
      s_id[e] = g;
      s_geo[e][0] = make_float4(m[0], m[1], m[2], m[3]);
      s_geo[e][1] = make_float4(m[4], m[5], m[6], m[7]);
      s_geo[e][2] = make_float4(m[8], Dk[3 * g], Dk[3 * g + 1], Dk[3 * g + 2]);
      s_geo[e][3] = make_float4(mean2d[2 * g], mean2d[2 * g + 1], opacity[g], 0.0f);
      s_cn[e][0] = make_float4(colors[3 * g], colors[3 * g + 1], colors[3 * g + 2], normals[3 * g]);
      s_cn[e][1] = make_float4(normals[3 * g + 1], normals[3 * g + 2], 0.0f, 0.0f);
#pragma unroll
      for (int k = 0; k < GS_SURFEL_NGRAD; ++k) s_grad[e][k] = 0.0f;
      s_touched[e] = 0;
    }
    __syncthreads();

    // staged entry j sits at position hi - 1 - j; the warp starts at its own last
    for (int j = max(0, hi - warp_last); j < batch; ++j) {
      const int pos = hi - 1 - j;
      const float4 q0 = s_geo[j][0], q1 = s_geo[j][1], q2 = s_geo[j][2], q3 = s_geo[j][3];
      const float m[9] = {q0.x, q0.y, q0.z, q0.w, q1.x, q1.y, q1.z, q1.w, q2.x};
      const float dk[3] = {q2.y, q2.z, q2.w};
      const float op = q3.z;
      float v[GS_SURFEL_NGRAD];  // the sums over this thread's pixels
#pragma unroll
      for (int i = 0; i < GS_SURFEL_NGRAD; ++i) v[i] = 0.0f;
      bool contrib = false;
#pragma unroll
      for (int p = 0; p < GS_BWD_PIX; ++p) {
        if (pos >= nc[p]) continue;
        const GsSurfelHit h = gs_surfel_hit(m, dk, q3.x, q3.y, op, pxf, pyf[p]);
        if (h.alpha <= 0.0f) continue;
        contrib = true;
        const float one_m_a = 1.0f - h.alpha;
        const float Tb = T[p] / one_m_a;  // T before this entry
        const float w = h.alpha * Tb;
        const float dep = h.depth;
        const float4 cn0 = s_cn[j][0], cn1 = s_cn[j][1];  // colour, normal
        const float payload = cn0.x * dC[p][0] + cn0.y * dC[p][1] + cn0.z * dC[p][2] +
                              dep * dDs[p] + dep * dep * dM2[p] + cn0.w * dN[p][0] +
                              cn1.x * dN[p][1] + cn1.y * dN[p][2] + dA[p];
        // the two quotients below feed only gradients
        const float dL_dalpha = Tb * payload - Sq[p] * __fdividef(1.0f, one_m_a);
        const bool cross = Tb > 0.5f && __fmul_rn(Tb, one_m_a) < 0.5f;
        const float drho = -0.5f * h.G * (op * dL_dalpha);
        const float ddep = w * dDs[p] + 2.0f * dep * w * dM2[p] + (cross ? dMed[p] : 0.0f);
        const float ddep3 = h.use3d ? ddep : 0.0f;
        const float du = (h.use3d ? 2.0f * h.u * drho : 0.0f) + dk[0] * ddep3;
        const float dv = (h.use3d ? 2.0f * h.v * drho : 0.0f) + dk[1] * ddep3;
        const float inv_sz = __fdividef(1.0f, h.sz);
        const float ds0 = du * inv_sz;
        const float ds1 = dv * inv_sz;
        const float ds2 = h.guarded ? 0.0f : -(h.u * du + h.v * dv) * inv_sz;
        const float dhu[3] = {h.hv[1] * ds2 - h.hv[2] * ds1, h.hv[2] * ds0 - h.hv[0] * ds2,
                              h.hv[0] * ds1 - h.hv[1] * ds0};
        const float dhv[3] = {ds1 * h.hu[2] - ds2 * h.hu[1], ds2 * h.hu[0] - ds0 * h.hu[2],
                              ds0 * h.hu[1] - ds1 * h.hu[0]};
#pragma unroll
        for (int k = 0; k < 3; ++k) {
          v[k] -= dhu[k];
          v[3 + k] -= dhv[k];
          v[6 + k] += pxf * dhu[k] + pyf[p] * dhv[k];
        }
        v[9] += h.u * ddep3;
        v[10] += h.v * ddep3;
        v[11] += ddep;
        v[12] += h.G * dL_dalpha;
#pragma unroll
        for (int c = 0; c < 3; ++c) {
          v[13 + c] += w * dC[p][c];
          v[16 + c] += w * dN[p][c];
        }
        const float drho2 = h.use3d ? 0.0f : drho;
        v[19] += drho2 * h.dx;  // d rho2d / dc = 2 (c - p) / 2
        v[20] += drho2 * h.dy;
        Sq[p] += w * payload;
        T[p] = Tb;
      }
      if (__any_sync(0xffffffffu, contrib)) {
        const float sum = gs_warp_reduce_scatter<32, GS_SURFEL_LIVE>(v, lane);
        if (k_sum >= 0) atomicAdd(&s_grad[j][k_sum], sum);
        if (lane == 0) s_touched[j] = 1;
      }
    }
    __syncthreads();
    gs_flush_rows<GS_SURFEL_NGRAD, GS_BWD_THREADS>(batch, s_id, s_touched, s_grad, grads);
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
    render_surfel_tiles_backward_kernel<<<num_tiles, GS_BWD_THREADS, 0, (cudaStream_t)stream>>>(
        grid_x, W, H, ranges, point_list, M, Dk, mean2d, opacity, colors, normals, final_T,
        n_contrib, dL_dcolor, dL_ddepth_sum, dL_dm2, dL_dnormal, dL_dfinal_T, dL_dmedian,
        grads);
  return gs_last_error();
}
