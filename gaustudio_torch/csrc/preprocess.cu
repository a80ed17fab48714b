// K7 preprocess_forward: the rasterizer's per-Gaussian preprocess in one
// pass, for renders that want no gradient.
//
// It replaces no Pallas kernel: the JAX package leaves its preprocess
// (gaustudio_tpu/ops/gaussian.py preprocess and ops/sh.py) to XLA's fusion.
// The port ran the same arithmetic as ~150 torch ops (ops/gaussian.py
// preprocess, ops/sh.py sh_to_rgb_clamped), which stay its plain version and
// the path of every render under autograd. At 3M Gaussians and 1237x822 on
// one H100 those ops took 17.0 ms of a 20.1 ms frame (PERF.md): the
// torch.stacks of the covariance, the transforms, the 2D covariance, the
// rects and the SH basis, the SH einsum's gemv and a hundred elementwise
// kernels, each a round trip of [N] floats through device memory, ~1.6% of
// the card's memory rate.
//
// Bound: bytes. A Gaussian reads its mean 12 B, scale 12, rotation 16,
// opacity 4 and SH 192 (16 x 3 float32 at degree 3), 236 B, and writes the
// Preprocessed record (depth 4, mean 8, conic 12, opacity 4, colour 12,
// radius 4, rects 16, tiles 4, valid 1), 65 B: 301 B, 0.27 ms at 3M on
// 3.35 TB/s. Its ~300 operations take under 0.02 ms at 67 TFLOP/s.
//
// Design: one thread per Gaussian, every intermediate in registers, so each
// of those bytes moves once; neighbouring threads read and write
// neighbouring rows. The SH rows are most of the bytes, and only their bands
// up to the active degree (capped at 3, as the plain version's max_deg) are
// read. Where a row's stride allows 16-byte loads (K = 4 or 16
// coefficients), a warp stages its 32 rows through shared memory: it reads
// them as one span (6 KB at degree 3) in 16-byte loads, neighbouring lanes
// on neighbouring addresses, into rows padded to an odd number of float4, so
// that each thread then reads its own row without bank conflicts. On one
// H100 that took 0.301 ms at 3M Gaussians, where each thread's own twelve
// 16-byte loads, 192 bytes apart across the warp, took 0.355-0.361 ms
// (PERF.md). Other strides are read a float at a time. The camera's
// matrices, centre and intrinsics are read from their device tensors into
// shared memory once a block, so the launch adds no host wait. Scalars that
// the plain version takes from the host (the focal lengths and the fov
// clamp of the projection-matrix path) come in as float arguments, rounded
// from the caller's double as torch rounds a Python scalar.
//
// Exact decisions: the arithmetic that decides an integer output (the 3D
// and 2D covariances, det, the eigenvalues, the radius, the support radius,
// the bbox and the tile rects) is written unfused (__fmul_rn, __fadd_rn,
// __fdiv_rn, __fsqrt_rn; logf, ceilf and floorf as ATen calls them) op for
// op in the plain version's order, with torch's NaN rules for clamp,
// maximum and minimum. So valid, radii, rect_min, rect_max and
// tiles_touched equal the plain version's bit for bit on the card, and so
// do depth, mean, conic and opacity. The colour's basis is unfused too; its
// sum over the coefficients may fuse and runs in another order than the
// einsum's, so the colour differs from the plain version's by rounding.
#include "common.cuh"

namespace {

// 4 warps a block: 26.6 KB of staged SH rows at degree 3
constexpr int kThreads = 128;

__device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ float sub(float a, float b) { return __fsub_rn(a, b); }
__device__ __forceinline__ float dvd(float a, float b) { return __fdiv_rn(a, b); }

// torch's clamp_min, clamp_max and clamp keep a NaN; maximum and minimum
// return NaN where either operand is one
__device__ __forceinline__ float clamp_min(float v, float lo) { return v != v ? v : fmaxf(v, lo); }
__device__ __forceinline__ float clamp_max(float v, float hi) { return v != v ? v : fminf(v, hi); }
__device__ __forceinline__ float clamp(float v, float lo, float hi) {
  return v != v ? v : fminf(fmaxf(v, lo), hi);
}
__device__ __forceinline__ float maximum(float a, float b) {
  return (a != a || b != b) ? a + b : fmaxf(a, b);
}
__device__ __forceinline__ float minimum(float a, float b) {
  return (a != a || b != b) ? a + b : fminf(a, b);
}

// gaussian._signed_clamp: |v| >= floor with v's sign
__device__ __forceinline__ float signed_clamp(float v, float floor) {
  return v >= 0.0f ? clamp_min(v, floor) : clamp_max(v, -floor);
}

// gaussian._tile_index: clamp(floor(v / 16), 0, grid) cast to int32 (a NaN
// casts to 0, as ATen's cast does on the card)
__device__ __forceinline__ int tile_index(float v, int grid) {
  return __float2int_rz(clamp(floorf(mul(v, 1.0f / GS_TILE)), 0.0f, (float)grid));
}

// gaussian.transform_points, component i of (x, y, z, 1) @ m, m row-major
__device__ __forceinline__ float transform(const float* m, float x, float y, float z, int i) {
  return add(add(add(mul(x, m[i]), mul(y, m[4 + i])), mul(z, m[8 + i])), m[12 + i]);
}

// gaussian.build_cov3d: R S^2 R^T as (xx, xy, xz, yy, yz, zz), the
// quaternion (w, x, y, z) not normalised
__device__ __forceinline__ void build_cov3d(float sx, float sy, float sz, float sm, float r,
                                            float x, float y, float z, float (&c)[6]) {
  const float R00 = sub(1.0f, mul(2.0f, add(mul(y, y), mul(z, z))));
  const float R01 = mul(2.0f, sub(mul(x, y), mul(r, z)));
  const float R02 = mul(2.0f, add(mul(x, z), mul(r, y)));
  const float R10 = mul(2.0f, add(mul(x, y), mul(r, z)));
  const float R11 = sub(1.0f, mul(2.0f, add(mul(x, x), mul(z, z))));
  const float R12 = mul(2.0f, sub(mul(y, z), mul(r, x)));
  const float R20 = mul(2.0f, sub(mul(x, z), mul(r, y)));
  const float R21 = mul(2.0f, add(mul(y, z), mul(r, x)));
  const float R22 = sub(1.0f, mul(2.0f, add(mul(x, x), mul(y, y))));
  const float a = mul(sm, sx), b = mul(sm, sy), d = mul(sm, sz);
  const float s0 = mul(a, a), s1 = mul(b, b), s2 = mul(d, d);
  auto term = [&](float p0, float q0, float p1, float q1, float p2, float q2) {
    return add(add(mul(mul(p0, q0), s0), mul(mul(p1, q1), s1)), mul(mul(p2, q2), s2));
  };
  c[0] = term(R00, R00, R01, R01, R02, R02);
  c[1] = term(R00, R10, R01, R11, R02, R12);
  c[2] = term(R00, R20, R01, R21, R02, R22);
  c[3] = term(R10, R10, R11, R11, R12, R12);
  c[4] = term(R10, R20, R11, R21, R12, R22);
  c[5] = term(R20, R20, R21, R21, R22, R22);
}

// sh.sh_basis of a unit direction, its first COEFFS values (1, 4, 9 or 16),
// with ops/sh.py's constants rounded to float as torch rounds a Python scalar
template <int COEFFS>
__device__ __forceinline__ void sh_basis(float x, float y, float z, float (&b)[COEFFS]) {
  b[0] = 0.28209479177387814f;
  if constexpr (COEFFS > 1) {
    constexpr float C1 = 0.4886025119029199f;
    b[1] = mul(-C1, y);
    b[2] = mul(C1, z);
    b[3] = mul(-C1, x);
  }
  if constexpr (COEFFS > 4) {
    const float xx = mul(x, x), yy = mul(y, y), zz = mul(z, z);
    const float xy = mul(x, y), yz = mul(y, z), xz = mul(x, z);
    b[4] = mul(1.0925484305920792f, xy);
    b[5] = mul(-1.0925484305920792f, yz);
    b[6] = mul(0.31539156525252005f, sub(sub(mul(2.0f, zz), xx), yy));
    b[7] = mul(-1.0925484305920792f, xz);
    b[8] = mul(0.5462742152960396f, sub(xx, yy));
    if constexpr (COEFFS > 9) {
      b[9] = mul(mul(-0.5900435899266435f, y), sub(mul(3.0f, xx), yy));
      b[10] = mul(mul(2.890611442640554f, xy), z);
      b[11] = mul(mul(-0.4570457994644658f, y), sub(sub(mul(4.0f, zz), xx), yy));
      b[12] = mul(mul(0.3731763325901154f, z),
                  sub(sub(mul(2.0f, zz), mul(3.0f, xx)), mul(3.0f, yy)));
      b[13] = mul(mul(-0.4570457994644658f, x), sub(sub(mul(4.0f, zz), xx), yy));
      b[14] = mul(mul(1.445305721320277f, z), sub(xx, yy));
      b[15] = mul(mul(-0.5900435899266435f, x), sub(xx, mul(3.0f, yy)));
    }
  }
}

struct PreArgs {
  int n, W, H, grid_x, grid_y, sh_stride, antialias;
  float scale_modifier, focal_x, focal_y, lim_x, lim_y;
  const float *means3d, *opacities, *scales, *rotations, *cov3d, *shs, *colors_precomp;
  const float *viewmatrix, *projmatrix, *campos, *intrinsics, *offset;
  bool* valid;
  float *depths, *means2d, *conic, *opacity, *colors;
  int *radii, *rect_min, *rect_max, *tiles;
};

// COEFFS: the SH coefficients read, 0-16 (sh.sh_to_rgb_clamped over the
// bands up to the active degree), or -1 for colors_precomp. VEC: the SH rows
// lie on 16-byte boundaries and hold a multiple of 4 floats, so the first
// kVec = ceil(3 COEFFS / 4) float4 of a row are staged whole.
template <int COEFFS, bool VEC>
__global__ void __launch_bounds__(kThreads) preprocess_forward_kernel(const PreArgs a) {
  constexpr int kVec = COEFFS > 0 ? (3 * COEFFS + 3) / 4 : 1;
  constexpr int kRow = kVec | 1;  // a staged row's float4, odd: no bank conflicts
  constexpr bool kStaged = VEC && COEFFS > 0;
  __shared__ float s_cam[39];  // viewmatrix, projmatrix, campos, intrinsics
  __shared__ float4 s_sh[kStaged ? kThreads * kRow : 1];
  const int t = threadIdx.x;
  if (t < 16) {
    s_cam[t] = __ldg(a.viewmatrix + t);
  } else if (t < 32) {
    if (a.projmatrix) s_cam[t] = __ldg(a.projmatrix + t - 16);
  } else if (t < 35) {
    if (a.campos) s_cam[t] = __ldg(a.campos + t - 32);
  } else if (t < 39) {
    if (a.intrinsics) s_cam[t] = __ldg(a.intrinsics + t - 35);
  }
  __syncthreads();
  const int g = blockIdx.x * kThreads + t;
  if constexpr (kStaged) {  // the warp's SH rows, read as one span
    const int lane = t & 31;
    const int first = g - lane;
    const int rows = min(32, a.n - first);
    float4* s = s_sh + (t - lane) * kRow;
    const float4* src = reinterpret_cast<const float4*>(a.shs);
    const int stride4 = a.sh_stride / 4;
    for (int q = lane; q < rows * kVec; q += 32) {
      const int r = q / kVec, c = q - r * kVec;
      s[r * kRow + c] = __ldg(src + (size_t)(first + r) * stride4 + c);
    }
    __syncwarp();
  }
  if (g >= a.n) return;
  const float* V = s_cam;
  const float* P = s_cam + 16;
  const size_t g2 = 2 * (size_t)g, g3 = 3 * (size_t)g;

  const float x = __ldg(a.means3d + g3), y = __ldg(a.means3d + g3 + 1),
              z = __ldg(a.means3d + g3 + 2);
  const float vx = transform(V, x, y, z, 0);
  const float vy = transform(V, x, y, z, 1);
  const float vz = transform(V, x, y, z, 2);
  const bool in_front = vz > 0.2f;

  float c[6];
  if (a.cov3d) {
#pragma unroll
    for (int k = 0; k < 6; ++k) c[k] = __ldg(a.cov3d + 6 * (size_t)g + k);
  } else {
    const float* q = a.rotations + 4 * (size_t)g;
    build_cov3d(__ldg(a.scales + g3), __ldg(a.scales + g3 + 1), __ldg(a.scales + g3 + 2),
                a.scale_modifier, __ldg(q), __ldg(q + 1), __ldg(q + 2), __ldg(q + 3), c);
  }

  // the pixel mean, and the focal lengths and fov clamp of the EWA projection
  float focal_x = a.focal_x, focal_y = a.focal_y, lim_x = a.lim_x, lim_y = a.lim_y, mx, my;
  if (a.intrinsics) {
    const float fx = s_cam[35], fy = s_cam[36], cx = s_cam[37], cy = s_cam[38];
    focal_x = fx;
    focal_y = fy;
    // 1.3 * tan_fov, tan_fov = 0.5 size / focal as reciprocal(focal) * (0.5 size)
    lim_x = mul(mul(dvd(1.0f, fx), 0.5f * (float)a.W), 1.3f);
    lim_y = mul(mul(dvd(1.0f, fy), 0.5f * (float)a.H), 1.3f);
    const float tz = signed_clamp(vz, 0.2f);
    mx = sub(add(dvd(mul(fx, vx), tz), cx), 0.5f);
    my = sub(add(dvd(mul(fy, vy), tz), cy), 0.5f);
  } else {
    const float pw = dvd(1.0f, signed_clamp(add(transform(P, x, y, z, 3), 1e-7f), 1e-4f));
    mx = mul(sub(mul(add(mul(transform(P, x, y, z, 0), pw), 1.0f), (float)a.W), 1.0f), 0.5f);
    my = mul(sub(mul(add(mul(transform(P, x, y, z, 1), pw), 1.0f), (float)a.H), 1.0f), 0.5f);
  }

  // gaussian.compute_cov2d: J W Sigma W^T J^T + 0.3 I
  const float tz = signed_clamp(vz, 0.2f);
  const float tx = mul(clamp(dvd(vx, tz), -lim_x, lim_x), tz);
  const float ty = mul(clamp(dvd(vy, tz), -lim_y, lim_y), tz);
  const float inv_tz = dvd(1.0f, tz);
  const float inv_tz2 = mul(inv_tz, inv_tz);
  const float j00 = mul(focal_x, inv_tz);
  const float j02 = mul(mul(-focal_x, tx), inv_tz2);
  const float j11 = mul(focal_y, inv_tz);
  const float j12 = mul(mul(-focal_y, ty), inv_tz2);
  // rows of the world -> view rotation: columns of the viewmatrix
  const float r[3][3] = {{V[0], V[4], V[8]}, {V[1], V[5], V[9]}, {V[2], V[6], V[10]}};
  float s[3][3];
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    s[i][0] = add(add(mul(c[0], r[i][0]), mul(c[1], r[i][1])), mul(c[2], r[i][2]));
    s[i][1] = add(add(mul(c[1], r[i][0]), mul(c[3], r[i][1])), mul(c[4], r[i][2]));
    s[i][2] = add(add(mul(c[2], r[i][0]), mul(c[4], r[i][1])), mul(c[5], r[i][2]));
  }
  auto dotr = [&](int i, int j) {
    return add(add(mul(s[i][0], r[j][0]), mul(s[i][1], r[j][1])), mul(s[i][2], r[j][2]));
  };
  const float V00 = dotr(0, 0), V01 = dotr(0, 1), V02 = dotr(0, 2);
  const float V11 = dotr(1, 1), V12 = dotr(1, 2), V22 = dotr(2, 2);
  const float cxx = add(add(mul(j00, add(mul(V00, j00), mul(V02, j02))),
                            mul(j02, add(mul(V02, j00), mul(V22, j02)))), 0.3f);
  const float cxy = add(mul(j00, add(mul(V01, j11), mul(V02, j12))),
                        mul(j02, add(mul(V12, j11), mul(V22, j12))));
  const float cyy = add(add(mul(j11, add(mul(V11, j11), mul(V12, j12))),
                            mul(j12, add(mul(V12, j11), mul(V22, j12)))), 0.3f);

  const float det = sub(mul(cxx, cyy), mul(cxy, cxy));
  const bool det_ok = det > 0.0f;
  const float det_inv = det_ok ? dvd(1.0f, det) : 0.0f;
  if (a.offset) {
    mx = add(mx, __ldg(a.offset + g2));
    my = add(my, __ldg(a.offset + g2 + 1));
  }
  const float mid = mul(0.5f, add(cxx, cyy));
  const float disc = __fsqrt_rn(clamp_min(sub(mul(mid, mid), det), 0.1f));
  const float radius_f =
      ceilf(mul(3.0f, __fsqrt_rn(maximum(add(mid, disc), sub(mid, disc)))));

  // the binning rect: the 3-sigma square cut to the bbox of the support
  // ellipse d^T cov2d^-1 d <= 2 ln(255 op)
  float op = __ldg(a.opacities + g);
  if (a.antialias) {
    const float det_raw = sub(mul(sub(cxx, 0.3f), sub(cyy, 0.3f)), mul(cxy, cxy));
    op = mul(op, __fsqrt_rn(add(mul(clamp_min(det_raw, 0.0f), det_inv), 1e-12f)));
  }
  const float r_support = __fsqrt_rn(
      add(clamp_min(mul(2.0f, logf(mul(255.0f, clamp_min(op, 1e-12f)))), 0.0f), 1e-12f));
  const bool supported = op > (float)(1.0 / 255.0);
  const float bbox_x = supported ? ceilf(minimum(radius_f, mul(r_support, __fsqrt_rn(add(
                                       clamp_min(cxx, 0.0f), 1e-12f)))))
                                 : 0.0f;
  const float bbox_y = supported ? ceilf(minimum(radius_f, mul(r_support, __fsqrt_rn(add(
                                       clamp_min(cyy, 0.0f), 1e-12f)))))
                                 : 0.0f;
  const int rmin_x = tile_index(sub(mx, bbox_x), a.grid_x);
  const int rmin_y = tile_index(sub(my, bbox_y), a.grid_y);
  const int rmax_x = tile_index(sub(add(add(mx, bbox_x), (float)GS_TILE), 1.0f), a.grid_x);
  const int rmax_y = tile_index(sub(add(add(my, bbox_y), (float)GS_TILE), 1.0f), a.grid_y);
  const int tiles = (rmax_x - rmin_x) * (rmax_y - rmin_y);
  // radii and visibility keep the 3-sigma circle's rect
  const int circ_w = tile_index(sub(add(add(mx, radius_f), (float)GS_TILE), 1.0f), a.grid_x) -
                     tile_index(sub(mx, radius_f), a.grid_x);
  const int circ_h = tile_index(sub(add(add(my, radius_f), (float)GS_TILE), 1.0f), a.grid_y) -
                     tile_index(sub(my, radius_f), a.grid_y);
  const bool vis = in_front && det_ok && circ_w * circ_h > 0;
  const bool valid = in_front && det_ok && tiles > 0;

  float rgb[3];
  if constexpr (COEFFS < 0) {
#pragma unroll
    for (int k = 0; k < 3; ++k) rgb[k] = __ldg(a.colors_precomp + g3 + k);
  } else {
    // sh.sh_to_rgb_clamped over the first COEFFS coefficients
    rgb[0] = rgb[1] = rgb[2] = 0.0f;
    if constexpr (COEFFS > 0) {
      float sh[4 * kVec];
      if constexpr (kStaged) {
#pragma unroll
        for (int j = 0; j < kVec; ++j) {
          const float4 v = s_sh[t * kRow + j];
          sh[4 * j] = v.x;
          sh[4 * j + 1] = v.y;
          sh[4 * j + 2] = v.z;
          sh[4 * j + 3] = v.w;
        }
      } else {
        const float* row = a.shs + (size_t)g * a.sh_stride;
#pragma unroll
        for (int j = 0; j < 3 * COEFFS; ++j) sh[j] = __ldg(row + j);
      }
      const float dx = sub(x, s_cam[32]), dy = sub(y, s_cam[33]), dz = sub(z, s_cam[34]);
      const float inv = rsqrtf(add(add(add(mul(dx, dx), mul(dy, dy)), mul(dz, dz)), 1e-18f));
      float b[COEFFS];
      sh_basis<COEFFS>(mul(dx, inv), mul(dy, inv), mul(dz, inv), b);
#pragma unroll
      for (int k = 0; k < COEFFS; ++k) {
#pragma unroll
        for (int ch = 0; ch < 3; ++ch) rgb[ch] += sh[3 * k + ch] * b[k];
      }
    }
#pragma unroll
    for (int k = 0; k < 3; ++k) rgb[k] = clamp_min(rgb[k] + 0.5f, 0.0f);
  }

  a.valid[g] = valid;
  a.depths[g] = vz;
  reinterpret_cast<float2*>(a.means2d)[g] = make_float2(mx, my);
  a.conic[g3] = mul(cyy, det_inv);
  a.conic[g3 + 1] = mul(-cxy, det_inv);
  a.conic[g3 + 2] = mul(cxx, det_inv);
  a.opacity[g] = op;
#pragma unroll
  for (int k = 0; k < 3; ++k) a.colors[g3 + k] = rgb[k];
  a.radii[g] = vis ? __float2int_rz(radius_f) : 0;
  reinterpret_cast<int2*>(a.rect_min)[g] = make_int2(rmin_x, rmin_y);
  reinterpret_cast<int2*>(a.rect_max)[g] = make_int2(rmax_x, rmax_y);
  a.tiles[g] = valid ? tiles : 0;
}

template <int COEFFS, bool VEC>
void launch(const PreArgs& a, cudaStream_t stream) {
  preprocess_forward_kernel<COEFFS, VEC>
      <<<(a.n + kThreads - 1) / kThreads, kThreads, 0, stream>>>(a);
}

template <int COEFFS>
void launch_sh(const PreArgs& a, bool vec, cudaStream_t stream) {
  if (vec)
    launch<COEFFS, true>(a, stream);
  else
    launch<COEFFS, false>(a, stream);
}

}  // namespace

// coeffs: the SH coefficients to read ((active degree + 1)^2, at most 16),
// ignored with colors_precomp; sh_stride: the floats of an SH row (3 K).
// projmatrix may be null with intrinsics, campos with colors_precomp;
// exactly one of (scales, rotations) and cov3d, and of shs and
// colors_precomp, is given; offset may be null. The outputs are [n]
// (valid, depths, opacity, radii, tiles), [n, 2] (means2d, rect_min,
// rect_max) and [n, 3] (conic, colors), contiguous.
GS_API int gs_preprocess_forward(
    int n, int W, int H, int grid_x, int grid_y, int coeffs, int sh_stride, int antialias,
    float scale_modifier, float focal_x, float focal_y, float lim_x, float lim_y,
    const float* means3d, const float* opacities, const float* scales, const float* rotations,
    const float* cov3d, const float* shs, const float* colors_precomp, const float* viewmatrix,
    const float* projmatrix, const float* campos, const float* intrinsics, const float* offset,
    bool* valid, float* depths, float* means2d, float* conic, float* opacity, float* colors,
    int* radii, int* rect_min, int* rect_max, int* tiles, void* stream) {
  const PreArgs a{n, W, H, grid_x, grid_y, sh_stride, antialias, scale_modifier, focal_x, focal_y,
                  lim_x, lim_y, means3d, opacities, scales, rotations, cov3d, shs,
                  colors_precomp, viewmatrix, projmatrix, campos, intrinsics, offset, valid,
                  depths, means2d, conic, opacity, colors, radii, rect_min, rect_max, tiles};
  const cudaStream_t s = (cudaStream_t)stream;
  const bool vec = shs != nullptr && sh_stride % 4 == 0 &&
                   reinterpret_cast<uintptr_t>(shs) % 16 == 0;
  if (n > 0) {
    switch (colors_precomp ? -1 : coeffs) {
      case -1: launch<-1, false>(a, s); break;
      case 0: launch<0, false>(a, s); break;
      case 1: launch_sh<1>(a, vec, s); break;
      case 4: launch_sh<4>(a, vec, s); break;
      case 9: launch_sh<9>(a, vec, s); break;
      case 16: launch_sh<16>(a, vec, s); break;
      default: return static_cast<int>(cudaErrorInvalidValue);
    }
  }
  return gs_last_error();
}
