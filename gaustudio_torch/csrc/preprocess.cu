// K7 preprocess_forward: the rasterizer's per-Gaussian preprocess in one
// pass; K8 preprocess_backward: its vector-Jacobian product, in one pass.
// K7 is the preprocess of every render on the card, and under autograd the
// forward whose backward is K8 (ops/gaussian.py _Preprocess).
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
//
// K8 replaces no Pallas kernel either: under autograd the port ran the same
// ~150 torch ops and their autograd backward, ~45 of a 77 ms training step
// at 3M Gaussians (PERF.md). Its plain version is ops/gaussian.py
// preprocess_backward_plain, the same formulas in torch ops, held to torch
// autograd through preprocess.
//
// Bound: bytes. At SH 3 a Gaussian reads its row of K4's [N, 10]
// accumulator in place (the wrapper passes each output's row stride; 36 of
// its 40 B are read, 40 with antialias), its mean 12 B, scale 12, rotation
// 16 and SH 192, and writes d_mean 12, d_scale 12, d_rotation 16 and d_SH
// 192: 500 B, 0.448 ms at 3M on 3.35 TB/s. The gradients of colors_precomp,
// means2d_offset and (without antialias) the opacities are their outputs'
// gradients unchanged, so the wrapper hands those on and K8 moves none of
// their bytes. Its ~600 operations a Gaussian are free beside that.
//
// Design: one thread per Gaussian, which recomputes the forward's
// intermediates in registers from the inputs (geometry() below, K7's own
// code) rather than reading them back: K7 saves nothing, and recomputing
// costs no bytes. The gates of the backward (the signed clamps of depth and
// w, the fov clamp, det > 0, the antialias root, the colour's clamp at 0)
// read those bit-equal values, so they decide as autograd through the plain
// version does; the colour's gate reads K7's SH sum, which differs from the
// einsum's by rounding, and may decide otherwise where a colour lies within
// rounding of 0. The gradient arithmetic itself may fuse. The SH rows are
// most of the bytes each way: they come in through K7's warp-staged rows,
// and d_SH goes out through the same rows, the zeros above the active band
// added on the way, a warp's 32 rows as one span of 16-byte stores. A row
// that no tile touched has zero upstream gradients and gets zeros, as under
// autograd.

#include <type_traits>

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

// sh.sh_basis_backward: the gradient of a unit direction from that of its
// first COEFFS basis values
template <int COEFFS>
__device__ __forceinline__ void sh_basis_backward(float x, float y, float z,
                                                  const float (&g)[COEFFS], float (&d)[3]) {
  d[0] = d[1] = d[2] = 0.0f;
  if constexpr (COEFFS > 1) {
    constexpr float C1 = 0.4886025119029199f;
    d[0] -= C1 * g[3];
    d[1] -= C1 * g[1];
    d[2] += C1 * g[2];
  }
  if constexpr (COEFFS > 4) {
    constexpr float A = 1.0925484305920792f, B = 0.31539156525252005f,
                    C = 0.5462742152960396f;
    d[0] += A * y * g[4] - 2.0f * B * x * g[6] - A * z * g[7] + 2.0f * C * x * g[8];
    d[1] += A * x * g[4] - A * z * g[5] - 2.0f * B * y * g[6] - 2.0f * C * y * g[8];
    d[2] += -A * y * g[5] + 4.0f * B * z * g[6] - A * x * g[7];
    if constexpr (COEFFS > 9) {
      constexpr float D0 = -0.5900435899266435f, D1 = 2.890611442640554f,
                      D2 = -0.4570457994644658f, D3 = 0.3731763325901154f,
                      D5 = 1.445305721320277f;
      const float xx = x * x, yy = y * y, zz = z * z;
      d[0] += D0 * 6.0f * x * y * g[9] + D1 * y * z * g[10] - D2 * 2.0f * x * y * g[11] -
              D3 * 6.0f * x * z * g[12] + D2 * (4.0f * zz - 3.0f * xx - yy) * g[13] +
              D5 * 2.0f * x * z * g[14] + D0 * 3.0f * (xx - yy) * g[15];
      d[1] += D0 * 3.0f * (xx - yy) * g[9] + D1 * x * z * g[10] +
              D2 * (4.0f * zz - xx - 3.0f * yy) * g[11] - D3 * 6.0f * y * z * g[12] -
              D2 * 2.0f * x * y * g[13] - D5 * 2.0f * y * z * g[14] - D0 * 6.0f * x * y * g[15];
      d[2] += D1 * x * y * g[10] + D2 * 8.0f * y * z * g[11] +
              D3 * (6.0f * zz - 3.0f * xx - 3.0f * yy) * g[12] + D2 * 8.0f * x * z * g[13] +
              D5 * (xx - yy) * g[14];
    }
  }
}

// What both kernels read of the Gaussians and the camera, and the host
// scalars of the projection-matrix path
struct GeomArgs {
  int n, W, H, sh_stride;
  float scale_modifier, focal_x, focal_y, lim_x, lim_y;
  const float *means3d, *scales, *rotations, *cov3d, *shs;
  const float *viewmatrix, *projmatrix, *campos, *intrinsics;
};

// The camera's matrices, centre and intrinsics into shared memory:
// viewmatrix 0-15, projmatrix 16-31, campos 32-34, intrinsics 35-38
__device__ __forceinline__ void load_camera(const GeomArgs& a, float* s_cam) {
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
}

// A warp's SH rows, the first KVEC float4 of each, read as one span into s
// (rows of KROW float4)
template <int KVEC, int KROW>
__device__ __forceinline__ void stage_sh_rows(const GeomArgs& a, int first, int lane, float4* s) {
  const int rows = min(32, a.n - first);
  const float4* src = reinterpret_cast<const float4*>(a.shs);
  const int stride4 = a.sh_stride / 4;
  for (int q = lane; q < rows * KVEC; q += 32) {
    const int r = q / KVEC, c = q - r * KVEC;
    s[r * KROW + c] = __ldg(src + (size_t)(first + r) * stride4 + c);
  }
  __syncwarp();
}

// The projection of one Gaussian up to its 2D covariance, as preprocess and
// compute_cov2d compute it, unfused and in their order
struct Geom {
  float x, y, z, vx, vy, vz;
  float c[6];  // the 3D covariance
  float focal_x, focal_y, lim_x, lim_y;
  float mx, my;  // the pixel mean, before the offset
  // the projection-matrix path: p_hom x and y, w = p_hom w + 1e-7, 1 / signed_clamp(w)
  float ph0, ph1, w, pw;
  float tz, txtz, tytz, tx, ty, inv_tz, j00, j02, j11, j12;
  float V00, V01, V02, V11, V12, V22;  // the view-space covariance
  float cxx, cxy, cyy, det, det_inv;
  bool det_ok;
};

__device__ __forceinline__ Geom geometry(const GeomArgs& a, const float* s_cam, int g) {
  Geom o;
  const float* V = s_cam;
  const float* P = s_cam + 16;
  const size_t g3 = 3 * (size_t)g;
  const float x = __ldg(a.means3d + g3), y = __ldg(a.means3d + g3 + 1),
              z = __ldg(a.means3d + g3 + 2);
  o.x = x;
  o.y = y;
  o.z = z;
  o.vx = transform(V, x, y, z, 0);
  o.vy = transform(V, x, y, z, 1);
  o.vz = transform(V, x, y, z, 2);

  if (a.cov3d) {
#pragma unroll
    for (int k = 0; k < 6; ++k) o.c[k] = __ldg(a.cov3d + 6 * (size_t)g + k);
  } else {
    const float* q = a.rotations + 4 * (size_t)g;
    build_cov3d(__ldg(a.scales + g3), __ldg(a.scales + g3 + 1), __ldg(a.scales + g3 + 2),
                a.scale_modifier, __ldg(q), __ldg(q + 1), __ldg(q + 2), __ldg(q + 3), o.c);
  }

  // the pixel mean, and the focal lengths and fov clamp of the EWA projection
  o.focal_x = a.focal_x;
  o.focal_y = a.focal_y;
  o.lim_x = a.lim_x;
  o.lim_y = a.lim_y;
  o.ph0 = o.ph1 = o.w = o.pw = 0.0f;
  if (a.intrinsics) {
    const float fx = s_cam[35], fy = s_cam[36], cx = s_cam[37], cy = s_cam[38];
    o.focal_x = fx;
    o.focal_y = fy;
    // 1.3 * tan_fov, tan_fov = 0.5 size / focal as reciprocal(focal) * (0.5 size)
    o.lim_x = mul(mul(dvd(1.0f, fx), 0.5f * (float)a.W), 1.3f);
    o.lim_y = mul(mul(dvd(1.0f, fy), 0.5f * (float)a.H), 1.3f);
    const float tz = signed_clamp(o.vz, 0.2f);
    o.mx = sub(add(dvd(mul(fx, o.vx), tz), cx), 0.5f);
    o.my = sub(add(dvd(mul(fy, o.vy), tz), cy), 0.5f);
  } else {
    o.w = add(transform(P, x, y, z, 3), 1e-7f);
    o.pw = dvd(1.0f, signed_clamp(o.w, 1e-4f));
    o.ph0 = transform(P, x, y, z, 0);
    o.ph1 = transform(P, x, y, z, 1);
    o.mx = mul(sub(mul(add(mul(o.ph0, o.pw), 1.0f), (float)a.W), 1.0f), 0.5f);
    o.my = mul(sub(mul(add(mul(o.ph1, o.pw), 1.0f), (float)a.H), 1.0f), 0.5f);
  }

  // gaussian.compute_cov2d: J W Sigma W^T J^T + 0.3 I
  o.tz = signed_clamp(o.vz, 0.2f);
  o.txtz = dvd(o.vx, o.tz);
  o.tytz = dvd(o.vy, o.tz);
  o.tx = mul(clamp(o.txtz, -o.lim_x, o.lim_x), o.tz);
  o.ty = mul(clamp(o.tytz, -o.lim_y, o.lim_y), o.tz);
  o.inv_tz = dvd(1.0f, o.tz);
  const float inv_tz2 = mul(o.inv_tz, o.inv_tz);
  o.j00 = mul(o.focal_x, o.inv_tz);
  o.j02 = mul(mul(-o.focal_x, o.tx), inv_tz2);
  o.j11 = mul(o.focal_y, o.inv_tz);
  o.j12 = mul(mul(-o.focal_y, o.ty), inv_tz2);
  // rows of the world -> view rotation: columns of the viewmatrix
  const float r[3][3] = {{V[0], V[4], V[8]}, {V[1], V[5], V[9]}, {V[2], V[6], V[10]}};
  float s[3][3];
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    s[i][0] = add(add(mul(o.c[0], r[i][0]), mul(o.c[1], r[i][1])), mul(o.c[2], r[i][2]));
    s[i][1] = add(add(mul(o.c[1], r[i][0]), mul(o.c[3], r[i][1])), mul(o.c[4], r[i][2]));
    s[i][2] = add(add(mul(o.c[2], r[i][0]), mul(o.c[4], r[i][1])), mul(o.c[5], r[i][2]));
  }
  auto dotr = [&](int i, int j) {
    return add(add(mul(s[i][0], r[j][0]), mul(s[i][1], r[j][1])), mul(s[i][2], r[j][2]));
  };
  o.V00 = dotr(0, 0);
  o.V01 = dotr(0, 1);
  o.V02 = dotr(0, 2);
  o.V11 = dotr(1, 1);
  o.V12 = dotr(1, 2);
  o.V22 = dotr(2, 2);
  const float j00 = o.j00, j02 = o.j02, j11 = o.j11, j12 = o.j12;
  o.cxx = add(add(mul(j00, add(mul(o.V00, j00), mul(o.V02, j02))),
                  mul(j02, add(mul(o.V02, j00), mul(o.V22, j02)))), 0.3f);
  o.cxy = add(mul(j00, add(mul(o.V01, j11), mul(o.V02, j12))),
              mul(j02, add(mul(o.V12, j11), mul(o.V22, j12))));
  o.cyy = add(add(mul(j11, add(mul(o.V11, j11), mul(o.V12, j12))),
                  mul(j12, add(mul(o.V12, j11), mul(o.V22, j12)))), 0.3f);

  o.det = sub(mul(o.cxx, o.cyy), mul(o.cxy, o.cxy));
  o.det_ok = o.det > 0.0f;
  o.det_inv = o.det_ok ? dvd(1.0f, o.det) : 0.0f;
  return o;
}

// The unit view direction of sh.sh_to_rgb_clamped and its inverse length
__device__ __forceinline__ void view_dir(const Geom& o, const float* s_cam, float (&d)[3],
                                         float (&u)[3], float& inv) {
  d[0] = sub(o.x, s_cam[32]);
  d[1] = sub(o.y, s_cam[33]);
  d[2] = sub(o.z, s_cam[34]);
  inv = rsqrtf(add(add(add(mul(d[0], d[0]), mul(d[1], d[1])), mul(d[2], d[2])), 1e-18f));
#pragma unroll
  for (int k = 0; k < 3; ++k) u[k] = mul(d[k], inv);
}

struct PreArgs {
  GeomArgs geo;
  int grid_x, grid_y, antialias;
  const float *opacities, *colors_precomp, *offset;
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
  __shared__ float s_cam[39];
  __shared__ float4 s_sh[kStaged ? kThreads * kRow : 1];
  const int t = threadIdx.x;
  load_camera(a.geo, s_cam);
  __syncthreads();
  const int g = blockIdx.x * kThreads + t;
  const int lane = t & 31;
  if constexpr (kStaged) stage_sh_rows<kVec, kRow>(a.geo, g - lane, lane, s_sh + (t - lane) * kRow);
  if (g >= a.geo.n) return;
  const size_t g2 = 2 * (size_t)g, g3 = 3 * (size_t)g;
  const Geom o = geometry(a.geo, s_cam, g);
  const bool in_front = o.vz > 0.2f;
  const float cxx = o.cxx, cxy = o.cxy, cyy = o.cyy, det = o.det, det_inv = o.det_inv;
  float mx = o.mx, my = o.my;
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
  const bool vis = in_front && o.det_ok && circ_w * circ_h > 0;
  const bool valid = in_front && o.det_ok && tiles > 0;

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
        const float* row = a.geo.shs + (size_t)g * a.geo.sh_stride;
#pragma unroll
        for (int j = 0; j < 3 * COEFFS; ++j) sh[j] = __ldg(row + j);
      }
      float d[3], u[3], inv;
      view_dir(o, s_cam, d, u, inv);
      float b[COEFFS];
      sh_basis<COEFFS>(u[0], u[1], u[2], b);
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
  a.depths[g] = o.vz;
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

struct BwdArgs {
  GeomArgs geo;
  int antialias;
  // the upstream gradients, rows of these strides (null: zeros)
  int s_depth, s_mean, s_conic, s_op, s_color;
  const float *d_depths, *d_means2d, *d_conic, *d_opacities, *d_colors;
  const float* opacities;
  float *g_means3d, *g_opacities, *g_scales, *g_rotations, *g_cov3d, *g_shs;
};

// gaussian._signed_clamp's gradient gate (false on NaN)
__device__ __forceinline__ bool signed_clamp_passes(float v, float floor) {
  return v >= 0.0f ? v >= floor : v <= -floor;
}

// K8: the vector-Jacobian product of preprocess, one thread a Gaussian.
// COEFFS and VEC as in K7; with VEC the d_SH rows are written back through
// the staging rows, whole (zeros above the active band), a warp's span at a
// time.
template <int COEFFS, bool VEC>
__global__ void __launch_bounds__(kThreads) preprocess_backward_kernel(const BwdArgs a) {
  constexpr int kVec = COEFFS > 0 ? (3 * COEFFS + 3) / 4 : 1;
  constexpr int kRow = kVec | 1;
  constexpr bool kStaged = VEC && COEFFS > 0;
  __shared__ float s_cam[39];
  __shared__ float4 s_sh[kStaged ? kThreads * kRow : 1];
  const int t = threadIdx.x;
  load_camera(a.geo, s_cam);
  __syncthreads();
  const int g = blockIdx.x * kThreads + t;
  const int lane = t & 31;
  float4* s_row = kStaged ? s_sh + t * kRow : s_sh;
  if constexpr (kStaged) stage_sh_rows<kVec, kRow>(a.geo, g - lane, lane, s_sh + (t - lane) * kRow);
  if (g < a.geo.n) {
    const float* V = s_cam;
    const float* P = s_cam + 16;
    const size_t g3 = 3 * (size_t)g;
    auto up = [&](const float* p, int stride, int k) {
      return p ? __ldg(p + (size_t)g * stride + k) : 0.0f;
    };
    const Geom o = geometry(a.geo, s_cam, g);
    const float gc0 = up(a.d_conic, a.s_conic, 0), gc1 = up(a.d_conic, a.s_conic, 1),
                gc2 = up(a.d_conic, a.s_conic, 2);

    // conic (and opacity) -> cov2d
    float d_det_inv = gc0 * o.cyy - gc1 * o.cxy + gc2 * o.cxx;
    float d_cxx = gc2 * o.det_inv, d_cxy = -gc1 * o.det_inv, d_cyy = gc0 * o.det_inv;
    if (a.antialias) {
      const float det_raw = sub(mul(sub(o.cxx, 0.3f), sub(o.cyy, 0.3f)), mul(o.cxy, o.cxy));
      const float kept = clamp_min(det_raw, 0.0f);
      const float root = __fsqrt_rn(add(mul(kept, o.det_inv), 1e-12f));
      const float gop = up(a.d_opacities, a.s_op, 0);
      a.g_opacities[g] = gop * root;
      const float d_f = gop * __ldg(a.opacities + g) * 0.5f / root;
      const float d_raw = det_raw >= 0.0f ? d_f * o.det_inv : 0.0f;
      d_det_inv += d_f * kept;
      d_cxx += d_raw * (o.cyy - 0.3f);
      d_cyy += d_raw * (o.cxx - 0.3f);
      d_cxy -= 2.0f * o.cxy * d_raw;
    }
    const float d_det = o.det_ok ? -d_det_inv * o.det_inv * o.det_inv : 0.0f;
    d_cxx += d_det * o.cyy;
    d_cyy += d_det * o.cxx;
    d_cxy -= 2.0f * o.cxy * d_det;

    // cov2d = J V J^T + 0.3 I -> J and V
    const float j00 = o.j00, j02 = o.j02, j11 = o.j11, j12 = o.j12;
    const float dV00 = d_cxx * j00 * j00;
    const float dV01 = d_cxy * j00 * j11;
    const float dV02 = 2.0f * d_cxx * j00 * j02 + d_cxy * j00 * j12;
    const float dV11 = d_cyy * j11 * j11;
    const float dV12 = d_cxy * j02 * j11 + 2.0f * d_cyy * j11 * j12;
    const float dV22 = d_cxx * j02 * j02 + d_cxy * j02 * j12 + d_cyy * j12 * j12;
    const float d_j00 =
        2.0f * d_cxx * (o.V00 * j00 + o.V02 * j02) + d_cxy * (o.V01 * j11 + o.V02 * j12);
    const float d_j02 =
        2.0f * d_cxx * (o.V02 * j00 + o.V22 * j02) + d_cxy * (o.V12 * j11 + o.V22 * j12);
    const float d_j11 =
        2.0f * d_cyy * (o.V11 * j11 + o.V12 * j12) + d_cxy * (o.V01 * j00 + o.V12 * j02);
    const float d_j12 =
        2.0f * d_cyy * (o.V12 * j11 + o.V22 * j12) + d_cxy * (o.V02 * j00 + o.V22 * j02);

    // J -> the view-space mean, through the fov clamp
    const float inv_tz2 = o.inv_tz * o.inv_tz;
    const float d_inv_tz = o.focal_x * d_j00 + o.focal_y * d_j11 +
                           2.0f * o.inv_tz * (-o.focal_x * o.tx * d_j02 - o.focal_y * o.ty * d_j12);
    const float d_tx = -o.focal_x * inv_tz2 * d_j02;
    const float d_ty = -o.focal_y * inv_tz2 * d_j12;
    float d_tz = -d_inv_tz * inv_tz2 + d_tx * clamp(o.txtz, -o.lim_x, o.lim_x) +
                 d_ty * clamp(o.tytz, -o.lim_y, o.lim_y);
    const float d_txtz = (o.txtz >= -o.lim_x && o.txtz <= o.lim_x) ? d_tx * o.tz : 0.0f;
    const float d_tytz = (o.tytz >= -o.lim_y && o.tytz <= o.lim_y) ? d_ty * o.tz : 0.0f;
    float d_vx = d_txtz / o.tz;
    float d_vy = d_tytz / o.tz;
    d_tz -= (d_txtz * o.vx + d_tytz * o.vy) / (o.tz * o.tz);

    // the pixel mean and the depth
    const float gmx = up(a.d_means2d, a.s_mean, 0), gmy = up(a.d_means2d, a.s_mean, 1);
    float dm[3] = {0.0f, 0.0f, 0.0f};
    if (a.geo.intrinsics) {
      d_vx += gmx * o.focal_x / o.tz;
      d_vy += gmy * o.focal_y / o.tz;
      d_tz -= (gmx * o.focal_x * o.vx + gmy * o.focal_y * o.vy) / (o.tz * o.tz);
    } else {
      const float hw = 0.5f * (float)a.geo.W, hh = 0.5f * (float)a.geo.H;
      const float d_h0 = gmx * hw * o.pw, d_h1 = gmy * hh * o.pw;
      const float d_pw = gmx * hw * o.ph0 + gmy * hh * o.ph1;
      const float d_h3 = signed_clamp_passes(o.w, 1e-4f) ? -d_pw * o.pw * o.pw : 0.0f;
#pragma unroll
      for (int j = 0; j < 3; ++j)
        dm[j] += d_h0 * P[4 * j] + d_h1 * P[4 * j + 1] + d_h3 * P[4 * j + 3];
    }
    const float d_vz =
        up(a.d_depths, a.s_depth, 0) + (signed_clamp_passes(o.vz, 0.2f) ? d_tz : 0.0f);
#pragma unroll
    for (int j = 0; j < 3; ++j)
      dm[j] += d_vx * V[4 * j] + d_vy * V[4 * j + 1] + d_vz * V[4 * j + 2];

    // V = Rwv Sigma Rwv^T -> Sigma: dSigma = Rwv^T G Rwv, G the symmetric dV
    const float G[3][3] = {{dV00, 0.5f * dV01, 0.5f * dV02},
                           {0.5f * dV01, dV11, 0.5f * dV12},
                           {0.5f * dV02, 0.5f * dV12, dV22}};
    float T[3][3];  // G Rwv; Rwv[i][b] = V[4 b + i]
#pragma unroll
    for (int i = 0; i < 3; ++i) {
#pragma unroll
      for (int b = 0; b < 3; ++b)
        T[i][b] = G[i][0] * V[4 * b] + G[i][1] * V[4 * b + 1] + G[i][2] * V[4 * b + 2];
    }
    auto dS = [&](int p, int q) {
      return V[4 * p] * T[0][q] + V[4 * p + 1] * T[1][q] + V[4 * p + 2] * T[2][q];
    };
    const float dc[6] = {dS(0, 0), 2.0f * dS(0, 1), 2.0f * dS(0, 2), dS(1, 1), 2.0f * dS(1, 2),
                         dS(2, 2)};
    if (a.geo.cov3d) {
#pragma unroll
      for (int k = 0; k < 6; ++k) a.g_cov3d[6 * (size_t)g + k] = dc[k];
    } else {
      // build_cov3d: Sigma = M diag(s^2) M^T, M of the quaternion (r, x, y, z)
      const float* qp = a.geo.rotations + 4 * (size_t)g;
      const float r = __ldg(qp), x = __ldg(qp + 1), y = __ldg(qp + 2), z = __ldg(qp + 3);
      const float M[3][3] = {
          {1.0f - 2.0f * (y * y + z * z), 2.0f * (x * y - r * z), 2.0f * (x * z + r * y)},
          {2.0f * (x * y + r * z), 1.0f - 2.0f * (x * x + z * z), 2.0f * (y * z - r * x)},
          {2.0f * (x * z - r * y), 2.0f * (y * z + r * x), 1.0f - 2.0f * (x * x + y * y)}};
      const float dC[3][3] = {{2.0f * dc[0], dc[1], dc[2]},
                              {dc[1], 2.0f * dc[3], dc[4]},
                              {dc[2], dc[4], 2.0f * dc[5]}};
      float dM[3][3];
#pragma unroll
      for (int k = 0; k < 3; ++k) {
        const float sk = a.geo.scale_modifier * __ldg(a.geo.scales + g3 + k);
        float d_sq = 0.0f;
#pragma unroll
        for (int i = 0; i < 3; ++i) {
          const float dcm = dC[i][0] * M[0][k] + dC[i][1] * M[1][k] + dC[i][2] * M[2][k];
          d_sq += M[i][k] * dcm;
          dM[i][k] = dcm * sk * sk;
        }
        a.g_scales[g3 + k] = d_sq * sk * a.geo.scale_modifier;  // 0.5 d_sq 2 s sm
      }
      float* gq = a.g_rotations + 4 * (size_t)g;
      gq[0] = 2.0f * (-z * dM[0][1] + y * dM[0][2] + z * dM[1][0] - x * dM[1][2] - y * dM[2][0] +
                      x * dM[2][1]);
      gq[1] = 2.0f * (y * dM[0][1] + z * dM[0][2] + y * dM[1][0] - 2.0f * x * dM[1][1] -
                      r * dM[1][2] + z * dM[2][0] + r * dM[2][1] - 2.0f * x * dM[2][2]);
      gq[2] = 2.0f * (-2.0f * y * dM[0][0] + x * dM[0][1] + r * dM[0][2] + x * dM[1][0] +
                      z * dM[1][2] - r * dM[2][0] + z * dM[2][1] - 2.0f * y * dM[2][2]);
      gq[3] = 2.0f * (-2.0f * z * dM[0][0] - r * dM[0][1] + x * dM[0][2] + r * dM[1][0] -
                      2.0f * z * dM[1][1] + y * dM[1][2] + x * dM[2][0] + y * dM[2][1]);
    }

    // the SH colour: d_SH[k][c] = b[k] d_rgb[c], and the view direction's share
    if constexpr (COEFFS > 0) {
      float d[3], u[3], inv;
      view_dir(o, s_cam, d, u, inv);
      float b[COEFFS];
      sh_basis<COEFFS>(u[0], u[1], u[2], b);
      // the SH row's first kVec float4: staged, or read a float at a time
      auto chunk = [&](int j) {
        if constexpr (kStaged) {
          return s_row[j];
        } else {
          const float* row = a.geo.shs + (size_t)g * a.geo.sh_stride;
          float v[4];
#pragma unroll
          for (int e = 0; e < 4; ++e) v[e] = 4 * j + e < 3 * COEFFS ? __ldg(row + 4 * j + e) : 0.0f;
          return make_float4(v[0], v[1], v[2], v[3]);
        }
      };
      float rgb[3] = {0.0f, 0.0f, 0.0f};  // K7's sum, for clamp_min's gate
#pragma unroll
      for (int j = 0; j < kVec; ++j) {
        const float4 v = chunk(j);
        const float e4[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int f = 4 * j + e;
          if (f < 3 * COEFFS) rgb[f % 3] += e4[e] * b[f / 3];
        }
      }
      float d_rgb[3];
#pragma unroll
      for (int c = 0; c < 3; ++c)
        d_rgb[c] = rgb[c] + 0.5f >= 0.0f ? up(a.d_colors, a.s_color, c) : 0.0f;
      float d_b[COEFFS];
#pragma unroll
      for (int k = 0; k < COEFFS; ++k) d_b[k] = 0.0f;
      float* out = a.g_shs + (size_t)g * a.geo.sh_stride;
#pragma unroll
      for (int j = 0; j < kVec; ++j) {
        const float4 v = chunk(j);
        const float e4[4] = {v.x, v.y, v.z, v.w};
        float w4[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int f = 4 * j + e;
          w4[e] = 0.0f;
          if (f < 3 * COEFFS) {
            d_b[f / 3] += e4[e] * d_rgb[f % 3];
            w4[e] = b[f / 3] * d_rgb[f % 3];
          }
        }
        if constexpr (kStaged) {
          s_row[j] = make_float4(w4[0], w4[1], w4[2], w4[3]);
        } else {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            if (4 * j + e < 3 * COEFFS) out[4 * j + e] = w4[e];
          }
        }
      }
      if constexpr (!kStaged) {
        for (int f = 3 * COEFFS; f < a.geo.sh_stride; ++f) out[f] = 0.0f;
      }
      float d_u[3];
      sh_basis_backward<COEFFS>(u[0], u[1], u[2], d_b, d_u);
      const float dot = d[0] * d_u[0] + d[1] * d_u[1] + d[2] * d_u[2];
#pragma unroll
      for (int k = 0; k < 3; ++k) dm[k] += inv * d_u[k] - inv * inv * inv * d[k] * dot;
    } else if constexpr (COEFFS == 0) {
      float* out = a.g_shs + (size_t)g * a.geo.sh_stride;
      for (int f = 0; f < a.geo.sh_stride; ++f) out[f] = 0.0f;
    }
#pragma unroll
    for (int k = 0; k < 3; ++k) a.g_means3d[g3 + k] = dm[k];
  }
  if constexpr (kStaged) {  // the warp's d_SH rows, written as one span
    __syncwarp();
    const int first = g - lane;
    const int rows = min(32, a.geo.n - first);
    const float4* s = s_sh + (t - lane) * kRow;
    float4* dst = reinterpret_cast<float4*>(a.g_shs);
    const int stride4 = a.geo.sh_stride / 4;
    for (int q = lane; q < rows * stride4; q += 32) {
      const int r = q / stride4, c = q - r * stride4;
      dst[(size_t)(first + r) * stride4 + c] =
          c < kVec ? s[r * kRow + c] : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    }
  }
}

template <typename Args, int COEFFS, bool VEC>
void launch(const Args& a, cudaStream_t stream) {
  const int blocks = (a.geo.n + kThreads - 1) / kThreads;
  if constexpr (std::is_same_v<Args, PreArgs>)
    preprocess_forward_kernel<COEFFS, VEC><<<blocks, kThreads, 0, stream>>>(a);
  else
    preprocess_backward_kernel<COEFFS, VEC><<<blocks, kThreads, 0, stream>>>(a);
}

// One instantiation for colors_precomp (coeffs -1) or each whole number of
// SH bands, the SH rows staged where they lie on 16-byte boundaries
template <typename Args>
int launch_coeffs(const Args& a, int coeffs, float* out_shs, cudaStream_t s) {
  const float* shs = a.geo.shs;
  const bool vec = shs != nullptr && a.geo.sh_stride % 4 == 0 &&
                   reinterpret_cast<uintptr_t>(shs) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(out_shs) % 16 == 0;
  if (a.geo.n <= 0) return 0;
  switch (shs ? coeffs : -1) {
    case -1: launch<Args, -1, false>(a, s); break;
    case 0: launch<Args, 0, false>(a, s); break;
    case 1: vec ? launch<Args, 1, true>(a, s) : launch<Args, 1, false>(a, s); break;
    case 4: vec ? launch<Args, 4, true>(a, s) : launch<Args, 4, false>(a, s); break;
    case 9: vec ? launch<Args, 9, true>(a, s) : launch<Args, 9, false>(a, s); break;
    case 16: vec ? launch<Args, 16, true>(a, s) : launch<Args, 16, false>(a, s); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return 0;
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
  const GeomArgs geo{n, W, H, sh_stride, scale_modifier, focal_x, focal_y, lim_x, lim_y,
                     means3d, scales, rotations, cov3d, shs, viewmatrix, projmatrix, campos,
                     intrinsics};
  const PreArgs a{geo, grid_x, grid_y, antialias, opacities, colors_precomp, offset, valid,
                  depths, means2d, conic, opacity, colors, radii, rect_min, rect_max, tiles};
  const int err = launch_coeffs(a, coeffs, nullptr, (cudaStream_t)stream);
  return err ? err : gs_last_error();
}

// K8. The inputs are K7's (colors_precomp and offset are not read); d_* are
// the gradients of depths [n], means2d [n, 2], conic [n, 3], opacity [n]
// and colors [n, 3], each a row every s_* floats (s_depth ... s_color; the
// row's own floats contiguous), or null for zeros. Written: g_means3d [n,
// 3]; g_opacities [n] with antialias (else unused); g_scales [n, 3] and
// g_rotations [n, 4], or g_cov3d [n, 6]; g_shs [n, K, 3] whole, zeros above
// the active band. Contiguous.
GS_API int gs_preprocess_backward(
    int n, int W, int H, int coeffs, int sh_stride, int antialias, int s_depth, int s_mean,
    int s_conic, int s_op, int s_color, float scale_modifier, float focal_x, float focal_y,
    float lim_x, float lim_y, const float* means3d, const float* opacities, const float* scales,
    const float* rotations, const float* cov3d, const float* shs, const float* viewmatrix,
    const float* projmatrix, const float* campos, const float* intrinsics,
    const float* d_depths, const float* d_means2d, const float* d_conic,
    const float* d_opacities, const float* d_colors, float* g_means3d, float* g_opacities,
    float* g_scales, float* g_rotations, float* g_cov3d, float* g_shs, void* stream) {
  const GeomArgs geo{n, W, H, sh_stride, scale_modifier, focal_x, focal_y, lim_x, lim_y,
                     means3d, scales, rotations, cov3d, shs, viewmatrix, projmatrix, campos,
                     intrinsics};
  const BwdArgs a{geo, antialias, s_depth, s_mean, s_conic, s_op, s_color, d_depths,
                  d_means2d, d_conic, d_opacities, d_colors, opacities, g_means3d, g_opacities,
                  g_scales, g_rotations, g_cov3d, g_shs};
  const int err = launch_coeffs(a, coeffs, g_shs, (cudaStream_t)stream);
  return err ? err : gs_last_error();
}
