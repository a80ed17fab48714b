// Shared constants of the render kernels (binning.cu, composite.cu,
// composite_bwd.cu).
//
// Built as one shared library with a plain C interface (see
// gaustudio_torch/utils/kernels.py); every entry point launches on the
// caller's stream, allocates nothing, and returns cudaGetLastError().
//
// The plain PyTorch versions of these kernels round once per tensor op. The
// arithmetic behind a decision (the tile cull of binning.cu; the skip, stop
// and median tests of composite.cu and composite_bwd.cu) is therefore written
// with __fmul_rn / __fadd_rn, which nvcc never fuses into a multiply-add, so
// each kernel decides exactly as its plain version does. Everything else may
// fuse.
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

#define GS_TILE 16
#define GS_BLOCK (GS_TILE * GS_TILE)

#define GS_API extern "C" __attribute__((visibility("default")))

static inline int gs_last_error() { return static_cast<int>(cudaGetLastError()); }

// -0.5 (a dx dx + c dy dy) - b dx dy of conic (a, b, c), unfused. It decides
// skip, stop and median in the forward (K3) and which entries the backward
// (K4) re-walks; one function keeps the two bit-identical, so the backward's
// T, rebuilt by division, retraces the forward exactly.
__device__ __forceinline__ float gs_power(float a, float b, float c, float dx, float dy) {
  return __fsub_rn(
      __fmul_rn(-0.5f, __fadd_rn(__fmul_rn(__fmul_rn(a, dx), dx),
                                 __fmul_rn(__fmul_rn(c, dy), dy))),
      __fmul_rn(__fmul_rn(b, dx), dy));
}
