// Shared constants of the forward render kernels (binning.cu, composite.cu).
//
// Built as one shared library with a plain C interface (see
// gaustudio_torch/utils/kernels.py); every entry point launches on the
// caller's stream, allocates nothing, and returns cudaGetLastError().
//
// The plain PyTorch versions of these kernels round once per tensor op. The
// arithmetic behind a decision (the tile cull of binning.cu; the skip, stop
// and median tests of composite.cu) is therefore written with __fmul_rn /
// __fadd_rn, which nvcc never fuses into a multiply-add, so each kernel
// decides exactly as its plain version does. Everything else may fuse.
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

#define GS_TILE 16
#define GS_BLOCK (GS_TILE * GS_TILE)

#define GS_API extern "C" __attribute__((visibility("default")))

static inline int gs_last_error() { return static_cast<int>(cudaGetLastError()); }
