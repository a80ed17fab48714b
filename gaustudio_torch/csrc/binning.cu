// K1 duplicate_with_keys and K2 identify_tile_ranges: tile binning.
//
// K1 replaces the TPU kernel gaustudio_tpu/ops/binning_fast.py:230
// _fused_expand_kernel. That kernel works in candidate-slot space: one slot
// per (Gaussian, rect tile), its owner recovered from a prefix-sum row with
// one-hot matmuls, since a TPU has no fast random gather. It emits, per
// candidate that survives the exact max-alpha tile cull (tile_max_alpha_keep,
// a port of binning_fast.py _tile_max_alpha_keep), one int64 key
// tile << 32 | float_bits(depth) and one int32 Gaussian index, Gaussian-major
// and row-major within a rect. Depth is > 0.2 after the near cull, so its
// bits order like its value, and a stable sort of the keys gives (tile,
// depth) order with ties in Gaussian order. With cull = 0 (2DGS surfels,
// whose support is not an ellipse in pixel space: fused_expand(cull=False))
// every candidate is kept and the conic and opacity are not read.
//
// What bounds K1 on this card: the cull's ~79 unfused operations per
// candidate (four of them IEEE divisions and a log), and 24 bytes per
// Gaussian read (48 with the cull) and 12 per kept entry written. Rects are
// skewed (at 1080p, p50 4 tiles, max a few hundred), so one thread per
// Gaussian walking its own rect leaves a warp waiting on its largest rect,
// ~5x the candidate iterations of a balanced split, and its stores land on
// 32 scattered runs. The walk here is warp-flattened instead, the TPU
// kernel's slot space taken one warp at a time:
//   * a warp owns 32 consecutive Gaussians; each lane loads its own
//     Gaussian's record once (with the cull's per-Gaussian terms,
//     cull_terms), and a shuffle scan of the candidate counts
//     (tiles_touched, never decoded from the rect alone) flattens the warp's
//     candidates into one list;
//   * the warp walks that list 32 candidates at a time: lane k takes
//     candidate base + k, finds its owner by a 5-step binary search over
//     the scan (read with shuffles), decodes
//     j -> (tx, ty) = rect_min + (j % w, j / w), shuffles in the owner's
//     record and evaluates the cull: ceil(sum / 32) iterations, not the max;
//   * __ballot_sync of the keep flags compacts the kept candidates, so a
//     lane's slot is the popcount of the kept lanes below it, and the
//     stores of neighbouring lanes land on neighbouring addresses.
// Two launches: the count pass (each warp's kept count, each block's total;
// without the cull the sum of tiles_touched; the block that finishes last
// scans the block totals into offsets and writes the entry count, which the
// caller reads back to size the outputs) and the write pass (the same walk,
// storing from the warp's offset, its block's plus the counts of the
// block's warps before it, and stopping once the warp's count is written).
// With the cull the count pass also keeps each iteration's keep mask (4
// bytes per 32 candidates), so the write pass culls nothing again and reads
// no splat. Depth is read by stride, so the caller's column of a wider
// tensor needs no copy. At 1080p/300k the count pass, bound by the cull's
// arithmetic, takes about 60% of K1's device time (PERF.md).
//
// K2 replaces gaustudio_tpu/ops/binning_fast.py _ranges_kernel, a sequential
// boundary walk over the sorted keys. Here one thread per boundary between
// sorted entries (L + 1 of them, with tile -1 before the first entry and
// tile T after the last) compares the tiles on its two sides; where they
// differ it ends the run of the one, starts the run of the other, and writes
// (0, 0) for every tile in between, which holds no entry. So every tile's
// pair is written exactly once, the output needs no zeroing pass, and K2 is
// one launch: one coalesced read of the keys and one write of the ranges,
// bound by memory bandwidth. The tiles of a gap are written by one thread,
// one after another, so an image whose entries fall in few tiles costs up
// to T serial 8-byte stores in one thread.

#include "common.cuh"

// The terms of the tile cull that depend on the Gaussian alone (its conic's
// a and c, its opacity), computed once per Gaussian.
struct CullTerms {
  float safe_a, safe_c, thresh;
  bool op_ok;
};

__device__ __forceinline__ CullTerms cull_terms(float a, float c, float op) {
  CullTerms t;
  t.safe_a = fabsf(a) > 1e-12f ? a : 1e-12f;
  t.safe_c = fabsf(c) > 1e-12f ? c : 1e-12f;
  t.thresh = 2.0f * logf(fmaxf(op, 1e-12f) * 255.0f);
  t.op_ok = op * 255.0f >= 1.0f;
  return t;
}

// True iff the Gaussian's max alpha over the 16x16 pixel box of tile
// (tx, ty) can reach 1/255: minimise d^T Q d over the box (0 inside, else
// the clamped vertex of the 1-D quadratic on each of the four edges), keep
// iff op exp(-min_q / 2) >= 1/255. Unfused, in the plain version's
// operation order (see common.cuh); the terms of ``t`` are the same
// operations on the same operands, only hoisted out of the walk.
__device__ __forceinline__ bool tile_max_alpha_keep(
    float mx, float my, float a, float b, float c, const CullTerms& t, int tx, int ty) {
  const float x0 = __fmul_rn((float)tx, GS_TILE);
  const float x1 = __fadd_rn(x0, GS_TILE - 1);
  const float y0 = __fmul_rn((float)ty, GS_TILE);
  const float y1 = __fadd_rn(y0, GS_TILE - 1);
  const bool inside = (mx >= x0) && (mx <= x1) && (my >= y0) && (my <= y1);

  const float dx0 = mx - x1;
  const float dx1 = mx - x0;
  const float dy0 = my - y1;
  const float dy1 = my - y0;

  auto q = [&](float dx, float dy) {  // a dx dx + 2 b dx dy + c dy dy
    return __fadd_rn(__fadd_rn(__fmul_rn(__fmul_rn(a, dx), dx),
                               __fmul_rn(__fmul_rn(__fmul_rn(2.0f, b), dx), dy)),
                     __fmul_rn(__fmul_rn(c, dy), dy));
  };
  auto edge_y = [&](float dy) {  // minimise over dx in [dx0, dx1] at fixed dy
    const float v = fminf(fmaxf(-b * dy / t.safe_a, dx0), dx1);
    return q(v, dy);
  };
  auto edge_x = [&](float dx) {  // minimise over dy in [dy0, dy1] at fixed dx
    const float v = fminf(fmaxf(-b * dx / t.safe_c, dy0), dy1);
    return q(dx, v);
  };
  const float m = fminf(fminf(edge_y(dy0), edge_y(dy1)),
                        fminf(edge_x(dx0), edge_x(dx1)));
  const float min_q = inside ? 0.0f : m;
  return (min_q <= t.thresh) && t.op_ok;
}

#define GS_FULL_MASK 0xffffffffu
// K1's blocks: 8 warps, each on its own 32 Gaussians (the walk itself needs
// no shared memory and no barrier); a block's offset covers its 8 warps.
#define GS_K1_THREADS 256
#define GS_K1_WARPS (GS_K1_THREADS / 32)
// With the cull, the count pass keeps each warp's keep masks of its first
// GS_K1_MASKS iterations (1024 candidates; a warp at 1080p walks a dozen),
// so that the write pass need not cull them again: a warp with more
// candidates culls the rest again.
#define GS_K1_MASKS 32

// The count kernel's blocks that have finished; the last one to finish
// scans the block totals and sets it back to 0. So K1's count passes must
// not run concurrently in one process (the wrappers queue them on the
// current stream, one at a time).
__device__ unsigned int gs_k1_blocks_done = 0;

// One lane's Gaussian: its candidate count and the fields the walk reads.
// The defaults (no candidates, width 1) keep the decode of a lane that owns
// nothing well defined.
struct Splat {
  int cnt = 0, x0 = 0, y0 = 0, w = 1;
  float mx = 0.f, my = 0.f, a = 0.f, b = 0.f, c = 0.f;
  CullTerms t = {1.f, 1.f, 0.f, false};
  uint32_t dbits = 0;
};

// The cull's fields of Gaussian g, which has candidates.
__device__ __forceinline__ void load_cull_fields(Splat& s, int g, const float* means2d,
                                                 const float* conic, const float* opacity) {
  s.mx = means2d[2 * g];
  s.my = means2d[2 * g + 1];
  s.a = conic[3 * g];
  s.b = conic[3 * g + 1];
  s.c = conic[3 * g + 2];
  s.t = cull_terms(s.a, s.c, opacity[g]);
}

template <bool CULL, bool WRITE>
__device__ __forceinline__ Splat load_splat(
    int g, int n, const float* means2d, const float* conic, const float* opacity,
    const int* rect_min, const int* rect_max, const int* tiles_touched,
    const float* depths, int depth_stride) {
  Splat s;
  if (g >= n) return s;
  s.cnt = max(tiles_touched[g], 0);
  if (s.cnt == 0) return s;  // its rect may hold anything: never decoded
  s.x0 = rect_min[2 * g];
  s.y0 = rect_min[2 * g + 1];
  s.w = max(rect_max[2 * g] - s.x0, 1);
  if (CULL) load_cull_fields(s, g, means2d, conic, opacity);
  if (WRITE) s.dbits = __float_as_uint(depths[(long long)g * depth_stride]);
  return s;
}

// The warp-flattened walk over the candidates of the warp's 32 Gaussians
// (the warp's first is warp * 32). Every lane of the warp calls it, lanes
// past n with no candidates, so the full-mask shuffles and ballots are
// defined. Returns the warp's kept count (the same in every lane). With the
// cull, the count pass stores the keep mask of iteration i < GS_K1_MASKS in
// masks[i], and the write pass reads it there instead of culling again.
// With WRITE, stores the kept entries from keys[out] / gids[out] on,
// stopping once ``want`` are written (the count pass's total: the
// candidates after the last kept one need no walk).
template <bool CULL, bool WRITE>
__device__ __forceinline__ int warp_walk(
    int warp, int n, int grid_x, const float* __restrict__ means2d,
    const float* __restrict__ conic, const float* __restrict__ opacity,
    const int* __restrict__ rect_min, const int* __restrict__ rect_max,
    const int* __restrict__ tiles_touched, const float* __restrict__ depths, int depth_stride,
    unsigned* __restrict__ masks, long long out, long long want, int64_t* __restrict__ keys,
    int* __restrict__ gids) {
  const int lane = threadIdx.x & 31;
  const int first = warp * 32;
  // the write pass reads the splat only for the candidates past the masks
  Splat s = load_splat<CULL && !WRITE, WRITE>(first + lane, n, means2d, conic, opacity, rect_min,
                                              rect_max, tiles_touched, depths, depth_stride);
  int incl = s.cnt;  // inclusive scan of the candidate counts
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int v = __shfl_up_sync(GS_FULL_MASK, incl, d);
    if (lane >= d) incl += v;
  }
  const int excl = incl - s.cnt;
  const int total = __shfl_sync(GS_FULL_MASK, incl, 31);  // <= 32 x the grid's tiles
  if (!CULL && !WRITE) return total;
  if (CULL && WRITE && total > 32 * GS_K1_MASKS && s.cnt > 0)
    load_cull_fields(s, first + lane, means2d, conic, opacity);

  int kept = 0;
  for (int base = 0, it = 0; base < total && (!WRITE || kept < want); base += 32, ++it) {
    const bool stored = CULL && WRITE && it < GS_K1_MASKS;  // the same in every lane
    unsigned mask = stored ? masks[it] : 0u;
    if (stored && mask == 0u) continue;
    const int cand = base + lane;
    // the owner: the number of lanes whose inclusive scan is <= cand (at
    // most 31, since lane 31's is the total); lanes with no candidates are
    // passed over, as their scan equals the lane's before
    int owner = 0;
#pragma unroll
    for (int step = 16; step > 0; step >>= 1) {
      if (__shfl_sync(GS_FULL_MASK, incl, owner + step - 1) <= cand) owner += step;
    }
    const int j = cand - __shfl_sync(GS_FULL_MASK, excl, owner);
    const int w = __shfl_sync(GS_FULL_MASK, s.w, owner);
    const int row = j / w;
    const int tx = __shfl_sync(GS_FULL_MASK, s.x0, owner) + (j - row * w);
    const int ty = __shfl_sync(GS_FULL_MASK, s.y0, owner) + row;
    bool keep = cand < total;
    if (stored) {
      keep = (mask >> lane) & 1u;
    } else if (CULL) {
      const float mx = __shfl_sync(GS_FULL_MASK, s.mx, owner);
      const float my = __shfl_sync(GS_FULL_MASK, s.my, owner);
      const float a = __shfl_sync(GS_FULL_MASK, s.a, owner);
      const float b = __shfl_sync(GS_FULL_MASK, s.b, owner);
      const float c = __shfl_sync(GS_FULL_MASK, s.c, owner);
      CullTerms t;
      t.safe_a = __shfl_sync(GS_FULL_MASK, s.t.safe_a, owner);
      t.safe_c = __shfl_sync(GS_FULL_MASK, s.t.safe_c, owner);
      t.thresh = __shfl_sync(GS_FULL_MASK, s.t.thresh, owner);
      t.op_ok = __shfl_sync(GS_FULL_MASK, (int)s.t.op_ok, owner);
      keep = keep && tile_max_alpha_keep(mx, my, a, b, c, t, tx, ty);
    }
    if (!stored) mask = __ballot_sync(GS_FULL_MASK, keep);
    if (CULL && !WRITE && it < GS_K1_MASKS && lane == 0) masks[it] = mask;
    if (WRITE) {
      const uint32_t dbits = __shfl_sync(GS_FULL_MASK, s.dbits, owner);
      if (keep) {
        const long long at = out + kept + __popc(mask & ((1u << lane) - 1u));
        keys[at] = ((int64_t)(ty * grid_x + tx) << 32) | (int64_t)dbits;
        gids[at] = first + owner;
      }
    }
    kept += __popc(mask);
  }
  return kept;
}

// The keep masks of warp ``warp`` in K1's scratch (see count_entries_kernel).
__device__ __forceinline__ unsigned* k1_masks(long long* scratch, int n, int warp) {
  const int num_warps = (n + 31) / 32, num_blocks = (n + GS_K1_THREADS - 1) / GS_K1_THREADS;
  return reinterpret_cast<unsigned*>(scratch + num_warps + num_blocks + 1) +
         (long long)warp * GS_K1_MASKS;
}

// In place over v[0, m): exclusive prefix sums, and *total = their sum. By
// one whole block: each thread sums a contiguous run of v, the block scans
// the runs' sums, and each thread writes its run's prefixes. Reads through
// L2 (other blocks wrote v).
__device__ void block_exclusive_scan(long long* v, int m, long long* total) {
  __shared__ long long warp_sums[GS_K1_WARPS];
  const int t = threadIdx.x, lane = t & 31, wid = t >> 5;
  const int per = (m + GS_K1_THREADS - 1) / GS_K1_THREADS;
  const int lo = min(t * per, m), hi = min(lo + per, m);
  long long sum = 0;
  for (int i = lo; i < hi; i += 8) {  // 8 loads in flight at a time
    long long x[8];
#pragma unroll
    for (int k = 0; k < 8; ++k) x[k] = i + k < hi ? __ldcg(v + i + k) : 0;
#pragma unroll
    for (int k = 0; k < 8; ++k) sum += x[k];
  }
  long long incl = sum;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const long long u = __shfl_up_sync(GS_FULL_MASK, incl, d);
    if (lane >= d) incl += u;
  }
  if (lane == 31) warp_sums[wid] = incl;
  __syncthreads();
  long long run = incl - sum;
  for (int w = 0; w < wid; ++w) run += warp_sums[w];
  for (int i = lo; i < hi; ++i) {
    const long long c = __ldcg(v + i);
    v[i] = run;
    run += c;
  }
  if (t == GS_K1_THREADS - 1) *total = run;
}

// K1's count pass, in scratch = [num_warps warp counts | num_blocks block
// offsets | the entry count | with the cull, GS_K1_MASKS keep masks a warp
// (uint32)]: each warp's kept count, each block's total; the block that
// finishes last turns the totals into exclusive offsets and writes the entry
// count, which the caller reads back.
template <bool CULL>
__global__ void __launch_bounds__(GS_K1_THREADS) count_entries_kernel(
    int n, const float* __restrict__ means2d, const float* __restrict__ conic,
    const float* __restrict__ opacity, const int* __restrict__ rect_min,
    const int* __restrict__ rect_max, const int* __restrict__ tiles_touched,
    long long* __restrict__ scratch) {
  __shared__ int warp_kept[GS_K1_WARPS];
  __shared__ bool last;
  const int lane = threadIdx.x & 31, wid = threadIdx.x >> 5;
  const int warp = blockIdx.x * GS_K1_WARPS + wid, num_warps = (n + 31) / 32;
  int kept = 0;
  if (warp < num_warps)  // the whole warp, which stays for the barriers below
    kept = warp_walk<CULL, false>(warp, n, 0, means2d, conic, opacity, rect_min, rect_max,
                                  tiles_touched, nullptr, 0, k1_masks(scratch, n, warp), 0, 0,
                                  nullptr, nullptr);
  if (lane == 0) {
    warp_kept[wid] = kept;
    if (warp < num_warps) scratch[warp] = kept;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    long long block = 0;
    for (int w = 0; w < GS_K1_WARPS; ++w) block += warp_kept[w];
    scratch[num_warps + blockIdx.x] = block;
    __threadfence();  // the total is visible before the block counts as done
    last = atomicAdd(&gs_k1_blocks_done, 1u) == gridDim.x - 1;
  }
  __syncthreads();
  if (!last) return;
  __threadfence();
  block_exclusive_scan(scratch + num_warps, gridDim.x, scratch + num_warps + gridDim.x);
  if (threadIdx.x == 0) gs_k1_blocks_done = 0;
}

// K1's write pass: each warp's output offset is its block's plus the counts
// of the block's warps before it; then the walk again, storing.
template <bool CULL>
__global__ void __launch_bounds__(GS_K1_THREADS) write_entries_kernel(
    int n, int grid_x, const float* __restrict__ means2d, const float* __restrict__ conic,
    const float* __restrict__ opacity, const int* __restrict__ rect_min,
    const int* __restrict__ rect_max, const int* __restrict__ tiles_touched,
    const float* __restrict__ depths, int depth_stride, const long long* __restrict__ scratch,
    int64_t* __restrict__ keys, int* __restrict__ gids) {
  const int lane = threadIdx.x & 31, wid = threadIdx.x >> 5;
  const int warp = blockIdx.x * GS_K1_WARPS + wid, num_warps = (n + 31) / 32;
  if (warp >= num_warps) return;  // the whole warp
  // < 2^31: the caller launches this pass only for fewer entries
  const unsigned before = __reduce_add_sync(
      GS_FULL_MASK, lane < wid ? (unsigned)scratch[warp - wid + lane] : 0u);
  warp_walk<CULL, true>(warp, n, grid_x, means2d, conic, opacity, rect_min, rect_max,
                        tiles_touched, depths, depth_stride,
                        k1_masks(const_cast<long long*>(scratch), n, warp),
                        scratch[num_warps + blockIdx.x] + before, scratch[warp], keys, gids);
}

__global__ void identify_tile_ranges_kernel(
    int num_entries, int num_tiles, const int64_t* __restrict__ keys, int* __restrict__ ranges) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;  // boundary before entry b
  if (b > num_entries) return;
  const int prev = b > 0 ? (int)(keys[b - 1] >> 32) : -1;
  const int next = b < num_entries ? (int)(keys[b] >> 32) : num_tiles;
  if (prev == next) return;
  if (prev >= 0) ranges[2 * prev + 1] = b;
  if (next < num_tiles) ranges[2 * next] = b;
  int2* pairs = reinterpret_cast<int2*>(ranges);
  for (int tile = prev + 1; tile < next; ++tile) pairs[tile] = make_int2(0, 0);
}

static inline int blocks_for(int n, int threads) { return (n + threads - 1) / threads; }

// K1's count pass into scratch: ceil(n / 32) + ceil(n / 256) + 1 int64, and
// with the cull GS_K1_MASKS / 2 int64 more a warp (see count_entries_kernel);
// the entry count is element ceil(n / 32) + ceil(n / 256).
GS_API int gs_count_entries(int n, const float* means2d, const float* conic,
                            const float* opacity, const int* rect_min, const int* rect_max,
                            const int* tiles_touched, int cull, long long* scratch,
                            void* stream) {
  if (n <= 0) return gs_last_error();
  const int blocks = blocks_for(n, GS_K1_THREADS);
  if (cull)
    count_entries_kernel<true><<<blocks, GS_K1_THREADS, 0, (cudaStream_t)stream>>>(
        n, means2d, conic, opacity, rect_min, rect_max, tiles_touched, scratch);
  else
    count_entries_kernel<false><<<blocks, GS_K1_THREADS, 0, (cudaStream_t)stream>>>(
        n, means2d, conic, opacity, rect_min, rect_max, tiles_touched, scratch);
  return gs_last_error();
}

// K1's write pass, at the offsets of gs_count_entries; depths[g] is read at
// g * depth_stride.
GS_API int gs_write_entries(int n, int grid_x, const float* means2d, const float* conic,
                            const float* opacity, const int* rect_min, const int* rect_max,
                            const int* tiles_touched, const float* depths, int depth_stride,
                            int cull, const long long* scratch, int64_t* keys, int* gids,
                            void* stream) {
  if (n <= 0) return gs_last_error();
  const int blocks = blocks_for(n, GS_K1_THREADS);
  if (cull)
    write_entries_kernel<true><<<blocks, GS_K1_THREADS, 0, (cudaStream_t)stream>>>(
        n, grid_x, means2d, conic, opacity, rect_min, rect_max, tiles_touched, depths,
        depth_stride, scratch, keys, gids);
  else
    write_entries_kernel<false><<<blocks, GS_K1_THREADS, 0, (cudaStream_t)stream>>>(
        n, grid_x, means2d, conic, opacity, rect_min, rect_max, tiles_touched, depths,
        depth_stride, scratch, keys, gids);
  return gs_last_error();
}

GS_API int gs_identify_tile_ranges(int num_entries, int num_tiles, const int64_t* keys,
                                   int* ranges, void* stream) {
  if (num_entries > 0)
    identify_tile_ranges_kernel<<<blocks_for(num_entries + 1, 256), 256, 0,
                                  (cudaStream_t)stream>>>(num_entries, num_tiles, keys, ranges);
  return gs_last_error();
}
